"""Port parity: the XGBoost surface of ``h2o_tpu_torch`` (gbtree, DART,
gblinear) against the reference (``h2o_tpu/models/xgboost.py``), on the
fixtures of ``tests/test_uplift_dt_xgb.py:79-260`` (the reference on a
one-device mesh, ``tests/torch_parity.py``).

Contracts and tolerances:
- the aliases resolve to the same parameters, idempotently;
- gbtree and DART forests structurally equal, leaf values within 1e-5 (g/h
  sums in other orders); DART drops the same trees (equal forests follow
  from equal drops, and the port's ``dropped_trees`` is held to the same
  numpy draws); training metrics within 1e-6 relative;
- gblinear: coefficients within 1e-4 x max(1, |beta|), the GLM
  comparison's tolerance;
- a multinomial gblinear (the multinomial GLM's block IRLS) gives the
  reference's coefficients within the same tolerance; DART's checkpoints
  and exports are taken (their parity with the reference's continuation
  is in test_torch_recovery.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from h2o_tpu.models.xgboost import XGBoost as JXGBoost
from h2o_tpu.models.xgboost import XGBoostParameters as JXGBoostParameters
from h2o_tpu_torch import Frame, XGBoost, XGBoostParameters, load_model
from h2o_tpu_torch.frame.vec import T_CAT, Vec

from torch_parity import assert_forest_equal, assert_varimp_equal, train_both

torch.set_num_threads(2)

LEAF_TOL = 1e-5
COEF_TOL = 1e-4


def _xgb_both(cols, y, ydom=None, **kw):
    return train_both(JXGBoost, JXGBoostParameters, XGBoost,
                      XGBoostParameters, cols, y, ydom, **kw)


def _cols(seed, n, F, fn):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F)).astype(np.float32)
    return {f"x{i}": x[:, i] for i in range(F)}, fn(x, rng).astype(np.float32)


def test_aliases_match_the_reference():
    kw = dict(n_estimators=30, eta=0.2, min_child_weight=3.0, subsample=0.9,
              colsample_bytree=0.8, colsample_bylevel=0.7, max_bins=64,
              gamma=0.5)
    tp, jp = XGBoostParameters(**kw), JXGBoostParameters(**kw)
    fields = ("ntrees", "learn_rate", "min_rows", "sample_rate",
              "col_sample_rate_per_tree", "col_sample_rate", "nbins",
              "min_split_improvement", "reg_lambda", "reg_alpha",
              "n_estimators", "eta", "subsample", "max_bins", "gamma")
    assert [getattr(tp, f) for f in fields] == [getattr(jp, f)
                                                for f in fields]
    assert (tp.ntrees, tp.learn_rate, tp.nbins) == (30, 0.2, 64)
    again = dataclasses.replace(tp)
    assert [getattr(again, f) for f in fields] == [getattr(tp, f)
                                                   for f in fields]
    d = XGBoostParameters()
    assert (d.learn_rate, d.min_rows, d.reg_lambda, d.max_depth) == (0.3, 1.0,
                                                                     1.0, 5)


def test_gbtree_matches_the_reference():
    """``test_xgboost_surface_aliases_and_fit``: sampled rows and trees,
    reg_alpha 0.1."""
    cols, y = _cols(5, 2000, 4, lambda x, r: x[:, 0] + 0.5 * x[:, 1] ** 2
                    + 0.1 * r.normal(size=x.shape[0]))
    jm, tm, _, _ = _xgb_both(cols, y, n_estimators=30, eta=0.3, max_depth=4,
                             subsample=0.9, colsample_bytree=0.9,
                             reg_lambda=1.0, reg_alpha=0.1, seed=11)
    assert tm.cfg.reg_alpha == 0.1 and tm.algo_override == "xgboost"
    assert_forest_equal(jm, tm, LEAF_TOL)
    assert_varimp_equal(jm, tm)
    assert tm.output.training_metrics.r2 == pytest.approx(
        jm.output.training_metrics.r2, rel=1e-6)
    assert tm.output.training_metrics.r2 > 0.8


def _dart_cols():
    return _cols(9, 1500, 4, lambda x, r: x[:, 0] - 0.7 * x[:, 1]
                 + 0.1 * r.normal(size=x.shape[0]))


def _drops(ntrees, seed, rate_drop, skip_drop=0.0, one_drop=False):
    """The reference's draw order, from numpy ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ntrees):
        d = []
        if t > 0 and rng.random() >= skip_drop:
            d = [i for i in range(t) if rng.random() < rate_drop]
            if not d and one_drop:
                d = [int(rng.integers(t))]
        out.append(d)
    return out


@pytest.mark.parametrize("case", ["rate_drop", "one_drop", "skip_drop",
                                  "forest"])
def test_dart_matches_the_reference(case):
    cols, y = _dart_cols()
    extra = {"rate_drop": dict(rate_drop=0.3),
             "one_drop": dict(rate_drop=0.0, one_drop=True),
             "skip_drop": dict(rate_drop=0.5, skip_drop=1.0),
             "forest": dict(rate_drop=0.3, normalize_type="forest")}[case]
    jm, tm, jfr, fr = _xgb_both(cols, y, ntrees=25, max_depth=3, eta=0.3,
                                seed=7, booster="dart", **extra)
    assert tm.dropped_trees == _drops(25, 7, **{
        k: v for k, v in extra.items() if k != "normalize_type"})
    assert any(tm.dropped_trees) == (case != "skip_drop")
    assert_forest_equal(jm, tm, LEAF_TOL)
    assert_varimp_equal(jm, tm)
    r2 = tm.output.training_metrics.r2
    assert r2 == pytest.approx(jm.output.training_metrics.r2, rel=1e-6)
    # the baked leaves score what the carried margin scored
    pred = tm.predict(fr).vec(0).to_numpy()
    n = y.shape[0]
    ss = float(np.sum((y - pred[:n]) ** 2))
    assert abs((1 - ss / float(np.sum((y - y.mean()) ** 2))) - r2) < 0.02


def test_dart_multinomial_matches_the_reference():
    rng = np.random.default_rng(3)
    n = 1200
    x = rng.normal(size=(n, 3)).astype(np.float32)
    yc = np.argmax(x, axis=1).astype(np.float32)
    noisy = rng.random(n) < 0.1
    yc[noisy] = rng.integers(0, 3, noisy.sum())
    jm, tm, _, fr = _xgb_both({f"x{i}": x[:, i] for i in range(3)}, yc,
                              ydom=["a", "b", "c"], booster="dart",
                              rate_drop=0.3, ntrees=15, max_depth=3, seed=5)
    assert tm.forest["feat"].dim() == 3
    assert_forest_equal(jm, tm, LEAF_TOL)
    tmm = tm.output.training_metrics
    assert tmm.logloss == pytest.approx(jm.output.training_metrics.logloss,
                                        rel=1e-6)
    np.testing.assert_allclose(tm.model_performance(fr).logloss,
                               tmm.logloss, rtol=1e-4)


def _assert_coef_close(jm, tm):
    jc, tc = jm.coef(), tm.coef()
    assert list(tc) == list(jc)
    for k in jc:
        assert abs(tc[k] - jc[k]) <= COEF_TOL * max(1.0, abs(jc[k])), k


@pytest.mark.parametrize("case", ["unpenalised", "l1", "binomial"])
def test_gblinear_matches_the_reference(case):
    cols, y = _cols(4, 2000, 5, lambda x, r: 2.0 * x[:, 0] - 1.0 * x[:, 1]
                    + 0.05 * r.normal(size=x.shape[0]))
    kw = {"unpenalised": dict(reg_lambda=0.0, reg_alpha=0.0),
          "l1": dict(reg_alpha=200.0, reg_lambda=0.0),
          "binomial": dict(reg_lambda=1.0)}[case]
    ydom = None
    if case == "binomial":
        y, ydom = (y > 0).astype(np.float32), ["n", "p"]
    jm, tm, _, _ = _xgb_both(cols, y, ydom=ydom, booster="gblinear", seed=1,
                             **kw)
    assert tm.booster == "gblinear" and tm.algo_override == "xgboost"
    assert tm.params.solver == "COORDINATE_DESCENT"
    assert not tm.params.standardize
    _assert_coef_close(jm, tm)
    if case == "l1":
        c = tm.coef()
        assert abs(c["x3"]) < 1e-3 and abs(c["x4"]) < 1e-3
    if case == "binomial":
        assert tm.output.training_metrics.auc == pytest.approx(
            jm.output.training_metrics.auc, abs=1e-6)


@pytest.mark.parametrize("case", ["dart_checkpoint", "dart_export",
                                  "gblinear_multinomial"])
def test_unported_xgboost_options_raise(case, tmp_path):
    """A multinomial gblinear, once refused by the GLM, trains the
    multinomial GLM as the reference does. DART's checkpoints and exports
    are ported now: an unknown prior key raises the reference's
    ``ValueError``, and an export writes one snapshot per scoring interval
    that loads and scores."""
    rng = np.random.default_rng(1)
    fr = Frame.from_dict({"x": rng.normal(size=300).astype(np.float32)},
                         device="cpu")
    fr.add("y", Vec.from_numpy((np.arange(300) % 3).astype(np.float32),
                               type=T_CAT, domain=["a", "b", "c"],
                               device="cpu"))
    kw = dict(training_frame=fr, response_column="y", ntrees=2)
    snaps = str(tmp_path / "snaps")
    kw.update({"dart_checkpoint": dict(booster="dart", checkpoint="prior"),
               "dart_export": dict(booster="dart",
                                   export_checkpoints_dir=snaps),
               "gblinear_multinomial": dict(booster="gblinear")}[case])
    if case == "dart_checkpoint":
        with pytest.raises(ValueError, match="checkpoint model 'prior'"):
            XGBoost(XGBoostParameters(**kw)).train_model()
        return
    if case == "dart_export":
        m = XGBoost(XGBoostParameters(**kw)).train_model()
        snap = load_model(str(tmp_path / "snaps" / "xgboost_00002.bin"),
                          device="cpu")
        assert snap.ntrees == m.ntrees == 2
        for k in m.forest:
            assert torch.equal(snap.forest[k], m.forest[k])
        return
    jm, tm, _jfr, _fr = _xgb_both(
        {"x": fr.vec("x").to_numpy()}, (np.arange(300) % 3).astype(np.float32),
        ["a", "b", "c"], booster="gblinear", ntrees=2)
    jb = np.asarray(jm.beta, np.float64)
    assert tm.booster == "gblinear" and tm.beta.shape == jb.shape == (3, 2)
    assert np.all(np.abs(tm.beta - jb) <= COEF_TOL * np.maximum(1.0,
                                                                np.abs(jb)))
