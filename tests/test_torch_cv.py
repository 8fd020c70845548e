"""Port parity: cross-validation, Platt calibration, custom distributions,
the multinomial AUC family and the binomial max-criteria and gains/lift
tables of ``h2o_tpu_torch`` against the reference (``h2o_tpu/models``),
the reference on a one-device mesh. Each reference model is trained once;
the GBM and GLM CV models in module-scoped fixtures that several tests
read.

Contracts and tolerances:
- fold assignments (Random, Modulo, Stratified, a fold column) bit-equal:
  both draw from numpy's ``default_rng(seed)``;
- GBM with 3 folds (3 trees, depth 3, min_rows 10 so no two candidates
  tie; Modulo folds of equal size, so the reference compiles one fold
  shape): every fold forest and the main forest structurally equal, leaves
  within 1e-5 (``torch_parity.assert_forest_equal``), cross-validation
  metrics and holdout predictions within 1e-5 (the g/h sums run in other
  orders); the Platt coefficients (a, b) of the main model and of every
  fold model within 1e-5 (float32 sums over the calibration frame in other
  orders), and the ``cal_p0``/``cal_p1`` columns within 1e-5;
- DRF and XGBoost CV through the same base-class path: the same forest
  contract, CV metrics within 1e-5;
- GLM CV: each fold's and the main model's coefficients within 1e-4 x
  max(1, |beta|) (the Gram's float32 sums in other orders through the
  IRLS solve), CV metrics within 1e-4, and each fit's residual and null
  deviance within a relative 1e-4;
- a custom distribution that restates gaussian grows the built-in's
  forest bit for bit;
- the four multinomial AUC types, ROC and PR, within 1e-6 (the port sums
  in float64, the reference in float32); the binomial max-criteria and
  gains/lift tables within 1e-6 (both read one 1024-bin histogram).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parity as tp
from h2o_tpu.models import metrics as jmetrics
from h2o_tpu.models.drf import DRF as JDRF
from h2o_tpu.models.drf import DRFParameters as JDRFParameters
from h2o_tpu.models.gbm import GBM as JGBM
from h2o_tpu.models.gbm import GBMParameters as JGBMParameters
from h2o_tpu.models.glm import GLM as JGLM
from h2o_tpu.models.glm import GLMParameters as JGLMParameters
from h2o_tpu.models.xgboost import XGBoost as JXGBoost
from h2o_tpu.models.xgboost import XGBoostParameters as JXGBoostParameters
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import (DRF, GBM, GLM, DRFParameters, GBMParameters,
                           GLMParameters, XGBoost, XGBoostParameters)
from h2o_tpu_torch.frame.vec import Vec
from h2o_tpu_torch.models import metrics as tmetrics
from h2o_tpu_torch.models.distributions import Distribution

torch.set_num_threads(2)

CV_METRICS = ("auc", "logloss", "mse", "rmse", "mean_per_class_error")


def _data(n, seed, nfeat=4):
    rng = np.random.default_rng(seed)
    cols = {f"x{j}": rng.normal(size=n).astype(np.float32)
            for j in range(nfeat)}
    cols["x1"][rng.random(n) < 0.05] = np.nan
    logit = cols["x0"] - 0.7 * np.nan_to_num(cols["x1"]) + 0.4 * cols["x2"]
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return cols, y


def _train(ref_builder, ref_params, builder, params, n=3000, data_seed=3,
           calibrate=False, **kw):
    """The same CV model in both packages; with ``calibrate``, Platt
    scaling on a second frame of the same generator."""
    cols, y = _data(n, data_seed)
    one, jfr, fr = tp.frames(cols, y, ["0", "1"])
    jkw, tkw = dict(kw), dict(kw)
    if calibrate:
        ccols, cy = _data(n // 3, data_seed + 1)
        _, jcal, cal = tp.frames(ccols, cy, ["0", "1"])
        jkw.update(calibrate_model=True, calibration_frame=jcal)
        tkw.update(calibrate_model=True, calibration_frame=cal)
    with meshmod.use_mesh(one):
        jm = ref_builder(ref_params(training_frame=jfr, response_column="y",
                                    **jkw)).train_model()
    tm = builder(params(training_frame=fr, response_column="y",
                        **tkw)).train_model()
    return jm, tm, jfr, fr


def _assert_cv_metrics(jm, tm, tol):
    jc, tc = (jm.output.cross_validation_metrics,
              tm.output.cross_validation_metrics)
    for k in CV_METRICS:
        assert getattr(tc, k) == pytest.approx(getattr(jc, k), abs=tol), k


def _holdout(m):
    fr = m.output.cv_holdout_predictions
    return np.stack([fr.vec(i).to_numpy() for i in range(fr.ncol)], axis=1)


@pytest.mark.parametrize("scheme", ["Random", "Modulo", "Stratified",
                                    "fold_column"])
def test_fold_assignment_matches_the_reference(scheme):
    n = 1001
    cols, y = _data(n, 7)
    cols["fold"] = np.random.default_rng(1).integers(0, 4, n).astype(
        np.float32)
    one, jfr, fr = tp.frames(cols, y, ["0", "1"])
    kw = dict(response_column="y", nfolds=4, seed=11)
    if scheme == "fold_column":
        kw.update(nfolds=0, fold_column="fold")
    else:
        kw.update(fold_assignment=scheme)
    with meshmod.use_mesh(one):
        jf = JGBM(JGBMParameters(training_frame=jfr, **kw))._fold_assignment(
            jfr)
    tf = GBM(GBMParameters(training_frame=fr, **kw))._fold_assignment(fr)
    assert tf.dtype == jf.dtype and np.array_equal(tf, jf)
    assert set(np.unique(tf)) == {0, 1, 2, 3}


@pytest.fixture(scope="module")
def gbm_cv():
    """The GBM with 3-fold CV and Platt calibration, trained once in each
    package; the tests below read it. Most of its wall is the reference's
    first GBM compile in the process."""
    return _train(
        JGBM, JGBMParameters, GBM, GBMParameters, calibrate=True, nfolds=3,
        fold_assignment="Modulo", ntrees=3, max_depth=3, min_rows=10,
        seed=42,
        keep_cross_validation_predictions=True,
        keep_cross_validation_fold_assignment=True)


def test_gbm_cv_forests_match_the_reference(gbm_cv):
    jm, tm, _, _ = gbm_cv
    assert len(tm.output.cv_models) == len(jm.output.cv_models) == 3
    for a, b in zip(jm.output.cv_models + [jm], tm.output.cv_models + [tm]):
        tp.assert_forest_equal(a, b, val_atol=1e-5)


def test_gbm_cv_metrics_and_holdout_match_the_reference(gbm_cv):
    jm, tm, _, _ = gbm_cv
    _assert_cv_metrics(jm, tm, 1e-5)
    jh, th = _holdout(jm), _holdout(tm)
    assert tm.output.cv_holdout_predictions.names == \
        jm.output.cv_holdout_predictions.names
    assert np.isfinite(th).all()
    np.testing.assert_allclose(th, jh, rtol=0, atol=1e-5)
    assert len(tm.output.cv_fold_predictions) == 3
    assert np.array_equal(
        tm.output.cv_fold_assignment.vec(0).to_numpy(),
        jm.output.cv_fold_assignment.vec(0).to_numpy())


def test_gbm_cv_and_calibration_match_the_reference(gbm_cv):
    jm, tm, jfr, fr = gbm_cv
    for a, b in zip(jm.output.cv_models, tm.output.cv_models):
        np.testing.assert_allclose(b.calib, a.calib, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.calib, jm.calib, rtol=0, atol=1e-5)
    jp, tpred = jm.predict(jfr), tm.predict(fr)
    assert tpred.names == jp.names
    for c in ("cal_p0", "cal_p1"):
        np.testing.assert_allclose(tpred.vec(c).to_numpy(),
                                   jp.vec(c).to_numpy(), rtol=0, atol=1e-5)
    s = tpred.vec("cal_p0").to_numpy() + tpred.vec("cal_p1").to_numpy()
    np.testing.assert_allclose(s, 1.0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("algo", ["drf", "xgboost"])
def test_drf_and_xgboost_cv_match_the_reference(algo):
    if algo == "drf":
        builders = (JDRF, JDRFParameters, DRF, DRFParameters)
        kw = dict(ntrees=3, max_depth=4, min_rows=10, seed=42)
    else:
        builders = (JXGBoost, JXGBoostParameters, XGBoost, XGBoostParameters)
        kw = dict(ntrees=3, max_depth=3, min_rows=10, seed=42)
    jm, tm, _, _ = _train(*builders, n=2000, nfolds=2,
                          fold_assignment="Modulo", **kw)
    assert len(tm.output.cv_models) == 2
    for a, b in zip(jm.output.cv_models + [jm],
                    tm.output.cv_models + [tm]):
        tp.assert_forest_equal(a, b, val_atol=1e-5)
    _assert_cv_metrics(jm, tm, 1e-5)


@pytest.fixture(scope="module")
def glm_cv():
    """The binomial GLM with 3-fold CV, trained once in each package."""
    return _train(JGLM, JGLMParameters, GLM, GLMParameters, n=4000,
                  nfolds=3, family="binomial", seed=42)


def test_glm_cv_matches_the_reference(glm_cv):
    jm, tm, _, _ = glm_cv
    assert len(tm.output.cv_models) == len(jm.output.cv_models) == 3
    for a, b in zip(jm.output.cv_models + [jm],
                    tm.output.cv_models + [tm]):
        ja, tb = np.asarray(a.beta), np.asarray(b.beta)
        assert np.all(np.abs(tb - ja) <= 1e-4 * np.maximum(1.0, np.abs(ja)))


def test_glm_cv_metrics_match_the_reference(glm_cv):
    jm, tm, _, _ = glm_cv
    _assert_cv_metrics(jm, tm, 1e-4)
    for a, b in zip(jm.output.cv_models + [jm],
                    tm.output.cv_models + [tm]):
        ja, tb = a.output.training_metrics, b.output.training_metrics
        for k in ("residual_deviance", "null_deviance"):
            assert getattr(tb, k) == pytest.approx(getattr(ja, k),
                                                   rel=1e-4), k


class _RestatedGaussian(Distribution):
    """A user's distribution object: gaussian, written out."""

    name = "my_gaussian"

    def gradient(self, y, f, w):
        return w * (f - y)

    def hessian(self, y, f, w):
        return w

    def deviance(self, y, f, w):
        return w * (y - f) ** 2


def test_custom_distribution_grows_the_builtin_forest():
    cols, y = _data(3000, 5)
    _, _, fr = tp.frames(cols)
    fr.add("y", Vec.from_numpy(y + cols["x3"], device="cpu"))
    kw = dict(training_frame=fr, response_column="y", ntrees=4, max_depth=3,
              seed=42)
    m = GBM(GBMParameters(distribution="custom",
                          custom_distribution_func=_RestatedGaussian(),
                          **kw)).train_model()
    g = GBM(GBMParameters(distribution="gaussian", **kw)).train_model()
    for k in ("feat", "thr", "nanL", "val", "catd"):
        assert torch.equal(m.forest[k], g.forest[k]), k
    assert torch.equal(m.f0, g.f0)
    assert m.output.training_metrics.mse == g.output.training_metrics.mse


def _multinomial_scores(n=3000, K=4, seed=9):
    """Class codes and probabilities with ties (probabilities rounded to
    two decimals) and a few NA responses."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, K, n).astype(np.float32)
    logits = rng.normal(size=(n, K)) + 1.5 * (y[:, None] == np.arange(K))
    p = np.round(np.exp(logits) / np.exp(logits).sum(1, keepdims=True), 2)
    p = (p / p.sum(1, keepdims=True)).astype(np.float32)
    y[rng.random(n) < 0.02] = np.nan
    w = rng.integers(1, 4, n).astype(np.float32)
    return y, p, w


@pytest.mark.parametrize("auc_type", ["MACRO_OVR", "WEIGHTED_OVR",
                                      "MACRO_OVO", "WEIGHTED_OVO"])
def test_multinomial_auc_types_match_the_reference(auc_type):
    y, p, w = _multinomial_scores()
    dom = ["a", "b", "c", "d"]
    jm = jmetrics.make_multinomial_metrics(jnp.asarray(y), jnp.asarray(p),
                                           jnp.asarray(w), auc_type=auc_type,
                                           domain=dom)
    tm = tmetrics.make_multinomial_metrics(torch.from_numpy(y),
                                           torch.from_numpy(p),
                                           torch.from_numpy(w),
                                           auc_type=auc_type, domain=dom)
    assert tm.auc_type == jm.auc_type
    assert 0.5 < tm.auc <= 1.0
    assert tm.auc == pytest.approx(jm.auc, abs=1e-6)
    assert tm.pr_auc == pytest.approx(jm.pr_auc, abs=1e-6)
    for t in ("macro_ovr", "weighted_ovr", "macro_ovo", "weighted_ovo"):
        assert tm.auc_by_type(t) == pytest.approx(jm.auc_by_type(t),
                                                  abs=1e-6)
        assert tm.pr_auc_by_type(t) == pytest.approx(jm.pr_auc_by_type(t),
                                                     abs=1e-6)
    ja, ta = jm.multinomial_auc_table, tm.multinomial_auc_table
    assert [r[0] for r in ta.cell_values] == [r[0] for r in ja.cell_values]
    np.testing.assert_allclose([r[1] for r in ta.cell_values],
                               [r[1] for r in ja.cell_values], atol=1e-6)


def test_binomial_tables_match_the_reference():
    rng = np.random.default_rng(4)
    n = 5000
    y = (rng.random(n) < 0.3).astype(np.float32)
    p = np.clip(0.3 + 0.25 * (y - 0.3) + 0.2 * rng.normal(size=n), 0,
                1).astype(np.float32)
    jm = jmetrics.make_binomial_metrics(jnp.asarray(y), jnp.asarray(p))
    tm = tmetrics.make_binomial_metrics(torch.from_numpy(y),
                                        torch.from_numpy(p))
    for name in ("max_criteria_and_metric_scores", "gains_lift_table"):
        jt, tt = getattr(jm, name), getattr(tm, name)
        assert tt.col_header == jt.col_header
        assert len(tt.cell_values) == len(jt.cell_values) > 0
        for jr, tr in zip(jt.cell_values, tt.cell_values):
            if isinstance(jr[0], str):
                assert tr[0] == jr[0]
                jr, tr = jr[1:], tr[1:]
            np.testing.assert_allclose(np.asarray(tr, np.float64),
                                       np.asarray(jr, np.float64), rtol=0,
                                       atol=1e-6)
    for crit in ("f2", "f0point5", "accuracy", "absolute_mcc",
                 "min_per_class_accuracy", "mean_per_class_accuracy"):
        np.testing.assert_allclose(tm.thresholds_and_metric_scores[crit],
                                   jm.thresholds_and_metric_scores[crit],
                                   rtol=0, atol=1e-6)
