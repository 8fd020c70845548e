"""Port parity: the stacked ``compute_bin_edges``, Uplift DRF and DT
(``h2o_tpu_torch/models/tree/binning.py``, ``models/uplift.py``,
``models/dt.py``) against the reference on a one-device mesh
(oracles ``tests/test_uplift_dt_xgb.py:29,51,63,261``).

One test runs every check (the driver's suite is scheduled by xdist in
chunks whose length moves with the test count, so this slice adds few
test items); each reference model trains once, on at most 2,000 rows.
Contracts and tolerances:

- stacked bin edges equal to the per-column ``compute_bin_edges_cols``,
  and to the reference's: bit-equal (NaN padding included) where the cuts
  are exact midpoints, categorical codes or uniform; the quantile
  sketch's cuts within ``torch_parity.THR_ATOL`` and 1e-6 relative (XLA
  contracts the sketch's ``q * (n - 1) - cum_before`` into an FMA in some
  vector lanes and not in others, by shape: ROADMAP Queue 3 item 1);
- uplift forests: split features exactly; thresholds within the bin
  edges' own tolerance (``torch_parity.THR_ATOL``, 1e-6 relative); leaf
  rates ``val_t``/``val_c`` bit-equal (quotients of exact integer
  counts); split gains within 1e-5 relative (the port's divergence is
  float64 rounded once, the reference's float32 ``log``); predictions
  within 1e-6; AUUC, qini, ATE, ATT and ATC within 1e-5 relative;
- DT forests: structure, split bins and leaf values as
  ``torch_parity.assert_forest_equal`` holds them, leaves within 1e-6,
  on a frame whose ``Exact`` bins make a width-bucketed plan with a
  bucket ~2,000 bins wide;
- refusals raise the reference's messages.

The fixtures keep near-tied splits out: the treatment effect and the class
signal sit on a few features with margins well above a float32 rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o_tpu.models.dt import DT as JDT
from h2o_tpu.models.dt import DTParameters as JDTParameters
from h2o_tpu.models.tree import binning as jbinning
from h2o_tpu.models.uplift import UpliftDRF as JUplift
from h2o_tpu.models.uplift import UpliftDRFParameters as JUpliftParameters
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch.models import uplift as tuplift
from h2o_tpu_torch.models.dt import DT, DTParameters
from h2o_tpu_torch.models.tree import binning as tbinning
from h2o_tpu_torch.models.uplift import UpliftDRF, UpliftDRFParameters

from torch_parity import THR_ATOL, assert_forest_equal, frames, train_both

METRICS = ["KL", "Euclidean", "ChiSquared"]


def _uplift_cols(n=2000, seed=11):
    rng = np.random.default_rng(seed)
    cols = {f"x{j}": rng.normal(size=n).astype(np.float32) for j in range(4)}
    cols["x3"][::29] = np.nan                    # NA rows route right
    treat = rng.integers(0, 2, n).astype(np.float32)
    p = (0.3 + 0.3 * (cols["x1"] > 0) * treat
         - 0.1 * (cols["x2"] > 0.5))
    y = (rng.random(n) < p).astype(np.float32)
    cols["treatment"] = treat
    return cols, y


def _fit_uplift(metric):
    cols, y = _uplift_cols()
    kw = dict(treatment_column="treatment", ntrees=3, max_depth=4, seed=1,
              uplift_metric=metric)
    jm, tm, jfr, fr = train_both(JUplift, JUpliftParameters, UpliftDRF,
                                 UpliftDRFParameters, cols, y, ["0", "1"],
                                 **kw)
    return jm, tm, jfr, fr


def _check_stacked_bin_edges(case):
    """The stacked entry on a (R, F) matrix against the reference's and
    the port's per-column entry, at the module docstring's tolerances."""
    rng = np.random.default_rng(11)
    R = 3000 if case == "quantiles" else 600
    X = rng.normal(size=(R, 3)).astype(np.float32)
    X[::17, 1] = np.nan
    X[:, 2] = np.round(X[:, 2], 1)
    is_cat = np.zeros(3, bool)
    kw = dict(nbins=20, seed=7)
    if case == "categorical":
        X[:, 0] = rng.integers(0, 40, R)
        is_cat[0] = True
        kw["nbins_cats"] = 20
    if case == "exact_type":
        kw.update(histogram_type="Exact", nbins_top_level=2048)
    if case == "uniform":
        kw["histogram_type"] = "UniformAdaptive"
    if case == "quantiles":
        # past the small-data exact rule: the two-pass sketch's cuts
        kw["nbins_top_level"] = 10
    want = jbinning.compute_bin_edges(jnp.asarray(X), is_cat, **kw)
    got = tbinning.compute_bin_edges(torch.from_numpy(X), is_cat, **kw)
    want = np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    if case == "quantiles":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=THR_ATOL)
    else:
        assert np.array_equal(got, want, equal_nan=True)
    cols = tbinning.compute_bin_edges_cols(
        [torch.from_numpy(X[:, j].copy()) for j in range(3)], is_cat, **kw)
    assert np.array_equal(got, cols, equal_nan=True)


def _check_uplift_forest(metric):
    """Forest, leaves, gains, predictions and the uplift metrics at the
    tolerances of the module docstring."""
    jm, tm, jfr, fr = _fit_uplift(metric)
    jf = {k: np.asarray(v) for k, v in jm.forest.items()}
    tf = {k: v.numpy() for k, v in tm.forest.items()}
    assert np.array_equal(jf["feat"], tf["feat"])
    split = jf["feat"] >= 0
    assert split.sum() >= 10
    np.testing.assert_allclose(tf["thr"][split], jf["thr"][split], rtol=1e-6,
                               atol=THR_ATOL)
    for k in ("val_t", "val_c"):
        assert np.array_equal(tf[k].view(np.int32), jf[k].view(np.int32)), k
    np.testing.assert_allclose(tf["gain"], jf["gain"], rtol=1e-5, atol=1e-7)
    assert tm.cfg.max_depth == jm.cfg.max_depth
    assert tm.cfg.hist_groups == jm.cfg.hist_groups
    with meshmod.use_mesh(meshmod.make_mesh(jax.devices()[:1])):
        jp = jm.predict(jfr)
    tp = tm.predict(fr)
    assert tp.names == ["uplift_predict", "p_y1_ct1", "p_y1_ct0"]
    for j in range(3):
        np.testing.assert_allclose(tp.vec(j).to_numpy(),
                                   np.asarray(jp.vec(j).to_numpy()),
                                   rtol=0, atol=1e-6)
    jmt, tmt = jm.output.training_metrics, tm.output.training_metrics
    assert tmt.nbins == jmt.nbins
    for k in ("auuc", "auuc_normalized", "qini", "ate", "att", "atc"):
        assert getattr(tmt, k) == pytest.approx(getattr(jmt, k), rel=1e-5)


def _check_uplift_metrics(auuc_type):
    """``make_uplift_metrics`` on the same host arrays: the reference's
    arithmetic, equal to 1e-12 relative (float64 on both)."""
    from h2o_tpu.models.uplift import make_uplift_metrics as jmake

    rng = np.random.default_rng(3)
    y = (rng.random(5000) < 0.4).astype(np.float32)
    y[::97] = np.nan
    treat = rng.integers(0, 2, 5000).astype(np.float32)
    up = rng.normal(size=5000).astype(np.float32)
    a = jmake(y, treat, up, 200, auuc_type)
    b = tuplift.make_uplift_metrics(y, treat, up, 200, auuc_type)
    for k in ("auuc", "auuc_normalized", "qini", "ate", "att", "atc"):
        assert getattr(b, k) == pytest.approx(getattr(a, k), rel=1e-12)


def _check_uplift_refusal(case):
    """What the reference refuses, the port refuses with its message."""
    cols, y = _uplift_cols(200)
    ydom = ["0", "1"]
    kw = dict(treatment_column="treatment", ntrees=1, max_depth=2)
    if case == "na_treatment":
        cols["treatment"][3] = np.nan
    elif case == "three_level_treatment":
        cols["treatment"][:5] = 2.0
    elif case == "regression":
        ydom = None
    one, jfr, fr = frames(cols, y, ydom)
    if case == "bad_metric":
        with pytest.raises(ValueError, match="uplift_metric"):
            UpliftDRF(UpliftDRFParameters(training_frame=fr,
                                          response_column="y",
                                          uplift_metric="Gini", **kw)
                      ).train_model()
        return
    with meshmod.use_mesh(one):
        with pytest.raises(ValueError) as je:
            JUplift(JUpliftParameters(training_frame=jfr, response_column="y",
                                      **kw)).train_model()
    with pytest.raises(ValueError) as te:
        UpliftDRF(UpliftDRFParameters(training_frame=fr, response_column="y",
                                      **kw)).train_model()
    assert str(te.value) == str(je.value)


def _dt_cols(n=2000, seed=3):
    rng = np.random.default_rng(seed)
    cols = {"a": np.round(rng.normal(size=n), 1).astype(np.float32),
            "b": np.round(rng.normal(size=n), 1).astype(np.float32),
            "c": rng.normal(size=n).astype(np.float32),     # ~2,000 cuts
            "d": rng.integers(0, 5, n).astype(np.float32)}
    cols["b"][::31] = np.nan
    score = cols["a"] + 0.5 * cols["b"] + 0.8 * (cols["d"] > 2)
    y = (np.nan_to_num(score) + rng.normal(scale=0.5, size=n) > 0)
    return cols, y.astype(np.float32)


def _check_dt():
    """One DT tree: structure, NA directions, split bins and leaves
    (within 1e-6) as the reference grows it, on ``Exact`` bins whose
    widths make a width-bucketed plan (the continuous column's ~2,000 cuts
    a bucket at the full width)."""
    cols, y = _dt_cols()
    jm, tm, _jfr, _fr = train_both(JDT, JDTParameters, DT, DTParameters,
                                   cols, y, ["n", "p"], max_depth=4)
    assert tm.cfg.hist_groups is not None
    assert tm.cfg.nbins > 1024
    assert max(w for _i, w, _m in tm.cfg.hist_groups) == tm.cfg.nbins + 1
    assert tm.cfg.hist_groups == jm.cfg.hist_groups
    assert tm.ntrees == 1 and tm.params.sample_rate == 1.0
    assert_forest_equal(jm, tm, 1e-6)
    assert tm.output.training_metrics.auc == pytest.approx(
        jm.output.training_metrics.auc, abs=1e-6)


def test_uplift_and_dt_match_the_reference():
    """The stacked bin edges (sketch quantiles, small-data exact cuts,
    categorical codes, ``Exact``, uniform cuts), uplift forests under each
    divergence, the uplift metrics under each AUUC type, the refusals and
    DT, at the module docstring's tolerances."""
    for case in ("quantiles", "exact_small", "categorical", "exact_type",
                 "uniform"):
        _check_stacked_bin_edges(case)
    for metric in METRICS:
        _check_uplift_forest(metric)
    for auuc_type in ("qini", "lift", "gain"):
        _check_uplift_metrics(auuc_type)
    for case in ("na_treatment", "three_level_treatment", "regression",
                 "bad_metric"):
        _check_uplift_refusal(case)
    _check_dt()
