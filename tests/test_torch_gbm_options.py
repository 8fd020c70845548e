"""Port parity: the rest of the GBM path of ``h2o_tpu_torch`` against the
reference (``h2o_tpu/models``) — variable importances, early stopping,
every built-in distribution, the quantile/laplace/huber leaves and
``histogram_type="Exact"``, on the fixtures of ``tests/test_gbm.py``. The
reference runs on a one-device mesh (``tests/torch_parity.py``).

Contracts and tolerances:
- forests structurally equal (split features, NA directions, split bins);
- variable importances in the same order, percentages within 1e-5;
- early stopping at the same tree count, with a history of the same length;
- distributions: gradient, hessian, deviance and link within rtol 1e-5
  (atol 1e-6 of the array's scale): XLA's and torch's exp and log differ
  in the last ulp; ``init_f`` of laplace and quantile (``jnp.nanmedian``
  and ``jnp.nanquantile``) bit-equal, the mean-based ones within 1e-6;
- laplace and quantile leaves bit-equal: the (node, bin) histograms count
  integer weights exactly, and the bracket update and the quantile's
  interpolation are formed as the reference's contracted multiply-adds;
- huber leaves within 1e-6 absolute (leaves up to ~51): the clipped-mean
  term is a real sum, in 64-bit fixed point in the port and float32 blocks
  in the reference;
- the other Newton-leaf forests within 1e-5 (g/h sums in other orders);
- Exact bin edges bit-equal, and the plan they give named.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o_tpu.models import distributions as jdist
from h2o_tpu.models.drf import DRF as JDRF
from h2o_tpu.models.drf import DRFParameters as JDRFParameters
from h2o_tpu.models.gbm import GBM as JGBM
from h2o_tpu.models.gbm import GBMParameters as JGBMParameters
from h2o_tpu.models.tree import binning as jbinning
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import GBM, DRF, DRFParameters, GBMParameters
from h2o_tpu_torch.models import distributions as tdist
from h2o_tpu_torch.models.tree import binning as tbinning

from torch_parity import (assert_forest_equal, assert_varimp_equal, frames,
                          train_both)

torch.set_num_threads(2)

NEWTON_TOL = 1e-5
HUBER_TOL = 1e-6


def _gbm_both(cols, y, ydom=None, **kw):
    return train_both(JGBM, JGBMParameters, GBM, GBMParameters, cols, y,
                      ydom, **kw)


def _regression_cols(n=2000, seed=0):
    """``tests/test_gbm.py:_regression_frame``."""
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x2 = rng.uniform(-2, 2, size=n)
    x3 = rng.integers(0, 4, size=n).astype(float)
    y = 3 * x1 - 2 * x2 ** 2 + x3 + rng.normal(0, 0.1, size=n)
    return {"x1": x1, "x2": x2, "x3": x3}, y


def test_varimp_and_history_match_the_reference():
    """``test_gbm.py:96``: 12 trees scored every 4."""
    cols, y = _regression_cols()
    jm, tm, _, _ = _gbm_both(cols, y, ntrees=12, score_tree_interval=4,
                             seed=0)
    assert_forest_equal(jm, tm, NEWTON_TOL)
    assert_varimp_equal(jm, tm)
    assert set(tm.output.variable_importances["variable"]) == {"x1", "x2",
                                                                "x3"}
    assert len(tm.output.scoring_history) == 3
    mses = [h["training_metrics"].mse for h in tm.output.scoring_history]
    assert mses[-1] < mses[0]


def test_drf_varimp_matches_the_reference():
    cols, y = _regression_cols(n=1500, seed=4)
    jm, tm, _, _ = train_both(JDRF, JDRFParameters, DRF, DRFParameters, cols,
                              y, ntrees=4, max_depth=5, seed=3)
    assert_varimp_equal(jm, tm)


def test_early_stopping_matches_the_reference():
    """``test_gbm.py:108``: sampled rows and columns, an aggressive
    tolerance stops before 40 trees."""
    cols, y = _regression_cols()
    jm, tm, _, _ = _gbm_both(cols, y, ntrees=40, sample_rate=0.7,
                             col_sample_rate=0.8, score_tree_interval=5,
                             stopping_rounds=2, stopping_tolerance=0.5,
                             seed=0)
    assert tm.ntrees == jm.ntrees < 40
    assert len(tm.output.scoring_history) == len(jm.output.scoring_history)
    assert_forest_equal(jm, tm, NEWTON_TOL)
    assert_varimp_equal(jm, tm)


_DISTS = {"poisson": {}, "gamma": {}, "tweedie": dict(tweedie_power=1.3),
          "laplace": {}, "quantile": dict(quantile_alpha=0.9),
          "huber": dict(huber_alpha=0.9), "quasibinomial": {},
          "negativebinomial": dict(theta=0.5)}


@pytest.mark.parametrize("name", sorted(_DISTS))
def test_distribution_matches_the_reference(name):
    rng = np.random.default_rng(2)
    n = 1001
    if name in ("poisson", "gamma", "tweedie", "negativebinomial"):
        y = rng.gamma(2.0, 1.0, n).astype(np.float32)
    elif name == "quasibinomial":
        y = (rng.random(n) < 0.4).astype(np.float32)
    else:
        y = rng.normal(size=n).astype(np.float32)
    f = rng.normal(scale=0.5, size=n).astype(np.float32)
    w = (rng.random(n) < 0.8).astype(np.float32)
    jd = jdist.get_distribution(name, **_DISTS[name])
    td = tdist.get_distribution(name, **_DISTS[name])
    jy, jf, jw = map(jnp.asarray, (y, f, w))
    ty, tf, tw = map(torch.from_numpy, (y, f, w))
    for fn in ("gradient", "hessian", "deviance"):
        ref = np.asarray(getattr(jd, fn)(jy, jf, jw))
        np.testing.assert_allclose(getattr(td, fn)(ty, tf, tw).numpy(), ref,
                                   rtol=1e-5, atol=1e-6 * np.abs(ref).max())
    mu = np.abs(f) + 0.1
    np.testing.assert_allclose(td.link(torch.from_numpy(mu)).numpy(),
                               np.asarray(jd.link(jnp.asarray(mu))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(td.linkinv(tf).numpy(),
                               np.asarray(jd.linkinv(jf)), rtol=1e-6)
    ref0 = np.float32(jd.init_f(jy, jw))
    if name in ("laplace", "quantile"):
        assert np.float32(td.init_f(ty, tw)) == ref0
    else:
        assert float(td.init_f(ty, tw)) == pytest.approx(float(ref0),
                                                         rel=1e-6)


def _count_cols(n=3000, seed=6):
    rng = np.random.default_rng(seed)
    cols = {f"x{j}": rng.normal(size=n).astype(np.float32) for j in range(4)}
    cols["x1"][rng.random(n) < 0.1] = np.nan
    eta = 0.4 * cols["x0"] - 0.3 * cols["x2"] + 0.2 * cols["x3"]
    return cols, rng, eta


@pytest.mark.parametrize("name", ["poisson", "gamma", "tweedie",
                                  "negativebinomial", "quasibinomial"])
def test_newton_leaf_forest_matches_the_reference(name):
    """The Newton-leaf distributions not covered by ``test_torch_gbm.py``:
    4 numeric features (10% NA in x1), 5 trees at depth 3."""
    cols, rng, eta = _count_cols()
    if name == "poisson" or name == "negativebinomial":
        y = rng.poisson(np.exp(eta)).astype(np.float32)
    elif name == "quasibinomial":
        y = (rng.random(eta.shape[0]) < 1 / (1 + np.exp(-eta))).astype(
            np.float32)
    else:
        y = rng.gamma(2.0, np.exp(eta) / 2.0).astype(np.float32)
    jm, tm, _, fr = _gbm_both(cols, y, ntrees=5, max_depth=3, seed=1,
                              distribution=name, tweedie_power=1.3)
    assert tm.dist.name == name
    assert_forest_equal(jm, tm, NEWTON_TOL)
    assert float(tm.f0) == pytest.approx(float(jm.f0), rel=1e-6)
    assert_varimp_equal(jm, tm)
    n = eta.shape[0]
    raw = tm.score0(tm.adapt_frame(fr)).numpy()[:n]
    assert np.isfinite(raw).all()


def _leaf_fixture(case):
    """``tests/test_gbm.py:243-318``'s frames and settings."""
    if case.startswith("quantile") or case == "laplace":
        rng = np.random.default_rng(0)
        n = 4000
        x = rng.uniform(-2, 2, n).astype(np.float32)
        y = (x + rng.normal(0, 1.0, n).astype(np.float32)).astype(np.float32)
        kw = dict(ntrees=40, max_depth=3, learn_rate=0.3, seed=1)
        if case == "laplace":
            return x, y, dict(kw, distribution="laplace")
        return x, y, dict(kw, distribution="quantile",
                          quantile_alpha=float(case.split("_")[1]))
    if case == "laplace_outlier":
        rng = np.random.default_rng(2)
        n = 2000
        x = rng.uniform(-2, 2, n).astype(np.float32)
        y = (x + 0.3 * rng.normal(size=n)).astype(np.float32)
        y[0] = 1e6
        return x, y, dict(ntrees=30, max_depth=3, learn_rate=0.3, seed=1,
                          distribution="laplace")
    rng = np.random.default_rng(3)
    n = 3000
    x = rng.uniform(-2, 2, n).astype(np.float32)
    y = (2 * x + 0.3 * rng.normal(size=n)).astype(np.float32)
    y[:5] = 1e5
    return x, y, dict(ntrees=40, max_depth=3, learn_rate=0.3, seed=1,
                      distribution="huber", huber_alpha=0.9)


@pytest.mark.parametrize("case", ["quantile_0.9", "quantile_0.1", "laplace",
                                  "laplace_outlier", "huber"])
def test_quantile_family_leaves_match_the_reference(case):
    x, y, kw = _leaf_fixture(case)
    jm, tm, jfr, fr = _gbm_both({"x": x}, y, **kw)
    huber = case == "huber"
    assert (tm.cfg.huber_leaf_alpha is not None) == huber
    assert (tm.cfg.leaf_quantile is not None) == (not huber)
    assert np.float32(tm.f0) == np.float32(jm.f0)
    assert_forest_equal(jm, tm, HUBER_TOL if huber else 0)
    n = x.shape[0]
    pred = tm.predict(fr).vec(0).to_numpy()
    ref = jm.predict(jfr).vec(0).to_numpy()
    np.testing.assert_allclose(pred, ref, rtol=0,
                               atol=40 * HUBER_TOL if huber else 0)
    if case == "quantile_0.9":      # the reference test's coverage band
        assert 0.8 < float(np.mean(y <= pred[:n])) < 0.97


def _exact_cols(n=20_000, seed=0):
    """Four columns: 50 distinct multiples of 0.37, a continuous column
    (more distinct values than nbins_top_level: quantile cuts), 624
    two-decimal values with 10% NA, and 3 levels."""
    rng = np.random.default_rng(seed)
    cols = {"a": rng.integers(0, 50, n).astype(np.float32) * 0.37,
            "b": rng.normal(size=n).astype(np.float32),
            "c": np.round(rng.normal(size=n), 2).astype(np.float32),
            "d": rng.integers(0, 3, n).astype(np.float32)}
    cols["c"][rng.random(n) < 0.1] = np.nan
    return cols, rng


def test_exact_edges_are_bit_equal_to_the_reference():
    cols, _ = _exact_cols()
    one, jfr, fr = frames(cols)
    is_cat = np.zeros(len(cols), bool)
    with meshmod.use_mesh(one):
        je = jbinning.compute_bin_edges_cols([jfr.vec(k) for k in cols],
                                             is_cat, 20,
                                             histogram_type="Exact")
    te = tbinning.compute_bin_edges_cols([fr.vec(k) for k in cols], is_cat,
                                         20, histogram_type="Exact")
    assert te.shape == je.shape == (4, 624)
    assert np.array_equal(te.view(np.int32), je.view(np.int32))
    assert [int((~np.isnan(r)).sum()) for r in te] == [49, 19, 624, 2]


def test_exact_gbm_matches_the_reference():
    """The Exact frame's widths (51, 21, 626, 4 bins) put it on the grouped
    plan."""
    cols, rng = _exact_cols(n=5000, seed=1)
    y = (np.nan_to_num(cols["c"]) + 0.5 * cols["a"]
         + rng.normal(size=5000)).astype(np.float32)
    jm, tm, jfr, _ = _gbm_both(cols, y, ntrees=4, max_depth=3, seed=1,
                               histogram_type="Exact")
    assert tm.cfg.hist_groups is not None
    assert tm.cfg.hist_groups == jm.cfg.hist_groups
    with meshmod.use_mesh(jfr.vec("a").data.sharding.mesh):
        je = jbinning.compute_bin_edges_cols(
            [jfr.vec(k) for k in cols], np.zeros(4, bool), 20,
            histogram_type="Exact")
    assert np.array_equal(tm.edges.view(np.int32), je.view(np.int32))
    assert_forest_equal(jm, tm, NEWTON_TOL)
