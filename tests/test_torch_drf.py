"""Port parity: jax's random streams, the per-level column mask, and the
forests of DRF, XRT, row/column-sampled GBM and multinomial GBM of
``h2o_tpu_torch`` against the reference (``h2o_tpu/models``).

The reference runs on a one-device mesh: its row sample draws over the
shard's padded length from ``fold_in(key, shard)``, which the port
reproduces for shard 0. Contracts and tolerances:

- ``threefry``: keys, splits, fold-ins and float32 uniforms bit-equal to
  the live ``jax.random`` (0.9.0, ``jax_threefry_partitionable`` on);
- ``_level_col_mask``: equal masks;
- every forest structurally equal: split features, NA directions and
  set-split direction rows at split nodes exactly, thresholds within 1e-6
  relative (the bin edges' own tolerance);
- classification DRF and XRT (integer channels: counts and class
  indicators): leaf values and out-of-bag metrics exactly equal,
  predictions within 1e-6 (the average over trees); regression DRF (real
  sums in other orders): leaf values, predictions and OOB MSE within 1e-5
  relative;
- GBM: leaf values and predictions within 1e-5 (g/h sums in other orders,
  and XLA's and torch's exp differ in the last ulp), training logloss and
  MSE within 1e-5 relative;
- a reference DRF and a multinomial GBM loaded with ``from_reference``
  score the reference's rows within 1e-6;
- variable importances in the same order, percentages within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o_tpu.frame.frame import Frame as JFrame
from h2o_tpu.frame.vec import T_CAT as J_CAT
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.models.drf import DRF as JDRF
from h2o_tpu.models.drf import XRT as JXRT
from h2o_tpu.models.drf import DRFParameters as JDRFParameters
from h2o_tpu.models.drf import XRTParameters as JXRTParameters
from h2o_tpu.models.gbm import GBM as JGBM
from h2o_tpu.models.gbm import GBMParameters as JGBMParameters
from h2o_tpu.models.tree import binning as jbinning
from h2o_tpu.models.tree import engine as jengine
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import (DRF, GBM, XRT, DRFModel, DRFParameters, Frame,
                           GBMModel, GBMParameters, XRTParameters)
from h2o_tpu_torch.frame.vec import T_CAT, Vec
from h2o_tpu_torch.models.tree import engine as tengine
from h2o_tpu_torch.utils import threefry

from torch_parity import assert_varimp_equal

torch.set_num_threads(2)

N = 3000
LEVELS = [f"L{i}" for i in range(5)]


# ---------------------------------------------------------------------------
# threefry
# ---------------------------------------------------------------------------
def test_keys_are_jax_keys():
    """PRNGKey, the pinned fold-in, split, and the tree keys of seed -1."""
    k = threefry.prng_key(42)
    assert k.tolist() == [0, 42]
    assert threefry.fold_in(k, 997).tolist() == [19482376, 1354921687]
    for seed in (0, 42, 1234, 2 ** 31 - 1):
        assert np.array_equal(threefry.prng_key(seed),
                              np.asarray(jax.random.PRNGKey(seed)))
    jk = jax.random.PRNGKey(1234)
    assert np.array_equal(threefry.split(threefry.prng_key(1234), 50),
                          np.asarray(jax.random.split(jk, 50)))
    for d in (0, 1, 31, 997, 2 ** 32 - 1):
        assert np.array_equal(threefry.fold_in(threefry.prng_key(1234), d),
                              np.asarray(jax.random.fold_in(jk, d)))


@pytest.mark.parametrize("shape", [(1,), (7,), (3008,), (5003,), (54,),
                                   (7, 1), (54, 16), (9, 33)])
def test_uniform_is_bit_equal_to_jax(shape):
    """The engine's shapes: rows (R,), features (F,), (F, n_lv); odd sizes
    included (jax pads an odd count in its non-partitionable mode only)."""
    key = threefry.fold_in(threefry.split(threefry.prng_key(42), 3)[2], 0)
    ref = np.asarray(jax.random.uniform(jnp.asarray(key), shape))
    port = threefry.uniform(key, shape).numpy()
    assert port.dtype == np.float32 and port.shape == shape
    assert np.array_equal(port.view(np.uint32), ref.view(np.uint32))
    bits = np.asarray(jax.random.bits(jnp.asarray(key), shape))
    assert np.array_equal(threefry.random_bits(key, shape).numpy(),
                          bits.astype(np.int64))


@pytest.mark.parametrize("kw,level", [
    (dict(mtries=3), 0), (dict(mtries=3), 4),
    (dict(mtries=2, col_sample_rate_change_per_level=1.5), 3),
    (dict(col_sample_rate=0.3), 2),
    (dict(col_sample_rate=0.6, col_sample_rate_change_per_level=0.9), 5),
    (dict(col_sample_rate=0.05), 1)])
def test_level_col_mask_matches_the_reference(kw, level):
    """mtries k-of-F (ties of the k-th draw kept) and the Bernoulli rate
    with its all-false guard (rate 0.05 over 7 features leaves nodes with
    nothing drawn), ANDed with a tree's column subsample."""
    F, n_lv = 7, 2 ** level
    key = threefry.fold_in(threefry.prng_key(7), level)
    tree_cols = np.array([True, True, False, True, True, True, True])
    ref = jengine._level_col_mask(jnp.asarray(key), F, n_lv,
                                  jengine.TreeConfig(**kw),
                                  jnp.asarray(tree_cols), level)
    port = tengine._level_col_mask(key, F, n_lv, tengine.TreeConfig(**kw),
                                   torch.from_numpy(tree_cols), level)
    assert np.array_equal(port.numpy(), np.asarray(ref))
    assert not port[2].any()


# ---------------------------------------------------------------------------
# forests against the reference
# ---------------------------------------------------------------------------
def _data(K, n=N, seed=0):
    """Six numeric features (10% NA in x1), a 5-level categorical, and a
    K-class response through a noisy score cut at its quantiles (K = 1: the
    noisy score itself, a regression response)."""
    rng = np.random.default_rng(seed)
    cols = {f"x{j}": rng.normal(size=n).astype(np.float32) for j in range(6)}
    cols["x1"][rng.random(n) < 0.1] = np.nan
    cat = rng.integers(0, 5, n).astype(np.float32)
    z = (cols["x0"] - 0.5 * np.nan_to_num(cols["x1"])
         + 0.3 * cols["x2"] * cols["x3"] + 0.4 * (cat == 2))
    if K == 1:
        y = z + rng.normal(scale=0.5, size=n)
    elif K == 2:
        y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float32)
    else:
        cuts = np.quantile(z, np.linspace(0, 1, K + 1)[1:-1])
        y = np.digitize(z + rng.normal(scale=0.5, size=n), cuts)
    return cols, cat, y.astype(np.float32)


def _frames(K):
    cols, cat, y = _data(K)
    dom = [f"k{i}" for i in range(K)]
    one = meshmod.make_mesh(jax.devices()[:1])
    jfr = JFrame.from_dict(cols, mesh=one)
    jfr.add("c", JVec.from_numpy(cat, type=J_CAT, domain=LEVELS, mesh=one))
    fr = Frame.from_dict(cols, device="cpu")
    fr.add("c", Vec.from_numpy(cat, type=T_CAT, domain=LEVELS, device="cpu"))
    if K == 1:
        jfr.add("y", JVec.from_numpy(y, mesh=one))
        fr.add("y", Vec.from_numpy(y, device="cpu"))
    else:
        jfr.add("y", JVec.from_numpy(y, type=J_CAT, domain=dom, mesh=one))
        fr.add("y", Vec.from_numpy(y, type=T_CAT, domain=dom, device="cpu"))
    return one, jfr, fr


_SAMPLED = dict(sample_rate=0.7, col_sample_rate=0.6,
                col_sample_rate_per_tree=0.8,
                col_sample_rate_change_per_level=0.9)
#: case -> (reference builder, params, port builder, params, K, settings)
CASES = {
    "drf_binomial": (JDRF, JDRFParameters, DRF, DRFParameters, 2,
                     dict(ntrees=5, max_depth=5, seed=42)),
    "drf_regression": (JDRF, JDRFParameters, DRF, DRFParameters, 1,
                       dict(ntrees=4, max_depth=5, seed=3)),
    "drf_multinomial": (JDRF, JDRFParameters, DRF, DRFParameters, 3,
                        dict(ntrees=4, max_depth=5, seed=42)),
    "xrt": (JXRT, JXRTParameters, XRT, XRTParameters, 3,
            dict(ntrees=4, max_depth=5, seed=7)),
    "gbm_sampled": (JGBM, JGBMParameters, GBM, GBMParameters, 2,
                    dict(ntrees=5, max_depth=4, seed=42, **_SAMPLED)),
    "gbm_multinomial": (JGBM, JGBMParameters, GBM, GBMParameters, 3,
                        dict(ntrees=4, max_depth=4, seed=-1)),
}


def _train_both(case):
    JB, JP, TB, TP, K, kw = CASES[case]
    one, jfr, fr = _frames(K)
    with meshmod.use_mesh(one):
        jm = JB(JP(training_frame=jfr, response_column="y", **kw)
                ).train_model()
        jraw = np.asarray(jm.score0(jm.adapt_frame(jfr)))[:N]
        names = jm.output.names
        jedges = jbinning.compute_bin_edges_cols(
            [jfr.vec(n) for n in names],
            np.array([jfr.vec(n).is_categorical() for n in names]), 20,
            seed=kw["seed"] if kw["seed"] != -1 else 1234,
            histogram_type=JP().histogram_type)
    tm = TB(TP(training_frame=fr, response_column="y", **kw)).train_model()
    traw = tm.score0(tm.adapt_frame(fr)).numpy()[:N]
    return jm, jraw, jedges, tm, traw, fr


@pytest.mark.parametrize("case", sorted(CASES))
def test_forest_matches_the_reference(case):
    jm, jraw, jedges, tm, traw, fr = _train_both(case)
    drf = jm.cfg.drf_mode
    K = CASES[case][4]
    jf = {k: np.asarray(v) for k, v in jm.forest.items()}
    tf = {k: v.numpy() for k, v in tm.forest.items()}
    T = CASES[case][5]["ntrees"]
    assert tf["feat"].shape == jf["feat"].shape == (
        (T, tm.cfg.n_nodes) if K <= 2 else (T, K, tm.cfg.n_nodes))
    assert tm.cfg.drf_mode == drf and tm.cfg.mtries == jm.cfg.mtries
    assert np.array_equal(jf["feat"], tf["feat"])
    assert np.array_equal(jf["nanL"], tf["nanL"])
    split = jf["feat"] >= 0
    assert split.sum() > T * 3
    assert np.array_equal(jf["catd"][split], tf["catd"][split])
    np.testing.assert_allclose(tf["thr"][split], jf["thr"][split], rtol=1e-6)
    np.testing.assert_allclose(tm.f0.numpy(), np.asarray(jm.f0), rtol=1e-6)

    assert_varimp_equal(jm, tm)
    jmm, tmm = jm.output.training_metrics, tm.output.training_metrics
    assert type(tmm).__name__ == type(jmm).__name__
    assert tmm.description == jmm.description
    assert tmm.nobs == jmm.nobs
    if drf:
        assert tmm.description == "Reported on OOB data"
        if K == 1:
            # real responses: leaf means of real sums in other orders
            np.testing.assert_allclose(tf["val"], jf["val"], rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(traw, jraw, rtol=1e-5, atol=1e-6)
            assert tmm.mse == pytest.approx(jmm.mse, rel=1e-5)
            return
        # integer channels: identical leaf means and out-of-bag metrics
        assert np.array_equal(jf["val"], tf["val"])
        np.testing.assert_allclose(traw, jraw, atol=1e-6)
        assert tmm.mse == pytest.approx(jmm.mse, rel=1e-6)
        if K > 2:
            assert np.array_equal(tmm.confusion_matrix, jmm.confusion_matrix)
            assert tmm.logloss == pytest.approx(jmm.logloss, rel=1e-6)
            assert tmm.mean_per_class_error == jmm.mean_per_class_error
    else:
        np.testing.assert_allclose(tf["val"], jf["val"], atol=1e-5)
        np.testing.assert_allclose(traw, jraw, atol=1e-5)
        assert tmm.logloss == pytest.approx(jmm.logloss, rel=1e-5)
        assert tmm.mse == pytest.approx(jmm.mse, rel=1e-5)
    if K > 2:
        np.testing.assert_allclose(tmm.hit_ratio_table, jmm.hit_ratio_table,
                                   atol=1e-6)
        # from_reference: the reference forest scores the reference's rows
        cls = DRFModel if drf else GBMModel
        m = cls.from_reference(
            jf, np.asarray(jm.f0), jedges, jm.output.names,
            jm.output.domains, dataclasses.asdict(jm.cfg),
            category="Multinomial", response_domain=jm.output.response_domain,
            device="cpu")
        assert type(m) is cls and m.cfg.drf_mode == drf
        raw = m.score0(m.adapt_frame(fr)).numpy()[:N]
        np.testing.assert_allclose(raw[:, 1:], jraw[:, 1:], atol=1e-6)
        pred = m.predict(fr)
        assert pred.names == ["predict", "pk0", "pk1", "pk2"]
        assert np.array_equal(raw[:, 0], jraw[:, 0])
