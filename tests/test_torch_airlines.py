"""Port parity: the airlines-shaped categorical GBM of ``h2o_tpu_torch``
against the reference — categorical bin cuts, the width-bucketed histogram
plan, set splits, set-split routing and scoring, the domain remap at
prediction, and the carry-over of a set-split forest.

The frame is the recipe of ``bench.py:_airlines_frame`` (seven categorical
columns with their real cardinalities, hub-skewed 300-level Origin/Dest,
two numerics; seed 116) at 20k rows, so both packages take the quantile
sketch and the grouped plan. The JAX side runs on a one-device mesh.
Contracts and tolerances:

- forest structure exactly equal: split features, NA directions and the
  set-split direction table ``catd``; numeric split thresholds within 1e-6
  relative (the bin edges' own tolerance), categorical ones exactly;
- leaf values and predictions within 1e-5: the histograms' g/h sums run in
  different orders, and XLA's and torch's exp differ in the last ulp;
- training AUC within 1e-4 (a prediction crossing one of the 1024 AUC bins
  moves it by one row's share), logloss within 1e-5 relative;
- the reference forest loaded with ``GBMModel.from_reference`` scores the
  reference's rows within 1e-6;
- set-split search on one histogram: identical (feature, bin, NA
  direction, direction rows, set flags), gains within rtol 1e-5;
- ``adapt_frame`` on a frame whose domains are permuted and hold an unseen
  level: exactly the reference's matrix (NaN where the reference has NaN).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o_tpu.backend.kernels import hist as jhist
from h2o_tpu.frame.frame import Frame as JFrame
from h2o_tpu.frame.vec import T_CAT as J_CAT
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.models import model_base as jmodel_base
from h2o_tpu.models.gbm import GBM as JGBM
from h2o_tpu.models.gbm import GBMParameters as JGBMParameters
from h2o_tpu.models.tree import binning as jbinning
from h2o_tpu.models.tree import engine as jengine
from h2o_tpu.parallel import mesh as meshmod
from chip_smoke import _airlines_cols   # the card run's copy of the recipe
from h2o_tpu_torch import GBM, Frame, GBMModel, GBMParameters
from h2o_tpu_torch.frame.vec import T_CAT, Vec
from h2o_tpu_torch.models import model_base as tmodel_base
from h2o_tpu_torch.models.tree import engine as tengine

torch.set_num_threads(2)

N = 20_000
KW = dict(response_column="IsDepDelayed", ntrees=3, max_depth=5, nbins=20,
          learn_rate=0.1, seed=42)


def _frames(cols, y, one):
    """(reference frame on the mesh ``one``, port frame on the CPU)."""
    def jv(a, dom):
        a = a.astype(np.float32)
        return (JVec.from_numpy(a, type=J_CAT, domain=list(dom), mesh=one)
                if dom else JVec.from_numpy(a, mesh=one))

    def tv(a, dom):
        a = a.astype(np.float32)
        return (Vec.from_numpy(a, type=T_CAT, domain=list(dom), device="cpu")
                if dom else Vec.from_numpy(a, device="cpu"))

    names = list(cols)
    jfr = JFrame(names, [jv(*cols[n]) for n in names])
    jfr.add("IsDepDelayed", jv(y, ["NO", "YES"]))
    fr = Frame(names, [tv(*cols[n]) for n in names])
    fr.add("IsDepDelayed", tv(y, ["NO", "YES"]))
    return jfr, fr


def test_airlines_gbm_matches_the_reference():
    """One test for the slice end to end (the reference's training compile
    is most of its time, so it is paid once): the plan, forest structure and
    set-split table, leaf values, predictions, training metrics, and the
    carry-over of the reference's set-split forest into the port."""
    cols, y = _airlines_cols(N)
    one = meshmod.make_mesh(jax.devices()[:1])
    with meshmod.use_mesh(one):
        jfr, fr = _frames(cols, y, one)
        jm = JGBM(JGBMParameters(training_frame=jfr, **KW)).train_model()
        jraw = np.asarray(jm.score0(jm.adapt_frame(jfr)))[:N]
        jedges = jbinning.compute_bin_edges_cols(
            [jfr.vec(n) for n in jm.output.names], np.asarray(jm.is_cat), 20)
    tm = GBM(GBMParameters(training_frame=fr, **KW)).train_model()
    traw = tm.score0(tm.adapt_frame(fr)).numpy()[:N]

    assert tm.cfg.hist_groups == jm.cfg.hist_groups == (
        ((0, 2, 4, 7, 8), 32, "onehot"), ((1,), 16, "onehot"),
        ((3,), 8, "segsum"), ((5, 6), 301, "onehot"))
    assert tm.cfg.use_sets and jm.cfg.use_sets and tm.cfg.nbins == 300
    jf = {k: np.asarray(v) for k, v in jm.forest.items()}
    tf = {k: v.numpy() for k, v in tm.forest.items()}
    for k in ("feat", "nanL", "catd"):
        assert np.array_equal(jf[k], tf[k]), k
    split = jf["feat"] >= 0
    is_cat = np.asarray(jm.is_cat)
    cat_split = split & is_cat[np.clip(jf["feat"], 0, None)]
    assert cat_split.sum() >= 3 * 5 and (split & ~cat_split).any()
    assert np.array_equal(tm.is_cat, is_cat)
    assert np.array_equal(tm.cat_nedges, np.asarray(jm.cat_nedges))
    np.testing.assert_allclose(tf["thr"][split], jf["thr"][split], rtol=1e-6)
    assert np.array_equal(tf["thr"][cat_split], jf["thr"][cat_split])

    np.testing.assert_allclose(tf["val"], jf["val"], atol=1e-5)
    np.testing.assert_allclose(traw, jraw, atol=1e-5)
    jmm, tmm = jm.output.training_metrics, tm.output.training_metrics
    assert tmm.auc == pytest.approx(jmm.auc, abs=1e-4)
    assert tmm.logloss == pytest.approx(jmm.logloss, rel=1e-5)
    assert tmm.auc > 0.7

    assert np.array_equal(np.isnan(jedges), np.isnan(tm.edges))
    m = GBMModel.from_reference(
        jf, np.asarray(jm.f0), jedges, jm.output.names, jm.output.domains,
        dataclasses.asdict(jm.cfg), category="Binomial",
        response_domain=["NO", "YES"], device="cpu")
    assert np.array_equal(m.is_cat, is_cat)
    assert np.array_equal(m.cat_nedges, np.asarray(jm.cat_nedges))
    raw = m.score0(m.adapt_frame(fr)).numpy()[:N]
    np.testing.assert_allclose(raw[:, 1:], jraw[:, 1:], atol=1e-6)
    assert m.predict(fr).names == ["predict", "pNO", "pYES"]


def _set_split_hist(seed=3):
    """A level histogram of bernoulli channels from the reference's scan:
    feature 0 categorical with 12 levels whose effect is not monotone in
    the code (a set split beats every cut), feature 1 numeric, feature 2
    categorical with an empty level; node 3 is empty."""
    rng = np.random.default_rng(seed)
    R, B, n_lv = 8192, 13, 4
    eff = rng.normal(0, 1.5, 12)
    codes = np.stack([rng.integers(0, 12, R), rng.integers(0, 12, R),
                      rng.choice([0, 1, 2, 4, 5], R)], 1)
    codes[:, 1] = np.where(rng.random(R) < 0.1, B - 1, codes[:, 1])  # NA
    lc = rng.integers(0, n_lv - 1, R).astype(np.int32)
    p = 1 / (1 + np.exp(-eff[codes[:, 0]]))
    y = (rng.random(R) < p).astype(np.float32)
    pr = np.full(R, 0.5, np.float32)
    vv = np.stack([np.ones(R), pr - y, pr * (1 - pr)], 1).astype(np.float32)
    return np.array(jhist.level_hist_blocks(
        jnp.asarray(codes, jnp.int8), jnp.asarray(lc), jnp.asarray(vv),
        n_lv=n_lv, nbins_tot=B, block=1024, backend="xla"))


def test_find_splits_with_set_splits_matches_the_reference():
    hist = _set_split_hist()
    Fh, n_lv = hist.shape[:2]
    iscat = np.array([True, False, True])
    nedges = np.array([11, 11, 5], np.int32)
    edge_ok = np.ones((Fh, 11), bool)
    colmask = np.ones((Fh, n_lv), bool)
    kw = dict(nbins=12, min_rows=10.0, use_sets=True)
    ref = jengine._find_splits(
        jnp.asarray(hist), jnp.asarray(colmask), jnp.asarray(edge_ok),
        jengine.TreeConfig(**kw), iscat=jnp.asarray(iscat),
        nedges=jnp.asarray(nedges))
    port = tengine._find_splits(
        torch.from_numpy(hist), torch.from_numpy(colmask),
        torch.from_numpy(edge_ok), tengine.TreeConfig(**kw),
        iscat=torch.from_numpy(iscat), nedges=torch.from_numpy(nedges))
    for i in (1, 2, 3, 7, 8):      # feat, bin, NA dir, direction rows, flags
        assert np.array_equal(np.asarray(ref[i]), port[i].numpy()), i
    assert bool(port[8][0]) and int(port[1][0]) == 0   # a set split won
    assert not np.isfinite(port[0][-1].item())          # empty node
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), rtol=1e-5)
    for i in (4, 5, 6):
        np.testing.assert_allclose(port[i].numpy(), np.asarray(ref[i]),
                                   rtol=1e-5, atol=1e-6)


def test_adapt_frame_remaps_domains_like_the_reference():
    """A scoring frame whose categorical domain is permuted, holds a level
    the training domain lacks, and has NAs; plus a numeric column."""
    train_dom = ["a", "b", "c", "d"]
    test_dom = ["d", "x", "b", "a", "c"]                  # "x" is unseen
    codes = np.array([0, 1, 2, 3, 4, np.nan, 1, 0], np.float32)
    num = np.linspace(-1, 1, 8).astype(np.float32)
    output = dict(names=["c", "n"], domains={"c": train_dom, "n": None})

    one = meshmod.make_mesh(jax.devices()[:1])
    with meshmod.use_mesh(one):
        jfr = JFrame(["n", "c"], [
            JVec.from_numpy(num, mesh=one),
            JVec.from_numpy(codes, type=J_CAT, domain=test_dom, mesh=one)])
        jout = jmodel_base.ModelOutput()
        jout.names, jout.domains = output["names"], output["domains"]
        # the reference's adapt_frame on a stand-in model: it reads only
        # ``output`` and ``pre_adapt``
        jself = types.SimpleNamespace(output=jout, pre_adapt=lambda f: f)
        ref = np.asarray(jmodel_base.Model.adapt_frame(jself, jfr))
    fr = Frame(["n", "c"], [
        Vec.from_numpy(num, device="cpu"),
        Vec.from_numpy(codes, type=T_CAT, domain=test_dom, device="cpu")])
    out = tmodel_base.ModelOutput()
    out.names, out.domains = output["names"], output["domains"]
    port = tmodel_base.Model(tmodel_base.Parameters(), out).adapt_frame(fr)
    port = port.numpy()
    np.testing.assert_array_equal(port, ref)        # NaN where ref has NaN
    np.testing.assert_array_equal(port[:8, 0], [3, np.nan, 1, 0, 2, np.nan,
                                                np.nan, 3])


SCALE_N = 100_000


def test_airlines_forest_at_scale_matches_the_reference():
    """The airlines GBM at 100,000 rows x 5 trees, the largest size that
    runs in about 20 s here (the reference's training compile is most of
    it). The reference sums a leaf's channels as float32 blocks and the
    port in 64-bit fixed point, so at scale the two could part where the
    reference's sums drift; on the CPU at 100,000 and 1,000,000 rows they
    do not: forest structure and set-split tables stay exactly equal, leaf
    values within 1e-5 (measured 1.9e-7 and 5.2e-8), predictions within
    1e-5, training AUC within 1e-4."""
    cols, y = _airlines_cols(SCALE_N)
    kw = dict(KW, ntrees=5)
    one = meshmod.make_mesh(jax.devices()[:1])
    with meshmod.use_mesh(one):
        jfr, fr = _frames(cols, y, one)
        jm = JGBM(JGBMParameters(training_frame=jfr, **kw)).train_model()
        jraw = np.asarray(jm.score0(jm.adapt_frame(jfr)))[:SCALE_N]
    tm = GBM(GBMParameters(training_frame=fr, **kw)).train_model()
    traw = tm.score0(tm.adapt_frame(fr)).numpy()[:SCALE_N]
    jf = {k: np.asarray(v) for k, v in jm.forest.items()}
    tf = {k: v.numpy() for k, v in tm.forest.items()}
    for k in ("feat", "nanL", "catd"):
        assert np.array_equal(jf[k], tf[k]), k
    split = jf["feat"] >= 0
    assert split.sum() >= 5 * 15
    np.testing.assert_allclose(tf["thr"][split], jf["thr"][split], rtol=1e-6)
    np.testing.assert_allclose(tf["val"], jf["val"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(traw, jraw, rtol=0, atol=1e-5)
    assert tm.output.training_metrics.auc == pytest.approx(
        jm.output.training_metrics.auc, abs=1e-4)
