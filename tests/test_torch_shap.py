"""Port parity: TreeSHAP contributions, node covers, leaf assignments and
staged predictions of the port's tree models (``h2o_tpu_torch/models/
tree/shap.py``, ``engine.forest_covers``, ``GBMModel``'s scoring
variants) against the reference (``h2o_tpu/models/tree/shap.py``,
``h2o_tpu/models/gbm.py:289-440``), the reference on a one-device mesh.

The frame is the scenario of ``tests/test_set_splits.py:82,91``: a
24-level categorical whose signal lives in a random half of its levels
(so the forests hold set splits) and a numeric column, with NAs in both.
Each model is trained once in each package, in the one test that reads
it. Contracts and tolerances:
- forests structurally equal (the premise of the rest);
- node covers (unit weights: integer counts) exactly equal;
- contributions within 1e-5 absolute; each row's sum within 1e-5 of the
  raw margin;
- leaf node ids exactly equal, path strings equal;
- staged predictions within 1e-6;
- the primitives and ``tree_shap`` itself, on forests written out by
  hand, within 1e-12 of the reference's numpy (both are float64);
- multinomial models raise the reference's ``ValueError``.
"""

import numpy as np
import pytest
import torch

import jax

from h2o_tpu.frame.frame import Frame as JFrame
from h2o_tpu.frame.vec import T_CAT as J_CAT
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.models import gbm as jgbm
from h2o_tpu.models.drf import DRF as JDRF
from h2o_tpu.models.drf import DRFParameters as JDRFParameters
from h2o_tpu.models.gbm import GBM as JGBM
from h2o_tpu.models.gbm import GBMParameters as JGBMParameters
from h2o_tpu.models.tree import shap as jshap
from h2o_tpu.models.xgboost import XGBoost as JXGBoost
from h2o_tpu.models.xgboost import XGBoostParameters as JXGBoostParameters
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import (DRF, GBM, XGBoost, DRFParameters, Frame,
                           GBMParameters, XGBoostParameters)
from h2o_tpu_torch.frame.vec import T_CAT, Vec
from h2o_tpu_torch.models import gbm as tgbm
from h2o_tpu_torch.models.tree import shap as tshap

from torch_parity import assert_forest_equal

torch.set_num_threads(2)

N = 1200
CARD = 24
DOM = [f"L{i:02d}" for i in range(CARD)]
TOL = 1e-5
STAGED_TOL = 1e-6


def _cols(n=N, seed=7):
    """``tests/test_set_splits.py:_cat_frame`` with NAs on every 41st
    categorical and 53rd numeric row."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, CARD, size=n).astype(np.float32)
    effect = rng.permutation(CARD) % 2
    x2 = rng.normal(size=n).astype(np.float32)
    y = (2.0 * (2 * effect[codes.astype(int)] - 1) + 0.5 * x2
         + rng.normal(0, 0.25, size=n)).astype(np.float32)
    codes[::41] = np.nan
    x2[::53] = np.nan
    return codes, x2, y


def _frames(binomial: bool):
    codes, x2, y = _cols()
    ydom = ["n", "p"] if binomial else None
    if binomial:   # noisy labels: no pure nodes, so no near-tied gains
        noise = np.random.default_rng(8).normal(0, 1.5, size=y.shape)
        y = (y + noise > 0).astype(np.float32)
    one = meshmod.make_mesh(jax.devices()[:1])
    jfr = JFrame(["c", "x2"], [
        JVec.from_numpy(codes, type=J_CAT, domain=DOM, mesh=one),
        JVec.from_numpy(x2, mesh=one)])
    jfr.add("y", JVec.from_numpy(y, mesh=one, **(
        dict(type=J_CAT, domain=ydom) if ydom else {})))
    fr = Frame(["c", "x2"], [
        Vec.from_numpy(codes, type=T_CAT, domain=DOM, device="cpu"),
        Vec.from_numpy(x2, device="cpu")])
    fr.add("y", Vec.from_numpy(y, device="cpu", **(
        dict(type=T_CAT, domain=ydom) if ydom else {})))
    return one, jfr, fr


#: (binomial response, reference builder/params, port builder/params, kw)
MODELS = {
    "gbm_regression": (False, JGBM, JGBMParameters, GBM, GBMParameters,
                       dict(ntrees=8, max_depth=4, seed=1)),
    "gbm_binomial": (True, JGBM, JGBMParameters, GBM, GBMParameters,
                     dict(ntrees=8, max_depth=4, seed=1)),
    "drf_binomial": (True, JDRF, JDRFParameters, DRF, DRFParameters,
                     dict(ntrees=6, max_depth=4, seed=3)),
    "xgboost_gbtree": (True, JXGBoost, JXGBoostParameters, XGBoost,
                       XGBoostParameters,
                       dict(ntrees=6, max_depth=4, seed=5, booster="gbtree")),
}


def _numpy_cols(frame) -> np.ndarray:
    return np.stack([frame.vec(j).to_numpy() for j in range(frame.ncol)], 1)


def _paths(frame) -> np.ndarray:
    """The path strings of a Path leaf-assignment frame, (R, T)."""
    out = []
    for j in range(frame.ncol):
        v = frame.vec(j)
        out.append(np.asarray(v.domain, dtype=object)[
            v.to_numpy().astype(np.int64)])
    return np.stack(out, 1)


@pytest.mark.parametrize("case", list(MODELS))
def test_scoring_variants_match_the_reference(case):
    """One model, trained once in each package: covers, contributions,
    leaf ids, paths and staged predictions against the reference's."""
    binomial, jb, jp, tb, tp, kw = MODELS[case]
    one, jfr, fr = _frames(binomial)
    with meshmod.use_mesh(one):
        jm = jb(jp(training_frame=jfr, response_column="y", **kw)
                ).train_model()
        jphi = _numpy_cols(jm.predict_contributions(jfr))
        jcover = np.asarray(jm.forest["cover"])
        jids = _numpy_cols(jm.predict_leaf_node_assignment(jfr, "Node_ID"))
        jpaths = _paths(jm.predict_leaf_node_assignment(jfr))
        jstaged = _numpy_cols(jm.staged_predict_proba(jfr))
        jraw = np.asarray(jm._raw_f(jm.adapt_frame(jfr)))[:N]
    tm = tb(tp(training_frame=fr, response_column="y", **kw)).train_model()
    assert_forest_equal(jm, tm, val_atol=TOL)

    phi_fr = tm.predict_contributions(fr)
    assert phi_fr.names == ["c", "x2", "BiasTerm"]
    np.testing.assert_array_equal(tm.forest["cover"].numpy(), jcover)
    phi = _numpy_cols(phi_fr)
    np.testing.assert_allclose(phi, jphi, rtol=0, atol=TOL)
    np.testing.assert_allclose(phi.astype(np.float64).sum(1), jraw, rtol=0,
                               atol=TOL)

    ids = tm.predict_leaf_node_assignment(fr, type="Node_ID")
    np.testing.assert_array_equal(_numpy_cols(ids), jids)
    paths = tm.predict_leaf_node_assignment(fr)
    assert paths.names == [f"T{t + 1}" for t in range(kw["ntrees"])]
    np.testing.assert_array_equal(_paths(paths), jpaths)

    staged = tm.staged_predict_proba(fr)
    np.testing.assert_allclose(_numpy_cols(staged), jstaged, rtol=0,
                               atol=STAGED_TOL)
    last = tm.predict(fr).vec(2 if binomial else 0).to_numpy()
    np.testing.assert_allclose(staged.vec(staged.ncol - 1).to_numpy(), last,
                               rtol=0, atol=STAGED_TOL)


def test_multinomial_models_refuse_like_the_reference():
    codes, x2, _ = _cols(300)
    fr = Frame.from_dict({"x2": x2}, device="cpu")
    fr.add("y", Vec.from_numpy(np.nan_to_num(codes) % 3, type=T_CAT,
                               domain=["a", "b", "c"], device="cpu"))
    m = GBM(GBMParameters(training_frame=fr, response_column="y", ntrees=2,
                          max_depth=2)).train_model()
    with pytest.raises(ValueError, match="regression and binomial"):
        m.predict_contributions(fr)
    with pytest.raises(ValueError, match="regression and binomial"):
        m.staged_predict_proba(fr)
    ids = m.predict_leaf_node_assignment(fr, type="Node_ID")
    assert ids.names == ["T1.Ca", "T1.Cb", "T1.Cc", "T2.Ca", "T2.Cb",
                         "T2.Cc"]


def test_heap_paths_are_the_references():
    assert [tgbm._heap_path(n) for n in range(200)] == \
        [jgbm._heap_path(n) for n in range(200)]


def _random_path(rng, R, depth):
    pw, zf, of = [], [], []
    for _ in range(depth):
        pz = float(rng.random())
        po = (rng.random(R) < 0.6).astype(np.float64)
        pw, zf, of = jshap._extend(pw, zf, of, pz, po)
    return pw, zf, of


@pytest.mark.parametrize("depth", [1, 3, 6])
def test_path_primitives_are_the_references(depth):
    """EXTEND, UNWIND and the unwound sum on the same random paths."""
    rng = np.random.default_rng(depth)
    pw, zf, of = _random_path(rng, 64, depth)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float64))
    tpw, tof = [t(a) for a in pw], [t(a) for a in of]
    po = (rng.random(64) < 0.5).astype(np.float64)
    jx = jshap._extend(pw, zf, of, 0.37, po)
    tx = tshap._extend(tpw, list(zf), tof, 0.37, t(po))
    for a, b in zip(jx[0], tx[0]):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-12, atol=1e-15)
    sums = tshap._unwound_sums(tpw, list(zf), tof).numpy()
    for i in range(len(zf)):
        ju = jshap._unwind(pw, zf, of, i)
        tu = tshap._unwind(tpw, list(zf), tof, i)
        assert tu[1] == ju[1]
        for a, b in zip(ju[0], tu[0]):
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-12, atol=1e-15)
        if i:
            np.testing.assert_allclose(sums[i - 1],
                                       jshap._unwound_sum(pw, zf, of, i),
                                       rtol=1e-12, atol=1e-15)


def _heap_forest(rng, T, depth, F, nb, cats):
    """Random complete-heap trees, leaves wherever a subtree is cut."""
    N = 2 ** (depth + 1) - 1
    feat = np.full((T, N), -1, np.int32)
    thr = np.zeros((T, N), np.float32)
    nanL = rng.random((T, N)) < 0.5
    val = rng.normal(size=(T, N)).astype(np.float32)
    catd = (rng.random((T, N, nb)) < 0.5).astype(np.float32)
    cover = np.zeros((T, N), np.float32)
    for t in range(T):
        cover[t, 0] = 1000.0
        for j in range(2 ** depth - 1):
            if cover[t, j] == 0 or (j > 0 and rng.random() < 0.2):
                continue
            feat[t, j] = rng.integers(0, F)
            thr[t, j] = rng.normal()
            left = np.floor(cover[t, j] * rng.uniform(0.2, 0.8))
            cover[t, 2 * j + 1], cover[t, 2 * j + 2] = left, cover[t, j] - left
        feat[t][cover[t] == 0] = -1
    return feat, thr, nanL, val, cover, catd


@pytest.mark.parametrize("sets", [False, True])
def test_tree_shap_is_the_references_on_written_forests(sets):
    """`tree_shap` on hand-written forests (repeated features along a
    path, NAs, set splits) against the reference's on the same rows."""
    rng = np.random.default_rng(11 + sets)
    F, nb, R = 4, 6, 300
    feat, thr, nanL, val, cover, catd = _heap_forest(rng, 5, 5, F, nb,
                                                     sets)
    X = rng.normal(size=(R, F)).astype(np.float32)
    iscat = np.array([True, False, True, False]) if sets else None
    nedges = np.array([nb - 1, 0, 3, 0], np.int64) if sets else None
    if sets:
        X[:, [0, 2]] = rng.integers(0, 8, size=(R, 2))
    X[rng.random((R, F)) < 0.1] = np.nan
    kw = dict(catd=catd if sets else None, iscat=iscat, nedges=nedges)
    ref = jshap.tree_shap(X, feat, thr, nanL, val, cover, bias0=0.25,
                          scale=0.5, **kw)
    port = tshap.tree_shap(torch.from_numpy(X), feat, thr, nanL, val, cover,
                           bias0=0.25, scale=0.5, depth=5, **kw)
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-12, atol=1e-12)
