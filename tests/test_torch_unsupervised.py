"""Port parity: the ``jax.random`` draws of the unsupervised slice, the
``supervised`` flag, and KMeans, PCA and SVD of ``h2o_tpu_torch`` against
the reference (``h2o_tpu/models/kmeans.py``, ``pca.py``).

Each model is fitted once per module in both packages on the same frame
(numpy data from a seed; the reference on a one-device mesh). Contracts
and tolerances:

- ``threefry``: uniform on [minval, maxval), permutation, cumsum and the
  three ``choice`` forms bit-equal to the live ``jax.random`` (0.9.0);
  ``normal`` within 3 ulps (XLA's ``log1p`` inside ``erf_inv`` and
  ``torch.log1p`` differ by up to 2 ulps, and √2· adds a rounding);
- KMeans (every init, ``estimate_k``, user points, standardize on and
  off): centers within 1e-5, assignments equal (the blobs leave no near
  ties), ``tot_withinss`` and ``totss`` within 1e-5 relative, the same
  iteration count; a carried reference model assigns the same rows; the
  ``kmeans_two_blob_withinss`` band of ``tests/accuracy_expectations.json``;
- PCA/SVD (GramSVD under every transform, Power, Randomized; a categorical
  column): standard deviations and singular values within 1e-5 relative,
  eigenvectors equal up to sign (|cos| >= 1 - 1e-5; the eigenvalues are
  well separated), projections within 1e-5 of the largest after the same
  sign flips; Randomized starts from ``normal``, so it takes the same
  tolerances as the rest (its subspace iteration converges past the
  start's ulps).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o_tpu.frame.frame import Frame as JFrame
from h2o_tpu.frame.vec import T_CAT as J_CAT
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.models.kmeans import KMeans as JKMeans
from h2o_tpu.models.kmeans import KMeansParameters as JKMeansParameters
from h2o_tpu.models.pca import PCA as JPCA
from h2o_tpu.models.pca import SVD as JSVD
from h2o_tpu.models.pca import PCAParameters as JPCAParameters
from h2o_tpu.models.pca import SVDParameters as JSVDParameters
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import (GBM, PCA, SVD, Frame, GBMParameters, KMeans,
                           KMeansModel, KMeansParameters, PCAModel,
                           PCAParameters, SVDModel, SVDParameters,
                           load_model)
from h2o_tpu_torch.frame.vec import T_CAT, Vec
from h2o_tpu_torch.models import kmeans as tkmeans
from h2o_tpu_torch.utils import threefry

torch.set_num_threads(2)

N = 600
DOM = ["a", "b", "c"]


# ---------------------------------------------------------------------------
# threefry draws
# ---------------------------------------------------------------------------
def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("shape,lo,hi", [
    ((7, 13), -0.3, 0.3), ((717, 200), -0.0809, 0.0809),
    ((1000,), float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform_range_is_bit_equal_to_jax(shape, lo, hi):
    key = jax.random.PRNGKey(42)
    ref = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))
    port = threefry.uniform(threefry.prng_key(42), shape, minval=lo,
                            maxval=hi).numpy()
    np.testing.assert_array_equal(port, ref)


def test_normal_within_three_ulps_of_jax():
    key = jax.random.PRNGKey(42)
    ref = np.asarray(jax.random.normal(key, (717, 58)))
    port = threefry.normal(threefry.prng_key(42), (717, 58)).numpy()
    assert _ulps(port, ref).max() <= 3
    assert (port == ref).mean() > 0.98
    x = np.linspace(-0.9999999, 0.9999999, 20001, dtype=np.float32)
    from jax._src.lax import special as lax_special
    erf_ref = np.asarray(jax.jit(lax_special.erf_inv)(jnp.asarray(x)))
    erf_port = threefry._erf_inv(torch.from_numpy(x)).numpy()
    assert _ulps(erf_port, erf_ref).max() <= 2


@pytest.mark.parametrize("n", [1625, 1626, 60160])
def test_permutation_is_bit_equal_to_jax(n):
    """One sort round up to n = 1625, two beyond (⌈3 ln n / ln(2³²−1)⌉)."""
    ref = np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.PRNGKey(42), 3), n))
    port = threefry.permutation(threefry.fold_in(threefry.prng_key(42), 3), n)
    np.testing.assert_array_equal(port.numpy(), ref)


@pytest.mark.parametrize("n", [129, 60160])
def test_cumsum_and_choice_are_bit_equal_to_jax(n):
    rng = np.random.default_rng(n)
    w = (rng.random(n) < 0.9).astype(np.float32)
    d2 = (rng.random(n) ** 3).astype(np.float32) * w
    for p in (w / w.sum(), d2 / d2.sum()):
        np.testing.assert_array_equal(
            threefry.cumsum(torch.from_numpy(p)).numpy(),
            np.asarray(jnp.cumsum(jnp.asarray(p))))
        for j in range(2):
            jk = jax.random.fold_in(jax.random.PRNGKey(7), j)
            tk = threefry.fold_in(threefry.prng_key(7), j)
            pt, pj = torch.from_numpy(p), jnp.asarray(p)
            assert int(threefry.choice(tk, n, p=pt)) == \
                int(jax.random.choice(jk, n, p=pj))
            np.testing.assert_array_equal(
                threefry.choice(tk, n, (5,), replace=False, p=pt).numpy(),
                np.asarray(jax.random.choice(jk, n, (5,), replace=False,
                                             p=pj)))
            np.testing.assert_array_equal(
                threefry.choice(tk, n, (5,), replace=False).numpy(),
                np.asarray(jax.random.choice(jk, n, (5,), replace=False)))


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------
def _cols(n=N, seed=0):
    """Four well-separated blobs in three numeric columns (one with NAs)
    and a 3-level categorical."""
    rng = np.random.default_rng(seed)
    centers = np.array([[0, 0, 0], [6, 6, 1], [-6, 6, 2], [0, -7, 3]],
                       np.float32)
    X = np.concatenate([rng.normal(c, 1.0, size=(n // 4, 3))
                        for c in centers]).astype(np.float32)
    X = X[rng.permutation(n)]
    cols = {f"x{j}": X[:, j].copy() for j in range(3)}
    cols["x2"][::53] = np.nan
    cat = rng.integers(0, 3, n).astype(np.float32)
    return cols, cat


@pytest.fixture(scope="module")
def frames():
    cols, cat = _cols()
    one = meshmod.make_mesh(jax.devices()[:1])
    with meshmod.use_mesh(one):
        jfr = JFrame.from_dict(cols, mesh=one)
        jfr.add("c", JVec.from_numpy(cat, type=J_CAT, domain=DOM, mesh=one))
    fr = Frame.from_dict(cols, device="cpu")
    fr.add("c", Vec.from_numpy(cat, type=T_CAT, domain=DOM, device="cpu"))
    return jfr, fr, one


def _train_both(jcls, jpcls, cls, pcls, frames, kw):
    jfr, fr, one = frames
    with meshmod.use_mesh(one):
        jm = jcls(jpcls(training_frame=jfr, **kw)).train_model()
        jpred = np.stack([np.asarray(v.to_numpy())
                          for v in jm.predict(jfr).vecs], axis=1)
    tm = cls(pcls(training_frame=fr, **kw)).train_model()
    tpred = np.stack([v.to_numpy() for v in tm.predict(fr).vecs], axis=1)
    return jm, jpred, tm, tpred


# ---------------------------------------------------------------------------
# the supervised flag
# ---------------------------------------------------------------------------
def test_unsupervised_builds_need_no_response(frames, monkeypatch):
    _jfr, fr, _one = frames
    seen, build = [], KMeans.build_impl
    monkeypatch.setattr(KMeans, "build_impl", lambda self, job: seen.append(
        self.params.response_column) or build(self, job))
    m = KMeans(KMeansParameters(training_frame=fr, k=2)).train_model()
    assert seen == [None] and m.output.names == ["x0", "x1", "x2", "c"]
    with pytest.raises(ValueError, match="response_column is required"):
        GBM(GBMParameters(training_frame=fr, ntrees=1))
    with pytest.raises(ValueError, match="not in frame"):
        GBM(GBMParameters(training_frame=fr, response_column="nope"))


def test_unsupervised_cv_skips_stratification_and_keeps_cluster_metrics(
        frames):
    _jfr, fr, _one = frames
    m = KMeans(KMeansParameters(training_frame=fr, k=4, seed=3, nfolds=3,
                                fold_assignment="Stratified",
                                keep_cross_validation_predictions=True)
               ).train_model()
    cvm = m.output.cross_validation_metrics
    assert isinstance(cvm, tkmeans.ClusteringMetrics)
    assert len(m.output.cv_models) == 3
    assert m.output.cv_holdout_predictions.nrow == N


# ---------------------------------------------------------------------------
# KMeans
# ---------------------------------------------------------------------------
KM_CASES = {
    "furthest": dict(k=4, init="Furthest"),
    "random": dict(k=4, init="Random"),
    "plusplus": dict(k=4, init="PlusPlus"),
    "estimate_k": dict(k=6, estimate_k=True),
    "user_raw": dict(k=4, init="User", standardize=False, user_points=np.array(
        [[0, 0, 0, 0], [1, 6, 6, 1], [2, -6, 6, 2], [0, 0, -7, 3]],
        np.float32)),
}


@pytest.fixture(scope="module")
def kmeans_fits(frames):
    return {case: _train_both(JKMeans, JKMeansParameters, KMeans,
                              KMeansParameters, frames,
                              dict(seed=42, max_iterations=20, **kw))
            for case, kw in KM_CASES.items()}


@pytest.mark.parametrize("case", list(KM_CASES))
def test_kmeans_matches_the_reference(kmeans_fits, frames, case):
    jm, jpred, tm, tpred = kmeans_fits[case]
    assert tm.centers.shape == jm.centers.shape
    np.testing.assert_allclose(tm.centers, jm.centers, atol=1e-5)
    np.testing.assert_allclose(tm.centers_std.numpy(),
                               np.asarray(jm.centers_std), atol=1e-5)
    np.testing.assert_array_equal(tpred, jpred)
    jt, tt = jm.output.training_metrics, tm.output.training_metrics
    for f in ("tot_withinss", "totss", "betweenss"):
        assert getattr(tt, f) == pytest.approx(getattr(jt, f), rel=1e-5)
    np.testing.assert_array_equal(tt.sizes, jt.sizes)
    assert tm.output.num_iterations == jm.output.num_iterations
    assert tm.output.model_category == jm.output.model_category
    carried = KMeansModel.from_reference(jm, device="cpu")
    _jfr, fr, _one = frames
    np.testing.assert_array_equal(carried.predict(fr).vec(0).to_numpy(),
                                  jpred[:, 0])
    perf = tm.model_performance(fr)
    assert perf.tot_withinss == pytest.approx(tt.tot_withinss, rel=1e-6)


def test_kmeans_two_blob_band():
    """The reference's accuracy case (``tests/accuracy_util.py``) through
    the port: within the stored band (5% relative)."""
    rng = np.random.default_rng(5)
    X = np.concatenate([rng.normal(0, 0.5, (500, 3)),
                        rng.normal(4, 0.5, (500, 3))]).astype(np.float32)
    fr = Frame.from_dict({f"x{j}": X[:, j] for j in range(3)}, device="cpu")
    m = KMeans(KMeansParameters(training_frame=fr, k=2, seed=7)
               ).train_model()
    with open(os.path.join(os.path.dirname(__file__),
                           "accuracy_expectations.json")) as f:
        exp = json.load(f)["kmeans_two_blob_withinss"]["value"]
    assert abs(m.output.training_metrics.tot_withinss - exp) <= 0.05 * exp


def test_kmeans_user_points_must_match_the_design(frames):
    _jfr, fr, _one = frames
    with pytest.raises(ValueError, match="user_points"):
        KMeans(KMeansParameters(training_frame=fr, k=2, init="User",
                                user_points=np.zeros((2, 3)))).train_model()


# ---------------------------------------------------------------------------
# PCA / SVD
# ---------------------------------------------------------------------------
PCA_CASES = {f"gram_{t.lower()}": dict(transform=t, pca_method="GramSVD")
             for t in ("NONE", "STANDARDIZE", "NORMALIZE", "DEMEAN",
                       "DESCALE")}
PCA_CASES.update({"power": dict(transform="STANDARDIZE", pca_method="Power"),
                  "randomized": dict(transform="STANDARDIZE",
                                     pca_method="Randomized")})
SVD_CASES = {m.lower(): dict(transform="STANDARDIZE", svd_method=m)
             for m in ("GramSVD", "Power", "Randomized")}


@pytest.fixture(scope="module")
def pca_fits(frames):
    out = {}
    for case, kw in PCA_CASES.items():
        out["pca_" + case] = _train_both(JPCA, JPCAParameters, PCA,
                                         PCAParameters, frames,
                                         dict(k=3, seed=5, **kw))
    for case, kw in SVD_CASES.items():
        out["svd_" + case] = _train_both(JSVD, JSVDParameters, SVD,
                                         SVDParameters, frames,
                                         dict(nv=3, seed=5, **kw))
    return out


@pytest.mark.parametrize("case", ["pca_" + c for c in PCA_CASES]
                         + ["svd_" + c for c in SVD_CASES])
def test_pca_svd_match_the_reference(pca_fits, frames, case):
    jm, jpred, tm, tpred = pca_fits[case]
    jd, td = np.asarray(jm.d), tm.d.numpy()
    np.testing.assert_allclose(td, jd, rtol=1e-5)
    jV, tV = np.asarray(jm.V), tm.V.numpy()
    dots = (jV * tV).sum(axis=0)
    cos = np.abs(dots) / np.linalg.norm(jV, axis=0) / np.linalg.norm(tV,
                                                                      axis=0)
    assert cos.min() >= 1 - 1e-5
    sign = np.sign(dots)
    np.testing.assert_allclose(tpred * sign, jpred,
                               atol=1e-5 * np.abs(jpred).max())
    np.testing.assert_allclose(tm.mu.numpy(), np.asarray(jm.mu), atol=1e-6)
    if case.startswith("pca_"):
        jv, tv = jm.output.variable_importances, tm.output.variable_importances
        assert tv["pc"] == jv["pc"]
        for f in ("std_deviation", "proportion_of_variance",
                  "cumulative_proportion"):
            np.testing.assert_allclose(tv[f], jv[f], rtol=1e-5)
        assert tm.eigenvector_names == jm.eigenvector_names
        carried = PCAModel.from_reference(jm, device="cpu")
    else:
        np.testing.assert_allclose(tm.singular_values, jm.singular_values,
                                   rtol=1e-5)
        carried = SVDModel.from_reference(jm, device="cpu")
    _jfr, fr, _one = frames
    cp = np.stack([v.to_numpy() for v in carried.predict(fr).vecs], axis=1)
    np.testing.assert_allclose(cp, jpred, atol=1e-6 * np.abs(jpred).max())
    assert carried.predict(fr).names == tm.predict(fr).names


@pytest.mark.parametrize("case", ["kmeans", "pca", "svd"])
def test_unsupervised_models_save_and_load(kmeans_fits, pca_fits, frames,
                                           tmp_path, case):
    _jfr, fr, _one = frames
    tm = {"kmeans": kmeans_fits["furthest"][2],
          "pca": pca_fits["pca_gram_standardize"][2],
          "svd": pca_fits["svd_gramsvd"][2]}[case]
    m2 = load_model(tm.save(str(tmp_path / f"{case}.bin")), device="cpu")
    assert type(m2) is type(tm)
    assert m2.params.training_frame is None   # frames are not model state
    for a, b in zip(tm.predict(fr).vecs, m2.predict(fr).vecs):
        assert torch.equal(a.data, b.data)
