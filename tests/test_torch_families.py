"""Port parity: ``threefry.randint``, Isolation Forest and Extended IF,
AdaBoost, Naive Bayes, isotonic regression and quantiles
(``h2o_tpu_torch/utils/threefry.py``, ``models/isofor.py``,
``models/adaboost.py``, ``models/naivebayes.py``, ``models/isotonic.py``,
``models/quantile.py``) against the reference on a one-device mesh
(oracles ``tests/test_misc_algos.py`` and
``tests/test_glrm_w2v_ada.py:91,108``).

Two tests run every check (the driver's suite is scheduled by xdist in
chunks whose length moves with the test count, so this slice adds few
test items); each reference model trains once, on at most 2,000 rows (the
classic isolation forest: 100,001 rows, its trees on 128-row samples).
Tolerances:

- ``randint``: bit-equal to live ``jax.random.randint`` (tolerance 0);
- Isolation Forest: split flags and subsample counts equal, directions
  (one-hot) and cuts bit-equal; Extended IF: flags and counts equal,
  directions and cuts within 1e-6 (its normals are within 3 ulps of
  jax's, ROADMAP Queue 3 item 9, and the port projects in float64);
  scores within 1e-6, mean path lengths within 1e-5;
- AdaBoost: the same number of learners, DRF learners' forests as
  ``torch_parity.assert_forest_equal`` holds them (leaves within 1e-6),
  alphas within 1e-9 relative, probabilities within 1e-6;
- Naive Bayes: priors and categorical tables bit-equal, Gaussian
  means and sdevs within 1e-6 relative, probabilities within 1e-5 (the
  reference sums its log terms in float32, the port in float64);
- isotonic: thresholds and fitted values bit-equal, predictions within
  1e-6 (NA and clip);
- quantiles: every combine method and the weighted ranks within 1e-6
  relative (LOW and HIGH, order statistics, bit-equal).
"""

import numpy as np
import pytest

import jax

from h2o_tpu.models import adaboost as jada
from h2o_tpu.models import isofor as jiso
from h2o_tpu.models import isotonic as jisot
from h2o_tpu.models import naivebayes as jnb
from h2o_tpu.models import quantile as jq
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch.models import adaboost as tada
from h2o_tpu_torch.models import isofor as tiso
from h2o_tpu_torch.models import isotonic as tisot
from h2o_tpu_torch.models import naivebayes as tnb
from h2o_tpu_torch.models import quantile as tq
from h2o_tpu_torch.utils import threefry

from torch_parity import assert_forest_equal, frames, train_both


RANDINT_CASES = [
    (0, (256,), 0, 284807),      # the subsample draw above 100,000 rows
    (3, (50, 256), 0, 100001),
    (7, (31,), 0, 30),           # a split feature of 30
    (9, (40,), 5, 5),            # empty span: minval
    (11, (1000,), -3, 2 ** 31 - 1),
    (13, (1000,), 0, 65537)]


def _check_randint(seed, shape, lo, hi):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.randint(key, shape, lo, hi))
    got = threefry.randint(np.asarray(key), shape, lo, hi)
    assert np.array_equal(got.numpy(), want)


def _fit_isofor(case):
    rng = np.random.default_rng(2)
    n = 100_001 if case == "classic" else 1500
    X = rng.normal(size=(n, 5)).astype(np.float32)
    X[:10] += 5.0
    X[::41, 3] = np.nan
    cols = {f"x{j}": X[:, j] for j in range(5)}
    ext = 2 if case == "extended" else 0
    kw = dict(ntrees=10, sample_size=128, seed=3, extension_level=ext)
    one, jfr, fr = frames(cols)
    jb = jiso.ExtendedIsolationForest if ext else jiso.IsolationForest
    tb = tiso.ExtendedIsolationForest if ext else tiso.IsolationForest
    with meshmod.use_mesh(one):
        jm = jb(jiso.IsolationForestParameters(training_frame=jfr,
                                               **kw)).train_model()
        jp = jm.predict(jfr)
    tm = tb(tiso.IsolationForestParameters(training_frame=fr,
                                           **kw)).train_model()
    return jm, tm, jp, tm.predict(fr)


def _check_isolation_forest(case):
    """Trees and scores at the module docstring's tolerances: the classic
    forest on 100,001 rows, whose subsamples come from ``randint``, the
    extended one on 1,500, whose subsamples are permutations' heads."""
    jm, tm, jp, tp = _fit_isofor(case)
    jw, jt, js, jc = (np.asarray(a) for a in jm.forest)
    tw, tt, ts, tc = (a.numpy() for a in tm.forest)
    assert tm.depth == jm.depth and tm.sample_size == jm.sample_size
    assert np.array_equal(ts, js) and js.sum() > 0
    assert np.array_equal(tc, jc)
    if case == "extended":
        np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tt, jt, rtol=1e-6, atol=1e-6)
    else:
        assert np.array_equal(tw, jw) and np.array_equal(tt, jt)
    for j in range(2):
        np.testing.assert_allclose(tp.vec(j).to_numpy(),
                                   np.asarray(jp.vec(j).to_numpy()),
                                   rtol=0, atol=1e-6 if j == 0 else 1e-5)
    assert tm.output.training_metrics.mean_length == pytest.approx(
        jm.output.training_metrics.mean_length, rel=1e-5)


def _ada_cols(n=2000, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = ((X[:, 0] + 0.6 * X[:, 1] + rng.normal(scale=0.7, size=n)) > 0)
    return ({"a": X[:, 0], "b": X[:, 1], "d": X[:, 2] * 3 + 10},
            y.astype(np.float32))


def _fit_ada(kind):
    cols, y = _ada_cols()
    jm, tm, jfr, fr = train_both(jada.AdaBoost, jada.AdaBoostParameters,
                                 tada.AdaBoost, tada.AdaBoostParameters,
                                 cols, y, ["n", "p"], nlearners=3,
                                 weak_learner=kind, seed=3)
    with meshmod.use_mesh(meshmod.make_mesh(jax.devices()[:1])):
        jp = jm.predict(jfr)
    return jm, tm, jp, tm.predict(fr)


def _check_adaboost(kind):
    jm, tm, jp, tp = _fit_ada(kind)
    assert len(tm.learners) == len(jm.learners) == 3
    np.testing.assert_allclose(tm.alphas, jm.alphas, rtol=1e-9)
    if kind == "DRF":
        for a, b in zip(jm.learners, tm.learners):
            assert_forest_equal(a, b, 1e-6)
    assert tp.names == jp.names
    for j in (1, 2):
        np.testing.assert_allclose(tp.vec(j).to_numpy(),
                                   np.asarray(jp.vec(j).to_numpy()),
                                   rtol=0, atol=1e-6)
    assert tm.output.training_metrics.auc == pytest.approx(
        jm.output.training_metrics.auc, abs=1e-6)


def _check_naive_bayes():
    """Tables, Gaussians and probabilities with Laplace smoothing, a
    categorical with NAs and a floored sdev, at the module docstring's
    tolerances."""
    from h2o_tpu.frame.vec import T_CAT as J_CAT
    from h2o_tpu.frame.vec import Vec as JVec
    from h2o_tpu_torch.frame.vec import T_CAT, Vec

    cols, y = _ada_cols()
    rng = np.random.default_rng(8)
    c = rng.integers(0, 4, y.shape[0]).astype(np.float32)
    c[::23] = np.nan
    cols["k"] = np.where(y > 0, 7.0, 7.0001).astype(np.float32)  # tiny sdev
    one, jfr, fr = frames(cols, y, ["n", "p"])
    jfr.add("c", JVec.from_numpy(c, mesh=one, type=J_CAT, domain=list("wxyz")))
    fr.add("c", Vec.from_numpy(c, device="cpu", type=T_CAT,
                               domain=list("wxyz")))
    kw = dict(response_column="y", laplace=1.0, min_sdev=0.01)
    with meshmod.use_mesh(one):
        jm = jnb.NaiveBayes(jnb.NaiveBayesParameters(training_frame=jfr,
                                                     **kw)).train_model()
        jp = jm.predict(jfr)
    tm = tnb.NaiveBayes(tnb.NaiveBayesParameters(training_frame=fr,
                                                 **kw)).train_model()
    tp = tm.predict(fr)
    assert tm.feat_meta == [tuple(m) for m in jm.feat_meta]
    assert np.array_equal(tm.priors.numpy(), np.asarray(jm.priors))
    assert np.array_equal(tm.tables["c"].numpy(), np.asarray(jm.tables["c"]))
    for k in jm.gauss:
        np.testing.assert_allclose(tm.gauss[k].numpy(),
                                   np.asarray(jm.gauss[k]), rtol=1e-6)
    for j in (1, 2):
        np.testing.assert_allclose(tp.vec(j).to_numpy(),
                                   np.asarray(jp.vec(j).to_numpy()),
                                   rtol=0, atol=1e-5)
    assert np.array_equal(tp.vec(0).to_numpy(),
                          np.asarray(jp.vec(0).to_numpy()))


def _check_isotonic(oob):
    """Pooled ties, weights and NA rows; predictions inside and outside
    the fitted range."""
    rng = np.random.default_rng(9)
    n = 2000
    x = np.round(rng.uniform(0, 10, n), 2).astype(np.float32)
    x[::53] = np.nan
    y = (np.sqrt(np.nan_to_num(x)) + 0.3 * rng.normal(size=n)).astype(
        np.float32)
    w = rng.integers(0, 3, n).astype(np.float32)
    one, jfr, fr = frames({"x": x, "w": w}, y)
    kw = dict(response_column="y", weights_column="w", out_of_bounds=oob)
    with meshmod.use_mesh(one):
        jm = jisot.IsotonicRegression(jisot.IsotonicParameters(
            training_frame=jfr, **kw)).train_model()
    tm = tisot.IsotonicRegression(tisot.IsotonicParameters(
        training_frame=fr, **kw)).train_model()
    assert np.array_equal(tm.xs, jm.xs) and np.array_equal(tm.ys, jm.ys)
    probe = np.concatenate([x, [-1.0, 11.0, np.nan]]).astype(np.float32)
    one, jpf, tpf = frames({"x": probe})
    with meshmod.use_mesh(one):
        jp = np.asarray(jm.predict(jpf).vec(0).to_numpy())
    tp = tm.predict(tpf).vec(0).to_numpy()
    assert np.array_equal(np.isnan(tp), np.isnan(jp))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)


def _check_quantiles(method):
    """One sort per column; NAs dropped; weighted ranks."""
    rng = np.random.default_rng(12)
    n = 2000
    cols = {"u": rng.uniform(-5, 5, n).astype(np.float32),
            "t": np.round(rng.standard_t(3, n), 1).astype(np.float32),
            "w": rng.integers(0, 4, n).astype(np.float32)}
    cols["t"][::19] = np.nan
    kw = dict(combine_method="INTERPOLATE" if method == "weighted"
              else method,
              weights_column="w" if method == "weighted" else None)
    one, jfr, fr = frames(cols)
    with meshmod.use_mesh(one):
        jm = jq.QuantileBuilder(jq.QuantileParameters(training_frame=jfr,
                                                      **kw)).train_model()
    tm = tq.QuantileBuilder(tq.QuantileParameters(training_frame=fr,
                                                  **kw)).train_model()
    assert list(tm.quantiles) == list(jm.quantiles)
    for k, want in jm.quantiles.items():
        if method in ("LOW", "HIGH"):
            assert np.array_equal(tm.quantiles[k], np.asarray(want))
        else:
            np.testing.assert_allclose(tm.quantiles[k], np.asarray(want),
                                       rtol=1e-6, atol=0)


def test_families_match_the_reference():
    """``randint`` against live ``jax.random``, both isolation forests,
    Naive Bayes, isotonic (NA and clip) and quantiles (every combine
    method, weighted ranks), at the module docstring's tolerances."""
    for case in RANDINT_CASES:
        _check_randint(*case)
    for case in ("classic", "extended"):
        _check_isolation_forest(case)
    _check_naive_bayes()
    for oob in ("NA", "clip"):
        _check_isotonic(oob)
    for method in ("INTERPOLATE", "AVERAGE", "LOW", "HIGH", "weighted"):
        _check_quantiles(method)


def test_adaboost_matches_the_reference():
    """SAMME rounds over the DRF (default) and GLM weak learners."""
    for kind in ("DRF", "GLM"):
        _check_adaboost(kind)
