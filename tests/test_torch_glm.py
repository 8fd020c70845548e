"""Port parity: DataInfo's design expansion and the GLM build of
``h2o_tpu_torch`` against the reference (``h2o_tpu/models``), plus the
carry-over of a reference model, and what GLM still refuses.

Each GLM case fits the same model in both packages on the same frame
(numpy data from a seed; the reference on a one-device mesh), once per
module. Contracts and tolerances:

- coefficients within atol ``beta_epsilon`` (1e-5) + rtol 1e-4: the Gram's
  float32 sums run in other orders in the two packages, and the IRLS solve
  carries that through a few iterations;
- equal IRLS iteration counts (the convergence tests run on float64 host
  values in both), except on the lambda search, where they may differ by
  one: its deviance-plateau stop compares two float32 deviance sums a few
  ulps apart, so any two summation orders can stop one iteration apart
  (data seeds 8, 11 and 15 of ``_cols`` do). That step moves beta by less
  than ``beta_epsilon``: over seeds 8-19 the coefficients stayed within
  1.2e-6 of the reference's whether the counts agreed or not;
- lambda within a relative 1e-5: lambda_max is read off the float32
  gradient b - G beta, a difference of two sums (measured up to 1.0e-6);
- null and residual deviance within a relative 1e-5;
- training AUC within 1e-4 (one row's share of a 1024-bin AUC can move when
  a prediction crosses a bin edge);
- predictions within 1e-5, and within 1e-6 for the reference's
  coefficients carried over with ``GLMModel.from_reference``;
- design expansion: the one-hot block exactly equal, numerics within 1e-6
  (the rollup means and sigmas are float32 sums in other orders).
"""

import numpy as np
import pytest
import torch

import jax

from h2o_tpu.frame.frame import Frame as JFrame
from h2o_tpu.frame.vec import T_CAT as J_CAT
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.models.datainfo import DataInfo as JDataInfo
from h2o_tpu.models.glm import GLM as JGLM
from h2o_tpu.models.glm import GLMParameters as JGLMParameters
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import GLM, GBM, Frame, GBMParameters, GLMModel, \
    GLMParameters
from h2o_tpu_torch.frame.vec import T_CAT, Vec
from h2o_tpu_torch.models.datainfo import DataInfo

from torch_parity import LazyCases

torch.set_num_threads(2)

N = 8000
CAT_DOM = ["a", "b", "c", "d"]


def _cols(n, seed=12):
    """Six normal features (f3 with 5% NA) and a 4-level categorical (5%
    NA); the linear predictor every response below is built from."""
    rng = np.random.default_rng(seed)
    cols = {f"f{j}": rng.normal(size=n).astype(np.float32) for j in range(6)}
    cols["f3"][rng.random(n) < 0.05] = np.nan
    cat = rng.integers(0, 4, n).astype(np.float32)
    lin = cols["f0"] - 0.5 * cols["f1"] + 0.25 * cols["f2"] + 0.3 * (cat == 2)
    cat[rng.random(n) < 0.05] = np.nan
    resp = {
        "binomial": (rng.random(n) < 1 / (1 + np.exp(-lin))).astype(np.float32),
        "gaussian": (lin + 0.1 * rng.normal(size=n)).astype(np.float32),
        "poisson": rng.poisson(np.exp(0.3 * lin)).astype(np.float32),
    }
    extra = {"wt": rng.uniform(0.5, 2.0, n).astype(np.float32),
             "off": (0.1 * rng.normal(size=n)).astype(np.float32)}
    return cols, cat, resp, extra


def _frames(kind, n=N, with_extra=False):
    """The same columns as a reference Frame (one-device mesh) and a port
    Frame on the CPU."""
    cols, cat, resp, extra = _cols(n)
    one = meshmod.make_mesh(jax.devices()[:1])
    y = resp[kind]
    names = list(cols) + ["cat", "y"] + (list(extra) if with_extra else [])
    data = dict(cols, cat=cat, y=y, **(extra if with_extra else {}))
    with meshmod.use_mesh(one):
        jfr = JFrame.from_dict(cols, mesh=one)
        fr = Frame.from_dict(cols, device="cpu")
        for nm in names[len(cols):]:
            if nm == "cat":
                jv = JVec.from_numpy(data[nm], type=J_CAT, domain=CAT_DOM,
                                     mesh=one)
                tv = Vec.from_numpy(data[nm], type=T_CAT, domain=CAT_DOM,
                                    device="cpu")
            elif nm == "y" and kind == "binomial":
                jv = JVec.from_numpy(y, type=J_CAT, domain=["n", "p"],
                                     mesh=one)
                tv = Vec.from_numpy(y, type=T_CAT, domain=["n", "p"],
                                    device="cpu")
            else:
                jv = JVec.from_numpy(data[nm], mesh=one)
                tv = Vec.from_numpy(data[nm], device="cpu")
            jfr.add(nm, jv)
            fr.add(nm, tv)
    return jfr, fr, one


#: (case, response kind, frame has weights/offset, GLM parameters)
CASES = {
    "gaussian": ("gaussian", False, dict(family="gaussian", lambda_=0.0)),
    "binomial": ("binomial", False, dict(family="binomial")),
    "binomial_lambda_search": ("binomial", False,
                               dict(family="binomial", lambda_search=True)),
    "cod_non_negative": ("binomial", False,
                         dict(family="binomial", solver="COORDINATE_DESCENT",
                              lambda_=1e-3, non_negative=True)),
    "poisson_weights_offset": ("poisson", True,
                               dict(family="poisson", weights_column="wt",
                                    offset_column="off")),
}


@pytest.fixture(scope="module")
def fits():
    """Each case fitted once in both packages, on first use: (reference
    model, its raw scores, port model, its raw scores, the port frame)."""
    def fit(case):
        kind, extra, kw = CASES[case]
        jfr, fr, one = _frames(kind, with_extra=extra)
        common = dict(response_column="y", seed=42,
                      ignored_columns=["wt", "off"] if extra else [], **kw)
        with meshmod.use_mesh(one):
            jm = JGLM(JGLMParameters(training_frame=jfr, **common)
                      ).train_model()
            jraw = np.asarray(jm.score0(jm.adapt_frame(jfr)))[:N]
        tm = GLM(GLMParameters(training_frame=fr, **common)).train_model()
        traw = tm.score0(tm.adapt_frame(fr)).numpy()[:N]
        return jm, jraw, tm, traw, fr

    return LazyCases(fit)


@pytest.mark.parametrize("case", list(CASES))
def test_glm_matches_the_reference(fits, case):
    jm, jraw, tm, traw, _fr = fits[case]
    jb, tb = np.asarray(jm.beta, np.float64), tm.beta
    assert tb.shape == jb.shape
    np.testing.assert_allclose(tb, jb, rtol=1e-4,
                               atol=tm.params.beta_epsilon)
    jh, th = jm.output.scoring_history[-1], tm.output.scoring_history[-1]
    if tm.params.lambda_search:
        assert abs(th["iterations"] - jh["iterations"]) <= 1
    else:
        assert th["iterations"] == jh["iterations"]
    assert th["lambda"] == pytest.approx(jh["lambda"], rel=1e-5)
    jmm, tmm = jm.output.training_metrics, tm.output.training_metrics
    for k in ("residual_deviance", "null_deviance"):
        assert getattr(tmm, k) == pytest.approx(getattr(jmm, k), rel=1e-5)
    for k in ("residual_degrees_of_freedom", "null_degrees_of_freedom"):
        assert getattr(tmm, k) == getattr(jmm, k)
    assert tmm.aic == pytest.approx(jmm.aic, rel=1e-5)
    if tm.output.model_category == "Binomial":
        assert tmm.auc == pytest.approx(jmm.auc, abs=1e-4)
        assert tmm.logloss == pytest.approx(jmm.logloss, rel=1e-5)
        np.testing.assert_array_equal(traw[:, 0], jraw[:, 0])
    np.testing.assert_allclose(traw, jraw, atol=1e-5)
    if jm.dispersion_estimated is not None:
        assert tm.dispersion_estimated == pytest.approx(
            jm.dispersion_estimated, rel=1e-4)
    jv = jm.output.variable_importances
    assert tm.output.variable_importances["variable"][:3] == jv["variable"][:3]
    if case == "gaussian":   # the generating coefficients, recovered
        c = tm.coef()
        assert abs(c["f0"] - 1.0) < 0.05
        assert abs(c["f1"] + 0.5) < 0.05
        assert abs(c["f2"] - 0.25) < 0.05
        np.testing.assert_allclose(list(c.values()), list(jm.coef().values()),
                                   rtol=1e-4, atol=1e-5)
    if case == "cod_non_negative":
        assert np.all(tb[:-1] >= 0) and np.any(tb[:-1] == 0)


@pytest.mark.parametrize("case", ["binomial", "poisson_weights_offset"])
def test_from_reference_scores_what_the_reference_scores(fits, case):
    jm, jraw, _tm, _traw, fr = fits[case]
    m = GLMModel.from_reference(jm, device="cpu")
    np.testing.assert_allclose(m.score0(m.adapt_frame(fr)).numpy()[:N], jraw,
                               atol=1e-6)
    assert m.coef().keys() == jm.coef().keys()
    pred = m.predict(fr)
    assert pred.names[0] == "predict" and pred.vec(0).nrow == N


@pytest.mark.parametrize("mvh", ["MeanImputation", "Skip"])
def test_datainfo_expand_matches_the_reference(mvh):
    """Training expansion, then scoring on a frame whose categorical has a
    permuted domain with one level unseen in training (it imputes like an
    NA)."""
    jfr, fr, one = _frames("gaussian")   # the fits' shapes: no recompile
    names = [f"f{j}" for j in range(6)] + ["cat"]
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 5, N).astype(np.float32)
    codes[::37] = np.nan
    sdom = ["d", "zz", "a", "c", "b"]
    with meshmod.use_mesh(one):
        jdi = JDataInfo.make(jfr, names, standardize=True,
                             missing_values_handling=mvh)
        jX, jok = (np.asarray(a) for a in jdi.expand(jfr))
        jsc = JFrame.from_dict({n: fr.vec(n).to_numpy() for n in names[:-1]},
                               mesh=one)
        jsc.add("cat", JVec.from_numpy(codes, type=J_CAT, domain=sdom,
                                       mesh=one))
        jXs, joks = (np.asarray(a) for a in jdi.expand(jsc))
    di = DataInfo.make(fr, names, standardize=True,
                       missing_values_handling=mvh)
    assert di.names == jdi.names and di.expanded_names == jdi.expanded_names
    assert di.cat_modes == jdi.cat_modes
    X, ok = di.expand(fr)
    sc = Frame.from_dict({n: fr.vec(n).to_numpy() for n in names[:-1]},
                         device="cpu")
    sc.add("cat", Vec.from_numpy(codes, type=T_CAT, domain=sdom,
                                 device="cpu"))
    Xs, oks = di.expand(sc)
    for a, b, aok, bok in ((X, jX, ok, jok), (Xs, jXs, oks, joks)):
        a = a.numpy()
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_array_equal(a[:, :3], b[:, :3])      # one-hot
        np.testing.assert_allclose(a[:, 3:], b[:, 3:], atol=1e-6)
        np.testing.assert_array_equal(aok.numpy(), bok)
    Xi, _ = di.expand(fr, intercept=True)
    assert torch.equal(Xi[:, :-1], X) and bool((Xi[:, -1] == 1).all())


@pytest.mark.parametrize("change", [
    dict(feature_parallelism=2),
    dict(feature_parallelism=4, family="multinomial"),
])
def test_out_of_slice_options_raise(change):
    """What GLM still refuses: ``feature_parallelism`` > 1 lays the design
    over several cards (ROADMAP Queue 1 item 1, step M). The other options
    this test once refused (ordinal, HGLM, interactions, beta and linear
    constraints, p-values, L_BFGS, alpha lists, ``ml`` dispersion) train
    now; their parity with the reference is in ``test_torch_glm_options.py``
    and ``test_torch_glm_models.py``."""
    _jfr, fr, _one = _frames("binomial", n=500)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 1\\b"):
        GLM(GLMParameters(training_frame=fr, response_column="y",
                          **change)).train_model()


def test_gbm_still_refuses_an_offset_column():
    """The GBM no longer refuses an offset column: as the reference's, it
    takes the column, leaves it out of the features and never reads it
    (ROADMAP Queue 3: H2O-3's GBM fits offsets), so the forest is the one
    grown with the column ignored. GBM's parity with the reference's
    forest under an offset is in test_torch_gbm_options.py."""
    _jfr, fr, _one = _frames("binomial", n=500)
    off = np.random.default_rng(3).normal(size=500).astype(np.float32)
    fr.add("off", Vec.from_numpy(off, device="cpu"))
    kw = dict(training_frame=fr, response_column="y", ntrees=1)
    m = GBM(GBMParameters(offset_column="off", **kw)).train_model()
    ref = GBM(GBMParameters(ignored_columns=["off"], **kw)).train_model()
    assert "off" not in m.output.names
    for k in ("feat", "thr", "nanL", "val"):
        assert torch.equal(m.forest[k], ref.forest[k])
