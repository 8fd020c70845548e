"""Port parity: GLM's interactions, ordinal and HGLM models, their carry-
over with ``GLMModel.from_reference``, and the two builders over GLM —
``ANOVAGLM`` and ``ModelSelection`` in every mode — against the reference
(``h2o_tpu/models/glm.py``, ``anovaglm.py``, ``modelselection.py``).

Each case fits the same model in both packages on the same seeded numpy
columns (at most 2,000 rows and 8 features; the reference on a one-device
mesh), once, in the one test that reads it: the reference's scenarios of
``tests/test_glm.py:225,411-540,611``, ``tests/test_hglm.py`` and
``tests/test_gam_rulefit_svm.py:100,120``. Contracts and tolerances:

- GLM coefficients within atol 1e-5 + rtol 1e-4, equal iteration counts
  (``test_torch_glm.py``'s); interaction columns equal (cat×cat codes
  exactly, products within 1e-6), and predictions through the replayed
  expansion within 1e-5;
- ordinal: optax's Adam written out step for step; after its 100-500
  float32 steps beta and the thresholds within atol 1e-5 + rtol 1e-4
  (measured 2.4e-7), the same step count;
- HGLM: the variance components within a relative 1e-5, fixed effects and
  random intercepts within atol 1e-5 (the cross products are float32 sums
  in other orders, the EM float64 on both sides; measured 1.7e-6);
- carried models score within 1e-6 of the reference;
- ANOVA: each term's df equal, its likelihood-ratio deviance within 1e-6
  of the reduced model's residual deviance (it is the difference of two
  float32 deviance sums, the reduced one the larger), its p-value within
  1e-3 (the reference takes
  ``1 - gammainc`` in float32, the port scipy's ``gammaincc`` in float64);
- ModelSelection: the same predictors at every size, R² within 1e-6,
  coefficients within atol 1e-5 + rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.frame.vec import T_CAT as J_CAT
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.models.anovaglm import ANOVAGLM as JANOVAGLM
from h2o_tpu.models.anovaglm import ANOVAGLMParameters as JANOVAGLMParameters
from h2o_tpu.models.glm import GLM as JGLM
from h2o_tpu.models.glm import GLMParameters as JGLMParameters
from h2o_tpu.models.glm import _apply_interactions as j_apply_interactions
from h2o_tpu.models.modelselection import ModelSelection as JModelSelection
from h2o_tpu.models.modelselection import \
    ModelSelectionParameters as JModelSelectionParameters
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import (ANOVAGLM, GLM, ANOVAGLMParameters,
                           GLMModel, GLMParameters, ModelSelection,
                           ModelSelectionParameters, load_model)
from h2o_tpu_torch.frame.vec import T_CAT, Vec
from h2o_tpu_torch.models.glm import _apply_interactions

import torch_parity as tp

torch.set_num_threads(2)


def _add_cat(one, jfr, fr, name, codes, domain):
    codes = np.asarray(codes, np.float32)
    jfr.add(name, JVec.from_numpy(codes, type=J_CAT, domain=list(domain),
                                  mesh=one))
    fr.add(name, Vec.from_numpy(codes, type=T_CAT, domain=list(domain),
                                device="cpu"))


def _same_coefficients(jm, tm):
    jb, tb = np.asarray(jm.beta, np.float64), np.asarray(tm.beta)
    assert tb.shape == jb.shape
    np.testing.assert_allclose(tb, jb, rtol=1e-4, atol=1e-5)


def _both(one, jfr, fr, **kw):
    with meshmod.use_mesh(one):
        jm = JGLM(JGLMParameters(training_frame=jfr, response_column="y",
                                 **kw)).train_model()
    tm = GLM(GLMParameters(training_frame=fr, response_column="y",
                           **kw)).train_model()
    return jm, tm


def _scores(jm, tm, one, jfr, fr):
    with meshmod.use_mesh(one):
        jraw = np.asarray(jm.score0(jm.adapt_frame(jfr)))[:fr.nrow]
    return jraw, tm.score0(tm.adapt_frame(fr)).numpy()[:fr.nrow]


# -- interactions (tests/test_glm.py:411-540) ---------------------------------
def _interaction_frames(case):
    if case == "num_num":
        rng = np.random.default_rng(8)
        x1 = rng.normal(size=2000).astype(np.float32)
        x2 = rng.normal(size=2000).astype(np.float32)
        y = (x1 + 2.0 * x1 * x2 + 0.05 * rng.normal(size=2000)
             ).astype(np.float32)
        return tp.frames({"x1": x1, "x2": x2}, y), \
            dict(interactions=["x1", "x2"])
    if case == "cat_num":
        rng = np.random.default_rng(21)
        g = rng.integers(0, 3, 2000)
        x = rng.normal(size=2000).astype(np.float32)
        y = (np.array([1.0, -2.0, 3.0])[g] * x
             + 0.05 * rng.normal(size=2000)).astype(np.float32)
        one, jfr, fr = tp.frames({"x": x}, y)
        _add_cat(one, jfr, fr, "g", g, ["a", "b", "c"])
        return (one, jfr, fr), dict(interaction_pairs=[("g", "x")])
    rng = np.random.default_rng(22)           # cat_cat: XOR of two levels
    a, b = rng.integers(0, 2, 2000), rng.integers(0, 3, 2000)
    y = (((a ^ (b > 0)) + 0.05 * rng.normal(size=2000))).astype(np.float32)
    one, jfr, fr = tp.frames({"z": rng.normal(size=2000).astype(np.float32)},
                             y)
    _add_cat(one, jfr, fr, "u", a, ["a0", "a1"])
    _add_cat(one, jfr, fr, "v", b, ["b_0", "b1", "New_York"])
    # the pairs alone (the mains left out) keep the design of full rank
    return (one, jfr, fr), dict(interaction_pairs=[("u", "v"), ("z", "u")],
                                ignored_columns=["u", "v"])


@pytest.mark.parametrize("case", ["num_num", "cat_num", "cat_cat"])
def test_interactions_match_the_reference(case, tmp_path):
    """Each kind of pair (``tests/test_glm.py:411,438,467``): the same frozen
    spec, the same generated columns, the same fit; scoring replays the
    expansion on a fresh frame whose categorical domains differ, and a
    saved and loaded model scores alike."""
    (one, jfr, fr), kw = _interaction_frames(case)
    jm, tm = _both(one, jfr, fr, family="gaussian", lambda_=0.0,
                   standardize=False, **kw)
    assert tm.interaction_spec == jm.interaction_spec
    assert tm.dinfo.expanded_names == jm.dinfo.expanded_names
    _same_coefficients(jm, tm)
    assert tm.output.scoring_history[-1]["iterations"] == \
        jm.output.scoring_history[-1]["iterations"]
    assert tm.output.training_metrics.r2 == pytest.approx(
        jm.output.training_metrics.r2, abs=1e-6)
    assert tm.output.training_metrics.r2 > 0.95
    jraw, traw = _scores(jm, tm, one, jfr, fr)
    np.testing.assert_allclose(traw, jraw, atol=1e-5)
    # a fresh frame: 7 rows, domains permuted or short, one unseen level
    rng = np.random.default_rng(1)
    sub = {n: fr.vec(n).to_numpy()[:7] for n in fr.names
           if not fr.vec(n).is_categorical() and n != "y"}
    one2, jsc, sc = tp.frames(sub)
    for n in fr.names:
        v = fr.vec(n)
        if v.is_categorical():
            dom = list(reversed(v.domain)) + ["unseen"]
            codes = rng.integers(0, len(dom), 7)
            _add_cat(one2, jsc, sc, n, codes, dom)
    with meshmod.use_mesh(one2):
        jp = jm.predict(jsc).vec(0).to_numpy()
    tpred = tm.predict(sc).vec(0).to_numpy()
    np.testing.assert_allclose(tpred, jp, atol=1e-5)
    tm.save(str(tmp_path / "m.bin"))
    back = load_model(str(tmp_path / "m.bin"), device="cpu")
    assert torch.equal(back.predict(sc).vec(0).data,
                       tm.predict(sc).vec(0).data)


def test_interaction_guards_match_the_reference():
    """``tests/test_glm.py:504``: a special column, a colliding generated
    name and a multinomial fit refuse in both packages; column indices
    freeze to names, and a reordered scoring frame without the response
    scores alike."""
    rng = np.random.default_rng(0)
    x1 = rng.normal(size=200).astype(np.float32)
    x2 = rng.normal(size=200).astype(np.float32)
    y = (x1 + x2).astype(np.float32)
    one, jfr, fr = tp.frames({"x1": x1, "x2": x2}, y)
    for kw, err, match in ((dict(interactions=["x1", "y"]), ValueError,
                            "special column"),):
        with meshmod.use_mesh(one), pytest.raises(err, match=match):
            JGLM(JGLMParameters(training_frame=jfr, response_column="y",
                                family="gaussian", **kw)).train_model()
        with pytest.raises(err, match=match):
            GLM(GLMParameters(training_frame=fr, response_column="y",
                              family="gaussian", **kw)).train_model()
    onec, jc, tc = tp.frames({"x1": x1, "x2": x2, "x1_x2": x1 * 0}, y)
    with meshmod.use_mesh(onec), pytest.raises(ValueError, match="collides"):
        JGLM(JGLMParameters(training_frame=jc, response_column="y",
                            family="gaussian", interactions=["x1", "x2"])
             ).train_model()
    with pytest.raises(ValueError, match="collides"):
        GLM(GLMParameters(training_frame=tc, response_column="y",
                          family="gaussian", interactions=["x1", "x2"])
            ).train_model()
    lab = ((y > 0).astype(int) + (x1 > 1)).astype(np.float32)
    onem, jmf, tmf = tp.frames({"x1": x1, "x2": x2}, lab, ["a", "b", "c"])
    with meshmod.use_mesh(onem), pytest.raises(NotImplementedError,
                                               match="single-block"):
        JGLM(JGLMParameters(training_frame=jmf, response_column="y",
                            family="multinomial", interactions=["x1", "x2"])
             ).train_model()
    with pytest.raises(NotImplementedError, match="single-block"):
        GLM(GLMParameters(training_frame=tmf, response_column="y",
                          family="multinomial", interactions=["x1", "x2"])
            ).train_model()
    jm, tm = _both(one, jfr, fr, family="gaussian", lambda_=0.0,
                   standardize=False, interactions=[0, 1])
    _same_coefficients(jm, tm)
    one2, jsc, sc = tp.frames({"x2": np.array([2.0], np.float32),
                               "x1": np.array([1.0], np.float32)})
    with meshmod.use_mesh(one2):
        jp = jm.predict(jsc).vec(0).to_numpy()
    tpred = tm.predict(sc).vec(0).to_numpy()
    np.testing.assert_allclose(tpred, jp, atol=1e-5)
    assert abs(tpred[0] - 3.0) < 0.1


def test_legacy_interaction_labels_match_the_reference():
    """``tests/test_glm.py:611``: a legacy cat×cat spec (labels only) maps
    to the same codes, levels with underscores included, and an ambiguous
    label refuses in both packages."""
    one, jfr, fr = tp.frames({"d": np.zeros(4, np.float32)})
    _add_cat(one, jfr, fr, "u", [0, 0, 1, 1], ["New_York", "LA"])
    _add_cat(one, jfr, fr, "v", [0, 1, 0, 1], ["x", "Y_z"])
    legacy = {"kind": "catcat", "a": "u", "b": "v",
              "labels": ["New_York_x", "New_York_Y_z", "LA_x", "LA_Y_z"]}
    with meshmod.use_mesh(one):
        jout, jnames = j_apply_interactions(jfr, [legacy])
        jcodes = jout.vec("u_v").to_numpy()
    out, names = _apply_interactions(fr, [legacy])
    assert names == jnames == ["u_v"]
    np.testing.assert_array_equal(out.vec("u_v").to_numpy(), jcodes)
    np.testing.assert_array_equal(jcodes, [0.0, 1.0, 2.0, 3.0])
    one2, jf2, f2 = tp.frames({"d": np.zeros(2, np.float32)})
    _add_cat(one2, jf2, f2, "u", [0, 1], ["New", "New_York"])
    _add_cat(one2, jf2, f2, "v", [0, 1], ["York_b", "b"])
    amb = {"kind": "catcat", "a": "u", "b": "v", "labels": ["New_York_b"]}
    with meshmod.use_mesh(one2), pytest.raises(ValueError, match="matches 2"):
        j_apply_interactions(jf2, [amb])
    with pytest.raises(ValueError, match="matches 2"):
        _apply_interactions(f2, [amb])


# -- ordinal and HGLM, and their carry-over ----------------------------------
def _ordinal_frames():
    """``tests/test_glm.py:225``: 3 ordered classes cut at ±1.5 on 2x plus
    logistic noise, with a second (noise) feature."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=2000).astype(np.float32)
    z = rng.normal(size=2000).astype(np.float32)
    y = np.digitize(2.0 * x + rng.logistic(size=2000), [-1.5, 1.5])
    return tp.frames({"x": x, "z": z}, y.astype(np.float32),
                     ["low", "mid", "high"])


def _hglm_frames(n=2000, q=20):
    """``tests/test_hglm.py``'s model: two fixed effects and a random
    intercept of σ_u = 0.6 over ``q`` levels, noise N(0, 1)."""
    rng = np.random.default_rng(11)
    x1 = rng.normal(size=n).astype(np.float32)
    x2 = rng.normal(size=n).astype(np.float32)
    g = rng.integers(0, q, n)
    u = rng.normal(0, 0.6, q)
    y = (1.0 + 0.5 * x1 - 0.25 * x2 + u[g]
         + rng.normal(size=n)).astype(np.float32)
    one, jfr, fr = tp.frames({"x1": x1, "x2": x2}, y)
    _add_cat(one, jfr, fr, "grp", g, [f"g{i}" for i in range(q)])
    return one, jfr, fr


@pytest.mark.parametrize("case", ["ordinal", "hglm"])
def test_model_and_carry_over_match_the_reference(case):
    """The ordinal fit (thresholds ordered, the shared slope and cutpoints
    recovered, class probabilities an ordered partition) and the HGLM fit
    (variance components, BLUPs, predictions with the random intercepts)
    against the reference; then the reference's model carried over with
    ``GLMModel.from_reference`` scores what the reference scores."""
    if case == "ordinal":
        one, jfr, fr = _ordinal_frames()
        jm, tm = _both(one, jfr, fr, family="ordinal", lambda_=0.0,
                       max_iterations=60)
        _same_coefficients(jm, tm)
        np.testing.assert_allclose(tm.thresholds, jm.thresholds, rtol=1e-4,
                                   atol=1e-5)
        assert tm.output.scoring_history[-1]["iterations"] == \
            jm.output.scoring_history[-1]["iterations"]
        c = tm.coef()
        assert abs(c["x"] - 2.0) < 0.25
        assert c["threshold_1"] < c["threshold_2"]
        assert abs(c["threshold_1"] + 1.5) < 0.3
        assert abs(c["threshold_2"] - 1.5) < 0.3
        assert tm.output.training_metrics.logloss == pytest.approx(
            jm.output.training_metrics.logloss, rel=1e-5)
        pred = tm.predict(fr)
        probs = np.stack([pred.vec(i).to_numpy() for i in (1, 2, 3)], axis=1)
        assert np.allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    else:
        one, jfr, fr = _hglm_frames()
        jm, tm = _both(one, jfr, fr, family="gaussian", HGLM=True,
                       random_columns=["grp"])
        np.testing.assert_allclose(tm.beta, jm.beta, atol=1e-5)
        np.testing.assert_allclose(tm.ubeta, jm.ubeta, atol=1e-5)
        assert tm.varfix == pytest.approx(jm.varfix, rel=1e-5)
        assert tm.varranef == pytest.approx(jm.varranef, rel=1e-5)
        assert tm.output.scoring_history[-1]["iterations"] == \
            jm.output.scoring_history[-1]["iterations"]
        assert abs(tm.varfix - 1.0) < 0.15 and abs(tm.varranef - 0.36) < 0.2
        assert tm.coef_random().keys() == jm.coef_random().keys()
        with meshmod.use_mesh(one):
            jp = jm.predict(jfr).vec(0).to_numpy()
        np.testing.assert_allclose(tm.predict(fr).vec(0).to_numpy(), jp,
                                   atol=1e-5)
    carried = GLMModel.from_reference(jm, device="cpu")
    assert type(carried).__name__ == type(jm).__name__
    with meshmod.use_mesh(one):
        jp = jm.predict(jfr)
        jcols = np.stack([v.to_numpy() for v in jp.vecs], axis=1)
    cp = carried.predict(fr)
    np.testing.assert_allclose(np.stack([v.to_numpy() for v in cp.vecs],
                                        axis=1), jcols, atol=1e-6)
    assert carried.coef().keys() == jm.coef().keys()


def test_hglm_refusals_match_the_reference():
    """``tests/test_hglm.py:70,81``: no random column, a numeric random
    column, and a non-gaussian family refuse alike in both packages."""
    one, jfr, fr = _hglm_frames(n=200, q=5)
    for kw, err in ((dict(family="gaussian"), ValueError),
                    (dict(family="gaussian", random_columns=["x1"]),
                     ValueError),
                    (dict(family="poisson", random_columns=["grp"]),
                     NotImplementedError)):
        with meshmod.use_mesh(one), pytest.raises(err):
            JGLM(JGLMParameters(training_frame=jfr, response_column="y",
                                HGLM=True, **kw)).train_model()
        with pytest.raises(err):
            GLM(GLMParameters(training_frame=fr, response_column="y",
                              HGLM=True, **kw)).train_model()


# -- ANOVA GLM and ModelSelection (tests/test_gam_rulefit_svm.py:100,120) ----
def _anova_frames(family):
    rng = np.random.default_rng(4)
    a = rng.normal(size=2000).astype(np.float32)
    b = rng.normal(size=2000).astype(np.float32)
    c = rng.normal(size=2000).astype(np.float32)
    lin = 2 * a + 0.0 * b + 0.5 * a * c
    if family == "binomial":
        y = (rng.random(2000) < 1 / (1 + np.exp(-lin))).astype(np.float32)
        return tp.frames({"a": a, "b": b, "c": c}, y, ["n", "p"])
    y = (lin + 0.3 * rng.normal(size=2000)).astype(np.float32)
    return tp.frames({"a": a, "b": b, "c": c}, y)


@pytest.mark.parametrize("case", [("gaussian", 2), ("binomial", 1)])
def test_anovaglm_matches_the_reference(case):
    family, highest = case
    one, jfr, fr = _anova_frames(family)
    kw = dict(response_column="y", family=family, lambda_=0.0, alpha=0.0,
              highest_interaction_term=highest)
    with meshmod.use_mesh(one):
        jm = JANOVAGLM(JANOVAGLMParameters(training_frame=jfr, **kw)
                       ).train_model()
    tm = ANOVAGLM(ANOVAGLMParameters(training_frame=fr, **kw)).train_model()
    full = tm.full_model.output.training_metrics.residual_deviance
    assert [r["term"] for r in tm.result()] == [r["term"] for r in jm.result()]
    for jr, tr in zip(jm.result(), tm.result()):
        assert tr["df"] == jr["df"]
        # a difference of two float32 deviance sums, the reduced one the
        # larger: within 1e-6 of it
        assert abs(tr["deviance"] - jr["deviance"]) <= 1e-6 * (
            full + jr["deviance"])
        assert abs(tr["p_value"] - jr["p_value"]) <= 1e-3
    _same_coefficients(jm.full_model, tm.full_model)
    tbl = {r["term"]: r for r in tm.result()}
    assert tbl["a"]["p_value"] < 0.01 and tbl["b"]["p_value"] > 0.05
    if highest == 2:
        assert [r["term"] for r in tm.result()] == [
            "a", "b", "c", "a:b", "a:c", "b:c"]
        assert tbl["a:c"]["p_value"] < 0.01


@pytest.mark.parametrize("mode", ["forward", "backward", "maxr",
                                  "maxrsweep", "allsubsets"])
def test_modelselection_matches_the_reference(mode):
    """Every mode of the gaussian sweep on one Gram, plus the binomial
    path's per-candidate IRLS fits under ``backward`` (the reference's
    ``p_values_threshold`` is taken and, as there, read by no mode)."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(2000, 5)).astype(np.float32)
    cols = {f"x{i}": X[:, i] for i in range(5)}
    lin = 3 * X[:, 0] - 2 * X[:, 3]
    runs = [("gaussian", (lin + 0.2 * rng.normal(size=2000)
                          ).astype(np.float32), None, dict(
                              max_predictor_number=3))]
    if mode == "backward":
        yb = (rng.random(2000) < 1 / (1 + np.exp(-lin / 3))
              ).astype(np.float32)
        runs.append(("binomial", yb, ["n", "p"],
                     dict(p_values_threshold=0.05)))
    for family, y, ydom, extra in runs:
        if family == "binomial":   # three predictors: 6 IRLS candidates
            cols = {k: cols[k] for k in ("x0", "x1", "x3")}
        one, jfr, fr = tp.frames(cols, y, ydom)
        kw = dict(response_column="y", mode=mode, family=family, **extra)
        with meshmod.use_mesh(one):
            jm = JModelSelection(JModelSelectionParameters(
                training_frame=jfr, **kw)).train_model()
        tm = ModelSelection(ModelSelectionParameters(
            training_frame=fr, **kw)).train_model()
        jr, tr = jm.result(), tm.result()
        assert [r["predictors"] for r in tr] == [r["predictors"] for r in jr]
        for a, b in zip(jr, tr):
            if family == "gaussian":
                assert b["r2"] == pytest.approx(a["r2"], abs=1e-6)
            assert b["coefs"].keys() == a["coefs"].keys()
            np.testing.assert_allclose(list(b["coefs"].values()),
                                       list(a["coefs"].values()),
                                       rtol=1e-4, atol=1e-5)
        two = next(r for r in tr if len(r["predictors"]) == 2)
        assert set(two["predictors"]) == {"x0", "x3"}
        if family == "gaussian":
            assert two["r2"] > 0.95
