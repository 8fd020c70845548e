"""Port parity: the GLM options of ``h2o_tpu_torch`` against the reference
(``h2o_tpu/models/glm.py``) — p-values, dispersion (``ml`` included), box
and linear constraints, ``alpha`` as a list, the L_BFGS solver, and a
grid over ``solver`` that now trains both.

Each case fits the same model in both packages on the same seeded numpy
columns (2,000 rows and 4 features in every case, so a test worker
compiles each of the reference's programs once; the reference on a
one-device mesh), once, in the one test that reads it. The cases are the
reference's own scenarios (``tests/test_glm.py:131,153,168,256,282,291-371``,
``tests/test_constrained_glm.py``), each held against the reference's fit
and, where the reference's test checks a known answer, against that too.
Contracts and tolerances:

- coefficients within atol 1e-5 + rtol 1e-4 (``test_torch_glm.py``'s: the
  Gram's float32 sums run in other orders), equal iteration counts;
- p-values: std errors within a relative 1e-5, z-values within 1e-4
  relative, p-values within atol 1e-4 + rtol 1e-3 (the reference takes the
  gaussian t-tail from jax's ``betainc`` in float32, the port from scipy's
  in float64: 4.4e-5 apart at p = 0.858 on the pvalues_gaussian frame; a
  z-test's tail moves by z·Δz relative);
- dispersion estimates within a relative 1e-5 (host float64 on both
  sides, from float32 means), the estimated variance power equal;
- L_BFGS: optax's ``lbfgs`` written out step for step, so the iterations
  are equal and the coefficients within the IRLS tolerance (measured
  2.4e-7); projected (``non_negative``) L-BFGS is chaotic — its stale
  gradients and curvature pairs straddle the projection, so float32 sums
  in another order part the two trajectories (ROADMAP Queue 3 item 21) —
  and is held to non-negative coefficients and a residual deviance within
  a relative 1e-3 of the reference's;
- linear constraints: the constraints table's rows equal in name, type and
  status, values within 1e-6.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.frame.frame import Frame as JFrame
from h2o_tpu.frame.vec import T_CAT as J_CAT
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.models.glm import GLM as JGLM
from h2o_tpu.models.glm import GLMParameters as JGLMParameters
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import GLM, Frame, GLMParameters, GridSearch
from h2o_tpu_torch.frame.vec import T_CAT, Vec

import torch_parity as tp

torch.set_num_threads(2)

BETA_ATOL, BETA_RTOL = 1e-5, 1e-4
#: every frame's rows and features: one shape, so a worker compiles each
#: of the reference's programs once
N, K = 2000, 4


def _xy(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return rng, {f"x{j + 1}": (scale * rng.normal(size=N)).astype(np.float32)
                 for j in range(K)}


def _bin(rng, lin):
    return (rng.random(len(lin)) < 1 / (1 + np.exp(-lin))).astype(np.float32)


def _tweedie(rng, p_var, phi, mu=2.0):
    """A compound poisson-gamma draw of Tw(p_var) at mean ``mu``
    (``tests/test_glm.py:327``'s)."""
    lam = mu ** (2 - p_var) / (phi * (2 - p_var))
    alpha = (2 - p_var) / (p_var - 1)
    scale = phi * (p_var - 1) * mu ** (p_var - 1)
    counts = rng.poisson(lam, N)
    return np.array([rng.gamma(alpha * k, scale) if k > 0 else 0.0
                     for k in counts], dtype=np.float32)


def _lc(names, values, types, numbers):
    return {"names": names, "values": values, "types": types,
            "constraint_numbers": numbers}


def _constrained(seed=3):
    """``tests/test_constrained_glm.py``'s model: y = 2 x1 + 3 x2 + 1."""
    rng, cols = _xy(seed)
    y = (2.0 * cols["x1"] + 3.0 * cols["x2"] + 1.0
         + rng.normal(0, 0.2, size=N)).astype(np.float32)
    return cols, y, None


def _frame_p_values_gaussian():
    rng, cols = _xy(0)
    y = (2 * cols["x1"] + rng.normal(size=N)).astype(np.float32)
    return cols, y, None


def _frame_p_values_binomial():
    rng, cols = _xy(1)
    return cols, _bin(rng, 2 * cols["x1"]), ["a", "b"]


def _frame_box():
    rng, cols = _xy(0)
    y = (3.0 * cols["x1"] - 2.0 * cols["x2"]
         + 0.1 * rng.normal(size=N)).astype(np.float32)
    return cols, y, None


def _frame_gamma():
    rng, cols = _xy(2)
    mu = np.exp(0.5 + 0.3 * cols["x1"])
    return cols, rng.gamma(4.0, mu / 4.0).astype(np.float32), None


def _frame_tweedie(seed, p_var, phi):
    """``tests/test_glm.py:327,350``: a constant mean, features near 0."""
    rng, cols = _xy(seed, scale=1e-3)
    return cols, _tweedie(rng, p_var, phi), None


def _frame_binomial():
    rng, cols = _xy(9)
    lin = 1.5 * cols["x1"] - 0.5 * cols["x2"] + 0.25 * cols["x3"]
    return cols, _bin(rng, lin), ["n", "p"]


def _frame_multinomial():
    rng, cols = _xy(9)
    x1, x2 = cols["x1"], cols["x2"]
    scores = np.stack([2.0 * x1, -2.0 * x1 + x2, -x2], axis=1)
    y = np.argmax(scores + rng.gumbel(size=(N, 3)) * 0.3, axis=1)
    return cols, y.astype(np.float32), ["a", "b", "c"]


def _frame_ordinal():
    rng, cols = _xy(2)
    latent = 2.0 * cols["x1"] + rng.logistic(size=N)
    return cols, np.digitize(latent, [-1.0, 1.0]).astype(np.float32), \
        ["a", "b", "c"]


EQ4 = _lc(["x1", "x2", "constant"], [1.0, 1.0, -4.0], ["Equal"] * 3,
          [0, 0, 0])

#: case -> (frame maker, GLM parameters, what the test checks besides
#: parity)
CASES = {
    # tests/test_glm.py:131, 153 — compute_p_values
    "p_values_gaussian": (_frame_p_values_gaussian, dict(
        family="gaussian", lambda_=0.0, compute_p_values=True), "ols_se"),
    "p_values_binomial": (_frame_p_values_binomial, dict(
        family="binomial", lambda_=0.0, compute_p_values=True), "p_small"),
    # tests/test_glm.py:256 — box constraints, IRLSM and COD
    "beta_box_irlsm": (_frame_box, dict(
        family="gaussian", lambda_=0.0, solver="IRLSM",
        beta_constraints={"names": ["x1", "x2"], "lower_bounds": [0.0, -1.0],
                          "upper_bounds": [1.5, 1.0]}), "box"),
    "beta_box_cod": (_frame_box, dict(
        family="gaussian", lambda_=0.0, solver="COORDINATE_DESCENT",
        beta_constraints={"names": ["x1", "x2"], "lower_bounds": [0.0, -1.0],
                          "upper_bounds": [1.5, 1.0]}), "box"),
    # tests/test_glm.py:373, 393 — every class block, and the ordinal fit
    "beta_multinomial": (_frame_multinomial, dict(
        family="multinomial", lambda_=0.0, standardize=False,
        beta_constraints={"names": ["x1"], "lower_bounds": [-0.5],
                          "upper_bounds": [0.5]}), "box_x1"),
    "beta_ordinal": (_frame_ordinal, dict(
        family="ordinal", standardize=False,
        beta_constraints={"names": ["x1"], "lower_bounds": [0.0],
                          "upper_bounds": [0.5]}), "box_x1"),
    # tests/test_glm.py:291-371 — dispersion
    "dispersion_pearson_gaussian": (_frame_p_values_gaussian, dict(
        family="gaussian", lambda_=0.0), "dispersion"),
    "dispersion_gamma_pearson": (_frame_gamma, dict(
        family="gamma", lambda_=0.0,
        dispersion_parameter_method="pearson"), "dispersion"),
    "dispersion_gamma_ml": (_frame_gamma, dict(
        family="gamma", lambda_=0.0, dispersion_parameter_method="ml"),
        "dispersion"),
    "dispersion_gamma_fixed": (_frame_gamma, dict(
        family="gamma", lambda_=0.0, fix_dispersion_parameter=True,
        init_dispersion_parameter=0.7), "dispersion"),
    "dispersion_tweedie_ml": (lambda: _frame_tweedie(3, 1.5, 1.0), dict(
        family="tweedie", tweedie_variance_power=1.5, lambda_=0.0,
        dispersion_parameter_method="ml"), "dispersion"),
    "tweedie_variance_power": (lambda: _frame_tweedie(7, 1.5, 0.8), dict(
        family="tweedie", tweedie_variance_power=1.3, lambda_=0.0,
        dispersion_parameter_method="ml",
        fix_tweedie_variance_power=False), "dispersion"),
    # alpha as a list: one fit per alpha, the best kept
    "alpha_list": (_frame_binomial, dict(
        family="binomial", lambda_=1e-2, alpha=[0.0, 0.5, 1.0]), "alpha"),
    # the L_BFGS solver
    "lbfgs_gaussian": (_frame_box, dict(
        family="gaussian", lambda_=0.0, solver="L_BFGS"), None),
    "lbfgs_binomial": (_frame_binomial, dict(
        family="binomial", lambda_=0.0, solver="L_BFGS"), None),
    "lbfgs_ridge": (_frame_binomial, dict(
        family="binomial", lambda_=1e-3, alpha=0.0, solver="L_BFGS"), None),
    "lbfgs_non_negative": (_frame_binomial, dict(
        family="binomial", lambda_=0.0, solver="L_BFGS",
        non_negative=True), "non_negative"),
    # tests/test_constrained_glm.py
    "equality_closed_form": (_constrained, dict(
        family="gaussian", lambda_=0.0, standardize=False,
        linear_constraints=EQ4), "closed_form"),
    "equality_standardized": (_constrained, dict(
        family="gaussian", lambda_=0.0, linear_constraints=EQ4), "eq4"),
    "binding_inequality": (_constrained, dict(
        family="gaussian", lambda_=0.0, linear_constraints=_lc(
            ["x2", "x1"], [1.0, -1.0], ["LessThanEqual"] * 2, [0, 0])),
        "binding"),
    "nonbinding_inequality": (_constrained, dict(
        family="gaussian", lambda_=0.0, linear_constraints=_lc(
            ["x1", "x2", "constant"], [1.0, 1.0, -100.0],
            ["LessThanEqual"] * 3, [0, 0, 0])), "nonbinding"),
    "equality_with_beta_constraints": (_constrained, dict(
        family="gaussian", lambda_=0.0, linear_constraints=EQ4,
        beta_constraints={"names": ["x1"], "lower_bounds": [0.0],
                          "upper_bounds": [1.5]}), "eq4_box"),
    "binomial_constrained": (_frame_binomial, dict(
        family="binomial", lambda_=0.0, linear_constraints=_lc(
            ["x1", "x2", "constant", "x3", "x4"],
            [1.0, 1.0, -0.8, 1.0, -1.0],
            ["Equal"] * 3 + ["LessThanEqual"] * 2, [0, 0, 0, 1, 1])),
        "binomial_lc"),
    "constraint_frame_spec": (_constrained, dict(
        family="gaussian", lambda_=0.0, linear_constraints="frame"), "eq4"),
}


def _frames(make):
    cols, y, ydom = make()
    return tp.frames(cols, y, ydom)


def _spec_frames(one):
    """The equality x1 + x2 = 4 as a constraints frame in each package
    (categorical names and types, as H2O's clients upload it)."""
    names, types = ["x1", "x2", "constant"], ["Equal"]
    codes = np.arange(3, dtype=np.float32)
    num = np.zeros(3, np.float32)
    vals = np.array([1.0, 1.0, -4.0], np.float32)
    jf = JFrame.from_dict({"values": vals, "constraint_numbers": num},
                          mesh=one)
    jf.add("names", JVec.from_numpy(codes, type=J_CAT, domain=names,
                                    mesh=one))
    jf.add("types", JVec.from_numpy(num, type=J_CAT, domain=types, mesh=one))
    tf = Frame.from_dict({"values": vals, "constraint_numbers": num},
                         device="cpu")
    tf.add("names", Vec.from_numpy(codes, type=T_CAT, domain=names,
                                   device="cpu"))
    tf.add("types", Vec.from_numpy(num, type=T_CAT, domain=types,
                                   device="cpu"))
    return jf, tf


def _fit_both(case):
    make, kw, _ = CASES[case]
    one, jfr, fr = _frames(make)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("linear_constraints") == "frame":
        jkw["linear_constraints"], tkw["linear_constraints"] = \
            _spec_frames(one)
    with meshmod.use_mesh(one):
        jm = JGLM(JGLMParameters(training_frame=jfr, response_column="y",
                                 seed=42, **jkw)).train_model()
    tm = GLM(GLMParameters(training_frame=fr, response_column="y", seed=42,
                           **tkw)).train_model()
    return jm, tm, fr


def _same_coefficients(jm, tm):
    jb, tb = np.asarray(jm.beta, np.float64), np.asarray(tm.beta)
    assert tb.shape == jb.shape
    np.testing.assert_allclose(tb, jb, rtol=BETA_RTOL, atol=BETA_ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_glm_option_matches_the_reference(case):
    jm, tm, fr = _fit_both(case)
    check = CASES[case][2]
    jmm, tmm = jm.output.training_metrics, tm.output.training_metrics
    if check == "non_negative":
        assert np.all(tm.beta[:-1] >= 0)
        assert tmm.residual_deviance == pytest.approx(
            jmm.residual_deviance, rel=1e-3)
        return
    _same_coefficients(jm, tm)
    jh, th = jm.output.scoring_history, tm.output.scoring_history
    if jh and "iterations" in jh[-1]:
        assert th[-1]["iterations"] == jh[-1]["iterations"]
    if hasattr(jmm, "residual_deviance"):
        assert tmm.residual_deviance == pytest.approx(
            jmm.residual_deviance, rel=1e-5)
    if getattr(jm, "thresholds", None) is not None:
        np.testing.assert_allclose(tm.thresholds, jm.thresholds, rtol=1e-4,
                                   atol=1e-5)
    coef = tm.coef()
    if check in ("ols_se", "p_small"):
        for k in ("std_errs", "z_values", "p_values"):
            jv = np.array([getattr(jm, k)[n] for n in coef])
            tv = np.array([getattr(tm, k)[n] for n in coef])
            rtol, atol = {"std_errs": (1e-5, 0), "z_values": (1e-4, 0),
                          "p_values": (1e-3, 1e-4)}[k]
            np.testing.assert_allclose(tv, jv, rtol=rtol, atol=atol)
        assert tm.dispersion == pytest.approx(jm.dispersion, rel=1e-5)
    if check == "ols_se":   # the closed-form OLS covariance
        cols, y, _ = _frame_p_values_gaussian()
        X = np.stack(list(cols.values()) + [np.ones(N)], axis=1
                     ).astype(np.float64)
        beta = np.linalg.lstsq(X, y.astype(np.float64), rcond=None)[0]
        s2 = ((y - X @ beta) ** 2).sum() / (N - K - 1)
        se = np.sqrt(np.diag(np.linalg.inv(X.T @ X)) * s2)
        got = [tm.std_errs[k] for k in list(cols) + ["Intercept"]]
        assert np.allclose(got, se, rtol=0.05)
        assert tm.p_values["x1"] < 1e-6 and tm.p_values["x2"] > 0.01
    if check == "p_small":
        assert tm.p_values["x1"] < 1e-6 and 0 < tm.std_errs["x1"] < 1
    if check == "box":
        assert -1e-6 <= coef["x1"] <= 1.5 + 1e-3
        assert -1.0 - 1e-3 <= coef["x2"] <= 1.0 + 1e-6
        assert coef["x1"] > 1.3 and coef["x2"] < -0.8
    if check == "box_x1":
        lo, hi = tm.params.beta_constraints["lower_bounds"][0], \
            tm.params.beta_constraints["upper_bounds"][0]
        vals = ([c["x1"] for c in coef.values()]
                if isinstance(next(iter(coef.values())), dict)
                else [float(np.asarray(tm.beta).ravel()[0])])
        assert all(lo - 1e-5 <= v <= hi + 1e-5 for v in vals)
    if check == "dispersion":
        assert tm.dispersion_estimated == pytest.approx(
            jm.dispersion_estimated, rel=1e-5)
        assert getattr(tm, "tweedie_variance_power_estimated", None) == \
            getattr(jm, "tweedie_variance_power_estimated", None)
        if case == "dispersion_gamma_fixed":
            assert tm.dispersion_estimated == 0.7
    if check == "alpha":
        assert tm.best_alpha == jm.best_alpha
    if check in ("closed_form", "eq4", "eq4_box"):
        assert abs(coef["x1"] + coef["x2"] - 4.0) < 1e-4
    if check == "closed_form":
        cols, y, _ = _constrained()
        X = np.stack(list(cols.values()) + [np.ones(N)], axis=1
                     ).astype(np.float64)
        a = np.zeros((1, K + 1))
        a[0, :2] = 1.0                                  # x1 + x2 = 4
        kkt = np.block([[X.T @ X, a.T], [a, np.zeros((1, 1))]])
        sol = np.linalg.solve(kkt, np.concatenate([X.T @ y, [4.0]]))
        for i, k in enumerate(list(cols) + ["Intercept"]):
            assert abs(coef[k] - sol[i]) < 1e-3
    if check == "eq4_box":
        assert -1e-6 <= coef["x1"] <= 1.5 + 1e-6
    if check == "binding":
        assert abs(coef["x2"] - coef["x1"]) < 1e-4
    if check == "nonbinding":   # the unconstrained optimum
        one, jfr, fr = _frames(_constrained)
        free = GLM(GLMParameters(training_frame=fr, response_column="y",
                                 family="gaussian", lambda_=0.0)
                   ).train_model().coef()
        for k in ("x1", "x2", "Intercept"):
            assert abs(coef[k] - free[k]) < 1e-4
    if check == "binomial_lc":
        assert abs(coef["x1"] + coef["x2"] - 0.8) < 1e-4
        assert coef["x3"] - coef["x4"] <= 1e-5
        assert tmm.auc > 0.7
    if tm.params.linear_constraints is not None:
        jt = jm.output.linear_constraints_table.cell_values
        tt = tm.output.linear_constraints_table.cell_values
        assert [r[:2] + r[3:] for r in tt] == [r[:2] + r[3:] for r in jt]
        np.testing.assert_allclose([r[2] for r in tt], [r[2] for r in jt],
                                   atol=1e-6)


#: (case, the refused parameters, the error and its message) — each raised
#: by both packages before any training
REFUSALS = {
    "p_values_regularized": (dict(family="gaussian", lambda_=0.5,
                                  compute_p_values=True), "lambda"),
    "beta_unknown_name": (dict(family="gaussian",
                               beta_constraints={"names": ["zzz"]}),
                          "unknown coefficient"),
    "beta_lbfgs": (dict(family="gaussian", lambda_=0.0, solver="L_BFGS",
                        beta_constraints={"names": ["x1"],
                                          "lower_bounds": [0.0]}),
                   "L_BFGS"),
    "single_coefficient": (dict(family="gaussian", lambda_=0.0,
                                linear_constraints=_lc(
                                    ["x1", "constant"], [1.0, -2.0],
                                    ["Equal"] * 2, [0, 0])),
                           "at least two coefficients"),
    "lbfgs_constrained": (dict(family="gaussian", lambda_=0.0,
                               solver="L_BFGS", linear_constraints=_lc(
                                   ["x1", "x2"], [1.0, 1.0], ["Equal"] * 2,
                                   [0, 0])), "IRLSM"),
    "regularized_constrained": (dict(family="gaussian", lambda_=0.1,
                                     linear_constraints=_lc(
                                         ["x1", "x2"], [1.0, 1.0],
                                         ["Equal"] * 2, [0, 0])),
                                "Regularization"),
    "redundant": (dict(family="gaussian", lambda_=0.0,
                       linear_constraints=_lc(
                           ["x1", "x2", "x1", "x2"], [1.0, 1.0, 2.0, 2.0],
                           ["Equal"] * 4, [0, 0, 1, 1])), "redundant"),
    "unknown_constraint_name": (dict(family="gaussian", lambda_=0.0,
                                     linear_constraints=_lc(
                                         ["zz", "x2"], [1.0, 1.0],
                                         ["Equal"] * 2, [0, 0])),
                                "not a valid coefficient"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_glm_refusals_match_the_reference(case):
    """``tests/test_glm.py:168,256,282`` and the rejections of
    ``tests/test_constrained_glm.py``: the same ``ValueError`` in both."""
    kw, match = REFUSALS[case]
    cols, y, _ = _constrained()
    one, jfr, fr = tp.frames(cols, y)
    with meshmod.use_mesh(one), pytest.raises(ValueError, match=match):
        JGLM(JGLMParameters(training_frame=jfr, response_column="y",
                            **kw)).train_model()
    with pytest.raises(ValueError, match=match):
        GLM(GLMParameters(training_frame=fr, response_column="y",
                          **kw)).train_model()


def test_glm_grid_over_solver_trains_both():
    """A GLM grid over ``solver=["IRLSM", "L_BFGS"]`` now trains both
    models (it raised naming the L_BFGS refusal before), each bit for bit
    the model its own build makes (the lbfgs_binomial case holds that one
    against the reference)."""
    cols, y, ydom = _frame_binomial()
    _one, _jfr, fr = tp.frames(cols, y, ydom)
    kw = dict(training_frame=fr, response_column="y", family="binomial",
              lambda_=0.0)
    tg = GridSearch(GLM, GLMParameters(**kw),
                    {"solver": ["IRLSM", "L_BFGS"]}).train()
    assert not tg.failures and len(tg.models) == 2
    assert sorted(m.params.solver for m in tg.models) == ["IRLSM", "L_BFGS"]
    for m in tg.models:
        alone = GLM(GLMParameters(solver=m.params.solver, **kw)).train_model()
        assert np.array_equal(m.beta, alone.beta)
