"""Port parity: GAM (``h2o_tpu_torch/models/gam.py``) and the spline bases
copied into ``h2o_tpu_torch/mojo/format.py``, against the reference
(``h2o_tpu/models/gam.py``, ``h2o_tpu/mojo/format.py``).

Each case fits the same GAM in both packages on the same seeded numpy
columns (the reference on a one-device mesh), once, in the one test that
reads it: the scenarios of ``tests/test_gam_rulefit_svm.py:12,39,153 (bs
0-3),171`` and ``:208``'s check (the standalone numpy scorer scores what
the model scores) on ``:153``'s fits. Contracts and tolerances:

- the numpy bases and penalty matrices bit-equal to the reference's;
- the device bases (``_gam_basis_dev``) within 1e-6 of the reference's on
  the training column (cubics and divisions in float32, a thin-plate
  product summed in another order);
- knots bit-equal at 8 knots (the default and every case but one). At 10
  knots within a relative 1e-6: the reference's sketch contracts its
  last quantile lanes into an FMA on the CPU, and a knot there may sit a
  few ulps away (ROADMAP Queue 3 item 25);
- coefficients within 1e-4 x max(1, |beta|), each cr (bs=0) and
  B-spline (bs=3) block taken with its mean coefficient removed: those
  bases sum to one in every row, so with the intercept the design is
  rank-deficient, and a block's mean coefficient is rounding noise over
  the solve's 1e-8 ridge in either package (ROADMAP Queue 3 item 26);
- a thin-plate (bs=1) or monotone I-spline (bs=2) block through its
  smooth (the block's basis times its coefficients) at every row, within
  1e-4 of the smooth's absolute mass (the sum of |basis x coefficient|),
  the Gram checks' convention: the thin plate's Gram has a condition
  number near 1e7 and the I-splines' COD sweeps run in float32, so
  float32 sums in another order move their coefficients — the port's own
  by up to 1.3e-1 and 2.1e-4 between 1 and 8 CPU threads — and a thin
  plate's terms cancel (measured against the mass: below 2e-6);
- predictions within 1e-4 x max(1, |prediction|) (measured 5.4e-5, the
  monotone fit), but for the thin plate's, held by its smooth (the port's
  own move by 2.1e-4 between thread counts); IRLS iteration counts within
  one of the reference's (the stopping test compares a float32-rounded
  step with beta_epsilon; the port's own count moves by one between
  thread counts); the numpy scorer's linear predictor within 1e-4 of the
  model's;
- ``GAMModel.from_reference`` scores within 1e-5 of the reference model.
"""

import numpy as np
import pytest

from h2o_tpu.models.gam import GAM as JGAM
from h2o_tpu.models.gam import GAMParameters as JGAMParameters
from h2o_tpu.models.gam import _gam_basis_dev as j_basis_dev
from h2o_tpu.mojo import format as jfmt
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import Frame
from h2o_tpu_torch.models.gam import (GAM, GAMModel, GAMParameters,
                                      _gam_basis_dev)
from h2o_tpu_torch.mojo import format as tfmt
from torch_parity import LazyCases, frames

COEF_TOL = 1e-4
PRED_TOL = 1e-4
BASIS_TOL = 1e-6
KNOT_RTOL = 1e-6


def test_numpy_bases_are_the_reference_bases():
    """``mojo/format.py``'s copied bases and penalties bit-equal to the
    reference's, NAs and out-of-range values included."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-4, 4, 500)
    x[::37] = np.nan
    knots = np.sort(rng.uniform(-3, 3, 7))
    interior = np.sort(rng.uniform(-2, 2, 5))
    for a, b in zip(jfmt.cr_matrices(knots), tfmt.cr_matrices(knots)):
        assert np.array_equal(a, b)
    Z, S = tfmt.tp_constraint(knots, 6.0)
    for a, b in zip(jfmt.tp_constraint(knots, 6.0), (Z, S)):
        assert np.array_equal(a, b)
    F = tfmt.cr_matrices(knots)[0]
    specs = [dict(bs=0, knots=knots, F=F),
             dict(bs=1, knots=knots, tp_scale=6.0, Z=Z),
             dict(bs=2, lo=-3.0, hi=3.0, interior=interior, degree=3),
             dict(bs=3, lo=-3.0, hi=3.0, interior=interior, degree=2)]
    for spec in specs:
        assert np.array_equal(jfmt.gam_basis(x, spec),
                              tfmt.gam_basis(x, spec)), spec["bs"]
    assert np.array_equal(jfmt.bspline_basis(x, -3, 3, interior),
                          tfmt.bspline_basis(x, -3, 3, interior))
    assert np.array_equal(jfmt.ispline_basis(x, -3, 3, interior),
                          tfmt.ispline_basis(x, -3, 3, interior))
    assert np.array_equal(jfmt.cr_basis(x, knots, F),
                          tfmt.cr_basis(x, knots, F))
    assert np.array_equal(jfmt.tp_basis(x, knots, 6.0, Z),
                          tfmt.tp_basis(x, knots, 6.0, Z))


def _smooth_frame(n=3000, seed=4):
    """``test_gam_rulefit_svm.py:153``."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, n).astype(np.float32)
    z = rng.normal(size=n).astype(np.float32)
    y = (np.sin(x) + 0.5 * x + 0.5 * z
         + 0.2 * rng.normal(size=n)).astype(np.float32)
    return {"x": x, "z": z}, y, None


def _sin_frame():
    """``test_gam_rulefit_svm.py:12``."""
    rng = np.random.default_rng(0)
    n = 3000
    x = rng.uniform(-3, 3, n).astype(np.float32)
    z = rng.normal(size=n).astype(np.float32)
    y = (np.sin(x) * 2 + 0.5 * z + 0.1 * rng.normal(size=n)).astype(
        np.float32)
    return {"x": x, "z": z}, y, None


def _binomial_frame():
    """``test_gam_rulefit_svm.py:39``."""
    rng = np.random.default_rng(1)
    n = 2000
    x = rng.uniform(-3, 3, n).astype(np.float32)
    pr = 1 / (1 + np.exp(-3 * np.sin(x)))
    y = (rng.random(n) < pr).astype(np.float32)
    return {"x": x}, y, ["0", "1"]


def _monotone_frame():
    """``test_gam_rulefit_svm.py:171``."""
    rng = np.random.default_rng(7)
    n = 3000
    x = rng.uniform(-3, 3, n).astype(np.float32)
    y = (2 * np.tanh(x) + 0.3 * rng.normal(size=n)).astype(np.float32)
    return {"x": x}, y, None


CASES = {
    "sin_cr_10_knots": (_sin_frame, dict(num_knots=10, scale=0.1,
                                         family="gaussian", lambda_=0.0,
                                         alpha=0.0)),
    "binomial": (_binomial_frame, dict(family="binomial", num_knots=8,
                                       scale=0.5)),
    **{f"bs{b}": (_smooth_frame, dict(bs=b, num_knots=8, scale=0.1,
                                      family="gaussian"))
       for b in range(4)},
    "monotone": (_monotone_frame, dict(bs=2, num_knots=8, scale=0.01,
                                       family="gaussian")),
}


def _fit(case):
    make, kw = CASES[case]
    cols, y, ydom = make()
    one, jfr, fr = frames(cols, y, ydom)
    kw = dict(response_column="y", gam_columns=["x"], **kw)
    with meshmod.use_mesh(one):
        jm = JGAM(JGAMParameters(training_frame=jfr, **kw)).train_model()
    tm = GAM(GAMParameters(training_frame=fr, **kw)).train_model()
    return jm, tm, jfr, fr


@pytest.fixture(scope="module")
def cases():
    return LazyCases(_fit)


def _identified(model) -> np.ndarray:
    """beta with each cr / B-spline block's mean coefficient removed (the
    direction the rank-deficient design leaves to rounding)."""
    b = np.asarray(model.beta, np.float64).copy()
    off = 0 if model.dinfo is None else len(model.dinfo.expanded_names)
    for s in model.gam_specs:
        k = len(s["col_means"])
        if int(s.get("bs", 3)) in (0, 3):
            b[off:off + k] -= b[off:off + k].mean()
        off += k
    return b


def _smooths(model, fr) -> list:
    """Each gam block's smooth over the frame's rows, with its absolute
    mass."""
    X = model.adapt_frame(fr)[:fr.nrow].double().numpy()
    b = np.asarray(model.beta, np.float64)
    off = 0 if model.dinfo is None else len(model.dinfo.expanded_names)
    out = []
    for s in model.gam_specs:
        k = len(s["col_means"])
        B, bb = X[:, off:off + k], b[off:off + k]
        out.append((B @ bb, np.abs(B) @ np.abs(bb)))
        off += k
    return out


def _last(fr):
    return fr.vec(fr.ncol - 1).to_numpy().astype(np.float64)


@pytest.mark.parametrize("case", list(CASES))
def test_gam_matches_the_reference(cases, case):
    jm, tm, jfr, fr = cases[case]
    js, ts = jm.gam_specs[0], tm.gam_specs[0]
    assert set(js) == set(ts)
    kk = "knots" if "knots" in js else "interior"
    if CASES[case][1]["num_knots"] == 8:
        assert np.array_equal(js[kk], ts[kk])
    else:
        np.testing.assert_allclose(ts[kk], js[kk], rtol=KNOT_RTOL, atol=0)
    for k in ("F", "Z"):
        if k in js and np.array_equal(js[kk], ts[kk]):
            assert np.array_equal(js[k], ts[k])
    # the device bases on the training column, under the reference's spec
    n = fr.nrow
    want = np.asarray(j_basis_dev(jfr.vec("x").data, js))[:n]
    got = _gam_basis_dev(fr.vec("x").data, js).numpy()[:n]
    np.testing.assert_allclose(got, want, rtol=0, atol=BASIS_TOL)
    np.testing.assert_allclose(ts["col_means"], js["col_means"], rtol=0,
                               atol=BASIS_TOL)

    assert abs(jm.output.scoring_history[0]["iterations"]
               - tm.output.scoring_history[0]["iterations"]) <= 1
    bs = int(js.get("bs", 0))
    jp, tp = _last(jm.predict(jfr)), _last(tm.predict(fr))
    if bs != 1:
        assert np.max(np.abs(tp - jp) / np.maximum(1, np.abs(jp))) \
            <= PRED_TOL
    carried = GAMModel.from_reference(jm, device="cpu")
    jb, tb = _identified(jm), _identified(tm)
    if bs in (1, 2):   # through the smooths, the rest by coefficients
        for (x, _), (y, mass) in zip(_smooths(tm, fr),
                                     _smooths(carried, fr)):
            assert np.all(np.abs(x - y) <= COEF_TOL * np.maximum(1, mass))
        k = len(ts["col_means"])
        jb, tb = (np.delete(v, np.s_[-1 - k:-1]) for v in (jb, tb))
    assert np.max(np.abs(tb - jb) / np.maximum(1, np.abs(jb))) <= COEF_TOL
    assert list(tm.coef()) == list(jm.coef())
    if jm.output.model_category == "Binomial":
        assert abs(tm.output.training_metrics.auc
                   - jm.output.training_metrics.auc) <= 1e-4

    assert np.max(np.abs(_last(carried.predict(fr)) - jp)) <= 1e-5

    if case.startswith("bs"):
        # the standalone scorer's numpy bases (``mojo/format.py``) score
        # what the device bases score (the reference's ``:208`` check, on
        # ``:153``'s fits)
        B = (tfmt.gam_basis(fr.vec("x").to_numpy(), ts)
             - np.asarray(ts["col_means"])[None, :])
        lin = tm.dinfo.expand(fr)[0].numpy()[:n].astype(np.float64)
        eta = lin @ tm.beta[:1] + B @ tm.beta[1:-1] + tm.beta[-1]
        np.testing.assert_allclose(eta, _last(tm.predict(fr)), rtol=1e-4,
                                   atol=1e-4)
    if case == "monotone":
        g = np.linspace(-3, 3, 300).astype(np.float32)
        grid = Frame.from_dict({"x": g, "y": np.zeros(300, np.float32)},
                               device="cpu")
        assert np.min(np.diff(_last(tm.predict(grid)))) >= -1e-5


def test_gam_refuses_a_multinomial_response():
    from h2o_tpu_torch.frame.vec import T_CAT, Vec

    rng = np.random.default_rng(3)
    fr = Frame.from_dict({"x": rng.normal(size=200).astype(np.float32)},
                         device="cpu")
    fr.add("y", Vec.from_numpy(rng.integers(0, 3, 200), type=T_CAT,
                               domain=["a", "b", "c"], device="cpu"))
    with pytest.raises(ValueError, match="multinomial"):
        GAM(GAMParameters(training_frame=fr, response_column="y",
                          gam_columns=["x"])).train_model()
