"""Port parity: CoxPH (``h2o_tpu_torch/models/coxph.py``) against the
reference (``h2o_tpu/models/coxph.py``).

Each case fits the same model in both packages on the same seeded numpy
columns (the reference on a one-device mesh), once, in the one test that
reads it: the scenarios of ``tests/test_coxph.py:56,75 (efron and
breslow),96,118,151,172``, and ``:75``'s tied times again with row
weights and two strata (with weights, which row of a tie group takes which
Efron fraction changes the fit, so the sort order must be the reference's
stable one). Contracts and tolerances:

- the Efron fractions bit-equal to the reference's loop over tie groups;
- coefficients, standard errors and the log-likelihood within a relative
  1e-5 (the reference's risk sums are float32, the port's float64;
  measured 2.1e-6);
- the baseline hazard: the same event times per stratum, cumulative
  hazards within a relative 1e-5;
- ``survfit``: the same time grid, each curve's cumulative hazard
  -log S(t) within a relative 1e-5 (S itself near 0 magnifies a 1e-6 move
  in the linear predictor by H·exp(lp));
- the events, rows and concordance equal (within 1e-9); the linear
  predictor within 1e-5 x max(1, |lp|) of the reference's, and a model
  carried over by ``CoxPHModel.from_reference`` within 1e-6;
- every Newton pass two Gram calls (the z = None form).
"""

import jax
import numpy as np
import pytest

import h2o_tpu.models.coxph as jcox
from h2o_tpu.frame.frame import Frame as JFrame
from h2o_tpu.parallel import mesh as meshmod
import h2o_tpu_torch.models.coxph as tcox
from h2o_tpu_torch import Frame
from torch_parity import LazyCases

REL_TOL = 1e-5


def _no_ties():
    """``test_coxph.py:56``."""
    rng = np.random.default_rng(0)
    n = 400
    X = rng.normal(size=(n, 3))
    t = rng.exponential(1.0 / np.exp(X @ np.array([0.8, -0.5, 0.0])))
    cens = rng.exponential(2.0, n)
    e = (t <= cens).astype(np.float64)
    cols = {f"x{i}": X[:, i].astype(np.float32) for i in range(3)}
    cols.update(time=np.minimum(t, cens).astype(np.float32),
                event=e.astype(np.float32))
    return cols, dict(stop_column="time"), None


def _ties(ties="efron", weighted=False):
    """``test_coxph.py:75`` (heavy ties), optionally weighted and
    stratified."""
    rng = np.random.default_rng(1)
    n = 200
    X = rng.normal(size=(n, 2))
    t = np.ceil(rng.exponential(1.0 / np.exp(X @ np.array([1.0, -1.0])))
                * 4)
    e = np.ones(n)
    e[rng.random(n) < 0.2] = 0
    cols = {"x0": X[:, 0].astype(np.float32), "x1": X[:, 1].astype(np.float32),
            "time": t.astype(np.float32), "event": e.astype(np.float32)}
    kw = dict(stop_column="time", ties=ties)
    if weighted:
        cols["w"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        cols["s"] = (rng.random(n) < 0.5).astype(np.float32)
        kw.update(weights_column="w", stratify_by=["s"])
    return cols, kw, None


def _stratified():
    """``test_coxph.py:96``."""
    rng = np.random.default_rng(2)
    n = 300
    X = rng.normal(size=(n, 1))
    strat = rng.integers(0, 2, n).astype(np.float64)
    t = rng.exponential(np.where(strat == 0, 1.0, 5.0) / np.exp(0.7 * X[:, 0]))
    cols = {"x0": X[:, 0].astype(np.float32), "s": strat.astype(np.float32),
            "time": t.astype(np.float32), "event": np.ones(n, np.float32)}
    return cols, dict(stop_column="time", stratify_by=["s"]), None


def _baseline():
    """``test_coxph.py:118``."""
    rng = np.random.default_rng(2)
    n = 4000
    x = rng.normal(size=n).astype(np.float32)
    t = rng.exponential(1.0 / (0.5 * np.exp(0.7 * x))).astype(np.float32)
    cens = rng.exponential(4.0, n).astype(np.float32)
    cols = {"x": x, "stop": np.minimum(t, cens),
            "event": (t <= cens).astype(np.float32)}
    return cols, dict(stop_column="stop"), {
        "x": np.array([-1.0, 1.0], np.float32)}


def _survfit_stratified():
    """``test_coxph.py:151``."""
    rng = np.random.default_rng(3)
    n = 2000
    g = rng.integers(0, 2, n).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    t = rng.exponential(np.where(g > 0, 0.5, 2.0)).astype(np.float32)
    cols = {"x": x, "g": g, "stop": t, "event": np.ones(n, np.float32)}
    return cols, dict(stop_column="stop", stratify_by=["g"]), {
        "x": np.zeros(2, np.float32), "g": np.array([0.0, 1.0], np.float32)}


def _one_stratum():
    """``test_coxph.py:172``."""
    rng = np.random.default_rng(4)
    n = 500
    cols = {"x": rng.normal(size=n).astype(np.float32),
            "g": np.zeros(n, np.float32),
            "stop": rng.exponential(1.0, n).astype(np.float32),
            "event": np.ones(n, np.float32)}
    return cols, dict(stop_column="stop", stratify_by=["g"]), {
        "x": np.zeros(1, np.float32), "g": np.zeros(1, np.float32)}


CASES = {"no_ties": _no_ties, "efron": _ties,
         "breslow": lambda: _ties("breslow"),
         "weighted_efron": lambda: _ties("efron", True),
         "stratified": _stratified, "baseline": _baseline,
         "survfit_stratified": _survfit_stratified,
         "one_stratum": _one_stratum}


def _fit(case):
    cols, kw, new = CASES[case]()
    one = meshmod.make_mesh(jax.devices()[:1])
    jfr = JFrame.from_dict(cols, mesh=one)
    fr = Frame.from_dict(cols, device="cpu")
    with meshmod.use_mesh(one):
        jm = jcox.CoxPH(jcox.CoxPHParameters(
            training_frame=jfr, response_column="event", **kw)).train_model()
        jsf = (None if new is None
               else jm.survfit(JFrame.from_dict(new, mesh=one)))
    before = _plain_calls[0]
    tm = tcox.CoxPH(tcox.CoxPHParameters(
        training_frame=fr, response_column="event", **kw)).train_model()
    calls = _plain_calls[0] - before
    tsf = None if new is None else tm.survfit(Frame.from_dict(new,
                                                              device="cpu"))
    return jm, tm, jfr, fr, (jsf, tsf), calls


_plain_calls = [0]


@pytest.fixture(scope="module")
def cases():
    """Counts the Gram's plain-version calls (the CPU's) per fit."""
    mp = pytest.MonkeyPatch()
    orig = tcox.gram_accumulate

    def counting(X, W, z=None):
        _plain_calls[0] += 1
        return orig(X, W, z)

    mp.setattr(tcox, "gram_accumulate", counting)
    yield LazyCases(_fit)
    mp.undo()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-300),
                        initial=0.0))


def _reference_fractions(gid, ev):
    """The reference's loop (``h2o_tpu/models/coxph.py:261-265``)."""
    frac = np.zeros(len(gid))
    for g in np.unique(gid):
        sel = (gid == g) & (ev > 0)
        d = sel.sum()
        if d > 1:
            frac[sel] = np.arange(d) / d
    return frac


def test_efron_fractions_equal_the_reference_loop():
    rng = np.random.default_rng(5)
    gid = np.repeat(np.arange(300), rng.integers(1, 7, 300))
    ev = (rng.random(len(gid)) < 0.7).astype(np.float64)
    want = _reference_fractions(gid, ev)
    assert np.array_equal(want.view(np.int64),
                          tcox.efron_fractions(gid, ev).view(np.int64))


@pytest.mark.parametrize("case", list(CASES))
def test_coxph_matches_the_reference(cases, case):
    jm, tm, jfr, fr, (jsf, tsf), calls = cases[case]
    jt, tt = jm.output.training_metrics, tm.output.training_metrics
    names = list(jm.coefficients)
    assert list(tm.coefficients) == names
    assert _rel([jm.coefficients[k] for k in names],
                [tm.coefficients[k] for k in names]) <= REL_TOL
    assert _rel([jt.se_coef[k] for k in names],
                [tt.se_coef[k] for k in names]) <= REL_TOL
    assert _rel([jt.loglik], [tt.loglik]) <= REL_TOL
    assert (tt.n, tt.n_events) == (jt.n, jt.n_events)
    assert abs(tt.concordance - jt.concordance) <= 1e-9
    assert calls == 2 * tm.newton_passes
    assert sorted(tm.baseline) == sorted(jm.baseline)
    for k in jm.baseline:
        assert np.array_equal(jm.baseline[k][0], tm.baseline[k][0])
        assert _rel(jm.baseline[k][1], tm.baseline[k][1]) <= REL_TOL
    jlp = jm.predict(jfr).vec(0).to_numpy()
    assert np.max(np.abs(tm.predict(fr).vec(0).to_numpy() - jlp)
                  / np.maximum(1, np.abs(jlp))) <= REL_TOL
    carried = tcox.CoxPHModel.from_reference(jm, device="cpu")
    assert np.max(np.abs(carried.predict(fr).vec(0).to_numpy() - jlp)) \
        <= 1e-6
    if jsf is not None:
        assert tsf.names == jsf.names
        assert np.array_equal(jsf.vec("t").to_numpy(),
                              tsf.vec("t").to_numpy())
        for c in jsf.names[1:]:
            assert _rel(-np.log(jsf.vec(c).to_numpy()),
                        -np.log(tsf.vec(c).to_numpy())) <= REL_TOL
        bh = tm.baseline_hazard_frame()
        assert bh.names == jm.baseline_hazard_frame().names


@pytest.mark.parametrize("shape", [(5,), (1024,), (4097, 3), (250_000,)])
def test_card_prefix_sums_match_cumsum(shape):
    """The card's blocked prefix sums (a fixed order of adds) against
    ``torch.cumsum`` in float64: within 1e-12 of each sum's absolute
    mass."""
    import torch

    v = torch.from_numpy(np.random.default_rng(6).normal(size=shape))
    got = tcox._blocked_cumsum(v)
    mass = torch.cumsum(v.abs(), dim=0)
    assert got.shape == v.shape
    assert float(((got - torch.cumsum(v, dim=0)).abs() / mass).max()) < 1e-12
