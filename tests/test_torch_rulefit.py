"""Port parity: RuleFit (``h2o_tpu_torch/models/rulefit.py``) against the
reference (``h2o_tpu/models/rulefit.py``).

Each case fits the same RuleFit in both packages on the same seeded numpy
columns (the reference on a one-device mesh), once, in the one test that
reads it: the scenarios of ``tests/test_gam_rulefit_svm.py:55`` (binomial,
rule lengths 2-3), ``:243`` (gaussian, the built design and, with the cell
budget lowered to 1 in both packages, the streamed one) and
``tests/test_kernels.py:333`` (rules only, covers). Contracts and
tolerances:

- integer work exactly: the rules (features, directions, NA sides,
  origins, sub-forest), the packed rule arrays, ``eval_rules``'
  memberships (on the same arrays, and on each package's own), a design
  block built from the same arguments, and the supports (the port's node
  covers equal to the reference's and to the port's streamed membership
  counts). A rule's threshold is its forest's split value: within the
  forest contract's rtol 1e-6 + atol 5e-7 (a quantile cut may sit 2 ulps
  from the reference's, ROADMAP Queue 3 item 1); the linear terms' means
  and sigmas (float32 rollup sums in other orders) within a relative 1e-6;
- coefficients within 1e-4 x max(1, |beta|) (the Gram sums in float32 in
  other orders; the lasso path's lambdas follow from the first Gram),
  the same nonzero pattern, predictions within 1e-4. The two binomial
  paths end where the likelihood barely tells overlapping rules apart:
  ``:55``'s one sharp rule (training AUC 0.9996, all but separable) and
  ``test_kernels.py:333``'s rules-only path, which walks to lambda 9e-5.
  There float32 sums in another order move the coefficients (the port's
  own by up to 5.7e-3 and 4.6e-4 between 1 and 8 CPU threads, a small
  one across the lasso's zero) while the predictions stay within 1e-5,
  so those two are held through their predictions;
- the streamed and built fits agree as in the reference's own test
  (correlation > 0.999, means within 0.02, training MSE within 10%);
- ``RuleFitModel.from_reference`` scores within 1e-5 of the reference.
"""

import numpy as np
import pytest
import torch

import h2o_tpu.models.rulefit as jrf
from h2o_tpu.parallel import mesh as meshmod
import h2o_tpu_torch.models.rulefit as trf
from torch_parity import THR_ATOL, LazyCases, frames

COEF_TOL = 1e-4
PRED_TOL = 1e-4


def _sharp_rule():
    """``test_gam_rulefit_svm.py:55``."""
    rng = np.random.default_rng(2)
    n = 3000
    a = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    y = ((a > 0.5) & (b < 0.0)).astype(np.float32)
    return ({"a": a, "b": b}, y, ["0", "1"],
            dict(min_rule_length=2, max_rule_length=3,
                 rule_generation_ntrees=20, seed=5, family="binomial",
                 model_type="rules_and_linear"))


def _streaming():
    """``test_gam_rulefit_svm.py:243``."""
    rng = np.random.default_rng(12)
    n = 4000
    x = rng.normal(size=(n, 5)).astype(np.float32)
    y = (((x[:, 0] > 0.3) & (x[:, 1] < 0.5)).astype(np.float32)
         + 0.2 * x[:, 2]
         + 0.05 * rng.normal(size=n).astype(np.float32)).astype(np.float32)
    return ({f"x{i}": x[:, i] for i in range(5)}, y, None,
            dict(seed=3, min_rule_length=2, max_rule_length=2,
                 rule_generation_ntrees=10))


def _covers():
    """``test_kernels.py:333`` (``_higgs_like(4000, seed=9)``)."""
    rng = np.random.default_rng(9)
    n = 4000
    cols = {f"f{j}": rng.normal(size=n).astype(np.float32) for j in range(6)}
    logits = cols["f0"] - 0.5 * cols["f1"] + 0.25 * cols["f2"]
    y = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return (cols, y, ["n", "p"],
            dict(min_rule_length=2, max_rule_length=2,
                 rule_generation_ntrees=10, seed=4, model_type="rules"))


CASES = {"sharp_rule": (_sharp_rule, 1 << 29),
         "built": (_streaming, 1 << 29),
         "streamed": (_streaming, 1),
         "covers": (_covers, 1 << 29)}


def _fit(case):
    make, budget = CASES[case]
    cols, y, ydom, kw = make()
    one, jfr, fr = frames(cols, y, ydom)
    old = (jrf._STREAM_CELL_BUDGET, trf._STREAM_CELL_BUDGET)
    jrf._STREAM_CELL_BUDGET = trf._STREAM_CELL_BUDGET = budget
    try:
        with meshmod.use_mesh(one):
            jm = jrf.RuleFit(jrf.RuleFitParameters(
                training_frame=jfr, response_column="y", **kw)).train_model()
        tm = trf.RuleFit(trf.RuleFitParameters(
            training_frame=fr, response_column="y", **kw)).train_model()
    finally:
        jrf._STREAM_CELL_BUDGET, trf._STREAM_CELL_BUDGET = old
    return jm, tm, jfr, fr


@pytest.fixture(scope="module")
def cases():
    return LazyCases(_fit)


def _pred(model, fr):
    return model.predict(fr).vec(model.predict(fr).ncol - 1).to_numpy()


def _check_case(jm, tm, jfr, fr, coef=True):
    n = fr.nrow
    assert tm.stream == jm.stream
    assert len(tm.rules) == len(jm.rules) > 0
    for a, b in zip(jm.rules, tm.rules):
        assert (a.origin, a.model_idx) == (b.origin, b.model_idx)
        assert [(f, op, nl) for f, op, _, nl in a.conds] == \
            [(f, op, nl) for f, op, _, nl in b.conds]
        np.testing.assert_allclose([c[2] for c in b.conds],
                                   [c[2] for c in a.conds], rtol=1e-6,
                                   atol=THR_ATOL)
        assert np.float32(a.support) == np.float32(b.support)
    jarr = [np.asarray(a) for a in jm.rule_arrays]
    for k, (a, b) in enumerate(zip(jarr, tm.rule_arrays)):
        if k == 1:   # thresholds
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-6,
                                       atol=THR_ATOL)
        else:
            assert np.array_equal(a, b.numpy())
    X = fr.as_matrix(tm.output.names)
    JX = jfr.as_matrix(jm.output.names)
    memb = trf.eval_rules(X, *tm.rule_arrays).numpy()
    want = np.asarray(jrf.eval_rules(JX, *jm.rule_arrays))
    assert np.array_equal(want, memb)
    same = [torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                             else a.copy()) for a in jarr]
    assert np.array_equal(want, trf.eval_rules(X, *same).numpy())
    # one design block, rules and linear terms, from the same arguments
    args = [np.asarray(a) for a in jm._stream_args()]
    targs = [torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                              else a.copy()) for a in args]
    got = trf._build_design_block(X[:512], *targs)
    want = jrf._build_design_block(JX[:512], *jm._stream_args())
    assert np.array_equal(np.asarray(want), got.numpy())
    for a, b in zip(args, tm._stream_args(X.device)):   # thresholds, stats
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=THR_ATOL)
    # supports: covers == membership counts, streamed, in both packages
    sup = np.array([r.support for r in tm.rules], np.float32)
    stream = trf._stream_rule_support(X, tm.rule_arrays, n).numpy()
    assert np.array_equal(sup, stream)
    assert np.array_equal(np.asarray(jrf._stream_rule_support(
        JX, jm.rule_arrays, n)), stream)

    jb, tb = np.asarray(jm.beta, np.float64), tm.beta
    if coef:
        assert np.array_equal(np.abs(jb) > 0, np.abs(tb) > 0)
        assert np.max(np.abs(tb - jb) / np.maximum(1, np.abs(jb))) \
            <= COEF_TOL
    jp, tp = _pred(jm, jfr), _pred(tm, fr)
    assert np.max(np.abs(tp - jp)) <= PRED_TOL
    carried = trf.RuleFitModel.from_reference(jm, device="cpu")
    assert np.max(np.abs(_pred(carried, fr) - jp)) <= 1e-5
    return tp


@pytest.mark.parametrize("case", ["sharp_rule", "covers"])
def test_rulefit_matches_the_reference(cases, case):
    jm, tm, jfr, fr = cases[case]
    # coefficients the likelihood barely determines are held through the
    # predictions (see the module docstring)
    _check_case(jm, tm, jfr, fr, coef=False)
    assert tm.output.training_metrics.auc > 0.6
    imp = tm.rule_importance()
    if case == "sharp_rule":   # the reference test's own check
        assert "a" in imp[0]["rule"] or "b" in imp[0]["rule"]
    else:
        assert imp[0]["rule"] == jm.rule_importance()[0]["rule"]


def test_streamed_and_built_rulefit_match_the_reference(cases):
    """The reference's streaming test on both packages: each fit against
    its reference twin, then the port's streamed fit against its built
    one (the reference's own contract)."""
    built, streamed = cases["built"], cases["streamed"]
    assert not built[1].stream and streamed[1].stream
    p1 = _check_case(*built)
    p2 = _check_case(*streamed)
    assert streamed[1].stream_steps >= streamed[1].lambdas_walked >= 1
    assert np.corrcoef(p1, p2)[0, 1] > 0.999
    assert abs(p1.mean() - p2.mean()) < 0.02
    m1 = built[1].output.training_metrics.mse
    m2 = streamed[1].output.training_metrics.mse
    assert abs(m1 - m2) / max(m1, 1e-9) < 0.1


def test_stream_block_plan():
    """The CPU keeps the reference's power-of-two blocks; the card's
    blocks hold at most 2^28 design cells, a multiple of 256 rows."""
    cpu = torch.device("cpu")
    for R, P in ((4000, 40), (11_001_856, 429), (1 << 20, 9)):
        assert trf._stream_block(R, P, cpu) == jrf._stream_block(R, P)
    rb = trf._stream_block(11_001_856, 429, torch.device("cuda"))
    assert rb % 256 == 0 and rb * 429 <= 1 << 28 and (rb + 256) * 429 > 1 << 28
