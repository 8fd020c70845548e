"""Port parity: AutoML (``h2o_tpu_torch/models/automl.py``) and the
explanation tools (``h2o_tpu_torch/models/explain.py``) against the
reference (``h2o_tpu/models/automl.py``, ``h2o_tpu/models/explain.py``),
the reference on a one-device mesh. The reference's AutoML run is made
once, in a module-scoped fixture.

Contracts and tolerances:
- ``_default_plan()``: the same steps (algo, id, weight) with the same
  presets, exactly;
- the leaderboard sorts each category by the reference's metric, ties and
  missing metrics as the reference orders them, exactly;
- ``max_models``, ``include_algos`` and ``exclude_algos`` pick the
  reference's steps;
- a tiny custom plan (``automl.small_plan()``: GLM with lambda search, a
  depth-3 GBM, a DRF, a 1-epoch DeepLearning, a 2-model GBM grid (depths
  2-4) and both stacked ensembles) on 300 rows with 2 folds, through both packages: the same
  steps run in the same order and make the same models; each step's
  leaderboard metrics (auc, logloss, aucpr, mean per-class error, rmse)
  within 1e-4, compared by step label (model keys are counters); the
  leaderboard's order equal wherever neighbouring AUCs differ by more than
  1e-4; the leader's predictions within 1e-4;
- ``partial_dependence`` (averages and one ICE row) and
  ``permutation_varimp`` on the plan's GBM within 1e-5 of the reference's;
- a priority other than the default is refused naming its ROADMAP item.
"""

import inspect

import numpy as np
import pytest
import torch

import torch_parity as tp
from h2o_tpu.models import automl as jautoml
from h2o_tpu.models import explain as jexplain
from h2o_tpu.models.gbm import GBM as JGBM
from h2o_tpu.models.gbm import GBMParameters as JGBMParameters
from h2o_tpu.models.grid import GridSearch as JGridSearch
from h2o_tpu.models.grid import SearchCriteria as JSearchCriteria
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import (H2OAutoML, Leaderboard, partial_dependence,
                           permutation_varimp)
from h2o_tpu_torch.models import automl as tautoml

torch.set_num_threads(2)

TOL = 1e-4
METRICS = ("auc", "logloss", "aucpr", "mean_per_class_error", "rmse")


def _frame_cols(n=300, seed=0):
    """``tests/test_automl.py``'s frame."""
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n).astype(np.float32)
    x2 = rng.normal(size=n).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(1.5 * x1 - x2)))).astype(
        np.float32)
    return {"x1": x1, "x2": x2}, y


def _closure(make):
    return {k: v for k, v in inspect.getclosurevars(make).nonlocals.items()}


def test_default_plan_matches_the_reference():
    ours, ref = tautoml._default_plan(), jautoml._default_plan()
    assert ([(s.algo, s.id, s.weight, _closure(s.make)) for s in ours]
            == [(s.algo, s.id, s.weight, _closure(s.make)) for s in ref])
    assert len(ours) == 16


class _Stub:
    """A minimal model: a key, an algo and training metrics."""

    def __init__(self, key, **metrics):
        self.key = key
        self.algo_name = "x"
        self.output = type("O", (), {})()
        self.output.cross_validation_metrics = None
        self.output.validation_metrics = None
        self.output.training_metrics = type("T", (), metrics)()


@pytest.mark.parametrize("category,metrics", [
    ("Binomial", [dict(auc=0.7), dict(auc=0.9), dict(auc=float("nan")),
                  dict(auc=0.9), dict()]),
    ("Multinomial", [dict(mean_per_class_error=0.3),
                     dict(mean_per_class_error=0.1), dict(),
                     dict(mean_per_class_error=0.3)]),
    ("Regression", [dict(rmse=2.0), dict(rmse=1.0), dict(rmse=None),
                    dict(rmse=1.0)]),
])
def test_leaderboard_sorts_as_the_reference(category, metrics):
    ours = Leaderboard(category, device="cpu")
    ref = jautoml.Leaderboard(category)
    assert ours.sort_metric == ref.sort_metric
    for i, m in enumerate(metrics):
        ours.add(_Stub(f"m{i}", **m))
        ref.add(_Stub(f"m{i}", **m))
    assert [m.key for m in ours.models] == [m.key for m in ref.models]
    assert ours.leader.key == ref.leader.key
    assert ours.as_table().col_header == ref.as_table().col_header
    lb = ours.as_frame() if category == "Binomial" else None
    if lb is not None:
        assert lb.names[0] == "model_id" and "auc" in lb.names


@pytest.fixture(scope="module")
def frames():
    cols, y = _frame_cols()
    return tp.frames(cols, y, ["no", "yes"])


@pytest.fixture(scope="module")
def runs(frames):
    one, jfr, fr = frames
    kw = dict(max_models=6, nfolds=2, seed=42)
    with meshmod.use_mesh(one):
        ja = jautoml.H2OAutoML(modeling_plan=tautoml.small_plan(
            mod=jautoml, grid_classes=(JGBM, JGBMParameters, JGridSearch,
                                       JSearchCriteria)), **kw)
        ja.train(y="y", training_frame=jfr)
    ta = H2OAutoML(modeling_plan=tautoml.small_plan(), **kw)
    ta.train(y="y", training_frame=fr)
    return ja, ta


def _by_label(aml):
    """{step label: [model, ...]}."""
    out = {}
    for label, m in tautoml.models_by_step(aml):
        out.setdefault(label, []).append(m)
    return out


def test_tiny_plan_matches_the_reference(runs, frames):
    """One test reads the reference's run, so a parallel test runner
    trains it once."""
    ja, ta = runs
    started = [[e["message"] for e in a.event_log.events
                if e["message"].startswith("starting")] for a in (ja, ta)]
    assert started[0] == started[1] and len(started[0]) == 7
    jl, tl = _by_label(ja), _by_label(ta)
    assert list(jl) == list(tl)
    assert [len(v) for v in tl.values()] == [1, 1, 1, 1, 2, 1, 1]
    for label in jl:
        for jm, tm in zip(jl[label], tl[label]):
            assert tautoml._family(tm) == jm.algo_name
            for name in METRICS:
                jv = ja.leaderboard._metric(jm, name)
                tv = ta.leaderboard._metric(tm, name)
                assert (jv is None) == (tv is None), (label, name)
                if jv is not None:
                    assert tv == pytest.approx(jv, abs=TOL), (label, name)
    # the order, where neighbouring AUCs are apart by more than the
    # tolerance; a model's place is its step label and rank in the step
    def ranks(a, byl):
        where = {m.key: (lb, i) for lb, ms in byl.items()
                 for i, m in enumerate(ms)}
        return [(where[m.key], a.leaderboard._metric(m, "auc"))
                for m in a.leaderboard.models]
    jr, tr = ranks(ja, jl), ranks(ta, tl)
    for i in range(len(jr) - 1):
        if abs(jr[i][1] - jr[i + 1][1]) > TOL:
            assert (tr.index(next(t for t in tr if t[0] == jr[i][0]))
                    < tr.index(next(t for t in tr if t[0] == jr[i + 1][0])))
    assert ta._model_count() == ja._model_count() == 6
    lb = ta.get_leaderboard()
    assert lb.nrow == 8 and lb.names == ja.get_leaderboard().names
    _assert_leader_predictions_match(ja, ta, frames)
    _assert_explain_matches(ja, ta, frames)


def _assert_leader_predictions_match(ja, ta, frames):
    _one, jfr, fr = frames
    jp = ja.predict(jfr).vec(2).to_numpy()
    tp_ = ta.predict(fr).vec(2).to_numpy()
    assert tautoml._family(ta.leader) == ja.leader.algo_name
    np.testing.assert_allclose(tp_[:fr.nrow], jp[:fr.nrow], rtol=0,
                               atol=TOL)


def _assert_explain_matches(ja, ta, frames):
    """Partial dependence and permutation importance on the plan's GBM."""
    one, jfr, fr = frames
    jm, tm = _by_label(ja)["GBM_def_1"][0], _by_label(ta)["GBM_def_1"][0]
    with meshmod.use_mesh(one):
        jpd = jexplain.partial_dependence(jm, jfr, cols=["x1", "x2"],
                                          nbins=7)
        jice = jexplain.partial_dependence(jm, jfr, cols=["x2"], nbins=5,
                                           row_index=3)
        jpv = jexplain.permutation_varimp(jm, jfr, seed=1, n_repeats=2)
    tpd = partial_dependence(tm, fr, cols=["x1", "x2"], nbins=7)
    tice = partial_dependence(tm, fr, cols=["x2"], nbins=5, row_index=3)
    tpv = permutation_varimp(tm, fr, seed=1, n_repeats=2)
    for jt, tt in zip(jpd + jice, tpd + tice):
        assert tt.table_header == jt.table_header
        assert tt.col_header == jt.col_header
        np.testing.assert_allclose(np.asarray(tt.cell_values, np.float64),
                                   np.asarray(jt.cell_values, np.float64),
                                   rtol=0, atol=1e-5)
    assert [r[0] for r in tpv.cell_values] == [r[0] for r in jpv.cell_values]
    np.testing.assert_allclose([r[1:] for r in tpv.cell_values],
                               [r[1:] for r in jpv.cell_values], rtol=0,
                               atol=1e-5)


def _port_frame():
    from h2o_tpu_torch import Frame, Vec
    from h2o_tpu_torch.frame.vec import T_CAT

    cols, y = _frame_cols()
    fr = Frame.from_dict(cols, device="cpu")
    fr.add("y", Vec.from_numpy(y, type=T_CAT, domain=["no", "yes"],
                               device="cpu"))
    return fr


def _cheap_plan():
    """Every algo of the default plan, at sizes the CPU trains in
    moments (the default DRF's depth-12 levels take seconds a tree on the
    CPU's plain histogram)."""
    S, ms = tautoml.Step, tautoml._model_step
    return [S("XGBoost", "def_1", ms("xgboost", dict(ntrees=3, max_depth=2))),
            S("GLM", "def_1", tautoml._glm_step()),
            S("DRF", "def_1", ms("drf", dict(ntrees=3, max_depth=3))),
            S("GBM", "def_1", ms("gbm", dict(ntrees=3, max_depth=2))),
            S("DeepLearning", "def_1", ms("deeplearning",
                                          dict(hidden=[3], epochs=1))),
            S("XRT", "def_1", ms("xrt", dict(ntrees=3, max_depth=3))),
            S("StackedEnsemble", "best_of_family", tautoml._se_step(True)),
            S("StackedEnsemble", "all", tautoml._se_step(False))]


@pytest.mark.parametrize("kw,algos,n_base", [
    (dict(max_models=3, exclude_algos=["DeepLearning", "XGBoost"]),
     {"glm", "drf", "gbm", "stackedensemble"}, 3),
    (dict(max_models=2, exclude_algos=["DeepLearning", "XGBoost",
                                       "StackedEnsemble"]),
     {"glm", "drf"}, 2),
    (dict(max_models=3, include_algos=["GLM"]), {"glm"}, 1),
])
def test_budgets_and_algo_filters(kw, algos, n_base):
    """The reference's AutoML scenarios (``tests/test_automl.py``): the
    plan under ``max_models`` and the algo filters, whose choices equal
    the reference's for every algo of the plan."""
    ref = jautoml.H2OAutoML(nfolds=2, seed=1, **kw)
    aml = H2OAutoML(nfolds=2, seed=1, modeling_plan=_cheap_plan(), **kw)
    for algo in ("XGBoost", "GLM", "DRF", "XRT", "GBM", "DeepLearning",
                 "StackedEnsemble"):
        assert aml._algo_allowed(algo) == ref._algo_allowed(algo)
    aml.train(y="y", training_frame=_port_frame())
    assert {m.algo_name for m in aml.leaderboard.models} == algos
    assert aml._model_count() == n_base
    skipped = [e["message"] for e in aml.event_log.events
               if e["message"].startswith(("skipping", "budget"))]
    assert skipped


def test_other_priorities_are_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 14"):
        H2OAutoML(max_models=1, priority="interactive")


class _Cat:
    """A stand-in model of one category, for the argument checks."""

    def __init__(self, category):
        self.output = type("O", (), {"model_category": category,
                                     "names": ["x1"]})()
        self.params = type("P", (), {"response_column": "y"})()


@pytest.mark.parametrize("call", ["pdp_multinomial", "pvi_clustering",
                                  "pvi_bad_metric"])
def test_explain_refuses_what_the_reference_refuses(call):
    """The argument errors of both packages, before any scoring."""
    def run(pd, pv):
        if call == "pdp_multinomial":
            return pd(_Cat("Multinomial"), None)
        if call == "pvi_clustering":
            return pv(_Cat("Clustering"), None)
        return pv(_Cat("Binomial"), None, metric="RMSE")
    with pytest.raises(ValueError) as ours:
        run(partial_dependence, permutation_varimp)
    with pytest.raises(ValueError) as ref:
        run(jexplain.partial_dependence, jexplain.permutation_varimp)
    assert str(ours.value) == str(ref.value)


def test_event_log_and_leaderboard_frames():
    """The event log and the leaderboard as frames and tables: host string
    columns for ids and messages, metrics on the named device."""
    ours, ref = tautoml.EventLog(), jautoml.EventLog()
    for log in (ours, ref):
        log.log("Workflow", "started")
        log.log("ModelBuilding", "a failed", level="Warn")
    f = ours.as_frame()
    assert f.names == ref.as_frame().names
    assert list(f.vec("message").host_data) == ["started", "a failed"]
    assert ours.as_table().col_header == ref.as_table().col_header
    lb = Leaderboard("Regression", device="cpu")
    lb.add(_Stub("m0", rmse=2.0, mse=4.0, mae=1.5, r2=0.1))
    fr = lb.as_frame()
    assert fr.names == ["model_id", "rmse", "mse", "mae", "r2"]
    assert fr.vec("rmse").to_numpy()[0] == 2.0
