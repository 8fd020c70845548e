"""Port parity: grid search (``h2o_tpu_torch/models/grid.py``) against the
reference (``h2o_tpu/models/grid.py``), the reference on a one-device mesh.

Contracts and tolerances:
- the Cartesian and RandomDiscrete walks give the reference's combos in
  the reference's order, exactly (numpy's ``default_rng(seed)``);
- a 2x2 Cartesian GBM grid on ``tests/test_grid_ensemble.py``'s frame:
  every forest structurally equal to the reference's, leaves within 1e-5
  (``torch_parity.assert_forest_equal``), the same sorted order and the
  summary's metric within 1e-6;
- port-only contracts, each exact: a retrain under a ``grid_id`` appends
  only new combos; a failing combo is recorded and the walk goes on;
  ``parallelism=2`` builds the forests of ``parallelism=1`` bit for bit;
  a grid killed at a failpoint and resumed equals the uninterrupted grid
  bit for bit; export and import round-trip the models; a priority other
  than the default is refused naming its ROADMAP item.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from h2o_tpu.models.gbm import GBM as JGBM
from h2o_tpu.models.gbm import GBMParameters as JGBMParameters
from h2o_tpu.models.grid import GridSearch as JGridSearch
from h2o_tpu.models.grid import SearchCriteria as JSearchCriteria
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import (GBM, GLM, GBMParameters, GLMParameters, Grid,
                           GridSearch, SearchCriteria, export_grid,
                           import_grid)
from h2o_tpu_torch.backend.kvstore import STORE
from h2o_tpu_torch.utils import failpoints

torch.set_num_threads(2)

HYPER = {"max_depth": [2, 3, 4, 5], "learn_rate": [0.05, 0.1, 0.2],
         "min_rows": [1, 10]}


def _binom_cols(n=600):
    """``tests/test_grid_ensemble.py``'s frame."""
    rng = np.random.default_rng(0)
    x1 = rng.normal(size=n).astype(np.float32)
    x2 = rng.normal(size=n).astype(np.float32)
    x3 = rng.normal(size=n).astype(np.float32)
    logit = 1.5 * x1 - x2 + 0.5 * x1 * x2
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return {"x1": x1, "x2": x2, "x3": x3}, y


@pytest.fixture(scope="module")
def frames():
    cols, y = _binom_cols()
    return tp.frames(cols, y, ["n", "p"])


@pytest.fixture
def fr(frames):
    return frames[2]


def _forests_bit_equal(a, b) -> bool:
    return (a.forest.keys() == b.forest.keys()
            and all(torch.equal(a.forest[k], b.forest[k]) for k in a.forest))


def _by_combo(grid, names):
    return {tuple(getattr(m.params, n) for n in names): m
            for m in grid.models}


@pytest.mark.parametrize("crit", [
    dict(), dict(strategy="RandomDiscrete", seed=42),
    dict(strategy="RandomDiscrete", seed=7)])
def test_walks_match_the_reference(crit):
    ours = list(GridSearch(GBM, None, HYPER, SearchCriteria(**crit))._walk())
    ref = list(JGridSearch(JGBM, None, HYPER,
                           JSearchCriteria(**crit))._walk())
    assert len(ours) == 24 and ours == ref


def test_cartesian_gbm_grid_matches_the_reference(frames):
    one, jfr, fr = frames
    # learn_rate 0.05 meets an exact gain tie on this frame (two bin edges
    # of x2 with no row between them), which either package may break
    # either way: the contract holds on fixtures without tied gains
    hyper = {"learn_rate": [0.1, 0.2], "min_rows": [5, 10]}
    kw = dict(response_column="y", ntrees=5, max_depth=4, seed=1)
    with meshmod.use_mesh(one):
        jg = JGridSearch(JGBM, JGBMParameters(training_frame=jfr, **kw),
                         hyper).train()
    tg = GridSearch(GBM, GBMParameters(training_frame=fr, **kw),
                    hyper).train()
    assert tg.model_count == jg.model_count == 4
    for jm, tm in zip(jg.models, tg.models):
        assert ((jm.params.learn_rate, jm.params.min_rows)
                == (tm.params.learn_rate, tm.params.min_rows))
        tp.assert_forest_equal(jm, tm, 1e-5)
    def order(g):
        return [(m.params.learn_rate, m.params.min_rows)
                for m in g.sorted_models()]
    assert order(tg) == order(jg)
    js, ts = jg.summary(), tg.summary()
    assert ([(r["learn_rate"], r["min_rows"]) for r in ts]
            == [(r["learn_rate"], r["min_rows"]) for r in js])
    np.testing.assert_allclose([r["auc"] for r in ts],
                               [r["auc"] for r in js], rtol=0, atol=1e-6)
    assert tg.summary_table().col_header == ["model", "learn_rate",
                                            "min_rows", "auc"]


def test_retrain_appends_without_duplicates(fr):
    params = GBMParameters(training_frame=fr, response_column="y", ntrees=3,
                           seed=1)
    g1 = GridSearch(GBM, params, {"max_depth": [2, 3]},
                    grid_id="torch_append_grid").train()
    assert g1.model_count == 2
    g2 = GridSearch(GBM, params, {"max_depth": [2, 3]},
                    grid_id="torch_append_grid").train()
    assert g2 is g1 and g2.model_count == 2
    g3 = GridSearch(GBM, params, {"max_depth": [2, 3, 5]},
                    SearchCriteria(max_models=2),
                    grid_id="torch_append_grid").train()
    assert g3.model_count == 3
    assert sorted(m.params.max_depth for m in g3.models) == [2, 3, 5]
    # other base params make new models under the same grid_id
    g4 = GridSearch(GBM, params.clone(ntrees=2), {"max_depth": [2]},
                    grid_id="torch_append_grid").train()
    assert g4.model_count == 4
    STORE.remove("torch_append_grid")


def test_failures_are_recorded_and_the_walk_goes_on(fr):
    g = GridSearch(GBM, GBMParameters(training_frame=fr, response_column="y",
                                      ntrees=2, seed=1),
                   {"max_depth": [2, 3], "distribution": ["bernoulli",
                                                          "no_such"]}).train()
    assert sorted(m.params.max_depth for m in g.models) == [2, 3]
    assert [f["params"] for f in g.failures] == [
        {"max_depth": 2, "distribution": "no_such"},
        {"max_depth": 3, "distribution": "no_such"}]
    assert all("no_such" in f["error"] for f in g.failures)


def test_parallel_builds_equal_sequential_ones(fr):
    params = GBMParameters(training_frame=fr, response_column="y", ntrees=4,
                           seed=3, sample_rate=0.7)
    hyper = {"max_depth": [2, 3, 4], "learn_rate": [0.1, 0.3]}
    seq = GridSearch(GBM, params, hyper).train()
    par = GridSearch(GBM, params, hyper, parallelism=2).train()
    a, b = _by_combo(seq, hyper), _by_combo(par, hyper)
    assert len(a) == len(b) == 6 and a.keys() == b.keys()
    assert all(_forests_bit_equal(a[k], b[k]) for k in a)
    glm = GridSearch(GLM, GLMParameters(training_frame=fr,
                                        response_column="y",
                                        family="binomial"),
                     {"alpha": [0.0, 1.0], "lambda_": [0.0, 0.01]},
                     parallelism=2).train()
    assert glm.model_count == 4
    assert all(m.output.training_metrics.auc > 0.5 for m in glm.models)


def test_killed_grid_resumes_bit_equal(fr, tmp_path):
    params = GBMParameters(training_frame=fr, response_column="y", ntrees=3,
                           seed=5, sample_rate=0.8)
    hyper = {"max_depth": [2, 3], "learn_rate": [0.1, 0.2]}
    crit = dict(strategy="RandomDiscrete", seed=11)
    full = GridSearch(GBM, params, hyper, SearchCriteria(**crit)).train()
    rdir = str(tmp_path / "rec")
    # the third manifest write (init, model 1, model 2) dies between its
    # temp write and the rename: model 2's file exists, the manifest
    # records one model
    failpoints.arm("persist.checkpoint", "raise(preempt)@3")
    try:
        with pytest.raises(failpoints.InjectedFault):
            GridSearch(GBM, params, hyper, SearchCriteria(**crit),
                       recovery_dir=rdir).train()
    finally:
        failpoints.reset()
    gs = GridSearch.resume(rdir, device="cpu")
    assert len(gs._recovered_models) == 1
    resumed = gs.train()
    assert resumed.model_count == full.model_count == 4
    a, b = _by_combo(full, hyper), _by_combo(resumed, hyper)
    assert a.keys() == b.keys()
    assert all(_forests_bit_equal(a[k], b[k]) for k in a)
    # the walk order is kept: the recovered model first, then the rest
    assert ([tuple(getattr(m.params, n) for n in hyper) for m in full.models]
            == [tuple(getattr(m.params, n) for n in hyper)
                for m in resumed.models])


def test_export_import_round_trip(fr, tmp_path):
    g = GridSearch(GBM, GBMParameters(training_frame=fr, response_column="y",
                                      ntrees=2, seed=1),
                   {"max_depth": [2, 3]}, grid_id="torch_export_grid").train()
    d = export_grid(g, str(tmp_path / "grid"))
    STORE.remove("torch_export_grid")
    g2 = import_grid(d, device="cpu")
    assert isinstance(g2, Grid) and g2.key == "torch_export_grid"
    assert g2.builder_cls is GBM and g2.model_count == 2
    assert g2.trained_param_keys == g.trained_param_keys
    for a, b in zip(g.models, g2.models):
        assert _forests_bit_equal(a, b)
        assert torch.equal(a.predict(fr).vec(2).data,
                           b.predict(fr).vec(2).data)
    STORE.remove("torch_export_grid")


def test_other_priorities_are_refused(fr):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 14"):
        GridSearch(GBM, GBMParameters(training_frame=fr, response_column="y"),
                   {"max_depth": [2]}, priority="interactive")


def test_combo_keys_ignore_key_order_and_json_round_trips():
    """A combo's key is the same before a crash and after a resume reads
    the manifest's JSON back: key order, numpy scalars and tuples do not
    change it."""
    import json

    from h2o_tpu_torch.models.grid import _combo_key

    a = {"max_depth": np.int64(3), "learn_rate": np.float32(0.5),
         "hidden": (8, 8)}
    b = json.loads(json.dumps({"hidden": [8, 8], "learn_rate": 0.5,
                               "max_depth": 3}))
    assert _combo_key(a) == _combo_key(b)
    assert _combo_key({"max_depth": 3}) != _combo_key({"max_depth": 3.5})


@pytest.mark.parametrize("metric,aucs", [
    ("AUTO", [0.70, 0.71, 0.7105, 0.7101, 0.7102]),
    ("AUTO", [0.70, 0.69, 0.68, 0.72, 0.71]),
    ("logloss", [0.60, 0.59, 0.5899, 0.5898, 0.58]),
])
def test_early_stop_decides_as_the_reference(metric, aucs):
    """``_early_stop`` over a series of models' metrics: the same stop,
    at the same model, as the reference's (``stopping_rounds`` 2,
    tolerance 1e-3)."""
    from h2o_tpu.models.grid import Grid as JGrid

    def stub(v):
        m = type("M", (), {})()
        m.output = type("O", (), {})()
        m.output.model_category = "Binomial"
        m.output.cross_validation_metrics = None
        m.output.validation_metrics = None
        m.output.training_metrics = type("T", (), {"auc": v, "logloss": v})()
        return m

    def stops(gs_cls, grid_cls, crit_cls):
        crit = crit_cls(stopping_rounds=2, stopping_metric=metric)
        gs = gs_cls(GBM, None, {"max_depth": [1]}, crit)
        grid = grid_cls.__new__(grid_cls)
        grid.models, scores = [], []
        for i, v in enumerate(aucs):
            grid.models.append(stub(v))
            if gs._early_stop(grid, scores, crit):
                return i
        return None
    ours = stops(GridSearch, Grid, SearchCriteria)
    assert ours == stops(JGridSearch, JGrid, JSearchCriteria)
