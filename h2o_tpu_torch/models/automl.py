"""AutoML — automatic model search and ensembling
(``h2o_tpu/models/automl.py``, `h2o-automl/`).

`ai/h2o/automl/AutoML.java` runs a modeling plan of steps
(`ModelingPlans.java:57-69`, the DEFAULT order: XGBoost defaults, GLM, DRF,
GBM defaults, DeepLearning, XRT, a GBM grid, then Stacked Ensembles) under
time and model budgets, ranks every model on a ``Leaderboard``
(`hex/leaderboard/Leaderboard.java:256`: binomial by auc, multinomial by
mean_per_class_error, regression by rmse standing in for
mean_residual_deviance) and records an ``EventLog``. The step presets are
the reference's, step for step. Every base model trains with k-fold CV on
Modulo folds and keeps its holdout predictions, so the ensembles stack
without leakage.

The plan runs as a host loop on one ``Job``, each build on the training
frame's device through the ported builders, with the budget checked
between steps; a step that raises is logged as a warning and the plan goes
on, as in the reference. The reference dispatches the plan through its
workload manager; the port runs it as a plain job, and a ``priority``
other than the default ``"batch"`` is refused (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..backend.jobs import Job
from ..backend.kvstore import STORE, Keyed
from ..frame.frame import Frame
from ..frame.vec import T_STR, Vec
from .grid import DEFAULT_PRIORITY, check_priority


# ---------------------------------------------------------------------------
# Event log (`ai/h2o/automl/events/EventLog.java`)
# ---------------------------------------------------------------------------
class EventLog:
    def __init__(self):
        self.events: list[dict] = []

    def log(self, stage: str, message: str, level: str = "Info"):
        self.events.append({"timestamp": time.time(), "level": level,
                            "stage": stage, "message": message})

    def as_frame(self) -> Frame:
        names = ["timestamp", "level", "stage", "message"]
        return Frame(names, [
            Vec(None, len(self.events), type=T_STR,
                host_data=np.asarray([e[n] for e in self.events],
                                     dtype=object))
            for n in names])

    def as_table(self):
        """`water/api/schemas3/TwoDimTableV3` shape for `/99/AutoML/{id}`."""
        from ..utils.twodimtable import TwoDimTable

        if not self.events:
            return TwoDimTable(table_header="Event Log")
        return TwoDimTable.from_dict("Event Log", {
            k: [e[k] for e in self.events]
            for k in ("timestamp", "level", "stage", "message")})


# ---------------------------------------------------------------------------
# Leaderboard (`hex/leaderboard/Leaderboard.java`)
# ---------------------------------------------------------------------------
_HIGHER_BETTER = {"auc", "aucpr", "r2", "accuracy"}


def _default_sort_metric(category: str) -> str:
    if category == "Binomial":
        return "auc"
    if category == "Multinomial":
        return "mean_per_class_error"
    return "rmse"  # stands in for mean_residual_deviance (the same ranking
                   # for gaussian; the reference's choice)


class Leaderboard:
    METRIC_COLS = {
        "Binomial": ["auc", "logloss", "aucpr", "mean_per_class_error",
                     "rmse", "mse"],
        "Multinomial": ["mean_per_class_error", "logloss", "rmse", "mse"],
        "Regression": ["rmse", "mse", "mae", "r2"],
    }

    def __init__(self, category: str, sort_metric: str | None = None,
                 device=None):
        self.category = category
        self.sort_metric = (sort_metric
                            or _default_sort_metric(category)).lower()
        self.device = device      # where ``as_frame`` puts its metrics
        self.models: list = []

    def add(self, model):
        self.models.append(model)
        self.models = self.sorted()

    def _metric(self, m, name):
        mm = (m.output.cross_validation_metrics or m.output.validation_metrics
              or m.output.training_metrics)
        v = getattr(mm, name, None)
        return None if v is None or (isinstance(v, float) and np.isnan(v)) \
            else v

    def sorted(self):
        decr = self.sort_metric in _HIGHER_BETTER
        worst = -np.inf if decr else np.inf

        def key(m):
            v = self._metric(m, self.sort_metric)
            return worst if v is None else v

        return sorted(self.models, key=key, reverse=decr)

    @property
    def leader(self):
        return self.models[0] if self.models else None

    def _metric_names(self):
        return self.METRIC_COLS.get(self.category,
                                    self.METRIC_COLS["Regression"])

    def as_frame(self) -> Frame:
        names = ["model_id"] + self._metric_names()
        vecs = [Vec(None, len(self.models), type=T_STR,
                    host_data=np.asarray([m.key for m in self.models],
                                         dtype=object))]
        for n in names[1:]:
            vals = [self._metric(m, n) for m in self.models]
            vecs.append(Vec.from_numpy(
                np.asarray([np.nan if v is None else float(v) for v in vals],
                           dtype=np.float32), device=self.device))
        return Frame(names, vecs)

    def as_table(self):
        """Leaderboard as a TwoDimTable (`/99/Leaderboards/{project}`)."""
        from ..utils.twodimtable import TwoDimTable

        ms = self.sorted()
        if not ms:
            return TwoDimTable(table_header="Leaderboard")
        cols = {"model_id": [m.key for m in ms]}
        for n in self._metric_names():
            cols[n] = [self._metric(m, n) for m in ms]
        return TwoDimTable.from_dict("Leaderboard", cols)


# ---------------------------------------------------------------------------
# Modeling steps (`ai/h2o/automl/modeling/*StepsProvider.java`)
# ---------------------------------------------------------------------------
@dataclass
class Step:
    algo: str              # GBM | DRF | XRT | GLM | DeepLearning | XGBoost |
                           # StackedEnsemble
    id: str                # def_1, grid_1, best_of_family, ...
    make: Callable         # (automl) -> list of models | None
    weight: int = 10       # relative work allocation (`WorkAllocations`)


def _default_plan() -> list[Step]:
    """The DEFAULT modeling plan order (`ModelingPlans.java:57-69`)."""
    plan: list[Step] = []
    for sid, over in (("def_2", dict(max_depth=10, min_rows=5)),
                      ("def_1", dict(max_depth=5, min_rows=10)),
                      ("def_3", dict(max_depth=15, min_rows=3))):
        plan.append(Step("XGBoost", sid,
                         _model_step("xgboost", dict(ntrees=50, **over))))
    plan.append(Step("GLM", "def_1", _glm_step()))
    plan.append(Step("DRF", "def_1", _model_step("drf", dict(ntrees=50))))
    # GBM def_1..def_5 (`GBMStepsProvider.java:81-123`)
    for sid, depth in (("def_1", 6), ("def_2", 7), ("def_3", 8),
                       ("def_4", 10), ("def_5", 15)):
        plan.append(Step("GBM", sid, _model_step(
            "gbm", dict(ntrees=50, max_depth=depth, sample_rate=0.8,
                        col_sample_rate_per_tree=0.8))))
    plan.append(Step("DeepLearning", "def_1", _model_step(
        "deeplearning", dict(hidden=[10, 10, 10], epochs=10))))
    plan.append(Step("XRT", "def_1", _model_step("xrt", dict(ntrees=50))))
    # one random grid over GBM (`GBMStepsProvider.java:137` search space)
    plan.append(Step("GBM", "grid_1", _gbm_grid_step(), weight=60))
    # exploitation: the best GBM again with learn-rate annealing
    # (`GBMStepsProvider.java:170-182` lr_annealing)
    plan.append(Step("GBM", "lr_annealing", _gbm_exploitation_step(),
                     weight=10))
    plan.append(Step("StackedEnsemble", "best_of_family", _se_step(True),
                     weight=5))
    plan.append(Step("StackedEnsemble", "all", _se_step(False), weight=10))
    return plan


def _family(model) -> str:
    """A model's algorithm family as the reference's AutoML sees it: the
    reference's DRF and XRT build a ``GBMModel``, whose ``algo_name`` is
    "gbm", so its best-of-family ensemble and its lr_annealing step count
    them with the GBMs. The port's DRF builds a ``DRFModel`` ("drf") and
    maps it back here, so both packages pick the same models (ROADMAP
    Queue 3)."""
    return "gbm" if model.algo_name == "drf" else model.algo_name


def _gbm_exploitation_step():
    def make(aml: "H2OAutoML"):
        best_gbm = next((m for m in aml.leaderboard.sorted()
                         if _family(m) == "gbm"), None)
        if best_gbm is None:
            return None
        params = best_gbm.params.clone(
            learn_rate_annealing=0.99, ntrees=max(best_gbm.params.ntrees, 100),
            training_frame=aml.training_frame)
        from .gbm import GBM

        return [GBM(params).train_model()]
    return make


def _builder_for(algo: str):
    from . import deeplearning, drf, gbm, glm, xgboost

    return {
        "gbm": (gbm.GBM, gbm.GBMParameters),
        "drf": (drf.DRF, drf.DRFParameters),
        "xrt": (drf.XRT, drf.XRTParameters),
        "xgboost": (xgboost.XGBoost, xgboost.XGBoostParameters),
        "glm": (glm.GLM, glm.GLMParameters),
        "deeplearning": (deeplearning.DeepLearning,
                         deeplearning.DeepLearningParameters),
    }[algo]


def _model_step(algo: str, overrides: dict):
    def make(aml: "H2OAutoML"):
        cls, pcls = _builder_for(algo)
        valid = {f.name for f in dataclasses.fields(pcls)}
        params = pcls(**aml._common_params(),
                      **{k: v for k, v in overrides.items() if k in valid})
        return [cls(params).train_model()]
    return make


def _glm_step():
    def make(aml: "H2OAutoML"):
        from .glm import GLM, GLMParameters

        params = GLMParameters(**aml._common_params(), lambda_search=True,
                               nlambdas=10)
        return [GLM(params).train_model()]
    return make


def _gbm_grid_step():
    def make(aml: "H2OAutoML"):
        from .gbm import GBM, GBMParameters
        from .grid import GridSearch, SearchCriteria

        base = GBMParameters(**aml._common_params(), ntrees=50)
        hyper = {"max_depth": [3, 5, 7, 9, 11, 13, 15, 17],
                 "sample_rate": [0.5, 0.8, 1.0],
                 "col_sample_rate": [0.4, 0.7, 1.0],
                 "min_rows": [1, 5, 10, 15, 30]}
        budget = aml._remaining_budget()
        criteria = SearchCriteria(
            strategy="RandomDiscrete",
            max_models=max(1, (aml.max_models - aml._model_count())
                           if aml.max_models else 5),
            max_runtime_secs=budget if budget is not None else 0.0,
            seed=aml.seed if aml.seed is not None else -1)
        grid = GridSearch(GBM, base, hyper, criteria).train()
        return grid.models
    return make


def _se_step(best_of_family: bool):
    def make(aml: "H2OAutoML"):
        from .ensemble import StackedEnsemble, StackedEnsembleParameters

        bases = [m for m in aml.leaderboard.models
                 if m.algo_name != "stackedensemble"
                 and m.output.cv_holdout_predictions is not None]
        if best_of_family:
            seen, picked = set(), []
            for m in aml.leaderboard.sorted():
                if m.algo_name == "stackedensemble":
                    continue
                if m.output.cv_holdout_predictions is None:
                    continue
                if _family(m) not in seen:
                    seen.add(_family(m))
                    picked.append(m)
            bases = picked
        if len(bases) < 2:
            return None
        params = StackedEnsembleParameters(
            training_frame=aml.training_frame, response_column=aml.y,
            base_models=bases, seed=aml.seed if aml.seed is not None else -1)
        return [StackedEnsemble(params).train_model()]
    return make


# ---------------------------------------------------------------------------
# The orchestrator (h2o-py `H2OAutoML` over `AutoML.java`)
# ---------------------------------------------------------------------------
def small_plan(ntrees: int = 5, max_depth: int = 3, hidden=(5,),
               xgboost: bool = False, mod=None, grid_classes=None) -> list:
    """A plan with one model of every algo at depths that train in
    moments — XGBoost (when ``xgboost``), GLM with lambda search, GBM,
    DRF (one level deeper), a 1-epoch DeepLearning of ``hidden`` — a
    2-model random GBM grid over depths up to ``max_depth`` and learn
    rates 0.1/0.2, and both ensembles: the whole orchestration in one
    quick run. ``mod`` builds the steps from another automl module with
    the same step makers, ``grid_classes`` (GBM, its parameters,
    GridSearch, SearchCriteria) the grid from that module's package."""
    mod = mod or sys.modules[__name__]
    if grid_classes is None:
        from .gbm import GBM, GBMParameters
        from .grid import GridSearch, SearchCriteria

        grid_classes = (GBM, GBMParameters, GridSearch, SearchCriteria)
    gbm, gbm_params, search, criteria = grid_classes

    def grid(aml):
        base = gbm_params(**aml._common_params(), ntrees=ntrees)
        hyper = {"max_depth": [max_depth - 1, max_depth, max_depth + 1],
                 "learn_rate": [0.1, 0.2]}
        crit = criteria(strategy="RandomDiscrete", max_models=2,
                        seed=aml.seed)
        return search(gbm, base, hyper, crit).train().models
    S, ms = mod.Step, mod._model_step
    tree = dict(ntrees=ntrees, max_depth=max_depth)
    plan = [S("XGBoost", "def_1", ms("xgboost", tree))] if xgboost else []
    return plan + [
        S("GLM", "def_1", mod._glm_step()),
        S("GBM", "def_1", ms("gbm", tree)),
        S("DRF", "def_1", ms("drf", dict(ntrees=ntrees,
                                         max_depth=max_depth + 1))),
        S("DeepLearning", "def_1", ms("deeplearning",
                                      dict(hidden=list(hidden), epochs=1))),
        S("GBM", "grid_1", grid, weight=60),
        S("StackedEnsemble", "best_of_family", mod._se_step(True), 5),
        S("StackedEnsemble", "all", mod._se_step(False))]


def models_by_step(aml) -> list:
    """[(step label, model), ...] in build order, read from the event log's
    ``label -> key`` lines: the label (``XGBoost_def_1``, ``GBM_grid_1``)
    names a model across runs whose keys differ."""
    keys = {m.key: m for m in aml.leaderboard.models}
    out = []
    for e in aml.event_log.events:
        if " -> " in e["message"]:
            label, rest = e["message"].split(" -> ")
            out.append((label, keys[rest.split(" ")[0]]))
    return out


class H2OAutoML(Keyed):
    def __init__(self, max_models: int = 0, max_runtime_secs: float = 0.0,
                 max_runtime_secs_per_model: float = 0.0, nfolds: int = 5,
                 seed: int | None = None, project_name: str | None = None,
                 include_algos: list | None = None,
                 exclude_algos: list | None = None,
                 sort_metric: str | None = None,
                 stopping_rounds: int = 3, stopping_tolerance: float = 1e-3,
                 stopping_metric: str = "AUTO",
                 keep_cross_validation_predictions: bool = True,
                 modeling_plan: list | None = None,
                 ignored_columns: list | None = None,
                 priority: str = DEFAULT_PRIORITY):
        check_priority(priority, "AutoML")
        super().__init__(key=project_name, prefix="automl")
        self.priority = priority
        self.ignored_columns = list(ignored_columns or [])
        if not max_models and not max_runtime_secs:
            max_runtime_secs = 3600.0  # the reference's default total budget
        self.max_models = max_models
        self.max_runtime_secs = max_runtime_secs
        self.max_runtime_secs_per_model = max_runtime_secs_per_model
        self.nfolds = nfolds
        self.seed = seed
        self.include_algos = include_algos
        self.exclude_algos = exclude_algos or []
        self.sort_metric = sort_metric
        self.stopping_rounds = stopping_rounds
        self.stopping_tolerance = stopping_tolerance
        self.stopping_metric = stopping_metric
        self.keep_cv_preds = keep_cross_validation_predictions
        self.plan = modeling_plan or _default_plan()
        self.event_log = EventLog()
        self.leaderboard: Leaderboard | None = None
        self.training_frame: Frame | None = None
        self.y: str | None = None
        self._t0 = None
        self.job: Job | None = None
        STORE.put_keyed(self)

    # -- budget helpers ------------------------------------------------------
    def _remaining_budget(self) -> float | None:
        if not self.max_runtime_secs:
            return None
        return max(0.0, self.max_runtime_secs - (time.time() - self._t0))

    def _model_count(self) -> int:
        """Base-model count — Stacked Ensembles do not count toward
        max_models (the reference's contract)."""
        if not self.leaderboard:
            return 0
        return sum(1 for m in self.leaderboard.models
                   if m.algo_name != "stackedensemble")

    def _budget_exhausted(self, step: "Step | None" = None) -> bool:
        is_se = step is not None and step.algo == "StackedEnsemble"
        if (not is_se and self.max_models
                and self._model_count() >= self.max_models):
            return True
        rem = self._remaining_budget()
        return rem is not None and rem <= 0

    def _common_params(self) -> dict:
        return dict(training_frame=self.training_frame,
                    response_column=self.y,
                    ignored_columns=list(self.ignored_columns),
                    nfolds=self.nfolds,
                    keep_cross_validation_predictions=self.keep_cv_preds,
                    fold_assignment="Modulo",  # shared folds: stackable
                    seed=self.seed if self.seed is not None else -1,
                    max_runtime_secs=self.max_runtime_secs_per_model,
                    stopping_rounds=self.stopping_rounds,
                    stopping_tolerance=self.stopping_tolerance,
                    stopping_metric=self.stopping_metric)

    def _algo_allowed(self, algo: str) -> bool:
        fam = {"XRT": "DRF"}.get(algo, algo)
        if self.include_algos is not None:
            return fam in self.include_algos or algo in self.include_algos
        return fam not in self.exclude_algos and algo not in self.exclude_algos

    # -- train (the h2o-py surface) ------------------------------------------
    def train(self, y: str | None = None, training_frame: Frame | None = None,
              job: Job | None = None, **kw) -> "H2OAutoML":
        if kw:
            raise ValueError(f"unsupported train() arguments: {sorted(kw)}")
        if training_frame is None or y is None:
            raise ValueError("y and training_frame are required")
        self.training_frame = training_frame
        self.y = y
        resp = training_frame.vec(y)
        if resp.is_categorical():
            category = "Binomial" if len(resp.domain) == 2 else "Multinomial"
        else:
            category = "Regression"
        self.leaderboard = Leaderboard(category, self.sort_metric,
                                       device=training_frame.device)
        self._t0 = time.time()
        log = self.event_log
        log.log("Workflow", f"AutoML build started: {self.key}")
        if job is not None:
            # an outside Job receives the per-step progress updates
            job.work = float(len(self.plan))
            self.job = job
            self._run_plan(log)
        else:
            # the plan runs on a started Job, as a builder's train() does;
            # join re-raises a failed plan loop
            self.job = Job("AutoML", work=float(len(self.plan)))
            self.job.start(lambda: self._run_plan(log), background=False,
                           device=training_frame.device)
            self.job.join()
        log.log("Workflow",
                f"AutoML build done: {self._model_count()} models, "
                f"leader={self.leader.key if self.leader else None}")
        return self

    def _run_plan(self, log) -> None:
        for step in self.plan:
            if self._budget_exhausted(step):
                log.log("Workflow",
                        f"budget exhausted; skipping {step.algo}_{step.id}")
                continue  # later SE steps may still run
            if not self._algo_allowed(step.algo):
                log.log("ModelBuilding",
                        f"skipping {step.algo} ({step.id}): excluded")
                continue
            label = f"{step.algo}_{step.id}"
            log.log("ModelBuilding", f"starting {label}")
            try:
                models = step.make(self)
            except NotImplementedError:
                raise   # what the port has not ported stops the run
            except Exception as e:
                log.log("ModelBuilding", f"{label} failed: {e!r}",
                        level="Warn")
                models = None
            lb = self.leaderboard
            for m in models or []:
                lb.add(m)
                log.log("ModelBuilding",
                        f"{label} -> {m.key} ({lb.sort_metric}="
                        f"{lb._metric(m, lb.sort_metric)})")
            self.job.update(1.0)

    # -- results -------------------------------------------------------------
    @property
    def leader(self):
        return self.leaderboard.leader if self.leaderboard else None

    def predict(self, fr: Frame) -> Frame:
        if self.leader is None:
            raise ValueError("no models trained")
        return self.leader.predict(fr)

    def get_leaderboard(self) -> Frame:
        return self.leaderboard.as_frame()
