"""Model / ModelBuilder / Parameters (``h2o_tpu/models/model_base.py``).

``Parameters`` keeps the reference's field names and defaults so the two
packages take the same arguments. ``ModelBuilder.train()`` returns a
``Job`` running the build on a worker thread (`hex/ModelBuilder.java:
381-398` trainModel), cooperatively cancellable and bounded by
``max_runtime_secs``; ``train_model()`` is ``train(False).join()``. The
build runs on the training frame's device, with N-fold cross-validation
(`hex/ModelBuilder.java:614` computeCrossValidation) when ``nfolds`` or
``fold_column`` asks for it: fold assignment (random, modulo or stratified
from numpy's ``default_rng(seed)``, or the fold column), one model per
fold on the complement, holdout metrics and predictions, then the main
model on the whole frame. Models and the CV output frames take keys and
live in the K/V store.

Preemption-proof training: with ``auto_recovery_dir`` the builder arms a
``TrainingRecovery`` (``backend/persist.py``) and offers its exact
iteration state at every chunk boundary (``_recovery_tick``); a killed
job resumes bit-equal through ``resume_training``. A preempt request
(``Job.request_preempt`` or the ``workload.preempt`` failpoint) checkpoints
and unwinds with ``JobPreempted``. CV builds train without recovery, as in
the reference. The reference's workload manager, telemetry spans and
flight recorder are not ported (ROADMAP step L).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..backend.jobs import Job, JobPreempted
from ..backend.kvstore import STORE, Keyed, make_key
from ..frame.frame import Frame
from ..frame.vec import T_CAT, Vec
from ..utils import failpoints
from ..utils.log import warn
from ..parallel.mesh import padded_len
from .metrics import make_metrics


@dataclass
class Parameters:
    """Common hyperparameters — `hex/Model.java` Model.Parameters."""

    training_frame: Optional[Frame] = None
    validation_frame: Optional[Frame] = None
    response_column: Optional[str] = None
    ignored_columns: list = field(default_factory=list)
    weights_column: Optional[str] = None
    offset_column: Optional[str] = None
    fold_column: Optional[str] = None
    nfolds: int = 0
    fold_assignment: str = "AUTO"  # AUTO|Random|Modulo|Stratified
    keep_cross_validation_models: bool = True
    keep_cross_validation_predictions: bool = False
    keep_cross_validation_fold_assignment: bool = False
    seed: int = -1
    max_runtime_secs: float = 0.0
    distribution: str = "AUTO"
    categorical_encoding: str = "AUTO"   # frozen on the training frame and
                                         # replayed at scoring
                                         # (``utils/linalg.py``)
    max_categorical_levels: int = 10     # EnumLimited's top k
    ignore_const_cols: bool = True
    check_constant_response: bool = True
    balance_classes: bool = False   # declared by the reference, read by no
                                    # builder of it: accepted and ignored
    stopping_rounds: int = 0
    stopping_metric: str = "AUTO"
    stopping_tolerance: float = 1e-3
    auc_type: str = "AUTO"  # multinomial AUC aggregate: AUTO(=NONE)|NONE|
                            # MACRO_OVR|WEIGHTED_OVR|MACRO_OVO|WEIGHTED_OVO
    checkpoint: Any = None          # prior model (or its key) to continue
    export_checkpoints_dir: Optional[str] = None  # in-training snapshots
    auto_recovery_dir: Optional[str] = None  # periodic atomic checkpoints
                                    # of the running job; resume_training
                                    # restarts a killed job bit-equal
                                    # (knob H2O_TORCH_CHECKPOINT_SECS)
    custom_metric_func: Any = None  # callable(y, raw, w) -> (name, value),
                                    # evaluated once after training

    def clone(self, **overrides):
        return dataclasses.replace(self, **overrides)


class ModelOutput:
    """What a trained model publishes (`hex/Model.Output`)."""

    def __init__(self):
        self.names: list[str] = []
        self.domains: dict[str, list | None] = {}
        self.response_domain: list | None = None
        self.model_category = "Regression"
        self.training_metrics = None
        self.validation_metrics = None
        self.cross_validation_metrics = None
        self.scoring_history: list[dict] = []
        self.variable_importances: dict | None = None
        self.run_time_ms = 0
        self.cv_models: list = []
        self.cv_holdout_predictions = None   # Frame, when kept
        self.cv_fold_predictions = None      # one Frame per fold, when kept
        self.cv_fold_assignment = None       # Frame, when kept

    @staticmethod
    def carried(ref) -> "ModelOutput":
        """A reference model's output names, domains, category and response
        domain, as plain lists (``from_reference``)."""
        out = ModelOutput()
        out.names = list(ref.names)
        out.domains = {n: (list(d) if d is not None else None)
                       for n, d in ref.domains.items()}
        out.model_category = ref.model_category
        if ref.response_domain is not None:
            out.response_domain = list(ref.response_domain)
        return out


class Model(Keyed):
    algo_name = "base"

    def __init__(self, params: Parameters, output: ModelOutput, key=None):
        super().__init__(key=key, prefix=f"{self.algo_name}_model")
        self.params = params
        self.output = output
        STORE.put_keyed(self)

    def save(self, path: str) -> str:
        """Binary model export (`hex/Model.java` exportBinaryModel)."""
        from ..backend.persist import save_model

        return save_model(self, path)

    def remove_impl(self, store):
        for m in self.output.cv_models:
            store.remove(m.key)

    def score0(self, X: torch.Tensor) -> torch.Tensor:
        """Raw per-row prediction on a dense (R, F) matrix: (R,) for
        regression, (R, 1 + K) [label, p0, ..., pK-1] for a K-class
        classifier."""
        raise NotImplementedError

    def score_raw(self, X: torch.Tensor) -> torch.Tensor:
        """The serving runtime's traceable raw-matrix scorer (reference
        ``model_base.py:129``): the serving path is step L."""
        raise NotImplementedError(
            f"{self.algo_name}: score_raw (the serving runtime) is not "
            f"ported yet (ROADMAP Queue 1 item 14, step L)")

    def pre_adapt(self, fr: Frame) -> Frame:
        """Replay the frozen ``categorical_encoding`` (reference
        ``model_base.py:140-148``); every ``adapt_frame`` routes incoming
        frames through this."""
        enc = getattr(self.output, "encoding_state", None)
        if enc is None:
            return fr
        from ..utils.linalg import apply_encoding_state

        return apply_encoding_state(fr, enc)

    def adapt_frame(self, fr: Frame) -> torch.Tensor:
        """adaptTestForTrain analog: training columns of ``fr`` in training
        order, as a (plen, F) matrix on the frame's device, categorical codes
        remapped onto the training domain by level name (unseen levels become
        NaN and follow each node's NA direction)."""
        fr = self.pre_adapt(fr)
        cols = []
        for name in self.output.names:
            v = fr.vec(name)
            train_dom = self.output.domains.get(name)
            data = v.data
            if train_dom is not None and v.domain != train_dom:
                if not v.domain:
                    raise ValueError(f"column '{name}' is categorical in "
                                     f"training but has no domain here")
                remap = {lvl: i for i, lvl in enumerate(train_dom)}
                codes = torch.tensor([float(remap.get(lvl, np.nan))
                                      for lvl in v.domain],
                                     dtype=torch.float32, device=data.device)
                ok = ~torch.isnan(data) & (data >= 0) & (data < len(v.domain))
                idx = torch.where(ok, data, 0.0).to(torch.int64)
                data = torch.where(ok, codes[idx], torch.nan)
            cols.append(data)
        return torch.stack(cols, dim=1)

    def predict(self, fr: Frame) -> Frame:
        raw = self.score0(self.adapt_frame(fr))
        return self._predictions_frame(raw, fr.nrow)

    def _predictions_frame(self, raw, nrow) -> Frame:
        if self.output.model_category == "Regression":
            return Frame(["predict"], [Vec(raw, nrow)])
        dom = self.output.response_domain or [str(i) for i in
                                              range(raw.shape[1] - 1)]
        names = ["predict"] + [f"p{d}" for d in dom]
        vecs = [Vec(raw[:, 0].contiguous(), nrow, type=T_CAT, domain=list(dom))]
        vecs += [Vec(raw[:, j].contiguous(), nrow)
                 for j in range(1, raw.shape[1])]
        return Frame(names, vecs)

    def model_performance(self, fr: Frame | None = None):
        if fr is None:
            return self.output.training_metrics
        return self._metrics_of(fr, self.score0(self.adapt_frame(fr)))

    def _metrics_of(self, fr: Frame, raw: torch.Tensor):
        p = self.params
        w = fr.vec(p.weights_column).data if p.weights_column else None
        y = _response_device(fr, p.response_column,
                             self.output.response_domain)
        return make_metrics(self.output.model_category, y, raw, w,
                            auc_type=p.auc_type,
                            domain=self.output.response_domain)

    def score_with_metrics(self, fr: Frame) -> tuple:
        """(predictions frame, metrics) from one scoring pass (reference
        ``model_base.py:201``, the BigScore map that serves both)."""
        raw = self.score0(self.adapt_frame(fr))
        return self._predictions_frame(raw, fr.nrow), self._metrics_of(fr,
                                                                        raw)

    def auc(self):
        """The training AUC, or None where there is none (regression, or a
        multinomial AUC left unset): never NaN (reference ``:216``)."""
        a = getattr(self.output.training_metrics, "auc", None)
        if a is None or (isinstance(a, float) and np.isnan(a)):
            return None
        return a

    def varimp_table(self):
        """The variable importances as a TwoDimTable (reference ``:226``)."""
        vi = self.output.variable_importances
        if not vi:
            return None
        from ..utils.twodimtable import TwoDimTable

        return TwoDimTable.from_dict("Variable Importances", {
            "variable": list(vi["variable"]),
            "relative_importance": [float(x) for x in
                                    vi["relative_importance"]],
            "scaled_importance": [float(x) for x in vi["scaled_importance"]],
            "percentage": [float(x) for x in vi["percentage"]]})

    def scoring_history_table(self):
        """The scoring history as a TwoDimTable: scalar entries as columns,
        the training metrics' logloss/auc/rmse/mse where present and not
        NaN (reference ``:238``)."""
        hist = self.output.scoring_history
        if not hist:
            return None
        from ..utils.twodimtable import TwoDimTable

        cols: dict[str, list] = {}
        for h in hist:
            for k, v in h.items():
                if k == "training_metrics":
                    for mk in ("logloss", "auc", "rmse", "mse"):
                        mv = getattr(v, mk, None)
                        if mv is not None and not np.isnan(mv):
                            cols.setdefault(f"training_{mk}", []).append(
                                float(mv))
                elif isinstance(v, (int, float, str)):
                    cols.setdefault(k, []).append(v)
        return TwoDimTable.from_dict("Scoring History", cols)

    def save_mojo(self, path: str) -> str:
        """MOJO export (`hex/ModelMojoWriter.java`, ``mojo/writer.py``):
        the zip the reference writes for this model."""
        from ..mojo.writer import export_mojo

        return export_mojo(self, path)

    download_mojo = save_mojo   # the h2o-py name

    def save_pojo(self, path: str, class_name: str | None = None) -> str:
        """Java source scorer (`hex/tree/TreeJCodeGen`, `toJavaPredict`;
        ``mojo/pojo.py``) for tree and GLM models."""
        from ..mojo.pojo import export_pojo

        return export_pojo(self, path, class_name)

    download_pojo = save_pojo

    def partial_dependence(self, fr, cols=None, nbins: int = 20,
                           weight_column=None, targets=None,
                           row_index: int = -1):
        from .explain import partial_dependence

        return partial_dependence(self, fr, cols, nbins, weight_column,
                                  targets, row_index=row_index)

    def permutation_importance(self, fr, metric: str = "AUTO",
                               n_repeats: int = 1, seed: int = -1):
        from .explain import permutation_varimp

        return permutation_varimp(self, fr, metric, n_repeats, seed)


def _response_device(fr: Frame, response: str, train_dom) -> torch.Tensor:
    """The response column as codes of the training domain: a categorical
    response whose domain differs is remapped by level name (levels the
    training never saw become NaN and drop out of the metrics)."""
    v = fr.vec(response)
    if train_dom is None or v.domain is None or v.domain == list(train_dom):
        return v.data
    remap = {lvl: i for i, lvl in enumerate(train_dom)}
    codes = torch.tensor([float(remap.get(lvl, np.nan)) for lvl in v.domain],
                         dtype=torch.float32, device=v.data.device)
    ok = ~torch.isnan(v.data)
    idx = torch.where(ok, v.data, 0.0).to(torch.int64)
    return torch.where(ok, codes[idx], torch.nan)


class ModelBuilder:
    """Per-algo builders subclass this and implement ``build_impl``."""

    algo_name = "base"
    supervised = True                 # False: no response (KMeans, PCA, SVD,
                                      # the DL autoencoder)
    supports_cv = True                # False for transformers that read the
                                      # fold column themselves (TargetEncoder's
                                      # KFold strategy)
    _constant_response_check = False  # True in tree builders (SharedTree)

    def __init__(self, params: Parameters):
        self.params = params
        self.job: Job | None = None
        self._validate()

    def _validate(self):
        p = self.params
        if p.training_frame is None:
            raise ValueError("training_frame is required")
        at = (p.auc_type or "AUTO").lower()
        if at not in ("auto", "none", "macro_ovr", "weighted_ovr",
                      "macro_ovo", "weighted_ovo"):
            raise ValueError(
                f"auc_type '{p.auc_type}' must be one of AUTO, NONE, "
                "MACRO_OVR, WEIGHTED_OVR, MACRO_OVO, WEIGHTED_OVO")
        if self.supervised:
            if not p.response_column:
                raise ValueError(f"{self.algo_name}: response_column is "
                                 "required")
            if p.training_frame.find(p.response_column) < 0:
                raise ValueError(f"response_column '{p.response_column}' "
                                 "not in frame")
        cmf = p.custom_metric_func
        if isinstance(cmf, str) and cmf.startswith("python:"):
            # the reference resolves it through an uploaded file in the
            # K/V store (`custom_udf.py:111-127`): the REST tier
            raise NotImplementedError(
                f"{self.algo_name}: a custom metric uploaded as "
                f"{cmf!r} is not ported yet (ROADMAP Queue 1 item 13); "
                "pass a callable")
        if (self.supervised and p.check_constant_response
                and self._constant_response_check):
            r = p.training_frame.vec(p.response_column).rollups()
            if r.nacnt < r.nrow and r.mins == r.maxs:
                raise ValueError(
                    f"{self.algo_name}: response is constant — set "
                    "check_constant_response=False to train anyway "
                    "(hex/tree/SharedTree constant-response check)")

    def feature_names(self) -> list[str]:
        """Non-ignored, non-special columns; constant and all-NA columns
        drop out under ``ignore_const_cols`` (the reference's rule). Every
        builder takes an ``offset_column`` and leaves it out here
        (reference ``model_base.py:373,386``); only GLM, GAM, ANOVA GLM's
        sub-fits and XGBoost's gblinear read it, as in the reference."""
        p = self.params
        skip = set(p.ignored_columns) | {p.response_column, p.weights_column,
                                         p.offset_column, p.fold_column, None}
        out = []
        for name in p.training_frame.names:
            if name in skip or p.training_frame.vec(name).is_string():
                continue
            if p.ignore_const_cols:
                r = p.training_frame.vec(name).rollups()
                if r.nacnt == r.nrow or r.mins == r.maxs:
                    continue
            out.append(name)
        if not out:
            raise ValueError(
                f"{self.algo_name}: no usable feature columns (all constant, "
                "all-NA, or ignored) — set ignore_const_cols=False to keep "
                "constant columns")
        return out

    def response_info(self):
        """(y tensor, model_category, response domain)."""
        p = self.params
        v = p.training_frame.vec(p.response_column)
        if v.is_string():
            raise ValueError(
                f"{self.algo_name}: response_column '{p.response_column}' "
                "is a string column — convert it to categorical first")
        if v.is_categorical():
            cat = "Binomial" if len(v.domain) == 2 else "Multinomial"
            return v.data, cat, v.domain
        dist = (p.distribution or "AUTO").lower()
        if dist in ("bernoulli", "quasibinomial"):
            return v.data, "Binomial", ["0", "1"]
        if dist == "multinomial":
            k = int(v.max()) + 1
            return v.data, "Multinomial", [str(i) for i in range(k)]
        return v.data, "Regression", None

    def build_impl(self, job: Job) -> Model:
        raise NotImplementedError

    def _is_cv(self) -> bool:
        p = self.params
        return self.supports_cv and (p.nfolds >= 2 or bool(p.fold_column))

    def train(self, background: bool = True) -> Job:
        """trainModel analog: the running Job. The build (with
        cross-validation when ``nfolds`` >= 2 or a ``fold_column`` asks for
        it) runs on a worker thread unless ``background`` is False;
        ``run_time_ms`` is taken after the device has finished the model's
        work."""
        self.job = Job(f"{self.algo_name} training", work=1.0)
        self.job.set_max_runtime(self.params.max_runtime_secs)
        # a Generic model reads a MOJO, not a frame
        dev = getattr(self.params.training_frame, "device", None)

        def run():
            t0 = time.perf_counter()
            # recovery persists the original inputs: a resumed build
            # replays the (deterministic) encoding itself
            self._arm_auto_recovery()
            enc_state = self._apply_categorical_encoding()
            model = (self._train_with_cv(self.job) if self._is_cv()
                     else self.build_impl(self.job))
            if enc_state is not None:
                model.output.encoding_state = enc_state
                for cv in model.output.cv_models:
                    cv.output.encoding_state = enc_state
            self._apply_custom_metric(model)
            if dev is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            model.output.run_time_ms = int((time.perf_counter() - t0) * 1000)
            self.job.dest_key = model.key
            if self._recovery is not None:
                self._recovery.mark_completed(model.key)
            return model

        self.job.start(run, background=background, device=dev)
        return self.job

    def train_model(self) -> Model:
        return self.train(background=False).join()

    # -- preemption-proof training (auto-recovery checkpoints) ----------------
    _recovery = None       # TrainingRecovery while an armed build runs
    _resume_state = None   # iteration state injected by resume_training

    def _arm_auto_recovery(self) -> None:
        """Arm periodic atomic checkpointing when the params name a
        recovery dir. CV builds train without it, as in the reference (the
        manifest would need a per-fold protocol)."""
        from ..backend.persist import TrainingRecovery

        self._recovery = None
        rdir = self.params.auto_recovery_dir
        if not rdir:
            return
        if self._is_cv():
            warn("auto-recovery checkpoints are not supported for CV "
                 "builds — training without them")
            return
        try:
            rec = TrainingRecovery(rdir)
            if self._resume_state is None:
                if not rec.init_for(self):
                    return
            else:
                rec._last_write = time.monotonic()  # the interval restarts
        except OSError as e:
            # an unwritable dir degrades to training without insurance
            warn(f"auto-recovery disabled: recovery dir {rdir!r} unusable "
                 f"({e!r})")
            return
        self._recovery = rec

    def _recovery_tick(self, state_fn, progress: dict | None = None) -> None:
        """Builders call this at every boundary they can resume from; the
        state is captured (and the write paid) only when the interval has
        elapsed. ``state_fn`` returns the exact iteration state, tensors
        welcome: restoring it and replaying the remaining iterations is
        bit-equal to never having stopped."""
        self._preempt_tick(state_fn, progress)
        rec = self._recovery
        if rec is None or not rec.due():
            return
        try:
            rec.save_state(state_fn(), progress)
        except OSError as e:
            # disk gone mid-train: lose the insurance, keep the job
            # (injected faults are RuntimeErrors and still propagate)
            warn(f"auto-recovery disabled mid-train: checkpoint write to "
                 f"{rec.dir!r} failed ({e!r})")
            self._recovery = None

    def _preempt_tick(self, state_fn, progress: dict | None = None) -> None:
        """The preemption poll, on the checkpoint boundaries: a preempt
        request (``Job.request_preempt``, or the ``workload.preempt``
        failpoint) force-checkpoints the state, bypassing the interval, and
        unwinds with ``JobPreempted``. Ignored when no recovery is armed: a
        job without it never loses work."""
        job = self.job
        want = job is not None and job.preempt_requested
        try:
            failpoints.hit("workload.preempt")
        except failpoints.InjectedFault:
            want = True     # raise@K = "preempt exactly before boundary K"
        rec = self._recovery
        if not want or rec is None:
            return
        rec.save_state(state_fn(), progress)
        if job is not None:
            job.clear_preempt()
        raise JobPreempted(str(job.key) if job else "<no job>", rec.dir)

    def _take_resume_state(self):
        """The iteration state ``resume_training`` injected (None on a
        fresh build); a recovery dir of another algorithm refuses."""
        rs = self._resume_state
        if rs is not None and rs.get("algo") != self.algo_name:
            raise ValueError(
                f"recovery state is for algo {rs.get('algo')!r}, "
                f"this builder is {self.algo_name!r}")
        return rs

    def _apply_categorical_encoding(self):
        """Eigen, OneHotExplicit, Binary, LabelEncoder, EnumLimited or
        SortByResponse (reference ``model_base.py:674-699``): freeze the
        transform on the training frame, swap the params to the encoded
        training and validation frames, and return the state the model
        replays at scoring (None for AUTO/Enum)."""
        from ..utils.linalg import apply_encoding_state, build_encoding_state

        p = self.params
        skip = [p.response_column, p.weights_column, p.offset_column,
                p.fold_column] + list(p.ignored_columns)
        state = build_encoding_state(
            p.training_frame, p.categorical_encoding,
            skip=[s for s in skip if s], response=p.response_column,
            weights=p.weights_column,
            max_levels=int(p.max_categorical_levels or 10))
        if state is None:
            return None
        updates = {"training_frame": apply_encoding_state(p.training_frame,
                                                          state)}
        if p.validation_frame is not None:
            updates["validation_frame"] = apply_encoding_state(
                p.validation_frame, state)
        self.params = p.clone(**updates)
        return state

    def _apply_custom_metric(self, model: Model) -> None:
        """One extra scoring pass on the model's device, then the user's
        ``custom_metric_func(y, raw, w) -> (name, value)`` on numpy copies,
        attached to the training metrics (reference ``model_base.py:
        701-725``, `hex/CMetricScoringTask`)."""
        cmf = self.params.custom_metric_func
        m = model.output.training_metrics
        if not callable(cmf) or m is None or not self.supervised:
            return
        fr = self.params.training_frame
        try:
            raw = model.score0(model.adapt_frame(fr))[: fr.nrow]
        except NotImplementedError:
            return
        raw = raw.cpu().numpy()
        y = fr.vec(self.params.response_column).to_numpy()
        w = (np.nan_to_num(fr.vec(self.params.weights_column).to_numpy())
             if self.params.weights_column
             else np.ones(fr.nrow, np.float32))
        name, value = cmf(y, raw, w)
        m.custom_metric_name = name
        m.custom_metric_value = float(value)

    # -- cross-validation (`hex/ModelBuilder.java:614`) -----------------------
    def _train_with_cv(self, job: Job) -> Model:
        """One model per fold on the other folds' rows, scored on its own
        fold, then the main model on the whole frame. Each fold builder
        takes the parameters with the fold's frame, no validation frame
        and no folds, as the reference's does, under a job that shares the
        outer job's deadline."""
        p = self.params
        fr = p.training_frame
        folds = self._fold_assignment(fr)
        nf = int(folds.max()) + 1
        cv_models, holdout_metrics, fold_preds = [], [], []
        holdout = names = None
        for f in range(nf):
            job.check_cancelled()
            tr_idx = np.flatnonzero(folds != f)
            va_idx = np.flatnonzero(folds == f)
            va = fr.take(va_idx)
            sub = type(self)(dataclasses.replace(
                p, training_frame=fr.take(tr_idx), validation_frame=None,
                nfolds=0, fold_column=None))
            fold_job = Job(f"cv_{f}", work=1.0)
            fold_job.deadline = job.deadline
            m = sub.build_impl(fold_job)
            if self.supervised or type(m).model_performance is not \
                    Model.model_performance:
                # an unsupervised model has holdout metrics only where it
                # defines its own (KMeans' clustering sums of squares)
                holdout_metrics.append(m.model_performance(va))
            if p.keep_cross_validation_predictions:
                pf = m.predict(va)
                cols = torch.stack([v.data[:va.nrow] for v in pf.vecs],
                                   dim=1)
                idx = torch.from_numpy(va_idx).to(cols.device)
                if holdout is None:
                    names = pf.names
                    holdout = torch.full((fr.nrow, pf.ncol), float("nan"),
                                         device=cols.device)
                holdout[idx] = cols
                full = torch.zeros((fr.nrow, pf.ncol), device=cols.device)
                full[idx] = cols
                fold_preds.append(_columns_frame(names, full))
            cv_models.append(m)
        main = self.build_impl(job)
        main.output.cross_validation_metrics = _mean_metrics(holdout_metrics)
        if p.keep_cross_validation_models:
            main.output.cv_models = cv_models
        if holdout is not None:
            hp = _columns_frame(names, holdout)
            hp.key = make_key("cv_holdout_prediction")
            STORE.put_keyed(hp)
            main.output.cv_holdout_predictions = hp
            for i, fp in enumerate(fold_preds):
                fp.key = make_key(f"cv_{i + 1}_prediction")
                STORE.put_keyed(fp)
            main.output.cv_fold_predictions = fold_preds
        if p.keep_cross_validation_fold_assignment:
            fa = Frame(["fold_assignment"],
                       [Vec.from_numpy(folds.astype(np.float32),
                                       device=fr.device)],
                       key=make_key("cv_fold_assignment"))
            STORE.put_keyed(fa)
            main.output.cv_fold_assignment = fa
        return main

    def _fold_assignment(self, fr: Frame) -> np.ndarray:
        """Each row's fold: the fold column, or AUTO/Random, Modulo or
        Stratified draws from numpy's ``default_rng(seed)``."""
        p = self.params
        if p.fold_column:
            return fr.vec(p.fold_column).to_numpy().astype(np.int64)
        n = fr.nrow
        scheme = p.fold_assignment.upper()
        rng = np.random.default_rng(None if p.seed in (-1, None) else p.seed)
        if scheme == "MODULO":
            return np.arange(n) % p.nfolds
        if scheme == "STRATIFIED" and self.supervised:
            y = fr.vec(p.response_column).to_numpy()
            out = np.zeros(n, dtype=np.int64)
            for cls in np.unique(y[~np.isnan(y)]):
                idx = np.where(y == cls)[0]
                out[idx] = rng.permutation(len(idx)) % p.nfolds
            return out
        return rng.integers(0, p.nfolds, size=n)


def resume_training(recovery_dir: str, device=None) -> Model:
    """Restart a killed training job from its auto-recovery directory and
    train it to completion, on ``device`` (default ``cuda``).

    Loads the builder class, the original params (frames from the dir) and
    the latest checkpointed iteration state, then replays the remaining
    iterations. Every random stream is indexed by global iteration and the
    checkpoint holds the exact carried device state, so the model is
    bit-equal to the one the uninterrupted run would have built. A job
    killed before its first state write replays from the start, as the
    reference's does.

    Raises ``ValueError`` when the dir holds no training manifest or the
    recorded job already completed (the manifest then names
    ``model_key``)."""
    from ..backend.persist import TrainingRecovery

    builder_cls, params, state, manifest = TrainingRecovery.load(
        recovery_dir, device=device)
    if manifest.get("completed"):
        raise ValueError(
            f"training in {recovery_dir} already completed "
            f"(model {manifest.get('model_key')!r}) — nothing to resume")
    params = dataclasses.replace(params, auto_recovery_dir=recovery_dir)
    builder = builder_cls(params)
    builder._resume_state = state
    return builder.train_model()


def _columns_frame(names, cols: torch.Tensor) -> Frame:
    """(nrow, C) prediction columns -> a Frame of numeric columns."""
    nrow = cols.shape[0]
    vecs = []
    for j in range(cols.shape[1]):
        buf = torch.full((padded_len(nrow),), float("nan"),
                         device=cols.device)
        buf[:nrow] = cols[:, j]
        vecs.append(Vec(buf, nrow))
    return Frame(list(names), vecs)


def _mean_metrics(ms: list):
    """The reference's CV metrics: fold 0's holdout metrics object with its
    seven scalar fields replaced by their means over the folds (NaNs
    skipped). H2O-3 pools the holdout predictions instead; the port keeps
    the reference's form (ROADMAP Queue 3)."""
    if not ms:
        return None
    out = ms[0]
    for fname in ("mse", "rmse", "mae", "auc", "logloss", "r2",
                  "mean_per_class_error"):
        vals = [getattr(m, fname) for m in ms if hasattr(m, fname)]
        vals = [v for v in vals if v is not None and not np.isnan(v)]
        if vals and hasattr(out, fname):
            setattr(out, fname, float(np.mean(vals)))
    return out
