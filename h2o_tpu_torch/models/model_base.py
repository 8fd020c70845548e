"""Model / ModelBuilder / Parameters (``h2o_tpu/models/model_base.py``).

``Parameters`` keeps the reference's field names and defaults so the two
packages take the same arguments. ``train_model`` runs the build
synchronously on the training frame's device, with N-fold
cross-validation (`hex/ModelBuilder.java:614` computeCrossValidation) when
``nfolds`` or ``fold_column`` asks for it: fold assignment (random, modulo
or stratified from numpy's ``default_rng(seed)``, or the fold column), one
model per fold on the complement, holdout metrics and predictions, then
the main model on the whole frame. Jobs, the K/V store, checkpoints and
checkpoint exports wait for a later slice, and options that need them
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, Vec
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
    distribution: str = "AUTO"
    ignore_const_cols: bool = True
    check_constant_response: bool = True
    stopping_rounds: int = 0
    stopping_metric: str = "AUTO"
    stopping_tolerance: float = 1e-3
    auc_type: str = "AUTO"  # multinomial AUC aggregate: AUTO(=NONE)|NONE|
                            # MACRO_OVR|WEIGHTED_OVR|MACRO_OVO|WEIGHTED_OVO
    checkpoint: Any = None
    export_checkpoints_dir: Optional[str] = None


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


class Model:
    algo_name = "base"

    def __init__(self, params: Parameters, output: ModelOutput):
        self.params = params
        self.output = output

    def score0(self, X: torch.Tensor) -> torch.Tensor:
        """Raw per-row prediction on a dense (R, F) matrix: (R,) for
        regression, (R, 1 + K) [label, p0, ..., pK-1] for a K-class
        classifier."""
        raise NotImplementedError

    def adapt_frame(self, fr: Frame) -> torch.Tensor:
        """adaptTestForTrain analog: training columns of ``fr`` in training
        order, as a (plen, F) matrix on the frame's device, categorical codes
        remapped onto the training domain by level name (unseen levels become
        NaN and follow each node's NA direction)."""
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
        raw = self.score0(self.adapt_frame(fr))
        p = self.params
        w = fr.vec(p.weights_column).data if p.weights_column else None
        y = _response_device(fr, p.response_column,
                             self.output.response_domain)
        return make_metrics(self.output.model_category, y, raw, w,
                            auc_type=p.auc_type,
                            domain=self.output.response_domain)


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
    _constant_response_check = False  # True in tree builders (SharedTree)
    _offset_supported = False         # True in builders that take an offset

    def __init__(self, params: Parameters):
        self.params = params
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
        if not p.response_column:
            raise ValueError(f"{self.algo_name}: response_column is required")
        if p.training_frame.find(p.response_column) < 0:
            raise ValueError(f"response_column '{p.response_column}' not in frame")
        for bad, what in ((p.offset_column and not self._offset_supported,
                           "offset columns (ROADMAP Queue 1 item 6)"),
                          (p.checkpoint is not None,
                           "checkpoints (ROADMAP Queue 1 item 12)"),
                          (p.export_checkpoints_dir,
                           "export_checkpoints_dir (ROADMAP Queue 1 item "
                           "12)")):
            if bad:
                raise NotImplementedError(f"{self.algo_name}: {what} is not "
                                          f"ported yet")
        if p.check_constant_response and self._constant_response_check:
            r = p.training_frame.vec(p.response_column).rollups()
            if r.nacnt < r.nrow and r.mins == r.maxs:
                raise ValueError(
                    f"{self.algo_name}: response is constant — set "
                    "check_constant_response=False to train anyway "
                    "(hex/tree/SharedTree constant-response check)")

    def feature_names(self) -> list[str]:
        """Non-ignored, non-special columns; constant and all-NA columns
        drop out under ``ignore_const_cols`` (the reference's rule)."""
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

    def build_impl(self) -> Model:
        raise NotImplementedError

    def train_model(self) -> Model:
        """Build synchronously (with cross-validation when ``nfolds`` >= 2
        or a ``fold_column`` asks for it); ``run_time_ms`` is taken after
        the device has finished the model's work."""
        t0 = time.perf_counter()
        p = self.params
        if p.nfolds >= 2 or p.fold_column:
            model = self._train_with_cv()
        else:
            model = self.build_impl()
        if self.params.training_frame.device.type == "cuda":
            torch.cuda.synchronize(self.params.training_frame.device)
        model.output.run_time_ms = int((time.perf_counter() - t0) * 1000)
        return model

    # -- cross-validation (`hex/ModelBuilder.java:614`) -----------------------
    def _train_with_cv(self) -> Model:
        """One model per fold on the other folds' rows, scored on its own
        fold, then the main model on the whole frame. Each fold builder
        takes the parameters with the fold's frame, no validation frame
        and no folds, as the reference's does."""
        p = self.params
        fr = p.training_frame
        folds = self._fold_assignment(fr)
        nf = int(folds.max()) + 1
        cv_models, holdout_metrics, fold_preds = [], [], []
        holdout = names = None
        for f in range(nf):
            tr_idx = np.flatnonzero(folds != f)
            va_idx = np.flatnonzero(folds == f)
            va = fr.take(va_idx)
            sub = type(self)(dataclasses.replace(
                p, training_frame=fr.take(tr_idx), validation_frame=None,
                nfolds=0, fold_column=None))
            m = sub.build_impl()
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
        main = self.build_impl()
        main.output.cross_validation_metrics = _mean_metrics(holdout_metrics)
        if p.keep_cross_validation_models:
            main.output.cv_models = cv_models
        if holdout is not None:
            main.output.cv_holdout_predictions = _columns_frame(names, holdout)
            main.output.cv_fold_predictions = fold_preds
        if p.keep_cross_validation_fold_assignment:
            main.output.cv_fold_assignment = Frame(
                ["fold_assignment"],
                [Vec.from_numpy(folds.astype(np.float32), device=fr.device)])
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
        if scheme == "STRATIFIED":
            y = fr.vec(p.response_column).to_numpy()
            out = np.zeros(n, dtype=np.int64)
            for cls in np.unique(y[~np.isnan(y)]):
                idx = np.where(y == cls)[0]
                out[idx] = rng.permutation(len(idx)) % p.nfolds
            return out
        return rng.integers(0, p.nfolds, size=n)


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
