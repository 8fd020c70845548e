"""Model / ModelBuilder / Parameters (``h2o_tpu/models/model_base.py``).

``Parameters`` keeps the reference's field names and defaults so the two
packages take the same arguments. ``train_model`` runs the build
synchronously on the training frame's device; jobs, the K/V store,
cross-validation, checkpoints and checkpoint exports wait for a later
slice, and options that need them raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, Vec
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
    seed: int = -1
    distribution: str = "AUTO"
    ignore_const_cols: bool = True
    check_constant_response: bool = True
    stopping_rounds: int = 0
    stopping_metric: str = "AUTO"
    stopping_tolerance: float = 1e-3
    auc_type: str = "AUTO"  # multinomial AUC aggregate: AUTO (= NONE) only
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
        self.scoring_history: list[dict] = []
        self.variable_importances: dict | None = None
        self.run_time_ms = 0


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
                            auc_type=p.auc_type)


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
        if not p.response_column:
            raise ValueError(f"{self.algo_name}: response_column is required")
        if p.training_frame.find(p.response_column) < 0:
            raise ValueError(f"response_column '{p.response_column}' not in frame")
        for bad, what in ((p.nfolds >= 2 or p.fold_column,
                           "cross-validation (ROADMAP Queue 1 item 6)"),
                          (p.offset_column and not self._offset_supported,
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
            if name in skip:
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
        """Build synchronously; ``run_time_ms`` is taken after the device
        has finished the model's work."""
        t0 = time.perf_counter()
        model = self.build_impl()
        if self.params.training_frame.device.type == "cuda":
            torch.cuda.synchronize(self.params.training_frame.device)
        model.output.run_time_ms = int((time.perf_counter() - t0) * 1000)
        return model
