"""Generic model — a MOJO imported as a scoring model
(``h2o_tpu/models/generic.py``; `hex/generic/`).

The MOJO is read by the standalone host scorer (``mojo/reader.py``), so
any MOJO loads: the port's, the reference's and the JVM's. ``predict``
scores a port Frame on the host and returns the predictions as a Frame on
the model's device (``cuda`` unless ``GenericParameters.device`` says
otherwise): the scorer's float64 output cast to float32, the label column
categorical over the response domain.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..backend.jobs import Job
from ..frame.frame import Frame
from ..frame.vec import T_CAT, Vec
from ..mojo.reader import MojoModel as _MojoScorer
from ..parallel.mesh import resolve_device
from .model_base import Model, ModelBuilder, ModelOutput, Parameters


@dataclass
class GenericParameters(Parameters):
    path: str | None = None    # `hex/generic/GenericModelParameters` _mojo_key
    device: Any = None         # where predictions land (default cuda)


class GenericModel(Model):
    algo_name = "generic"

    def __init__(self, params, output, scorer: _MojoScorer, device,
                 key=None):
        self.scorer = scorer
        self.device = device
        super().__init__(params, output, key=key)

    def predict(self, fr: Frame) -> Frame:
        raw = self.scorer.predict(fr).astype(np.float32)
        if raw.ndim == 1:   # a regression value or a cluster label
            return Frame(["predict"],
                         [Vec.from_numpy(raw, device=self.device)])
        dom = self.output.response_domain or [str(i) for i in
                                              range(raw.shape[1] - 1)]
        names = ["predict"] + [f"p{d}" for d in dom]
        vecs = [Vec.from_numpy(raw[:, 0], type=T_CAT, domain=list(dom),
                               device=self.device)]
        vecs += [Vec.from_numpy(raw[:, j], device=self.device)
                 for j in range(1, raw.shape[1])]
        return Frame(names, vecs)

    def score0(self, X):
        return self.scorer.score(np.asarray(X))


class Generic(ModelBuilder):
    """`hex/generic/Generic.java` — a model from a MOJO file."""

    algo_name = "generic"
    supervised = False

    def _validate(self):
        path = getattr(self.params, "path", None)
        if not path:
            raise ValueError("generic: 'path' to a MOJO file is required")
        if isinstance(path, str) and os.path.exists(path):
            return
        if isinstance(path, str) and (os.sep in path
                                      or path.endswith(".zip")):
            raise FileNotFoundError(f"generic: no MOJO at {path}")
        # `h2o.upload_mojo` hands the REST upload's key as the path
        raise NotImplementedError(
            f"generic: {path!r} names no file; an uploaded MOJO's key (the "
            "REST tier) is not ported yet (ROADMAP Queue 1 item 13, step K)")

    def build_impl(self, job: Job) -> Model:
        device = resolve_device(self.params.device)
        scorer = _MojoScorer.load(self.params.path)
        output = ModelOutput()
        feats = (scorer.columns[:-1] if scorer.supervised
                 else list(scorer.columns))
        output.names = feats
        output.domains = {n: scorer.domains[i] for i, n in enumerate(feats)}
        if scorer.supervised:
            output.response_domain = scorer.domains[len(scorer.columns) - 1]
            self.params.response_column = scorer.response_column
        output.model_category = scorer.category
        return GenericModel(self.params, output, scorer, device)


def import_mojo(path: str, device=None) -> GenericModel:
    """`h2o.import_mojo`: the MOJO at ``path`` as a model whose predictions
    land on ``device`` (default ``cuda``)."""
    return Generic(GenericParameters(path=path, device=device)).train_model()
