"""Stacked Ensemble — a metalearner over base-model predictions
(``h2o_tpu/models/ensemble.py``, `hex/ensemble/`).

Two ways to build the level-one frame, as in the reference:

- CV stacking (default): the base models share a fold assignment and keep
  their CV holdout predictions; the level-one frame is those out-of-fold
  predictions, so nothing leaks;
- blending: the base models score a held-out ``blending_frame``.

The metalearner is ``AUTO`` (a GLM of the response's family with
``non_negative`` and ``lambda_`` 0, `Metalearners.java`), ``glm``,
``gbm``, ``drf`` or ``deeplearning``. A binomial base model contributes its
p1 column, a multinomial one its K class columns, a regression one its
prediction. The base models and the metalearner score on the frame's
device; the level-one columns never leave it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from ..backend.jobs import Job
from ..frame.frame import Frame
from ..parallel.mesh import resolve_device
from .metrics import make_metrics
from .model_base import (Model, ModelBuilder, ModelOutput, Parameters,
                         _response_device)


@dataclass
class StackedEnsembleParameters(Parameters):
    base_models: list = field(default_factory=list)
    metalearner_algorithm: str = "AUTO"  # AUTO|glm|gbm|drf|deeplearning
    metalearner_params: dict = field(default_factory=dict)
    blending_frame: Frame | None = None


def _base_feature_cols(model, pred_frame: Frame) -> dict:
    """Level-one columns contributed by one base model's predictions."""
    cat = model.output.model_category
    key = model.key
    if cat == "Binomial":
        return {key: pred_frame.vec(2)}  # p(positive class)
    if cat == "Multinomial":
        return {f"{key}/{n}": pred_frame.vec(i)
                for i, n in enumerate(pred_frame.names) if i >= 1}
    return {key: pred_frame.vec(0)}


class StackedEnsembleModel(Model):
    algo_name = "stackedensemble"

    def __init__(self, params, output, base_models, metalearner, key=None):
        self.base_models = base_models
        self.metalearner = metalearner
        super().__init__(params, output, key=key)

    def level_one(self, fr: Frame) -> Frame:
        """The base models' predictions on ``fr`` as the metalearner's
        input frame."""
        cols = {}
        for bm in self.base_models:
            cols.update(_base_feature_cols(bm, bm.predict(fr)))
        return Frame(list(cols), list(cols.values()))

    def predict(self, fr: Frame) -> Frame:
        return self.metalearner.predict(self.level_one(fr))

    def model_performance(self, fr: Frame | None = None):
        if fr is None:
            return self.output.training_metrics
        pf = self.predict(fr)
        n = fr.nrow
        y = _response_device(fr, self.params.response_column,
                             self.output.response_domain)
        raw = torch.full((y.shape[0], pf.ncol), float("nan"),
                         dtype=torch.float32, device=y.device)
        raw[:n] = torch.stack([v.data[:n] for v in pf.vecs], dim=1)
        if self.output.model_category == "Regression":
            raw = raw[:, 0]
        return make_metrics(self.output.model_category, y, raw, None,
                            auc_type=self.params.auc_type,
                            domain=self.output.response_domain)

    @staticmethod
    def from_reference(ref, device=None) -> "StackedEnsembleModel":
        """Carry a JAX-trained ensemble over: each base model and the
        metalearner through its own ``from_reference`` (the metalearner's
        column names are the reference's base-model keys, so the carried
        base models keep those keys, and the metalearner keeps its own, as
        the ensemble's MOJO names them all), plus the output's category and
        response domain. Given the same frame it scores what the reference
        scores."""
        resolve_device(device)
        bases = [carry_model(bm, device, key=bm.key)
                 for bm in ref.base_models]
        meta = carry_model(ref.metalearner, device, key=ref.metalearner.key)
        out = ModelOutput()
        out.model_category = ref.output.model_category
        if ref.output.response_domain is not None:
            out.response_domain = list(ref.output.response_domain)
        out.training_metrics = meta.output.training_metrics
        rp = ref.params
        params = StackedEnsembleParameters(
            response_column=rp.response_column, base_models=bases,
            metalearner_algorithm=rp.metalearner_algorithm,
            metalearner_params=dict(rp.metalearner_params), seed=rp.seed,
            auc_type=rp.auc_type)
        return StackedEnsembleModel(params, out, bases, meta)


def carry_model(ref, device=None, key=None) -> Model:
    """A JAX-trained model of a ported algorithm as the port's model, by
    the reference model's class: GLM (multinomial included), DeepLearning,
    and the tree models (GBM, DRF, XRT, XGBoost's gbtree) through
    ``GBMModel.from_reference``."""
    from . import deeplearning, drf, gbm, glm

    kind = type(ref).__name__
    if kind in ("GLMModel", "GLMMultinomialModel"):
        m = glm.GLMModel.from_reference(ref, device=device)
    elif kind == "DeepLearningModel":
        m = deeplearning.DeepLearningModel.from_reference(ref, device=device)
    elif kind in ("GBMModel", "DRFModel"):
        cls = drf.DRFModel if kind == "DRFModel" else gbm.GBMModel
        m = cls.from_reference(
            {k: np.asarray(v) for k, v in ref.forest.items()},
            np.asarray(ref.f0), None, ref.output.names, ref.output.domains,
            dataclasses.asdict(ref.cfg),
            category=ref.output.model_category,
            response_domain=ref.output.response_domain,
            cat_nedges=ref.cat_nedges,
            response_column=ref.params.response_column, device=device)
        m.output.training_metrics = ref.output.training_metrics
    elif kind == "StackedEnsembleModel":
        m = StackedEnsembleModel.from_reference(ref, device=device)
    else:
        raise NotImplementedError(
            f"carrying a {kind} over is not ported (GLM, DeepLearning, "
            "tree models and stacked ensembles are)")
    if getattr(ref, "algo_override", None):
        m.algo_override = ref.algo_override
    if key is not None:
        from ..backend.kvstore import STORE

        STORE.remove(m.key, cascade=False)
        m.key = key
        STORE.put_keyed(m)
    return m


class StackedEnsemble(ModelBuilder):
    algo_name = "stackedensemble"

    def build_impl(self, job: Job) -> StackedEnsembleModel:
        p: StackedEnsembleParameters = self.params
        if not p.base_models:
            raise ValueError("stackedensemble: base_models is required")
        _y, category, resp_domain = self.response_info()
        cats = {m.output.model_category for m in p.base_models}
        if cats != {category}:
            raise ValueError(f"base models categories {cats} != {category}")

        # ---- level-one frame ------------------------------------------------
        cols = {}
        if p.blending_frame is not None:
            src = p.blending_frame
            for bm in p.base_models:
                cols.update(_base_feature_cols(bm, bm.predict(src)))
        else:
            for bm in p.base_models:
                hp = bm.output.cv_holdout_predictions
                if hp is None:
                    raise ValueError(
                        f"base model {bm.key} has no CV holdout "
                        "predictions — "
                        "train with nfolds>=2 and "
                        "keep_cross_validation_predictions=True")
                cols.update(_base_feature_cols(bm, hp))
            src = p.training_frame
        level_one = Frame(list(cols), list(cols.values()))
        level_one.add(p.response_column, src.vec(p.response_column))

        # ---- metalearner ----------------------------------------------------
        algo = (p.metalearner_algorithm or "AUTO").lower()
        ml_params = dict(p.metalearner_params)
        common = dict(training_frame=level_one,
                      response_column=p.response_column, seed=p.seed)
        if algo in ("auto", "glm"):
            from .glm import GLM, GLMParameters

            fam = {"Binomial": "binomial", "Multinomial": "multinomial",
                   "Regression": "gaussian"}[category]
            ml_params.setdefault("family", fam)
            ml_params.setdefault("lambda_", 0.0)
            ml_params.setdefault("non_negative", algo == "auto")
            builder = GLM(GLMParameters(**common, **ml_params))
        elif algo == "gbm":
            from .gbm import GBM, GBMParameters

            builder = GBM(GBMParameters(**common, **ml_params))
        elif algo == "drf":
            from .drf import DRF, DRFParameters

            builder = DRF(DRFParameters(**common, **ml_params))
        elif algo == "deeplearning":
            from .deeplearning import DeepLearning, DeepLearningParameters

            builder = DeepLearning(DeepLearningParameters(**common,
                                                          **ml_params))
        else:
            raise ValueError(f"unknown metalearner {algo!r}")
        meta = builder.build_impl(Job("metalearner", work=1.0))

        output = ModelOutput()
        output.names = []  # the ensemble reads base predictions, not columns
        output.response_domain = list(resp_domain) if resp_domain else None
        output.model_category = category
        model = StackedEnsembleModel(p, output, list(p.base_models), meta)
        output.training_metrics = meta.output.training_metrics
        if p.validation_frame is not None:
            output.validation_metrics = model.model_performance(
                p.validation_frame)
        return model
