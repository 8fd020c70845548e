"""Infogram — admissible machine learning (``h2o_tpu/models/infogram.py``;
`hex/Infogram/Infogram.java`, `EstimateCMI.java`, `InfogramUtils.java`).

Two modes:

- core (no protected columns): one probe model on all predictors, and per
  top-K predictor x_j one on all but x_j; the raw CMI of x_j is the full
  model's mean log-probability of the true class minus the probe's,
  floored at 0 (`InfogramUtils.java:213-228`); relevance is the full
  model's variable importance;
- fair/safety (``protected_columns``): per predictor a probe on the
  protected columns plus x_j against one on the protected columns alone;
  relevance from a model on all non-protected predictors.

Both axes are scaled to a maximum of 1; a predictor is admissible when
both reach their thresholds (0.1 by default). Probes are the port's GBM
(default), DRF, GLM or DeepLearning builders, on the training frame's
device, one after another; a regression response scores the mean Gaussian
log-density (-1/2 log(2 pi e MSE)), the reference's stand-in.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..backend.jobs import Job
from ..frame.frame import Frame
from ..frame.vec import T_STR, Vec
from .model_base import Model, ModelBuilder, ModelOutput, Parameters


@dataclass
class InfogramParameters(Parameters):
    protected_columns: list = field(default_factory=list)
    infogram_algorithm: str = "gbm"          # gbm | drf | glm | deeplearning
    infogram_algorithm_params: dict = field(default_factory=dict)
    top_n_features: int = 50
    net_information_threshold: float = 0.1   # CMI axis (safety in fair mode)
    total_information_threshold: float = 0.1  # relevance axis
    data_fraction: float = 1.0


def _mean_log_prob(model, fr: Frame, response: str) -> float:
    """``EstimateCMI``: the mean log-probability of each scorable row's
    class (probabilities clipped at 1e-10), on the device; for a
    regression probe the mean Gaussian log-density at its MSE."""
    pred = model.predict(fr)
    n = fr.nrow
    y = fr.vec(response).data[:n]
    ok = ~torch.isnan(y)
    if model.output.model_category in ("Binomial", "Multinomial"):
        probs = torch.stack([pred.vec(j).data[:n]
                             for j in range(1, pred.ncol)], dim=1)
        yi = y[ok].long()
        p = torch.clamp(probs[ok][torch.arange(yi.shape[0],
                                               device=yi.device), yi],
                        1e-10, 1.0)
        return float(torch.log(p.double()).mean())
    err = pred.vec(0).data[:n][ok].double() - y[ok].double()
    mse = float((err * err).mean())
    return -0.5 * math.log(2 * math.pi * math.e * max(mse, 1e-12))


class InfogramModel(Model):
    algo_name = "infogram"

    def __init__(self, params, output, key=None):
        super().__init__(params, output, key=key)
        self.admissible_features: list[str] = []
        self.cmi: dict[str, float] = {}
        self.relevance: dict[str, float] = {}
        self.cmi_raw: dict[str, float] = {}

    @staticmethod
    def from_reference(ref, device=None) -> "InfogramModel":
        """Carry a reference infogram's tables over."""
        out = ModelOutput.carried(ref.output)
        rp = ref.params
        params = InfogramParameters(
            response_column=rp.response_column,
            protected_columns=list(rp.protected_columns),
            infogram_algorithm=rp.infogram_algorithm,
            top_n_features=rp.top_n_features,
            net_information_threshold=rp.net_information_threshold,
            total_information_threshold=rp.total_information_threshold)
        m = InfogramModel(params, out)
        m.admissible_features = list(ref.admissible_features)
        m.cmi = {k: float(v) for k, v in ref.cmi.items()}
        m.relevance = {k: float(v) for k, v in ref.relevance.items()}
        m.cmi_raw = {k: float(v) for k, v in ref.cmi_raw.items()}
        return m

    def get_admissible_score_frame(self) -> Frame:
        """column, admissible, admissible_index, relevance, cmi, cmi_raw
        (`InfogramUtils.java:194`), by admissible index, largest first."""
        names = list(self.cmi)
        rel = np.array([self.relevance[n] for n in names])
        cmi = np.array([self.cmi[n] for n in names])
        adm = np.array([1.0 if n in self.admissible_features else 0.0
                        for n in names])
        # admissible_index: the distance from the ideal (1, 1) corner, scaled
        idx = 1.0 - np.sqrt(((1 - rel) ** 2 + (1 - cmi) ** 2) / 2.0)
        order = np.argsort(-idx)
        dev = self.params.training_frame.device \
            if self.params.training_frame is not None else "cpu"

        def num(a):
            return Vec.from_numpy(np.asarray(a, np.float32), device=dev)
        cols = {
            "column": Vec(None, len(names), type=T_STR,
                          host_data=np.asarray([names[i] for i in order],
                                               dtype=object)),
            "admissible": num(adm[order]),
            "admissible_index": num(idx[order]),
            "relevance": num(rel[order]),
            "cmi": num(cmi[order]),
            "cmi_raw": num([self.cmi_raw[names[i]] for i in order]),
        }
        return Frame(list(cols), list(cols.values()))

    def score0(self, X):
        raise NotImplementedError("Infogram produces an admissibility "
                                  "analysis, not row scores")

    def predict(self, fr):
        raise NotImplementedError("use get_admissible_score_frame()")


class Infogram(ModelBuilder):
    algo_name = "infogram"

    def _probe_builder(self):
        from . import deeplearning, drf, gbm, glm

        name = (self.params.infogram_algorithm or "gbm").lower()
        table = {"gbm": (gbm.GBM, gbm.GBMParameters),
                 "drf": (drf.DRF, drf.DRFParameters),
                 "glm": (glm.GLM, glm.GLMParameters),
                 "deeplearning": (deeplearning.DeepLearning,
                                  deeplearning.DeepLearningParameters)}
        if name not in table:
            raise ValueError(f"unsupported infogram_algorithm '{name}'")
        return table[name]

    def _train_probe(self, feats: list[str]) -> Model:
        p = self.params
        cls, pcls = self._probe_builder()
        valid = {f.name for f in dataclasses.fields(pcls)}
        over = {k: v for k, v in p.infogram_algorithm_params.items()
                if k in valid}
        if "ntrees" in valid:
            over.setdefault("ntrees", 10)
            over.setdefault("max_depth", 5)
        ignored = [n for n in p.training_frame.names
                   if n not in feats and n != p.response_column]
        params = pcls(training_frame=p.training_frame,
                      response_column=p.response_column,
                      ignored_columns=ignored, seed=p.seed, **over)
        return cls(params).build_impl(Job("infogram probe", work=1.0))

    def build_impl(self, job) -> InfogramModel:
        p: InfogramParameters = self.params
        fr = p.training_frame
        protected = list(p.protected_columns or [])
        build_core = not protected  # `Infogram.java:182`
        feats = [n for n in self.feature_names() if n not in protected]

        # the full / relevance model on all (non-protected) predictors
        full = self._train_probe(feats)
        vi = full.output.variable_importances
        rel_raw = {n: 0.0 for n in feats}
        if vi:
            for n, v in zip(vi["variable"], vi["relative_importance"]):
                base = n.split(".")[0]  # one-hot expanded names fold back
                if base in rel_raw:
                    rel_raw[base] += float(v)
        max_rel = max(rel_raw.values()) or 1.0
        relevance = {n: v / max_rel for n, v in rel_raw.items()}

        # the top K by relevance (`extractTopKPredictors`)
        k = min(p.top_n_features, len(feats))
        top = sorted(feats, key=lambda n: -relevance[n])[:k]

        if build_core:
            base_cmi = _mean_log_prob(full, fr, p.response_column)
        else:
            base_cmi = _mean_log_prob(self._train_probe(protected), fr,
                                      p.response_column)
        cmi_raw = {}
        for name in top:
            job.check_cancelled()
            if build_core:
                probe = self._train_probe([n for n in top if n != name])
                raw = max(0.0, base_cmi - _mean_log_prob(
                    probe, fr, p.response_column))
            else:
                probe = self._train_probe(protected + [name])
                raw = max(0.0, _mean_log_prob(probe, fr, p.response_column)
                          - base_cmi)
            cmi_raw[name] = raw
            job.update(1.0 / max(len(top), 1))

        max_cmi = max(cmi_raw.values()) if cmi_raw else 0.0
        scale = 1.0 / max_cmi if max_cmi > 0 else 0.0
        cmi = {n: v * scale for n, v in cmi_raw.items()}

        out = ModelOutput()
        out.model_category = "Infogram"
        out.names = top
        out.domains = {n: fr.vec(n).domain for n in top}
        model = InfogramModel(p, out)
        model.cmi_raw = cmi_raw
        model.cmi = cmi
        model.relevance = {n: relevance[n] for n in top}
        model.admissible_features = [
            n for n in top
            if cmi[n] >= p.net_information_threshold
            and relevance[n] >= p.total_information_threshold]
        model.output.variable_importances = vi
        return model
