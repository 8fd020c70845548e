"""AdaBoost (``h2o_tpu/models/adaboost.py``, `hex/adaboost/AdaBoost.java`):
binary SAMME boosting over the port's weak learners.

Each round trains a weak learner — DRF (the default: one depth-2 tree,
``mtries`` 1, no row sample), GBM, GLM or DeepLearning, as the reference's
``weak_learner`` enum — on the current row weights through its builder's
``weights_column``, takes the weighted error and the learner's
coefficient alpha, and up-weights the rows it missed. The weights live on
the device in float64, as the reference's host weights do, and each round
hands the learner the float32 column ``w / sum(w) * n``. Boosting stops
at a learner no better than chance. A prediction is the sign of the
alpha-weighted vote, its probability ``1 / (1 + exp(-2 vote / sum
alpha))``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..backend.jobs import Job
from ..frame.frame import Frame
from ..frame.vec import T_CAT, Vec
from ..parallel.mesh import padded_len
from .metrics import make_metrics
from .model_base import (Model, ModelBuilder, ModelOutput, Parameters,
                         _response_device)


@dataclass
class AdaBoostParameters(Parameters):
    nlearners: int = 50
    weak_learner: str = "DRF"  # DRF | GLM | GBM | DEEP_LEARNING
    learn_rate: float = 0.5


def _make_weak(kind: str, fr, response, weights_col, seed):
    """The reference's weak learners, with its settings."""
    kind = kind.upper()
    if kind == "GLM":
        from .glm import GLM, GLMParameters

        return GLM(GLMParameters(training_frame=fr, response_column=response,
                                 weights_column=weights_col, family="binomial",
                                 seed=seed))
    if kind == "GBM":
        from .gbm import GBM, GBMParameters

        return GBM(GBMParameters(training_frame=fr, response_column=response,
                                 weights_column=weights_col, ntrees=1,
                                 max_depth=3, seed=seed))
    if kind in ("DEEP_LEARNING", "DEEPLEARNING"):
        from .deeplearning import DeepLearning, DeepLearningParameters

        return DeepLearning(DeepLearningParameters(
            training_frame=fr, response_column=response,
            weights_column=weights_col, hidden=[8], epochs=5, seed=seed))
    from .drf import DRF, DRFParameters

    return DRF(DRFParameters(training_frame=fr, response_column=response,
                             weights_column=weights_col, ntrees=1,
                             max_depth=2, mtries=1, sample_rate=1.0, seed=seed))


def _signs(model, fr) -> torch.Tensor:
    """A learner's predicted labels of ``fr``'s rows as +1 / -1 (float64)."""
    lab = model.predict(fr).vec("predict").data[:fr.nrow]
    return torch.where(lab > 0, 1.0, -1.0).double()


class AdaBoostModel(Model):
    algo_name = "adaboost"

    def __init__(self, params, output, learners, alphas, key=None):
        self.learners = learners
        self.alphas = alphas
        super().__init__(params, output, key=key)

    @staticmethod
    def from_reference(ref, device=None) -> "AdaBoostModel":
        """Carry a JAX-trained AdaBoost model over: each learner through
        the port's carriers (tree and GLM models), the alphas as they
        are."""
        from .ensemble import carry_model

        out = ModelOutput.carried(ref.output)
        out.training_metrics = ref.output.training_metrics
        rp = ref.params
        params = AdaBoostParameters(
            response_column=rp.response_column, nlearners=rp.nlearners,
            weak_learner=rp.weak_learner, learn_rate=rp.learn_rate,
            seed=rp.seed)
        return AdaBoostModel(params, out,
                             [carry_model(m, device) for m in ref.learners],
                             [float(a) for a in ref.alphas])

    def predict(self, fr: Frame) -> Frame:
        dev = fr.device
        vote = torch.zeros((fr.nrow,), dtype=torch.float64, device=dev)
        for m, a in zip(self.learners, self.alphas):
            vote = vote + a * _signs(m, fr).to(dev)
        p1 = 1.0 / (1.0 + torch.exp(-2.0 * vote / max(sum(self.alphas), 1e-9)))
        label = (vote > 0).to(torch.float32)
        dom = self.output.response_domain

        def col(x):
            buf = torch.full((padded_len(fr.nrow),), float("nan"),
                             dtype=torch.float32, device=dev)
            buf[:fr.nrow] = x.to(torch.float32)
            return buf
        return Frame(["predict", f"p{dom[0]}", f"p{dom[1]}"],
                     [Vec(col(label), fr.nrow, type=T_CAT, domain=list(dom)),
                      Vec(col(1 - p1), fr.nrow), Vec(col(p1), fr.nrow)])

    def model_performance(self, fr: Frame | None = None):
        fr = fr or self.params.training_frame
        pf = self.predict(fr)
        y = _response_device(fr, self.params.response_column,
                             self.output.response_domain)
        raw = torch.stack([pf.vec(i).data for i in range(3)], dim=1)
        return make_metrics("Binomial", y, raw, None)


class AdaBoost(ModelBuilder):
    algo_name = "adaboost"

    def build_impl(self, job) -> AdaBoostModel:
        p: AdaBoostParameters = self.params
        fr = p.training_frame
        dev = fr.device
        y_dev, category, resp_domain = self.response_info()
        if category != "Binomial":
            raise ValueError("adaboost supports binary classification only")
        n = fr.nrow
        y = y_dev[:n]
        ok = ~torch.isnan(y)
        ysign = torch.where(y > 0, 1.0, -1.0).double()
        n_ok = float(ok.sum())

        w = ok.double()
        seed = p.seed if p.seed not in (-1, None) else 1234
        learners, alphas = [], []
        wname = "__adaboost_w__"
        for r in range(p.nlearners):
            job.check_cancelled()
            wcol = torch.full((padded_len(n),), float("nan"),
                              dtype=torch.float32, device=dev)
            wcol[:n] = (w / w.sum() * n_ok).to(torch.float32)
            wf = Frame(fr.names + [wname], fr.vecs + [Vec(wcol, n)])
            builder = _make_weak(p.weak_learner, wf, p.response_column,
                                 wname, seed + r)
            builder.params.ignored_columns = list(p.ignored_columns)
            m = builder.build_impl(Job(f"weak_{r}", work=1.0))
            miss = ((_signs(m, fr) != ysign) & ok).double()
            err = float((w * miss).sum() / max(float(w[ok].sum()), 1e-12))
            err = min(max(err, 1e-10), 1 - 1e-10)
            alpha = p.learn_rate * 0.5 * np.log((1 - err) / err)
            if err >= 0.5:
                break  # a learner no better than chance stops the boosting
            learners.append(m)
            alphas.append(float(alpha))
            w = torch.where(ok, w * torch.exp(alpha * miss), 0.0)  # SAMME
            job.update(1.0 / p.nlearners)
            if err < 1e-9:
                break

        output = ModelOutput()
        output.names = [nn for nn in fr.names if nn != p.response_column]
        output.response_domain = list(resp_domain)
        output.model_category = "Binomial"
        model = AdaBoostModel(p, output, learners, alphas)
        output.training_metrics = model.model_performance(fr)
        return model
