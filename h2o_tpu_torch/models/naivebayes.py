"""Naive Bayes (``h2o_tpu/models/naivebayes.py``,
`hex/naivebayes/NaiveBayes.java`).

Class priors; per categorical feature P(x = l | y = c) with Laplace
smoothing; per numeric feature a Gaussian (mean, sdev) per class. The
tables come from one pass over the frame: the numeric features' per-class
sums of x and x² as two float64 products of the (R, K) weighted class
indicator with the (R, Fn) matrix, the categorical counts as one float64
``index_add_`` over every categorical column's (class, level) cells; each
sum is rounded once to float32, then the reference's float32 formulas
finish the tables. Prediction is a log-space sum per class, float64 on
the device (NA features skip their term), then the softmax; probabilities
below ``min_prob`` and sdevs below ``min_sdev`` take ``eps_prob`` /
``eps_sdev`` when set, else the floor itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from .metrics import make_metrics
from .model_base import Model, ModelBuilder, ModelOutput, Parameters


@dataclass
class NaiveBayesParameters(Parameters):
    """Mirrors `hex/schemas/NaiveBayesV3`."""

    laplace: float = 0.0
    min_sdev: float = 0.001
    eps_sdev: float = 0.0
    min_prob: float = 0.001
    eps_prob: float = 0.0
    compute_metrics: bool = True


class NaiveBayesModel(Model):
    algo_name = "naivebayes"

    def __init__(self, params, output, priors, tables, gauss, feat_meta,
                 key=None):
        self.priors = priors        # (K,) class priors
        self.tables = tables        # name -> (K, card) conditional probs
        self.gauss = gauss          # name -> (K, 2) [mean, sdev]
        self.feat_meta = feat_meta  # ordered [(name, "cat" | "num")]
        super().__init__(params, output, key=key)

    @staticmethod
    def from_reference(ref, device=None) -> "NaiveBayesModel":
        """Carry a JAX-trained Naive Bayes model over: priors, tables and
        Gaussians as float32 tensors, the feature order and thresholds."""
        dev = resolve_device(device)

        def t(a):
            return torch.from_numpy(np.array(a, np.float32)).to(dev)
        out = ModelOutput.carried(ref.output)
        out.training_metrics = ref.output.training_metrics
        rp = ref.params
        params = NaiveBayesParameters(
            response_column=rp.response_column, laplace=rp.laplace,
            min_sdev=rp.min_sdev, eps_sdev=rp.eps_sdev,
            min_prob=rp.min_prob, eps_prob=rp.eps_prob)
        return NaiveBayesModel(params, out, t(ref.priors),
                               {k: t(v) for k, v in ref.tables.items()},
                               {k: t(v) for k, v in ref.gauss.items()},
                               [tuple(m) for m in ref.feat_meta])

    def score0(self, X: torch.Tensor) -> torch.Tensor:
        p = self.params
        K = self.priors.shape[0]
        dev = X.device
        logp = torch.log(torch.clamp(self.priors.to(dev).double(),
                                     min=1e-30))[None, :].expand(X.shape[0], K)
        for j, (name, kind) in enumerate(self.feat_meta):
            x = X[:, j]
            ok = ~torch.isnan(x)
            if kind == "cat":
                tab = self.tables[name].to(dev)
                card = tab.shape[1]
                codes = torch.clamp(torch.where(ok, x, 0.0).to(torch.int64),
                                    0, card - 1)
                floor = p.eps_prob if p.eps_prob > 0 else p.min_prob
                probs_tab = torch.where(tab < np.float32(p.min_prob),
                                        np.float32(floor), tab)
                contrib = torch.log(probs_tab[:, codes].T.double())
            else:
                g = self.gauss[name].to(dev)
                mu, sd = g[:, 0], g[:, 1]
                floor = p.eps_sdev if p.eps_sdev > 0 else p.min_sdev
                sd = torch.where(sd < np.float32(p.min_sdev),
                                 np.float32(floor), sd).double()
                z = ((torch.where(ok, x, 0.0).double()[:, None]
                      - mu.double()[None, :]) / sd[None, :])
                contrib = -0.5 * z * z - torch.log(sd)[None, :]
            logp = logp + torch.where(ok[:, None], contrib, 0.0)
        probs = torch.softmax(logp, dim=1).to(torch.float32)
        label = torch.argmax(probs, dim=1).to(torch.float32)
        return torch.cat([label[:, None], probs], dim=1)


class NaiveBayes(ModelBuilder):
    algo_name = "naivebayes"

    def build_impl(self, job) -> NaiveBayesModel:
        p: NaiveBayesParameters = self.params
        fr = p.training_frame
        names = self.feature_names()
        y_dev, category, resp_domain = self.response_info()
        if category == "Regression":
            raise ValueError("naivebayes: response must be categorical")
        K = len(resp_domain)
        dev = fr.device

        rowok = ~torch.isnan(y_dev)
        w = rowok.double()
        if p.weights_column:
            w = w * torch.nan_to_num(fr.vec(p.weights_column).data).double()
        yc = torch.where(rowok, y_dev, 0.0).to(torch.int64)
        class_counts = torch.zeros(K, dtype=torch.float64, device=dev
                                   ).index_add_(0, yc, w).to(torch.float32)
        priors = class_counts / torch.clamp(class_counts.sum(), min=1e-10)

        cats = [n for n in names if fr.vec(n).is_categorical()]
        nums = [n for n in names if not fr.vec(n).is_categorical()]
        tables, gauss = {}, {}
        if cats:
            cards = [len(fr.vec(n).domain) for n in cats]
            offs = np.concatenate([[0], np.cumsum(cards)[:-1]]) * K
            keys, vals = [], []
            for n, card, off in zip(cats, cards, offs):
                x = fr.vec(n).data
                ok = ~torch.isnan(x)
                code = torch.clamp(torch.where(ok, x, 0.0).to(torch.int64), 0,
                                   card - 1)
                keys.append(int(off) + yc * card + code)
                vals.append(torch.where(ok, w, 0.0))
            counts = torch.zeros(int(sum(cards)) * K, dtype=torch.float64,
                                 device=dev).index_add_(
                0, torch.cat(keys), torch.cat(vals)).to(torch.float32)
            for n, card, off in zip(cats, cards, offs):
                c = counts[int(off):int(off) + K * card].view(K, card)
                tables[n] = (c + p.laplace) / torch.clamp(
                    c.sum(dim=1, keepdim=True) + p.laplace * card, min=1e-10)
        if nums:
            Xn = torch.stack([fr.vec(n).data for n in nums], dim=1)
            ok = ~torch.isnan(Xn)
            xs = torch.where(ok, Xn, 0.0).double()
            y1h = (torch.nn.functional.one_hot(yc, K).double()
                   * w[:, None])                               # (R, K)
            okd = ok.double()
            nk = torch.clamp((y1h.T @ okd).to(torch.float32), min=1e-10)
            s1 = (y1h.T @ xs).to(torch.float32)                 # (K, Fn)
            s2 = (y1h.T @ (xs * xs)).to(torch.float32)
            mu = s1 / nk
            ex2 = s2 / nk
            var = (torch.clamp(ex2 - mu * mu, min=0.0) * nk
                   / torch.clamp(nk - 1, min=1.0))
            sd = torch.sqrt(var)
            for j, n in enumerate(nums):
                gauss[n] = torch.stack([mu[:, j], sd[:, j]], dim=1)
        feat_meta = [(n, "cat" if n in tables else "num") for n in names]

        output = ModelOutput()
        output.names = names
        output.domains = {n: fr.vec(n).domain for n in names}
        output.response_domain = list(resp_domain)
        output.model_category = category
        model = NaiveBayesModel(p, output, priors, tables, gauss, feat_meta)
        if p.compute_metrics:
            raw = model.score0(fr.as_matrix(names))
            output.training_metrics = make_metrics(
                category, torch.where(rowok, y_dev, torch.nan), raw,
                None if p.weights_column is None else w.to(torch.float32),
                auc_type=p.auc_type, domain=output.response_domain)
            if p.validation_frame is not None:
                output.validation_metrics = model.model_performance(
                    p.validation_frame)
        return model
