"""PSVM — support vector machine classification (``h2o_tpu/models/psvm.py``).

The reference's redesign of `hex/psvm/` kept: a Gaussian kernel through a
Nyström feature map — m landmark rows drawn by numpy's ``default_rng(seed)``
(m = min(rank_ratio · n, 500), at least 32), Φ = K(X, L) K(L, L)^(−1/2) with
the whitening from a float64 ``eigh`` on the host — then Newton on the
regularized primal squared hinge, ½‖β‖² + C·Σ w·max(0, 1 − y·f)², with the
bias as an appended column of ones. ``kernel_type="linear"`` fits on the
expanded design itself.

Each Newton iteration is one pass over the rows through the weighted Gram
kernel: ``gram_accumulate(Φb, W = 2·active, z = −y·m)`` returns the Hessian
ΦᵀWΦ and the gradient −2Φᵀ(active·y·m) together (``_sq_hinge_grad_hess``;
on a CUDA tensor the Hopper kernel ``csrc/gram.cu``, on a CPU tensor its
plain version). The kernel weights rows and masks none, so the padded and
zero-weight rows of Φb must be finite: ``DataInfo.expand`` imputes them,
and the feature map of a finite row is finite. The Newton solve runs on
the host in float64, as the reference's does. The feature map and the
margins are plain float32 products (TF32 off).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..backend.kernels.gram import gram_accumulate
from ..frame.frame import Frame
from ..parallel.mesh import resolve_device
from .datainfo import DataInfo
from .metrics import make_metrics
from .model_base import Model, ModelBuilder, ModelOutput, Parameters


@dataclass
class SVMParameters(Parameters):
    """Mirrors `hex/schemas/PSVMV3` (hyper_param C, gamma, kernel_type,
    rank_ratio, positive_weight/negative_weight, sv_threshold)."""

    hyper_param: float = 1.0        # C
    kernel_type: str = "gaussian"   # gaussian | linear
    gamma: float = -1.0             # -1 = 1/#features
    rank_ratio: float = -1.0        # landmark fraction; -1 = auto
    positive_weight: float = 1.0
    negative_weight: float = 1.0
    sv_threshold: float = 1e-4
    max_iterations: int = 30


def _sq_hinge_grad_hess(Phib, y, w, beta):
    """Squared-hinge primal: L = Σ w·max(0, 1 − y·f)² with f = Φβ. Returns
    (grad (P,), Hessian (P, P), loss): one Gram launch for the first two,
    a plain reduction for the loss."""
    f = Phib @ beta
    m = 1.0 - y * f
    active = (m > 0).to(torch.float32) * w
    H, g = gram_accumulate(Phib, 2.0 * active, -(y * m))
    loss = torch.sum(w * torch.clamp_min(m, 0.0) ** 2)
    return g, H, loss


class SVMModel(Model):
    algo_name = "psvm"

    def __init__(self, params, output, dinfo, landmarks, whiten, gamma, beta,
                 bias, sv_count, key=None):
        self.dinfo = dinfo
        self.landmarks = landmarks    # (m, P) tensor, or None for linear
        self.whiten = whiten          # (m, m) K_mm^(-1/2), or None
        self.gamma = gamma
        self.beta = beta              # (P_phi,) tensor
        self.bias = bias
        self.sv_count = sv_count
        self.iterations = 0           # Newton iterations (Gram launches)
        super().__init__(params, output, key=key)

    @staticmethod
    def from_reference(ref, device=None) -> "SVMModel":
        """Carry a JAX-trained PSVM over: landmarks, whitening and weights as
        float32 tensors, gamma, bias and the support-vector count, the
        ``DataInfo`` and the output's names and domains."""
        dev = resolve_device(device)

        def t(a):
            return (None if a is None else
                    torch.from_numpy(np.array(a, np.float32)).to(dev))
        out = ModelOutput.carried(ref.output)
        out.training_metrics = ref.output.training_metrics
        rp = ref.params
        params = SVMParameters(
            response_column=rp.response_column, hyper_param=rp.hyper_param,
            kernel_type=rp.kernel_type, gamma=rp.gamma,
            rank_ratio=rp.rank_ratio, positive_weight=rp.positive_weight,
            negative_weight=rp.negative_weight,
            sv_threshold=rp.sv_threshold, max_iterations=rp.max_iterations)
        return SVMModel(params, out, DataInfo.carried(ref.dinfo),
                        t(ref.landmarks), t(ref.whiten), float(ref.gamma),
                        t(ref.beta), float(ref.bias), int(ref.sv_count))

    def _features(self, X):
        if self.landmarks is None:
            return X
        L = self.landmarks.to(X.device)
        d2 = ((X * X).sum(dim=1, keepdim=True) - 2.0 * (X @ L.T)
              + (L * L).sum(dim=1)[None, :])
        K = torch.exp(-self.gamma * torch.clamp_min(d2, 0.0))
        return K @ self.whiten.to(X.device)

    def adapt_frame(self, fr: Frame):
        X, _ = self.dinfo.expand(self.pre_adapt(fr))
        return X

    def decision_function(self, X):
        return self._features(X) @ self.beta.to(X.device) + self.bias

    def score0(self, X):
        f = self.decision_function(X)
        label = (f > 0).to(torch.float32)
        # probability surrogate via the margin, as the reference's
        p1 = 1.0 / (1.0 + torch.exp(-2.0 * f))
        return torch.stack([label, 1 - p1, p1], dim=1)


class PSVM(ModelBuilder):
    algo_name = "psvm"

    def build_impl(self, job) -> SVMModel:
        p: SVMParameters = self.params
        fr = p.training_frame
        names = self.feature_names()
        y_dev, category, resp_domain = self.response_info()
        if category != "Binomial":
            raise ValueError("psvm requires a binary response "
                             "(`hex/psvm/PSVM.java` binomial-only)")
        dev = fr.device

        dinfo = DataInfo.make(fr, names, standardize=True)
        X, okrow = dinfo.expand(fr)
        y01 = torch.nan_to_num(y_dev)
        ypm = 2.0 * y01 - 1.0                      # ±1 labels
        w = (~torch.isnan(y_dev)).to(torch.float32) * okrow.to(torch.float32)
        w = w * (torch.arange(X.shape[0], device=dev) < fr.nrow)
        w = w * torch.where(ypm > 0, np.float32(p.positive_weight).item(),
                            np.float32(p.negative_weight).item())
        if p.weights_column:
            w = w * torch.nan_to_num(fr.vec(p.weights_column).data)

        gamma = p.gamma if p.gamma > 0 else 1.0 / max(X.shape[1], 1)
        landmarks = whiten = None
        if p.kernel_type.lower() == "gaussian":
            n = fr.nrow
            m = int(min(500, max(32, (p.rank_ratio if p.rank_ratio > 0
                                      else 0.1) * n)))
            m = min(m, n)
            rng = np.random.default_rng(p.seed if p.seed not in (-1, None)
                                        else 1234)
            idx = np.sort(rng.choice(n, size=m, replace=False))
            landmarks = X[torch.from_numpy(idx).to(dev)]
            L = landmarks.cpu().numpy()
            d2 = (np.sum(L * L, axis=1, keepdims=True) - 2.0 * L @ L.T
                  + np.sum(L * L, axis=1)[None, :])
            Kmm = np.exp(-gamma * np.maximum(d2, 0.0))
            evals, evecs = np.linalg.eigh(Kmm + 1e-6 * np.eye(m))
            wh = (evecs / np.sqrt(np.maximum(evals, 1e-10))) @ evecs.T
            whiten = torch.from_numpy(wh.astype(np.float32)).to(dev)

        output = ModelOutput()
        output.names = names
        output.domains = {n: fr.vec(n).domain for n in names}
        output.response_domain = list(resp_domain)
        output.model_category = "Binomial"
        model = SVMModel(p, output, dinfo, landmarks, whiten, gamma, None,
                         0.0, 0)
        Phi = model._features(X)
        del X

        # Newton on ½‖β‖² + C·Σ w·max(0, 1 − y f)², f = Φβ + b (the bias
        # through an appended column of ones, unpenalized)
        Pphi = Phi.shape[1]
        Phib = torch.cat([Phi, torch.ones((Phi.shape[0], 1),
                                          dtype=torch.float32, device=dev)],
                         dim=1)
        del Phi
        C = p.hyper_param
        beta = torch.zeros(Pphi + 1, dtype=torch.float32, device=dev)
        reg = np.eye(Pphi + 1)
        reg[-1, -1] = 0.0
        prev = np.inf
        it = 0
        for it in range(1, p.max_iterations + 1):
            job.check_cancelled()
            g, H, loss = _sq_hinge_grad_hess(Phib, ypm, w, beta)
            b64 = beta.cpu().numpy().astype(np.float64)
            obj = float(loss) * C + 0.5 * float(torch.sum(beta[:-1] ** 2))
            gn = C * g.cpu().numpy().astype(np.float64) + reg @ b64
            Hn = (C * H.cpu().numpy().astype(np.float64) + reg
                  + 1e-8 * np.eye(Pphi + 1))
            stepv = np.linalg.solve(Hn, gn)
            beta = beta - torch.from_numpy(stepv.astype(np.float32)).to(dev)
            if abs(prev - obj) < 1e-8 * max(abs(obj), 1.0):
                break
            prev = obj

        f = Phib @ beta
        margins = ypm * f
        sv_count = int(torch.sum((margins < 1.0 - p.sv_threshold) & (w > 0)))
        del Phib, f, margins
        model.beta = beta[:-1].clone()
        model.bias = float(beta[-1])
        model.sv_count = sv_count
        model.iterations = it

        raw = model.score0(dinfo.expand(fr)[0])
        ym = torch.where(w > 0, y01, torch.nan)
        output.training_metrics = make_metrics("Binomial", ym, raw, None)
        job.update(1.0)
        return model
