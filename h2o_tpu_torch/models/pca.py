"""PCA / SVD — dimensionality reduction (``h2o_tpu/models/pca.py``).

Three methods, as in the reference:

- **GramSVD** (default): the masked Gram XᵀX over the design in one pass of
  the Gram kernel (``backend/kernels/gram.gram_accumulate`` with z = None
  and the 0/1 row mask as W: the hand-written Hopper kernel on the card,
  the plain blocked version on the CPU), then ``torch.linalg.eigh`` of the
  small P×P matrix, in float64, on the tensor's device.
- **Power**: power iteration with deflation on XᵀX (a plain product).
- **Randomized**: Halko subspace iteration from a ``jax.random.normal``
  start (``utils/threefry.normal``), QR and a small ``eigh``.

Neither ``eigh`` fixes an eigenvector's sign, and the reference applies no
convention: vectors and projections match the reference's up to sign.
Products run in full float32: ``torch.backends.cuda.matmul.allow_tf32``
must be False (PyTorch's default). SVD exposes V and the singular values;
PCA reports the standard deviation, proportion and cumulative proportion
of variance and projects through ``predict``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..backend.kernels.gram import gram_accumulate
from ..frame.frame import Frame
from ..frame.vec import Vec
from ..parallel.mesh import resolve_device
from ..utils import threefry
from .datainfo import DataInfo
from .model_base import Model, ModelBuilder, ModelOutput, Parameters


@dataclass
class PCAParameters(Parameters):
    """Mirrors `hex/schemas/PCAV3`."""

    k: int = 1
    transform: str = "NONE"   # NONE | STANDARDIZE | NORMALIZE | DEMEAN | DESCALE
    pca_method: str = "GramSVD"  # GramSVD | Power | Randomized | GLRM
    max_iterations: int = 1000
    use_all_factor_levels: bool = False
    compute_metrics: bool = True


@dataclass
class SVDParameters(Parameters):
    nv: int = 1
    transform: str = "NONE"
    svd_method: str = "GramSVD"
    max_iterations: int = 1000
    use_all_factor_levels: bool = True


def _transform_info(transform: str):
    t = (transform or "NONE").upper()
    demean = t in ("STANDARDIZE", "DEMEAN")
    descale = t in ("STANDARDIZE", "NORMALIZE", "DESCALE")
    return demean, descale


def _top_k(G, k):
    """The k largest eigenpairs of a symmetric G, largest first: (singular
    values √max(λ, 0), vectors), in float32. ``eigh`` runs in float64: on
    the card, cuSOLVER's float32 ``eigh`` missed a small Gram's leading
    eigenvalues by far more than float32 rounding, where LAPACK's (the
    reference's arithmetic on the CPU) does not (``tests/test_torch_cuda.py``
    compares PCA on the card and the CPU; ``chip_smoke.py`` ``pca_mnist``
    prints the float32 error on its Gram)."""
    evals, evecs = torch.linalg.eigh(G.double())        # ascending
    evals = evals.flip(0)[:k]
    V = evecs.flip(1)[:, :k].to(torch.float32)
    return torch.sqrt(torch.clamp_min(evals, 0.0)).to(torch.float32), V


def _gram_svd(X, wmask, k):
    """XᵀX (one pass of the Gram kernel) → eigh → top-k singular pairs."""
    G, _ = gram_accumulate(X, wmask)
    d, V = _top_k(G, k)
    return d, V, wmask.sum()


def _randomized_svd(X, wmask, k, iters, key):
    """Halko randomized subspace iteration: X only through products."""
    P = X.shape[1]
    Xm = X * wmask[:, None]
    Q = threefry.normal(key, (P, min(k + 8, P)), X.device)
    for _ in range(max(2, min(iters, 8))):
        Z = Xm @ Q
        Q, _ = torch.linalg.qr(Xm.T @ Z)
    B = Xm @ Q
    d, W = _top_k(B.T @ B, k)
    return d, Q @ W, wmask.sum()


def _power_svd(X, wmask, k, iters):
    """Sequential power iteration with deflation (`hex/svd` Power)."""
    Xm = X * wmask[:, None]
    P = X.shape[1]
    V, d = [], []
    G = Xm.T @ Xm
    for _ in range(k):
        v = torch.ones(P, dtype=torch.float32, device=X.device) \
            / float(np.sqrt(P))
        for _ in range(min(iters, 100)):
            v2 = G @ v
            v = v2 / torch.clamp_min(torch.linalg.vector_norm(v2), 1e-12)
        lam = v @ (G @ v)
        V.append(v)
        d.append(torch.sqrt(torch.clamp_min(lam, 0.0)))
        G = G - lam * torch.outer(v, v)
    return torch.stack(d), torch.stack(V, dim=1), wmask.sum()


def _design(builder, fr, transform, use_all_factor_levels):
    """(names, DataInfo, X, row mask, mu): the expanded design under the
    transform, demeaned by its masked column means where asked (the
    categorical block too: the reference demeans the expanded design)."""
    names = builder.feature_names()
    demean, descale = _transform_info(transform)
    dinfo = DataInfo.make(fr, names, standardize=descale,
                          use_all_factor_levels=use_all_factor_levels)
    if not demean:
        dinfo = _no_center(dinfo, descale)
    X, ok = dinfo.expand(fr)
    wmask = ((torch.arange(X.shape[0], device=X.device) < fr.nrow)
             & ok).to(torch.float32)
    if demean:
        mu = (X * wmask[:, None]).sum(dim=0) \
            / torch.clamp_min(wmask.sum(), 1.0)
        X = X - mu
    else:
        mu = torch.zeros(X.shape[1], dtype=torch.float32, device=X.device)
    return names, dinfo, X, wmask, mu


def _decompose(method, X, wmask, k, iters, seed):
    """(d, V, n) by the named method."""
    method = (method or "GramSVD").lower()
    if method == "randomized":
        return _randomized_svd(X, wmask, k, iters, threefry.prng_key(seed))
    if method == "power":
        return _power_svd(X, wmask, k, iters)
    return _gram_svd(X, wmask, k)


def _carry_projection(cls, ref, params, device):
    """A ``PCAModel``/``SVDModel`` from a reference model's V, d, mu,
    ``DataInfo`` and output."""
    dev = resolve_device(device)
    t = {n: torch.from_numpy(np.array(getattr(ref, n), np.float32)).to(dev)
         for n in ("V", "d", "mu")}
    return cls(params, ModelOutput.carried(ref.output), t["V"], t["d"],
               DataInfo.carried(ref.dinfo), t["mu"])


class _Projection(Model):
    """Scores (X − mu) @ V, one column per vector."""

    _prefix = "PC"

    def __init__(self, params, output, V, d, dinfo, mu, key=None):
        self.V = V          # (P, k) vectors in the expanded space
        self.d = d          # (k,) singular values
        self.dinfo = dinfo
        self.mu = mu        # (P,) training mean (0 without demeaning)
        super().__init__(params, output, key=key)

    def predict(self, fr: Frame) -> Frame:
        X, _ = self.dinfo.expand(fr)
        proj = (X - self.mu.to(X.device)) @ self.V.to(X.device)
        names = [f"{self._prefix}{i + 1}" for i in range(self.V.shape[1])]
        return Frame(names, [Vec(proj[:, i].contiguous(), fr.nrow)
                             for i in range(len(names))])


class PCAModel(_Projection):
    algo_name = "pca"

    @staticmethod
    def from_reference(ref, device=None) -> "PCAModel":
        """Carry a JAX-trained PCA over: ``V``, ``d``, ``mu``, the
        ``DataInfo`` fields and the output. Given the same frame it
        projects what the reference projects."""
        m = _carry_projection(PCAModel, ref, PCAParameters(
            k=int(np.shape(ref.V)[1]), transform=ref.params.transform,
            pca_method=ref.params.pca_method), device)
        m.output.variable_importances = ref.output.variable_importances
        m.eigenvectors = m.V.cpu().numpy()
        m.eigenvector_names = list(m.dinfo.expanded_names)
        return m


class PCA(ModelBuilder):
    algo_name = "pca"
    supervised = False

    def build_impl(self, job) -> PCAModel:
        p: PCAParameters = self.params
        fr = p.training_frame
        names, dinfo, X, wmask, mu = _design(self, fr, p.transform,
                                             p.use_all_factor_levels)
        k = min(p.k, X.shape[1])
        seed = p.seed if p.seed not in (-1, None) else 1234
        d, V, n = _decompose(p.pca_method, X, wmask, k, p.max_iterations,
                             seed)

        n = float(n)
        sdev = d.cpu().numpy() / np.sqrt(max(n - 1, 1.0))
        var = sdev ** 2
        # total variance = tr(XᵀX)/(n-1), one pass (no second Gram)
        totvar = float((wmask * (X * X).sum(dim=1)).sum()) / max(n - 1, 1.0)
        prop = var / totvar if totvar > 0 else var * 0

        output = ModelOutput()
        output.names = names
        output.domains = {nn: fr.vec(nn).domain for nn in names}
        output.model_category = "DimReduction"
        output.variable_importances = {
            "pc": [f"PC{i + 1}" for i in range(k)],
            "std_deviation": sdev,
            "proportion_of_variance": prop,
            "cumulative_proportion": np.cumsum(prop),
        }
        model = PCAModel(p, output, V, d, dinfo, mu)
        model.eigenvectors = V.cpu().numpy()
        model.eigenvector_names = dinfo.expanded_names
        return model


class SVDModel(_Projection):
    algo_name = "svd"
    _prefix = "svd"

    @staticmethod
    def from_reference(ref, device=None) -> "SVDModel":
        """Carry a JAX-trained SVD over: ``V``, ``d``, ``mu``, the
        ``DataInfo`` fields and the output."""
        m = _carry_projection(SVDModel, ref, SVDParameters(
            nv=int(np.shape(ref.V)[1]), transform=ref.params.transform,
            svd_method=ref.params.svd_method), device)
        m.singular_values = m.d.cpu().numpy()
        m.v = m.V.cpu().numpy()
        return m


class SVD(ModelBuilder):
    algo_name = "svd"
    supervised = False

    def build_impl(self, job) -> SVDModel:
        p: SVDParameters = self.params
        fr = p.training_frame
        names, dinfo, X, wmask, mu = _design(self, fr, p.transform,
                                             p.use_all_factor_levels)
        k = min(p.nv, X.shape[1])
        seed = p.seed if p.seed not in (-1, None) else 1234
        d, V, _ = _decompose(p.svd_method, X, wmask, k, p.max_iterations,
                             seed)

        output = ModelOutput()
        output.names = names
        output.domains = {nn: fr.vec(nn).domain for nn in names}
        output.model_category = "DimReduction"
        model = SVDModel(p, output, V, d, dinfo, mu)
        model.singular_values = d.cpu().numpy()
        model.v = V.cpu().numpy()
        return model


def _no_center(dinfo: DataInfo, descale: bool) -> DataInfo:
    """Strip mean-centering from a DataInfo (transform NONE/DESCALE/
    NORMALIZE). NA imputation keeps using the column means either way:
    ``DataInfo.center`` only controls the (x − mean) subtraction."""
    if descale:
        dinfo.center = False  # x/sigma, mean-imputed NAs
    else:
        dinfo.standardize = False
    return dinfo
