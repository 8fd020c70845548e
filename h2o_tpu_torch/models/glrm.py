"""GLRM — generalized low-rank models (``h2o_tpu/models/glrm.py``).

A frame A (n × m, mixed types, missing entries) is factored as A ≈ X·Y,
X (n × k) and Y (k × m), by the reference's alternating proximal-gradient
loop: each iteration one gradient step on X then one on Y, each followed
by its regularizer's prox, then the backtracking rule — accept when the
objective fell (step × 1.05), else reject (step × 0.5), the step floored
at ``min_step_size``. The reference runs the loop as one ``lax.scan``; here
it is a plain loop whose accept/reject is a ``torch.where`` on the device,
so no iteration waits for the host.

Losses (`GlrmLoss.java`): Quadratic, Absolute, Huber, Poisson, Logistic,
Hinge and Periodic per numeric cell (``loss_by_col`` overrides), the
Categorical block as a one-vs-all hinge on the one-hot cells and the
Ordinal block as a hinge on the thresholds [level > j], the block's last
column masked out. Regularizers (`GlrmRegularizer.java`): None, Quadratic,
L1, NonNegative, OneSparse, UnitOneSparse and Simplex, the last three as
exact projections per X row / Y column. Missing cells add no loss.

Inits: Random (``threefry.normal``, within 3 ulps of ``jax.random.normal``),
PlusPlus (its first row from ``threefry.randint``, bit-equal) and SVD, the
float32 host LAPACK SVD of the padded design (``numpy.linalg.svd``) on
either device, so its signs and the trajectory they set do not depend on
the device. X0 is drawn over the padded row count, as the reference's.
Every product is plain float32 torch (TF32 off): the reference's are
plain XLA products, outside any Pallas kernel.

``GLRMModel._project`` (predict, transform) solves the per-row masked least
squares onto the archetypes in row blocks, in float64 where the
reference's is float32 (its k x k systems can be near-singular): the
reference's (R, k, k) stack at once would be 4.4 GB at 11M rows and
k = 10.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import Vec
from ..parallel.mesh import resolve_device
from ..utils import threefry
from .datainfo import DataInfo
from .model_base import Model, ModelBuilder, ModelOutput, Parameters


@dataclass
class GLRMParameters(Parameters):
    k: int = 1
    loss: str = "Quadratic"            # numeric: Quadratic | Absolute | Huber
                                       # | Poisson | Logistic | Hinge | Periodic
    multi_loss: str = "Categorical"    # categorical blocks: Categorical | Ordinal
    loss_by_col: dict = None           # {column name: loss kind} overrides
    period: float = 1.0                # Periodic loss period
    regularization_x: str = "None"     # None | Quadratic | L1 | NonNegative
                                       # | OneSparse | UnitOneSparse | Simplex
    regularization_y: str = "None"
    gamma_x: float = 0.0
    gamma_y: float = 0.0
    max_iterations: int = 100
    init_step_size: float = 1.0
    min_step_size: float = 1e-4
    init: str = "PlusPlus"             # Random | SVD | PlusPlus
    transform: str = "NONE"
    recover_svd: bool = False


def _pm(t):
    """{0, 1} targets -> ±1."""
    return 2.0 * t - 1.0


def _cell_losses(period: float) -> dict:
    """Per-cell (value, gradient) functions of (u, t), t the transformed
    target (`GlrmLoss.java` loss/lgrad)."""
    f = 2.0 * np.pi / max(period, 1e-10)
    return {
        "quadratic": ((lambda u, t: 0.5 * (u - t) ** 2),
                      (lambda u, t: u - t)),
        "absolute": ((lambda u, t: torch.abs(u - t)),
                     (lambda u, t: torch.sign(u - t))),
        "huber": ((lambda u, t: torch.where(torch.abs(u - t) <= 1,
                                            0.5 * (u - t) ** 2,
                                            torch.abs(u - t) - 0.5)),
                  (lambda u, t: torch.clamp(u - t, -1.0, 1.0))),
        "poisson": ((lambda u, t: torch.exp(torch.clamp(u, -30, 30)) - t * u
                     + torch.where(t > 0, t * torch.log(
                         torch.clamp_min(t, 1e-30)), 0.0) - t),
                    (lambda u, t: torch.exp(torch.clamp(u, -30, 30)) - t)),
        "logistic": ((lambda u, t: torch.logaddexp(torch.zeros_like(u),
                                                   -_pm(t) * u)),
                     (lambda u, t: -_pm(t) * torch.sigmoid(-_pm(t) * u))),
        "hinge": ((lambda u, t: torch.clamp_min(1.0 - _pm(t) * u, 0.0)),
                  (lambda u, t: torch.where(_pm(t) * u < 1.0, -_pm(t),
                                            torch.zeros_like(u)))),
        "periodic": ((lambda u, t: 1.0 - torch.cos((t - u) * f)),
                     (lambda u, t: -f * torch.sin((t - u) * f))),
    }


_NUMERIC_LOSSES = ("quadratic", "absolute", "huber", "poisson", "logistic",
                   "hinge", "periodic")


def _simplex_project(V, axis: int):
    """Euclidean projection of each slice along ``axis`` onto the
    probability simplex (sort-based, Duchi et al.)."""
    U = torch.sort(V, dim=axis, descending=True).values
    k = V.shape[axis]
    ar = torch.arange(1, k + 1, dtype=V.dtype, device=V.device)
    ar = ar[:, None] if axis == 0 else ar[None, :]
    css = (torch.cumsum(U, dim=axis) - 1.0) / ar
    ok = (U - css) > 0
    rho = ok.to(torch.int64).sum(dim=axis, keepdim=True)
    tau = torch.gather(css, axis, torch.clamp_min(rho - 1, 0))
    return torch.clamp_min(V - tau, 0.0)


def _argmax_keep(V, axis: int, unit: bool):
    """OneSparse / UnitOneSparse projection: keep only each slice's largest
    component (set to 1 in the unit form, clipped at 0 in the plain one)."""
    idx = torch.argmax(V, dim=axis, keepdim=True)
    onehot = torch.zeros_like(V).scatter_(axis, idx, 1.0)
    if unit:
        return onehot
    return onehot * torch.clamp_min(V, 0.0)


def _prox(kind: str, gamma: float, axis: int):
    k = kind.lower()
    if k == "quadratic":
        return lambda M, step: M / (1.0 + 2.0 * gamma * step)
    if k == "l1":
        return lambda M, step: torch.sign(M) * torch.clamp_min(
            torch.abs(M) - gamma * step, 0.0)
    if k == "nonnegative":
        return lambda M, step: torch.clamp_min(M, 0.0)
    if k == "onesparse":
        return lambda M, step: _argmax_keep(M, axis, unit=False)
    if k == "unitonesparse":
        return lambda M, step: _argmax_keep(M, axis, unit=True)
    if k == "simplex":
        return lambda M, step: _simplex_project(M, axis)
    if k == "none":
        return lambda M, step: M
    raise ValueError(f"unknown GLRM regularizer '{kind}'")


def _reg_value(kind: str, gamma: float, M):
    k = kind.lower()
    if k == "quadratic":
        return gamma * torch.sum(M * M)
    if k == "l1":
        return gamma * torch.sum(torch.abs(M))
    return 0.0   # indicators are 0 on their feasible set (prox keeps us there)


def _missing_mask(dinfo: DataInfo, fr: Frame, plen: int):
    """(plen, m_expanded) observed-cell mask; padding rows are all
    unobserved."""
    cols = []
    for n in dinfo.names:
        ok = ~torch.isnan(fr.vec(n).data)
        reps = len(dinfo.domains[n]) if n in dinfo.domains else 1
        cols.append(ok[:, None].expand(-1, reps))
    M = torch.cat(cols, dim=1).to(torch.float32)
    dev = M.device
    inrange = (torch.arange(plen, device=dev) < fr.nrow).to(torch.float32)
    return M * inrange[:, None]


def _loss_plan(p: GLRMParameters, dinfo: DataInfo, A, M):
    """The per-expanded-column loss layout: (T, lossM, col_ids, kinds) — the
    per-cell targets (numeric value, one-hot cell or ordinal threshold
    indicator), the loss mask (the missing mask with each Ordinal block's
    last column removed), each column's index into ``kinds``, and the
    distinct loss kinds used."""
    by_col = {k.lower(): v.lower() for k, v in (p.loss_by_col or {}).items()}
    unknown = set(by_col) - {n.lower() for n in dinfo.names}
    if unknown:
        raise ValueError(f"loss_by_col names not in the frame: {sorted(unknown)}")
    base = p.loss.lower()
    multi = p.multi_loss.lower()
    if base not in _NUMERIC_LOSSES:
        raise ValueError(f"unknown GLRM loss '{p.loss}'")
    if multi not in ("categorical", "ordinal"):
        raise ValueError(f"unknown GLRM multi_loss '{p.multi_loss}'")

    kinds: list[str] = []

    def kid(kind):
        if kind not in _NUMERIC_LOSSES:
            raise ValueError(f"unknown GLRM loss '{kind}'")
        if kind not in kinds:
            kinds.append(kind)
        return kinds.index(kind)

    col_ids = np.zeros(A.shape[1], np.int32)
    T = A
    lossM = M
    j = 0
    for name in dinfo.names:
        if name in dinfo.domains:          # categorical block (one-hot cols)
            d = len(dinfo.domains[name])
            kind = by_col.get(name.lower(), multi)
            if kind == "ordinal":
                # t_j = [level > j]; the last threshold carries nothing
                if T is A:
                    T, lossM = A.clone(), M.clone()
                T[:, j:j + d] = 1.0 - torch.cumsum(A[:, j:j + d], dim=1)
                lossM[:, j + d - 1] = 0.0
                col_ids[j:j + d] = kid("hinge")
            elif kind == "categorical":
                col_ids[j:j + d] = kid("hinge")   # one-vs-all hinge
            else:                                 # numeric loss on the one-hot
                col_ids[j:j + d] = kid(kind)
            j += d
        else:
            col_ids[j] = kid(by_col.get(name.lower(), base))
            j += 1
    return T, lossM, col_ids, kinds


class GLRMMetrics:
    """The training objective (`ModelMetricsGLRM`'s numerr role)."""

    def __init__(self, objective: float):
        self.objective = float(objective)

    def __repr__(self):
        return f"GLRMMetrics(objective={self.objective:.5f})"


class GLRMModel(Model):
    algo_name = "glrm"

    #: design cells (rows x k x max(k, m)) per block of ``_project``
    _PROJECT_CELLS = 1 << 25

    def __init__(self, params, output, Y, X, dinfo, key=None):
        self.Y = Y          # (k, m) archetypes in expanded space
        self.X = X          # (n_padded, k) training representation
        self.dinfo = dinfo
        super().__init__(params, output, key=key)

    @staticmethod
    def from_reference(ref, device=None) -> "GLRMModel":
        """Carry a JAX-trained GLRM over: Y and X as float32 tensors, the
        ``DataInfo``, the objective history and the parameters."""
        dev = resolve_device(device)
        out = ModelOutput.carried(ref.output)
        out.scoring_history = [dict(h) for h in ref.output.scoring_history]
        out.training_metrics = GLRMMetrics(
            ref.output.training_metrics.objective)
        rp = ref.params
        params = GLRMParameters(**{
            f.name: getattr(rp, f.name) for f in dataclasses.fields(
                GLRMParameters) if f.name not in (
                "training_frame", "validation_frame", "checkpoint",
                "custom_metric_func")})
        t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev)
        return GLRMModel(params, out, t(ref.Y), t(ref.X),
                         DataInfo.carried(ref.dinfo))

    def archetypes(self):
        return self.Y.cpu().numpy()

    def _project(self, fr: Frame):
        """Per-row masked least squares onto the archetypes, min_x
        ‖M⊙(xY − a)‖² (missing cells must not bias the representation),
        as batched k × k solves over blocks of rows, in float64: archetypes
        of one-hot blocks under a NonNegative X are near-collinear (a
        float32 solve put the 1M-row airlines reconstruction 0.16 from the
        float64 MOJO scorer's). Returns X in float64."""
        A, _ = self.dinfo.expand(fr)
        M = _missing_mask(self.dinfo, fr, A.shape[0])
        Y = self.Y.to(A.device, torch.float64)
        k, m = Y.shape
        eye = 1e-6 * torch.eye(k, dtype=torch.float64, device=A.device)
        rb = max(1, self._PROJECT_CELLS // (k * max(k, m)))
        out = torch.empty((A.shape[0], k), dtype=torch.float64,
                          device=A.device)
        for s in range(0, A.shape[0], rb):
            Mb = M[s:s + rb].double()
            Ab = torch.where(Mb > 0, A[s:s + rb].double(), 0.0)
            G = (Mb[:, None, :] * Y[None, :, :]) @ Y.T + eye
            b = Ab @ Y.T
            out[s:s + rb] = torch.linalg.solve(G, b[..., None])[..., 0]
        return out

    def predict(self, fr: Frame) -> Frame:
        R = (self._project(fr) @ self.Y.to(fr.device, torch.float64)).to(
            torch.float32)
        names = [f"reconstr_{n}" for n in self.dinfo.expanded_names]
        return Frame(names, [Vec(R[:, i].contiguous(), fr.nrow)
                             for i in range(R.shape[1])])

    def transform_frame(self, fr: Frame) -> Frame:
        X = self._project(fr).to(torch.float32)
        return Frame([f"Arch{i+1}" for i in range(X.shape[1])],
                     [Vec(X[:, i].contiguous(), fr.nrow)
                      for i in range(X.shape[1])])


class GLRM(ModelBuilder):
    algo_name = "glrm"
    supervised = False

    def build_impl(self, job) -> GLRMModel:
        p: GLRMParameters = self.params
        fr = p.training_frame
        dev = fr.device
        names = self.feature_names()
        demean = p.transform.upper() in ("DEMEAN", "STANDARDIZE")
        descale = p.transform.upper() in ("STANDARDIZE", "NORMALIZE", "DESCALE")
        dinfo = DataInfo.make(fr, names, standardize=descale,
                              use_all_factor_levels=True)
        dinfo.center = demean
        A, _ = dinfo.expand(fr)
        # the ORIGINAL missing mask: imputation must not leak into the loss
        M = _missing_mask(dinfo, fr, A.shape[0])
        A = torch.where(M > 0, A, 0.0)
        inrange = (torch.arange(A.shape[0], device=dev)
                   < fr.nrow).to(torch.float32)

        n, m = A.shape
        k = min(p.k, m)
        seed = p.seed if p.seed not in (-1, None) else 1234
        key = threefry.prng_key(seed)

        # ---- init (`hex/glrm/GLRM.java` initialYMatrix) ----------------------
        init = p.init.lower()
        if init == "svd":
            _, _, Vt = np.linalg.svd(A.cpu().numpy(), full_matrices=False)
            Y0 = torch.from_numpy(np.ascontiguousarray(Vt[:k])).to(dev)
        elif init == "plusplus":
            idx = [int(threefry.randint(key, (), 0, fr.nrow))]
            d2 = torch.sum((A - A[idx[0]]) ** 2, dim=1) * inrange
            for _ in range(1, k):
                i = int(torch.argmax(d2))
                idx.append(i)
                d2 = torch.minimum(d2, torch.sum((A - A[i]) ** 2, dim=1)
                                   * inrange)
            Y0 = A[torch.tensor(idx, device=dev)]
        else:
            Y0 = threefry.normal(key, (k, m), dev) * 0.1
        X0 = threefry.normal(threefry.fold_in(key, 1), (n, k), dev) * 0.1
        if p.regularization_x.lower() in ("onesparse", "unitonesparse",
                                          "simplex"):
            X0 = _prox(p.regularization_x, p.gamma_x, axis=1)(
                torch.abs(X0), 0.0)

        T, lossM, col_ids, kinds = _loss_plan(p, dinfo, A, M)
        cell = _cell_losses(p.period)
        kind_masks = [torch.from_numpy((col_ids == i).astype(np.float32))
                      .to(dev) for i in range(len(kinds))]

        def loss_value(U):
            out = 0.0
            for i, kd in enumerate(kinds):
                out = out + torch.sum(lossM * kind_masks[i][None, :]
                                      * cell[kd][0](U, T))
            return out

        def loss_grad(U):
            out = torch.zeros_like(U)
            for i, kd in enumerate(kinds):
                out = out + lossM * kind_masks[i][None, :] * cell[kd][1](U, T)
            return out

        prox_x = _prox(p.regularization_x, p.gamma_x, axis=1)
        prox_y = _prox(p.regularization_y, p.gamma_y, axis=0)

        def objective(X, Y):
            return (loss_value(X @ Y)
                    + _reg_value(p.regularization_x, p.gamma_x, X)
                    + _reg_value(p.regularization_y, p.gamma_y, Y))

        # the initial step scaled by the problem size (observed cells,
        # counted exactly)
        nobs = float(torch.sum(M, dtype=torch.float64))
        alpha0 = p.init_step_size / max(nobs, 1.0) * n
        X, Y = X0, Y0
        alpha = torch.tensor(alpha0, dtype=torch.float32, device=dev)
        obj = objective(X, Y)
        hist = []
        for _ in range(p.max_iterations):
            job.check_cancelled()
            G = loss_grad(X @ Y)
            Xn = prox_x(X - alpha * (G @ Y.T), alpha)
            Gy = loss_grad(Xn @ Y)
            Yn = prox_y(Y - alpha * (Xn.T @ Gy), alpha)
            newobj = objective(Xn, Yn)
            ok = newobj < obj
            # backtracking: accept and grow the step, or reject and shrink
            X = torch.where(ok, Xn, X)
            Y = torch.where(ok, Yn, Y)
            alpha = torch.clamp_min(torch.where(ok, alpha * 1.05,
                                                alpha * 0.5),
                                    p.min_step_size)
            obj = torch.where(ok, newobj, obj)
            hist.append(obj)
        hist = (torch.stack(hist).cpu().numpy() if hist
                else np.zeros(0, np.float32))

        output = ModelOutput()
        output.names = names
        output.domains = {nn: fr.vec(nn).domain for nn in names}
        output.model_category = "DimReduction"
        output.scoring_history = [{"iteration": i, "objective": float(o)}
                                  for i, o in enumerate(hist)]
        output.training_metrics = GLRMMetrics(float(obj))
        job.update(1.0)
        return GLRMModel(p, output, Y, X, dinfo)
