"""GAM — generalized additive models (``h2o_tpu/models/gam.py``).

Each ``gam_column`` expands into a spline basis beside the linear design,
and one penalized GLM is fitted over the lot (`hex/gam/GAMModel.java`).
The reference's four ``bs`` families, by their codes:

- ``bs=0`` cubic regression splines (mgcv 'cr', the default): values at
  the knots, the exact integrated-squared-second-derivative penalty;
- ``bs=1`` thin plate (1-D): |x−k|³ radial bumps projected on the side
  constraint, plus the linear null space;
- ``bs=2`` monotone I-splines: non-negative coefficients, enforced per
  coordinate in the COD solver, give a non-decreasing smooth;
- ``bs=3`` M/P-splines: B-splines with the 2nd-order difference penalty.

Knots come from the binning's quantile sketch (``hist_quantile_sketch``
of the column: only the quantiles cross to the host); ``cr_matrices`` and
``tp_constraint`` (``mojo/format.py``, plain numpy) build the penalties on
the host; the bases are evaluated on the frame's device by torch twins of
the numpy bases. Every IRLS iteration is one call of the Gram kernel
through ``glm._make_irls_kernel`` (the hand-written Hopper kernel on the
card, the plain version on the CPU); the block-diagonal penalty is added
to the Gram on the host before the solve, which is ADMM, or cyclic COD
with lower bounds when a monotone I-spline block is present.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np
import torch

from ..frame.frame import Frame
from ..mojo.format import cr_matrices, tp_constraint
from ..parallel.mesh import resolve_device
from .datainfo import DataInfo
from .glm import (GLM, GLMParameters, _admm_solve, _apply_interactions,
                  _carried_family, _cod_solve, _freeze_interaction_pairs,
                  _make_irls_kernel, _on_dev)
from .metrics import make_metrics
from .model_base import Model, ModelBuilder, ModelOutput
from .tree.binning import hist_quantile_sketch


def diff_penalty(n_basis: int, order: int = 2) -> np.ndarray:
    """P-spline penalty DᵀD (2nd-order differences of adjacent coefficients)."""
    D = np.diff(np.eye(n_basis), n=order, axis=0)
    return D.T @ D


# ---------------------------------------------------------------------------
# device bases: the reference's `_gam_basis_dev` in torch, on x's device.
# Scalars enter as the float32 values the reference's arrays hold; a row of
# F is a gather where the reference multiplies by a one-hot row (the same
# float32 values: each one-hot row has a single 1).
# ---------------------------------------------------------------------------
def _f32(v) -> float:
    return float(np.float32(v))


def _cr_basis_dev(x, knots, F):
    """Natural cubic regression spline, values-at-knots parameterization."""
    k32 = np.asarray(knots, np.float32)
    K = k32.shape[0]
    kn = torch.from_numpy(k32).to(x.device)
    x = torch.clamp(torch.nan_to_num(x, nan=float(k32[K // 2])),
                    float(k32[0]), float(k32[-1]))
    j = torch.clamp(torch.searchsorted(kn, x, right=True) - 1, 0, K - 2)
    kj = kn[j]
    kj1 = kn[j + 1]
    h = kj1 - kj
    am = (kj1 - x) / h
    ap = (x - kj) / h
    cm = ((kj1 - x) ** 3 / h - h * (kj1 - x)) / 6.0
    cp = ((x - kj) ** 3 / h - h * (x - kj)) / 6.0
    Fj = torch.from_numpy(np.asarray(F, np.float32)).to(x.device)
    B = torch.zeros((x.shape[0], K), dtype=torch.float32, device=x.device)
    B.scatter_(1, j[:, None], am[:, None])
    B.scatter_(1, (j + 1)[:, None], ap[:, None])
    return B + cm[:, None] * Fj[j] + cp[:, None] * Fj[j + 1]


def _bspline_basis_dev(x, lo, hi, interior, degree: int = 3):
    """Cox-de-Boor B-splines; NA/out-of-range clamp to the boundary."""
    lo, hi = float(lo), float(hi)
    interior = np.asarray(interior, np.float64)
    x = torch.clamp(torch.nan_to_num(x, nan=_f32((lo + hi) / 2)), _f32(lo),
                    _f32(hi))
    t = np.concatenate([[lo] * (degree + 1), interior, [hi] * (degree + 1)])
    n_basis = len(interior) + degree + 1
    zero = torch.zeros_like(x)
    cols = []
    for i in range(len(t) - 1):
        if t[i + 1] > t[i]:
            c = ((x >= _f32(t[i]))
                 & ((x < _f32(t[i + 1])) | bool(t[i + 1] == hi)))
            cols.append(c.to(torch.float32))
        else:
            cols.append(zero)
    B = torch.stack(cols, dim=1)
    for d in range(1, degree + 1):
        nxt = []
        for i in range(len(t) - 1 - d):
            acc = zero
            if t[i + d] > t[i]:
                acc = acc + (x - _f32(t[i])) / _f32(t[i + d] - t[i]) * B[:, i]
            if t[i + d + 1] > t[i + 1]:
                acc = acc + ((_f32(t[i + d + 1]) - x)
                             / _f32(t[i + d + 1] - t[i + 1]) * B[:, i + 1])
            nxt.append(acc)
        B = torch.stack(nxt, dim=1)
    return B[:, :n_basis]


def _gam_basis_dev(x, spec):
    """Device twin of `mojo.format.gam_basis` (same spec dict)."""
    bs = int(spec.get("bs", 3))
    if bs == 0:
        return _cr_basis_dev(x, spec["knots"], spec["F"])
    if bs == 1:
        knots = torch.from_numpy(np.asarray(spec["knots"], np.float32)).to(
            x.device)
        scale = _f32(spec["tp_scale"])
        xm = torch.nan_to_num(x, nan=_f32(np.median(np.asarray(
            spec["knots"]))))
        r = torch.abs(xm[:, None] - knots[None, :]) / scale
        Z = torch.from_numpy(np.asarray(spec["Z"], np.float32)).to(x.device)
        return torch.cat([(r ** 3) @ Z, (xm / scale)[:, None]], dim=1)
    B = _bspline_basis_dev(x, spec["lo"], spec["hi"], spec["interior"],
                           spec["degree"])
    if bs == 2:
        I = torch.flip(torch.cumsum(torch.flip(B, [1]), dim=1), [1])
        return I[:, 1:]
    return B


def _device_quantiles(col, qs) -> np.ndarray:
    """A column's quantiles through the binning sketch: only the (nq,)
    values cross to the host."""
    return hist_quantile_sketch(col, tuple(float(q) for q in qs))


# ---------------------------------------------------------------------------
@dataclass
class GAMParameters(GLMParameters):
    """Mirrors `hex/schemas/GAMV3` (gam_columns, num_knots, scale, bs)."""

    gam_columns: list = field(default_factory=list)
    num_knots: list | int = 8        # knot count per gam column
    scale: list | float = 1.0        # smoothing penalty weight per gam column
    bs: list | int = 0               # 0=cr | 1=thin plate | 2=monotone
                                     # I-splines | 3=M/P-splines
    spline_degree: int = 3
    splines_non_negative: list | bool = True  # bs=2: True → non-decreasing
    keep_gam_cols: bool = False

    def knots_for(self, j: int) -> int:
        return (self.num_knots[j] if isinstance(self.num_knots, (list, tuple))
                else int(self.num_knots))

    def scale_for(self, j: int) -> float:
        return (self.scale[j] if isinstance(self.scale, (list, tuple))
                else float(self.scale))

    def bs_for(self, j: int) -> int:
        return (int(self.bs[j]) if isinstance(self.bs, (list, tuple))
                else int(self.bs))

    def nonneg_for(self, j: int) -> bool:
        v = self.splines_non_negative
        return bool(v[j]) if isinstance(v, (list, tuple)) else bool(v)


class GAMModel(Model):
    algo_name = "gam"
    interaction_spec = None  # frozen cat/num interaction pairs

    def __init__(self, params, output, dinfo, gam_specs, beta, family,
                 key=None):
        super().__init__(params, output, key=key)
        self.dinfo = dinfo          # DataInfo over non-gam features (or None)
        self.gam_specs = gam_specs  # list of dicts per gam column
        self.beta = beta            # (P_total+1,) float64, intercept last
        self.family = family

    @staticmethod
    def from_reference(ref, device=None) -> "GAMModel":
        """Carry a JAX-trained GAM over: ``beta``, the gam specs (knots,
        F, Z, column means, ...), the ``DataInfo`` fields, the family and
        the frozen interaction spec. Given the same frame it scores what
        the reference scores."""
        resolve_device(device)
        family, powers = _carried_family(ref.family)
        specs = copy.deepcopy(ref.gam_specs)   # host numpy already
        params = GAMParameters(
            family=ref.family.name, link=ref.family.link_name,
            gam_columns=[s["column"] for s in specs],
            bs=[int(s.get("bs", 3)) for s in specs],
            response_column=ref.params.response_column, **powers)
        dinfo = None if ref.dinfo is None else DataInfo.carried(ref.dinfo)
        model = GAMModel(params, ModelOutput.carried(ref.output), dinfo, specs,
                         np.asarray(ref.beta, np.float64).copy(), family)
        model.interaction_spec = copy.deepcopy(ref.interaction_spec)
        return model

    def _design(self, fr: Frame) -> torch.Tensor:
        """The linear block (``DataInfo.expand``) beside each gam column's
        centred basis, on the frame's device."""
        blocks = []
        if self.interaction_spec:
            fr, _ = _apply_interactions(fr, self.interaction_spec,
                                        skip_existing=True)
        if self.dinfo is not None and self.dinfo.names:
            Xlin, _ = self.dinfo.expand(fr)
            blocks.append(Xlin)
        for spec in self.gam_specs:
            B = _gam_basis_dev(fr.vec(spec["column"]).data, spec)
            means = torch.from_numpy(np.asarray(spec["col_means"],
                                                np.float32)).to(B.device)
            blocks.append(B - means[None, :])
        return torch.cat(blocks, dim=1)

    def adapt_frame(self, fr: Frame) -> torch.Tensor:
        return self._design(self.pre_adapt(fr))

    def score0(self, X: torch.Tensor) -> torch.Tensor:
        beta = torch.as_tensor(self.beta, dtype=torch.float32,
                               device=X.device)
        mu = self.family.linkinv(X @ beta[:-1] + beta[-1])
        if self.output.model_category == "Binomial":
            label = (mu > 0.5).to(torch.float32)
            return torch.stack([label, 1 - mu, mu], dim=1)
        return mu

    def coef(self) -> dict:
        names = []
        if self.dinfo is not None:
            names += self.dinfo.expanded_names
        for spec in self.gam_specs:
            names += [f"{spec['column']}_gam.{i}"
                      for i in range(len(spec["col_means"]))]
        names.append("Intercept")
        return dict(zip(names, np.asarray(self.beta)))


class GAM(ModelBuilder):
    algo_name = "gam"

    def _validate(self):
        super()._validate()
        p = self.params
        if not p.gam_columns:
            raise ValueError("gam: gam_columns is required")
        for c in p.gam_columns:
            if p.training_frame.find(c) < 0:
                raise ValueError(f"gam: gam column '{c}' not in frame")
            if p.training_frame.vec(c).is_categorical():
                raise ValueError(f"gam: gam column '{c}' must be numeric")

    def feature_names(self):
        names = super().feature_names()
        return [n for n in names if n not in self.params.gam_columns]

    def _spec(self, j: int, c: str, v):
        """(spec, penalty block, monotone) of gam column ``c``: knots from
        the quantile sketch, penalties on the host."""
        p = self.params
        r = v.rollups()
        xmin, xmax = float(r.mins), float(r.maxs)
        bs = p.bs_for(j)
        if bs not in (0, 1, 2, 3):
            raise ValueError(f"gam: bs={bs} unknown (0=cr, 1=thin plate, "
                             f"2=monotone I-splines, 3=M/P-splines)")
        scale = p.scale_for(j)
        if bs in (0, 1):
            K = max(p.knots_for(j), 3)
            knots = np.unique(_device_quantiles(
                v.data, np.linspace(0, 1, K)).astype(np.float64))
            if len(knots) < 3:  # degenerate quantiles: span the data
                knots = np.linspace(xmin, max(xmax, xmin + 1.0), 3)
        if bs == 0:
            F, S_blk = cr_matrices(knots)
            spec = dict(column=c, bs=0, knots=knots, F=F, scale=scale)
        elif bs == 1:
            tp_scale = max(float(knots[-1] - knots[0]), 1e-12)
            Z, S_rad = tp_constraint(knots, tp_scale)
            nb = S_rad.shape[0] + 1  # projected radial + linear
            S_blk = np.zeros((nb, nb))
            S_blk[:-1, :-1] = S_rad
            spec = dict(column=c, bs=1, knots=knots, tp_scale=tp_scale, Z=Z,
                        scale=scale)
        else:
            hi = xmax if xmax > xmin else xmin + 1.0
            qs = np.linspace(0, 1, max(p.knots_for(j), 1) + 2)[1:-1]
            interior = np.unique(_device_quantiles(v.data, qs).astype(
                np.float64))
            spec = dict(column=c, bs=bs, lo=xmin, hi=hi, interior=interior,
                        degree=p.spline_degree, scale=scale)
            nb = len(interior) + p.spline_degree + 1 - (1 if bs == 2 else 0)
            S_blk = diff_penalty(nb)
        return spec, scale * S_blk, bs == 2 and p.nonneg_for(j)

    def build_impl(self, job) -> GAMModel:
        p = self.params
        fr = p.training_frame
        y_dev, category, resp_domain = self.response_info()
        if category == "Multinomial":
            raise ValueError("gam: multinomial family not yet supported")
        family = GLM._family(self, category)

        lin_names = self.feature_names()
        inter_spec = None
        if p.interactions or p.interaction_pairs:
            reserved = {p.response_column, p.weights_column, p.offset_column}
            inter_spec = _freeze_interaction_pairs(
                fr, p.interactions, p.interaction_pairs, reserved)
            fr, extra = _apply_interactions(fr, inter_spec)
            lin_names = lin_names + extra
        dinfo = (DataInfo.make(
            fr, lin_names, standardize=p.standardize,
            missing_values_handling=p.missing_values_handling)
            if lin_names else None)

        gam_specs, pen_blocks, mono_blocks = [], [], []
        for j, c in enumerate(p.gam_columns):
            v = fr.vec(c)
            spec, S_blk, mono = self._spec(j, c, v)
            B = _gam_basis_dev(v.data, spec)
            # means over real rows only (padding rows clamp to mid-knot)
            spec["col_means"] = B[:fr.nrow].mean(dim=0).cpu().numpy().astype(
                np.float64)
            gam_specs.append(spec)
            pen_blocks.append(S_blk)
            mono_blocks.append(mono)

        output = ModelOutput()
        output.names = lin_names + list(p.gam_columns)
        output.domains = {n: fr.vec(n).domain for n in output.names}
        output.response_domain = list(resp_domain) if resp_domain else None
        output.model_category = category
        model = GAMModel(p, output, dinfo, gam_specs, None, family)
        model.interaction_spec = inter_spec

        X = model._design(fr)
        Ptot = X.shape[1]
        # block-diagonal smoothing penalty (zeros over the linear block and
        # the intercept); per-coordinate lower bounds for monotone blocks
        S = np.zeros((Ptot + 1, Ptot + 1))
        lo_bounds = np.full(Ptot + 1, -np.inf)
        off = Ptot - sum(b.shape[0] for b in pen_blocks)
        for blk, mono in zip(pen_blocks, mono_blocks):
            sz = blk.shape[0]
            S[off:off + sz, off:off + sz] = blk
            if mono:
                lo_bounds[off:off + sz] = 0.0
            off += sz
        any_mono = any(mono_blocks)

        y = torch.nan_to_num(y_dev)
        w = (~torch.isnan(y_dev)).to(torch.float32)
        w = w * (torch.arange(X.shape[0], device=w.device) < fr.nrow)
        if p.weights_column:
            w = w * torch.nan_to_num(fr.vec(p.weights_column).data)
        offset = (torch.nan_to_num(fr.vec(p.offset_column).data)
                  if p.offset_column else torch.zeros_like(y))

        # penalized IRLS (GLMDriver loop + S added to the Gram)
        step = _make_irls_kernel(family)
        Xi = torch.cat([X, torch.ones((X.shape[0], 1), dtype=torch.float32,
                                      device=X.device)], dim=1)
        del X
        free = np.zeros(Ptot + 1, dtype=bool)
        free[-1] = True
        alpha = p.alpha if p.alpha is not None else 0.0
        lam = p.lambda_ if p.lambda_ is not None else 0.0
        neff = float(torch.sum(w))
        beta = np.zeros(Ptot + 1, dtype=np.float64)
        beta[-1] = float(family.init_intercept(y, w)) if p.intercept else 0.0

        mu0 = family.linkinv(torch.full_like(y, beta[-1]) + offset)
        nulldev = float(torch.sum(family.deviance(y, mu0, w)))
        dev_prev = np.inf
        iters = 0
        for it in range(max(p.max_iterations, 1)):
            job.check_cancelled()
            G, b, dev, _ = step(Xi, y, w, _on_dev(beta, Xi.device), offset)
            iters += 1
            Gn = G.cpu().numpy().astype(np.float64) + S
            bn = b.cpu().numpy().astype(np.float64)
            if any_mono:
                # COD applies the I-spline non-negativity per coordinate
                # inside the sweep (ADMM has no bound projection)
                beta_new = _cod_solve(Gn, bn, alpha * lam * neff,
                                      (1 - alpha) * lam * neff, free, beta,
                                      p.beta_epsilon, lo=lo_bounds)
            else:
                beta_new = _admm_solve(Gn, bn, alpha * lam * neff,
                                       (1 - alpha) * lam * neff, free)
            diff = np.max(np.abs(beta_new - beta)) if it else np.inf
            beta = beta_new
            if diff < p.beta_epsilon:
                break
            if abs(dev_prev - float(dev)) < p.objective_epsilon * abs(nulldev):
                break
            dev_prev = float(dev)

        model.beta = beta
        raw = model.score0(Xi[:, :-1])
        ym = torch.where(w > 0, y, torch.nan)
        m = make_metrics(category, ym, raw, w if p.weights_column else None,
                         auc_type=p.auc_type, domain=output.response_domain)
        mu = family.linkinv(Xi @ _on_dev(beta, Xi.device) + offset)
        m.residual_deviance = float(torch.sum(family.deviance(y, mu, w)))
        m.null_deviance = nulldev
        output.training_metrics = m
        output.scoring_history = [{"iterations": iters,
                                   "deviance": m.residual_deviance}]
        if p.validation_frame is not None:
            output.validation_metrics = model.model_performance(
                p.validation_frame)
        job.update(1.0)
        return model
