"""GLM — generalized linear models via Gram + IRLS (``h2o_tpu/models/glm.py``),
the whole of the reference's builder but feature parallelism: the
single-block families through the IRLSM, COORDINATE_DESCENT and L_BFGS
solvers, with or without ``lambda_search``; ``alpha`` as a list (one fit
each, the best kept); box ``beta_constraints`` and ``linear_constraints``
(the reference's exact active-set QP on the normal equations);
``compute_p_values``; pearson, deviance and ``ml`` dispersion (gamma
exactly, tweedie by the Dunn-Smyth series, with or without its variance
power); interactions (num×num, cat×num, cat×cat) frozen at training and
replayed at scoring; the multinomial family as the reference's per-class
block IRLS, the ordinal family by full-batch Adam, and HGLM (one random
intercept, EM over Henderson's equations).

The expensive part of every IRLS iteration — XᵀWX and XᵀWz over the (R, P+1)
design with its intercept column — is one call of the Gram kernel
(``backend/kernels/gram.py``: the hand-written Hopper kernel on the card, the
plain blocked version on the CPU); so is the p-values' Fisher pass. The
linear predictor ``X @ beta`` is a plain
``torch.matmul``, as the reference leaves it to XLA, and so are L_BFGS and
the ordinal fit, whose gradients come from autograd (``utils/optim.py``
writes out the reference's optax). The small P×P solves run on the host,
as in the reference (`hex/glm/GLM.java:1743`): ADMM over the inverse in
float64, Gauss-Seidel coordinate descent in float32, the constrained QP
and HGLM's cross products and EM in float64. ``feature_parallelism > 1`` raises
``NotImplementedError`` naming ROADMAP Queue 1 item 1 (step M).

Float32 matrix products stay in full float32: the caller's
``torch.backends.cuda.matmul.allow_tf32`` must be False (PyTorch's default),
or the IRLS coefficients drift.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..backend.kernels.gram import gram_accumulate
from ..frame.frame import Frame
from ..frame.vec import T_CAT, Vec
from ..parallel.mesh import resolve_device
from ..utils.log import warn
from ..utils.optim import LBFGS, Adam
from ..utils.twodimtable import TwoDimTable
from .datainfo import DataInfo
from .metrics import make_metrics
from .model_base import Model, ModelBuilder, ModelOutput, Parameters

_MULTI_CARD = "ROADMAP Queue 1 item 1"


# ---------------------------------------------------------------------------
# family/link definitions (hex/glm/GLMModel.GLMParameters.Family + Link)
# ---------------------------------------------------------------------------
class Family:
    name = "gaussian"
    default_link = "identity"

    def __init__(self, link=None, **kw):
        self.link_name = link or self.default_link
        self.params = kw

    def linkinv(self, eta):
        return _LINKINV[self.link_name](eta)

    def dmu_deta(self, eta):
        return _DMUDETA[self.link_name](eta)

    def variance(self, mu):
        return torch.ones_like(mu)

    def deviance(self, y, mu, w):
        return w * (y - mu) ** 2

    def init_intercept(self, y, w):
        ybar = torch.sum(w * y) / torch.clamp(torch.sum(w), min=1e-10)
        return _LINK[self.link_name](torch.clamp(ybar, min=1e-6)
                                     if self.link_name == "log" else ybar)


class GaussianF(Family):
    name = "gaussian"

    def init_intercept(self, y, w):
        return torch.sum(w * y) / torch.clamp(torch.sum(w), min=1e-10)


class BinomialF(Family):
    name = "binomial"
    default_link = "logit"

    def variance(self, mu):
        return mu * (1 - mu)

    def deviance(self, y, mu, w):
        mu = torch.clamp(mu, 1e-10, 1 - 1e-10)
        return -2 * w * (y * torch.log(mu) + (1 - y) * torch.log(1 - mu))

    def init_intercept(self, y, w):
        p = torch.clamp(torch.sum(w * y)
                        / torch.clamp(torch.sum(w), min=1e-10), 1e-6, 1 - 1e-6)
        return torch.log(p / (1 - p))


class QuasibinomialF(BinomialF):
    name = "quasibinomial"


class PoissonF(Family):
    name = "poisson"
    default_link = "log"

    def variance(self, mu):
        return torch.clamp(mu, min=1e-10)

    def deviance(self, y, mu, w):
        mu = torch.clamp(mu, min=1e-10)
        return 2 * w * (torch.where(y > 0, y * torch.log(y / mu), 0.0)
                        - (y - mu))


class GammaF(Family):
    name = "gamma"
    default_link = "log"

    def variance(self, mu):
        return torch.clamp(mu * mu, min=1e-10)

    def deviance(self, y, mu, w):
        mu = torch.clamp(mu, min=1e-10)
        ys = torch.clamp(y, min=1e-10)
        return 2 * w * (-torch.log(ys / mu) + (y - mu) / mu)


class TweedieF(Family):
    name = "tweedie"
    default_link = "log"

    def __init__(self, link=None, tweedie_variance_power=1.5, **kw):
        super().__init__(link, **kw)
        self.p = tweedie_variance_power

    def variance(self, mu):
        return torch.pow(torch.clamp(mu, min=1e-10), self.p)

    def deviance(self, y, mu, w):
        p = self.p
        mu = torch.clamp(mu, min=1e-10)
        yp = torch.clamp(y, min=0.0)
        return 2 * w * (torch.pow(yp, 2 - p) / ((1 - p) * (2 - p))
                        - y * torch.pow(mu, 1 - p) / (1 - p)
                        + torch.pow(mu, 2 - p) / (2 - p))


class NegBinomialF(Family):
    name = "negativebinomial"
    default_link = "log"

    def __init__(self, link=None, theta=1.0, **kw):
        super().__init__(link, **kw)
        self.theta = theta

    def variance(self, mu):
        return torch.clamp(mu + self.theta * mu * mu, min=1e-10)

    def deviance(self, y, mu, w):
        t = 1.0 / self.theta
        mu = torch.clamp(mu, min=1e-10)
        return 2 * w * (torch.where(y > 0, y * torch.log(y / mu), 0.0)
                        - (y + t) * torch.log((y + t) / (mu + t)))


def _clip01(mu):
    return torch.clamp(mu, 1e-10, 1 - 1e-10)


def _sigmoid(eta):
    return 1 / (1 + torch.exp(-eta))


def _safe(x):
    return torch.where(torch.abs(x) < 1e-10, 1e-10, x)


_LINK = {
    "identity": lambda mu: mu,
    "log": lambda mu: torch.log(torch.clamp(mu, min=1e-10)),
    "logit": lambda mu: torch.log(_clip01(mu) / (1 - _clip01(mu))),
    "inverse": lambda mu: 1.0 / _safe(mu),
}
_LINKINV = {
    "identity": lambda eta: eta,
    "log": lambda eta: torch.exp(torch.clamp(eta, -30, 30)),
    "logit": _sigmoid,
    "inverse": lambda eta: 1.0 / _safe(eta),
}
_DMUDETA = {
    "identity": lambda eta: torch.ones_like(eta),
    "log": lambda eta: torch.exp(torch.clamp(eta, -30, 30)),
    "logit": lambda eta: (lambda p: p * (1 - p))(_sigmoid(eta)),
    "inverse": lambda eta: -1.0 / torch.clamp(eta * eta, min=1e-10),
}

_FAMILIES = {c.name: c for c in
             [GaussianF, BinomialF, QuasibinomialF, PoissonF, GammaF, TweedieF,
              NegBinomialF]}


def _carried_family(fam) -> tuple[Family, dict]:
    """A reference family object's counterpart, and its powers as keyword
    arguments (``from_reference``)."""
    cls = _FAMILIES.get(fam.name)
    if cls is None:
        raise ValueError(f"cannot carry a model of family {fam.name} over")
    powers = dict(tweedie_variance_power=getattr(fam, "p", 1.5),
                  theta=getattr(fam, "theta", 1.0))
    return cls(fam.link_name, **powers), powers


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------
def _make_irls_kernel(family: Family):
    """One GLMIterationTask: (X, y, w, beta, offset) -> (Gram, XWz, dev,
    neff), on the design's device. W and z are formed as the reference forms
    them; the Gram and its vector come from one ``gram_accumulate`` call."""

    def step(X, y, w, beta, offset):
        eta = X @ beta + offset
        mu = family.linkinv(eta)
        d = family.dmu_deta(eta)
        V = family.variance(mu)
        W = w * d * d / torch.clamp(V, min=1e-10)
        z = eta - offset + (y - mu) / _safe(d)
        G, b = gram_accumulate(X, W, z)
        dev = torch.sum(family.deviance(y, mu, w))
        return G, b, dev, torch.sum(w)

    return step


def _make_dev_kernel(family: Family):
    """Deviance-only probe: one matvec + the family deviance, ~P× cheaper
    than a full GLMIterationTask — the IRLS loop's plateau check."""

    def dev_eval(X, y, w, beta, offset):
        mu = family.linkinv(X @ beta + offset)
        return torch.sum(family.deviance(y, mu, w))

    return dev_eval


def _admm_solve(G, b, l1, l2, free: np.ndarray, rho=None, iters=500, tol=1e-6,
                state: dict | None = None):
    """Elastic-net solve of ½βᵀGβ − bᵀβ + l1·|β|₁ + ½l2·‖β‖² on the host in
    float64 — the reference's ADMM, verbatim (`hex/optimization/ADMM.java`
    L1Solver). `free` marks unpenalized coefficients (intercept); ``state``
    warm-starts the (z, u) iterates across calls."""
    P = G.shape[0]
    if l1 <= 0:
        A = G + l2 * np.eye(P)
        A[np.diag_indices(P)] += 1e-8
        return np.linalg.solve(A, b)
    rho = rho or max(float(np.mean(np.diag(G))), l1, 1e-3)
    A = G + (l2 + rho) * np.eye(P)
    Ainv = np.linalg.inv(A + 1e-8 * np.eye(P))
    z = np.zeros(P)
    u = np.zeros(P)
    if state and "z" in state and state["z"].shape == (P,):
        z = state["z"].copy()
        u = state["u"].copy()
    thr = np.where(free, 0.0, l1 / rho)
    for _ in range(iters):
        beta = Ainv @ (b + rho * (z - u))
        z_new = np.clip(np.abs(beta + u) - thr, 0, None) * np.sign(beta + u)
        u = u + beta - z_new
        if (np.max(np.abs(z_new - z)) < tol
                and np.max(np.abs(beta - z_new)) < tol * max(1.0, np.abs(z_new).max())):
            z = z_new
            break
        z = z_new
    if state is not None:
        state["z"], state["u"] = z.copy(), u.copy()
    return z


def _cod_sweeps(G, xy, beta0, diag_inv, thr, lo, hi, eps2, max_iter: int):
    """Gauss-Seidel sweeps in float32 on the host, the reference's
    ``_cod_kernel`` step for step: carries (beta, grads) with grads[j] =
    xy[j] − Σ_k G[j,k]β_k + G[j,j]β_j (the reference's CODGradients
    invariant), updated per coordinate; stops after a sweep whose largest
    Δβ_j²·G_jj is below ``eps2``, or after ``max_iter`` sweeps.

    It runs on the host by design, on every run: the sweeps are P
    dependent scalar steps over a P×P matrix — on the card each would be a
    few tiny launches, ~10·P per sweep for up to max(P, 500) sweeps, where
    the host does them in microseconds. A device-side solve (one CTA, or a
    captured graph) waits for a profile that shows this solve."""
    P = G.shape[0]
    beta = beta0.copy()
    grads = xy - G @ beta0 + np.diag(G) * beta0
    zero = np.float32(0.0)
    diffs = np.empty(P, np.float32)
    it, maxdiff = 0, np.float32(np.inf)
    while it < max_iter and maxdiff >= eps2:
        for j in range(P):
            gj = grads[j]
            bnew = np.clip(np.sign(gj) * np.maximum(np.abs(gj) - thr[j], zero)
                           * diag_inv[j], lo[j], hi[j])
            bd = beta[j] - bnew
            step = bd * G[j]
            step[j] = zero
            grads = grads + step
            beta[j] = beta[j] - bd
            diffs[j] = bd * bd * G[j, j]
        maxdiff = diffs.max()
        it += 1
    return beta, it


def _cod_solve(G, b, l1, l2, free: np.ndarray, beta0, beta_epsilon=1e-5,
               lo=None, hi=None):
    """Cyclic coordinate descent on the Gram — the reference's distinct
    COORDINATE_DESCENT solver (`hex/glm/GLM.java:4373` COD_solve): per
    coordinate a soft-threshold step S(grads_j, λα)/(G_jj + λ(1−α)),
    unpenalized coordinates (the intercept) step by grads_j/G_jj;
    convergence when max_j Δβ_j²·G_jj < beta_epsilon², max(P, 500) sweeps,
    in float32 like the reference's device loop."""
    P = G.shape[0]
    diag = np.diag(G).copy()
    diag_inv = 1.0 / np.where(free, np.maximum(diag, 1e-12),
                              np.maximum(diag + l2, 1e-12))
    thr = np.where(free, 0.0, l1)
    lo = np.full(P, -np.inf) if lo is None else np.asarray(lo, np.float64)
    hi = np.full(P, np.inf) if hi is None else np.asarray(hi, np.float64)
    f32 = np.float32
    beta, _ = _cod_sweeps(
        np.asarray(G, f32), np.asarray(b, f32), np.asarray(beta0, f32),
        np.asarray(diag_inv, f32), np.asarray(thr, f32), np.asarray(lo, f32),
        np.asarray(hi, f32), f32(max(beta_epsilon ** 2, 1e-10)), max(P, 500))
    return np.asarray(beta, np.float64)


# ---------------------------------------------------------------------------
# box and linear constraints
# ---------------------------------------------------------------------------
def _strings(spec, col) -> list:
    """A constraint frame's column as strings (a categorical's levels, a
    string column's values)."""
    v = spec.vec(col)
    if v.is_categorical():
        return [v.domain[int(c)] for c in v.to_numpy()]
    return [str(x) for x in v.to_numpy()]


def _beta_bounds(spec, di):
    """(lo, hi) arrays over [expanded coefs..., intercept] on the TRAINING
    (standardized) scale, from a natural-scale constraint spec — a Frame or
    dict with names/lower_bounds/upper_bounds (`hex/glm/GLM.BetaConstraint`).
    Natural bound b on a standardized numeric coef becomes b·σ (β_std = β·σ);
    one-hot and unstandardized coefs carry bounds unchanged."""
    if spec is None:
        return None
    if hasattr(spec, "vec"):  # Frame
        names = _strings(spec, "names")
        lob = spec.vec("lower_bounds").to_numpy()
        upb = spec.vec("upper_bounds").to_numpy()
    else:
        names = list(spec["names"])
        lob = np.asarray(spec.get("lower_bounds",
                                  [-np.inf] * len(names)), dtype=np.float64)
        upb = np.asarray(spec.get("upper_bounds",
                                  [np.inf] * len(names)), dtype=np.float64)
    P = di.ncols_expanded
    lo = np.full(P + 1, -np.inf)
    hi = np.full(P + 1, np.inf)
    idx = {n: j for j, n in enumerate(di.expanded_names)}
    for n, l, u in zip(names, lob, upb):
        if n not in idx:
            raise ValueError(f"beta_constraints: unknown coefficient '{n}' "
                             f"(expanded names: numeric column or "
                             f"'col.level')")
        j = idx[n]
        s = di.num_sigmas.get(n, 1.0) if di.standardize else 1.0
        if not np.isnan(l):
            lo[j] = l * s
        if not np.isnan(u):
            hi[j] = u * s
    return lo, hi


def _linear_constraint_system(spec, di):
    """Parse linear_constraints into (Aeq, ceq, Ain, cin) over the TRAINING
    coefficient layout [expanded coefs..., intercept].

    Wire format (`ConstrainedGLMUtils.extractLinearConstraints`): rows of
    {names, values, types, constraint_numbers}; rows sharing a
    constraint_number form one constraint Σ value·coef + constant (op) 0,
    with the name 'constant' carrying the constant and types Equal /
    LessThanEqual. Natural→standardized transform: β_nat_j = β_std_j/σ_j
    for standardized numerics, and a constraint naming the intercept picks
    up the centering cross-terms −a_int·m_j/σ_j."""
    if spec is None:
        return None
    if hasattr(spec, "vec"):  # Frame
        names = _strings(spec, "names")
        values = np.asarray(spec.vec("values").to_numpy(), np.float64)
        types = [t.lower() for t in _strings(spec, "types")]
        numbers = np.asarray(spec.vec("constraint_numbers").to_numpy(),
                             np.int64)
    else:
        names = list(spec["names"])
        values = np.asarray(spec["values"], np.float64)
        types = [str(t).lower() for t in spec["types"]]
        numbers = np.asarray(spec["constraint_numbers"], np.int64)
    P1 = di.ncols_expanded + 1
    idx = {n: j for j, n in enumerate(di.expanded_names)}
    rows_eq, rows_in = [], []
    for cn in sorted(set(int(n) for n in numbers)):
        sel = [i for i in range(len(names)) if int(numbers[i]) == cn]
        ctypes = {types[i] for i in sel}
        if len(ctypes) != 1 or not ctypes <= {"equal", "lessthanequal"}:
            raise ValueError(
                f"linear_constraints: constraint {cn} must have one type, "
                f"Equal or LessThanEqual (got {sorted(ctypes)})")
        a = np.zeros(P1)
        c = 0.0
        ncoef = 0
        for i in sel:
            n = names[i]
            v = float(values[i])
            if n == "constant":
                c += v
                continue
            ncoef += 1
            if n in ("Intercept", "intercept"):
                a[-1] += v
                # centering cross-terms from int_nat = int_std − Σ β·m/σ
                for j, en in enumerate(di.expanded_names):
                    if en in di.num_means and di.effective_center:
                        s = di.num_sigmas[en] if di.standardize else 1.0
                        a[j] -= v * di.num_means[en] / s
                continue
            if n not in idx:
                raise ValueError(
                    f"linear_constraints: coefficient name '{n}' is not a "
                    f"valid coefficient name (numeric column or "
                    f"'col.level') or 'constant'")
            s = (di.num_sigmas.get(n, 1.0)
                 if di.standardize and n in di.num_means else 1.0)
            a[idx[n]] += v / s
        if ncoef < 2:
            raise ValueError(
                "Linear constraint must have at least two coefficients. For "
                "constraints on just one coefficient use beta_constraints "
                "instead.")
        (rows_eq if "equal" in ctypes else rows_in).append((a, c))
    Aeq = np.array([r[0] for r in rows_eq]).reshape(-1, P1)
    ceq = np.array([r[1] for r in rows_eq], np.float64)
    Ain = np.array([r[0] for r in rows_in]).reshape(-1, P1)
    cin = np.array([r[1] for r in rows_in], np.float64)
    M = np.vstack([Aeq, Ain]) if len(Aeq) + len(Ain) else np.zeros((0, P1))
    if len(M) and np.linalg.matrix_rank(M) < len(M):
        raise ValueError("redundant and possibly conflicting linear "
                         "constraints: the constraint matrix is not full "
                         "rank — remove redundant constraints")
    return Aeq, ceq, Ain, cin


def _constrained_qp(G, b, Aeq, ceq, Ain, cin, tol=1e-8, max_iter=200):
    """min ½βᵀGβ − bᵀβ  s.t.  Aeq·β + ceq = 0, Ain·β + cin ≤ 0, on the
    host in float64: the reference's dense primal active set over KKT
    solves — each iteration solves [[G, Aᵀ], [A, 0]] [β; λ] = [b; −c] for
    the working set, adds the most violated inactive inequality, drops the
    most negative multiplier."""
    P = G.shape[0]
    Greg = G + 1e-10 * np.eye(P)
    active: list[int] = []

    def solve(act):
        rows = [Aeq] + [Ain[i:i + 1] for i in act]
        A = np.vstack([r for r in rows if len(r)]) if (len(Aeq) or act) \
            else np.zeros((0, P))
        c = np.concatenate([ceq] + [cin[i:i + 1] for i in act]) \
            if (len(ceq) or act) else np.zeros(0)
        m = A.shape[0]
        K = np.zeros((P + m, P + m))
        K[:P, :P] = Greg
        K[:P, P:] = A.T
        K[P:, :P] = A
        rhs = np.concatenate([b, -c])
        try:
            sol = np.linalg.solve(K, rhs)
        except np.linalg.LinAlgError:
            sol = np.linalg.lstsq(K, rhs, rcond=None)[0]
        return sol[:P], sol[P + len(ceq):]  # β, inequality multipliers

    beta, lam = solve(active)
    for _ in range(max_iter):
        if len(active) and len(lam) and lam.min() < -tol:
            del active[int(np.argmin(lam))]
            beta, lam = solve(active)
            continue
        if len(Ain):
            viol = Ain @ beta + cin
            viol[active] = -np.inf
            worst = int(np.argmax(viol))
            if viol[worst] > tol:
                active.append(worst)
                beta, lam = solve(active)
                continue
        break
    return beta


def _qp_inequalities(lincon, bounds, non_negative: bool, P1: int):
    """The inequality rows the constrained solve takes: the linear
    constraints' own, then ``non_negative`` and the box bounds as rows
    (a post-hoc clip would break the linear constraints)."""
    _Aeq, _ceq, Ain, cin = lincon
    rows = [(Ain, cin)]
    if non_negative:
        rows.append((-np.eye(P1)[: P1 - 1], np.zeros(P1 - 1)))
    if bounds is not None:
        lo, hi = bounds
        for j in range(P1):
            e = np.zeros(P1)
            if np.isfinite(hi[j]):
                e[j] = 1.0
                rows.append((e[None, :].copy(), np.array([-hi[j]])))
            if np.isfinite(lo[j]):
                e[j] = -1.0
                rows.append((e[None, :].copy(), np.array([lo[j]])))
    return np.vstack([r[0] for r in rows]), np.concatenate([r[1]
                                                           for r in rows])


def _constraints_table(lincon, beta):
    """`GLMModel.output._linear_constraint_states`: each constraint's value
    at the solution and whether it holds (within 1e-5)."""
    Aeq, ceq, Ain, cin = lincon
    rows = []
    for i in range(len(ceq)):
        val = float(Aeq[i] @ beta + ceq[i])
        rows.append([f"equality_{i}", "Equal", val, bool(abs(val) < 1e-5)])
    for i in range(len(cin)):
        val = float(Ain[i] @ beta + cin[i])
        rows.append([f"lessthanequal_{i}", "LessThanEqual", val,
                     bool(val < 1e-5)])
    return TwoDimTable(
        table_header="Linear Constraints", description="",
        col_header=["constraint", "type", "value", "condition_satisfied"],
        col_types=["string", "string", "double", "string"], cell_values=rows)


# ---------------------------------------------------------------------------
# dispersion
# ---------------------------------------------------------------------------
def _tweedie_loglik(y, mu, phi, p):
    """Σ log f(y; μ, φ) for Tweedie 1<p<2, by the Dunn & Smyth (2005) series
    (`hex/glm/TweedieMLDispersionOnly`). Host float64; the series index
    window is centered on j_max = y^{2−p}/(φ(2−p))."""
    from scipy.special import gammaln

    y = np.asarray(y, np.float64)
    mu = np.maximum(np.asarray(mu, np.float64), 1e-10)
    alpha = (2.0 - p) / (p - 1.0)
    ll = (y * mu ** (1 - p) / (1 - p) - mu ** (2 - p) / (2 - p)) / phi
    pos = y > 0
    yp = y[pos]
    if yp.size:
        jmax = np.max(np.maximum(yp ** (2 - p) / (phi * (2 - p)), 1.0))
        J = int(min(max(3 * jmax + 20, 40), 4000))
        j = np.arange(1, J + 1, dtype=np.float64)[None, :]
        logz = (alpha * np.log(yp) - alpha * np.log(p - 1)
                - (1 + alpha) * np.log(phi) - np.log(2 - p))[:, None]
        logWj = j * logz - gammaln(j + 1) - gammaln(alpha * j)
        m = logWj.max(axis=1, keepdims=True)
        logW = m[:, 0] + np.log(np.exp(logWj - m).sum(axis=1))
        ll[pos] += logW - np.log(yp)
    return float(ll.sum())


def _tweedie_phi_ml(yh, muh, p_var: float, df: float) -> float:
    """Golden-section ML over log φ at fixed variance power, seeded from the
    Pearson estimate."""
    pearson = _estimate_dispersion_pearson(
        TweedieF(tweedie_variance_power=p_var), yh, muh,
        np.ones_like(yh), df)
    a, b = np.log(max(pearson, 1e-8)) - 4.0, np.log(max(pearson, 1e-8)) + 4.0
    gr = (np.sqrt(5.0) - 1) / 2

    def f(lp):
        return _tweedie_loglik(yh, muh, np.exp(lp), p_var)

    c1, c2 = b - gr * (b - a), a + gr * (b - a)
    f1, f2 = f(c1), f(c2)
    for _ in range(40):
        if f1 < f2:
            a, c1, f1 = c1, c2, f2
            c2 = a + gr * (b - a)
            f2 = f(c2)
        else:
            b, c2, f2 = c2, c1, f1
            c1 = b - gr * (b - a)
            f1 = f(c1)
        if b - a < 1e-8:
            break
    return float(np.exp(0.5 * (a + b)))


def _gamma_ml_dispersion(dev: float, neff: float) -> float:
    """Exact gamma ML: solve log α − ψ(α) = D/(2n) for the shape α = 1/φ
    by Newton with digamma/trigamma (`hex/glm/DispersionTask` ml branch)."""
    from scipy.special import digamma, polygamma

    c = max(dev / (2.0 * max(neff, 1.0)), 1e-12)
    a = (3.0 - c + np.sqrt((c - 3.0) ** 2 + 24.0 * c)) / (12.0 * c)
    for _ in range(30):
        f = np.log(a) - float(digamma(a)) - c
        fp = 1.0 / a - float(polygamma(1, a))
        a_new = a - f / fp
        if a_new <= 0:
            a_new = a / 2.0
        if abs(a_new - a) < 1e-12 * max(a, 1.0):
            a = a_new
            break
        a = a_new
    return 1.0 / max(a, 1e-12)


def _estimate_dispersion(p, family, y, mu, w, dev, neff, rank) -> float:
    """Dispersion φ per `dispersion_parameter_method`
    (`hex/glm/GLMModel.java:528`, `hex/glm/DispersionTask.java`), on host
    copies: pearson, deviance, or ``ml`` — exact for gamma, the Dunn-Smyth
    series likelihood for tweedie (over at most 50,000 rows, drawn from
    numpy's ``default_rng(42)`` as the reference draws them), jointly with
    the variance power when ``fix_tweedie_variance_power`` is False."""
    if p.fix_dispersion_parameter:
        return float(p.init_dispersion_parameter)
    method = (p.dispersion_parameter_method or "pearson").lower()
    df = max(neff - rank, 1.0)
    if method == "deviance":
        return float(dev) / df
    if method == "ml":
        if family.name == "gamma":
            return _gamma_ml_dispersion(float(dev), float(neff))
        if family.name == "tweedie":
            if not (1.0 < family.p < 2.0):
                raise ValueError("ml dispersion for tweedie requires "
                                 "1 < tweedie_variance_power < 2")
            keep = w > 0
            yh, muh = y[keep], mu[keep]
            if yh.size > 50_000:
                sel = np.random.default_rng(42).choice(yh.size, 50_000,
                                                       replace=False)
                yh, muh = yh[sel], muh[sel]
            if p.fix_tweedie_variance_power:
                return _tweedie_phi_ml(yh, muh, family.p, df)
            best = (-np.inf, family.p, 1.0)
            for vp in np.arange(1.1, 1.91, 0.05):  # joint (p, φ) profile ML
                phi = _tweedie_phi_ml(yh, muh, float(vp), df)
                ll = _tweedie_loglik(yh, muh, phi, float(vp))
                if ll > best[0]:
                    best = (ll, float(vp), phi)
            family.estimated_p = best[1]  # per-model family instance
            return best[2]
        raise ValueError(f"ml dispersion is supported for gamma and tweedie "
                         f"(got family={family.name}) — use pearson/deviance")
    return _estimate_dispersion_pearson(family, y, mu, w, df)


def _estimate_dispersion_pearson(family, y, mu, w, df) -> float:
    V = family.variance(torch.from_numpy(np.asarray(mu))).numpy()
    resid2 = w * (y - mu) ** 2 / np.maximum(V, 1e-12)
    return float(np.nansum(resid2) / df)


# ---------------------------------------------------------------------------
# interactions (`hex/DataInfo.java:133` InteractionPair)
# ---------------------------------------------------------------------------
#: cap on a cat×cat product domain — the EnumLimited analog for interaction
#: columns (the reference's `Interaction.java` max_factors defaults to 100)
_INTERACTION_MAX_LEVELS = 100


def _freeze_interaction_pairs(fr: Frame, interactions, interaction_pairs,
                              reserved: set,
                              max_levels: int = _INTERACTION_MAX_LEVELS):
    """Resolve `interactions` (all pairwise combos among the columns) and/or
    `interaction_pairs` (explicit (a, b) tuples) into frozen per-pair specs:

    - num×num → one product column "a_b"
    - cat×num → one gated numeric column "a_b.lvl" per non-reference level
    - cat×cat → one categorical column "a_b" whose domain is the OBSERVED
      level combos "la_lb", most-frequent first, capped at ``max_levels``;
      rarer combos score as NA → mode

    Everything needed to replay at score time is frozen here from the
    TRAINING frame (its codes read on the host)."""
    def resolve(c):
        return fr.names[int(c)] if not isinstance(c, str) else c

    pairs = []
    listed = []
    if interactions:
        cols = [resolve(c) for c in interactions]
        listed += cols
        if len(cols) < 2:
            raise ValueError(
                "interactions needs at least two columns to form pairs "
                f"(got {cols}) — use interaction_pairs for explicit tuples")
        pairs += [(a, b) for i, a in enumerate(cols) for b in cols[i + 1:]]
    for a, b in (interaction_pairs or []):
        pairs.append((resolve(a), resolve(b)))
        listed += [resolve(a), resolve(b)]
    for c in listed:
        if c in reserved:
            raise ValueError(f"interactions may not include the special "
                             f"column '{c}' (response/weights/offset)")
        if fr.vec(c).is_string():
            raise ValueError(f"interactions: column '{c}' is a string "
                             "column")
    specs = []
    for a, b in pairs:
        # canonical order: categorical first (stable generated names)
        if fr.vec(b).is_categorical() and not fr.vec(a).is_categorical():
            a, b = b, a
        acat, bcat = fr.vec(a).is_categorical(), fr.vec(b).is_categorical()
        if not acat:
            specs.append({"kind": "numnum", "a": a, "b": b})
        elif not bcat:
            specs.append({"kind": "catnum", "a": a, "b": b,
                          "levels": list(fr.vec(a).domain)})
        else:
            ca = fr.vec(a).to_numpy()
            cb = fr.vec(b).to_numpy()
            ok = ~(np.isnan(ca) | np.isnan(cb))
            da, db = fr.vec(a).domain, fr.vec(b).domain
            combo = ca[ok].astype(np.int64) * len(db) + cb[ok].astype(np.int64)
            codes, counts = np.unique(combo, return_counts=True)
            order = np.argsort(-counts, kind="stable")[:max_levels]
            # combos keyed by the level-name pair: labels are display only
            combos = [(da[c // len(db)], db[c % len(db)])
                      for c in codes[order]]
            labels, seen = [], set()
            for la, lb in combos:
                lab = f"{la}_{lb}"
                while lab in seen:
                    lab += "."
                seen.add(lab)
                labels.append(lab)
            specs.append({"kind": "catcat", "a": a, "b": b,
                          "combos": combos, "labels": labels})
    return specs


def _primary_interaction_name(s: dict) -> str:
    if s["kind"] == "catnum":
        return f"{s['a']}_{s['b']}.{s['levels'][1]}" if len(s["levels"]) > 1 \
            else f"{s['a']}_{s['b']}"
    return f"{s['a']}_{s['b']}"


def _legacy_combos(s: dict, da, db) -> list:
    """(level_a, level_b) pairs of a legacy spec that stored display labels
    only, each matched exactly against the domains (a blind ``rsplit``
    would mis-parse levels holding underscores); a label matching other
    than one pair fails the load."""
    db_set = set(db)
    combos = []
    for lab in s["labels"]:
        hits = [(la, lab[len(la) + 1:]) for la in da
                if lab.startswith(la + "_") and lab[len(la) + 1:] in db_set]
        if len(hits) != 1:
            raise ValueError(
                f"interaction '{s['a']}_{s['b']}': legacy level label "
                f"'{lab}' matches {len(hits)} (level_a, level_b) pairs — "
                f"cannot recover the combo mapping; re-export the model "
                f"with 'combos' in its interaction spec")
        combos.append(hits[0])
    return combos


def _apply_interactions(fr: Frame, specs: list, skip_existing: bool = False):
    """Append the frozen interaction columns to (a shallow copy of) ``fr``
    on its device — identically at train and score time; score-frame
    domains are matched BY LABEL so unseen levels/combos become NA.
    ``skip_existing`` makes replay idempotent on a frame that already
    carries the expansion."""
    out = Frame(list(fr.names), list(fr.vecs))
    new_names = []

    def add(nm, data, **kw):
        if nm in out.names:
            raise ValueError(
                f"interactions: generated column name '{nm}' collides "
                f"with an existing column — rename it")
        out.add(nm, Vec(data, fr.nrow, **kw))
        new_names.append(nm)

    if skip_existing:
        specs = [s for s in specs
                 if _primary_interaction_name(s) not in fr.names]
    for s in specs:
        va, vb = fr.vec(s["a"]), fr.vec(s["b"])
        if s["kind"] == "numnum":
            add(f"{s['a']}_{s['b']}", va.data * vb.data)
        elif s["kind"] == "catnum":
            dom = va.domain or []
            for lvl in s["levels"][1:]:   # reference level dropped
                code = dom.index(lvl) if lvl in dom else -1
                gate = (va.data == code).to(torch.float32)
                col = torch.where(torch.isnan(va.data), torch.nan, gate) \
                    * vb.data
                add(f"{s['a']}_{s['b']}.{lvl}", col)
        else:  # catcat
            da, db = va.domain or [], vb.domain or []
            combos = s.get("combos")
            if combos is None:
                combos = _legacy_combos(s, da, db)
            combo_idx = {tuple(c): i for i, c in enumerate(combos)}
            table = np.full(max(len(da), 1) * max(len(db), 1), np.nan,
                            np.float32)
            for i, la in enumerate(da):
                for j, lb in enumerate(db):
                    k = combo_idx.get((la, lb))
                    if k is not None:
                        table[i * len(db) + j] = k
            combo = va.data * len(db) + vb.data   # NaN propagates
            nan = torch.isnan(combo)
            codes = torch.where(nan, 0.0, combo).to(torch.int64)
            lut = torch.from_numpy(table).to(combo.device)
            mapped = lut[codes.clamp(0, len(table) - 1)]
            add(f"{s['a']}_{s['b']}",
                torch.where(nan, torch.nan, mapped), type=T_CAT,
                domain=list(s["labels"]))
    return out, new_names


# ---------------------------------------------------------------------------
# parameters / model / builder
# ---------------------------------------------------------------------------
@dataclass
class GLMParameters(Parameters):
    """The reference's GLM fields and defaults (`hex/schemas/GLMV3`)."""

    family: str = "AUTO"
    link: str | None = None
    solver: str = "IRLSM"          # IRLSM | COORDINATE_DESCENT | L_BFGS
    alpha: float | None = None     # elastic-net mix; default .5 like the
                                   # reference; a list fits one model each
    lambda_: float | None = None   # penalty strength; None -> 0 or search
    lambda_search: bool = False
    early_stopping: bool = True    # lambda_search walks the path only while
                                   # deviance still improves materially
    nlambdas: int = 30
    lambda_min_ratio: float = 1e-4
    standardize: bool = True
    intercept: bool = True
    non_negative: bool = False
    dispersion_parameter_method: str = "pearson"  # pearson | deviance | ml
    fix_dispersion_parameter: bool = False
    init_dispersion_parameter: float = 1.0
    fix_tweedie_variance_power: bool = True
    HGLM: bool = False               # one categorical random intercept
    random_columns: list = None
    rand_family: list = None         # ["gaussian"] (the only member)
    interactions: list = None        # columns whose pairs enter the design
    interaction_pairs: list = None   # explicit (a, b) tuples
    beta_constraints: object = None  # Frame or {names, lower_bounds,
                                     # upper_bounds}, natural scale
    linear_constraints: object = None  # Frame or {names, values, types,
                                     # constraint_numbers}; solved by the
                                     # reference's exact active-set QP
    constraint_eta0: float = 0.1258925  # accepted for API parity; the QP
    constraint_tau: float = 10.0        # solve has no use for them, as in
    constraint_c0: float = 10.0         # the reference
    constraint_alpha: float = 0.1
    constraint_beta: float = 0.9
    max_iterations: int = 50
    beta_epsilon: float = 1e-5
    objective_epsilon: float = 1e-6
    tweedie_variance_power: float = 1.5
    theta: float = 1.0
    missing_values_handling: str = "MeanImputation"
    compute_p_values: bool = False
    feature_parallelism: int = 1     # > 1 lays the design over several
                                     # cards: ROADMAP Queue 1 item 1


def _destandardize(beta: np.ndarray, di) -> np.ndarray:
    """Map coefficients from the standardized training scale back to the
    original feature scale: b → b/s, intercept → intercept − Σ b·m/s.
    Accepts (P+1,) or multinomial (K, P+1) [classes × coefs, intercept last]."""
    beta = beta.copy()
    if not (di.standardize or di.effective_center):
        return beta
    B = beta[None, :] if beta.ndim == 1 else beta
    shift = np.zeros(B.shape[0])
    for j, n in enumerate(di.expanded_names):
        if n in di.num_means:  # numeric (one-hot names never collide)
            s = di.num_sigmas[n] if di.standardize else 1.0
            m = di.num_means[n] if di.effective_center else 0.0
            B[:, j] = B[:, j] / s
            shift += B[:, j] * m
    B[:, -1] -= shift
    return B[0] if beta.ndim == 1 else B


class GLMModel(Model):
    algo_name = "glm"
    dispersion_estimated = None   # φ per dispersion_parameter_method
    default_threshold = 0.5       # binomial label cut on p1
    interaction_spec = None       # frozen pair specs (levels/labels by name)

    def __init__(self, params, output, dinfo: DataInfo, beta, family):
        super().__init__(params, output)
        self.dinfo = dinfo
        self.beta = beta        # (P+1,) float64 host array, intercept LAST
        self.family = family

    @staticmethod
    def from_reference(ref, device=None) -> "GLMModel":
        """Carry a JAX-trained GLM over from its plain fields: ``beta``
        (intercept last), the ``DataInfo`` fields, the family's name, link
        and powers, the output's names, domains, category and response
        domain, the frozen interaction spec, and an ordinal model's
        thresholds or an HGLM's random intercepts and variances. ``device``
        is checked as every entry point checks it; the model holds host
        arrays only and scores on the frame's device. Given the same
        frame, the carried model scores what the reference scores."""
        resolve_device(device)
        di = DataInfo.carried(ref.dinfo)
        fam = ref.family
        kind = type(ref).__name__
        if kind not in ("GLMModel", "GLMMultinomialModel", "GLMOrdinalModel",
                        "HGLMModel"):
            raise ValueError(f"cannot carry a {kind} of family {fam.name} "
                             f"over")
        family, powers = _carried_family(fam)
        out = ModelOutput.carried(ref.output)
        fam_name = {"GLMMultinomialModel": "multinomial",
                    "GLMOrdinalModel": "ordinal"}.get(kind, fam.name)
        params = GLMParameters(
            family=fam_name, link=fam.link_name, standardize=di.standardize,
            missing_values_handling=di.missing_values_handling,
            HGLM=kind == "HGLMModel",
            response_column=ref.params.response_column, **powers)
        beta = np.asarray(ref.beta, np.float64).copy()
        if kind == "GLMOrdinalModel":
            model = GLMOrdinalModel(params, out, di, beta,
                                    np.asarray(ref.thresholds, np.float64))
        elif kind == "HGLMModel":
            params.random_columns = [ref.random_column]
            model = HGLMModel(params, out, di, beta, family, ref.ubeta,
                              ref.random_column, ref.random_domain)
            model.varfix, model.varranef = ref.varfix, ref.varranef
        else:
            model_cls = GLMMultinomialModel \
                if kind == "GLMMultinomialModel" else GLMModel
            model = model_cls(params, out, di, beta, family)
        model.interaction_spec = copy.deepcopy(ref.interaction_spec)
        return model

    def coef(self) -> dict:
        """Coefficients on the ORIGINAL feature scale
        (`GLMModel.coefficients()`)."""
        names = self.dinfo.expanded_names + ["Intercept"]
        beta = _destandardize(np.asarray(self.beta, dtype=np.float64),
                              self.dinfo)
        return dict(zip(names, beta))

    def coef_norm(self) -> dict:
        """Coefficients on the standardized scale
        (`coefficients(standardize=True)`)."""
        names = self.dinfo.expanded_names + ["Intercept"]
        return dict(zip(names, np.asarray(self.beta)))

    def adapt_frame(self, fr) -> torch.Tensor:
        """The design of ``fr``: the categorical encoding replayed first, so
        the interaction products see the training-time values, then the
        frozen interactions, then ``DataInfo``'s expansion."""
        fr = self.pre_adapt(fr)
        if self.interaction_spec:
            fr, _ = _apply_interactions(fr, self.interaction_spec,
                                        skip_existing=True)
        X, _ok = self.dinfo.expand(fr)
        return X

    def score0(self, X: torch.Tensor) -> torch.Tensor:
        beta = torch.as_tensor(self.beta, dtype=torch.float32,
                               device=X.device)
        eta = X @ beta[:-1] + beta[-1]
        mu = self.family.linkinv(eta)
        if self.output.model_category == "Binomial":
            label = (mu >= float(self.default_threshold)).to(torch.float32)
            return torch.stack([label, 1 - mu, mu], dim=1)
        return mu


def _weights(p, fr, y_dev, okrow) -> torch.Tensor:
    """The rows' fitting weights: response present, row kept by the
    expansion, times the weights column."""
    w = (~torch.isnan(y_dev)).to(torch.float32) * okrow.to(torch.float32)
    if p.weights_column:
        w = w * torch.nan_to_num(fr.vec(p.weights_column).data)
    return w


def _on_dev(beta: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(beta.astype(np.float32)).to(dev)


class GLM(ModelBuilder):
    algo_name = "glm"

    def _validate(self):
        super()._validate()
        p = self.params
        fam = (p.family or "").lower()
        if p.compute_p_values:  # the reference rejects up front
            if p.lambda_search or (p.lambda_ is not None and p.lambda_ > 0):
                raise ValueError("compute_p_values requires lambda = 0 / no "
                                 "lambda_search (no regularization)")
            if fam == "multinomial":
                raise ValueError("compute_p_values is not supported for "
                                 "multinomial family")
        if p.linear_constraints is not None:
            # `GLM.checkInitLinearConstraints`
            if (p.solver or "IRLSM").upper() not in ("IRLSM", "AUTO"):
                raise ValueError(
                    "constrained GLM is only available for IRLSM. Please "
                    "set solver to IRLSM/irlsm explicitly.")
            if not p.intercept:
                raise ValueError("constrained GLM is only supported with "
                                 "intercept=true.")
            if p.lambda_search or (p.lambda_ is not None and p.lambda_ > 0):
                raise ValueError("Regularization is not allowed for "
                                 "constrained GLM.")
            if fam in ("multinomial", "ordinal"):
                raise ValueError("Constrained GLM is not supported for "
                                 "multinomial and ordinal families")
        if p.feature_parallelism > 1:
            raise NotImplementedError(
                f"glm: feature_parallelism={p.feature_parallelism} lays the "
                f"design over several cards, which is not ported yet "
                f"({_MULTI_CARD})")

    def _family(self, category) -> Family:
        p = self.params
        name = (p.family or "AUTO").lower()
        if name == "auto":
            name = {"Binomial": "binomial", "Multinomial": "multinomial",
                    "Regression": "gaussian"}[category]
        if name == "multinomial":
            return BinomialF(p.link if p.link not in (None, "family_default")
                             else None)
        cls = _FAMILIES.get(name)
        if cls is None:
            raise ValueError(f"unsupported GLM family '{name}'")
        link = p.link if p.link not in (None, "family_default") else None
        return cls(link, tweedie_variance_power=p.tweedie_variance_power,
                   theta=p.theta)

    def build_impl(self, job) -> GLMModel:
        p = self.params
        if isinstance(p.alpha, (list, tuple)):
            return self._build_alpha_search(job)
        fr = p.training_frame
        names = self.feature_names()
        y_dev, category, resp_domain = self.response_info()
        spec = None
        if p.interactions or p.interaction_pairs:
            if category == "Multinomial" or p.HGLM:
                raise NotImplementedError(
                    "interactions are supported for single-block GLM "
                    "families (not multinomial/ordinal/HGLM)")
            reserved = {p.response_column, p.weights_column, p.offset_column}
            spec = _freeze_interaction_pairs(fr, p.interactions,
                                             p.interaction_pairs, reserved)
            fr, extra = _apply_interactions(fr, spec)
            names = names + extra
        if p.HGLM:
            return self._build_hglm(job, names, y_dev, category)
        if category == "Multinomial":
            if p.compute_p_values:  # AUTO family resolving to multinomial
                raise ValueError("compute_p_values is not supported for "
                                 "multinomial family")
            if p.linear_constraints is not None:
                raise ValueError("Constrained GLM is not supported for "
                                 "multinomial and ordinal families")
            if (p.family or "").lower() == "ordinal":
                return self._build_ordinal(job, names, y_dev, resp_domain)
            return self._build_multinomial(job, names, y_dev, resp_domain)
        return self._build_single(job, fr, names, y_dev, category,
                                  resp_domain, spec)

    def _build_alpha_search(self, job) -> GLMModel:
        """``alpha`` given as a list (`hex/glm/GLM.java`'s submodel scan over
        alphas): one fit per alpha, keeping the best by deviance —
        validation when present, else training; ``best_alpha`` names it."""
        p = self.params
        alphas = [float(a) for a in p.alpha]
        if not alphas:
            raise ValueError("alpha: empty array")
        best, best_dev, best_alpha = None, float("inf"), None
        for a in alphas:
            sub = type(self)(dataclasses.replace(p, alpha=a, nfolds=0))
            m = sub.build_impl(job)
            mm = (m.output.validation_metrics
                  if p.validation_frame is not None
                  else m.output.training_metrics)
            dev = None
            for attr in ("residual_deviance", "mean_residual_deviance",
                         "logloss", "mse"):
                dev = getattr(mm, attr, None)
                if dev is not None and dev == dev:
                    break
            if best is None or (dev is not None and dev < best_dev):
                best, best_alpha = m, a
                best_dev = dev if dev is not None else best_dev
        best.best_alpha = best_alpha
        return best

    def _build_single(self, job, fr, names, y_dev, category, resp_domain,
                      spec):
        p = self.params
        family = self._family(category)
        dinfo = DataInfo.make(fr, names, standardize=p.standardize,
                              missing_values_handling=p.missing_values_handling)
        Xi, okrow = dinfo.expand(fr, intercept=True)
        y = torch.nan_to_num(y_dev)
        w = _weights(p, fr, y_dev, okrow)
        offset = (torch.nan_to_num(fr.vec(p.offset_column).data)
                  if p.offset_column else torch.zeros_like(y))
        self._bounds = _beta_bounds(p.beta_constraints, dinfo)
        self._lincon = _linear_constraint_system(p.linear_constraints, dinfo)
        beta, lambda_used, dev, nulldev, neff, iters = self._fit(
            Xi, y, w, offset, family, job)
        X = Xi[:, :dinfo.ncols_expanded]

        output = ModelOutput()
        output.names = names
        output.domains = {n: fr.vec(n).domain for n in names}
        output.response_domain = list(resp_domain) if resp_domain else None
        output.model_category = category
        model = GLMModel(p, output, dinfo, beta, family)
        model.interaction_spec = spec
        raw = model.score0(X)
        ym = torch.where(w > 0, y, torch.nan)
        m = make_metrics(category, ym, raw, w if p.weights_column else None,
                         auc_type=p.auc_type, domain=output.response_domain)
        m.residual_deviance = float(dev)
        m.null_deviance = float(nulldev)
        rank = int(np.sum(np.abs(np.asarray(beta)) > 1e-12))
        m.aic = float(dev + 2 * rank)
        m.residual_degrees_of_freedom = int(neff) - rank
        m.null_degrees_of_freedom = int(neff) - 1
        output.training_metrics = m
        output.scoring_history = [{"iterations": iters, "lambda": lambda_used,
                                   "deviance": float(dev)}]
        output.variable_importances = self._varimp_from_beta(dinfo, beta)
        if self._lincon is not None:
            output.linear_constraints_table = _constraints_table(
                self._lincon, beta)
        if family.name in ("gaussian", "gamma", "tweedie", "negativebinomial",
                           "quasibinomial"):
            mu = raw if raw.ndim == 1 else raw[:, -1]
            model.dispersion_estimated = _estimate_dispersion(
                p, family, ym.cpu().numpy(), mu.cpu().numpy(),
                w.cpu().numpy(), float(dev), float(neff), len(beta))
            if getattr(family, "estimated_p", None) is not None:
                model.tweedie_variance_power_estimated = family.estimated_p
        if p.compute_p_values:
            self._compute_p_values(model, Xi, y, w, offset, family, beta,
                                   float(dev), float(neff))
        if p.validation_frame is not None:
            output.validation_metrics = model.model_performance(
                p.validation_frame)
        return model

    def _compute_p_values(self, model, Xi, y, w, offset, family, beta,
                          dev, neff):
        """Std errors, z-values and p-values from the inverse Fisher
        information at the solution: one more Gram launch at ``beta``, the
        inverse on the host in float64, and the covariance mapped to the
        original scale with the coefficients' own linear map. The gaussian
        t-tail is ``scipy.special.betainc`` in float64 (the reference's
        is jax's, in float32); other families take the two-sided z-test."""
        from scipy.special import betainc

        step = _make_irls_kernel(family)
        G, _, _, _ = step(Xi, y, w, _on_dev(beta, Xi.device), offset)
        Gn = G.cpu().numpy().astype(np.float64)
        rank = len(beta)
        gaussian = family.name == "gaussian"
        est = model.dispersion_estimated
        dispersion = (est if est is not None
                      else dev / max(neff - rank, 1.0) if gaussian else 1.0)
        try:
            cov = np.linalg.inv(Gn + 1e-10 * np.eye(Gn.shape[0])) * dispersion
        except np.linalg.LinAlgError:
            return
        di = model.dinfo
        A = np.eye(rank)
        if di.standardize or di.effective_center:
            for j, n in enumerate(di.expanded_names):
                if n in di.num_means:
                    s = di.num_sigmas[n] if di.standardize else 1.0
                    m = di.num_means[n] if di.effective_center else 0.0
                    A[j, j] = 1.0 / s
                    A[-1, j] = -m / s
        cov = A @ cov @ A.T
        beta_orig = A @ np.asarray(beta, np.float64)
        se = np.sqrt(np.clip(np.diag(cov), 0, None))
        with np.errstate(divide="ignore", invalid="ignore"):
            z = np.where(se > 0, beta_orig / se, np.nan)
        df = max(neff - rank, 1.0)
        az = np.abs(np.nan_to_num(z))
        if gaussian:
            pvals = betainc(df / 2.0, 0.5, df / (df + az ** 2))
        else:
            pvals = np.array([math.erfc(v / math.sqrt(2.0)) for v in az])
        names = di.expanded_names + ["Intercept"]
        model.std_errs = dict(zip(names, se))
        model.z_values = dict(zip(names, z))
        model.p_values = dict(zip(names, pvals))
        model.dispersion = dispersion

    # -- the IRLS loop (`hex/glm/GLM.java:1682`) ------------------------------
    def _fit(self, Xi, y, w, offset, family, job=None):
        """IRLS over the design ``Xi`` (intercept column last): beta lives
        on the host in float64 and goes to the device as float32 on every
        step, as in the reference. Box bounds clip each solve (COD applies
        them per coordinate); linear constraints replace the solve by the
        active-set QP. Returns (beta, lambda, deviance, null deviance,
        neff, iterations)."""
        p = self.params
        P = Xi.shape[1] - 1
        dev_t = Xi.device
        step = _make_irls_kernel(family)
        alpha = p.alpha if p.alpha is not None else 0.5
        free = np.zeros(P + 1, dtype=bool)
        free[-1] = True
        bounds = getattr(self, "_bounds", None)
        lincon = getattr(self, "_lincon", None)

        beta = np.zeros(P + 1, dtype=np.float64)
        b0 = float(family.init_intercept(y, w))
        beta[-1] = b0 if p.intercept else 0.0

        mu0 = family.linkinv(torch.full_like(y, b0) + offset)
        nulldev = float(torch.sum(family.deviance(y, mu0, w)))
        neff = float(torch.sum(w))

        if p.lambda_search:
            G0, b_, _, _ = step(Xi, y, w, _on_dev(beta, dev_t), offset)
            grad0 = np.abs(b_.cpu().numpy() - G0.cpu().numpy() @ beta)[:-1]
            lmax = float(grad0.max()) / max(alpha, 1e-3) / max(neff, 1.0)
            lambdas = np.geomspace(lmax, lmax * p.lambda_min_ratio, p.nlambdas)
        else:
            lambdas = [p.lambda_ if p.lambda_ is not None else 0.0]

        if (p.solver or "IRLSM").upper() in ("L_BFGS", "LBFGS"):
            if bounds is not None:
                # the reference's restriction: L-BFGS has no projection step
                raise ValueError("beta_constraints are not supported with "
                                 "solver=L_BFGS — use IRLSM or "
                                 "COORDINATE_DESCENT")
            iters_total = 0
            result = None
            for lam in lambdas:   # the whole path, warm-started
                if job is not None:
                    job.check_cancelled()
                result = self._fit_lbfgs(Xi, y, w, offset, family, beta,
                                         float(lam), alpha, neff, nulldev,
                                         job)
                beta = result[0]
                iters_total += result[5]
            return (*result[:5], iters_total)

        use_cod = bool(p.solver) and p.solver.upper() in (
            "COORDINATE_DESCENT", "COORDINATE_DESCENT_NAIVE")
        cod_lo = cod_hi = None
        if use_cod:
            cod_lo, cod_hi = np.full(P + 1, -np.inf), np.full(P + 1, np.inf)
            if p.non_negative:
                cod_lo[:-1] = 0.0
            if bounds is not None:
                cod_lo = np.maximum(cod_lo, bounds[0])
                cod_hi = np.minimum(cod_hi, bounds[1])
        qp_in = None
        if lincon is not None:
            qp_in = _qp_inequalities(lincon, bounds, p.non_negative, P + 1)

        dev_probe = _make_dev_kernel(family)
        best = None
        iters_total = 0
        dev_path_prev = None
        admm_state: dict = {}  # (z, u) warm start across IRLS/path solves
        for lam in lambdas:
            if job is not None:
                job.check_cancelled()
                if best is not None and job.time_exceeded():
                    break   # keep the best-so-far lambda (partial path)
            l1 = alpha * lam * neff
            l2 = (1 - alpha) * lam * neff
            dev_final = None
            for it in range(max(p.max_iterations, 1)):
                if job is not None:
                    job.check_cancelled()
                    if it and job.time_exceeded():
                        break
                G, b, dev, _ = step(Xi, y, w, _on_dev(beta, dev_t), offset)
                iters_total += 1
                Gn = G.cpu().numpy().astype(np.float64)
                bn = b.cpu().numpy().astype(np.float64)
                if lincon is not None:
                    beta_new = _constrained_qp(Gn + l2 * np.eye(P + 1), bn,
                                               lincon[0], lincon[1], *qp_in)
                elif use_cod:
                    beta_new = _cod_solve(Gn, bn, l1, l2, free, beta,
                                          p.beta_epsilon, cod_lo, cod_hi)
                else:
                    beta_new = _admm_solve(Gn, bn, l1, l2, free,
                                           state=admm_state)
                if lincon is None:
                    if p.non_negative:
                        beta_new[:-1] = np.clip(beta_new[:-1], 0, None)
                    if bounds is not None:
                        beta_new = np.clip(beta_new, *bounds)
                # convergence vs the INCOMING beta, first iteration included
                diff = np.max(np.abs(beta_new - beta))
                beta = beta_new
                if diff < p.beta_epsilon:
                    dev_final = None  # beta moved since `dev` — probe below
                    break
                # deviance plateau via the cheap probe at the post-solve beta
                dev_new = float(dev_probe(Xi, y, w, _on_dev(beta, dev_t),
                                          offset))
                dev_final = dev_new
                if abs(float(dev) - dev_new) < p.objective_epsilon * abs(nulldev):
                    break
            if dev_final is None:
                dev_final = float(dev_probe(Xi, y, w, _on_dev(beta, dev_t),
                                            offset))
            dev = dev_final
            best = (beta.copy(), float(lam), dev)
            if (p.lambda_search and p.early_stopping
                    and dev_path_prev is not None
                    and dev_path_prev - dev < 1e-4 * abs(nulldev)):
                break   # lambda-search early stop (`GLM.java` _early_stop_search)
            dev_path_prev = dev
        beta, lam, dev = best
        return beta, lam, dev, nulldev, neff, iters_total

    def _fit_lbfgs(self, Xi, y, w, offset, family, beta0, lam, alpha, neff,
                   nulldev, job):
        """The L_BFGS solver (`hex/optimization/L_BFGS.java`, the GLM path
        at `hex/glm/GLM.java:2130`): minimizes ½·deviance + ½·λℓ₂‖β‖² on the
        design's device through ``optax.lbfgs()`` written out
        (``utils/optim.py``), the gradient from autograd. As in the
        reference only the ridge share of the penalty applies; its
        products are plain ``torch.matmul``, no Gram."""
        p = self.params
        l2 = (1.0 - alpha) * lam * neff if alpha < 1.0 else 0.0
        if alpha > 0 and lam > 0:
            warn("L_BFGS ignores the l1 share of the penalty "
                 "(reference behavior); use IRLSM for lasso paths")

        def value_and_grad(b):
            b = b.detach().requires_grad_(True)
            mu = family.linkinv(Xi @ b + offset)
            v = 0.5 * torch.sum(family.deviance(y, mu, w)) \
                + 0.5 * l2 * torch.sum(b[:-1] ** 2)
            g, = torch.autograd.grad(v, b)
            return np.float32(v.item()), g

        beta = _on_dev(beta0, Xi.device)
        opt = LBFGS(value_and_grad, beta)
        prev = np.inf
        iters = 0
        for i in range(max(p.max_iterations, 1) * 4):  # cheap iterations
            if job is not None:
                job.check_cancelled()
                if i and job.time_exceeded():
                    break
            beta, value, grad = opt.step(beta)
            if p.non_negative:  # projected L-BFGS (IRLSM clips likewise)
                beta[:-1] = beta[:-1].clamp(min=0)
            iters += 1
            v = float(value)
            if abs(prev - v) < p.objective_epsilon * max(abs(nulldev), 1.0):
                break
            if float(grad.abs().max()) < p.beta_epsilon:
                break
            prev = v
        with torch.no_grad():
            mu = family.linkinv(Xi @ beta + offset)
            dev = float(torch.sum(family.deviance(y, mu, w)))
        return (beta.cpu().numpy().astype(np.float64), lam, dev, nulldev,
                neff, iters)

    # -- ordinal (proportional odds) ------------------------------------------
    def _build_ordinal(self, job, names, y_dev, resp_domain):
        """Ordinal regression (the reference's `hex/glm/GLM.java` ordinal
        family): cumulative logits P(y≤k) = σ(θ_k − xβ) with thresholds kept
        ordered by a softplus reparameterization, fitted by full-batch Adam
        (``optax.adam(1e-1)`` written out, ``utils/optim.py``) on the
        design's device, the gradients from autograd; the objective is
        checked every 20 steps. Box ``beta_constraints`` project beta after
        each step."""
        p = self.params
        fr = p.training_frame
        K = len(resp_domain)
        dinfo = DataInfo.make(fr, names, standardize=p.standardize,
                              missing_values_handling=p.missing_values_handling)
        X, okrow = dinfo.expand(fr)
        y = torch.nan_to_num(y_dev)
        w = _weights(p, fr, y_dev, okrow)
        P = X.shape[1]
        dev = X.device
        lam = p.lambda_ or 0.0
        alpha = p.alpha if p.alpha is not None else 0.5
        if alpha > 0 and lam > 0:
            warn("ordinal family ignores the l1 share of the penalty "
                 "(gradient solver; same restriction as L_BFGS)")
        l2 = (1 - alpha) * lam * float(torch.sum(w))
        yk = y.to(torch.int64)[:, None]
        zeros = torch.zeros((X.shape[0], 1), device=dev)
        ones = torch.ones((X.shape[0], 1), device=dev)

        def thresholds(prm):
            # θ_1 free; θ_k = θ_{k-1} + softplus(d_k) keeps them ordered
            return prm["t0"] + torch.cat([
                torch.zeros(1, device=dev),
                torch.cumsum(torch.logaddexp(prm["d"], torch.zeros_like(
                    prm["d"])), 0)])

        def nll(prm):
            eta = X @ prm["beta"]
            cum = torch.sigmoid(thresholds(prm)[None, :] - eta[:, None])
            cdf = torch.cat([zeros, cum, ones], dim=1)
            pk = (torch.gather(cdf, 1, yk + 1)
                  - torch.gather(cdf, 1, yk))[:, 0]
            ll = torch.sum(w * torch.log(torch.clamp(pk, min=1e-12)))
            return -ll + 0.5 * l2 * torch.sum(prm["beta"] ** 2)

        prm = {"beta": torch.zeros(P, device=dev),
               "t0": torch.zeros(1, device=dev),
               "d": torch.zeros(max(K - 2, 0), device=dev)}
        opt = Adam(prm, 1e-1)
        bounds = _beta_bounds(p.beta_constraints, dinfo)
        blo = bhi = None
        if bounds is not None:
            blo = torch.from_numpy(bounds[0][:P].astype(np.float32)).to(dev)
            bhi = torch.from_numpy(bounds[1][:P].astype(np.float32)).to(dev)

        prev = np.inf
        v = np.nan
        i = -1
        for i in range(max(p.max_iterations, 1) * 10):
            job.check_cancelled()
            if i and job.time_exceeded():
                break
            for t in prm.values():
                t.requires_grad_(True)
            loss = nll(prm)
            grads = dict(zip(prm, torch.autograd.grad(loss,
                                                      list(prm.values()))))
            for t in prm.values():
                t.requires_grad_(False)
            opt.step(prm, grads)
            if blo is not None:
                prm["beta"] = torch.minimum(torch.maximum(prm["beta"], blo),
                                            bhi)
            if i % 20 == 19:
                v = float(loss.detach())
                if abs(prev - v) < p.objective_epsilon * max(abs(prev), 1.0):
                    break
                prev = v
        v = float(loss.detach()) if i >= 0 else v

        output = ModelOutput()
        output.names = names
        output.domains = {n: fr.vec(n).domain for n in names}
        output.response_domain = list(resp_domain)
        output.model_category = "Multinomial"  # ordinal scores like multiclass
        with torch.no_grad():
            th = thresholds(prm).cpu().numpy().astype(np.float64)
        model = GLMOrdinalModel(p, output, dinfo,
                                prm["beta"].cpu().numpy().astype(np.float64),
                                th)
        raw = model.score0(X)
        ym = torch.where(w > 0, y, torch.nan)
        output.training_metrics = make_metrics(
            "Multinomial", ym, raw, w if p.weights_column else None,
            auc_type=p.auc_type, domain=output.response_domain)
        output.scoring_history = [{"iterations": i + 1, "negloglik": v}]
        if p.validation_frame is not None:
            output.validation_metrics = model.model_performance(
                p.validation_frame)
        return model

    # -- multinomial (`hex/glm/GLM.java` multinomial loop) --------------------
    def _build_multinomial(self, job, names, y_dev, resp_domain):
        """Per-class block IRLS, the reference's: each class's block is a
        binomial IRLS whose offset is minus the log-sum-exp of the other
        classes' linear predictors (the softmax's block coordinate), three
        IRLS steps a class and ``max(2, min(6, max_iterations // 5))``
        sweeps over the classes. Every step is one ``gram_accumulate``
        call, so on the card each is one launch of the Gram kernel. Box
        ``beta_constraints`` clip every class block alike. As in the
        reference, ``lambda_search`` and ``non_negative`` do not act on
        this family and no validation metrics are kept (ROADMAP Queue 3)."""
        p = self.params
        fr = p.training_frame
        K = len(resp_domain)
        dinfo = DataInfo.make(
            fr, names, standardize=p.standardize,
            missing_values_handling=p.missing_values_handling)
        Xi, okrow = dinfo.expand(fr, intercept=True)
        y = torch.nan_to_num(y_dev)
        w = _weights(p, fr, y_dev, okrow)
        P = Xi.shape[1] - 1
        betas = np.zeros((K, P + 1), dtype=np.float64)
        family = BinomialF()
        step = _make_irls_kernel(family)
        free = np.zeros(P + 1, dtype=bool)
        free[-1] = True
        alpha = p.alpha if p.alpha is not None else 0.5
        lam = p.lambda_ or 0.0
        neff = float(torch.sum(w))
        bounds = _beta_bounds(p.beta_constraints, dinfo)
        classes = torch.arange(K, device=Xi.device)
        sweeps = max(2, min(6, p.max_iterations // 5))
        for _ in range(sweeps):
            job.check_cancelled()
            for k in range(K):
                eta_all = Xi @ torch.from_numpy(betas.T.astype(np.float32)
                                                ).to(Xi.device)     # (R, K)
                off = torch.logsumexp(eta_all.masked_fill(
                    classes[None, :] == k, -torch.inf), dim=1)
                yk = (y == k).to(torch.float32)
                bk = betas[k].copy()
                for _ in range(3):
                    G, b, _dev, _ = step(Xi, yk, w, _on_dev(bk, Xi.device),
                                         -off)
                    bk = _admm_solve(G.cpu().numpy().astype(np.float64),
                                     b.cpu().numpy().astype(np.float64),
                                     alpha * lam * neff,
                                     (1 - alpha) * lam * neff, free)
                    if bounds is not None:
                        bk = np.clip(bk, bounds[0], bounds[1])
                betas[k] = bk
        output = ModelOutput()
        output.names = names
        output.domains = {n: fr.vec(n).domain for n in names}
        output.response_domain = list(resp_domain)
        output.model_category = "Multinomial"
        model = GLMMultinomialModel(p, output, dinfo, betas, family)
        raw = model.score0(Xi[:, :P])
        ym = torch.where(w > 0, y, torch.nan)
        output.training_metrics = make_metrics(
            "Multinomial", ym, raw, w if p.weights_column else None,
            auc_type=p.auc_type, domain=output.response_domain)
        return model

    # -- HGLM (`hex/glm/GLM.java` HGLM path) ----------------------------------
    def _build_hglm(self, job, names, y_dev, category):
        """Hierarchical GLM — a linear mixed model with one categorical
        random intercept (`GLMModel.java:638-641` allows exactly one random
        column), fitted by the reference's EM over Henderson's equations.

        The data-sized cross products are taken once on the design's
        device, all in float64 (the reference takes them in float32):
        XᵀWX and XᵀWy as plain products, as the reference's einsums are,
        and the random column's blocks — XᵀWZ, the diagonal ZᵀWZ and ZᵀWy
        — as ``index_add_`` sums keyed by the level code (the reference
        forms them as one-hot products; Z never materializes). The (P+q)
        Henderson solves and EM updates run on the host in float64."""
        p = self.params
        fr = p.training_frame
        fam = (p.family or "AUTO").lower()
        if category != "Regression" or fam not in ("gaussian", "auto"):
            raise NotImplementedError("HGLM supports family=gaussian with a "
                                      "numeric response (the reference's "
                                      "tested path)")
        if not p.random_columns or len(p.random_columns) != 1:
            raise ValueError("HGLM requires exactly one random column "
                             "(`GLMModel.java:641`)")
        if p.rand_family and [str(f).lower() for f in p.rand_family] != [
                "gaussian"]:
            raise NotImplementedError("rand_family supports [gaussian]")
        rc = p.random_columns[0]
        rname = fr.names[int(rc)] if not isinstance(rc, str) else rc
        rvec = fr.vec(rname)
        if not rvec.is_categorical():
            raise ValueError(f"HGLM random column '{rname}' must be "
                             f"categorical")
        names = [n for n in names if n != rname]
        dinfo = DataInfo.make(fr, names, standardize=p.standardize,
                              missing_values_handling=p.missing_values_handling)
        Xi, okrow = dinfo.expand(fr, intercept=True)
        y = torch.nan_to_num(y_dev)
        w = _weights(p, fr, y_dev, okrow)
        q = len(rvec.domain)
        zi = torch.nan_to_num(rvec.data, nan=-1.0).to(torch.int64)
        # every block in float64: the intercept's Schur complement,
        # n - Σ_l n_l²/(n_l + λ), is a difference of two near-equal sums,
        # so a float32 XᵀWX beside float64 random blocks moved the
        # intercept by 1e-4 between the card and the CPU at 100,000 rows
        Xd, wd, yd = Xi.double(), w.double(), y.double()
        Xw = Xd * wd[:, None]
        XtX, Xty = (Xw.T @ Xd).cpu().numpy(), (Xw.T @ yd).cpu().numpy()
        has = zi >= 0                           # NA level: no random effect
        zk = zi[has]
        f64 = dict(dtype=torch.float64, device=Xi.device)
        XtZ = torch.zeros((q, Xi.shape[1]), **f64).index_add_(
            0, zk, Xw[has]).T.cpu().numpy()
        ZtZ = torch.zeros(q, **f64).index_add_(0, zk, wd[has]).cpu().numpy()
        Zty = torch.zeros(q, **f64).index_add_(
            0, zk, (wd * yd)[has]).cpu().numpy()
        yty = float(torch.sum(wd * yd * yd))
        del Xd, Xw
        neff = float(torch.sum(w))
        P1 = XtX.shape[0]

        # EM on variance components over Henderson's mixed-model equations
        sig_e, sig_u = 1.0, 1.0
        beta = np.zeros(P1)
        u = np.zeros(q)
        M = np.block([[XtX, XtZ], [XtZ.T, np.diag(ZtZ)]])
        rhs = np.concatenate([Xty, Zty])
        it = 0
        for it in range(max(p.max_iterations, 10)):
            job.check_cancelled()
            lam = sig_e / max(sig_u, 1e-12)
            A = M.copy()
            A[P1:, P1:] += lam * np.eye(q)
            A[np.diag_indices_from(A)] += 1e-8
            Ainv = np.linalg.inv(A)  # one factorization: solve and traces
            sol = Ainv @ rhs
            beta_new, u_new = sol[:P1], sol[P1:]
            Tuu = Ainv[P1:, P1:] * sig_e
            sse = yty - 2 * rhs @ sol + sol @ (M @ sol)
            # the standard LMM EM updates (Laird-Ware / Searle)
            sig_e_new = float((sse + sig_e * (P1 + q)
                               - lam * np.trace(Tuu)) / max(neff, 1.0))
            sig_u_new = float((u_new @ u_new + np.trace(Tuu)) / q)
            done = (abs(sig_e_new - sig_e) < 1e-8 * max(sig_e, 1.0)
                    and abs(sig_u_new - sig_u) < 1e-8 * max(sig_u, 1.0))
            beta, u = beta_new, u_new
            sig_e = max(sig_e_new, 1e-10)
            sig_u = max(sig_u_new, 1e-10)
            if done:
                break

        output = ModelOutput()
        output.names = names + [rname]
        output.domains = {n: fr.vec(n).domain for n in output.names}
        output.response_domain = None
        output.model_category = "Regression"
        model = HGLMModel(p, output, dinfo, beta, GaussianF(), u,
                          rname, list(rvec.domain))
        model.varfix = sig_e       # residual variance (`to2dTableHGLM`)
        model.varranef = sig_u     # random-effect variance
        raw = model.score0_with_ranef(Xi[:, :P1 - 1], zi)
        ym = torch.where(w > 0, y, torch.nan)
        output.training_metrics = make_metrics(
            "Regression", ym, raw, w if p.weights_column else None)
        output.scoring_history = [{"iterations": it + 1,
                                   "varfix": sig_e, "varranef": sig_u}]
        return model

    def _varimp_from_beta(self, dinfo, beta):
        mag = np.abs(np.asarray(beta)[:-1])
        if mag.sum() <= 0:
            return None
        order = np.argsort(-mag)
        return {"variable": [dinfo.expanded_names[i] for i in order],
                "relative_importance": mag[order],
                "scaled_importance": mag[order] / mag.max(),
                "percentage": mag[order] / mag.sum()}


class HGLMModel(GLMModel):
    """Mixed model y = Xβ + Zu + e. Predictions add the level's BLUP random
    intercept when the level is known; unseen/NA levels fall back to the
    fixed-effects mean, as the reference scores them."""

    def __init__(self, params, output, dinfo, beta, family, ubeta,
                 random_column, random_domain):
        super().__init__(params, output, dinfo, beta, family)
        self.ubeta = np.asarray(ubeta, np.float64)
        self.random_column = random_column
        self.random_domain = list(random_domain)

    def coef_random(self) -> dict:
        """Per-level random intercepts (the reference's ubeta table)."""
        return {lvl: float(v) for lvl, v in zip(self.random_domain,
                                                self.ubeta)}

    def score0_with_ranef(self, X, zi) -> torch.Tensor:
        beta = torch.as_tensor(self.beta, dtype=torch.float32,
                               device=X.device)
        eta = X @ beta[:-1] + beta[-1]
        ub = torch.as_tensor(self.ubeta, dtype=torch.float32,
                             device=X.device)
        q = len(self.random_domain)
        ranef = torch.where((zi >= 0) & (zi < q), ub[zi.clamp(0, q - 1)],
                            0.0)
        return eta + ranef

    def predict(self, fr) -> Frame:
        X = self.adapt_frame(fr)
        rv = (fr.vec(self.random_column)
              if self.random_column in fr.names else None)
        zi_np = np.full(X.shape[0], -1, np.int64)   # X rows are padded
        if rv is not None and rv.domain is not None:
            # the scoring frame's levels on the training domain
            lut = np.full(len(rv.domain), -1, np.int64)
            for i, lvl in enumerate(rv.domain):
                if lvl in self.random_domain:
                    lut[i] = self.random_domain.index(lvl)
            codes = np.nan_to_num(rv.to_numpy(), nan=-1.0).astype(np.int64)
            zi_np[:len(codes)] = np.where(codes >= 0,
                                          lut[np.clip(codes, 0, None)], -1)
        mu = self.score0_with_ranef(X, torch.from_numpy(zi_np).to(X.device))
        return Frame(["predict"], [Vec(mu, fr.nrow)])


class GLMOrdinalModel(GLMModel):
    """Proportional-odds model: β shared across classes + ordered
    thresholds."""

    def __init__(self, params, output, dinfo, beta, thresholds):
        super().__init__(params, output, dinfo, beta, BinomialF())
        self.thresholds = thresholds  # (K-1,) ordered cutpoints

    def coef_norm(self) -> dict:
        out = dict(zip(self.dinfo.expanded_names,
                       np.asarray(self.beta, np.float64)))
        for k, t in enumerate(self.thresholds):
            out[f"threshold_{k + 1}"] = float(t)
        return out

    def coef(self) -> dict:
        base = _destandardize(
            np.concatenate([np.asarray(self.beta, np.float64), [0.0]]),
            self.dinfo)
        out = dict(zip(self.dinfo.expanded_names, base[:-1]))
        # σ(θ − x_std·β_std) = σ((θ − c) − x_orig·β_orig) with
        # c = −Σ β_j·m_j/s_j (= base[-1]); the original-scale cutpoint is θ − c
        for k, t in enumerate(self.thresholds):
            out[f"threshold_{k + 1}"] = float(t) - float(base[-1])
        return out

    def score0(self, X: torch.Tensor) -> torch.Tensor:
        eta = X @ torch.as_tensor(self.beta, dtype=torch.float32,
                                  device=X.device)
        th = torch.as_tensor(self.thresholds, dtype=torch.float32,
                             device=X.device)
        cum = torch.sigmoid(th[None, :] - eta[:, None])
        R = X.shape[0]
        cdf = torch.cat([torch.zeros((R, 1), device=X.device), cum,
                         torch.ones((R, 1), device=X.device)], dim=1)
        probs = torch.diff(cdf, dim=1)
        label = torch.argmax(probs, dim=1).to(torch.float32)
        return torch.cat([label[:, None], probs], dim=1)


class GLMMultinomialModel(GLMModel):
    """A multinomial GLM: ``beta`` is (K, P+1), one row per class, the
    intercept last; scores are the softmax of the K linear predictors."""

    def coef(self) -> dict:
        """Per-class coefficient maps — h2o-py's coef() multinomial shape:
        {class_name: {coef_name: value}} on the original feature scale."""
        names = self.dinfo.expanded_names + ["Intercept"]
        B = _destandardize(np.asarray(self.beta, dtype=np.float64),
                           self.dinfo)
        classes = self.output.response_domain or [
            str(k) for k in range(B.shape[0])]
        return {str(c): dict(zip(names, B[k])) for k, c in enumerate(classes)}

    def coef_norm(self) -> dict:
        names = self.dinfo.expanded_names + ["Intercept"]
        B = np.asarray(self.beta)
        classes = self.output.response_domain or [
            str(k) for k in range(B.shape[0])]
        return {str(c): dict(zip(names, B[k])) for k, c in enumerate(classes)}

    def score0(self, X: torch.Tensor) -> torch.Tensor:
        B = torch.as_tensor(self.beta, dtype=torch.float32,
                            device=X.device)            # (K, P+1)
        eta = X @ B[:, :-1].T + B[:, -1][None, :]
        probs = torch.softmax(eta, dim=1)
        label = torch.argmax(probs, dim=1).to(torch.float32)
        return torch.cat([label[:, None], probs], dim=1)
