"""GLM — generalized linear models via Gram + IRLS (``h2o_tpu/models/glm.py``),
single-block families through the IRLSM and COORDINATE_DESCENT solvers,
with and without ``lambda_search``, and the multinomial family as the
reference's per-class block IRLS (``GLM._build_multinomial``).

The expensive part of every IRLS iteration — XᵀWX and XᵀWz over the (R, P+1)
design with its intercept column — is one call of the Gram kernel
(``backend/kernels/gram.py``: the hand-written Hopper kernel on the card, the
plain blocked version on the CPU); the linear predictor ``X @ beta`` is a
plain ``torch.matmul``, as the reference leaves it to XLA. The small P×P
solve runs on the host, as in the reference (`hex/glm/GLM.java:1743`): ADMM
over the Cholesky-like inverse in float64, or Gauss-Seidel coordinate
descent in float32. Families: gaussian, binomial, quasibinomial, poisson,
gamma, tweedie, negativebinomial, multinomial. Ordinal, HGLM, interactions,
constraints, p-values, L-BFGS, feature parallelism, alpha arrays and ``ml``
dispersion raise ``NotImplementedError`` naming ROADMAP Queue 1 item 8.

Float32 matrix products stay in full float32: the caller's
``torch.backends.cuda.matmul.allow_tf32`` must be False (PyTorch's default),
or the IRLS coefficients drift.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..backend.kernels.gram import gram_accumulate
from ..parallel.mesh import resolve_device
from .datainfo import DataInfo
from .metrics import make_metrics
from .model_base import Model, ModelBuilder, ModelOutput, Parameters

_TODO = "ROADMAP Queue 1 item 8"


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
# dispersion
# ---------------------------------------------------------------------------
def _estimate_dispersion(p, family, y, mu, w, dev, neff, rank) -> float:
    """Dispersion φ per `dispersion_parameter_method`
    (`hex/glm/GLMModel.java:528`): pearson or deviance; ``ml`` is refused
    at validation."""
    if p.fix_dispersion_parameter:
        return float(p.init_dispersion_parameter)
    method = (p.dispersion_parameter_method or "pearson").lower()
    df = max(neff - rank, 1.0)
    if method == "deviance":
        return float(dev) / df
    return _estimate_dispersion_pearson(family, np.asarray(y),
                                        np.asarray(mu), np.asarray(w), df)


def _estimate_dispersion_pearson(family, y, mu, w, df) -> float:
    V = family.variance(torch.from_numpy(np.asarray(mu))).numpy()
    resid2 = w * (y - mu) ** 2 / np.maximum(V, 1e-12)
    return float(np.nansum(resid2) / df)


# ---------------------------------------------------------------------------
# parameters / model / builder
# ---------------------------------------------------------------------------
@dataclass
class GLMParameters(Parameters):
    """The reference's GLM fields and defaults (`hex/schemas/GLMV3`)."""

    family: str = "AUTO"
    link: str | None = None
    solver: str = "IRLSM"          # IRLSM | COORDINATE_DESCENT | L_BFGS
    alpha: float | None = None     # elastic-net mix; default .5 like reference
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
    HGLM: bool = False
    random_columns: list = None
    rand_family: list = None
    interactions: list = None
    interaction_pairs: list = None
    beta_constraints: object = None
    linear_constraints: object = None
    constraint_eta0: float = 0.1258925
    constraint_tau: float = 10.0
    constraint_c0: float = 10.0
    constraint_alpha: float = 0.1
    constraint_beta: float = 0.9
    max_iterations: int = 50
    beta_epsilon: float = 1e-5
    objective_epsilon: float = 1e-6
    tweedie_variance_power: float = 1.5
    theta: float = 1.0
    missing_values_handling: str = "MeanImputation"
    compute_p_values: bool = False
    feature_parallelism: int = 1


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

    def __init__(self, params, output, dinfo: DataInfo, beta, family):
        super().__init__(params, output)
        self.dinfo = dinfo
        self.beta = beta        # (P+1,) float64 host array, intercept LAST
        self.family = family

    @staticmethod
    def from_reference(ref, device=None) -> "GLMModel":
        """Carry a JAX-trained GLM over from its plain fields: ``beta``
        (intercept last), the ``DataInfo`` fields, the family's name, link
        and powers, and the output's names, domains, category and response
        domain. ``device`` is checked as every entry point checks it; the
        model holds host arrays only and scores on the frame's device. Given
        the same frame, the carried model scores what the reference
        scores."""
        resolve_device(device)
        di = DataInfo.carried(ref.dinfo)
        fam = ref.family
        cls = _FAMILIES.get(fam.name)
        kind = type(ref).__name__
        if cls is None or kind not in ("GLMModel", "GLMMultinomialModel"):
            what = fam.name if cls is None else kind
            raise NotImplementedError(f"{what} GLMs are not ported yet "
                                      f"({_TODO})")
        powers = dict(tweedie_variance_power=getattr(fam, "p", 1.5),
                      theta=getattr(fam, "theta", 1.0))
        family = cls(fam.link_name, **powers)
        out = ModelOutput.carried(ref.output)
        multi = kind == "GLMMultinomialModel"
        params = GLMParameters(family="multinomial" if multi else fam.name,
                               link=fam.link_name,
                               standardize=di.standardize,
                               missing_values_handling=di.missing_values_handling,
                               **powers)
        model_cls = GLMMultinomialModel if multi else GLMModel
        return model_cls(params, out, di,
                         np.asarray(ref.beta, np.float64).copy(), family)

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
        X, _ok = self.dinfo.expand(self.pre_adapt(fr))
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


class GLM(ModelBuilder):
    algo_name = "glm"
    _offset_supported = True   # `glm.py:1233-1234`

    def _validate(self):
        super()._validate()
        p = self.params
        fam = (p.family or "AUTO").lower()
        refusals = (
            (fam == "ordinal", "the ordinal family"),
            (p.HGLM, "HGLM"),
            (p.interactions or p.interaction_pairs, "interactions"),
            (p.beta_constraints is not None, "beta_constraints"),
            (p.linear_constraints is not None, "linear_constraints"),
            (p.compute_p_values, "compute_p_values"),
            ((p.solver or "IRLSM").upper() in ("L_BFGS", "LBFGS"),
             "the L_BFGS solver"),
            (p.feature_parallelism > 1, "feature_parallelism > 1"),
            (isinstance(p.alpha, (list, tuple)), "alpha given as a list"),
            ((p.dispersion_parameter_method or "pearson").lower() == "ml",
             "dispersion_parameter_method='ml'"))
        for bad, what in refusals:
            if bad:
                raise NotImplementedError(f"glm: {what} is not ported yet "
                                          f"({_TODO})")

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
        fr = p.training_frame
        names = self.feature_names()
        y_dev, category, resp_domain = self.response_info()
        if category == "Multinomial":
            return self._build_multinomial(job, names, y_dev, resp_domain)
        family = self._family(category)

        dinfo = DataInfo.make(fr, names, standardize=p.standardize,
                              missing_values_handling=p.missing_values_handling)
        Xi, okrow = dinfo.expand(fr, intercept=True)
        y = torch.nan_to_num(y_dev)
        w = (~torch.isnan(y_dev)).to(torch.float32) * okrow.to(torch.float32)
        if p.weights_column:
            w = w * torch.nan_to_num(fr.vec(p.weights_column).data)
        offset = (torch.nan_to_num(fr.vec(p.offset_column).data)
                  if p.offset_column else torch.zeros_like(y))

        beta, lambda_used, dev, nulldev, neff, iters = self._fit(
            Xi, y, w, offset, family, job)
        X = Xi[:, :dinfo.ncols_expanded]

        output = ModelOutput()
        output.names = names
        output.domains = {n: fr.vec(n).domain for n in names}
        output.response_domain = list(resp_domain) if resp_domain else None
        output.model_category = category
        model = GLMModel(p, output, dinfo, beta, family)
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
        if family.name in ("gaussian", "gamma", "tweedie", "negativebinomial",
                           "quasibinomial"):
            mu = raw if raw.ndim == 1 else raw[:, -1]
            model.dispersion_estimated = _estimate_dispersion(
                p, family, ym.cpu().numpy(), mu.cpu().numpy(),
                w.cpu().numpy(), float(dev), float(neff), len(beta))
        if p.validation_frame is not None:
            output.validation_metrics = model.model_performance(
                p.validation_frame)
        return model

    # -- the IRLS loop (`hex/glm/GLM.java:1682`) ------------------------------
    def _fit(self, Xi, y, w, offset, family, job=None):
        """IRLS over the design ``Xi`` (intercept column last): beta lives
        on the host in float64 and goes to the device as float32 on every
        step, as in the reference. Returns (beta, lambda, deviance, null
        deviance, neff, iterations)."""
        p = self.params
        P = Xi.shape[1] - 1
        dev_t = Xi.device
        step = _make_irls_kernel(family)
        alpha = p.alpha if p.alpha is not None else 0.5
        free = np.zeros(P + 1, dtype=bool)
        free[-1] = True

        def on_dev(beta):
            return torch.from_numpy(beta.astype(np.float32)).to(dev_t)

        beta = np.zeros(P + 1, dtype=np.float64)
        b0 = float(family.init_intercept(y, w))
        beta[-1] = b0 if p.intercept else 0.0

        mu0 = family.linkinv(torch.full_like(y, b0) + offset)
        nulldev = float(torch.sum(family.deviance(y, mu0, w)))
        neff = float(torch.sum(w))

        if p.lambda_search:
            G0, b_, _, _ = step(Xi, y, w, on_dev(beta), offset)
            grad0 = np.abs(b_.cpu().numpy() - G0.cpu().numpy() @ beta)[:-1]
            lmax = float(grad0.max()) / max(alpha, 1e-3) / max(neff, 1.0)
            lambdas = np.geomspace(lmax, lmax * p.lambda_min_ratio, p.nlambdas)
        else:
            lambdas = [p.lambda_ if p.lambda_ is not None else 0.0]

        use_cod = bool(p.solver) and p.solver.upper() in (
            "COORDINATE_DESCENT", "COORDINATE_DESCENT_NAIVE")
        cod_lo = cod_hi = None
        if use_cod:
            cod_lo, cod_hi = np.full(P + 1, -np.inf), np.full(P + 1, np.inf)
            if p.non_negative:
                cod_lo[:-1] = 0.0

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
                G, b, dev, _ = step(Xi, y, w, on_dev(beta), offset)
                iters_total += 1
                Gn = G.cpu().numpy().astype(np.float64)
                bn = b.cpu().numpy().astype(np.float64)
                if use_cod:
                    beta_new = _cod_solve(Gn, bn, l1, l2, free, beta,
                                          p.beta_epsilon, cod_lo, cod_hi)
                else:
                    beta_new = _admm_solve(Gn, bn, l1, l2, free,
                                           state=admm_state)
                if p.non_negative:
                    beta_new[:-1] = np.clip(beta_new[:-1], 0, None)
                # convergence vs the INCOMING beta, first iteration included
                diff = np.max(np.abs(beta_new - beta))
                beta = beta_new
                if diff < p.beta_epsilon:
                    dev_final = None  # beta moved since `dev` — probe below
                    break
                # deviance plateau via the cheap probe at the post-solve beta
                dev_new = float(dev_probe(Xi, y, w, on_dev(beta), offset))
                dev_final = dev_new
                if abs(float(dev) - dev_new) < p.objective_epsilon * abs(nulldev):
                    break
            if dev_final is None:
                dev_final = float(dev_probe(Xi, y, w, on_dev(beta), offset))
            dev = dev_final
            best = (beta.copy(), float(lam), dev)
            if (p.lambda_search and p.early_stopping
                    and dev_path_prev is not None
                    and dev_path_prev - dev < 1e-4 * abs(nulldev)):
                break   # lambda-search early stop (`GLM.java` _early_stop_search)
            dev_path_prev = dev
        beta, lam, dev = best
        return beta, lam, dev, nulldev, neff, iters_total

    # -- multinomial (`hex/glm/GLM.java` multinomial loop) --------------------
    def _build_multinomial(self, job, names, y_dev, resp_domain):
        """Per-class block IRLS, the reference's: each class's block is a
        binomial IRLS whose offset is minus the log-sum-exp of the other
        classes' linear predictors (the softmax's block coordinate), three
        IRLS steps a class and ``max(2, min(6, max_iterations // 5))``
        sweeps over the classes. Every step is one ``gram_accumulate``
        call, so on the card each is one launch of the Gram kernel. As in
        the reference, ``lambda_search`` and ``non_negative`` do not act on
        this family and no validation metrics are kept (ROADMAP Queue 3)."""
        p = self.params
        fr = p.training_frame
        K = len(resp_domain)
        dinfo = DataInfo.make(
            fr, names, standardize=p.standardize,
            missing_values_handling=p.missing_values_handling)
        Xi, okrow = dinfo.expand(fr, intercept=True)
        y = torch.nan_to_num(y_dev)
        w = (~torch.isnan(y_dev)).to(torch.float32) * okrow.to(torch.float32)
        if p.weights_column:
            w = w * torch.nan_to_num(fr.vec(p.weights_column).data)
        P = Xi.shape[1] - 1
        betas = np.zeros((K, P + 1), dtype=np.float64)
        family = BinomialF()
        step = _make_irls_kernel(family)
        free = np.zeros(P + 1, dtype=bool)
        free[-1] = True
        alpha = p.alpha if p.alpha is not None else 0.5
        lam = p.lambda_ or 0.0
        neff = float(torch.sum(w))
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
                    G, b, _dev, _ = step(
                        Xi, yk, w, torch.from_numpy(bk.astype(np.float32)
                                                    ).to(Xi.device), -off)
                    bk = _admm_solve(G.cpu().numpy().astype(np.float64),
                                     b.cpu().numpy().astype(np.float64),
                                     alpha * lam * neff,
                                     (1 - alpha) * lam * neff, free)
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

    def _varimp_from_beta(self, dinfo, beta):
        mag = np.abs(np.asarray(beta)[:-1])
        if mag.sum() <= 0:
            return None
        order = np.argsort(-mag)
        return {"variable": [dinfo.expanded_names[i] for i in order],
                "relative_importance": mag[order],
                "scaled_importance": mag[order] / mag.max(),
                "percentage": mag[order] / mag.sum()}


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
