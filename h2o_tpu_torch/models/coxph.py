"""CoxPH — Cox proportional hazards regression (``h2o_tpu/models/coxph.py``).

`hex/coxph/` (`CoxPH.java`, `CoxPHTask`): Newton iterations on the partial
log-likelihood with Efron or Breslow ties and stratification. After one
sort of the rows by (stratum, stop time) — the reference's stable
``np.lexsort``, on the host — every risk-set quantity is a suffix sum, and
both Hessian sums over the risk sets are weighted Gram products:

- S0/S1 suffix sums give each (stratum, time) group's denominators; the
  tied deaths' sums D0/D1 and the per-group scalars are segment sums. The
  groups are contiguous after the sort, so a segment sum is a difference
  of two prefix sums. On the card every prefix sum is a blocked product
  with a triangular matrix of ones (``_blocked_cumsum``): ``torch.cumsum``'s
  card scan, like float ``index_add_``, adds in an order that changes
  between runs, and a fit must give the same bits twice. In float64 the
  differences keep ~1e-10 of a group's sum.
- Σ_g a_g·S2_g == Xᵀ diag(r·ω) X with ω_j = Σ_{g ≤ group(j)} a_g (within
  the stratum), and the tied-death term is Xᵀ diag(evr·b_g) X: two calls of
  the Gram kernel's z = None form (``gram_accumulate``) a Newton pass. The
  Efron outer term is a plain product.

The design, its coefficients and the linear predictor are float32 as in the
reference; the per-row risk sums, the segment sums, the log-likelihood and
the gradient are float64 (the reference's float32 suffix sums lose their
low bits to ``s - s[stratum end]``). The Efron fractions l/d come from one
vectorised pass (each death's rank among its group's deaths over their
count), equal to the reference's per-group loop. The Newton step, the
standard errors and the Breslow baseline hazard run on the host in
float64, as in the reference.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch

from ..backend.kernels.gram import gram_accumulate
from ..frame.frame import Frame
from ..frame.vec import Vec
from ..parallel.mesh import resolve_device
from .datainfo import DataInfo
from .glm import _apply_interactions, _freeze_interaction_pairs
from .model_base import Model, ModelBuilder, ModelOutput, Parameters


@dataclass
class CoxPHParameters(Parameters):
    """Mirrors `hex/schemas/CoxPHV3`."""

    start_column: str | None = None
    stop_column: str | None = None
    stratify_by: list = None
    ties: str = "efron"  # efron | breslow
    max_iterations: int = 20
    lre: float = 9.0     # -log10 relative tolerance (reference default)
    use_all_factor_levels: bool = False
    interactions: list = None        # pairwise interactions among columns
    interaction_pairs: list = None   # explicit (a, b) pairs


def efron_fractions(gid: np.ndarray, ev: np.ndarray) -> np.ndarray:
    """l/d for each death of a tie group of d > 1 deaths (l its rank among
    them, in row order), 0 elsewhere: the reference's loop over groups
    (``coxph.py:261-265``) in one pass over the sorted rows."""
    isd = ev > 0
    d = np.bincount(gid, weights=isd)
    cum = np.cumsum(isd)
    first = np.concatenate([[True], gid[1:] != gid[:-1]])
    before = (cum - isd)[np.flatnonzero(first)]    # deaths before each group
    rank = cum - 1 - before[gid]
    dg = d[gid]
    return np.where(isd & (dg > 1), rank / np.maximum(dg, 1), 0.0)


#: rows per block of the card's prefix sums
_SCAN_ROWS = 1024


def _blocked_cumsum(v):
    """Inclusive prefix sums of ``v`` along dim 0: each block of
    ``_SCAN_ROWS`` rows summed by one product with a triangular matrix of
    ones, then the blocks' carries likewise (a fixed order of adds)."""
    R = v.shape[0]
    B = min(_SCAN_ROWS, R)
    nb = -(-R // B)
    x = v.new_zeros((nb * B,) + v.shape[1:])
    x[:R] = v
    x = x.reshape(nb, B, -1)
    tri = torch.ones((B, B), dtype=v.dtype, device=v.device).tril()
    inner = tri @ x
    if nb > 1:
        tot = inner[:, -1]
        inner = inner + (_blocked_cumsum(tot) - tot)[:, None]
    return inner.reshape((nb * B,) + v.shape[1:])[:R]


def _cumsum(v):
    """Inclusive prefix sums along dim 0, the same bits on every run. On
    the CPU ``torch.cumsum`` (sequential); on the card its scan combines
    partial sums in an order that changes between runs, so
    ``_blocked_cumsum``."""
    if v.device.type == "cpu":
        return torch.cumsum(v, dim=0)
    return _blocked_cumsum(v)


def _segment_sums(v, gstart, gend):
    """Per-group sums of float64 ``v`` (rows grouped contiguously): prefix
    sums differenced at the group bounds."""
    cs = torch.cat([torch.zeros((1,) + v.shape[1:], dtype=v.dtype,
                                device=v.device), _cumsum(v)])
    return cs[gend] - cs[gstart]


def _cox_pass(X, w, event, frac, gid, gstart, gend, strat_end,
              grp_strat_first, beta):
    """One Newton pass over rows sorted by (stratum, time).

    X (R, P) float32 standardized; w, event, frac (R,) float64 (frac = l/d
    per death under Efron, 0 under Breslow); gid (R,) each row's (stratum,
    time) group; gstart/gend (G,) the groups' row bounds; strat_end (R,)
    one past the row's stratum; grp_strat_first (R,) the first group of
    the row's stratum. Returns (loglik, grad (P,), hess (P, P)), float64.
    """
    f64 = torch.float64
    R = X.shape[0]
    eta = (X @ beta).to(f64)
    X64 = X.to(f64)
    r = w * torch.exp(eta)

    def suffix_within(v):
        """Σ_{k >= j, same stratum} v[k]: global suffix minus stratum end."""
        s = torch.flip(_cumsum(torch.flip(v, [0])), [0])
        s_pad = torch.cat([s, torch.zeros((1,) + v.shape[1:], dtype=f64,
                                          device=v.device)])
        return s - s_pad[strat_end]

    # every row of a group shares the group head's suffix values
    is_head = torch.cat([torch.ones((1,), dtype=torch.bool, device=X.device),
                         gid[1:] != gid[:-1]])
    idx = torch.arange(R, device=X.device)
    head_idx = torch.cummax(torch.where(is_head, idx, 0), dim=0).values
    S0 = suffix_within(r)[head_idx]
    S1 = suffix_within(r[:, None] * X64)[head_idx]

    # tied-death sums per group
    evr = event * r
    D0 = _segment_sums(evr, gstart, gend)[gid]
    D1 = _segment_sums(evr[:, None] * X64, gstart, gend)[gid]

    denom = torch.clamp(S0 - frac * D0, min=1e-30)
    isd = event > 0
    inv = torch.where(isd, 1.0 / denom, 0.0)
    num1 = S1 - frac[:, None] * D1               # per-death numerator (R,P)

    loglik = torch.sum(torch.where(isd, w * (eta - torch.log(denom)), 0.0))
    grad = ((X64 * (event * w)[:, None]).sum(0)
            - torch.sum(w[:, None] * num1 * inv[:, None], 0))

    # Hessian = Σ_deaths [(S2 - f·D2)/denom − num1·num1ᵀ/denom²], the S2
    # and D2 sums as two Gram launches (z = None form)
    a_g = _segment_sums(w * inv, gstart, gend)
    cum_a = _cumsum(a_g)
    omega = cum_a[gid] - (cum_a - a_g)[grp_strat_first]
    H_S2, _ = gram_accumulate(X, (r * omega).to(torch.float32))
    b_g = _segment_sums(w * frac * inv, gstart, gend)
    H_D2, _ = gram_accumulate(X, (evr * b_g[gid]).to(torch.float32))
    outer = num1.T @ (num1 * (w * inv * inv)[:, None])
    hess = -(H_S2.to(f64) - H_D2.to(f64) - outer)
    return loglik, grad, hess


class CoxPHMetrics:
    """The training summary (`hex/coxph` model output): log-likelihood,
    coefficients, standard errors, hazard ratios, rows, events and
    Harrell's concordance."""

    def __init__(self, loglik, coefficients, se_coef, n, n_events,
                 concordance):
        self.loglik = loglik
        self.coefficients = coefficients
        self.se_coef = se_coef
        self.hazard_ratios = {k: float(np.exp(v))
                              for k, v in coefficients.items()}
        self.n = n
        self.n_events = n_events
        self.concordance = concordance

    def __repr__(self):
        return (f"CoxPHMetrics(loglik={self.loglik:.4f}, "
                f"concordance={self.concordance:.4f})")


class CoxPHModel(Model):
    algo_name = "coxph"
    baseline = None  # {stratum_code: (event_times, cumulative_hazard)}
    strata_cols = None
    interaction_spec = None  # frozen interaction pairs (GLM-shared)
    newton_passes = None     # Newton passes of the fit

    def __init__(self, params, output, beta, dinfo, mean_x, key=None):
        super().__init__(params, output, key=key)
        self.beta = beta        # (P,) float32 tensor, the raw scale
        self.dinfo = dinfo
        self.mean_x = mean_x    # (P,) float32 tensor: lp is centred (R)
        self._strat_base = {}

    @staticmethod
    def from_reference(ref, device=None) -> "CoxPHModel":
        """Carry a JAX-trained CoxPH over: ``beta``, ``mean_x``, the
        ``DataInfo`` fields, the baseline hazard per stratum, the strata
        columns and their bases, and the frozen interaction spec."""
        dev = resolve_device(device)
        f32 = np.float32
        model = CoxPHModel(
            CoxPHParameters(stratify_by=list(ref.strata_cols or []),
                            response_column=ref.params.response_column),
            ModelOutput.carried(ref.output),
            torch.from_numpy(np.array(ref.beta, f32)).to(dev),
            DataInfo.carried(ref.dinfo),
            torch.from_numpy(np.array(ref.mean_x, f32)).to(dev))
        model.baseline = {int(k): (np.array(t, np.float64),
                                   np.array(h, np.float64))
                          for k, (t, h) in ref.baseline.items()}
        model.strata_cols = list(ref.strata_cols or [])
        model._strat_base = dict(ref._strat_base)
        model.interaction_spec = copy.deepcopy(ref.interaction_spec)
        model.coefficients = dict(ref.coefficients)
        return model

    def predict(self, fr: Frame) -> Frame:
        if self.interaction_spec:
            fr, _ = _apply_interactions(fr, self.interaction_spec,
                                        skip_existing=True)
        X, _ = self.dinfo.expand(fr)
        lp = (X - self.mean_x.to(X.device)) @ self.beta.to(X.device)
        return Frame(["lp"], [Vec(lp, fr.nrow)])

    def baseline_hazard_frame(self) -> Frame:
        """Breslow cumulative baseline hazard per stratum (R ``basehaz``),
        on the model's device."""
        if not self.baseline:
            raise ValueError("no baseline hazard stored")
        dev = self.beta.device
        ts, hs, ks = [], [], []
        for k, (t, h) in sorted(self.baseline.items()):
            ts.append(t)
            hs.append(h)
            ks.append(np.full(len(t), float(k)))
        out = Frame(["t", "cumhaz"],
                    [Vec.from_numpy(np.concatenate(ts), device=dev),
                     Vec.from_numpy(np.concatenate(hs), device=dev)])
        if len(self.baseline) > 1:
            out.add("stratum", Vec.from_numpy(np.concatenate(ks), device=dev))
        return out

    def survfit(self, fr: Frame, max_rows: int = 1000) -> Frame:
        """Per-row survival curves S(t|x) = exp(−H0(t)·exp(lp)) over the
        training event times (R ``survfit.coxph``): columns t, then one
        survival column per scoring row."""
        if fr.nrow > max_rows:
            raise ValueError(f"survfit: frame has {fr.nrow} rows; cap is "
                             f"{max_rows} (curves are per-row columns)")
        lp = np.asarray(self.predict(fr).vec(0).to_numpy(), np.float64)
        if not self.strata_cols:
            (only_key,) = self.baseline.keys()
            strat = np.full(fr.nrow, only_key, np.int64)
        else:  # replay the training stratum encoding
            strat = np.zeros(fr.nrow, dtype=np.int64)
            for s in self.strata_cols:
                sv = fr.vec(s).to_numpy()
                strat = strat * (self._strat_base[s]) + np.where(
                    np.isnan(sv), 0, sv + 1).astype(np.int64)
        tgrid = np.unique(np.concatenate(
            [t for t, _ in self.baseline.values()]))
        dev = fr.device
        cols = [Vec.from_numpy(tgrid.astype(np.float64), device=dev)]
        names = ["t"]
        for i in range(fr.nrow):
            k = int(strat[i])
            if k not in self.baseline:
                raise ValueError(f"survfit: unseen stratum for row {i}")
            t, h = self.baseline[k]
            # the Breslow estimator is a right-continuous step function
            idx = np.searchsorted(t, tgrid, side="right") - 1
            H = np.where(idx >= 0, h[np.clip(idx, 0, None)], 0.0)
            cols.append(Vec.from_numpy(np.exp(-H * np.exp(lp[i])),
                                       device=dev))
            names.append(f"surv_{i}")
        return Frame(names, cols)


class CoxPH(ModelBuilder):
    algo_name = "coxph"

    def build_impl(self, job) -> CoxPHModel:
        p: CoxPHParameters = self.params
        fr = p.training_frame
        if not p.stop_column:
            raise ValueError("coxph: stop_column is required")
        skip = {p.stop_column, p.start_column, p.response_column}
        skip |= set(p.stratify_by or [])
        names = [n for n in self.feature_names() if n not in skip]
        inter_spec = None
        if p.interactions or p.interaction_pairs:
            reserved = {p.response_column, p.weights_column, p.offset_column,
                        p.start_column, p.stop_column} | set(p.stratify_by
                                                             or [])
            inter_spec = _freeze_interaction_pairs(
                fr, p.interactions, p.interaction_pairs, reserved)
            fr, extra = _apply_interactions(fr, inter_spec)
            names = names + extra

        dinfo = DataInfo.make(fr, names, standardize=False,
                              use_all_factor_levels=p.use_all_factor_levels)
        X_full, okrow = dinfo.expand(fr)
        dev = X_full.device
        nrow = fr.nrow

        t_stop = fr.vec(p.stop_column).to_numpy().astype(np.float64)
        event = fr.vec(p.response_column).to_numpy().astype(np.float64)
        w = (np.nan_to_num(fr.vec(p.weights_column).to_numpy())
             if p.weights_column else np.ones(nrow))
        strata = np.zeros(nrow, dtype=np.int64)
        strat_bases = {}
        for s in (p.stratify_by or []):
            sv = fr.vec(s).to_numpy()
            strat_bases[s] = int(np.nanmax(sv)) + 2
            strata = strata * strat_bases[s] + \
                np.where(np.isnan(sv), 0, sv + 1).astype(np.int64)

        ok = ~(np.isnan(t_stop) | np.isnan(event)) & (w > 0)
        ok &= okrow[:nrow].cpu().numpy()
        order = np.lexsort((t_stop, strata))   # stable: ties keep row order
        order = order[ok[order]]
        R = len(order)
        X = X_full[:nrow].cpu().numpy()[order]
        tt = t_stop[order]
        ss = strata[order]
        ev = event[order]
        ww = w[order]

        # group ids per (stratum, time); Efron fraction l/d per death
        new_group = np.concatenate([[True], (tt[1:] != tt[:-1])
                                    | (ss[1:] != ss[:-1])])
        gid = np.cumsum(new_group) - 1
        gstart = np.flatnonzero(new_group)
        gend = np.append(gstart[1:], R)
        strat_change = np.concatenate([[True], ss[1:] != ss[:-1]])
        strat_id = np.cumsum(strat_change) - 1
        ends = np.concatenate([np.where(strat_change)[0][1:], [R]])
        strat_end = ends[strat_id]                  # 1 past each row's stratum
        first_group = gid[np.where(strat_change)[0]]
        grp_strat_first = first_group[strat_id]     # first group of stratum
        frac = (efron_fractions(gid, ev)
                if (p.ties or "efron").lower() == "efron" else np.zeros(R))

        P = X.shape[1]
        # standardize for conditioning; coefficients rescaled back after
        mu = X.mean(axis=0)
        sd = X.std(axis=0)
        sd[sd == 0] = 1.0
        Xs = ((X - mu) / sd).astype(np.float32)

        def put(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)

        i64, f64 = np.int64, np.float64
        args = (put(Xs, np.float32), put(ww, f64), put(ev, f64),
                put(frac, f64), put(gid, i64), put(gstart, i64),
                put(gend, i64), put(strat_end, i64), put(grp_strat_first, i64))
        beta = torch.zeros((P,), dtype=torch.float32, device=dev)
        prev_ll = -np.inf
        ll = hess = None
        passes = 0
        for _it in range(max(p.max_iterations, 1)):
            job.check_cancelled()
            ll_t, grad, hess = _cox_pass(*args, beta)
            passes += 1
            ll = float(ll_t)
            H = hess.cpu().numpy()          # loglik Hessian (neg. def.)
            g = grad.cpu().numpy()
            try:
                step = np.linalg.solve(-H + 1e-8 * np.eye(P), g)
            except np.linalg.LinAlgError:
                step = np.linalg.lstsq(-H, g, rcond=None)[0]
            beta = beta + torch.from_numpy(step.astype(np.float32)).to(dev)
            if abs(ll - prev_ll) <= 10.0 ** (-p.lre) * (abs(ll) + 1e-10):
                break
            prev_ll = ll

        beta_np = beta.cpu().numpy().astype(np.float64) / sd
        se = None
        try:
            cov = np.linalg.inv(-hess.cpu().numpy())
            se = np.sqrt(np.maximum(np.diag(cov), 0.0)) / sd
        except np.linalg.LinAlgError:
            pass

        output = ModelOutput()
        output.names = names
        output.domains = {n: fr.vec(n).domain for n in names}
        output.model_category = "CoxPH"
        coefs = dict(zip(dinfo.expanded_names, beta_np))
        output.training_metrics = CoxPHMetrics(
            ll, coefs,
            None if se is None else dict(zip(dinfo.expanded_names, se)),
            R, int(ev.sum()), _concordance(X @ beta_np, tt, ev, ss))
        model = CoxPHModel(p, output, put(beta_np, np.float32), dinfo,
                           put(mu, np.float32))
        model.interaction_spec = inter_spec
        model.coefficients = coefs
        model.newton_passes = passes   # two Gram launches each

        # Breslow cumulative baseline hazard per stratum: dH0(t) = Σ w·event
        # at t / Σ_{risk set} w·exp(lp), risk sets via within-stratum suffix
        # sums over the time-sorted rows
        risk = ww * np.exp((X - mu) @ beta_np)
        rev = np.cumsum(risk[::-1])[::-1]
        sfx = rev - np.append(rev, 0.0)[strat_end]
        denom = sfx[gstart]
        dsum = np.bincount(gid, weights=ww * (ev > 0))
        dh = np.where(denom > 0, dsum / np.maximum(denom, 1e-300), 0.0)
        g_times = tt[gstart]
        g_strat = ss[gstart]
        model.baseline = {int(k): (g_times[g_strat == k].astype(np.float64),
                                   np.cumsum(dh[g_strat == k]))
                          for k in np.unique(g_strat)}
        model.strata_cols = list(p.stratify_by or [])
        model._strat_base = strat_bases
        return model


def _concordance(lp, tt, ev, ss, cap: int = 4000):
    """Harrell's C on (a sample of) comparable pairs — the reference
    reports it."""
    n = len(lp)
    if n > cap:
        idx = np.random.default_rng(0).choice(n, cap, replace=False)
        lp, tt, ev, ss = lp[idx], tt[idx], ev[idx], ss[idx]
    conc = ties = tot = 0
    for i in range(len(lp)):
        if ev[i] <= 0:
            continue
        cmp = (tt > tt[i]) & (ss == ss[i])
        tot += cmp.sum()
        conc += (lp[cmp] < lp[i]).sum()
        ties += (lp[cmp] == lp[i]).sum()
    return float((conc + 0.5 * ties) / tot) if tot else float("nan")
