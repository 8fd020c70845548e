"""Model metrics (``h2o_tpu/models/metrics.py``): binomial, multinomial
and regression.

Binomial AUC follows the reference's ``hex/AUC2.java`` design: a 1024-bin
threshold histogram of weighted positives and negatives, cumulated from the
top bin down, trapezoid-integrated, and the threshold criteria (F1, ...)
read off the same bins. The device computes the histogram and the sums;
the ROC arithmetic runs on the host in numpy, as in the reference. The
histogram is a sorted float64 running sum (no float atomics), so metrics
are deterministic on the card; the max-criteria and gains/lift tables are
read off the same bins. Multinomial metrics (logloss, confusion matrix,
hit ratios) are sums over rows, also free of atomics. The multinomial AUC
family (``auc_type`` MACRO_OVR, WEIGHTED_OVR, MACRO_OVO, WEIGHTED_OVO;
``hex/MultinomialAUC.java``) is the exact rank statistic: one sort per
class, tie groups resolved by binary search, sums in float64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..utils.twodimtable import TwoDimTable

NBINS = 1024


@dataclass
class ModelMetrics:
    mse: float = np.nan
    rmse: float = np.nan
    nobs: int = 0
    description: str = ""


@dataclass
class ModelMetricsRegression(ModelMetrics):
    mae: float = np.nan
    rmsle: float = np.nan
    r2: float = np.nan
    mean_residual_deviance: float = np.nan


@dataclass
class ModelMetricsBinomial(ModelMetrics):
    auc: float = np.nan
    pr_auc: float = np.nan
    gini: float = np.nan
    logloss: float = np.nan
    mean_per_class_error: float = np.nan
    ks: float = np.nan
    max_f1: float = np.nan
    max_f1_threshold: float = np.nan
    confusion_matrix: Any = None  # 2x2 [[tn, fp], [fn, tp]] at max-F1
    thresholds_and_metric_scores: Any = None
    max_criteria_and_metric_scores: Any = None   # TwoDimTable
    gains_lift_table: Any = None                 # TwoDimTable


@dataclass
class ModelMetricsMultinomial(ModelMetrics):
    logloss: float = np.nan
    mean_per_class_error: float = np.nan
    confusion_matrix: Any = None   # (K, K) weighted counts, actual x predicted
    hit_ratio_table: Any = None    # (K,) share of rows whose class is in the top j
    # `hex/MultinomialAUC.java`: filled when auc_type is not AUTO/NONE
    auc: float = np.nan
    pr_auc: float = np.nan
    auc_type: str = "none"
    _mauc: Any = None              # MultinomialAUC (every aggregate)

    @property
    def multinomial_auc_table(self):
        return self._mauc.table(pr=False) if self._mauc else None

    def auc_by_type(self, auc_type: str) -> float:
        """Any aggregate on demand (`MultinomialAUC.getAucTable`)."""
        return self._mauc.get(auc_type, pr=False) if self._mauc else np.nan

    def pr_auc_by_type(self, auc_type: str) -> float:
        return self._mauc.get(auc_type, pr=True) if self._mauc else np.nan


def _weights(y, weights):
    """Row weights with NaN responses (NA and padding) dropped."""
    base = (~torch.isnan(y)).to(torch.float32)
    return base * torch.nan_to_num(weights) if weights is not None else base


def _binomial_hist(y, p, w):
    """Per-bin weighted positives/negatives over NBINS thresholds plus the
    logloss and squared-error sums (the reference's _binomial_hist_kernel)."""
    pc = torch.clamp(p, 1e-15, 1 - 1e-15)
    logloss = torch.sum(-w * (y * torch.log(pc) + (1 - y) * torch.log(1 - pc)))
    bins = torch.clamp(p * NBINS, 0, NBINS - 1).to(torch.int64)
    pn = torch.stack([w * y, w * (1 - y)], dim=1)                 # (R, 2)
    # per-bin sums as differences of a float64 running sum over the rows
    # sorted by bin: deterministic on the card (stable sort, integer
    # counts, no float atomics)
    cs = torch.cumsum(pn[torch.argsort(bins, stable=True)].double(), dim=0)
    cs = torch.cat([cs.new_zeros((1, 2)), cs])
    ends = torch.cumsum(torch.bincount(bins, minlength=NBINS), dim=0)
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    hist = (cs[ends] - cs[starts]).to(torch.float32)
    err = p - y
    sums = torch.stack([logloss, torch.sum(w), torch.sum(w * err * err),
                        torch.sum(w * y), torch.sum(w * (1 - y))])
    return hist.cpu().numpy(), sums.cpu().numpy()


def make_binomial_metrics(y, p, weights=None) -> ModelMetricsBinomial:
    """y in {0,1} (NaN = NA/padding), p = P(class 1)."""
    w = _weights(y, weights)
    hist, sums = _binomial_hist(torch.nan_to_num(y), torch.nan_to_num(p), w)
    pos, neg = hist[:, 0], hist[:, 1]
    logloss, n, mse_sum, npos, nneg = (float(v) for v in sums)
    # cumulative from the top bin down: predictions >= threshold are positive
    tp = np.cumsum(pos[::-1])[::-1]
    fp = np.cumsum(neg[::-1])[::-1]
    tn = nneg - fp
    fn = npos - tp
    tpr = tp / max(npos, 1e-10)
    fpr = fp / max(nneg, 1e-10)
    auc = float(-np.trapezoid(np.concatenate([tpr, [0.0]]),
                              np.concatenate([fpr, [0.0]])))
    precision = tp / np.maximum(tp + fp, 1e-10)
    recall = tpr
    order = np.argsort(recall)
    pr_auc = float(np.trapezoid(precision[order], recall[order]))
    # the `hex/AUC2.java` ThresholdCriterion family over every bin
    f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-10)
    f2 = 5 * precision * recall / np.maximum(4 * precision + recall, 1e-10)
    f0point5 = 1.25 * precision * recall / np.maximum(
        0.25 * precision + recall, 1e-10)
    accuracy = (tp + tn) / max(n, 1e-10)
    mcc_den = np.sqrt(np.maximum((tp + fp) * (tp + fn) * (tn + fp)
                                 * (tn + fn), 1e-10))
    absolute_mcc = np.abs((tp * tn - fp * fn) / mcc_den)
    specificity = tn / max(nneg, 1e-10)
    best = int(np.argmax(f1))
    mse = mse_sum / max(n, 1e-10)
    scores = dict(thresholds=np.arange(NBINS) / NBINS, f1=f1, f2=f2,
                  f0point5=f0point5, accuracy=accuracy, precision=precision,
                  recall=recall, tpr=tpr, fpr=fpr, specificity=specificity,
                  absolute_mcc=absolute_mcc,
                  min_per_class_accuracy=np.minimum(tpr, specificity),
                  mean_per_class_accuracy=0.5 * (tpr + specificity),
                  tps=tp, fps=fp, tns=tn, fns=fn)
    return ModelMetricsBinomial(
        mse=mse, rmse=float(np.sqrt(mse)), nobs=int(n),
        auc=auc, pr_auc=pr_auc, gini=2 * auc - 1,
        logloss=logloss / max(n, 1e-10),
        mean_per_class_error=float(0.5 * (fp[best] / max(nneg, 1e-10)
                                          + fn[best] / max(npos, 1e-10))),
        ks=float(np.max(tpr - fpr)),
        max_f1=float(f1[best]), max_f1_threshold=best / NBINS,
        confusion_matrix=np.array([[tn[best], fp[best]], [fn[best], tp[best]]]),
        thresholds_and_metric_scores=scores,
        max_criteria_and_metric_scores=_max_criteria_table(scores),
        gains_lift_table=_gains_lift(pos, neg, npos, n))


_MAX_CRITERIA = ("f1", "f2", "f0point5", "accuracy", "precision", "recall",
                 "specificity", "absolute_mcc", "min_per_class_accuracy",
                 "mean_per_class_accuracy")


def _max_criteria_table(scores) -> TwoDimTable:
    """`hex/AUC2.java` maxCriteria: each criterion's best value and its
    threshold."""
    rows = []
    for crit in _MAX_CRITERIA:
        v = scores[crit]
        i = int(np.nanargmax(v))
        rows.append([f"max {crit}", float(scores["thresholds"][i]),
                     float(v[i]), i])
    return TwoDimTable(
        table_header="Maximum Metrics",
        description="Maximum metrics at their respective thresholds",
        col_header=["metric", "threshold", "value", "idx"],
        col_types=["string", "double", "double", "long"], cell_values=rows)


def _gains_lift(pos, neg, npos, n, groups: int = 16):
    """`hex/GainsLift.java`: 16 groups of predicted probability, top
    first, cut from the AUC's threshold histogram at each n/16 rows, with
    capture and response rates and lift. None without positives."""
    if npos <= 0 or n <= 0:
        return None
    cum = np.cumsum((pos + neg)[::-1])   # weighted rows from the top bin
    cum_pos = np.cumsum(pos[::-1])
    idx = np.minimum(np.searchsorted(
        cum, n * (np.arange(1, groups + 1) / groups) - 1e-9), len(cum) - 1)
    rows, prev_rows, prev_pos = [], 0.0, 0.0
    overall_rate = npos / n
    for g in range(groups):
        c_rows, c_pos = float(cum[idx[g]]), float(cum_pos[idx[g]])
        g_rows, g_pos = c_rows - prev_rows, c_pos - prev_pos
        if g_rows <= 0:
            prev_rows, prev_pos = c_rows, c_pos
            continue
        resp_rate, cum_resp_rate = g_pos / g_rows, c_pos / c_rows
        lift = resp_rate / overall_rate
        cum_lift = cum_resp_rate / overall_rate
        rows.append([g + 1, c_rows / n, 1.0 - (idx[g] + 1) / NBINS,
                     resp_rate, cum_resp_rate, g_pos / npos, c_pos / npos,
                     lift, cum_lift, 100.0 * (lift - 1),
                     100.0 * (cum_lift - 1)])
        prev_rows, prev_pos = c_rows, c_pos
    return TwoDimTable(
        table_header="Gains/Lift Table",
        description="Avg response rate: %5.2f %%" % (100 * overall_rate),
        col_header=["group", "cumulative_data_fraction", "lower_threshold",
                    "response_rate", "cumulative_response_rate",
                    "capture_rate", "cumulative_capture_rate", "lift",
                    "cumulative_lift", "gain", "cumulative_gain"],
        col_types=["long"] + ["double"] * 10, cell_values=rows)


def make_regression_metrics(y, pred, weights=None) -> ModelMetricsRegression:
    w = _weights(y, weights)
    y = torch.nan_to_num(y)
    pred = torch.nan_to_num(pred)
    n = torch.sum(w)
    err = pred - y
    ok_log = (y > -1) & (pred > -1)
    lw = torch.where(ok_log, w, 0.0)
    sums = torch.stack([
        n, torch.sum(w * err * err) / n, torch.sum(w * torch.abs(err)) / n,
        torch.sum(w * (y - torch.sum(w * y) / n) ** 2) / n,
        torch.sum(torch.where(ok_log, w * (torch.log1p(pred)
                                           - torch.log1p(y)) ** 2, 0.0))
        / torch.clamp(torch.sum(lw), min=1e-10)]).cpu().numpy()
    n, mse, mae, ss_tot, rmsle2 = (float(v) for v in sums)
    return ModelMetricsRegression(
        mse=mse, rmse=float(np.sqrt(mse)), nobs=int(n), mae=mae,
        rmsle=float(np.sqrt(max(rmsle2, 0.0))),
        r2=1.0 - mse / ss_tot if ss_tot > 0 else np.nan,
        mean_residual_deviance=mse)


def _multinomial_sums(y, probs, w):
    """The reference's ``_multinomial_kernel``: logloss, the weighted
    confusion matrix, the hit-ratio counts and the squared-error sum. The
    hit order comes from a stable argsort of -p, so tied classes rank by
    index as in ``jnp.argsort``."""
    k = probs.shape[1]
    yi = y.to(torch.int64)
    y1h = (yi[:, None] == torch.arange(k, device=y.device)).to(torch.float32)
    py = torch.clamp(torch.gather(probs, 1, yi[:, None])[:, 0], 1e-15, 1.0)
    logloss = torch.sum(-w * torch.log(py))
    pred = torch.argmax(probs, dim=1)
    p1h = (pred[:, None] == torch.arange(k, device=y.device)).to(torch.float32)
    cm = ((y1h * w[:, None])[:, :, None] * p1h[:, None, :]).sum(dim=0)
    order = torch.argsort(-probs, dim=1, stable=True)
    hit_at = torch.cumsum((order == yi[:, None]).to(torch.float32), dim=1)
    hits = torch.sum(w[:, None] * hit_at, dim=0)
    mse = torch.sum(w * torch.sum((probs - y1h) ** 2, dim=1))
    sums = torch.stack([logloss, torch.sum(w), mse])
    return cm.cpu().numpy(), hits.cpu().numpy(), sums.cpu().numpy()


def _mauc_sums(y, probs, w, K: int):
    """The reference's ``_mauc_kernel``: per class k, sort p_k once and
    carry the (R, K) per-true-class weights through running sums; tie
    groups come from binary searches, so the AUC is the exact rank
    statistic. Returns the directed ROC numerators (K, K), the pairwise
    and one-vs-rest average precisions and the class weights N, in
    float64 (deterministic on the card: no float atomics)."""
    yi = y.to(torch.int64)
    Wm = ((yi[:, None] == torch.arange(K, device=y.device)).double()
          * w.double()[:, None])                               # (R, K)
    N = Wm.sum(dim=0)
    s_roc, ap_pair, ap_ovr = [], [], []
    for k in range(K):
        pk = probs[:, k].contiguous()
        order = torch.argsort(pk, stable=True)
        ps = pk[order]
        Ws = Wm[order]
        cum = torch.cumsum(Ws, dim=0)
        left = torch.searchsorted(ps, ps, right=False)
        right = torch.searchsorted(ps, ps, right=True)
        before = torch.where((left > 0)[:, None],
                             cum[torch.clamp(left - 1, min=0)], 0.0)
        tied = cum[right - 1] - before
        wpos = Ws[:, k]
        s_roc.append(torch.sum(wpos[:, None] * (before + 0.5 * tied), dim=0))
        nk = N[k]
        tp_end = nk - before[:, k]
        fp_end = N[None, :] - before
        contrib = wpos / torch.clamp(nk, min=1e-10)
        ap_pair.append(torch.sum(contrib[:, None] * tp_end[:, None]
                                 / torch.clamp(tp_end[:, None] + fp_end,
                                               min=1e-10), dim=0))
        fp_ovr = torch.sum(fp_end, dim=1) - tp_end
        ap_ovr.append(torch.sum(contrib * tp_end
                                / torch.clamp(tp_end + fp_ovr, min=1e-10)))
    out = [torch.stack(s_roc), torch.stack(ap_pair), torch.stack(ap_ovr), N]
    return [o.cpu().numpy() for o in out]


_AUC_TYPES = ("macro_ovr", "weighted_ovr", "macro_ovo", "weighted_ovo")


class MultinomialAUC:
    """Host aggregation of the sums: every ``auc_type`` aggregate. OVO
    pairwise AUC is the mean of the two directed AUCs
    (`hex/PairwiseAUC.java`); WEIGHTED_OVO pair weights are (N_i + N_j) /
    ((K - 1) N) (`MultinomialAUC.java` computeWeightedOVO)."""

    def __init__(self, s_roc, ap_pair, ap_ovr, N, domain=None):
        K = len(N)
        self.K = K
        self.N = N
        self.domain = (list(domain) if domain is not None
                       else [str(i) for i in range(K)])
        ntot = N.sum()
        nneg = ntot - N
        with np.errstate(divide="ignore", invalid="ignore"):
            auc_ovr = s_roc.sum(axis=1) - np.diag(s_roc)
            self.auc_ovr = np.where(N * nneg > 0,
                                    auc_ovr / np.maximum(N * nneg, 1e-30),
                                    np.nan)
            denom = N[:, None] * N[None, :]
            auc_dir = np.where(denom > 0, s_roc / np.maximum(denom, 1e-30),
                               np.nan)
        self.auc_pair = 0.5 * (auc_dir + auc_dir.T)
        self.ap_ovr = ap_ovr
        self.ap_pair_sym = 0.5 * (ap_pair + ap_pair.T)
        prev = N / max(ntot, 1e-30)
        iu = np.triu_indices(K, 1)
        pair_w = (N[iu[0]] + N[iu[1]]) / max((K - 1) * ntot, 1e-30)
        self._agg = {}
        for pr, ovr, pair in ((False, self.auc_ovr, self.auc_pair),
                              (True, self.ap_ovr, self.ap_pair_sym)):
            vals = pair[iu]
            self._agg[("macro_ovr", pr)] = float(np.nanmean(ovr))
            self._agg[("weighted_ovr", pr)] = float(np.nansum(prev * ovr))
            self._agg[("macro_ovo", pr)] = float(np.nanmean(vals))
            self._agg[("weighted_ovo", pr)] = float(np.nansum(pair_w * vals))
        self._iu = iu

    def get(self, auc_type: str, pr: bool = False) -> float:
        t = auc_type.lower()
        if t in ("auto", "none"):
            return np.nan
        if t not in _AUC_TYPES:
            raise ValueError(f"unknown auc_type '{auc_type}' "
                             f"(one of {_AUC_TYPES})")
        return self._agg[(t, pr)]

    def table(self, pr: bool = False) -> TwoDimTable:
        """OVR rows, OVO rows and the four aggregates
        (`MultinomialAUC.getTable`)."""
        ovr = self.ap_ovr if pr else self.auc_ovr
        pair = self.ap_pair_sym if pr else self.auc_pair
        rows = [[f"{self.domain[k]} vs Rest", float(ovr[k])]
                for k in range(self.K)]
        rows += [[f"{self.domain[i]} vs {self.domain[j]}", float(pair[i, j])]
                 for i, j in zip(*self._iu)]
        rows += [[t, self._agg[(t, pr)]] for t in _AUC_TYPES]
        name = "PR AUC" if pr else "AUC"
        return TwoDimTable(
            table_header=f"Multinomial {name} values",
            description="One-vs-Rest, One-vs-One and aggregated "
                        f"{name} (`hex/MultinomialAUC.java`)",
            col_header=["auc_kind", name.lower().replace(" ", "_")],
            col_types=["string", "double"], cell_values=rows)


def make_multinomial_auc(y, probs, weights=None, domain=None
                         ) -> MultinomialAUC:
    K = int(probs.shape[1])
    w = _weights(y, weights)
    return MultinomialAUC(*_mauc_sums(torch.nan_to_num(y),
                                      torch.nan_to_num(probs), w, K),
                          domain=domain)


def make_multinomial_metrics(y, probs, weights=None, auc_type: str = "AUTO",
                             domain=None) -> ModelMetricsMultinomial:
    """y class codes (NaN = NA/padding), probs (R, K) class probabilities.
    ``auc_type`` other than AUTO/NONE adds the multinomial AUC family."""
    w = _weights(y, weights)
    cm, hits, sums = _multinomial_sums(torch.nan_to_num(y), probs, w)
    logloss, n, mse = (float(v) for v in sums)
    per_class_err = 1.0 - np.diag(cm) / np.maximum(cm.sum(axis=1), 1e-10)
    mm = ModelMetricsMultinomial(
        mse=mse / max(n, 1e-10), rmse=float(np.sqrt(mse / max(n, 1e-10))),
        nobs=int(n), logloss=logloss / max(n, 1e-10),
        mean_per_class_error=float(per_class_err.mean()),
        confusion_matrix=cm, hit_ratio_table=hits / max(n, 1e-10))
    at = (auc_type or "AUTO").lower()
    if at not in ("auto", "none"):
        mauc = make_multinomial_auc(y, probs, weights, domain)
        mm._mauc = mauc
        mm.auc_type = at
        mm.auc = mauc.get(at, pr=False)
        mm.pr_auc = mauc.get(at, pr=True)
    return mm


def make_metrics(category, y, raw, weights=None, auc_type="AUTO",
                 domain=None):
    if category == "Binomial":
        return make_binomial_metrics(y, raw[:, 2], weights)
    if category == "Multinomial":
        return make_multinomial_metrics(y, raw[:, 1:], weights,
                                        auc_type=auc_type, domain=domain)
    return make_regression_metrics(y, raw, weights)
