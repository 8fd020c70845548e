"""Model metrics (``h2o_tpu/models/metrics.py``): binomial, multinomial
and regression.

Binomial AUC follows the reference's ``hex/AUC2.java`` design: a 1024-bin
threshold histogram of weighted positives and negatives, cumulated from the
top bin down, trapezoid-integrated, and the threshold criteria (F1, ...)
read off the same bins. The device computes the histogram and the sums;
the ROC arithmetic runs on the host in numpy, as in the reference. The
histogram is a sorted float64 running sum (no float atomics), so metrics
are deterministic on the card. Multinomial metrics (logloss, confusion
matrix, hit ratios) are sums over rows, also free of atomics. The
max-criteria and gains/lift tables wait for the port of
``utils/twodimtable.py``, and the multinomial AUC family
(``MultinomialAUC``) for a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

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


@dataclass
class ModelMetricsMultinomial(ModelMetrics):
    logloss: float = np.nan
    mean_per_class_error: float = np.nan
    confusion_matrix: Any = None   # (K, K) weighted counts, actual x predicted
    hit_ratio_table: Any = None    # (K,) share of rows whose class is in the top j
    auc: float = np.nan            # the AUC family is not ported: always NaN
    pr_auc: float = np.nan
    auc_type: str = "none"


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
    order = np.argsort(tpr)
    pr_auc = float(np.trapezoid(precision[order], tpr[order]))
    f1 = 2 * precision * tpr / np.maximum(precision + tpr, 1e-10)
    specificity = tn / max(nneg, 1e-10)
    best = int(np.argmax(f1))
    mse = mse_sum / max(n, 1e-10)
    scores = dict(thresholds=np.arange(NBINS) / NBINS, f1=f1,
                  precision=precision, recall=tpr, tpr=tpr, fpr=fpr,
                  specificity=specificity, tps=tp, fps=fp, tns=tn, fns=fn)
    return ModelMetricsBinomial(
        mse=mse, rmse=float(np.sqrt(mse)), nobs=int(n),
        auc=auc, pr_auc=pr_auc, gini=2 * auc - 1,
        logloss=logloss / max(n, 1e-10),
        mean_per_class_error=float(0.5 * (fp[best] / max(nneg, 1e-10)
                                          + fn[best] / max(npos, 1e-10))),
        ks=float(np.max(tpr - fpr)),
        max_f1=float(f1[best]), max_f1_threshold=best / NBINS,
        confusion_matrix=np.array([[tn[best], fp[best]], [fn[best], tp[best]]]),
        thresholds_and_metric_scores=scores)


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


def check_auc_type(auc_type) -> None:
    """Multinomial AUC is opt-in in the reference (``auc_type`` other than
    AUTO/NONE builds ``MultinomialAUC``); the port refuses it."""
    if (auc_type or "AUTO").lower() not in ("auto", "none"):
        raise NotImplementedError(
            f"multinomial AUC (auc_type='{auc_type}') is not ported yet "
            f"(ROADMAP Queue 1 item 6)")


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


def make_multinomial_metrics(y, probs, weights=None,
                             auc_type: str = "AUTO") -> ModelMetricsMultinomial:
    """y class codes (NaN = NA/padding), probs (R, K) class probabilities."""
    check_auc_type(auc_type)
    w = _weights(y, weights)
    cm, hits, sums = _multinomial_sums(torch.nan_to_num(y), probs, w)
    logloss, n, mse = (float(v) for v in sums)
    per_class_err = 1.0 - np.diag(cm) / np.maximum(cm.sum(axis=1), 1e-10)
    return ModelMetricsMultinomial(
        mse=mse / max(n, 1e-10), rmse=float(np.sqrt(mse / max(n, 1e-10))),
        nobs=int(n), logloss=logloss / max(n, 1e-10),
        mean_per_class_error=float(per_class_err.mean()),
        confusion_matrix=cm, hit_ratio_table=hits / max(n, 1e-10))


def make_metrics(category, y, raw, weights=None, auc_type="AUTO"):
    if category == "Binomial":
        return make_binomial_metrics(y, raw[:, 2], weights)
    if category == "Multinomial":
        return make_multinomial_metrics(y, raw[:, 1:], weights,
                                        auc_type=auc_type)
    return make_regression_metrics(y, raw, weights)
