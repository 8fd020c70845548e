"""Intersectional fairness metrics — `water/rapids/ast/prims/models/
AstFairnessMetrics.java` rebuilt on the host over one scoring pass
(``h2o_tpu/rapids/fairness.py``).

The prim scores the frame once, buckets rows by the cross-product of the
protected columns' codes (+1 slot per column for NA), and produces:

- an ``overview`` frame: per non-empty group, the protected-column codes,
  the FairnessMetrics fields in the reference's declared order (tp, fp, tn,
  fn, total, relativeSize, accuracy, precision, f1, tpr, tnr, fpr, fnr, auc,
  aucpr, gini, selected, selectedRatio, logloss), the adverse-impact ratios
  ``AIR_<metric>`` against the reference group for everything except
  total/relativeSize, and ``p.value`` — Fisher's exact test on the 2x2
  selected-vs-reference table below the 10k-population threshold, the G-test
  above it (same switch and the R-compatible 1+1e-7 relative tolerance the
  Java uses).
- one ``thresholds_and_metrics_<group>`` frame per group: the binomial
  threshold/criteria table from the group's scores (the AUC2 ROC-info
  analog).

The scoring pass runs on the frame's device; the rest is stdlib+numpy: the
hypergeometric mass goes through lgamma, the G-test p-value through erfc
(chi-square sf at 1 dof). Result frames go to the frame's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, Vec

#: FairnessMetrics field order (`AstFairnessMetrics.FairnessMetrics`)
_FIELDS = ["tp", "fp", "tn", "fn", "total", "relativeSize", "accuracy",
           "precision", "f1", "tpr", "tnr", "fpr", "fnr", "auc", "aucpr",
           "gini", "selected", "selectedRatio", "logloss"]
_SKIP_AIR = {"total", "relativeSize"}
_GTEST_THRESHOLD = 10_000
_FISHER_REL = 1 + 1e-7


def _auc_np(y: np.ndarray, p: np.ndarray) -> tuple[float, float]:
    """(auc, pr_auc) host-side: rank-statistic AUC with tie-averaged ranks,
    trapezoidal PR AUC over the threshold sweep."""
    npos = int(y.sum())
    nneg = len(y) - npos
    if npos == 0 or nneg == 0:
        return float("nan"), float("nan")
    order = np.argsort(p, kind="stable")
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    ps = p[order]
    # average ranks over ties
    uniq, start = np.unique(ps, return_index=True)
    for i, s in enumerate(start):
        e = start[i + 1] if i + 1 < len(start) else len(ps)
        if e - s > 1:
            ranks[order[s:e]] = (s + 1 + e) / 2.0
    auc = (ranks[y == 1].sum() - npos * (npos + 1) / 2.0) / (npos * nneg)
    # PR curve at descending unique thresholds
    desc = np.argsort(-p, kind="stable")
    yd = y[desc]
    tps = np.cumsum(yd)
    fps = np.cumsum(1 - yd)
    prec = tps / np.maximum(tps + fps, 1)
    rec = tps / npos
    pr_auc = float(np.trapezoid(prec, rec))
    return float(auc), pr_auc


def _fisher_exact(a: int, b: int, c: int, d: int) -> float:
    """Two-sided Fisher's exact test on [[a,b],[c,d]], summing all outcome
    probabilities ≤ p(observed)·(1+1e-7) like R / the reference."""
    n = a + b + c + d
    K = a + b     # selected margin
    N = a + c     # protected-group margin
    denom = math.lgamma(n + 1) - math.lgamma(N + 1) - math.lgamma(n - N + 1)

    def logp(i):
        if i < 0 or i > K or N - i > n - K:
            return -math.inf
        return (math.lgamma(K + 1) - math.lgamma(i + 1)
                - math.lgamma(K - i + 1)
                + math.lgamma(n - K + 1) - math.lgamma(N - i + 1)
                - math.lgamma(n - K - (N - i) + 1) - denom)

    p0 = math.exp(logp(a))
    pv = 0.0
    for i in range(max(a - d, 0), min(K, N) + 1):
        pi = math.exp(logp(i))
        if pi <= p0 * _FISHER_REL:
            pv += pi
    return min(pv, 1.0)


def _g_test(a: int, b: int, c: int, d: int) -> float:
    """G-test of independence on the 2x2 table; p from the chi-square
    survival at 1 dof (erfc(sqrt(G/2)))."""
    n = a + b + c + d
    rows = (a + b, c + d)
    cols = (a + c, b + d)
    exp_a = rows[0] * cols[0] / n
    exp_b = rows[0] * cols[1] / n
    exp_c = rows[1] * cols[0] / n
    exp_d = rows[1] * cols[1] / n
    g = 0.0
    for obs, exp in ((a, exp_a), (b, exp_b), (c, exp_c), (d, exp_d)):
        if obs > 0:
            g += obs * math.log(obs / exp)
    g *= 2.0
    return math.erfc(math.sqrt(max(g, 0.0) / 2.0))


def _p_value(ref: dict, grp: dict) -> float:
    a = int(grp["selected"])
    b = int(ref["selected"])
    c = int(grp["total"] - grp["selected"])
    d = int(ref["total"] - ref["selected"])
    try:
        if (ref["total"] < _GTEST_THRESHOLD
                and grp["total"] < _GTEST_THRESHOLD) \
                or a == 0 or b == 0 or c == 0 or d == 0:
            return _fisher_exact(a, b, c, d)
        return _g_test(a, b, c, d)
    except (ValueError, OverflowError):
        return float("nan")


def fairness_metrics(model, fr: Frame, protected_columns, reference,
                     favorable_class) -> dict:
    """Returns {name: Frame} with 'overview' + per-group threshold tables
    (`AstFairnessMetrics.apply`)."""
    from ..models.metrics import make_binomial_metrics

    if model.output.model_category != "Binomial":
        raise ValueError("Model has to be a binomial model!")
    pcols = list(protected_columns)
    for pc in pcols:
        if pc not in fr.names:
            raise ValueError(f"{pc} was not found in the frame!")
        if not fr.vec(pc).is_categorical():
            raise ValueError(f"{pc} has to be a categorical column!")
    resp = model.params.response_column
    dom = fr.vec(resp).domain or []
    if favorable_class not in dom:
        raise ValueError("Favourable class is not present in the response!")
    fav = dom.index(favorable_class)
    if reference is not None and len(reference) != len(pcols):
        raise ValueError(
            f"reference must name one level per protected column "
            f"({len(pcols)} expected, got {len(reference)})")
    if reference is not None:
        ref_idx = []
        for pc, rv in zip(pcols, reference):
            d = fr.vec(pc).domain
            if rv not in d:
                raise ValueError(
                    "Reference group is not present in the protected column")
            ref_idx.append(d.index(rv))
    else:
        ref_idx = None

    cards = [len(fr.vec(pc).domain) + 1 for pc in pcols]  # +1 = NA slot
    if float(np.prod(cards)) > 1e6:
        raise ValueError("Too many combinations of categories! Maximum "
                         "number of category combinations is 1e6.")

    # one scoring pass
    pred = model.predict(fr)
    plabel = pred.vec(0).to_numpy()
    p_fav = pred.vec(1 + fav).to_numpy()  # [label, p0, p1] layout
    y_raw = fr.vec(resp).to_numpy()
    ok = ~np.isnan(y_raw)
    y = np.where(ok, y_raw, 0).astype(np.int64)
    # favourable class becomes "1" (the reference flips labels when fav==0)
    yb = (y == fav).astype(np.int64)
    predb = (plabel.astype(np.int64) == fav).astype(np.int64)
    prob = np.clip(p_fav, 1e-15, 1 - 1e-15)

    # group keys: mixed-radix over protected codes, NA -> card-1 slot
    key = np.zeros(fr.nrow, dtype=np.int64)
    base = 1
    codes_per_col = []
    for pc, card in zip(pcols, cards):
        cc = fr.vec(pc).to_numpy()
        idx = np.where(np.isnan(cc), card - 1, cc).astype(np.int64)
        codes_per_col.append(idx)
        key += idx * base
        base *= card
    key = key[ok]
    yb, predb, prob = yb[ok], predb[ok], prob[ok]
    nrows = float(ok.sum())

    maxk = int(np.prod(cards))
    tp = np.bincount(key, weights=(yb & predb), minlength=maxk)
    tn = np.bincount(key, weights=((1 - yb) & (1 - predb)), minlength=maxk)
    fp = np.bincount(key, weights=((1 - yb) & predb), minlength=maxk)
    fn = np.bincount(key, weights=(yb & (1 - predb)), minlength=maxk)
    lls = np.bincount(key, weights=-(yb * np.log(prob)
                                     + (1 - yb) * np.log(1 - prob)),
                      minlength=maxk)

    def metrics_of(k) -> dict | None:
        t, n_, f, m_ = tp[k], tn[k], fp[k], fn[k]
        total = t + n_ + f + m_
        if total == 0:
            return None
        sel = key == k
        auc, aucpr = _auc_np(yb[sel], prob[sel])
        out = {
            "tp": t, "fp": f, "tn": n_, "fn": m_, "total": total,
            "relativeSize": total / nrows,
            "accuracy": (t + n_) / total,
            "precision": t / (f + t) if (f + t) else float("nan"),
            "f1": (2 * t) / (2 * t + f + m_) if (2 * t + f + m_)
            else float("nan"),
            "tpr": t / (t + m_) if (t + m_) else float("nan"),
            "tnr": n_ / (n_ + f) if (n_ + f) else float("nan"),
            "fpr": f / (f + n_) if (f + n_) else float("nan"),
            "fnr": m_ / (m_ + t) if (m_ + t) else float("nan"),
            "auc": auc, "aucpr": aucpr, "gini": 2 * auc - 1,
            "selected": t + f,
            "selectedRatio": (t + f) / total,
            "logloss": lls[k] / total,
        }
        return out

    groups = {k: m for k in range(maxk)
              if (m := metrics_of(k)) is not None}
    if ref_idx is not None:
        rk = 0
        b_ = 1
        for i, card in zip(ref_idx, cards):
            rk += i * b_
            b_ *= card
    else:
        rk = max(groups, key=lambda k: groups[k]["total"])
    ref = groups.get(rk)
    if ref is None:
        raise ValueError("reference group has no rows in the frame")

    def decode(k):
        out = []
        for card in cards:
            v = k % card
            k //= card
            out.append(float("nan") if v == card - 1 else float(v))
        return out

    # overview frame
    names = list(pcols) + list(_FIELDS) \
        + [f"AIR_{f}" for f in _FIELDS if f not in _SKIP_AIR] + ["p.value"]
    rows = []
    for k, m in groups.items():
        dec = decode(k)
        air = [m[f] / ref[f] if ref[f] else float("nan")
               for f in _FIELDS if f not in _SKIP_AIR]
        rows.append(dec + [m[f] for f in _FIELDS] + air + [_p_value(ref, m)])
    A = np.array(rows, dtype=np.float64)
    dev = fr.device
    vecs = []
    for j, nm in enumerate(names):
        col = A[:, j].astype(np.float32)
        if j < len(pcols):
            vecs.append(Vec.from_numpy(col, type=T_CAT,
                                       domain=list(fr.vec(pcols[j]).domain),
                                       device=dev))
        else:
            vecs.append(Vec.from_numpy(col, device=dev))
    result = {"overview": Frame(names, vecs)}

    # per-group threshold/criteria tables (the ROC-info frames); the
    # metrics object stores them as a dict of column arrays
    for k in groups:
        sel = key == k
        if not sel.any():
            continue
        mm = make_binomial_metrics(
            torch.from_numpy(yb[sel].astype(np.float32)).to(dev),
            torch.from_numpy(prob[sel].astype(np.float32)).to(dev))
        t = getattr(mm, "thresholds_and_metric_scores", None)
        if t is None:
            continue
        labels = []
        kk = k
        for pc, card in zip(pcols, cards):
            v = kk % card
            kk //= card
            labels.append("NaN" if v == card - 1
                          else str(fr.vec(pc).domain[v]))
        gname = "".join(ch if ch.isalnum() or ch == "," else "_"
                        for ch in ",".join(labels))
        result[f"thresholds_and_metrics_{gname}"] = Frame.from_dict(
            {cn: np.asarray(cv, dtype=np.float32)
             for cn, cv in t.items()}, device=dev)
    return result
