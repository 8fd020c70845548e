"""GroupBy — `water/rapids/ast/prims/mungers/AstGroup` analog
(``h2o_tpu/rapids/groupby.py``).

Group keys are factorized into dense group ids on the host with
``np.unique``, as the reference does; groups come out sorted by key, an NA
key sorting last. The aggregates reduce on the frame's device in a fixed
order: the rows are sorted by group id once (a stable integer sort), then
every segment is reduced by ``torch.segment_reduce`` in float64, one
sequential pass per segment, so no float atomic is involved and two runs
give the same bits. The reference's float32 ``segment_sum`` family reduces
in whatever order XLA picks.

Supported aggs mirror AstGroup: nrow (count), sum, mean, min, max, sd/var,
sumSquares, mode (categorical); NA handling per agg: "all" (NAs poison),
"rm" (drop), "ignore" (== rm for these aggs). sd and var come from the
centred second moment of each group (a second pass over the rows).
"""

from __future__ import annotations

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_INT, Vec


#: a key whose values are integers in [0, this) factorizes by counting
_DENSE_KEYS = 1 << 25


def _unique_inverse(c: np.ndarray):
    """``np.unique(c, return_inverse=True, return_counts=True)`` of a
    float64 key column (+inf sorting last); by a ``bincount`` over the
    values where they are small non-negative integers (categorical codes),
    which gives the same groups in the same order without a sort."""
    fin = c[np.isfinite(c)]
    if (len(fin) and len(fin) + int(np.isposinf(c).sum()) == len(c)
            and fin.min() >= 0 and fin.max() < _DENSE_KEYS
            and np.array_equal(fin, np.floor(fin))):
        top = int(fin.max()) + 1
        codes = np.where(np.isfinite(c), c, top).astype(np.int64)
        counts = np.bincount(codes, minlength=top + 1)
        present = counts > 0
        uniq = np.flatnonzero(present).astype(np.float64)
        uniq[uniq == top] = np.inf
        rank = np.cumsum(present) - 1
        return uniq, rank[codes], counts[present]
    uniq, inv, counts = np.unique(c, return_inverse=True, return_counts=True)
    return uniq, inv.reshape(-1), counts


def factorize(key_cols: list[np.ndarray]):
    """(unique key rows, group id of each row, rows per group) of the host
    key columns, NA as +inf: the rows and order of ``np.unique(axis=0)``
    over the stacked keys, computed per column and then over the combined
    column ranks while they fit one int64."""
    cols = [np.where(np.isnan(c), np.inf, c).astype(np.float64)
            for c in key_cols]
    per = [_unique_inverse(c) for c in cols]
    cards = [len(u) for u, _, _ in per]
    if float(np.prod([max(c, 1) for c in cards], dtype=np.float64)) >= 2**62:
        keys = np.stack(cols, axis=1)
        uniq, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                                      return_counts=True)
        return uniq, inv.reshape(-1), counts
    if len(cols) == 1:
        return per[0][0][:, None], per[0][1], per[0][2]
    combined = np.zeros(len(cols[0]), dtype=np.int64)
    for (_, inv, _), card in zip(per, cards):
        combined = combined * card + inv
    ucomb, inv, counts = _unique_inverse(combined.astype(np.float64))
    ucomb = ucomb.astype(np.int64)
    uniq = np.empty((len(ucomb), len(cols)), dtype=np.float64)
    rest = ucomb
    for j in range(len(cols) - 1, -1, -1):
        uniq[:, j] = per[j][0][rest % cards[j]]
        rest = rest // cards[j]
    return uniq, inv, counts


def _group_reduce(gid: torch.Tensor, lengths: torch.Tensor,
                  cols: torch.Tensor) -> dict:
    """gid (n,) group ids, lengths (G,) rows per group, cols (n, C). Per
    group and column: count of valid values, NA count, sum, centred sum of
    squares, sum of squares, min and max (float64, host arrays)."""
    order = torch.sort(gid, stable=True).indices
    x = cols.index_select(0, order).to(torch.float64)
    ok = ~torch.isnan(x)
    xz = torch.where(ok, x, 0.0)
    C = x.shape[1]
    sums = torch.segment_reduce(
        torch.cat([ok.to(torch.float64), (~ok).to(torch.float64), xz,
                   xz * xz], dim=1), "sum", lengths=lengths, axis=0)
    count, nacnt, s, ss = (sums[:, i * C:(i + 1) * C] for i in range(4))
    mean = s / count.clamp(min=1.0)
    d = torch.where(ok, x - mean.repeat_interleave(lengths, dim=0), 0.0)
    css = torch.segment_reduce(d * d, "sum", lengths=lengths, axis=0)
    mn = torch.segment_reduce(torch.where(ok, x, torch.inf), "min",
                              lengths=lengths, axis=0)
    mx = torch.segment_reduce(torch.where(ok, x, -torch.inf), "max",
                              lengths=lengths, axis=0)
    out = dict(count=count, nacnt=nacnt, sum=s, sumsq=ss, css=css, min=mn,
               max=mx)
    return {k: v.cpu().numpy() for k, v in out.items()}


def group_by(fr: Frame, by: list[str], aggs: list[tuple]) -> Frame:
    """aggs: [(op, col, na_handling), ...]; returns one row per group, sorted
    by group key (H2O returns groups sorted)."""
    n = fr.nrow
    dev = fr.device
    uniq, inv, rows = factorize([fr.vec(b).to_numpy() for b in by])
    ngroups = len(uniq)

    value_cols = sorted({c for _, c, *_ in aggs if c})
    if value_cols and n:
        cols = torch.stack([fr.vec(c).data[:n] for c in value_cols], dim=1)
        stats = _group_reduce(torch.from_numpy(inv).to(dev),
                              torch.from_numpy(rows).to(dev), cols)
    else:
        stats = {}
    colix = {c: i for i, c in enumerate(value_cols)}

    out_names, out_vecs = [], []
    for j, b in enumerate(by):
        v = fr.vec(b)
        vals = uniq[:, j].astype(np.float32)
        vals[np.isinf(uniq[:, j])] = np.nan
        out_names.append(b)
        out_vecs.append(Vec.from_numpy(vals, type=v.type, domain=v.domain,
                                       device=dev))

    for spec in aggs:
        op, col, *rest = spec
        na = rest[0] if rest else "rm"
        if op == "nrow":
            out_names.append("nrow")
            out_vecs.append(Vec.from_numpy(rows.astype(np.float32),
                                           type=T_INT, device=dev))
            continue
        i = colix[col]
        cnt = stats["count"][:, i]
        nac = stats["nacnt"][:, i]
        with np.errstate(invalid="ignore", divide="ignore"):
            if op == "sum":
                vals = stats["sum"][:, i]
            elif op == "sumSquares":
                vals = stats["sumsq"][:, i]
            elif op == "mean":
                vals = stats["sum"][:, i] / cnt
            elif op == "min":
                vals = np.where(cnt > 0, stats["min"][:, i], np.nan)
            elif op == "max":
                vals = np.where(cnt > 0, stats["max"][:, i], np.nan)
            elif op in ("sd", "var"):
                var = np.where(cnt > 0, stats["css"][:, i]
                               / np.maximum(cnt - 1, 1), np.nan)
                vals = np.sqrt(var) if op == "sd" else var
            elif op == "mode":
                vals = _group_mode(fr, col, inv, ngroups, n)
            else:
                raise ValueError(f"unknown agg {op!r}")
        if na == "all":
            vals = np.where(nac > 0, np.nan, vals)
        out_names.append(f"{op}_{col}")
        out_vecs.append(Vec.from_numpy(vals.astype(np.float32), device=dev))
    return Frame(out_names, out_vecs)


def _group_mode(fr: Frame, col: str, inv: np.ndarray, ngroups: int, n: int):
    """The most frequent integer value of ``col`` in each group, the
    smallest on a tie (``np.bincount(...).argmax()`` per group)."""
    host = fr.vec(col).to_numpy()[:n]
    out = np.full(ngroups, np.nan, dtype=np.float32)
    ok = ~np.isnan(host)
    if not ok.any():
        return out
    pairs = np.stack([inv[ok], host[ok].astype(np.int64)], axis=1)
    up, cnt = np.unique(pairs, axis=0, return_counts=True)
    # within a group, rows by descending count then ascending value
    order = np.lexsort((up[:, 1], -cnt, up[:, 0]))
    first = np.ones(len(order), dtype=bool)
    first[1:] = up[order[1:], 0] != up[order[:-1], 0]
    pick = order[first]
    out[up[pick, 0]] = up[pick, 1]
    return out
