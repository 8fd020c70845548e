"""Sort & merge — the `water/rapids/RadixOrder.java` / `BinaryMerge.java` /
`Merge.java` analog (``h2o_tpu/rapids/merge.py``).

``sort`` orders the rows on the frame's device with stable integer sorts,
one per key from the last key to the first: each float key is mapped to an
order-preserving int32 after the reference's canonical form (NaN as -inf,
so NAs sort first ascending; a descending key negated; -0.0 as +0.0), and
the permutation equals the reference's one multi-key stable ``lax.sort``.

``merge`` mirrors ``h2o.merge(x, y, by, all_x, all_y)``: inner/left/right
joins on equal column names, with duplicate-key cartesian expansion (the
BinaryMerge allLeft/allRight semantics). The output lists the left rows in
order, each left row's matches in the right table's stable sorted order;
NA keys never match, +0.0 joins -0.0. A single numeric key joins on the
device — one stable sort of the right keys, ``searchsorted`` ranges and a
``repeat_interleave`` expansion, every step integer or a gather, so the
output is the same bits from run to run. Multi-key, string, categorical
(aligned by level name), exact-int64, right-outer and empty joins take the
host path over the radix sort of ``backend/native.py``. The reference's
sharded expansion (``H2O_TPU_SHARDED_MERGE``) belongs to the multi-card
step; the port's expansion is its replicated oracle's semantics.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frame.frame import Frame, _padded
from ..frame.vec import T_STR, Vec

_I32_LOW = 0x7FFFFFFF


def sortable_i32(k: torch.Tensor) -> torch.Tensor:
    """float32 keys without NaN -> int32 keys of the same order (-0.0 and
    +0.0 equal)."""
    k = torch.where(k == 0, 0.0, k)
    bits = k.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ _I32_LOW, bits)


def sort_permutation(keys: list[torch.Tensor],
                     ascending: list[bool]) -> torch.Tensor:
    """Stable permutation of the rows of float32 ``keys`` (primary first),
    the reference's order: NaN as -inf, descending keys negated."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k, asc in zip(reversed(keys), reversed(ascending)):
        k = torch.where(torch.isnan(k), -torch.inf, k)
        ik = sortable_i32(k if asc else -k)
        perm = perm[torch.sort(ik[perm], stable=True).indices]
    return perm


def _gather_vec(v: Vec, perm: torch.Tensor, host_perm, n: int) -> Vec:
    if v.is_string():
        return Vec(None, n, type=T_STR, host_data=v.host_data[host_perm()])
    out = Vec(_padded(v.data.index_select(0, perm), n), n, type=v.type,
              domain=v.domain)
    if v.exact_data is not None:
        out.exact_data = v.exact_data[host_perm()]
    return out


def sort(fr: Frame, by: list[str] | None = None,
         ascending: list[bool] | None = None) -> Frame:
    """Row-sort the frame by columns (NAs first ascending, last
    descending). Device columns are gathered on the device; string columns
    and exact host copies follow the permutation on the host."""
    by = by or fr.names
    ascending = ascending or [True] * len(by)
    n = fr.nrow
    perm = sort_permutation([fr.vec(b).data[:n] for b in by], ascending)
    cache = []

    def host_perm():
        if not cache:
            cache.append(perm.cpu().numpy())
        return cache[0]

    return Frame(fr.names, [_gather_vec(fr.vec(nm), perm, host_perm, n)
                            for nm in fr.names])


def _merge_schema(left: Frame, right: Frame, key: str) -> list:
    """Output column order + source Vec (the type/domain carrier): all
    left columns, then right's non-key columns."""
    return ([(n, left.vec(n)) for n in left.names]
            + [(n, right.vec(n)) for n in right.names if n != key])


def _merge_ranges(lk: torch.Tensor, rk: torch.Tensor):
    """(right sort order, first match in it, match count) of each left key
    against the right keys, both NaN-free float32 on one device."""
    ik_r = sortable_i32(rk)
    r_order = torch.sort(ik_r, stable=True).indices
    rs = ik_r[r_order].contiguous()
    ik_l = sortable_i32(lk).contiguous()
    lo = torch.searchsorted(rs, ik_l, side="left")
    hi = torch.searchsorted(rs, ik_l, side="right")
    return r_order, lo, hi - lo


def _merge_device(left: Frame, right: Frame, key: str, all_x: bool) -> Frame:
    """Single-key numeric join on the device: one host sync (the output
    row count), no float atomics, no per-row host work."""
    ln, rn = left.nrow, right.nrow
    # NA keys never match: +inf on the left, -inf on the right (the
    # reference's mapping, ``h2o_tpu/rapids/merge.py:353-356``)
    lk = left.vec(key).data[:ln]
    lk = torch.where(torch.isnan(lk), torch.inf, lk)
    rk = right.vec(key).data[:rn]
    rk = torch.where(torch.isnan(rk), -torch.inf, rk)
    r_order, lo, counts = _merge_ranges(lk, rk)
    counts_eff = counts.clamp(min=1) if all_x else counts
    total = int(counts_eff.sum())  # the one host sync
    sch = _merge_schema(left, right, key)
    dev = lk.device
    if total == 0:
        return Frame([n for n, _ in sch],
                     [Vec.from_numpy(np.zeros(0, np.float32), type=v.type,
                                     domain=v.domain, device=dev)
                      for _, v in sch])
    rows = torch.arange(ln, device=dev)
    l_idx = torch.repeat_interleave(rows, counts_eff, output_size=total)
    starts = torch.cumsum(counts_eff, 0) - counts_eff
    within = torch.arange(total, device=dev) - starts[l_idx]
    matched = (counts > 0)[l_idx]
    r_pos = r_order[(lo[l_idx] + within).clamp(max=rn - 1)]
    out = []
    for name, _ in sch[:left.ncol]:
        v = left.vec(name)
        out.append(Vec(_padded(v.data.index_select(0, l_idx), total), total,
                       type=v.type, domain=v.domain))
    for name, v in sch[left.ncol:]:
        col = torch.where(matched, v.data.index_select(0, r_pos), torch.nan)
        out.append(Vec(_padded(col, total), total, type=v.type,
                       domain=v.domain))
    return Frame([n for n, _ in sch], out)


def merge(left: Frame, right: Frame, by: list[str] | None = None,
          all_x: bool = False, all_y: bool = False) -> Frame:
    """Join on shared key columns. Single-key numeric joins run on the
    device (``_merge_device``); multi-key / string / categorical /
    exact-int64 / right-outer / empty joins take the host radix path."""
    by = by or [n for n in left.names if n in right.names]
    if not by:
        raise ValueError("no common columns to merge on")
    if (len(by) == 1 and not all_y
            and not any(left.vec(n).is_string() for n in left.names)
            and not any(right.vec(n).is_string() for n in right.names)
            and not any(left.vec(n).exact_data is not None
                        for n in left.names)
            and not any(right.vec(n).exact_data is not None
                        for n in right.names)
            and not left.vec(by[0]).is_categorical()
            and not right.vec(by[0]).is_categorical()
            and left.nrow > 0 and right.nrow > 0):
        return _merge_device(left, right, by[0], all_x)
    return _merge_host(left, right, by, all_x, all_y)


def _merge_host(left: Frame, right: Frame, by: list[str], all_x: bool,
                all_y: bool) -> Frame:
    from ..backend.native import radix_lexsort

    ln, rn = left.nrow, right.nrow
    dev = left.device or right.device
    # NA keys never match: NaN -> +inf on the left, -inf on the right
    lk = np.stack([np.where(np.isnan(c), np.inf, c) for c in
                   (left.vec(b).to_numpy() for b in by)], axis=1)
    rk = np.stack([np.where(np.isnan(c), -np.inf, c) for c in
                   (right.vec(b).to_numpy() for b in by)], axis=1)
    # categorical codes align by LEVEL NAME, not code
    for j, b in enumerate(by):
        lv, rv = left.vec(b), right.vec(b)
        if lv.is_categorical() and rv.domain != lv.domain and rv.domain:
            at = {lvl: i for i, lvl in enumerate(lv.domain)}
            remap = np.array([at.get(lvl, -np.inf) for lvl in rv.domain],
                             dtype=np.float64)
            fin = np.isfinite(rk[:, j])
            rk[fin, j] = remap[rk[fin, j].astype(np.int64)]

    r_order = radix_lexsort([rk[:, j] for j in range(rk.shape[1])])
    rk_s = rk[r_order]
    lo = _searchsorted_rows(rk_s, lk, "left")
    hi = _searchsorted_rows(rk_s, lk, "right")
    counts = hi - lo
    matched = counts > 0

    # each left row yields counts_eff[i] output rows; matched rows
    # enumerate their sorted right range, unmatched all_x rows get one row
    # with r_pos = -1
    counts_eff = np.maximum(counts, 1) if all_x else counts
    l_idx = np.repeat(np.arange(ln), counts_eff)
    tot = int(counts_eff.sum())
    block_start = np.cumsum(counts_eff) - counts_eff
    offs = np.arange(tot) - np.repeat(block_start, counts_eff)
    srt_pos = np.repeat(lo, counts_eff) + offs
    row_matched = np.repeat(matched, counts_eff)
    if rn:
        r_pos = np.where(row_matched, r_order[np.clip(srt_pos, 0, rn - 1)],
                         -1)
    else:
        r_pos = np.full(tot, -1, dtype=np.int64)
    if all_y:
        used = np.zeros(rn, dtype=bool)
        used[r_pos[r_pos >= 0]] = True
        extra = np.where(~used)[0]
        l_idx = np.concatenate([l_idx, np.full(len(extra), -1)])
        r_pos = np.concatenate([r_pos, extra])

    out_names, out_vecs = [], []
    for name in left.names:
        v = left.vec(name)
        if name in by and all_y:
            # unmatched right rows contribute their key value, in LEFT code
            # space (+-inf = no left equivalent -> NA)
            bj = by.index(name)
            lhost = v.to_numpy()
            fill = np.where(np.isfinite(rk[:, bj]), rk[:, bj], np.nan)
            fill_at = (fill[np.clip(r_pos, 0, None)] if rn
                       else np.full(len(r_pos), np.nan))
            lvals = (lhost[np.clip(l_idx, 0, None)] if ln
                     else np.full(len(l_idx), np.nan))
            out = np.where(l_idx >= 0, lvals, fill_at)
            col = Vec.from_numpy(out.astype(np.float32), type=v.type,
                                 domain=v.domain, device=dev)
        else:
            col = _take(v, l_idx, dev)
        out_names.append(name)
        out_vecs.append(col)
    for name in right.names:
        if name in by:
            continue
        out_names.append(name)
        out_vecs.append(_take(right.vec(name), r_pos, dev))
    return Frame(out_names, out_vecs)


def _searchsorted_rows(sorted_rows: np.ndarray, queries: np.ndarray, side):
    """Row-wise (lexicographic) searchsorted via a structured-array view."""
    def view(a):
        a = np.ascontiguousarray(a)
        return a.view([("", a.dtype)] * a.shape[1]).ravel()

    return np.searchsorted(view(sorted_rows), view(queries), side=side)


def _take(v: Vec, idx: np.ndarray, dev):
    """Host rows by index; idx < 0 -> NA (unmatched outer-join rows). An
    exact host copy stays exact."""
    host = v.to_numpy()
    if v.is_string():
        out = np.array([host[i] if i >= 0 else None for i in idx],
                       dtype=object)
        return Vec(None, len(idx), type=T_STR, host_data=out)
    if len(host) == 0:
        out = np.full(len(idx), np.nan)
    else:
        out = np.where(idx >= 0, host[np.clip(idx, 0, None)], np.nan)
    if v.exact_data is None:
        out = out.astype(np.float32)
    return Vec.from_numpy(out, type=v.type, domain=v.domain, device=dev)
