"""Path-dependent TreeSHAP for heap-layout forests
(``h2o_tpu/models/tree/shap.py``; `hex/genmodel/algos/tree/TreeSHAP.java`,
Lundberg & Lee's exact tree SHAP behind ``predict_contributions``).

The reference's formulation, kept step for step: the EXTEND/UNWIND
recursion runs once per node, host-side over the tree's structure, with
every row-dependent quantity — the hot/cold direction of each path entry
and the path weights — a float64 tensor over a block of rows. A tree costs
O(nodes x depth) tensor operations, whatever the rows. On the card the
block is sized to the card's free memory; on the CPU the same code runs on
CPU tensors. The scalars the recursion reads (covers, leaf values, the
fractions of the path) stay on the host as float64 Python numbers,
rounded as the reference's numpy rounds them, so the two agree to the last
few ulps.

Trees are the engine's complete heaps (children of i at 2i+1 / 2i+2,
``feat < 0`` at leaves); ``cover`` holds each node's weighted training-row
count (`engine.forest_covers`).
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12


def _extend(pw, zf, of, pz: float, po):
    """EXTEND: the path with (pz, po) appended. ``pw``: list of (R,)
    tensors; ``zf``: list of floats; ``of``: list of (R,) tensors."""
    l = len(zf)
    pw = list(pw)
    pw.append(torch.ones_like(po) if l == 0 else torch.zeros_like(po))
    for i in range(l - 1, -1, -1):
        pw[i + 1] = pw[i + 1] + po * pw[i] * ((i + 1) / (l + 1))
        pw[i] = pz * pw[i] * ((l - i) / (l + 1))
    return pw, zf + [pz], of + [po]


def _unwind(pw, zf, of, i: int):
    """UNWIND: the path without entry ``i`` (an earlier split on the same
    feature)."""
    l = len(zf) - 1
    o, z = of[i], zf[i]
    pw = list(pw)
    n = pw[l]
    hot = o > 0
    o_safe = torch.where(hot, o, 1.0)
    for j in range(l - 1, -1, -1):
        t = pw[j]
        pw_hot = n * (l + 1) / ((j + 1) * o_safe)
        pw_cold = t * (l + 1) / max(z * (l - j), _EPS)
        pw[j] = torch.where(hot, pw_hot, pw_cold)
        n = torch.where(hot, t - pw[j] * z * ((l - j) / (l + 1)), n)
    return pw[:l], zf[:i] + zf[i + 1:], of[:i] + of[i + 1:]


def _unwound_sums(pw, zf, of):
    """(l, R): for each path entry i = 1..l, the sum of the path weights
    with entry i notionally unwound (the leaf step). The reference's
    per-entry loop (``shap.py:57``), run for every entry at once: each
    element goes through the same operations in the same order."""
    l = len(zf) - 1
    if l == 0:
        return pw[0].new_zeros((0,) + pw[0].shape)
    o = torch.stack(of[1:])                                   # (l, R)
    z = torch.tensor(zf[1:], dtype=torch.float64, device=o.device)[:, None]
    hot = o > 0
    o_safe = torch.where(hot, o, 1.0)
    n = pw[l].expand_as(o)
    total = torch.zeros_like(o)
    for j in range(l - 1, -1, -1):
        tmp = n * (l + 1) / ((j + 1) * o_safe)
        cold = pw[j] * (l + 1) / torch.clamp(z * (l - j), min=_EPS)
        total = total + torch.where(hot, tmp, cold)
        n = torch.where(hot, pw[j] - tmp * z * ((l - j) / (l + 1)), n)
    return total


def _tree_shap_one(X, feat, thr, nanL, val, cover, phi, scale: float,
                   catd=None, iscat=None, nedges=None) -> None:
    """Add one tree's contributions to ``phi`` (R, F+1) float64. ``X``
    (R, F) float32 on the device; ``feat``/``thr``/``nanL``/``val``/
    ``cover`` (N,) numpy; ``catd`` (N, nb) numpy, ``iscat``/``nedges``
    (F,) numpy for a forest with set splits."""
    R = X.shape[0]
    f = feat.astype(np.int64)
    dev = X.device

    def hot_right(j: int):
        """(R,) bool: the rows that go right at node j (reference
        ``shap.py:80-91``: the raw threshold, the set-split direction row
        at bin ``min(level, nedges)``, NA by the node's NA direction)."""
        x = X[:, int(f[j])]
        right = x > float(thr[j])
        if catd is not None and bool(iscat[f[j]]):
            xb = torch.clamp(torch.nan_to_num(x), 0.0,
                             float(nedges[f[j]])).to(torch.int64)
            row = torch.from_numpy(np.ascontiguousarray(catd[j]) > 0.5).to(
                dev)
            right = row[xb]
        return torch.where(torch.isnan(x), not bool(nanL[j]), right)

    root_cover = max(float(cover[0]), _EPS)
    leaves = (f < 0) & (cover > 0)
    # the bias: the leaves' cover-weighted mean value
    phi[:, -1] += scale * float(np.sum(cover[leaves] * val[leaves])
                                / root_cover)
    if f[0] < 0:   # a single leaf: all bias
        return
    scale32 = np.float32(scale)

    def recurse(j, pw, zf, of, feats_path):
        if f[j] < 0:
            if len(feats_path) == 1:
                return
            # numpy rounds ``scale * val[j]`` to float32, as here
            v = float(scale32 * val[j])
            z = torch.tensor(zf[1:], dtype=torch.float64, device=dev)
            s = _unwound_sums(pw, zf, of)
            phi[:, feats_path[1:]] += (s * (torch.stack(of[1:]) - z[:, None])
                                       * v).T
            return
        d = int(f[j])
        cl, cr = 2 * j + 1, 2 * j + 2
        rj = max(float(cover[j]), _EPS)
        hot_r = hot_right(j)
        k = feats_path.index(d) if d in feats_path else -1
        if k >= 0:
            iz, io = zf[k], of[k]
            pw, zf, of = _unwind(pw, zf, of, k)
            feats_path = feats_path[:k] + feats_path[k + 1:]
        else:
            iz = 1.0
            io = torch.ones(R, dtype=torch.float64, device=dev)
        for child, is_right in ((cl, False), (cr, True)):
            pz = iz * float(cover[child]) / rj
            po = io * (hot_r == is_right).to(torch.float64)
            pw2, zf2, of2 = _extend(pw, zf, of, pz, po)
            recurse(child, pw2, zf2, of2, feats_path + [d])

    ones = torch.ones(R, dtype=torch.float64, device=dev)
    pw0, zf0, of0 = _extend([], [], [], 1.0, ones)
    recurse(0, pw0, zf0, of0, [-1])


def block_rows(R: int, F: int, depth: int, device) -> int:
    """Rows per TreeSHAP block: all of them on the CPU; on the card as
    many as a third of the free device memory holds, at ~8 bytes for each
    of phi's F+1 columns and of the (depth+2)^2 path tensors the recursion
    keeps alive."""
    if torch.device(device).type != "cuda":
        return max(R, 1)
    free, _total = torch.cuda.mem_get_info(device)
    per_row = 8 * ((F + 1) + 2 * (depth + 2) ** 2) + 4 * F
    return max(8192, min(R, int(free // 3 // per_row)))


def tree_shap(X: torch.Tensor, feat, thr, nanL, val, cover,
              bias0: float = 0.0, scale: float = 1.0, depth: int = 0,
              catd=None, iscat=None, nedges=None) -> torch.Tensor:
    """SHAP contributions of a forest (reference ``shap.py:130``).

    ``X`` (R, F) float32 rows (NaN = missing) on the device the work runs
    on; ``feat``/``thr``/``nanL``/``val``/``cover`` (T, N) numpy; ``catd``
    (T, N, nb), ``iscat``/``nedges`` (F,) numpy for set splits. Returns
    (R, F+1) float64 on X's device: per-feature contributions and the
    BiasTerm last, on the link scale; each row sums to the forest's raw
    prediction plus ``bias0``."""
    R, F = X.shape
    out = torch.zeros((R, F + 1), dtype=torch.float64, device=X.device)
    step = block_rows(R, F, depth, X.device)
    for s in range(0, R, step):
        phi = torch.zeros((min(R, s + step) - s, F + 1), dtype=torch.float64,
                          device=X.device)
        for t in range(feat.shape[0]):
            _tree_shap_one(X[s:s + step], feat[t], thr[t], nanL[t], val[t],
                           np.asarray(cover[t], np.float64), phi, scale,
                           catd=None if catd is None else catd[t],
                           iscat=iscat, nedges=nedges)
        out[s:s + step] = phi
    out[:, -1] += bias0
    return out
