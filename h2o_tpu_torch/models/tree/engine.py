"""Shared tree engine (``h2o_tpu/models/tree/engine.py``).

Per tree level: route rows off the previous level's splits (integer
gathers), accumulate the level histogram over the node window (the
level-histogram kernel, flat or per width bucket of `plan_hist_groups`),
pick each node's best split — an ordinal cut, or for a categorical feature
under ``use_sets`` a set of levels sent left — and write the level into the
full-binary-tree arrays (node i -> children 2i+1 / 2i+2). After the last
level, one per-node accumulation gives Newton leaf values. The loop stays on
the device: nothing in it reads a value back to the host.

Sampling follows the reference's ``jax.random`` streams bit for bit
(`utils/threefry.py`): per tree a row sample from ``fold_in(key, 0)`` over
the padded rows, a column subsample from ``fold_in(colkey, 997)``, and per
level a column mask from ``fold_in(colkey, level)`` — DRF's mtries draw or
GBM's Bernoulli rate. Multinomial models grow one tree per class per
iteration, each with its own column key, in a loop where the reference
vmaps. DRF trees fit at f = 0 and keep their leaf means unscaled; the rows a
tree's bag left out collect its outputs for out-of-bag scoring.

This is the shape of the reference's pipelined program under the pallas
backend (route pass, then the kernel), and it produces the same forests as
the reference's synchronous oracle: routing is integer work, and split
finding keeps the reference's candidate layout and first-maximum tie rule.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ...backend.kernels import hist as hist_kernels
from ...utils import threefry
from ...utils.knobs import get_int


@dataclass(frozen=True)
class TreeConfig:
    """The reference's ``TreeConfig`` fields that describe the model (its
    JAX execution options ``pipeline``/``async_psum``/``fused_score`` have
    no counterpart here). ``use_monotone``/``use_interaction`` switch on the
    constraint arrays `train_trees` is given; ``leaf_quantile`` fits each
    leaf to that quantile of its residuals (laplace 0.5, quantile alpha),
    ``huber_leaf_alpha`` fits huber's hybrid leaves. GOSS, not ported yet,
    is refused by `check_supported`."""

    ntrees: int = 50
    max_depth: int = 5
    nbins: int = 20              # real-value bins; bin index nbins = NA bucket
    min_rows: float = 10.0
    learn_rate: float = 0.1
    reg_lambda: float = 0.0
    reg_alpha: float = 0.0
    min_split_improvement: float = 1e-5
    sample_rate: float = 1.0
    col_sample_rate: float = 1.0
    col_sample_rate_per_tree: float = 1.0
    mtries: int = -1
    drf_mode: bool = False
    nclass: int = 1
    block_rows: int = 8192
    hist_groups: tuple | None = None
    use_monotone: bool = False
    use_interaction: bool = False
    leaf_quantile: float | None = None
    max_abs_leafnode_pred: float = float("inf")
    col_sample_rate_change_per_level: float = 1.0
    huber_leaf_alpha: float | None = None
    use_sets: bool = False
    goss: tuple | None = None

    @property
    def n_nodes(self) -> int:
        return 2 ** (self.max_depth + 1) - 1

    def check_supported(self) -> None:
        """Raise ``NotImplementedError`` naming the ROADMAP item for every
        option the port does not reproduce yet — never approximate."""
        if self.goss is not None:
            raise NotImplementedError("h2o_tpu_torch: GOSS sampling (ROADMAP "
                                      "Queue 1 item 7) is not ported yet")


def plan_hist_groups(nedges, B_hist: int, block_rows: int,
                     budget_bytes: int | None = None,
                     n_lv_max: int = 32, nvals: int = 3):
    """Auto-tuned histogram accumulation plan: (hist_groups | None, block) —
    the reference's planner, verbatim (pure numpy), so both packages pick
    the same plan and row block for the same bin widths."""
    widths = np.asarray(nedges, np.int64) + 2  # data bins + NA slot
    F = int(widths.shape[0])
    by_w: dict[int, list[int]] = {}
    for f, wd in enumerate(widths):
        p2 = 1 << int(np.ceil(np.log2(max(int(wd), 2))))
        by_w.setdefault(min(p2, B_hist), []).append(f)
    grouped_cells = sum(len(fs) * wd for wd, fs in by_w.items())
    seg_w = get_int("H2O_TORCH_HIST_SEG_WIDTH")
    groups = None
    if len(by_w) > 1 and grouped_cells < 0.6 * F * B_hist:
        groups = tuple(sorted(
            (tuple(fs), int(wd), "segsum" if wd <= seg_w else "onehot")
            for wd, fs in by_w.items()))
    cells_per_row = grouped_cells if groups else F * B_hist
    budget = budget_bytes or (4 << 30)
    step_cap = max(budget // 12, 1 << 20)
    blk = block_rows
    while blk > 512 and blk * (cells_per_row + n_lv_max * nvals) * 4 > step_cap:
        blk //= 2
    return groups, blk


def _norm_groups(groups):
    """Normalize hist_groups entries to (idxs, width, mode): legacy 2-tuples
    (pre-mode persisted models) accumulate via the one-hot product."""
    return tuple((g[0], g[1], g[2] if len(g) > 2 else "onehot")
                 for g in groups)


def _build_level_hist(Xb, node, vals, offset: int, n_lv: int, nbins_tot: int,
                      block: int, groups=None) -> torch.Tensor:
    """hist (F, n_lv, nbins_tot, V) for nodes [offset, offset+n_lv): rows
    outside the window contribute zeros. With ``groups`` (a width-bucketed
    plan from `plan_hist_groups`) the kernels layer accumulates each bucket
    at its own width — one kernel launch for all of them on the card — and
    the buckets scatter back into the global bin layout."""
    local = node - offset
    active = (local >= 0) & (local < n_lv)
    lc = torch.clamp(local, 0, n_lv - 1).to(torch.int32)
    v = torch.where(active[:, None], vals, 0.0)
    if groups is None:
        return hist_kernels.level_hist_blocks(Xb, lc, v, n_lv=n_lv,
                                              nbins_tot=nbins_tot, block=block)
    groups = _norm_groups(groups)
    hists = hist_kernels.level_hist_blocks(Xb, lc, v, n_lv=n_lv,
                                           nbins_tot=nbins_tot, block=block,
                                           groups=groups)
    return _scatter_group_hists(hists, groups, Xb.shape[1], n_lv, nbins_tot,
                                vals.shape[1])


@functools.lru_cache(maxsize=None)
def _index_tensor(idxs: tuple, device: str) -> torch.Tensor:
    """A group's feature indices on ``device``, copied there once."""
    return torch.tensor(idxs, dtype=torch.int64, device=device)


def _scatter_group_hists(hists, groups, F: int, n_lv: int, nbins_tot: int,
                         V: int) -> torch.Tensor:
    """Per-group accumulators back into the global (F, n_lv, B, V) layout,
    each group's NA slot (its LAST bin) restored to the global NA bucket;
    bins a group does not hold stay zero. Plain tensor indexing, shared by
    the CPU and card paths."""
    na_global = nbins_tot - 1
    full = torch.zeros((F, n_lv, nbins_tot, V), dtype=torch.float32,
                       device=hists[0].device)
    for (idxs, Bg, _mode), hg in zip(groups, hists):
        ia = _index_tensor(tuple(int(i) for i in idxs), str(full.device))
        full[ia, :, :Bg - 1, :] = hg[:, :, :Bg - 1, :]
        full[ia, :, na_global, :] = hg[:, :, Bg - 1, :]
    return full


def _route_rows_gather(Xb, node, route_args, cfg: TreeConfig) -> torch.Tensor:
    """Advance node ids off one level's splits with integer gathers: the
    row's code at its node's split feature against the cut — or, at a
    set-split node, the node's direction row read at the row's bin — and NA
    rows by the node's NA direction. Integer work end to end, so the ids
    equal the reference's whatever the formulation."""
    bf, bb, bnal, do_split, catd_lv, isset, offset, n_lv = route_args
    local = node - offset
    active = (local >= 0) & (local < n_lv)
    lc = torch.clamp(local, 0, n_lv - 1).long()
    xv = torch.gather(Xb, 1, bf[lc][:, None])[:, 0].to(torch.int32)
    num_right = xv > bb[lc]
    if catd_lv is not None:
        idx = lc * cfg.nbins + torch.clamp(xv, 0, cfg.nbins - 1)
        cat_right = catd_lv.reshape(-1)[idx] > 0.5
        num_right = torch.where(isset[lc], cat_right, num_right)
    go_right = torch.where(xv == cfg.nbins, ~bnal[lc], num_right)
    return torch.where(do_split[lc] & active,
                       2 * node + 1 + go_right.to(torch.int32), node)


#: rows per routing step — bounds the gathers' int64 temporaries
_ROUTE_ROWS = 1 << 22


def _route_all(Xb, node, route_args, cfg: TreeConfig) -> torch.Tensor:
    """Routing pass over every row, in steps of `_ROUTE_ROWS` rows."""
    return torch.cat([_route_rows_gather(Xb[s:s + _ROUTE_ROWS],
                                         node[s:s + _ROUTE_ROWS],
                                         route_args, cfg)
                      for s in range(0, Xb.shape[0], _ROUTE_ROWS)])


def _node_totals(node, vals, n_nodes: int) -> torch.Tensor:
    """Per-node channel totals (n_nodes, V): the reference's one-hot
    accumulation as one integer ``index_add_`` in 64-bit fixed point, the
    level-histogram kernel's number format. Each channel is scaled by a
    power of two chosen from Rl x max|v| so that no sum can overflow, so
    integer channels (DRF's counts) come out exact and every channel is the
    same on the card and on the CPU in any order: no float atomics, one
    pass, no (rows, nodes) one-hot. A channel holding a NaN or an infinity
    comes out NaN."""
    Rl, V = vals.shape
    amax = vals.abs().amax(dim=0).double()                        # (V,)
    _m, e = torch.frexp(amax * Rl)                                # < 2^e
    scale = torch.where(amax > 0, torch.ldexp(torch.ones_like(amax), 62 - e),
                        1.0)
    finite = torch.isfinite(amax)
    q = torch.round(torch.nan_to_num(vals.double(), posinf=0.0, neginf=0.0)
                    * torch.where(finite, scale, 0.0)).to(torch.int64)
    tot = torch.zeros((n_nodes, V), dtype=torch.int64, device=vals.device)
    tot.index_add_(0, node.long(), q)
    return torch.where(finite, tot.double() / scale, torch.nan).to(
        torch.float32)


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with the product unrounded, as XLA's CPU
    backend contracts it to an FMA: the float32 product is exact in
    float64, and rounding the float64 sum to float32 differs from the FMA's
    single rounding only where the sum falls on a float32 halfway point."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _leaf_quantile_vals(resid, w, node, n_nodes: int, q: float,
                        qbins: int = 256) -> torch.Tensor:
    """Per-node ``q``-quantile of the residuals (n_nodes,): the reference's
    three passes of a (node, qbins) weight histogram over each node's
    residual bracket, which starts at the global [min, max] of the weighted
    rows and narrows to the bin holding the target each pass; the value is
    the last bracket's midpoint, 0 for an empty node. The histogram is
    `_node_totals` over the key ``node * qbins + bin``: with integer
    weights its cells count exactly, as the reference's float32 one-hot
    sums do, so the same bin is picked."""
    ok = w > 0
    wz = torch.where(ok, w, 0.0)
    gmin = torch.where(ok, resid, torch.inf).amin()
    gmax = torch.where(ok, resid, -torch.inf).amax()
    lo_n = gmin.expand(n_nodes).clone()
    hi_n = gmax.expand(n_nodes).clone()
    nd = node.long()
    for _ in range(3):
        span_n = torch.clamp(hi_n - lo_n, min=1e-12)
        span_row = torch.clamp(span_n[nd], min=1e-12)
        # clamped before the int conversion: XLA's saturates, torch's not
        v = (resid - lo_n[nd]) / span_row * qbins
        bins = torch.clamp(v, 0, qbins - 1).to(torch.int64)
        hist = _node_totals(nd * qbins + bins, wz[:, None],
                            n_nodes * qbins)[:, 0].reshape(n_nodes, qbins)
        cum = torch.cumsum(hist, dim=1)
        tot = cum[:, -1]
        target = q * tot
        idx = torch.argmax((cum >= target[:, None]).to(torch.uint8),
                           dim=1).to(torch.float32)
        lo_n, hi_n = (_fma(idx / qbins, span_n, lo_n),
                      _fma((idx + 1.0) / qbins, span_n, lo_n))
    return torch.where(tot > 0, 0.5 * (lo_n + hi_n), 0.0)


def _level_col_mask(lkey, F: int, n_lv: int, cfg: TreeConfig, tree_cols,
                    level: int = 0) -> torch.Tensor:
    """Per-(feature, node) candidate mask of one level: DRF's mtries k-of-F
    draw (the k smallest of F uniforms per node) or GBM's Bernoulli
    ``col_sample_rate`` with every node keeping all features when its draw
    took none, scaled by ``col_sample_rate_change_per_level ** level`` (the
    rate saturates at 1; k grows up to F) — the reference's
    ``_level_col_mask``, on the same stream. ANDed with the tree's
    columns."""
    dev = tree_cols.device
    factor = cfg.col_sample_rate_change_per_level ** level
    rate = min(max(cfg.col_sample_rate * factor, 1e-6), 1.0)
    if cfg.mtries > 0:
        k = min(F, max(1, int(round(min(cfg.mtries, F) * factor))))
        u = threefry.uniform(lkey, (F, n_lv), dev)
        kth = torch.sort(u, dim=0).values[k - 1]
        cmask = u <= kth[None, :]
    elif rate < 1.0:
        cmask = threefry.uniform(lkey, (F, n_lv), dev) < _f32(rate)
        cmask = torch.where(cmask.any(dim=0, keepdim=True), cmask, True)
    else:
        cmask = torch.ones((F, n_lv), dtype=torch.bool, device=dev)
    return cmask & tree_cols[:, None]


def _f32(x: float) -> float:
    """``x`` rounded to float32, as jax rounds a Python float compared with
    a float32 array."""
    return float(np.float32(x))


def _find_splits(hist, colmask, edge_ok, cfg: TreeConfig, iscat=None,
                 nedges=None, mono=None):
    """Best split per node. hist (F, n_lv, B, 3) -> (gain, feat, bin,
    nan_left, node weight, left value, right value, direction rows, set
    flags); the last two are None unless ``cfg.use_sets`` with ``iscat``
    (F,) bool and ``nedges`` (F,) given. ``mono`` (F,) in {-1, 0, 1} drops
    the candidates whose child values go against their feature's monotone
    direction.

    Candidates are cuts b in 0..nb-2 (left = bins <= b) with the NA bucket
    sent right or left. They are flattened exactly as the reference does —
    (n_lv, F*(nb-1)*2) in [NA right, NA left] order — and the first maximum
    wins (``torch.argmax`` returns the first maximal index), which settles
    the systematic NA-left/NA-right ties of features without NAs and the
    all -inf candidates of empty nodes the same way on both packages.

    Set splits (the reference's sorted-prefix search): a categorical
    feature's bins are ordered by G/H, empty bins keyed +inf so they sort
    last, and candidate b sends the b+1 first bins of that order left. The
    order comes from a stable argsort, so ties break by bin index as in
    ``jnp.argsort(stable=True)``; a second stable argsort gives each bin's
    rank, which the chosen node's direction row reads back."""
    nb = cfg.nbins
    W, G, H = hist[..., 0], hist[..., 1], hist[..., 2]
    lam = cfg.reg_lambda
    alpha = cfg.reg_alpha
    Wt = W.sum(dim=2)[0]     # (n_lv,) — identical across features
    Gt = G.sum(dim=2)[0]
    Ht = H.sum(dim=2)[0]

    cw = torch.cumsum(W[:, :, :nb], dim=2)[:, :, :-1]      # (F, n_lv, nb-1)
    cg = torch.cumsum(G[:, :, :nb], dim=2)[:, :, :-1]
    ch = torch.cumsum(H[:, :, :nb], dim=2)[:, :, :-1]
    rank = None
    if cfg.use_sets and iscat is not None:
        Wr, Gr, Hr = W[:, :, :nb], G[:, :, :nb], H[:, :, :nb]
        key = torch.where(Wr > 0, Gr / (Hr + 1e-10), torch.inf)
        order = torch.argsort(key, dim=2, stable=True)
        rank = torch.argsort(order, dim=2, stable=True)
        isc = iscat[:, None, None]
        cw = torch.where(isc, torch.cumsum(torch.gather(Wr, 2, order), 2)
                         [:, :, :-1], cw)
        cg = torch.where(isc, torch.cumsum(torch.gather(Gr, 2, order), 2)
                         [:, :, :-1], cg)
        ch = torch.where(isc, torch.cumsum(torch.gather(Hr, 2, order), 2)
                         [:, :, :-1], ch)
        # a prefix of k = b+1 bins is meaningful up to all real bins left and
        # NA right (k = nedges + 1, the NA-vs-rest split)
        cat_ok = (torch.arange(nb - 1, device=hist.device)[None, :]
                  <= nedges[:, None])
        edge_ok = torch.where(iscat[:, None], cat_ok, edge_ok)
    wna = W[:, :, nb][:, :, None]
    gna = G[:, :, nb][:, :, None]
    hna = H[:, :, nb][:, :, None]

    def _soft(g):
        # xgboost-style L1 soft threshold on score numerators (no-op at 0)
        return (torch.sign(g) * torch.clamp(torch.abs(g) - alpha, min=0.0)
                if alpha > 0 else g)

    def child_vals(gl, hl):
        gr = Gt[None, :, None] - gl
        hr = Ht[None, :, None] - hl
        return (-_soft(gl) / (hl + lam + 1e-10),
                -_soft(gr) / (hr + lam + 1e-10))

    def gain_of(wl, gl, hl):
        wr = Wt[None, :, None] - wl
        gr = Gt[None, :, None] - gl
        hr = Ht[None, :, None] - hl
        gl_, gr_, gt_ = _soft(gl), _soft(gr), _soft(Gt)
        g = (gl_ * gl_ / (hl + lam + 1e-10) + gr_ * gr_ / (hr + lam + 1e-10)
             - (gt_ * gt_ / (Ht + lam + 1e-10))[None, :, None])
        ok = (wl >= cfg.min_rows) & (wr >= cfg.min_rows)
        return torch.where(ok, g, -torch.inf)

    gains = torch.stack([gain_of(cw, cg, ch),                  # NA right
                         gain_of(cw + wna, cg + gna, ch + hna)],  # NA left
                        dim=3)                                 # (F, n_lv, nb-1, 2)
    vL_nar, vR_nar = child_vals(cg, ch)
    vL_nal, vR_nal = child_vals(cg + gna, ch + hna)
    vL = torch.stack([vL_nar, vL_nal], dim=3)
    vR = torch.stack([vR_nar, vR_nal], dim=3)
    if mono is not None:
        m = mono[:, None, None, None]
        viol = ((m > 0) & (vL > vR)) | ((m < 0) & (vL < vR))
        gains = torch.where(viol, -torch.inf, gains)
    gains = torch.where(colmask[:, :, None, None], gains, -torch.inf)
    gains = torch.where(edge_ok[:, None, :, None], gains, -torch.inf)

    n_lv = gains.shape[1]
    flat = gains.permute(1, 0, 2, 3).reshape(n_lv, -1)  # (n_lv, F*(nb-1)*2)
    best = torch.argmax(flat, dim=1)

    def pick(arr):
        a = arr.permute(1, 0, 2, 3).reshape(n_lv, -1)
        return torch.gather(a, 1, best[:, None])[:, 0]

    per_f = (nb - 1) * 2
    bf = best // per_f
    bb = ((best % per_f) // 2).to(torch.int32)
    bnal = (best % 2).to(torch.bool)
    out = (pick(gains), bf, bb, bnal, Wt, pick(vL), pick(vR))
    if rank is None:
        return out + (None, None)
    # direction row per node over real bins (0 = left, 1 = right): at a set
    # split, bin b goes left iff its rank is inside the chosen prefix; empty
    # bins follow the NA direction (a level unseen at this node is treated
    # like missing). Numeric nodes get the ordinal pattern b > cut, which
    # routing never reads (it keeps the cut test for them).
    sel = bf[:, None, None].expand(n_lv, 1, nb)
    rank_sel = torch.gather(rank.permute(1, 0, 2), 1, sel)[:, 0, :]
    w_sel = torch.gather(W[:, :, :nb].permute(1, 0, 2), 1, sel)[:, 0, :]
    dir_c = torch.where(w_sel > 0, rank_sel > bb[:, None], ~bnal[:, None])
    isset = iscat[bf]
    ordinal = torch.arange(nb, device=hist.device)[None, :] > bb[:, None]
    catd_lv = torch.where(isset[:, None], dir_c, ordinal).to(torch.float32)
    return out + (catd_lv, isset)


def _grow_tree(Xb, g, h, w, edges, edge_ok, colkey, cfg: TreeConfig,
               iscat=None, nedges=None, mono=None, imat=None, resid=None,
               w_full=None):
    """Grow one tree on the device. ``colkey`` is the tree's column key
    (its tree key, or its class key under multinomial). Returns (feat (N,),
    thr (N,), nanL (N,), val (N,), gain (N,), catd (N, nbins | 1), node
    (Rl,)) — the reference's layout. ``catd`` holds each node's set-split
    direction row when ``cfg.use_sets`` and ``iscat``/``nedges`` are given,
    else one dummy column.

    ``mono`` (F,) float32 in {-1, 0, 1}: candidates against a direction are
    dropped, and each node carries [lo, hi] value bounds that a constrained
    split passes to its children through the midpoint of its child values;
    leaf values are clipped into them. ``imat`` (F, F) bool may-interact
    matrix: each node carries its usable features, a child's being the
    parent's ANDed with the split feature's row. ``resid`` (y - f) feeds
    the quantile and huber leaves; huber's delta is taken over every row
    with the unsampled weights ``w_full``."""
    Rl, F = Xb.shape
    N = cfg.n_nodes
    B = cfg.nbins + 1
    dev = Xb.device
    use_sets = cfg.use_sets and iscat is not None
    feat = torch.full((N,), -1, dtype=torch.int32, device=dev)
    thr = torch.zeros((N,), dtype=torch.float32, device=dev)
    nanL = torch.zeros((N,), dtype=torch.bool, device=dev)
    garr = torch.zeros((N,), dtype=torch.float32, device=dev)
    catd = torch.zeros((N, cfg.nbins if use_sets else 1), dtype=torch.float32,
                       device=dev)
    node = torch.zeros((Rl,), dtype=torch.int32, device=dev)
    vals3 = torch.stack([w, g, h], dim=1)
    lo = torch.full((N,), -torch.inf, dtype=torch.float32, device=dev)
    hi = torch.full((N,), torch.inf, dtype=torch.float32, device=dev)
    allowed = torch.ones((N, F), dtype=torch.bool, device=dev)
    # the tree's column subsample; a uniform draw is below 1, so at rate 1
    # every column is in, as in the reference
    if cfg.col_sample_rate_per_tree < 1.0:
        tree_cols = (threefry.uniform(threefry.fold_in(colkey, 997), (F,), dev)
                     < _f32(cfg.col_sample_rate_per_tree))
        tree_cols = torch.where(tree_cols.any(), tree_cols, True)
    else:
        tree_cols = torch.ones((F,), dtype=torch.bool, device=dev)

    route_args = None
    for level in range(cfg.max_depth):
        n_lv = 2 ** level
        offset = n_lv - 1
        sl = slice(offset, offset + n_lv)
        kids = slice(2 * offset + 1, 2 * offset + 1 + 2 * n_lv)
        if route_args is not None:
            node = _route_all(Xb, node, route_args, cfg)
        hist = _build_level_hist(Xb, node, vals3, offset, n_lv, B,
                                 cfg.block_rows, groups=cfg.hist_groups)
        cmask = _level_col_mask(threefry.fold_in(colkey, level), F, n_lv, cfg,
                                tree_cols, level)
        if imat is not None:
            cmask = cmask & allowed[sl].T
        gain, bf, bb, bnal, Wt, vL, vR, catd_lv, isset = _find_splits(
            hist, cmask, edge_ok, cfg,
            iscat if use_sets else None, nedges if use_sets else None, mono)
        do_split = (gain > cfg.min_split_improvement) & (Wt >= 2 * cfg.min_rows)
        if mono is not None:
            lo_n, hi_n = lo[sl], hi[sl]
            cbf = mono[bf]
            mid = torch.minimum(torch.maximum((vL + vR) * 0.5, lo_n), hi_n)
            use = do_split & (cbf != 0)
            up, down = use & (cbf > 0), use & (cbf < 0)
            lo[kids] = torch.stack([torch.where(down, mid, lo_n),
                                    torch.where(up, mid, lo_n)], 1).reshape(-1)
            hi[kids] = torch.stack([torch.where(up, mid, hi_n),
                                    torch.where(down, mid, hi_n)], 1).reshape(-1)
        if imat is not None:
            allowed_n = allowed[sl]
            child = torch.where(do_split[:, None], allowed_n & imat[bf],
                                allowed_n)
            allowed[kids] = torch.repeat_interleave(child, 2, dim=0)
        feat[sl] = torch.where(do_split, bf.to(torch.int32), -1)
        thr[sl] = edges[bf, bb.long()]
        nanL[sl] = bnal
        garr[sl] = torch.where(do_split, gain, 0.0)
        if use_sets:
            catd[sl] = catd_lv
        route_args = (bf, bb, bnal, do_split, catd_lv, isset, offset, n_lv)
    if route_args is not None:
        node = _route_all(Xb, node, route_args, cfg)

    # leaf/stop-node values from one final per-node accumulation; DRF's
    # leaves are response means, unscaled
    tot = _node_totals(node, vals3, N)
    if cfg.huber_leaf_alpha is not None and resid is not None:
        # huber's hybrid leaf: the leaf median plus the leaf mean of the
        # residuals' distance from it, clipped at delta, the huber_alpha
        # quantile of |resid| over all rows
        med = _leaf_quantile_vals(resid, w, node, N, 0.5)
        delta = _leaf_quantile_vals(torch.abs(resid),
                                    w if w_full is None else w_full,
                                    torch.zeros_like(node), 1,
                                    cfg.huber_leaf_alpha)[0]
        d = resid - med[node.long()]
        clipped = torch.sign(d) * torch.minimum(torch.abs(d), delta)
        tot2 = _node_totals(node, (w * clipped)[:, None], N)
        gamma = torch.where(tot[:, 0] > 0,
                            tot2[:, 0] / torch.clamp(tot[:, 0], min=1e-10), 0.0)
        newton = torch.where(tot[:, 0] > 0, med + gamma, 0.0)
    elif cfg.leaf_quantile is not None and resid is not None:
        newton = _leaf_quantile_vals(resid, w, node, N, cfg.leaf_quantile)
        newton = torch.where(tot[:, 0] > 0, newton, 0.0)
    else:
        gleaf = tot[:, 1]
        if cfg.reg_alpha > 0:
            gleaf = torch.sign(gleaf) * torch.clamp(
                torch.abs(gleaf) - cfg.reg_alpha, min=0.0)
        newton = torch.where(tot[:, 0] > 0,
                             -gleaf / (tot[:, 2] + cfg.reg_lambda + 1e-10),
                             0.0)
    if mono is not None:
        newton = torch.minimum(torch.maximum(newton, lo), hi)
    val = newton * (1.0 if cfg.drf_mode else cfg.learn_rate)
    return feat, thr, nanL, val, garr, catd, node


def train_trees(Xb, y, w, f, edges, edge_ok, keys, rates, cfg: TreeConfig,
                grad_fn, iscat=None, nedges=None, mono=None, imat=None):
    """Grow one iteration per key — the port's ``make_train_fn``: one
    Python loop over iterations (and classes), everything on the device, no
    host sync per level.

    ``grad_fn(y, f, w) -> (g, h)``, shaped like ``f``: (Rl,), or (K, Rl)
    for K = ``cfg.nclass`` > 1; ``keys`` (T, 2) uint32 tree keys (the
    reference's ``split(PRNGKey(seed), ntrees)`` rows); ``rates`` (T,)
    float32 learn rate factors (learn_rate_annealing^i);
    ``iscat``/``nedges`` (F,) are read only under ``cfg.use_sets``,
    ``mono`` (F,) only under ``cfg.use_monotone`` and ``imat`` (F, F)
    only under ``cfg.use_interaction``.

    Per iteration: the row sample ``s`` from ``fold_in(key, 0)`` over the
    padded rows (the reference's shard 0), g, h and w scaled by it, one tree
    — or for K > 1 one per class with the keys ``split(fold_in(key, 31),
    K)`` — the carried margin moved by the leaf values, and each row out of
    the bag collecting the trees' outputs. Quantile and huber leaves read
    the residuals ``y - f`` (K = 1). Returns (f, oob_sum (like f), oob_cnt
    (Rl,), trees): feat, thr, nanL, val, gain each (T, N) or (T, K, N),
    catd (T, [K,] N, nbins | 1)."""
    K = cfg.nclass
    Rl = w.shape[-1]
    dev = w.device
    sampled = cfg.sample_rate < 1.0
    mono = mono if cfg.use_monotone else None
    imat = imat if cfg.use_interaction else None
    leafq = cfg.leaf_quantile is not None or cfg.huber_leaf_alpha is not None
    osum = torch.zeros_like(f)
    ocnt = torch.zeros((Rl,), dtype=torch.float32, device=dev)
    trees = []
    for key, rate in zip(keys, rates):
        if sampled:
            s = (threefry.uniform(threefry.fold_in(key, 0), (Rl,), dev)
                 < _f32(cfg.sample_rate)).to(torch.float32)
        else:
            s = torch.ones((Rl,), dtype=torch.float32, device=dev)
        g, h = grad_fn(y, f, w)
        if K == 1:
            grown = [_grow_tree(Xb, g * s, h * s, w * s, edges, edge_ok, key,
                                cfg, iscat, nedges, mono, imat,
                                resid=(y - f) if leafq else None, w_full=w)]
        else:
            ckeys = threefry.split(threefry.fold_in(key, 31), K)
            grown = [_grow_tree(Xb, g[k] * s, h[k] * s, w * s, edges, edge_ok,
                                ckeys[k], cfg, iscat, nedges, mono, imat)
                     for k in range(K)]
        parts, delta = [], []
        for ft, th, nl, vl, ga, cd, node in grown:
            # annealed rate first, then the cap (GBM.java:716-719)
            vl = vl * rate
            if math.isfinite(cfg.max_abs_leafnode_pred):
                vl = torch.clamp(vl, -cfg.max_abs_leafnode_pred,
                                 cfg.max_abs_leafnode_pred)
            parts.append((ft, th, nl, vl, ga, cd))
            delta.append(vl[node.long()])
        delta = delta[0] if K == 1 else torch.stack(delta)
        f = f + delta
        if sampled:
            # OOB accumulation (`DRF.java` OOB scoring)
            oob = 1.0 - s
            osum = osum + delta * oob
            ocnt = ocnt + oob
        trees.append(parts[0] if K == 1
                     else tuple(torch.stack(t) for t in zip(*parts)))
    return f, osum, ocnt, tuple(torch.stack(t) for t in zip(*trees))


def predict_forest(X, feat, thr, nanL, val, max_depth: int, catd=None,
                   iscat=None, nedges=None) -> torch.Tensor:
    """X (R, F) raw values; feat/thr/nanL/val (T, N), or (T, K, N) for a
    multinomial forest. Returns the summed tree outputs (R,), or (R, K).
    Each level reads the row's value at its node's split feature with a
    gather and tests the raw threshold; at a set-split node (``catd`` (T,
    [K,] N, nb) given and the feature flagged in ``iscat``) the level code
    maps to its bin, ``min(level, nedges[f])``, and the node's direction row
    is read there; NA follows the node's NA direction; leaves hold their
    node."""
    if feat.dim() == 3:
        return torch.stack([
            predict_forest(X, feat[:, k], thr[:, k], nanL[:, k], val[:, k],
                           max_depth, None if catd is None else catd[:, k],
                           iscat, nedges)
            for k in range(feat.shape[1])], dim=1)
    R = X.shape[0]
    out = torch.zeros((R,), dtype=torch.float32, device=X.device)
    for t in range(feat.shape[0]):
        ft, th, nl, vl = feat[t].long(), thr[t], nanL[t], val[t]
        node = torch.zeros((R,), dtype=torch.int64, device=X.device)
        for _ in range(max_depth):
            f_n = ft[node]
            fc = torch.clamp(f_n, min=0)
            x = torch.gather(X, 1, fc[:, None])[:, 0]
            num_right = x > th[node]
            if catd is not None:
                isset = iscat[fc] & (f_n >= 0)
                xb = torch.minimum(torch.clamp(torch.nan_to_num(x), min=0.0),
                                   nedges[fc].to(torch.float32)).long()
                num_right = torch.where(isset, catd[t][node, xb] > 0.5,
                                        num_right)
            go_right = torch.where(torch.isnan(x), ~nl[node], num_right)
            node = torch.where(f_n < 0, node, 2 * node + 1 + go_right.long())
        out = out + vl[node]
    return out
