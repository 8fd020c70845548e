"""Feature binning for the histogram tree engine
(``h2o_tpu/models/tree/binning.py``).

Global bin edges per feature from a two-pass histogram quantile sketch over
all rows (categorical features: one cut per level code), then int codes
``bin = #edges < x`` with NA (and padding) in the dedicated bucket
``nbins``. Layout as in the reference: ``edges`` (F, W)
float32 right-inclusive cuts, NaN-padded.

Parity: the sketch's histogram cells are exact integer counts (any
accumulation order gives the same f32 value), and every float step below is
the reference's operation in the reference's order, one IEEE op per torch
call. The one multiply-add that XLA contracts is formed exactly here (see
`_hist_quantile_rows`).
"""

from __future__ import annotations

import numpy as np
import torch

from ...backend.memory import hbm_budget_bytes
from ...utils.knobs import get_int

#: planning fallback when no accelerator budget is resolvable (the CPU)
_DEFAULT_SKETCH_BUDGET = 4 << 30

_UNSET = object()  # "resolve the budget from the columns' device"


def _pow2_block(R: int, want: int) -> int:
    """Largest power-of-two divisor of R up to ``want`` (>= 1 always)."""
    b = 1
    while b * 2 <= want and R % (b * 2) == 0:
        b *= 2
    return b


def _sketch_plan(R: int, F: int, nb: int,
                 budget_bytes: int | None) -> tuple[int, int]:
    """(rb, Fb) row- and feature-block sizes for the quantile sketch from a
    memory budget — the reference's plan, verbatim."""
    budget = budget_bytes or _DEFAULT_SKETCH_BUDGET
    col_cap = max(budget // 4, 1 << 20)
    onehot_cap = max(budget // 8, 1 << 20)
    Fb = int(min(F, max(1, col_cap // (4 * max(R, 1)))))
    rb = 1024
    while rb > 64 and rb * Fb * nb * 4 > onehot_cap:
        rb //= 2
    while Fb > 1 and rb * Fb * nb * 4 > onehot_cap:
        Fb = max(1, Fb // 2)
    return rb, Fb


def _nan_extrema(X: torch.Tensor):
    """Per-column (nanmin, nanmax); NaN for an all-NaN column (jnp.nanmin)."""
    ok = ~torch.isnan(X)
    mn = torch.where(ok, X, torch.inf).amin(dim=0)
    mx = torch.where(ok, X, -torch.inf).amax(dim=0)
    some = ok.any(dim=0)
    return (torch.where(some, mn, torch.nan),
            torch.where(some, mx, torch.nan))


def _bin_counts(X: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                nb: int) -> torch.Tensor:
    """(F, nb) f32 counts of ``clip(int((x - lo) / span * nb), 0, nb-1)``
    over non-NaN rows. Counts are integers, so they equal the reference's
    f32 one-hot sums exactly. The clip is applied to the float before the
    int conversion: XLA's f32->s32 convert saturates, torch's does not."""
    R, F = X.shape
    span = torch.clamp(hi - lo, min=1e-30)
    v = (X - lo[None, :]) / span[None, :] * nb
    b = torch.clamp(v, 0, nb - 1).to(torch.int32)
    keys = b + torch.arange(F, dtype=torch.int32, device=X.device)[None, :] * nb
    keys = torch.where(torch.isnan(X), F * nb, keys)      # NaN -> dump slot
    counts = torch.bincount(keys.reshape(-1), minlength=F * nb + 1)
    return counts[:F * nb].reshape(F, nb).to(torch.float32)


def _hist_quantile_rows(X: torch.Tensor, qs,
                        fused: bool = True) -> torch.Tensor:
    """(nq, F) per-column quantiles via the reference's TWO-PASS histogram
    sketch (``binning.py:_hist_quantile_rows``): pass 1 spans [min, max],
    pass 2 re-bins inside the [0.1%, 99.9%] bracket, and each quantile is
    read linearly inside its pass-2 bin. ``fused=False`` rounds the
    product ``q * (nval - 1)`` before the subtraction below."""
    nb = 1024
    ok = ~torch.isnan(X)
    nval = ok.sum(dim=0).to(torch.float32)
    cmin, cmax = _nan_extrema(X)

    cum1 = torch.cumsum(_bin_counts(X, cmin, cmax, nb), dim=1)
    span1 = torch.clamp(cmax - cmin, min=1e-30)
    ar = torch.arange(1, nb + 1, dtype=torch.float32, device=X.device)
    edges1 = cmin[:, None] + span1[:, None] * ar[None, :] / nb

    def bracket(frac):
        target = frac * nval
        idx = torch.argmax((cum1 >= target[:, None]).to(torch.uint8), dim=1)
        return torch.gather(edges1, 1, idx[:, None])[:, 0]

    lo2 = torch.minimum(bracket(0.001) - span1 / nb, cmax)
    hi2 = torch.maximum(bracket(0.999) + span1 / nb, lo2 + 1e-30)
    h2 = _bin_counts(X, lo2, hi2, nb)
    cum2 = torch.cumsum(h2, dim=1)
    span2 = torch.clamp(hi2 - lo2, min=1e-30)
    q = torch.tensor(np.asarray(qs, np.float32), device=X.device)[:, None]
    target = q * torch.clamp(nval[None, :] - 1.0, min=0.0)        # (nq, F)
    ge = cum2[None, :, :] >= target[:, :, None]                   # (nq, F, nb)
    bidx = torch.argmax(ge.to(torch.uint8), dim=2)                # (nq, F)
    nq = target.shape[0]
    cum2b = cum2[None].expand(nq, -1, -1)
    cum_before = torch.where(
        bidx > 0,
        torch.gather(cum2b, 2, torch.clamp(bidx - 1, min=0)[:, :, None])[:, :, 0],
        0.0)
    cnt = torch.gather(h2[None].expand(nq, -1, -1), 2, bidx[:, :, None])[:, :, 0]
    # ``q * (nval - 1) - cum_before`` is a cancellation. XLA's CPU backend
    # contracts it into an FMA (the product never rounded) in most lanes of
    # its vectorised loop; separate f32 ops would round the product and move
    # such an edge by up to ~32 of its own ulps. The numerator is formed
    # exactly in float64 (a 24x24-bit product minus an integer count fits in
    # 53 bits) and rounded once, as the FMA rounds it; lanes where XLA does
    # not contract still differ by about an ulp of the column's magnitude.
    if fused:
        num = (q.double() * torch.clamp(nval[None, :] - 1.0, min=0.0).double()
               - cum_before.double()).to(torch.float32)
    else:
        num = target - cum_before
    frac = torch.clamp(num / torch.clamp(cnt, min=1e-30), 0, 1)
    out = lo2[None, :] + (bidx.to(torch.float32) + frac) * span2[None, :] / nb
    return torch.where(nval[None, :] > 0, out, torch.nan)


def _coldata(c) -> torch.Tensor:
    return c.data if hasattr(c, "data") else c


def _resolve_budget(budget_bytes, cols):
    if budget_bytes is _UNSET:
        return hbm_budget_bytes(_coldata(cols[0]).device)
    return budget_bytes


def hist_quantile_sketch_cols(cols, qs, budget_bytes=_UNSET) -> np.ndarray:
    """The sketch fed from per-column Vecs/tensors in Fb-sized column blocks
    planned by `_sketch_plan` (each column's quantiles depend only on that
    column, so blocking is exact). Returns the host (nq, F) array."""
    cols = list(cols)
    budget_bytes = _resolve_budget(budget_bytes, cols)
    F = len(cols)
    R = int(_coldata(cols[0]).shape[0])
    _, Fb = _sketch_plan(R, F, 1024, budget_bytes)
    out = np.empty((len(qs), F), np.float32)
    for f0 in range(0, F, Fb):
        blk = torch.stack([_coldata(c) for c in cols[f0:f0 + Fb]], dim=1)
        out[:, f0:f0 + Fb] = _hist_quantile_rows(blk, qs).cpu().numpy()
    return out


def hist_quantile_sketch(x: torch.Tensor, qs) -> np.ndarray:
    """The sketch of one column (``binning.py:155`` on an (R, 1) matrix,
    GAM's knots): the host (nq,) quantiles. XLA's CPU code for that shape
    leaves ``q * (nval - 1) - cum_before`` uncontracted in its vector
    lanes, so the product is rounded here (``fused=False``); in the lanes
    past the last whole vector of quantiles it contracts, and a knot there
    may sit a few ulps from the reference's (ROADMAP Queue 3 item 25)."""
    return _hist_quantile_rows(x[:, None], qs, fused=False)[:, 0].cpu().numpy()


def _distinct_values(X: torch.Tensor, cap: int):
    """Per-column distinct values: (cap, F) ascending and NaN-padded, plus
    the true (F,) distinct counts (which may exceed cap)."""
    R, F = X.shape
    S = torch.sort(X, dim=0).values                    # NaN sorts last
    new = torch.cat([torch.ones((1, F), dtype=torch.bool, device=X.device),
                     S[1:] != S[:-1]], dim=0) & ~torch.isnan(S)
    counts = new.sum(dim=0)
    pos = torch.cumsum(new.to(torch.int64), dim=0) - 1
    rows = torch.where(new, torch.clamp(pos, max=cap - 1), cap)  # cap = dump
    out = torch.full((cap + 1, F), torch.nan, dtype=torch.float32,
                     device=X.device)
    cols = torch.arange(F, device=X.device)[None, :].expand(R, F)
    keep = rows < cap
    out[rows[keep], cols[keep]] = S[keep].to(torch.float32)
    return out[:cap], counts


def _exact_bin_row_limit() -> int:
    return get_int("H2O_TORCH_EXACT_BIN_ROWS")


def _validate_ht(histogram_type: str) -> str:
    ht = (histogram_type or "AUTO").lower()
    if ht not in ("auto", "quantilesglobal", "uniformadaptive", "random",
                  "exact"):
        raise ValueError(
            f"unsupported histogram_type '{histogram_type}' — supported: "
            f"AUTO, QuantilesGlobal, UniformAdaptive, Random, Exact")
    return ht


def _wants_exact(ht: str, R: int, nbins: int, nbins_top_level: int) -> bool:
    """Exact cuts: always for ``Exact``, and on small data (at most
    ``H2O_TORCH_EXACT_BIN_ROWS`` rows) for the quantile and uniform types
    when ``nbins_top_level`` exceeds ``nbins`` (the reference's rule)."""
    return (ht == "exact"
            or (R <= _exact_bin_row_limit() and nbins_top_level > nbins
                and ht in ("auto", "quantilesglobal", "uniformadaptive")))


def _edges_from_stats(F, is_cat, col_min, col_max, qrows, exact, ht,
                      nbins, nbins_top_level, nbins_cats,
                      seed: int) -> np.ndarray:
    """Per-feature cut assembly from host-side column stats (the
    reference's shared tail). An exact column (at most ``nbins_top_level``
    distinct values) cuts at the midpoints between its distinct values,
    formed in float64 and rounded to float32 as the reference does; a
    column with more keeps its quantile cuts."""
    all_cuts: list = []
    for f in range(F):
        if not np.isfinite(col_max[f]):  # all-NaN column
            all_cuts.append(np.zeros(0, np.float32))
            continue
        if exact is not None and not is_cat[f] and \
                0 < int(exact[1][f]) <= nbins_top_level:
            u = exact[0][:int(exact[1][f]), f].astype(np.float64)
            all_cuts.append(((u[:-1] + u[1:]) / 2).astype(np.float32))
            continue
        if is_cat[f]:
            # one bin per observed level, capped by nbins_cats: cuts at codes
            # 0..min(card, nbins_cats)-2, so bin = min(level, n_cuts)
            card = int(col_max[f]) + 1
            cuts = np.arange(min(card - 1, nbins_cats - 1), dtype=np.float32)
        elif ht == "uniformadaptive":
            lo, hi = float(col_min[f]), float(col_max[f])
            cuts = (np.unique(np.linspace(lo, hi, nbins + 1)[1:-1]
                              .astype(np.float32)) if hi > lo
                    else np.zeros(0, np.float32))
        elif ht == "random":
            # XRT's cuts: nbins - 1 uniform draws per feature from its own
            # numpy stream (the reference's seed rule)
            lo, hi = float(col_min[f]), float(col_max[f])
            rrng = np.random.default_rng(seed + 7919 * f)
            cuts = (np.unique(rrng.uniform(lo, hi, nbins - 1)
                              .astype(np.float32)) if hi > lo
                    else np.zeros(0, np.float32))
        else:  # AUTO / QuantilesGlobal
            col = qrows[:, f]
            cuts = np.unique(col[~np.isnan(col)].astype(np.float32))
        all_cuts.append(cuts)
    width = max(nbins - 1, max((len(c) for c in all_cuts), default=0))
    edges = np.full((F, width), np.nan, dtype=np.float32)
    for f, cuts in enumerate(all_cuts):
        edges[f, : len(cuts)] = cuts
    return edges


def compute_bin_edges_cols(cols, is_cat: np.ndarray, nbins: int,
                           seed: int = 1234,
                           histogram_type: str = "QuantilesGlobal",
                           nbins_top_level: int = 1024,
                           nbins_cats: int = 1024,
                           budget_bytes=_UNSET) -> np.ndarray:
    """Global bin edges per feature from per-column Vecs/tensors — the raw
    (R, F) matrix is never stacked. Categorical features (``is_cat``) bin on
    their level codes, one bin per observed level up to ``nbins_cats``
    (levels at or above the cap share the top bin); numeric ones on the
    histogram type's cuts (``Random``: ``nbins - 1`` uniform cuts from
    ``seed``; ``Exact``: the midpoints between distinct values for columns
    with at most ``nbins_top_level`` of them). Returns (F, W) float32
    edges, NaN-padded where a feature has fewer cuts."""
    ht = _validate_ht(histogram_type)
    cols = list(cols)
    F = len(cols)
    if F == 0:
        return np.zeros((0, max(nbins - 1, 0)), np.float32)
    budget_bytes = _resolve_budget(budget_bytes, cols)
    R = int(_coldata(cols[0]).shape[0])
    _, Fb = _sketch_plan(R, F, 1024, budget_bytes)
    col_min = np.empty(F, np.float32)
    col_max = np.empty(F, np.float32)
    exact = None
    if _wants_exact(ht, R, nbins, nbins_top_level):
        exact = (np.empty((int(nbins_top_level), F), np.float32),
                 np.empty(F, np.int64))
    for f0 in range(0, F, Fb):
        blk = torch.stack([_coldata(c) for c in cols[f0:f0 + Fb]], dim=1)
        mn, mx = _nan_extrema(blk)
        col_min[f0:f0 + Fb] = mn.cpu().numpy()
        col_max[f0:f0 + Fb] = mx.cpu().numpy()
        if exact is not None:
            vals, counts = _distinct_values(blk, int(nbins_top_level))
            exact[0][:, f0:f0 + Fb] = vals.cpu().numpy()
            exact[1][f0:f0 + Fb] = counts.cpu().numpy()
    qrows = None
    if ht in ("auto", "quantilesglobal", "exact"):
        qs = np.linspace(0, 1, nbins + 1)[1:-1]
        qrows = hist_quantile_sketch_cols(cols, qs, budget_bytes=budget_bytes)
    return _edges_from_stats(F, is_cat, col_min, col_max, qrows, exact, ht,
                             nbins, nbins_top_level, nbins_cats, seed)


def compute_bin_edges(X: torch.Tensor, is_cat: np.ndarray, nbins: int,
                      sample: int = 200_000, seed: int = 1234,
                      histogram_type: str = "QuantilesGlobal",
                      nbins_top_level: int = 1024,
                      nbins_cats: int = 1024,
                      budget_bytes=_UNSET) -> np.ndarray:
    """The reference's stacked entry (``binning.py:309``): the bin edges of
    a (R, F) float32 matrix (NaN = NA or padding), through
    `compute_bin_edges_cols` on its columns — each column's cuts depend on
    that column alone, so the stacked and per-column forms give the same
    edges. ``sample`` is the reference's unused argument, kept for its
    signature."""
    return compute_bin_edges_cols(
        X.unbind(1), is_cat, nbins, seed=seed, histogram_type=histogram_type,
        nbins_top_level=nbins_top_level, nbins_cats=nbins_cats,
        budget_bytes=budget_bytes)


def bin_column(x: torch.Tensor, erow: torch.Tensor,
               dtype=torch.int32) -> torch.Tensor:
    """(plen,) raw values + that feature's NaN-padded edge row -> bin codes
    ``#edges < x`` in ``dtype``; NA (and padding) -> ``nbins``.

    Cut rows are ascending with their NaN padding last (every histogram type
    builds them so), so ``#edges < x`` is a left binary search over the
    row's real cuts: the same codes as the reference's compare-and-sum, in
    O(plen log W) work and without its (plen, W) intermediate, which at a
    300-level categorical and 116M rows would be 35 GB."""
    nbins = erow.shape[0] + 1
    cuts = erow[~torch.isnan(erow)].contiguous()
    b = torch.searchsorted(cuts, x.contiguous(), side="left")
    return torch.where(torch.isnan(x), nbins, b).to(dtype)
