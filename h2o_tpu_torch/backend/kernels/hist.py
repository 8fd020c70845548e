"""Level-histogram accumulation (``h2o_tpu/backend/kernels/hist.py``).

One call accumulates the channel histogram of one tree level from
int8/int16/int32 bin codes, either flat — one (F, n_lv, B, V) accumulator —
or per width bucket of ``engine.plan_hist_groups`` — one (Fg, n_lv, Bg, V)
accumulator per group, each group's NA bucket in its last slot. Two forms of
each:

- ``_torch_flat`` / ``_torch_grouped``: the plain versions, ports of the
  reference's ``_xla_flat`` / ``_xla_grouped`` and their per-block math
  (``_flat_contrib``, ``_one_group_contrib``, ``_group_contrib``) — row
  blocks summed in ascending order, one-hot products or, for ``segsum``
  groups, an ``index_add_`` over (feature, node, bin) keys. They run for CPU
  tensors and are the oracles the card is checked against.
- ``_cuda_flat`` / ``_cuda_grouped``: wrappers of the hand-written Hopper
  kernel ``csrc/level_hist.cu``, which replaces both ``hist.py::_pallas_flat``
  and ``hist.py::_pallas_grouped``: a deterministic fixed-point scatter-add
  into shared-memory tiles of (feature, node range) pieces, one launch per
  level for all groups, reading the code matrix in place.

``level_hist_blocks`` and ``level_hist_one_group`` dispatch on the tensor's
device only: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import check, load_library, pow2_block_rows

#: launches of the kernel through the flat wrapper in this process — a plain
#: counter a run reads to show its main path went through the kernel
LAUNCHES = 0
#: launches of the kernel through the grouped wrapper, counted apart
GROUPED_LAUNCHES = 0

_CODE_DTYPES = (torch.int8, torch.int16, torch.int32)
#: shared memory of one CTA tile, item table included — two CTAs per SM
_TILE_BYTES = 112 * 1024
#: the kernel's per-CTA shared-memory ceiling on Hopper (227 KB): one node
#: of one feature, Bg x V int64 cells plus the item table, must fit
_MAX_TILE_BYTES = 232_448
#: the kernel's item table: at most 64 items of six int32 per tile
_MAX_ITEMS = 64
_ITEM_BYTES = _MAX_ITEMS * 6 * 4


# ---------------------------------------------------------------------------
# plain versions — the per-block math of the reference, in torch
# ---------------------------------------------------------------------------
def _node_outer(l, vv, n_lv: int) -> torch.Tensor:
    """(rb, n_lv, V) channel values routed to the row's node slot: an outer
    product against the node one-hot (exact, one 1.0 per row)."""
    n_oh = (l[:, None] == torch.arange(n_lv, device=l.device)).to(torch.float32)
    return n_oh[:, :, None] * vv[:, None, :]


def _flat_contrib(xb, l, vv, n_lv: int, nbins_tot: int) -> torch.Tensor:
    """One row block's (F, n_lv, B, V) contribution in flat bin space. A
    code or node id out of range matches no one-hot column and adds
    nothing, as ``jax.nn.one_hot`` does."""
    xb = xb.to(torch.int32)
    b_oh = (xb[:, :, None] == torch.arange(nbins_tot, device=xb.device)
            ).to(torch.float32)                                    # (rb, F, B)
    return torch.einsum("rnv,rfb->fnbv", _node_outer(l, vv, n_lv), b_oh)


def _one_group_contrib(xg, a, l, vv, Bg: int, mode: str, n_lv: int,
                       na_global: int) -> torch.Tensor:
    """One width bucket's (Fg, n_lv, Bg, V) block contribution from the
    group's gathered code block ``xg``; the global NA code remaps to the
    group's last slot. ``segsum`` groups sum by (feature, node, bin) keys with
    ``index_add_`` (the reference's ``segment_sum``), ``onehot`` groups by the
    one-hot product; codes outside [0, Bg) and node ids outside [0, n_lv) add
    nothing in both (the reference's segment sum reads only in-range keys,
    which is all the engine produces)."""
    xg = xg.to(torch.int32)
    Fg = xg.shape[1]
    xg = torch.where(xg == na_global, Bg - 1, xg)
    if mode == "segsum":
        rb, V = vv.shape
        n = Fg * n_lv * Bg
        fi = torch.arange(Fg, dtype=torch.int32, device=xg.device)[None, :]
        seg = (fi * n_lv + l[:, None]) * Bg + xg                   # (rb, Fg)
        ok = (xg >= 0) & (xg < Bg) & (l[:, None] >= 0) & (l[:, None] < n_lv)
        seg = torch.where(ok, seg, n).reshape(-1).to(torch.int64)  # n = dump
        data = vv[:, None, :].expand(rb, Fg, V).reshape(-1, V)
        h = torch.zeros((n + 1, V), dtype=torch.float32, device=vv.device)
        return h.index_add_(0, seg, data)[:n].reshape(Fg, n_lv, Bg, V)
    b_oh = (xg[:, :, None] == torch.arange(Bg, device=xg.device)
            ).to(torch.float32)                                    # (rb, Fg, Bg)
    return torch.einsum("rnv,rfb->fnbv", a, b_oh)


def _group_contrib(xgs, l, vv, groups, n_lv: int, na_global: int):
    a = _node_outer(l, vv, n_lv)   # shared across onehot groups — exact
    return tuple(_one_group_contrib(xg, a, l, vv, Bg, mode, n_lv, na_global)
                 for xg, (_idxs, Bg, mode) in zip(xgs, groups))


def _torch_flat(Xb, lc, vv, n_lv: int, nbins_tot: int, rb: int) -> torch.Tensor:
    Rl, F = Xb.shape
    hist = torch.zeros((F, n_lv, nbins_tot, vv.shape[1]), dtype=torch.float32,
                       device=Xb.device)
    for s in range(0, Rl, rb):
        hist += _flat_contrib(Xb[s:s + rb], lc[s:s + rb], vv[s:s + rb],
                              n_lv, nbins_tot)
    return hist


def _torch_grouped(xgs, lc, vv, groups, n_lv: int, na_global: int,
                   rb: int) -> tuple:
    """Per-group accumulators over ascending row blocks; ``xgs`` are the
    groups' gathered code columns."""
    V = vv.shape[1]
    hists = tuple(torch.zeros((len(idxs), n_lv, Bg, V), dtype=torch.float32,
                              device=vv.device)
                  for idxs, Bg, _mode in groups)
    for s in range(0, lc.shape[0], rb):
        cs = _group_contrib([xg[s:s + rb] for xg in xgs], lc[s:s + rb],
                            vv[s:s + rb], groups, n_lv, na_global)
        for h, c in zip(hists, cs):
            h += c
    return hists


# ---------------------------------------------------------------------------
# the CUDA kernel's wrappers
# ---------------------------------------------------------------------------
def _tile_plan(feats, n_lv: int, V: int):
    """Pack the output into CTA tiles. ``feats`` is ((column, Bg, offset of
    the feature's (n_lv, Bg, V) block), ...). A feature whose block exceeds a
    tile is cut into balanced node ranges; the pieces are packed greedily in
    order into tiles of at most ``_TILE_BYTES``. Returns (items, tile_start,
    tile_cells): items as (column, n0, n1, Bg, tile offset, output offset)
    rows."""
    cap = (_TILE_BYTES - _ITEM_BYTES) // 8
    pieces = []
    for col, bg, off in feats:
        per_node = bg * V
        if (per_node * 8 + _ITEM_BYTES) > _MAX_TILE_BYTES:
            raise NotImplementedError(
                f"one node of a {bg}-bin feature ({bg} x {V} int64 cells) "
                f"exceeds the {_MAX_TILE_BYTES} bytes of shared memory a "
                f"CTA can hold")
        npt = max(1, min(n_lv, cap // per_node))
        k = -(-n_lv // npt)
        bounds = [n_lv * i // k for i in range(k + 1)]
        for n0, n1 in zip(bounds, bounds[1:]):
            pieces.append((col, n0, n1, bg, off + n0 * per_node,
                           (n1 - n0) * per_node))

    tiles, cur, used = [], [], 0
    for p in pieces:
        if cur and (used + p[5] > cap or len(cur) == _MAX_ITEMS):
            tiles.append(cur)
            cur, used = [], 0
        cur.append(p)
        used += p[5]
    tiles.append(cur)
    items, starts, tile_cells = [], [0], 0
    for tile in tiles:
        used = 0
        for col, n0, n1, bg, out_off, cells in tile:
            items.append((col, n0, n1, bg, used, out_off))
            used += cells
        starts.append(len(items))
        tile_cells = max(tile_cells, used)
    return items, starts, tile_cells


#: device copies of tile plans, keyed by (feats, n_lv, V, device): a level's
#: plan is built once, so the launches of a training run copy nothing
_PLANS: dict = {}


def _device_plan(feats, n_lv: int, V: int, dev: torch.device):
    key = (feats, n_lv, V, str(dev))
    plan = _PLANS.get(key)
    if plan is None:
        items, starts, tile_cells = _tile_plan(feats, n_lv, V)
        plan = (torch.tensor(items, dtype=torch.int32, device=dev),
                torch.tensor(starts, dtype=torch.int32, device=dev),
                len(starts) - 1, tile_cells)
        _PLANS[key] = plan
    return plan


def _check_inputs(Xb, lc, vv) -> None:
    Rl = Xb.shape[0]
    V = vv.shape[1] if vv.dim() == 2 else 0
    dev = Xb.device
    if lc.device != dev or vv.device != dev:
        raise ValueError(f"codes on {dev}, node ids on {lc.device}, values "
                         f"on {vv.device}")
    if Xb.dtype not in _CODE_DTYPES:
        raise TypeError(f"codes must be int8/int16/int32, got {Xb.dtype}")
    if lc.dtype != torch.int32 or vv.dtype != torch.float32:
        raise TypeError(f"node ids must be int32 and values float32, got "
                        f"{lc.dtype} and {vv.dtype}")
    if Xb.dim() != 2 or lc.shape != (Rl,) or vv.shape != (Rl, V) \
            or not 1 <= V <= 4:
        raise ValueError(f"shapes codes {tuple(Xb.shape)}, node ids "
                         f"{tuple(lc.shape)}, values {tuple(vv.shape)}: "
                         f"want (R, F), (R,), (R, V) with 1 <= V <= 4")
    if not (Xb.is_contiguous() and lc.is_contiguous() and vv.is_contiguous()):
        raise ValueError("codes, node ids and values must be contiguous")


def _launch(Xb, lc, vv, n_lv: int, na_code: int, feats,
            n_cells: int) -> torch.Tensor:
    """One launch of ``csrc/level_hist.cu`` on the current stream over the
    plan ``feats`` (inputs already checked); returns the (n_cells,) float32
    output."""
    if n_cells >= 2 ** 31:
        raise NotImplementedError(f"{n_cells} histogram cells exceed the "
                                  f"kernel's int32 offsets")
    Rl, F = Xb.shape
    V = vv.shape[1]
    dev = Xb.device
    items, starts, n_tiles, tile_cells = _device_plan(feats, n_lv, V, dev)
    lib = load_library()
    acc = torch.zeros(n_cells, dtype=torch.int64, device=dev)
    amax = torch.zeros(V, dtype=torch.int32, device=dev)
    scale = torch.empty(V, dtype=torch.float64, device=dev)
    out = torch.empty(n_cells, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.h2o_level_hist(
            Xb.data_ptr(), Xb.element_size(), lc.data_ptr(), vv.data_ptr(),
            Rl, F, V, n_lv, na_code, items.data_ptr(), starts.data_ptr(),
            n_tiles, tile_cells, acc.data_ptr(), n_cells, amax.data_ptr(),
            scale.data_ptr(), out.data_ptr(), stream)
    check(lib, rc, "level_hist")
    return out


def _cuda_flat(Xb, lc, vv, n_lv: int, nbins_tot: int) -> torch.Tensor:
    """Flat plan: every feature at width ``nbins_tot`` -> (F, n_lv, B, V)."""
    global LAUNCHES
    _check_inputs(Xb, lc, vv)
    F, V = Xb.shape[1], vv.shape[1]
    block = n_lv * nbins_tot * V
    feats = tuple((f, nbins_tot, f * block) for f in range(F))
    out = _launch(Xb, lc, vv, n_lv, nbins_tot - 1, feats, F * block)
    LAUNCHES += 1
    return out.view(F, n_lv, nbins_tot, V)


def _cuda_grouped(Xb, lc, vv, groups, n_lv: int, na_global: int) -> tuple:
    """Grouped plan, all groups in one launch, codes read in place from
    ``Xb``: returns one (Fg, n_lv, Bg, V) view per group, in ``groups``
    order."""
    global GROUPED_LAUNCHES
    _check_inputs(Xb, lc, vv)
    V = vv.shape[1]
    feats, shapes, off = [], [], 0
    for idxs, Bg, _mode in groups:
        block = n_lv * Bg * V
        for i, f in enumerate(idxs):
            if not 0 <= f < Xb.shape[1]:
                raise ValueError(f"group column {f} outside the {Xb.shape[1]} "
                                 f"code columns")
            feats.append((int(f), int(Bg), off + i * block))
        shapes.append((len(idxs), n_lv, int(Bg), V))
        off += len(idxs) * block
    out = _launch(Xb, lc, vv, n_lv, na_global, tuple(feats), off)
    GROUPED_LAUNCHES += 1
    views, s = [], 0
    for shp in shapes:
        n = shp[0] * shp[1] * shp[2] * shp[3]
        views.append(out[s:s + n].view(shp))
        s += n
    return tuple(views)


# ---------------------------------------------------------------------------
# public entry — what engine._build_level_hist calls
# ---------------------------------------------------------------------------
def _check_device(dev: torch.device) -> None:
    if dev.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"no level-histogram path for {dev}")


def level_hist_one_group(xg, lc, vv, *, Bg: int, mode: str, n_lv: int,
                         nbins_tot: int, block: int) -> torch.Tensor:
    """One width bucket accumulated on its own (the reference's async-psum
    shape): ``xg`` holds the group's code columns. Returns (Fg, n_lv, Bg,
    V). A one-group call of the same kernel on the card."""
    groups1 = ((tuple(range(xg.shape[1])), Bg, mode),)
    _check_device(xg.device)
    if xg.device.type == "cuda":
        return _cuda_grouped(xg, lc, vv, groups1, n_lv, nbins_tot - 1)[0]
    return _torch_grouped([xg], lc, vv, groups1, n_lv, nbins_tot - 1,
                          pow2_block_rows(lc.shape[0], block))[0]


def level_hist_blocks(Xb, lc, vv, *, n_lv: int, nbins_tot: int, block: int,
                      groups=None):
    """Per-level histogram accumulation over row blocks.

    ``Xb`` (Rl, F) int8/int16/int32 bin codes; ``lc`` (Rl,) int32 local
    node ids in [0, n_lv); ``vv`` (Rl, V) float32 channel values already
    zeroed for inactive rows. Flat (``groups=None``) returns the (F, n_lv,
    nbins_tot, V) accumulator; grouped returns a tuple with one (Fg, n_lv,
    Bg, V) accumulator per normalized group, each group's NA bucket in its
    LAST slot. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel.
    """
    _check_device(Xb.device)
    cuda = Xb.device.type == "cuda"
    if groups is None:
        if cuda:
            return _cuda_flat(Xb, lc, vv, n_lv, nbins_tot)
        return _torch_flat(Xb, lc, vv, n_lv, nbins_tot,
                           pow2_block_rows(Xb.shape[0], block))
    if cuda:
        return _cuda_grouped(Xb, lc, vv, groups, n_lv, nbins_tot - 1)
    xgs = [Xb[:, list(idxs)] for idxs, _Bg, _mode in groups]
    return _torch_grouped(xgs, lc, vv, groups, n_lv, nbins_tot - 1,
                          pow2_block_rows(Xb.shape[0], block))
