"""Level-histogram accumulation (``h2o_tpu/backend/kernels/hist.py``).

One call accumulates the channel histogram of one tree level from
int8/int16/int32 bin codes, either flat — one (F, n_lv, B, V) accumulator —
or per width bucket of ``engine.plan_hist_groups`` — one (Fg, n_lv, Bg, V)
accumulator per group, each group's NA bucket in its last slot. Two forms of
each:

- ``_torch_flat`` / ``_torch_grouped``: the plain versions of the
  reference's ``_xla_flat`` / ``_xla_grouped``: each row's channels summed
  into its (feature, node, bin) cell, per width bucket (flat: one bucket of
  every feature at the full width), as one keyed ``scatter_add_`` in
  float64 — the reference's ``segment_sum``, which its one-hot products
  equal up to the order and rounding of the adds. Their work does not grow
  with the level's node count, as a one-hot product over 2,048 nodes would.
  They run for CPU tensors and are the oracles the card is checked
  against.
- ``_cuda_flat`` / ``_cuda_grouped``: wrappers of the hand-written Hopper
  kernel ``csrc/level_hist.cu``, which replaces both ``hist.py::_pallas_flat``
  and ``hist.py::_pallas_grouped``: a deterministic fixed-point scatter-add
  into shared-memory tiles of (feature, node range) pieces, one launch per
  level for all groups, reading the code matrix in place. The tiles of a
  level form a thread-block cluster that reads each block of rows from
  device memory once, multicast into every CTA's staging ring.

``level_hist_blocks`` and ``level_hist_one_group`` dispatch on the tensor's
device only: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import COUNT_LOCK, check, load_library

#: launches of the kernel through the flat wrapper in this process — a plain
#: counter a run reads to show its main path went through the kernel
LAUNCHES = 0
#: launches of the kernel through the grouped wrapper, counted apart
GROUPED_LAUNCHES = 0

_CODE_DTYPES = (torch.int8, torch.int16, torch.int32)
#: shared memory a CTA can hold on Hopper (227 KB)
_SMEM_BYTES = 232_448
#: the kernel's item table (at most 64 items of six int32 per tile), ahead
#: of the staging ring and the tile
_MAX_ITEMS = 64
_ITEM_BYTES = _MAX_ITEMS * 6 * 4
#: the staging ring: the stages' mbarriers, then _STAGES blocks (the
#: kernel's kStages) of up to _RING_ROWS rows (codes, node ids, channels;
#: one row per thread of the kernel's 1024), at most _RING_BYTES in all;
#: the rest holds the tile
_BAR_BYTES = 128
_STAGES = 2
_RING_ROWS = 1024
_RING_BYTES = 96 * 1024
#: CTAs in a thread-block cluster (the portable maximum)
_MAX_CLUSTER = 8


# ---------------------------------------------------------------------------
# plain versions — keyed sums, in torch
# ---------------------------------------------------------------------------
def _group_keys(xg, l, Bg: int, n_lv: int, na_global: int,
                V: int) -> torch.Tensor:
    """Each (row, feature, channel) value's flat index into one width
    bucket's (Fg, n_lv, Bg, V) block, the global NA code remapped to the
    group's last slot; codes outside [0, Bg) and node ids outside [0, n_lv)
    go to the dump cell Fg * n_lv * Bg and add nothing, as in the reference
    (its one-hot has no column for them, its segment sum drops them)."""
    xg = xg.to(torch.int64)
    Fg = xg.shape[1]
    xg = torch.where(xg == na_global, Bg - 1, xg)
    lc = l.to(torch.int64)[:, None]
    fi = torch.arange(Fg, device=xg.device)[None, :]
    ok = (xg >= 0) & (xg < Bg) & (lc >= 0) & (lc < n_lv)
    cell = torch.where(ok, (fi * n_lv + lc) * Bg + xg, Fg * n_lv * Bg)
    return (cell[:, :, None] * V
            + torch.arange(V, device=xg.device)).reshape(-1)


#: rows per step of the plain versions: bounds their (rows, Fg, V) keys
_PLAIN_ROWS = 1 << 16


def _torch_grouped(xgs, lc, vv, groups, n_lv: int, na_global: int,
                   rb: int = _PLAIN_ROWS) -> tuple:
    """Per-group accumulators; ``xgs`` are the groups' gathered code
    columns. One ``scatter_add_`` per step of ``rb`` rows into one float64
    buffer per group, rounded to float32 once: on the CPU the adds run in
    row order, so the result does not depend on ``rb``, and in float64 the
    order hardly matters, so each cell comes out as the card kernel's exact
    fixed-point sum does, rounded once (a float32 running sum over a million
    rows would drift by ~1e-3 of the cell and move near-tied splits)."""
    V = vv.shape[1]
    hists = []
    for xg, (idxs, Bg, _mode) in zip(xgs, groups):
        n = len(idxs) * n_lv * Bg * V
        h = torch.zeros(n + V, dtype=torch.float64, device=vv.device)
        for s in range(0, lc.shape[0], rb):
            keys = _group_keys(xg[s:s + rb], lc[s:s + rb], Bg, n_lv,
                               na_global, V)
            v = vv[s:s + rb].double()
            h.scatter_add_(0, keys, v[:, None, :].expand(
                v.shape[0], len(idxs), V).reshape(-1))
        hists.append(h[:n].to(torch.float32).view(len(idxs), n_lv, Bg, V))
    return tuple(hists)


def _torch_flat(Xb, lc, vv, n_lv: int, nbins_tot: int,
                rb: int = _PLAIN_ROWS) -> torch.Tensor:
    """The flat plan: one bucket of every feature at width ``nbins_tot``
    (its last slot the NA bucket) -> (F, n_lv, nbins_tot, V)."""
    F = Xb.shape[1]
    return _torch_grouped([Xb], lc, vv, ((tuple(range(F)), nbins_tot,
                                          "onehot"),),
                          n_lv, nbins_tot - 1, rb)[0]


# ---------------------------------------------------------------------------
# the CUDA kernel's wrappers
# ---------------------------------------------------------------------------
def _ring_plan(F: int, code_bytes: int, V: int, node_cells: int):
    """(rows per staged block, ring bytes): the most rows, a multiple of 16
    up to ``_RING_ROWS``, whose ``_STAGES`` blocks of codes, node ids and
    channels fit ``_RING_BYTES`` and leave a tile room for one node of the
    widest feature (``node_cells`` int64 cells). Every block then starts on
    16 bytes. (0, 0) when not even 16 rows fit: the kernel then reads every
    row straight from device memory."""
    row_bytes = F * code_bytes + 4 + 4 * V
    room = min(_RING_BYTES,
               _SMEM_BYTES - _ITEM_BYTES - 8 * node_cells) - _BAR_BYTES
    rb = min(_RING_ROWS, max(room, 0) // (_STAGES * row_bytes) // 16 * 16)
    if rb < 16:
        return 0, 0
    return rb, _BAR_BYTES + _STAGES * rb * row_bytes


def _staging(Xb, lc, vv, feats):
    """The ring plan of these inputs: none when one does not start on 16
    bytes, which the kernel's bulk copies need."""
    if any(t.data_ptr() % 16 for t in (Xb, lc, vv)):
        return 0, 0
    V = vv.shape[1]
    return _ring_plan(Xb.shape[1], Xb.element_size(), V,
                      max(bg for _c, bg, _o in feats) * V)


def _packed_tiles(feats, n_lv: int, V: int, cap: int):
    """Features cut into node ranges only as far as one must be to fit
    ``cap``; the pieces go, largest first, into the fewest tiles that hold
    them, each to the tile the fewest rows reach so far (a piece's share of
    the level's nodes), so a cluster's CTAs add about equally."""
    pieces = []
    for col, bg, off in feats:
        per_node = bg * V
        npt = max(1, min(n_lv, cap // per_node))
        k = -(-n_lv // npt)
        bounds = [n_lv * i // k for i in range(k + 1)]
        for n0, n1 in zip(bounds, bounds[1:]):
            pieces.append((col, n0, n1, bg, off + n0 * per_node,
                           (n1 - n0) * per_node))
    order = sorted(range(len(pieces)), key=lambda i: -pieces[i][5])
    n_tiles = max(1, -(-sum(p[5] for p in pieces) // cap),
                  -(-len(pieces) // _MAX_ITEMS))
    while True:
        used, rows, members = ([0] * n_tiles, [0] * n_tiles,
                               [[] for _ in range(n_tiles)])
        for i in order:
            fits = [t for t in range(n_tiles) if used[t] + pieces[i][5] <= cap
                    and len(members[t]) < _MAX_ITEMS]
            if not fits:
                break
            t = min(fits, key=lambda t: (rows[t], used[t], t))
            used[t] += pieces[i][5]
            rows[t] += pieces[i][2] - pieces[i][1]
            members[t].append(i)
        else:
            return [[pieces[i] for i in sorted(idx)] for idx in members]
        n_tiles += 1


def _tile_plan(feats, n_lv: int, V: int, ring_bytes: int):
    """Pack the output into CTA tiles and the tiles into clusters.
    ``feats`` is ((column, Bg, offset of the feature's (n_lv, Bg, V)
    block), ...). A tile holds what the staging ring leaves of a CTA's
    shared memory; features are packed into tiles by ``_packed_tiles``
    (whole features where they fit: a CTA then adds for every row it
    reads, so its warps' adds run with all lanes). Tiles form clusters of at most ``_MAX_CLUSTER``, padded with empty
    tiles to equal size. Returns (items, tile_start, tile_cells, cluster):
    items as (column, n0, n1, Bg, tile offset, output offset) rows,
    tile_start with one entry per CTA (cluster-major) plus one."""
    cap = (_SMEM_BYTES - _ITEM_BYTES - ring_bytes) // 8
    for _col, bg, _off in feats:
        if bg * V > cap:
            raise NotImplementedError(
                f"one node of a {bg}-bin feature ({bg} x {V} int64 cells) "
                f"exceeds the {cap * 8} bytes of shared memory a CTA has "
                f"beside its staging ring")
    tiles = _packed_tiles(feats, n_lv, V, cap)
    n_cl = -(-len(tiles) // _MAX_CLUSTER)
    cluster = -(-len(tiles) // n_cl)
    tiles += [[] for _ in range(n_cl * cluster - len(tiles))]
    items, starts, tile_cells = [], [0], 0
    for tile in tiles:
        used = 0
        for col, n0, n1, bg, out_off, cells in tile:
            items.append((col, n0, n1, bg, used, out_off))
            used += cells
        starts.append(len(items))
        tile_cells = max(tile_cells, used)
    return items, starts, tile_cells, cluster


#: device copies of tile plans, keyed by (feats, n_lv, V, ring, device): a
#: level's plan is built once, so the launches of a training run copy
#: nothing
_PLANS: dict = {}


def _device_plan(feats, n_lv: int, V: int, ring_bytes: int,
                 dev: torch.device):
    key = (feats, n_lv, V, ring_bytes, str(dev))
    plan = _PLANS.get(key)
    if plan is None:
        items, starts, tile_cells, cluster = _tile_plan(feats, n_lv, V,
                                                        ring_bytes)
        plan = (torch.tensor(items, dtype=torch.int32, device=dev),
                torch.tensor(starts, dtype=torch.int32, device=dev),
                len(starts) - 1, tile_cells, cluster)
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
    rb, ring = _staging(Xb, lc, vv, feats)
    items, starts, n_tiles, tile_cells, cluster = _device_plan(
        feats, n_lv, V, ring, dev)
    lib = load_library()
    acc = torch.zeros(n_cells, dtype=torch.int64, device=dev)
    amax = torch.zeros(V, dtype=torch.int32, device=dev)
    scale = torch.empty(V, dtype=torch.float64, device=dev)
    out = torch.empty(n_cells, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.h2o_level_hist(
            Xb.data_ptr(), Xb.element_size(), lc.data_ptr(), vv.data_ptr(),
            Rl, F, V, na_code, items.data_ptr(), starts.data_ptr(), n_tiles,
            cluster, tile_cells, rb, acc.data_ptr(), n_cells,
            amax.data_ptr(), scale.data_ptr(), out.data_ptr(), stream)
    check(lib, rc, "level_hist")
    return out


def _flat_feats(F: int, n_lv: int, B: int, V: int):
    """The flat plan's features (every one at width ``B``) and its cells."""
    block = n_lv * B * V
    return tuple((f, B, f * block) for f in range(F)), F * block


def _grouped_feats(F: int, groups, n_lv: int, V: int):
    """The grouped plan's features, each group's (Fg, n_lv, Bg, V) shape and
    the cells of all groups, packed in ``groups`` order."""
    feats, shapes, off = [], [], 0
    for idxs, Bg, _mode in groups:
        block = n_lv * Bg * V
        for i, f in enumerate(idxs):
            if not 0 <= f < F:
                raise ValueError(f"group column {f} outside the {F} code "
                                 f"columns")
            feats.append((int(f), int(Bg), off + i * block))
        shapes.append((len(idxs), n_lv, int(Bg), V))
        off += len(idxs) * block
    return tuple(feats), shapes, off


def launch_shape(Xb, lc, vv, n_lv: int, nbins_tot: int,
                 groups=None) -> dict:
    """What one launch of the kernel runs for these inputs: rows per staged
    block (0: no ring, every row read from device memory), stages, CTAs per
    cluster, clusters (each a pass over the rows), and the largest tile's
    bytes."""
    F, V = Xb.shape[1], vv.shape[1]
    feats = (_flat_feats(F, n_lv, nbins_tot, V)[0] if groups is None
             else _grouped_feats(F, groups, n_lv, V)[0])
    rb, ring = _staging(Xb, lc, vv, feats)
    _items, starts, tile_cells, cluster = _tile_plan(feats, n_lv, V, ring)
    return dict(rows_per_block=rb, stages=_STAGES, cluster=cluster,
                clusters=(len(starts) - 1) // cluster,
                tile_bytes=tile_cells * 8)


def _cuda_flat(Xb, lc, vv, n_lv: int, nbins_tot: int) -> torch.Tensor:
    """Flat plan: every feature at width ``nbins_tot`` -> (F, n_lv, B, V)."""
    global LAUNCHES
    _check_inputs(Xb, lc, vv)
    F, V = Xb.shape[1], vv.shape[1]
    feats, n_cells = _flat_feats(F, n_lv, nbins_tot, V)
    out = _launch(Xb, lc, vv, n_lv, nbins_tot - 1, feats, n_cells)
    with COUNT_LOCK:
        LAUNCHES += 1
    return out.view(F, n_lv, nbins_tot, V)


def _cuda_grouped(Xb, lc, vv, groups, n_lv: int, na_global: int) -> tuple:
    """Grouped plan, all groups in one launch, codes read in place from
    ``Xb``: returns one (Fg, n_lv, Bg, V) view per group, in ``groups``
    order."""
    global GROUPED_LAUNCHES
    _check_inputs(Xb, lc, vv)
    feats, shapes, n_cells = _grouped_feats(Xb.shape[1], groups, n_lv,
                                            vv.shape[1])
    out = _launch(Xb, lc, vv, n_lv, na_global, feats, n_cells)
    with COUNT_LOCK:
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
    V). A one-group call of the same kernel on the card; ``block`` is kept
    for the reference's signature (the grouped plain version needs none)."""
    groups1 = ((tuple(range(xg.shape[1])), Bg, mode),)
    _check_device(xg.device)
    if xg.device.type == "cuda":
        return _cuda_grouped(xg, lc, vv, groups1, n_lv, nbins_tot - 1)[0]
    return _torch_grouped([xg], lc, vv, groups1, n_lv, nbins_tot - 1)[0]


def level_hist_blocks(Xb, lc, vv, *, n_lv: int, nbins_tot: int, block: int,
                      groups=None):
    """Per-level histogram accumulation.

    ``Xb`` (Rl, F) int8/int16/int32 bin codes; ``lc`` (Rl,) int32 local
    node ids in [0, n_lv); ``vv`` (Rl, V) float32 channel values already
    zeroed for inactive rows. Flat (``groups=None``) returns the (F, n_lv,
    nbins_tot, V) accumulator; grouped returns a tuple with one (Fg, n_lv,
    Bg, V) accumulator per normalized group, each group's NA bucket in its
    LAST slot. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel. ``block`` is kept for the reference's signature.
    """
    _check_device(Xb.device)
    cuda = Xb.device.type == "cuda"
    if groups is None:
        if cuda:
            return _cuda_flat(Xb, lc, vv, n_lv, nbins_tot)
        return _torch_flat(Xb, lc, vv, n_lv, nbins_tot)
    if cuda:
        return _cuda_grouped(Xb, lc, vv, groups, n_lv, nbins_tot - 1)
    xgs = [Xb[:, list(idxs)] for idxs, _Bg, _mode in groups]
    return _torch_grouped(xgs, lc, vv, groups, n_lv, nbins_tot - 1)
