"""Fused weighted Gram accumulation (``h2o_tpu/backend/kernels/gram.py``) —
the GLMIterationTask inner loop.

One call computes G = XᵀWX and, optionally, b = XᵀWz in one pass over the
rows. Two forms:

- ``_torch_gram``: the plain version, a port of the reference's
  ``_xla_gram`` — a Python loop over balanced row blocks in ascending order,
  each block's ``block_contrib`` added into the running (G, b), so its
  summation order follows the reference's. It runs for CPU tensors and is
  the oracle the card is checked against.
- ``_cuda_gram``: the wrapper of the hand-written Hopper kernel
  ``csrc/gram.cu``, which replaces ``gram.py::_pallas_gram``: one product of
  (W∘X)ᵀ with the augmented operand [X | z] on the tensor cores in 3xTF32
  (float32 accuracy), over the upper triangle's output tiles x row chunks,
  rows staged into shared memory once per (tile, chunk) by asynchronous
  copies; per-chunk partials summed in ascending chunk order by a second
  launch, which mirrors G (bit-identical from run to run, no float
  atomics). It reads X where it lies: the zero-row padding of the plain
  version is not copied.

``gram_accumulate`` dispatches on the tensor's device only: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import COUNT_LOCK, check, load_library

#: launches of the kernel in this process — one per ``gram_accumulate`` call
#: on the card (the kernel's two internal launches count once); a plain
#: counter a run reads to show its main path went through the kernel
GRAM_LAUNCHES = 0

#: transient-cell budget per block of the plain version — the reference's:
#: designs under it run as one block, frame-scale designs split
_BLOCK_CELLS = 1 << 25
#: CTAs the kernel aims for (output tiles x row chunks); the chunk count
#: follows from R and P alone, never from the card's SM count
_TARGET_CTAS = 1024
#: (tile edge, rows per staged block) of the kernel's two forms, which the
#: kernel picks itself (kNarrowTile/kNarrowBK, kWideTile/kWideBK): one
#: 32 x 32 tile when the augmented width fits it, else 128 x 128 tiles
_NARROW = (32, 256)
_WIDE = (128, 64)


def block_contrib(xb, wb, zb):
    """One row block's (ΔG, Δb): Xᵀ(W∘X) and Xᵀ(W∘z); ``zb=None`` skips the
    vector (PCA's unweighted-response Gram)."""
    XW = xb * wb[:, None]
    dG = torch.einsum("rp,rq->pq", XW, xb)
    if zb is None:
        return dG, None
    return dG, XW.T @ zb


def _torch_gram(X, W, z, rb: int):
    """Blocks of ``rb`` rows (``rb`` divides R) added in ascending order."""
    R, P = X.shape
    has_z = z is not None
    G = torch.zeros((P, P), dtype=torch.float32, device=X.device)
    b = torch.zeros((P,), dtype=torch.float32, device=X.device) if has_z \
        else None
    for s in range(0, R, rb):
        dG, db = block_contrib(X[s:s + rb], W[s:s + rb],
                               z[s:s + rb] if has_z else None)
        G = G + dG
        if has_z:
            b = b + db
    return G, b


def _gram_plan(R: int, P: int, has_z: bool):
    """(tile, tiles, n_chunks, chunk_rows, bk) of one launch: the tile edge,
    the output tiles (ti, tj) with ti <= tj that cover G's upper triangle
    and b (the last column of [X | z]), enough row chunks that tiles x
    chunks reach ``_TARGET_CTAS``, each a whole number of ``bk``-row staged
    blocks (so every block starts on 16 bytes). A function of R and P
    only."""
    Q = P + int(has_z)
    tile, bk = _NARROW if Q <= _NARROW[0] else _WIDE
    nti, ntj = -(-P // tile), -(-Q // tile)
    tiles = tuple((ti, tj) for ti in range(nti) for tj in range(ti, ntj))
    n_chunks = max(1, min(-(-_TARGET_CTAS // len(tiles)), -(-R // bk)))
    per = -(-R // n_chunks)
    chunk_rows = -(-per // bk) * bk
    n_chunks = max(1, -(-R // chunk_rows))
    return tile, tiles, n_chunks, chunk_rows, bk


#: device copies of the tile lists, keyed by (tiles, device)
_TILES: dict = {}


def _check_inputs(X, W, z) -> None:
    dev = X.device
    for t, what in ((W, "W"), (z, "z")):
        if t is not None and t.device != dev:
            raise ValueError(f"X on {dev}, {what} on {t.device}")
    for t, what in ((X, "X"), (W, "W"), (z, "z")):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{what} must be float32, got {t.dtype}")
    if X.dim() != 2 or X.shape[1] < 1:
        raise ValueError(f"X must be (R, P) with P >= 1, got "
                         f"{tuple(X.shape)}")
    R = X.shape[0]
    if W.shape != (R,) or (z is not None and z.shape != (R,)):
        raise ValueError(f"shapes X {tuple(X.shape)}, W {tuple(W.shape)}, z "
                         f"{None if z is None else tuple(z.shape)}: want "
                         f"(R, P), (R,), (R,)")
    if not (X.is_contiguous() and W.is_contiguous()
            and (z is None or z.is_contiguous())):
        raise ValueError("X, W and z must be contiguous")
    if any(t is not None and t.data_ptr() % 16 for t in (X, W, z)):
        raise ValueError("X, W and z must start on 16 bytes (the kernel "
                         "stages rows with 16-byte copies)")


def _cuda_gram(X, W, z):
    """One launch of ``csrc/gram.cu`` on the current stream: (G, b), ``b``
    None when ``z`` is."""
    global GRAM_LAUNCHES
    _check_inputs(X, W, z)
    R, P = X.shape
    dev = X.device
    _tile, tiles, n_chunks, chunk_rows, _bk = _gram_plan(R, P, z is not None)
    key = (tiles, str(dev))
    if key not in _TILES:
        _TILES[key] = torch.tensor(tiles, dtype=torch.int32, device=dev)
    Q = P + int(z is not None)
    G = torch.empty((P, P), dtype=torch.float32, device=dev)
    b = torch.empty((P,), dtype=torch.float32, device=dev) \
        if z is not None else None
    partial = torch.empty(n_chunks * P * Q, dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.h2o_gram(X.data_ptr(), W.data_ptr(),
                          None if z is None else z.data_ptr(), R, P,
                          _TILES[key].data_ptr(), len(tiles), n_chunks,
                          chunk_rows, partial.data_ptr(), G.data_ptr(),
                          None if b is None else b.data_ptr(), stream)
    check(lib, rc, "gram")
    with COUNT_LOCK:
        GRAM_LAUNCHES += 1
    return G, b


def _plain_gram(X, W, z, block: int | None = None):
    """The plain version with the reference's balanced blocking — nblk =
    ceil(R·P / cell budget), rb = ceil(R / nblk), zero rows padded up to
    nblk·rb (zero-weight zero rows add exact +0.0) — with ``block`` rows per
    block overriding the budget (the reference's ``block=``). Runs on any
    device (the card's checks call it on CUDA tensors)."""
    R, P = X.shape
    cells = block * P if block else _BLOCK_CELLS
    nblk = max(1, -(-R * P // max(cells, 1)))
    rb = max(1, -(-R // nblk))
    pad = nblk * rb - R
    if pad:
        X = torch.cat([X, X.new_zeros((pad, P))])
        W = torch.cat([W, W.new_zeros(pad)])
        if z is not None:
            z = torch.cat([z, z.new_zeros(pad)])
    return _torch_gram(X, W, z, rb)


def gram_accumulate(X, W, z=None):
    """(G, b) = (XᵀWX, XᵀWz) in one pass; ``b`` is None when ``z`` is. ``W``
    is the per-row weight vector (a 0/1 mask for PCA: W is applied once).

    A CPU tensor takes the plain version (``_plain_gram``, blocked by the
    cell budget); a CUDA tensor launches the kernel, which chunks rows by
    its own plan and masks the ragged end.
    """
    dev = X.device
    if dev.type == "cuda":
        return _cuda_gram(X, W, z)
    if dev.type != "cpu":
        raise NotImplementedError(f"no Gram path for {dev}")
    return _plain_gram(X, W, z)
