"""Compressed columnar chunks (``h2o_tpu/frame/chunks.py``): the
`water/fvec/C*Chunk` codec family, and the binned view the tree engine
trains on.

- **Coded columns** (``CodedVec``): one device tensor of codes per column
  plus host-side affine metadata (``ChunkMeta``). Codecs: ``const`` (one
  value), ``int8``/``int16`` offset-scale (``value = offset + code *
  scale`` in float32, the top code = NA), ``cat8``/``cat16`` (categorical
  level ids, the same format), ``sparse0`` (row index and float32 bits of
  the rows whose bits are not zero) and ``raw``. ``encode_column`` picks
  the narrowest codec on the host, by the reference's rules, so both
  packages code a column alike; each codec is verified bit-exact at encode
  time against the device decode (NaN-aware), and a column no codec
  reproduces exactly stays a plain Vec. ``decode_chunk`` is a few torch
  ops on the column's device, and ``.data`` decodes per access — the
  float32 view is never resident. 16-bit codes sit on the device as the
  int16 view of their uint16 bits (torch has no general uint16 arithmetic).
- **Rollups from codes**: min, max, NA and zero counts are exact in code
  space, and mean and sigma are the same centred float32 reduction the raw
  pass runs, on the codes, then mapped through the affine; a frame's coded
  columns batch into one pass per (plen, code width) stack
  (``batch_code_rollups``).
- **BinnedView**: the packed (plen, F) bin-code matrix the tree engine
  trains on (int8 at the default 20 bins, int16 once a wide categorical
  widens the bin space), built column by column, so the raw float32 matrix
  is never stacked.

The reference's Cleaner tracks, spills and rehydrates coded bytes under
device-memory pressure; the port has no Cleaner yet (ROADMAP step L), so
coded columns stay resident. Compression is opt-in:
``compress_frame`` / ``Frame.compress()``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .vec import T_NUM, Rollups, Vec

#: code-space caps: the top code of each width is the NA sentinel
_CAP8, _NA8 = 254, 255
_CAP16, _NA16 = 65534, 65535

_INT_KINDS = ("int8", "int16", "cat8", "cat16")


@dataclass(frozen=True)
class ChunkMeta:
    """Host-side decode metadata — the `Chunk` subclass header analog."""

    kind: str            # const | int8 | int16 | cat8 | cat16 | sparse0 | raw
    nrow: int            # logical rows (padding rows beyond this are NaN)
    plen: int            # padded device length
    offset: float = 0.0  # int codecs: value = offset + code * scale (f32)
    scale: float = 1.0
    na_code: int = 0     # int codecs: the NA/padding sentinel code
    value: float = float("nan")  # const codecs: the single value
    is_int: bool = False         # decoded values all integral (encode-time)
    zero_code: int = -1          # int codecs: code decoding to 0.0 (-1: none)


# ---------------------------------------------------------------------------
# decode (torch ops on the column's device)
# ---------------------------------------------------------------------------
def _codes_i32(coded: torch.Tensor) -> torch.Tensor:
    """uint8 codes, or the int16 view of uint16 codes -> their unsigned
    values as int32."""
    c = coded.to(torch.int32)
    return c & 0xFFFF if coded.dtype == torch.int16 else c


def decode_chunk(coded: torch.Tensor, meta: ChunkMeta) -> torch.Tensor:
    """Coded device tensor + meta -> the float32 column (padding NaN)."""
    k = meta.kind
    dev = coded.device
    if k == "raw":
        return coded
    if k == "const":
        out = torch.full((meta.plen,), float("nan"), dtype=torch.float32,
                         device=dev)
        out[:meta.nrow] = float(np.float32(meta.value))
        return out
    if k in _INT_KINDS:
        c = _codes_i32(coded)
        # two roundings, product then sum, as the reference's decode
        out = c.to(torch.float32) * float(np.float32(meta.scale))
        out = out + float(np.float32(meta.offset))
        return torch.where(c == meta.na_code, torch.nan, out)
    if k == "sparse0":
        out = torch.zeros((meta.plen,), dtype=torch.float32, device=dev)
        out[coded[0].long()] = coded[1].contiguous().view(torch.float32)
        return out
    raise ValueError(f"unknown chunk kind '{k}'")


def _to_device(coded_np: np.ndarray, device) -> torch.Tensor:
    if coded_np.dtype == np.uint16:
        coded_np = coded_np.view(np.int16)
    return torch.from_numpy(np.ascontiguousarray(coded_np)).to(device)


# ---------------------------------------------------------------------------
# encode (host side, at compress time) — the reference's rules
# ---------------------------------------------------------------------------
def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """f32 bit-equality with all NaNs identified (any-payload NaN == NaN)."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    same = a.view(np.int32) == b.view(np.int32)
    return bool(np.all(same | (np.isnan(a) & np.isnan(b))))


def _int_candidate(vals, nan_mask, nrow, plen, cap, na_code, dtype, kind,
                   is_int):
    """Offset-scale integer codes covering every distinct value exactly, or
    None. The affine params are chosen so the f32 decode arithmetic
    reproduces the original f32 bits (verified by the caller)."""
    finite = vals[~nan_mask]
    u = np.unique(finite.astype(np.float64))
    if u.size == 0:
        return None
    offset = float(u[0])
    if u.size == 1:
        scale = 1.0
    else:
        scale = float(np.min(np.diff(u)))
        if scale <= 0:
            return None
    q = (u - offset) / scale
    qr = np.round(q)
    if np.max(np.abs(q - qr)) > 1e-6 or qr[-1] > cap:
        return None
    codes = np.full(plen, na_code, dtype=dtype)
    c = np.round((vals[~nan_mask].astype(np.float64) - offset) / scale)
    if c.min() < 0 or c.max() > cap:
        return None
    codes[~nan_mask] = c.astype(dtype)
    # host-side replica of the decode arithmetic as a cheap pre-filter; the
    # device decode re-verifies in from_vec
    dec = np.float32(offset) + codes.astype(np.float32) * np.float32(scale)
    dec = np.where(codes == na_code, np.float32(np.nan), dec)
    if not _bits_equal(dec, vals):
        return None
    zq = np.round((0.0 - offset) / scale)
    zero_code = int(zq) if (0 <= zq <= cap and
                            np.float32(offset)
                            + np.float32(zq) * np.float32(scale) == 0.0) \
        else -1
    meta = ChunkMeta(kind=kind, nrow=nrow, plen=plen, offset=offset,
                     scale=scale, na_code=na_code, is_int=is_int,
                     zero_code=zero_code)
    return codes, meta


def encode_column(host: np.ndarray, nrow: int,
                  is_cat: bool = False) -> tuple[np.ndarray, ChunkMeta]:
    """Pick the narrowest codec that reproduces ``host`` (a padded (plen,)
    f32 column, NaN = NA/padding) bit-exactly. Preference order is by coded
    bytes: const, int8 (1 B/row), sparse when it beats 2 B/row, int16,
    sparse when it beats 4 B/row, raw."""
    vals = np.ascontiguousarray(host, np.float32)
    plen = vals.shape[0]
    nan_mask = np.isnan(vals)
    is_int = bool(np.all(vals[~nan_mask] == np.floor(vals[~nan_mask]))) \
        if (~nan_mask).any() else False

    if nan_mask[:nrow].all():          # all-NA logical column
        return (np.zeros(1, np.int8),
                ChunkMeta(kind="const", nrow=nrow, plen=plen,
                          value=float("nan")))
    bits = vals.view(np.int32)
    if not nan_mask[:nrow].any() and np.all(bits[:nrow] == bits[0]):
        return (np.zeros(1, np.int8),
                ChunkMeta(kind="const", nrow=nrow, plen=plen,
                          value=float(vals[0]), is_int=is_int))

    # sparse payload: rows whose BITS are nonzero (keeps -0.0 and every NaN,
    # padding tail included) as (row, f32-bits) int32 pairs
    nz = np.nonzero(bits)[0]
    sparse_bytes = 8 * max(nz.size, 1)

    def sparse_pack():
        packed = np.stack([nz.astype(np.int32), bits[nz]], axis=0)
        return packed, ChunkMeta(kind="sparse0", nrow=nrow, plen=plen,
                                 is_int=is_int)

    cand = _int_candidate(vals, nan_mask, nrow, plen, _CAP8, _NA8, np.uint8,
                          "cat8" if is_cat else "int8", is_int)
    if cand is not None:
        return cand
    if sparse_bytes < 2 * plen:
        return sparse_pack()
    cand = _int_candidate(vals, nan_mask, nrow, plen, _CAP16, _NA16,
                          np.uint16, "cat16" if is_cat else "int16", is_int)
    if cand is not None:
        return cand
    if sparse_bytes < 4 * plen:
        return sparse_pack()
    return vals, ChunkMeta(kind="raw", nrow=nrow, plen=plen, is_int=is_int)


# ---------------------------------------------------------------------------
# rollups from codes (lossless stats without decoding)
# ---------------------------------------------------------------------------
def _code_stats(codes: torch.Tensor, na: torch.Tensor, zero: torch.Tensor):
    """Code-space stats of a (C, plen) stack of int32 codes, per row: the
    count, float32 mean and centred variance of the non-NA codes, min,
    max and the zero-code count — one host transfer for C columns."""
    ok = codes != na[:, None]
    cf = codes.to(torch.float32)
    n = ok.sum(dim=1)
    nf = torch.clamp(n, min=1).to(torch.float32)
    mean = torch.where(ok, cf, 0.0).sum(dim=1) / nf
    d = torch.where(ok, cf - mean[:, None], 0.0)
    var = torch.clamp((d * d).sum(dim=1) / nf, min=0.0)
    cmin = torch.where(ok, cf, torch.inf).amin(dim=1)
    cmax = torch.where(ok, cf, -torch.inf).amax(dim=1)
    zerocnt = (ok & (codes == zero[:, None])).sum(dim=1)
    out = torch.stack([n.to(torch.float64), mean.double(), var.double(),
                       cmin.double(), cmax.double(),
                       zerocnt.to(torch.float64)], dim=1).cpu().numpy()
    return [dict(zip(("n", "mean", "var", "cmin", "cmax", "zerocnt"), r))
            for r in out]


def _rollups_from_code_stats(meta: ChunkMeta, r: dict, nrow: int) -> Rollups:
    """Affine-map code-space stats back to value space (float32 min/max
    as the decode computes them; the sample-variance correction of
    ``vec._rollups``)."""
    n = int(r["n"])
    var = (float(meta.scale) ** 2) * float(r["var"]) * (n / max(n - 1, 1))

    def dec(c):
        return float(np.float32(meta.offset) + np.float32(c)
                     * np.float32(meta.scale))

    return Rollups(
        mins=dec(r["cmin"]) if n else np.nan,
        maxs=dec(r["cmax"]) if n else np.nan,
        mean=float(meta.offset + meta.scale * float(np.float32(r["mean"])))
        if n else np.nan,
        sigma=float(np.sqrt(var)) if n else np.nan,
        nacnt=nrow - n, nrow=nrow, zerocnt=int(r["zerocnt"]),
        is_int=meta.is_int)


def batch_code_rollups(vecs) -> list:
    """Fill the missing rollups of CodedVecs without decoding: consts on
    the host, int-coded columns in one pass per (plen, code width, device)
    stack. Returns the vecs it could not serve (sparse and raw), which take
    the decode path."""
    rest: list = []
    by_shape: dict = {}
    for v in vecs:
        if v._rollups is not None:
            continue
        m = getattr(v, "meta", None)
        if m is None or m.kind not in _INT_KINDS + ("const",):
            rest.append(v)
        elif m.kind == "const":
            v.rollups_from_codes()
        else:
            by_shape.setdefault((m.plen, v.coded.dtype, v.coded.device),
                                []).append(v)
    for group in by_shape.values():
        dev = group[0].coded.device
        codes = torch.stack([_codes_i32(v.coded) for v in group])
        na = torch.tensor([v.meta.na_code for v in group], dtype=torch.int32,
                          device=dev)
        zero = torch.tensor([v.meta.zero_code for v in group],
                            dtype=torch.int32, device=dev)
        for v, r in zip(group, _code_stats(codes, na, zero)):
            v._rollups = _rollups_from_code_stats(v.meta, r, v.nrow)
    return rest


class CodedVec(Vec):
    """A Vec whose device state is the CODED column: ``.coded`` holds the
    codes, ``.data`` decodes them per access (a float32 temporary, never
    resident). Rollups come straight off the codes for const and int
    codecs. Assigning ``.data`` replaces the codes by a plain column and
    degrades the codec to ``raw``."""

    def __init__(self, coded: torch.Tensor, meta: ChunkMeta, nrow: int,
                 type: str = T_NUM, domain=None, exact_data=None):
        self.meta = meta
        self.coded = coded
        self.nrow = int(nrow)
        self.type = type
        self.domain = domain
        self.host_data = None
        self.exact_data = exact_data
        self._rollups = None

    @property
    def data(self) -> torch.Tensor:
        return decode_chunk(self.coded, self.meta)

    @data.setter
    def data(self, value: torch.Tensor):
        self.meta = replace(self.meta, kind="raw", plen=int(value.shape[0]))
        self.coded = value

    @property
    def plen(self) -> int:
        # decode metadata: a shape query never decodes the column
        return self.meta.plen

    @property
    def device(self) -> torch.device:
        return self.coded.device

    def coded_nbytes(self) -> int:
        """Device bytes of the codes."""
        return self.coded.numel() * self.coded.element_size()

    def rollups_from_codes(self) -> bool:
        """Compute and cache the rollups without decoding when the codec
        allows; False sends the caller down the decode path."""
        if self._rollups is not None:
            return True
        m = self.meta
        if m.kind == "const":
            if np.isnan(m.value):
                self._rollups = Rollups(np.nan, np.nan, np.nan, np.nan,
                                        self.nrow, self.nrow)
            else:
                self._rollups = Rollups(
                    m.value, m.value, m.value, 0.0, 0, self.nrow,
                    zerocnt=self.nrow if m.value == 0.0 else 0,
                    is_int=m.is_int)
            return True
        if m.kind in _INT_KINDS:
            dev = self.coded.device
            r = _code_stats(
                _codes_i32(self.coded)[None],
                torch.tensor([m.na_code], dtype=torch.int32, device=dev),
                torch.tensor([m.zero_code], dtype=torch.int32, device=dev))
            self._rollups = _rollups_from_code_stats(m, r[0], self.nrow)
            return True
        return False

    def rollups(self) -> Rollups:
        if self._rollups is None and not self.rollups_from_codes():
            return super().rollups()
        return self._rollups

    @staticmethod
    def from_vec(vec: Vec) -> Vec:
        """Compress one column. Returns ``vec`` itself when it has no
        device data (strings), is already coded, or no codec reproduces
        it (raw); the chosen codec is re-verified against the device
        decode, and a mismatch keeps the plain column."""
        if isinstance(vec, CodedVec) or vec.data is None:
            return vec
        host = vec.data.cpu().numpy()
        coded_np, meta = encode_column(host, vec.nrow,
                                       is_cat=vec.is_categorical())
        if meta.kind == "raw":
            return vec
        coded = _to_device(coded_np, vec.device)
        if not _bits_equal(decode_chunk(coded, meta).cpu().numpy(), host):
            return vec
        return CodedVec(coded, meta, vec.nrow, type=vec.type,
                        domain=vec.domain, exact_data=vec.exact_data)

    def __repr__(self) -> str:
        return (f"CodedVec(nrow={self.nrow}, type={self.type}, "
                f"codec={self.meta.kind}, device={self.device})")


def compress_frame(fr):
    """A new Frame, registered in the store, with every compressible column
    coded (``Frame.compress``); plain columns are shared, not copied."""
    from ..backend.kvstore import STORE
    from .frame import Frame

    out = Frame(list(fr.names), [CodedVec.from_vec(v) for v in fr.vecs])
    STORE.put_keyed(out)
    return out


# ---------------------------------------------------------------------------
# BinnedView — the packed bin-code matrix the tree engine trains on
# ---------------------------------------------------------------------------
class BinnedView:
    def __init__(self, matrix: torch.Tensor, edges_np: np.ndarray,
                 names=None):
        self.matrix = matrix            # (plen, F) int8/int16/int32
        self.edges_np = edges_np
        self.col_names = list(names) if names is not None else None

    @staticmethod
    def code_dtype(nbins_tot: int) -> torch.dtype:
        """Narrowest signed dtype holding codes 0..nbins_tot (NA bucket)."""
        if nbins_tot <= np.iinfo(np.int8).max:
            return torch.int8
        if nbins_tot <= np.iinfo(np.int16).max:
            return torch.int16
        return torch.int32

    @staticmethod
    def build(cols, edges_np: np.ndarray, names=None) -> "BinnedView":
        """Bin column by column against ``edges_np`` ((F, W) NaN-padded cut
        rows) and pack into one contiguous narrow-dtype matrix; the raw f32
        matrix is never stacked."""
        from ..models.tree.binning import _coldata, bin_column

        cols = list(cols)
        if len(cols) != edges_np.shape[0]:
            raise ValueError("one edge row per column")
        dtype = BinnedView.code_dtype(edges_np.shape[1] + 1)
        dev = _coldata(cols[0]).device
        edges = torch.from_numpy(
            np.ascontiguousarray(edges_np, np.float32)).to(dev)
        codes = [bin_column(_coldata(c), edges[f], dtype=dtype)
                 for f, c in enumerate(cols)]
        return BinnedView(torch.stack(codes, dim=1), edges_np, names=names)

    def __repr__(self) -> str:
        return f"BinnedView(shape={tuple(self.matrix.shape)}, " \
               f"dtype={self.matrix.dtype})"
