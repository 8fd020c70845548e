"""MOJO wire format — binary tree bytecode, `model.ini`, zip layout.

Byte-compatible with the reference's standalone scoring format so downstream
tooling (h2o-genmodel readers) keeps working:

- `model.ini` sections [info]/[columns]/[domains] and `domains/d%03d.txt`
  files (`hex/genmodel/ModelMojoReader.java:291-345`,
  `hex/genmodel/AbstractMojoWriter.java:238-278`).
- Tree bytecode matching the mojo>=1.2 decoder
  (`hex/genmodel/algos/tree/SharedTreeMojoModel.java:134-254` scoreTree):
  per internal node: nodeType u8, colId u16le (0xFFFF = root leaf),
  naSplitDir u8, float32 split value (or inline bitset for categorical set
  splits), left-subtree-size field (1-4 bytes, width in nodeType bits 0-1),
  left subtree, right subtree; leaves are raw float32. All little-endian
  (`hex/genmodel/utils/ByteBufferWrapper.java` uses native order).
- Aux blobs: one 40-byte record per decided node — nid, reserved, weightL/R,
  predL/R, sqErrL/R (f32), nidL, nidR
  (`hex/genmodel/algos/tree/SharedTreeMojoModel.java:709-740` AuxInfo).

Everything here is plain numpy, so the standalone scorer has no engine
dependency (the `h2o-genmodel` "zero h2o-core deps" property). The file is
the port's own copy of ``h2o_tpu/mojo/format.py``: the writer and reader of
either package read the other's zips, and ``models/gam.py`` builds its
penalties from ``cr_matrices`` and ``tp_constraint`` and holds its device
bases against the spline bases at the end.
"""

from __future__ import annotations

import io
import struct
import zipfile

import numpy as np

# NaSplitDir values (`hex/genmodel/algos/tree/NaSplitDir.java:6-17`)
NSD_NA_VS_REST = 1
NSD_NA_LEFT = 2
NSD_NA_RIGHT = 3
NSD_LEFT = 4
NSD_RIGHT = 5

_LEAF_COL = 0xFFFF


# ---------------------------------------------------------------------------
# Tree encoding: dense perfect-binary-tree arrays -> MOJO bytecode
# ---------------------------------------------------------------------------
def encode_tree(feat, thr, nanL, val, catd=None, iscat=None, nedges=None,
                cards=None):
    """Encode one tree given engine arrays (N,) with N = 2^(d+1)-1.

    feat[i] < 0 marks a leaf with value val[i]; otherwise the node splits on
    column feat[i]: rows with x <= thr[i] go left, x > thr[i] right, NaN goes
    left iff nanL[i]. The MOJO numeric test sends x >= splitVal right, so we
    emit splitVal = nextafter(thr, +inf) which is exactly equivalent for every
    float32. Returns (tree_bytes, aux_bytes).

    Categorical SET splits (``catd`` (N, B) bin-direction rows + ``iscat``/
    ``nedges``/``cards`` (F,) arrays given): the node is emitted as the
    reference's bitset split (`SharedTreeMojoModel.java` equal==12 layout,
    u16 bitoff + i32 nbits + bytes) with one bit per DOMAIN level — bit set =
    level goes right, exactly the `GenmodelBitSet.contains -> go right`
    convention; levels at/above the engine's bin cap share the top bin's
    direction (bin = min(level, n_edges)).
    """
    feat = np.asarray(feat)
    thr = np.asarray(thr, dtype=np.float32)
    nanL = np.asarray(nanL)
    val = np.asarray(val, dtype=np.float32)
    aux = []

    def set_split_bytes(i) -> bytes | None:
        f = int(feat[i])
        if catd is None or iscat is None or not iscat[f]:
            return None
        card = int(cards[f])
        levels = np.minimum(np.arange(card), int(nedges[f]))
        bits_right = np.asarray(catd[i])[levels] > 0.5
        packed = np.packbits(bits_right, bitorder="little")
        return struct.pack("<Hi", 0, card) + packed.tobytes()

    def node_bytes(i) -> bytes:
        if feat[i] < 0:  # leaf
            return struct.pack("<f", float(val[i]))
        left_leaf = feat[2 * i + 1] < 0
        right_leaf = feat[2 * i + 2] < 0
        left = node_bytes(2 * i + 1)
        right = node_bytes(2 * i + 2)
        # One AuxInfo per decided node, heap indices as the node-id space
        # throughout (nid and nidL/nidR must resolve within the same
        # numbering). Child preds are exact for leaf children; weights and
        # squared errors are not tracked by the engine and stay 0.
        aux.append(struct.pack("<ii6f2i", i, -1, 0.0, 0.0,
                               float(val[2 * i + 1]) if left_leaf else 0.0,
                               float(val[2 * i + 2]) if right_leaf else 0.0,
                               0.0, 0.0, 2 * i + 1, 2 * i + 2))
        nodetype = 0
        if right_leaf:
            nodetype |= 0x40  # rmask 16: right child is a 4-byte leaf
        if left_leaf:
            nodetype |= 48    # lmask 48: left child is a 4-byte leaf
            offs = b""
        else:
            n = len(left)
            nbytes = 1 if n < (1 << 8) else 2 if n < (1 << 16) else \
                3 if n < (1 << 24) else 4
            nodetype |= nbytes - 1
            offs = n.to_bytes(nbytes, "little")
        nsd = NSD_NA_LEFT if nanL[i] else NSD_NA_RIGHT
        bset = set_split_bytes(i)
        if bset is not None:
            nodetype |= 12  # equal == 12: extended bitset split
            head = struct.pack("<BHB", nodetype, int(feat[i]), nsd) + bset
        else:
            split = np.nextafter(thr[i], np.float32(np.inf), dtype=np.float32)
            head = struct.pack("<BHBf", nodetype, int(feat[i]), nsd,
                               float(split))
        return head + offs + left + right

    if feat[0] < 0:  # degenerate single-leaf tree
        return struct.pack("<BHf", 0, _LEAF_COL, float(val[0])), b""
    body = node_bytes(0)
    return body, b"".join(aux)


# ---------------------------------------------------------------------------
# Tree decoding: MOJO bytecode -> node list (for the standalone scorer)
# ---------------------------------------------------------------------------
class _Node:
    __slots__ = ("col", "split", "na_left", "na_vs_rest", "bitset",
                 "left", "right", "leaf_val")

    def __init__(self):
        self.col = -1
        self.split = np.nan
        self.na_left = True
        self.na_vs_rest = False
        self.bitset = None      # (bitoff, np.uint8 array) for categorical sets
        self.left = self.right = None
        self.leaf_val = None


def decode_tree(buf: bytes):
    """Parse MOJO tree bytecode into a _Node graph (mojo >= 1.2 layout)."""

    def parse(pos):
        nodetype = buf[pos]
        colid = struct.unpack_from("<H", buf, pos + 1)[0]
        pos += 3
        node = _Node()
        if colid == _LEAF_COL:
            node.leaf_val = struct.unpack_from("<f", buf, pos)[0]
            return node, pos + 4
        node.col = colid
        nsd = buf[pos]
        pos += 1
        node.na_vs_rest = nsd == NSD_NA_VS_REST
        node.na_left = nsd in (NSD_NA_LEFT, NSD_LEFT)
        lmask = nodetype & 51
        equal = nodetype & 12
        if not node.na_vs_rest:
            if equal == 0:
                node.split = struct.unpack_from("<f", buf, pos)[0]
                pos += 4
            elif equal == 8:  # 32-bit inline bitset, offset 0
                node.bitset = (0, np.frombuffer(buf, np.uint8, 4, pos))
                pos += 4
            else:  # equal == 12: u16 bitoff + i32 nbits + bytes
                bitoff = struct.unpack_from("<H", buf, pos)[0]
                nbits = struct.unpack_from("<i", buf, pos + 2)[0]
                nbytes = ((nbits - 1) >> 3) + 1
                node.bitset = (bitoff,
                               np.frombuffer(buf, np.uint8, nbytes, pos + 6))
                pos += 6 + nbytes
        if lmask <= 3:
            pos += lmask + 1  # left-subtree-size field (we recurse instead)
            node.left, pos = parse(pos)
        else:  # lmask 48: left child is an inline leaf
            node.left = _Node()
            node.left.leaf_val = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        rmask = (nodetype & 0xC0) >> 2
        if rmask & 16:
            node.right = _Node()
            node.right.leaf_val = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        else:
            node.right, pos = parse(pos)
        return node, pos

    node, _ = parse(0)
    return node


def score_tree(root: _Node, X: np.ndarray, domains=None) -> np.ndarray:
    """Vectorized traversal of a decoded tree over rows X (R, F).

    Mirrors the reference decision logic (`SharedTreeMojoModel.java:216-221`):
    NaN / out-of-range categorical follows the NA direction; naVsRest sends
    non-NA left; numeric x >= split goes right; bitset membership goes right.
    """
    out = np.empty(X.shape[0], dtype=np.float64)
    stack = [(root, np.arange(X.shape[0]))]
    while stack:
        node, idx = stack.pop()
        if node.leaf_val is not None:
            out[idx] = node.leaf_val
            continue
        x = X[idx, node.col]
        isna = np.isnan(x)
        cond = isna.copy()  # NA / bitset-out-of-range / beyond-domain rows
        member = None
        if node.bitset is not None:
            bitoff, bits = node.bitset
            xi = np.where(isna, 0, x).astype(np.int64) - bitoff
            in_range = (xi >= 0) & (xi < bits.size * 8)
            xi = np.clip(xi, 0, bits.size * 8 - 1)
            member = ((bits[xi >> 3] >> (xi & 7)) & 1).astype(bool)
            cond |= ~in_range
        if domains is not None and domains[node.col] is not None:
            cond |= np.where(isna, False, x >= len(domains[node.col]))
        if node.na_vs_rest:
            go_right = cond  # NA-ish right, everything else left
        else:
            test = member if member is not None else \
                np.where(isna, False, x >= node.split)
            go_right = np.where(cond, not node.na_left, test)
        stack.append((node.left, idx[~go_right]))
        stack.append((node.right, idx[go_right]))
    return out


# ---------------------------------------------------------------------------
# model.ini + zip assembly
# ---------------------------------------------------------------------------
def format_kv(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (list, tuple, np.ndarray)):
        return "[" + ", ".join(format_kv(x) for x in v) + "]"
    if isinstance(v, float) and np.isnan(v):
        return "NaN"
    return str(v)


def build_model_ini(info: dict, columns, domains_per_col) -> str:
    """domains_per_col: list aligned with columns; None for non-categorical."""
    lines = ["[info]"]
    for k, v in info.items():
        lines.append(f"{k} = {format_kv(v)}")
    lines.append("\n[columns]")
    lines.extend(columns)
    lines.append("\n[domains]")
    di = 0
    for ci, dom in enumerate(domains_per_col):
        if dom is not None:
            lines.append(f"{ci}: {len(dom)} d{di:03d}.txt")
            di += 1
    return "\n".join(lines) + "\n"


def parse_model_ini(text: str):
    info, columns, dommap = {}, [], {}
    section = 0
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[info]":
            section = 1
        elif line == "[columns]":
            section = 2
        elif line == "[domains]":
            section = 3
        elif section == 1:
            k, _, v = line.partition("=")
            info[k.strip()] = v.strip()
        elif section == 2:
            columns.append(line)
        elif section == 3:
            ci, _, rest = line.partition(":")
            _, fname = rest.strip().split(" ", 1)
            dommap[int(ci)] = fname.strip()
    return info, columns, dommap


def parse_kv(raw: str, default=None):
    """Best-effort typed parse of an [info] value (ParseUtils.tryParse role)."""
    if raw is None:
        return default
    s = raw.strip()
    if s in ("true", "false"):
        return s == "true"
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        if not inner:
            return []
        return [parse_kv(p.strip()) for p in inner.split(",")]
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


_ESCAPES = {"\\n": "\n", "\\\\": "\\"}


def escape_line(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def unescape_line(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            out.append(_ESCAPES.get(s[i:i + 2], s[i + 1]))
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


class MojoZipWriter:
    def __init__(self):
        self._buf = io.BytesIO()
        self._zip = zipfile.ZipFile(self._buf, "w", zipfile.ZIP_DEFLATED)

    def write_text(self, name: str, text: str):
        self._zip.writestr(name, text.encode("utf-8"))

    def write_blob(self, name: str, blob: bytes):
        self._zip.writestr(name, blob)

    def finish(self, path: str):
        self._zip.close()
        with open(path, "wb") as f:
            f.write(self._buf.getvalue())


class MojoZipReader:
    def __init__(self, path: str):
        self._zip = zipfile.ZipFile(path, "r")

    def exists(self, name: str) -> bool:
        try:
            self._zip.getinfo(name)
            return True
        except KeyError:
            return False

    def text(self, name: str) -> str:
        return self._zip.read(name).decode("utf-8")

    def blob(self, name: str) -> bytes:
        return self._zip.read(name)

    def close(self):
        self._zip.close()


# ---------------------------------------------------------------------------
def bspline_basis(x: np.ndarray, lo: float, hi: float, interior: np.ndarray,
                  degree: int = 3) -> np.ndarray:
    """(R,) values -> (R, n_basis) cubic B-spline design. NAs/out-of-range are
    clamped to the boundary (constant extrapolation)."""
    x = np.clip(np.nan_to_num(x, nan=(lo + hi) / 2), lo, hi)
    t = np.concatenate([[lo] * (degree + 1), interior, [hi] * (degree + 1)])
    n_basis = len(interior) + degree + 1
    # degree-0: indicator of knot span (right-open; last span right-closed)
    B = np.zeros((len(x), len(t) - 1))
    for i in range(len(t) - 1):
        if t[i + 1] > t[i]:
            B[:, i] = (x >= t[i]) & ((x < t[i + 1]) | (t[i + 1] == hi))
    for d in range(1, degree + 1):
        Bn = np.zeros((len(x), len(t) - 1 - d))
        for i in range(len(t) - 1 - d):
            left = 0.0
            if t[i + d] > t[i]:
                left = (x - t[i]) / (t[i + d] - t[i]) * B[:, i]
            right = 0.0
            if t[i + d + 1] > t[i + 1]:
                right = (t[i + d + 1] - x) / (t[i + d + 1] - t[i + 1]) * B[:, i + 1]
            Bn[:, i] = left + right
        B = Bn
    return B[:, :n_basis]


def cr_basis(x: np.ndarray, knots: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Natural cubic regression spline basis in the values-at-knots
    parameterization (mgcv 'cr', Wood 2006 §4.1.2; the reference's
    `hex/gam/GamSplines/CubicRegressionSplines.java` role). ``F`` maps knot
    values to second derivatives (cr_matrices). Out-of-range clamps."""
    knots = np.asarray(knots, np.float64)
    K = len(knots)
    x = np.clip(np.nan_to_num(np.asarray(x, np.float64),
                              nan=float(knots[K // 2])),
                knots[0], knots[-1])
    j = np.clip(np.searchsorted(knots, x, side="right") - 1, 0, K - 2)
    h = knots[j + 1] - knots[j]
    am = (knots[j + 1] - x) / h
    ap = (x - knots[j]) / h
    cm = ((knots[j + 1] - x) ** 3 / h - h * (knots[j + 1] - x)) / 6.0
    cp = ((x - knots[j]) ** 3 / h - h * (x - knots[j])) / 6.0
    R = len(x)
    B = np.zeros((R, K))
    rows = np.arange(R)
    B[rows, j] += am
    B[rows, j + 1] += ap
    B += cm[:, None] * F[j] + cp[:, None] * F[j + 1]
    return B


def cr_matrices(knots: np.ndarray):
    """(F, S) for the cr basis: F = [0; B⁻¹D; 0] maps knot values to second
    derivatives under natural boundary conditions; S = DᵀB⁻¹D is the exact
    integrated-squared-second-derivative penalty."""
    knots = np.asarray(knots, np.float64)
    K = len(knots)
    h = np.diff(knots)
    D = np.zeros((K - 2, K))
    Bm = np.zeros((K - 2, K - 2))
    for i in range(K - 2):
        D[i, i] = 1.0 / h[i]
        D[i, i + 1] = -1.0 / h[i] - 1.0 / h[i + 1]
        D[i, i + 2] = 1.0 / h[i + 1]
        Bm[i, i] = (h[i] + h[i + 1]) / 3.0
        if i + 1 < K - 2:
            Bm[i, i + 1] = Bm[i + 1, i] = h[i + 1] / 6.0
    Binv_D = np.linalg.solve(Bm, D)
    F = np.vstack([np.zeros(K), Binv_D, np.zeros(K)])
    S = D.T @ Binv_D
    return F, S


def tp_basis(x: np.ndarray, knots: np.ndarray, scale: float,
             Z: np.ndarray) -> np.ndarray:
    """1-D thin-plate regression spline basis: cubic radial bumps |x−k|³
    around each knot, projected through ``Z`` (an orthonormal basis of the
    null space of [1, k]ᵀ — the standard TPRS side constraint that makes the
    radial energy penalty positive semi-definite), plus the linear null-space
    term. ``scale`` normalizes for conditioning."""
    knots = np.asarray(knots, np.float64)
    x = np.nan_to_num(np.asarray(x, np.float64),
                      nan=float(np.median(knots)))
    r = np.abs(x[:, None] - knots[None, :]) / scale
    return np.concatenate([(r ** 3) @ np.asarray(Z, np.float64),
                           (x / scale)[:, None]], axis=1)


def tp_constraint(knots: np.ndarray, scale: float):
    """(Z, S) for the 1-D TPRS: Z spans null([1, k]ᵀ) so the projected
    radial energy S = Zᵀ E Z (E_ij = |k_i−k_j|³) is PSD — the cubic radial
    kernel is only conditionally positive definite orthogonal to {1, x}."""
    knots = np.asarray(knots, np.float64)
    K = len(knots)
    T = np.stack([np.ones(K), knots / scale], axis=1)
    Q, _ = np.linalg.qr(T, mode="complete")
    Z = Q[:, 2:]
    E = np.abs(knots[:, None] - knots[None, :]) ** 3 / scale ** 3
    S = Z.T @ E @ Z
    return Z, (S + S.T) / 2.0


def ispline_basis(x: np.ndarray, lo: float, hi: float, interior: np.ndarray,
                  degree: int = 3) -> np.ndarray:
    """Monotone I-spline basis: I_i(x) = Σ_{j≥i} B_j(x) over the B-spline
    basis (each column rises 0→1, so non-negative coefficients give a
    non-decreasing function — `hex/gam/GamSplines/ISplines.java` role). The
    all-ones j=0 column is dropped (it duplicates the intercept)."""
    B = bspline_basis(x, lo, hi, interior, degree)
    I = np.cumsum(B[:, ::-1], axis=1)[:, ::-1]
    return I[:, 1:]


def gam_basis(x: np.ndarray, spec: dict) -> np.ndarray:
    """Evaluate one gam column's (uncentered) basis from its serialized spec
    — shared by the engine and the standalone MOJO scorer."""
    bs = int(spec.get("bs", 3))
    if bs == 0:      # cr
        return cr_basis(x, np.asarray(spec["knots"]),
                        np.asarray(spec["F"]))
    if bs == 1:      # thin plate (1-D)
        return tp_basis(x, np.asarray(spec["knots"]), float(spec["tp_scale"]),
                        np.asarray(spec["Z"]))
    if bs == 2:      # monotone I-splines
        return ispline_basis(x, spec["lo"], spec["hi"],
                             np.asarray(spec["interior"]), spec["degree"])
    return bspline_basis(x, spec["lo"], spec["hi"],
                         np.asarray(spec["interior"]), spec["degree"])
