"""Ingest: CSV/TSV file -> Frame (``h2o_tpu/io/parser.py``).

The reference tokenizes through ``pyarrow.csv`` and interns categoricals
through Arrow dictionaries. The card's machine has no pyarrow, so the port
tokenizes itself, on the host as the reference does, and decides each
column by the reference's rules (``_read_csv``/``_table_to_frame``):

- type inference in pyarrow's order: null, int64 (decimal digits inside
  int64's range, or ``0x`` and up to 16 hex digits), boolean, date and
  timestamp, time of day, float64, string. An all-NA column is numeric;
  an integral float column reports ``int``; booleans become ``int`` 0/1;
  timestamps become milliseconds since the epoch; a time-of-day column
  (``HH:MM[:SS]``) is a string column of ``datetime.time`` host values.
  Numbers may carry spaces around them.
- the NA asymmetry: the NA spellings (the defaults, or the user's list
  plus "") nullify numeric cells; string and enum columns keep them as
  levels ("NA" is a level, a bare empty field the level "") unless the user
  passed ``na_strings``.
- quoting: a field that starts with ``"`` may hold separators and line
  breaks, ``""`` inside it is a quote, text after its closing quote is
  kept; a quote elsewhere is literal.
- categorical domains sorted lexicographically as strings ("1", "10", ...,
  "2"), as H2O interns them.
- numbers parsed correctly rounded to float64, then cast to float32 by
  ``Vec.from_numpy``, which keeps the exact host copy where float32 loses
  a value.

The tokenizer is C++ on the host (``csrc/csv_tokenize.cpp``, compiled with
the host's C++ compiler at first use, as the kernels are with ``nvcc``):
two passes of one state machine with the quoting rules of Python's ``csv``
reader, which are pyarrow's, writing each column's fields into a
fixed-width byte matrix. The columns are then typed with numpy: integers
parsed from the digits, floats by numpy's correctly rounded conversion,
levels interned by a sort of the fields' bytes. Plain, ``.gz`` and ``.zip``
(first member) files.

The other formats the reference reads without pyarrow take its readers
and its column typing: Avro containers (``io/avro.py``), XLSX and legacy
XLS sheets (``io/xlsx.py``, ``io/xls.py``: first row the header, a column
holding any string interned as a categorical), SVMLight (``target`` then
``C0..Cmax`` float32 columns, absent entries 0) and ARFF (the
``@attribute`` lines type the columns). Their categorical levels are
interned here, sorted as Python sorts strings, as pyarrow's dictionary
and the reference's renumbering give them. Parquet and ORC need pyarrow
and raise ``NotImplementedError`` (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import ctypes
import datetime
import gzip
import hashlib
import itertools
import os
import re
import shutil
import subprocess
import threading
import zipfile
from typing import Sequence

import numpy as np

from ..backend.kernels import BUILD_DIR, CSRC_DIR
from ..backend.kvstore import STORE
from ..frame.frame import Frame
from ..frame.vec import T_CAT, T_INT, T_NUM, T_STR, T_TIME, Vec
from ..parallel.mesh import resolve_device
from ..utils import failpoints, knobs

#: NA spellings — the reference's `water/parser/ParseSetup` vocabulary
DEFAULT_NA_STRINGS = ["", "NA", "N/A", "na", "NaN", "nan", "null", "NULL",
                      "?", "None"]

#: formats the reference reads through pyarrow, which the port does not
OTHER_FORMATS = (".parquet", ".pq", ".orc")

_TRUE = (b"1", b"True", b"TRUE", b"true")      # pyarrow's boolean spellings
_FALSE = (b"0", b"False", b"FALSE", b"false")
_FLOAT_WORDS = re.compile(rb"[+-]?(inf|infinity|nan)", re.IGNORECASE)
_ISO_TIME = re.compile(
    rb"\d{4}-\d{2}-\d{2}([ T]\d{2}(:\d{2}(:\d{2}(\.\d{1,9})?)?)?)?Z?")
_TIME_OF_DAY = re.compile(rb"(\d{2}):(\d{2})(?::(\d{2}))?")


class ParseSetup:
    """Parse configuration, guessed from a sample or given by the user
    (the role of `water/parser/ParseSetup.java`)."""

    def __init__(self, separator: str | None = None,
                 header: bool | None = None,
                 column_names: Sequence[str] | None = None,
                 column_types: dict | None = None,
                 na_strings: Sequence[str] | None = None,
                 skipped_columns: Sequence[str] | None = None):
        self.separator = separator
        self.header = header
        self.column_names = list(column_names) if column_names else None
        self.column_types = dict(column_types or {})
        self.na_strings = list(na_strings if na_strings is not None
                               else DEFAULT_NA_STRINGS)
        # string/enum cells go NA only on a spelling the user gave
        self.na_strings_user = na_strings is not None
        self.skipped_columns = list(skipped_columns or [])


def _refuse_format(path: str) -> None:
    if "://" in path:
        raise NotImplementedError(
            f"{path}: URI schemes (the persist backends) are not ported yet "
            "(ROADMAP Queue 1 item 13)")
    if path.lower().endswith(OTHER_FORMATS):
        raise NotImplementedError(
            f"{os.path.basename(path)}: parquet and orc need pyarrow, "
            "which the port does without (ROADMAP Queue 1 item 3)")


def _read_bytes(path: str, limit: int | None = None) -> bytes:
    """The file's bytes, decompressed (.gz; a .zip's first member)."""
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read() if limit is None else f.read(limit)
    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as zf:
            with zf.open(zf.namelist()[0]) as f:
                return f.read() if limit is None else f.read(limit)
    with open(path, "rb") as f:
        return f.read() if limit is None else f.read(limit)


def guess_setup(path: str, setup: ParseSetup | None = None) -> ParseSetup:
    """Sample the file's head and guess the separator and the header
    (ParseSetup's first pass, the reference's heuristics)."""
    setup = setup or ParseSetup()
    head = _read_bytes(path, 1 << 16).decode("utf-8", errors="replace")
    lines = [ln for ln in head.splitlines() if ln.strip()][:50]
    if not lines:
        return setup
    if setup.separator is None:
        counts = {sep: lines[0].count(sep) for sep in [",", "\t", ";", "|"]}
        best = max(counts, key=counts.get)
        setup.separator = best if counts[best] > 0 else ","
    if setup.header is None:
        # the first row's tokens are not numbers
        first = lines[0].split(setup.separator)
        setup.header = not any(_is_number(t) for t in first)
    return setup


def _is_number(tok: str) -> bool:
    try:
        float(tok.strip().strip('"'))
        return True
    except ValueError:
        return False


def _check_frame_size(n_rows: int, n_cols: int) -> None:
    """Refuse a parse whose float32 device columns would exceed
    ``H2O_TORCH_MAX_FRAME_BYTES`` (`water/FrameSizeMonitor.java`)."""
    cap = knobs.get_int("H2O_TORCH_MAX_FRAME_BYTES")
    est = n_rows * n_cols * 4
    if est > cap:
        raise MemoryError(
            f"parse would allocate ~{est / 1e9:.1f} GB of device columns "
            f"({n_rows} rows x {n_cols} cols), over the {cap / 1e9:.1f} GB "
            "budget — set H2O_TORCH_MAX_FRAME_BYTES to raise it")


# ---------------------------------------------------------------------------
# tokenizing: the file's bytes -> one fixed-width bytes array per column
# ---------------------------------------------------------------------------
_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_CSV_LIB: ctypes.CDLL | None = None
_CSV_LOCK = threading.Lock()


def _csv_library() -> ctypes.CDLL:
    """The host tokenizer (``csrc/csv_tokenize.cpp``), compiled with the
    host's C++ compiler at first use into the git-ignored ``build/``, named
    by the hash of its source and flags."""
    global _CSV_LIB
    with _CSV_LOCK:
        if _CSV_LIB is not None:
            return _CSV_LIB
        src = CSRC_DIR / "csv_tokenize.cpp"
        h = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + src.read_bytes())
        out = BUILD_DIR / f"libh2o_csv-{h.hexdigest()[:16]}.so"
        if not out.exists():
            cxx = (shutil.which("c++") or shutil.which("g++")
                   or shutil.which("clang++"))
            if cxx is None:
                raise RuntimeError("no C++ compiler (c++, g++ or clang++ on "
                                   "PATH) — the CSV tokenizer cannot be "
                                   "built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp),
                                   str(src)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.h2o_csv_shape.argtypes = [ctypes.c_char_p, i64, ctypes.c_uint8,
                                      i32, vp, vp, vp, vp]
        lib.h2o_csv_shape.restype = ctypes.c_int
        lib.h2o_csv_fill.argtypes = [ctypes.c_char_p, i64, ctypes.c_uint8,
                                     vp, vp]
        lib.h2o_csv_fill.restype = None
        _CSV_LIB = lib
        return lib


def _tokenize(buf: bytes, sep: str) -> list[np.ndarray]:
    """Every non-empty record's fields, as one numpy ``S`` array per column
    (the first record included), through the host C++ tokenizer: one pass
    for the record count and each column's widest field, one that writes
    every field's content (quotes stripped, ``""`` read as ``"``) into its
    column's zeroed byte matrix."""
    if len(sep) != 1 or not sep.isascii() or sep in '"\r\n':
        raise ValueError(f"separator {sep!r}: want one ASCII character "
                         "other than a quote or a line break")
    lib = _csv_library()
    ncol, nrec, bad = ctypes.c_int32(), ctypes.c_int64(), ctypes.c_int32()
    max_cols = 256
    while True:
        widths = np.zeros(max_cols, dtype=np.int64)
        rc = lib.h2o_csv_shape(buf, len(buf), ord(sep), max_cols,
                               ctypes.byref(ncol), ctypes.byref(nrec),
                               widths.ctypes.data, ctypes.byref(bad))
        if rc != 2:
            break
        max_cols = ncol.value
    if rc == 1:
        raise ValueError(f"CSV parse error: expected {ncol.value} columns, "
                         f"got {bad.value} on non-empty line "
                         f"{nrec.value + 1}")
    widths = np.maximum(widths[:ncol.value], 1)
    mats = [np.zeros((nrec.value, int(w)), dtype=np.uint8) for w in widths]
    ptrs = (ctypes.c_void_p * len(mats))(*[m.ctypes.data for m in mats])
    lib.h2o_csv_fill(buf, len(buf), ord(sep), ptrs, widths.ctypes.data)
    return [m.view(f"S{m.shape[1]}").ravel() for m in mats]


# ---------------------------------------------------------------------------
# column typing (pyarrow's inference order) and conversion
# ---------------------------------------------------------------------------
def _byte_matrix(s: np.ndarray) -> np.ndarray:
    W = s.dtype.itemsize
    return np.ascontiguousarray(s).view(np.uint8).reshape(len(s), W)


def _table(chars: bytes, nul: bool = True) -> np.ndarray:
    """A 256-entry lookup of the bytes in ``chars`` (and the NUL padding
    of an ``S`` array, unless ``nul`` is False)."""
    tbl = np.zeros(256, dtype=bool)
    tbl[np.frombuffer(chars, np.uint8)] = True
    tbl[0] = nul
    return tbl


_DIGITS = _table(b"0123456789")
#: each byte's hex digit value, -1 for a byte that is not one
_HEX_VALUE = np.full(256, -1, dtype=np.int64)
for _c in b"0123456789abcdefABCDEF":
    _HEX_VALUE[_c] = int(chr(_c), 16)
_FLOAT_CHARS = _table(b"0123456789+-.eE")


def _is_any(s: np.ndarray, words) -> np.ndarray:
    """Elementwise ``s in words``: only the fields whose first byte starts
    a word are compared (``np.isin`` would sort the whole column)."""
    out = np.zeros(len(s), dtype=bool)
    if not len(s):
        return out
    first = _table(bytes(w[0] for w in words if w), nul=b"" in words)
    cand = np.flatnonzero(first[_byte_matrix(s)[:, 0]])
    sub = s[cand]
    hit = np.zeros(len(cand), dtype=bool)
    for w in words:
        hit |= sub == w
    out[cand] = hit
    return out


def _strip_spaces(s: np.ndarray) -> np.ndarray:
    """Numbers may carry spaces around them (pyarrow trims them)."""
    if len(s) and (_byte_matrix(s) == 32).any():
        return np.char.strip(s, b" ")
    return s


def _as_int64(s: np.ndarray):
    """int64 values when every field is an int64 in pyarrow's syntax, else
    None (wider integers go to float64): ``-``? and decimal digits (leading
    zeros free) inside int64's range, or ``0x``/``0X`` and 1..16 hex
    digits, whose 64 bits are the value."""
    if not len(s):
        return None
    m = _byte_matrix(s)
    hexr = ((m[:, 0] == 48) & ((m[:, 1] | 32) == 120) if m.shape[1] > 1
            else np.zeros(len(s), dtype=bool))
    out = np.empty(len(s), dtype=np.int64)
    for rows, parse in ((hexr, _hex_int64), (~hexr, _dec_int64)):
        if rows.any():
            v = parse(m[rows])
            if v is None:
                return None
            out[rows] = v
    return out


def _dec_int64(m: np.ndarray):
    neg = m[:, 0] == 45
    if not (_DIGITS[m[:, 0]] | neg).all() or not _DIGITS[m[:, 1:]].all():
        return None
    d = m.astype(np.int64) - 48
    digit = (d >= 0) & (d <= 9)
    if (digit.sum(axis=1) < 1).any():
        return None
    # significant digits: those from the first nonzero one on
    sig = digit & (np.cumsum(digit & (d > 0), axis=1) > 0)
    if (sig.sum(axis=1) > 19).any():
        return None
    acc = np.zeros(len(m), dtype=np.uint64)
    for c in range(m.shape[1]):
        acc = np.where(digit[:, c], acc * np.uint64(10)
                       + d[:, c].astype(np.uint64), acc)
    if (acc > np.uint64(2 ** 63 - 1) + neg.astype(np.uint64)).any():
        return None
    v = acc.view(np.int64)      # -2^63 stays -2^63 under the negation
    return np.where(neg, -v, v)


def _hex_int64(m: np.ndarray):
    h = m[:, 2:]
    ok = _HEX_VALUE[h] >= 0
    nd = ok.sum(axis=1)
    if not (ok | (h == 0)).all() or (nd < 1).any() or (nd > 16).any():
        return None
    acc = np.zeros(len(m), dtype=np.uint64)
    for c in range(h.shape[1]):
        acc = np.where(ok[:, c], acc * np.uint64(16)
                       + _HEX_VALUE[h[:, c]].astype(np.uint64), acc)
    return acc.view(np.int64)


def _as_time_of_day(s: np.ndarray):
    """``HH:MM`` or ``HH:MM:SS`` fields (two digits each, 00-23, 00-59,
    00-59: pyarrow's time32[s]) -> an object array of ``datetime.time``,
    or None."""
    if not len(s):
        return None
    m = _byte_matrix(s)
    if m.shape[1] < 5 or not (m[:, 2] == 58).all():
        return None
    uniq, inv = np.unique(s, return_inverse=True)
    times = []
    for t in uniq:
        hit = _TIME_OF_DAY.fullmatch(bytes(t))
        if hit is None:
            return None
        h, mi, sec = (int(g or 0) for g in hit.groups())
        if h > 23 or mi > 59 or sec > 59:
            return None
        times.append(datetime.time(h, mi, sec))
    return np.array(times, dtype=object)[inv.ravel()]


def _as_float64(s: np.ndarray):
    """float64 values, each correctly rounded, or None when a field is not
    a number in pyarrow's syntax."""
    if not len(s):
        return None
    m = _byte_matrix(s)
    plain = _FLOAT_CHARS[m].all(axis=1) & (m[:, 0] != 0)
    if not plain.all():
        if not all(_FLOAT_WORDS.fullmatch(bytes(t)) for t in s[~plain]):
            return None
    try:
        return s.astype(np.float64)
    except ValueError:
        return None


def _as_bool(s: np.ndarray):
    t = _is_any(s, _TRUE)
    f = _is_any(s, _FALSE)
    return t.astype(np.float32) if (t | f).all() else None


def _as_epoch_ms(s: np.ndarray):
    """ISO dates and timestamps -> float64 ms since the epoch, or None."""
    if not len(s):
        return None
    m = _byte_matrix(s)
    if m.shape[1] < 10 or not ((m[:, 4] == 45) & (m[:, 7] == 45)).all():
        return None
    uniq, inv = np.unique(s, return_inverse=True)
    if not all(_ISO_TIME.fullmatch(bytes(t)) for t in uniq):
        return None
    try:
        ms = np.array([t.decode().rstrip("Z") for t in uniq],
                      dtype="datetime64[ms]").astype(np.int64)
    except ValueError:
        return None
    return ms.astype(np.float64)[inv.ravel()]


def _unique_codes(s: np.ndarray):
    """(sorted unique fields, each field's index into them), in byte
    order, which is the code-point order of UTF-8 strings. Fields of up to
    8 bytes compare as big-endian integers. The levels of the first 2^16
    fields are tried first: when they cover the column, one binary search
    a field codes it without a sort of the whole column."""
    W = s.dtype.itemsize
    if W > 8:
        keys = s
    else:
        m = np.zeros((len(s), 8), dtype=np.uint8)
        m[:, :W] = _byte_matrix(s)
        keys = m.view(">u8").ravel()
    uniq = np.unique(keys[:1 << 16])
    inv = np.minimum(np.searchsorted(uniq, keys), max(len(uniq) - 1, 0))
    if not len(uniq) or not (uniq[inv] == keys).all():
        uniq, inv = np.unique(keys, return_inverse=True)
    if W <= 8:
        uniq = uniq.astype(">u8").view("S8")
    return uniq, inv.ravel()


def _intern(s: np.ndarray, null: np.ndarray, device) -> Vec:
    """Categorical interning: the domain sorted lexicographically, codes
    onto it, NaN where the cell is NA."""
    codes = np.full(len(s), np.nan, dtype=np.float32)
    uniq, inv = _unique_codes(s[~null])
    codes[~null] = inv
    domain = [u.decode("utf-8", errors="replace") for u in uniq]
    return Vec.from_numpy(codes, type=T_CAT, domain=domain, device=device)


def _convert(s: np.ndarray, name: str, want, setup: ParseSetup,
             nulls: list, device) -> Vec:
    """One column's fields -> a Vec, by the reference's `_table_to_frame`."""
    n = len(s)
    null = _is_any(s, nulls)
    str_null = null if setup.na_strings_user else np.zeros(n, dtype=bool)
    if want == T_STR:
        host = np.array([t.decode("utf-8", errors="replace") for t in s],
                        dtype=object)
        host[str_null] = None
        return Vec(None, n, type=T_STR, host_data=host)
    if want == T_CAT:
        return _intern(s, str_null, device)
    vals = _strip_spaces(s[~null])

    def with_nulls(v):
        out = np.full(n, np.nan, dtype=np.float64)
        out[~null] = v
        return out

    if want in (T_NUM, T_INT):
        f = _as_float64(vals)
        if f is None:
            raise ValueError(f"column '{name}' is typed {want} but holds a "
                             "value that is not a number")
        return Vec.from_numpy(with_nulls(f), type=want, device=device)
    if not len(vals):
        # all NA: numeric, as the reference's all-NA columns are
        return Vec.from_numpy(np.full(n, np.nan, np.float64), type=T_NUM,
                              device=device)
    i = _as_int64(vals)
    if i is not None:
        if want == T_TIME:
            return Vec.from_numpy(with_nulls(i), type=T_TIME, device=device)
        arr = i if not null.any() else with_nulls(i)
        return Vec.from_numpy(arr, type=T_INT, device=device)
    b = _as_bool(s[~null])
    if b is not None and want != T_TIME:
        return Vec.from_numpy(with_nulls(b).astype(np.float32), type=T_INT,
                              device=device)
    ms = _as_epoch_ms(s[~null])
    if ms is not None:
        return Vec.from_numpy(with_nulls(ms), type=T_TIME, device=device)
    if want == T_TIME:
        raise ValueError(f"column '{name}' is typed time but holds a value "
                         "that is not an ISO date or timestamp")
    tod = _as_time_of_day(vals)
    if tod is not None:
        # pyarrow's time32 column: the reference keeps its host values
        host = np.full(n, None, dtype=object)
        host[~null] = tod
        return Vec(None, n, type=T_STR, host_data=host)
    f = _as_float64(vals)
    if f is not None:
        arr = with_nulls(f)
        finite = arr[np.isfinite(arr)]
        t = T_INT if finite.size and np.all(finite == np.floor(finite)) \
            else T_NUM
        return Vec.from_numpy(arr, type=t, device=device)
    return _intern(s, str_null, device)


# ---------------------------------------------------------------------------
# Avro, spreadsheets, SVMLight and ARFF (the reference's
# ``_parse_avro``/``_spreadsheet_to_frame``/``_parse_svmlight``/``_parse_arff``)
# ---------------------------------------------------------------------------
def _intern_strings(vals, device) -> Vec:
    """A column of strings (None for NA) as a categorical, through the
    CSV path's interning (levels in UTF-8 byte order, which is Python's
    string order)."""
    null = np.array([v is None for v in vals], dtype=bool)
    s = np.array([b"" if v is None else v.encode("utf-8") for v in vals],
                 dtype=np.bytes_)
    return _intern(s, null, device)


def _parse_avro(path: str, device, dest_key: str | None = None) -> Frame:
    """Avro container ingest (``io/avro.py``; `h2o-parsers/h2o-avro-parser`:
    flat records -> columns). Enums are categoricals over the schema's
    symbols, strings host columns, NA-free int/long columns exact
    integers, everything else float64 cast by ``Vec.from_numpy``."""
    from .avro import read_avro

    names, cols, domains, types = read_avro(path)
    out = {}
    for name, vals, dom, prim in zip(names, cols, domains, types):
        if dom is not None:
            lut = {s: i for i, s in enumerate(dom)}
            arr = np.array([np.nan if v is None else lut[v] for v in vals],
                           dtype=np.float32)
            out[name] = Vec.from_numpy(arr, type=T_CAT, domain=list(dom),
                                       device=device)
        elif prim in ("string", "bytes", "fixed"):
            out[name] = Vec.from_numpy(np.array(
                [None if v is None else
                 (v.decode("utf-8", "replace") if isinstance(v, bytes)
                  else str(v)) for v in vals], dtype=object))
        elif prim in ("int", "long") and not any(v is None for v in vals):
            out[name] = Vec.from_numpy(np.array(vals, dtype=np.int64),
                                       device=device)
        else:
            arr = np.array([np.nan if v is None else float(v) for v in vals],
                           dtype=np.float64)
            out[name] = Vec.from_numpy(arr, device=device)
    return Frame(list(out), list(out.values()), key=dest_key)


def _spreadsheet_to_frame(header, rows, device,
                          dest_key: str | None = None) -> Frame:
    """The XLSX and XLS cell grid -> Frame: duplicate header names take a
    count suffix, a column holding any string is a categorical (its other
    cells as their ``str``), the rest float64."""
    seen: dict[str, int] = {}
    uniq = []
    for name in header:
        if name in seen:
            seen[name] += 1
            uniq.append(f"{name}{seen[name]}")
        else:
            seen[name] = 0
            uniq.append(name)
    out = {}
    for j, name in enumerate(uniq):
        vals = [r[j] if j < len(r) else None for r in rows]
        if any(isinstance(v, str) for v in vals):
            out[name] = _intern_strings(
                [None if v is None else str(v) for v in vals], device)
        else:
            arr = np.array([np.nan if v is None else float(v)
                            for v in vals], dtype=np.float64)
            out[name] = Vec.from_numpy(arr, device=device)
    return Frame(list(out), list(out.values()), key=dest_key)


def _parse_xlsx(path: str, device, dest_key: str | None = None) -> Frame:
    """XLSX ingest (``io/xlsx.py``, the first sheet)."""
    from .xlsx import read_xlsx

    header, rows = read_xlsx(path)
    return _spreadsheet_to_frame(header, rows, device, dest_key)


def _parse_xls(path: str, device, dest_key: str | None = None) -> Frame:
    """Legacy BIFF8 .xls ingest (``io/xls.py``): the first row is the
    header, as for XLSX."""
    from .xls import cells_to_rows, parse_xls_cells

    with open(path, "rb") as fh:
        grid = cells_to_rows(parse_xls_cells(fh.read()))
    if not grid:
        raise ValueError(f"xls: no cells in {path}")
    header = [str(v) if v is not None else f"C{i + 1}"
              for i, v in enumerate(grid[0])]
    return _spreadsheet_to_frame(header, grid[1:], device, dest_key)


def _parse_svmlight(path: str, device, dest_key: str | None = None) -> Frame:
    """SVMLight (`water/parser/SVMLightParser.java`): per line a target and
    ``index:value`` pairs, ``#`` starting a comment. The frame is
    ``target`` and ``C0..Cmax`` float32 columns, absent entries 0 (a
    repeated index keeps its last value). Each value is parsed correctly
    rounded to float64, then cast to float32, as the reference's
    ``float()`` and its float32 matrix do."""
    targets, pairs, counts = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split("#", 1)[0].split()
            if not parts:
                continue
            targets.append(parts[0])
            counts.append(len(parts) - 1)
            pairs.extend(parts[1:])
    n = len(targets)
    kv = ":".join(pairs).split(":") if pairs else []
    if len(kv) != 2 * len(pairs):
        for p in pairs:         # the pair without one ':' raises here
            k, v = p.split(":")
    k = np.array(list(map(int, kv[0::2])), dtype=np.int64)
    v = np.array(list(map(float, kv[1::2])), dtype=np.float64)
    max_idx = max(0, int(k.max())) if k.size else 0
    _check_frame_size(n, max_idx + 2)       # + the target column
    mat = np.zeros((n, max_idx + 1), dtype=np.float32)
    mat[np.repeat(np.arange(n), counts), k] = v
    cols = {"target": np.array([float(t) for t in targets],
                               dtype=np.float32)}
    for j in range(max_idx + 1):
        cols[f"C{j}"] = mat[:, j]
    return Frame.from_dict(cols, device=device, key=dest_key)


def _parse_arff(path: str, device, dest_key: str | None = None) -> Frame:
    """ARFF (`water/parser/ARFFParser.java`): the ``@attribute`` lines type
    the columns (numeric, nominal ``{...}`` as a categorical over its listed
    levels, anything else host strings), the ``@data`` rows parse as CSV
    with single quotes; ``?`` or an empty cell is NA. Sparse rows raise."""
    import csv as _csv

    names, kinds, domains = [], [], []
    data_rows = []
    in_data = False
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("%"):
                continue
            low = line.lower()
            if not in_data and low.startswith("@attribute"):
                rest = line.split(None, 1)[1]
                if rest.startswith(("'", '"')):
                    q = rest[0]
                    end = rest.index(q, 1)
                    name, spec = rest[1:end], rest[end + 1:].strip()
                else:
                    name, _, spec = rest.partition(" ")
                    spec = spec.strip()
                names.append(name)
                if spec.startswith("{"):
                    kinds.append("enum")
                    toks = next(_csv.reader([spec.strip("{}")],
                                            quotechar="'",
                                            skipinitialspace=True))
                    domains.append([t.strip().strip("'\"") for t in toks])
                elif spec.lower() in ("numeric", "integer", "real"):
                    kinds.append("numeric")
                    domains.append(None)
                else:       # string / date / relational: host strings
                    kinds.append("string")
                    domains.append(None)
            elif low.startswith("@data"):
                in_data = True
            elif in_data:
                if line.startswith("{"):
                    raise NotImplementedError(
                        "sparse-format ARFF ({index value, ...} rows) is not "
                        "supported — densify or convert to CSV")
                # ARFF quotes with single quotes; a row without one splits
                # on commas as the csv reader would
                data_rows.append(
                    next(_csv.reader([line], quotechar="'")) if "'" in line
                    else line.split(","))
    n = len(data_rows)
    # the cells column by column, a short row's missing cells "?"
    by_col = list(itertools.zip_longest(*data_rows, fillvalue="?"))
    cols = {}
    for j, (name, kind, dom) in enumerate(zip(names, kinds, domains)):
        raw = list(map(str.strip, by_col[j])) if j < len(by_col) \
            else ["?"] * n
        if kind == "numeric":
            try:                # no NA cell: every cell a number
                vals = np.array(list(map(float, raw)), dtype=np.float64)
            except ValueError:
                vals = np.array([np.nan if t in ("?", "") else float(t)
                                 for t in raw], dtype=np.float64)
            cols[name] = Vec.from_numpy(vals, device=device)
        elif kind == "enum":
            lut = {lvl: i for i, lvl in enumerate(dom)}
            vals = np.array([np.nan if t in ("?", "") else
                             lut.get(t.strip("'\""), np.nan) for t in raw],
                            dtype=np.float32)
            cols[name] = Vec.from_numpy(vals, type=T_CAT, domain=dom,
                                        device=device)
        else:
            vals = np.array([None if t in ("?", "") else t.strip("'\"")
                             for t in raw], dtype=object)
            cols[name] = Vec(None, n, type=T_STR, host_data=vals)
    _check_frame_size(n, len(names))
    return Frame(list(cols), list(cols.values()), key=dest_key)


_OTHER_PARSERS = {".avro": _parse_avro, ".xlsx": _parse_xlsx,
                  ".xls": _parse_xls, ".svm": _parse_svmlight,
                  ".svmlight": _parse_svmlight, ".arff": _parse_arff}


def parse_file(path: str, setup: ParseSetup | None = None,
               dest_key: str | None = None, device=None) -> Frame:
    """Parse one file into a Frame on ``device`` (default ``cuda``), the
    role of ``ParseDataset.parse``: CSV/TSV by default, Avro, XLSX, XLS,
    SVMLight and ARFF by their extension (which ignore ``setup``, as the
    reference's readers do)."""
    failpoints.hit("parser.parse")
    _refuse_format(path)
    dev = resolve_device(device)
    other = _OTHER_PARSERS.get(os.path.splitext(path)[1].lower())
    if other is not None:
        return STORE.put_keyed(other(path, dev, dest_key))
    setup = guess_setup(path, setup)
    cols = _tokenize(_read_bytes(path), setup.separator or ",")
    if setup.header:
        header = [c[0].decode("utf-8", errors="replace") for c in cols]
        cols = [c[1:] for c in cols]
    else:
        header = [f"f{i}" for i in range(len(cols))]
    names = list(setup.column_names) if setup.column_names else header
    if len(names) != len(cols):
        raise ValueError(f"{len(names)} column names for {len(cols)} "
                         "columns")
    nrow = len(cols[0]) if cols else 0
    _check_frame_size(nrow, sum(
        1 for nm in names if nm not in setup.skipped_columns
        and setup.column_types.get(nm) != T_STR))
    nas = list(setup.na_strings)
    if "" not in nas:
        nas.append("")      # numeric empties are NA whatever the list
    nulls = [t.encode("utf-8") for t in nas]
    out_names, vecs = [], []
    for nm, s in zip(names, cols):
        if nm in setup.skipped_columns:
            continue
        vecs.append(_convert(s, nm, setup.column_types.get(nm), setup,
                             nulls, dev))
        out_names.append(nm)
    return STORE.put_keyed(Frame(out_names, vecs, key=dest_key))


def import_file(path: str, destination_frame: str | None = None,
                header: bool | None = None, sep: str | None = None,
                col_names: Sequence[str] | None = None,
                col_types: dict | None = None,
                na_strings: Sequence[str] | None = None,
                device=None) -> Frame:
    """Public ingest entry — ``h2o.import_file`` (`h2o-py/h2o/h2o.py:323`):
    a local path, CSV/TSV (plain, ``.gz`` or ``.zip``), Avro, XLSX, XLS,
    SVMLight or ARFF."""
    setup = ParseSetup(separator=sep, header=header, column_names=col_names,
                       column_types=col_types, na_strings=na_strings)
    return parse_file(path, setup, dest_key=destination_frame, device=device)
