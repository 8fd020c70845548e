"""String ops — `water/rapids/ast/prims/string/` analog
(``h2o_tpu/rapids/strings.py``: toupper, tolower, sub/gsub, trim, strsplit,
nchar, substring, grep/countmatches, replaceall...).

String Vecs live on the host (variable-length data has no place in device
memory); these ops are numpy-object passes there, as in the reference.
Categorical Vecs get the op applied to their DOMAIN only (string ops on
enums rewrite the domain, `AstToUpper` etc.), O(levels) instead of O(rows).
A numeric result goes to the device of its input column; a host string
column has none, so those ops take ``device`` (None -> ``cuda``).
"""

from __future__ import annotations

import re

import numpy as np

from ..frame.vec import T_CAT, T_INT, T_STR, Vec
from ..parallel.mesh import resolve_device


def _dev(v: Vec, device):
    return v.device if v.device is not None else resolve_device(device)


def _host_strings(v: Vec) -> list:
    """Row-wise python strings (None = NA) from a string or categorical Vec."""
    if v.is_string():
        return list(v.host_data)
    if v.is_categorical():
        return list(level_strings(v))
    raise TypeError(f"string op on {v.type} Vec")


def level_strings(v: Vec) -> np.ndarray:
    """A categorical column's level names, row by row (None = NA)."""
    x = v.to_numpy()
    lut = np.array(list(v.domain or []) + [None], dtype=object)
    return lut[np.where(np.isnan(x), len(lut) - 1, x).astype(np.int64)]


def _apply(v: Vec, fn) -> Vec:
    if v.is_categorical():
        return Vec(v.data, v.nrow, type=T_CAT,
                   domain=[fn(d) for d in v.domain])
    if not v.is_string():
        raise TypeError(f"string op on {v.type} Vec")
    out = np.array([None if s is None else fn(str(s)) for s in v.host_data],
                   dtype=object)
    return Vec(None, v.nrow, type=T_STR, host_data=out)


def toupper(v): return _apply(v, str.upper)
def tolower(v): return _apply(v, str.lower)
def trim(v): return _apply(v, str.strip)
def lstrip(v, chars=None): return _apply(v, lambda s: s.lstrip(chars))
def rstrip(v, chars=None): return _apply(v, lambda s: s.rstrip(chars))


def sub(v, pattern, replacement, ignore_case=False):
    flags = re.IGNORECASE if ignore_case else 0
    rx = re.compile(pattern, flags)
    return _apply(v, lambda s: rx.sub(replacement, s, count=1))


def gsub(v, pattern, replacement, ignore_case=False):
    flags = re.IGNORECASE if ignore_case else 0
    rx = re.compile(pattern, flags)
    return _apply(v, lambda s: rx.sub(replacement, s))


def substring(v, start, end=None):
    return _apply(v, lambda s: s[start:end])


def replaceall(v, pattern, replacement):  # alias used by h2o-py
    return gsub(v, pattern, replacement)


def nchar(v: Vec, device=None) -> Vec:
    if v.is_categorical():
        lens = np.array([len(d) for d in v.domain], dtype=np.float32)
        host = v.to_numpy()
        out = np.full(host.shape, np.nan, dtype=np.float32)
        ok = ~np.isnan(host)
        out[ok] = lens[host[ok].astype(np.int64)]
        return Vec.from_numpy(out, type=T_INT, device=_dev(v, device))
    out = np.array([np.nan if s is None else float(len(str(s)))
                    for s in v.host_data], dtype=np.float32)
    return Vec.from_numpy(out, type=T_INT, device=_dev(v, device))


def countmatches(v: Vec, patterns, device=None) -> Vec:
    if isinstance(patterns, str):
        patterns = [patterns]
    rxs = [re.compile(p) for p in patterns]

    def cnt(s):
        return float(sum(len(r.findall(s)) for r in rxs))

    if v.is_categorical():
        per_level = np.array([cnt(d) for d in v.domain], dtype=np.float32)
        host = v.to_numpy()
        out = np.full(host.shape, np.nan, dtype=np.float32)
        ok = ~np.isnan(host)
        out[ok] = per_level[host[ok].astype(np.int64)]
        return Vec.from_numpy(out, type=T_INT, device=_dev(v, device))
    out = np.array([np.nan if s is None else cnt(str(s)) for s in v.host_data],
                   dtype=np.float32)
    return Vec.from_numpy(out, type=T_INT, device=_dev(v, device))


def grep(v: Vec, pattern, ignore_case=False, invert=False,
         output_logical=True, device=None) -> Vec:
    """`AstGrep` — logical (or index) match vector over a string/cat column."""
    flags = re.IGNORECASE if ignore_case else 0
    rx = re.compile(pattern, flags)

    def hit(s):
        return rx.search(s) is not None

    if v.is_categorical():
        per_level = np.array([hit(d) for d in v.domain])
        host = v.to_numpy()
        ok = ~np.isnan(host)
        m = np.zeros(host.shape, dtype=bool)
        m[ok] = per_level[host[ok].astype(np.int64)]
    else:
        m = np.array([False if s is None else hit(str(s)) for s in v.host_data])
    if invert:
        m = ~m
    if output_logical:
        return Vec.from_numpy(m.astype(np.float32), type=T_INT,
                              device=_dev(v, device))
    return Vec.from_numpy(np.where(m)[0].astype(np.float32), type=T_INT,
                          device=_dev(v, device))


def strsplit(v: Vec, pattern) -> list[Vec]:
    """Split into N string columns (ragged padded with None) — `AstStrSplit`."""
    if v.is_categorical():
        host = level_strings(v)
    else:
        host = v.host_data
    rx = re.compile(pattern)
    parts = [None if s is None else rx.split(str(s)) for s in host]
    width = max((len(p) for p in parts if p), default=0)
    cols = []
    for j in range(width):
        cols.append(Vec(None, v.nrow, type=T_STR, host_data=np.array(
            [p[j] if p and j < len(p) else None for p in parts], dtype=object)))
    return cols


def ascharacter(v: Vec) -> Vec:
    """enum -> string column."""
    return Vec(None, v.nrow, type=T_STR, host_data=level_strings(v))


def asfactor(v: Vec, device=None) -> Vec:
    """string/int -> enum (sorted-domain interning, ParseDataset analog)."""
    if v.is_categorical():
        return v
    if v.is_string():
        vals = [None if s is None else str(s) for s in v.host_data]
        dom = sorted({s for s in vals if s is not None})
        lookup = {d: i for i, d in enumerate(dom)}
        codes = np.array([np.nan if s is None else lookup[s] for s in vals],
                         dtype=np.float32)
        return Vec.from_numpy(codes, type=T_CAT, domain=dom,
                              device=_dev(v, device))
    host = v.to_numpy()
    ok = ~np.isnan(host)
    lv = np.unique(host[ok]).astype(np.int64)
    lookup = {x: i for i, x in enumerate(lv)}
    codes = np.full(host.shape, np.nan, dtype=np.float32)
    codes[ok] = [lookup[int(x)] for x in host[ok]]
    return Vec.from_numpy(codes, type=T_CAT, domain=[str(x) for x in lv],
                          device=v.device)


def entropy(v: Vec, device=None) -> Vec:
    """Per-string Shannon character entropy (`AstEntropy`)."""
    import math

    def ent(s):
        if not s:
            return 0.0
        counts = {}
        for ch in s:
            counts[ch] = counts.get(ch, 0) + 1
        n = len(s)
        return -sum(c / n * math.log2(c / n) for c in counts.values())

    host = _host_strings(v)
    out = np.array([np.nan if s is None else ent(s) for s in host],
                   dtype=np.float32)
    return Vec.from_numpy(out, device=_dev(v, device))


def strdistance(v1: Vec, v2: Vec, measure: str = "lv",
                compare_empty: bool = True, device=None) -> Vec:
    """Pairwise string distance (`AstStrDistance`); Levenshtein ('lv') and
    Jaccard ('jaccard') measures."""

    def lev(a, b):
        if a == b:
            return 0
        prev = list(range(len(b) + 1))
        for i, ca in enumerate(a, 1):
            cur = [i]
            for j, cb in enumerate(b, 1):
                cur.append(min(prev[j] + 1, cur[-1] + 1,
                               prev[j - 1] + (ca != cb)))
            prev = cur
        return prev[-1]

    def jac(a, b):
        sa, sb = set(a), set(b)
        return 1.0 - len(sa & sb) / max(len(sa | sb), 1)

    def jw(a, b):
        # Jaro-Winkler SIMILARITY with the standard p=0.1 prefix boost —
        # the reference's 'jw' measure (util.comparison.string.StringComparator)
        if a == b:
            return 1.0
        la, lb = len(a), len(b)
        if la == 0 or lb == 0:
            return 0.0
        window = max(la, lb) // 2 - 1
        ma = [False] * la
        mb = [False] * lb
        m = 0
        for i in range(la):
            lo, hi = max(0, i - window), min(lb, i + window + 1)
            for j in range(lo, hi):
                if not mb[j] and a[i] == b[j]:
                    ma[i] = mb[j] = True
                    m += 1
                    break
        if m == 0:
            return 0.0
        t = 0
        k = 0
        for i in range(la):
            if ma[i]:
                while not mb[k]:
                    k += 1
                if a[i] != b[k]:
                    t += 1
                k += 1
        jaro = (m / la + m / lb + (m - t / 2) / m) / 3.0
        prefix = 0
        for ca, cb in zip(a[:4], b[:4]):
            if ca != cb:
                break
            prefix += 1
        return jaro + prefix * 0.1 * (1.0 - jaro)

    def lcs_dist(a, b):
        # longest-common-subsequence edit distance (stringdist 'lcs')
        dp = [[0] * (len(b) + 1) for _ in range(len(a) + 1)]
        for i, ca in enumerate(a, 1):
            for j, cb in enumerate(b, 1):
                dp[i][j] = dp[i - 1][j - 1] + 1 if ca == cb else \
                    max(dp[i - 1][j], dp[i][j - 1])
        return len(a) + len(b) - 2 * dp[len(a)][len(b)]

    fns = {"jaccard": jac, "jw": jw, "lcs": lcs_dist, "lv": lev}
    if measure not in fns:
        raise ValueError(f"strDistance: unsupported measure '{measure}' "
                         f"(supported: {sorted(fns)})")
    fn = fns[measure]
    h1, h2 = _host_strings(v1), _host_strings(v2)
    out = np.full(len(h1), np.nan, dtype=np.float32)
    for i, (a, b) in enumerate(zip(h1, h2)):
        if a is None or b is None:
            continue
        if (a == "" or b == "") and not compare_empty:
            continue
        out[i] = fn(a, b)
    return Vec.from_numpy(out, device=_dev(
        v1 if v1.device is not None else v2, device))


def tokenize(v: Vec, split: str = " ") -> Vec:
    """Flatten each string into one token per output row, NA row between
    originals (`AstTokenize` — the word2vec ingest shape)."""
    import re as _re

    host = _host_strings(v)
    out = []
    for s in host:
        if s is not None:
            out.extend(t for t in _re.split(split, s) if t)
        out.append(None)
    return Vec(None, len(out), type=T_STR,
               host_data=np.array(out, dtype=object))
