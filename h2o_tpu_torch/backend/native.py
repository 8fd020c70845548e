"""Host radix sort — the port's loader for ``csrc/radix.cpp``
(``h2o_tpu/backend/native.py``).

The merge's host path (multi-key, string, categorical, exact-int64 and
right-outer joins) orders the right table with a stable multi-column
argsort. Above 2^15 rows it runs the parallel LSB radix of
``csrc/radix.cpp``, compiled with the host's C++ compiler at first use into
the git-ignored ``build/`` (named by the hash of its source and flags, as
``io/parser.py`` builds the CSV tokenizer) and bound through ctypes. Below
2^15 rows ``np.lexsort`` sorts the same uint64 keys, so the two routes give
the same permutation. Where the library cannot be built or loaded, the
call raises: nothing falls back to numpy quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from .kernels import BUILD_DIR, CSRC_DIR

_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()

#: rows below which ``radix_lexsort`` sorts with ``np.lexsort``
RADIX_MIN_ROWS = 1 << 15


def lib() -> ctypes.CDLL:
    """The radix library, built on first use; raises when the host has
    no C++ compiler, the build fails or the library does not load."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        src = CSRC_DIR / "radix.cpp"
        h = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + src.read_bytes())
        out = BUILD_DIR / f"libh2o_radix-{h.hexdigest()[:16]}.so"
        if not out.exists():
            cxx = (shutil.which("c++") or shutil.which("g++")
                   or shutil.which("clang++"))
            if cxx is None:
                raise RuntimeError("no C++ compiler (c++, g++ or clang++ on "
                                   "PATH) — the radix sort cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp),
                                   str(src)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        L = ctypes.CDLL(str(out))
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        for name in ("h2otpu_radix_argsort_u64", "h2otpu_radix_refine_u64"):
            fn = getattr(L, name)
            fn.argtypes = [u64p, ctypes.c_int64, i64p, ctypes.c_int]
            fn.restype = None
        _LIB = L
        return L


def _as_sortable_u64(col: np.ndarray, ascending: bool = True,
                     na_first: bool = True) -> np.ndarray:
    """A float64 column -> order-preserving uint64 keys: the sign bit
    flipped for non-negatives, every bit for negatives; NaN maps to an
    extreme so NAs sort first ascending (H2O's order), or last."""
    col = np.ascontiguousarray(col, dtype=np.float64)
    bits = col.view(np.uint64).copy()
    neg = bits >> 63 != 0
    bits[neg] = ~bits[neg]
    bits[~neg] |= np.uint64(1) << np.uint64(63)
    nan = np.isnan(col)
    bits[nan] = 0 if na_first == ascending else np.uint64(0xFFFFFFFFFFFFFFFF)
    if not ascending:
        bits = np.uint64(0xFFFFFFFFFFFFFFFF) - bits
    return bits


def radix_lexsort(columns: list[np.ndarray],
                  ascending: list[bool] | None = None,
                  na_first: bool = True, nthreads: int = 0) -> np.ndarray:
    """Stable multi-column argsort; ``columns[0]`` is the primary key
    (unlike ``np.lexsort``). The radix library from 2^15 rows on,
    ``np.lexsort`` over the same keys below."""
    n = len(columns[0])
    ascending = ascending or [True] * len(columns)
    keys = [_as_sortable_u64(np.asarray(c, dtype=np.float64), asc, na_first)
            for c, asc in zip(columns, ascending)]
    if n < RADIX_MIN_ROWS:
        return np.lexsort(list(reversed(keys)))
    L = lib()
    order = np.empty(n, dtype=np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    op = order.ctypes.data_as(i64p)
    # least-significant column first; each refine is stable on prior order
    for i, k in enumerate(reversed(keys)):
        fn = (L.h2otpu_radix_argsort_u64 if i == 0
              else L.h2otpu_radix_refine_u64)
        fn(k.ctypes.data_as(u64p), n, op, nthreads)
    return order
