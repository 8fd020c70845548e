"""Kernels layer — hand-written Hopper kernels and their plain PyTorch
versions (``h2o_tpu/backend/kernels/``).

Each kernel module pairs a plain PyTorch function (the CPU path, and the
oracle the card is checked against) with a wrapper that dispatches on the
tensor's device: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises. There is no backend switch and no fallback.

Two kernels so far: the level histogram (``hist.py`` -> ``csrc/level_hist.cu``)
and the weighted Gram (``gram.py`` -> ``csrc/gram.cu``).

CUDA sources live in ``h2o_tpu_torch/csrc/``. They are compiled at first use
with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, run together),
linked into one shared library with a plain C interface, bound through
ctypes, and rebuilt when a source's content changes. Importing this package
on a machine without ``nvcc`` is fine: only a CUDA launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]          # h2o_tpu_torch/
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()
#: guards the wrappers' launch counters: concurrent builds on one card
#: (a grid's ``parallelism``) launch from several threads, and ``+= 1`` on
#: a module global is a read-modify-write
COUNT_LOCK = threading.Lock()
#: nvcc's output (ptxas register/shared-memory report) of the last build
#: this process ran; empty when the library was already built
BUILD_LOG = ""


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin) — "
                           "the CUDA kernels cannot be built")
    return found


def _build() -> Path:
    """Compile every ``csrc/*.cu`` into one library named by the hash of the
    sources and flags; an existing library with that hash is reused. Each
    source compiles in its own ``nvcc``, all started together, and one more
    call links the objects."""
    global BUILD_LOG
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libh2o_kernels-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}-{tag}.o" for s in srcs]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
    try:
        for c, p, log in zip(cmds, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(c)}\n{log}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    BUILD_LOG = "".join(logs)
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.h2o_level_hist.argtypes = [vp, i32, vp, vp, i64, i32, i32,
                                           i32, vp, vp, i32, i32, i32, i32,
                                           vp, i64, vp, vp, vp, vp]
            lib.h2o_level_hist.restype = i32
            lib.h2o_gram.argtypes = [vp, vp, vp, i64, i32, vp, i32, i32,
                                     i64, vp, vp, vp, vp]
            lib.h2o_gram.restype = i32
            lib.h2o_cuda_error_string.argtypes = [i32]
            lib.h2o_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.h2o_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
