#!/usr/bin/env python3
"""Per-level times of the port's hand-written kernels on one GPU, and what
their shared-memory adds compile to.

    python3 tools/kernel_times.py [--pkg DIR]
                                  [--what build,grouped,flat,gram]
                                  [--reps N] [--sass]

Builds the kernels of the ``h2o_tpu_torch`` package found first on the path
(``--pkg DIR`` puts DIR in front, so two checkouts can be timed in one call,
in turns), prints nvcc's ``ptxas`` lines, and with ``--sass`` counts the
``ATOMS``/``ATOM``/``RED`` instructions of each kernel function in
``cuobjdump -sass`` of the built library (a native 64-bit shared add reads
``ATOMS.ADD.64``; a compare-and-swap loop reads ``ATOMS.CAS.64``). Then
it times the kernels alone, no plain version, on the inputs
``chip_smoke.py`` gives them:

- ``grouped``: ``hist._cuda_grouped`` at the airlines plan for n_lv = 1, 2,
  4, 8, 16 at the airlines train's 116,006,912 padded rows;
- ``flat``: ``hist._cuda_flat`` at the HIGGS shapes (11,001,856 rows, 28
  int8 features, 21 bins) for the same levels;
- ``build`` (only when asked for): seconds of the kernels' build as
  ``kernels._build`` runs it (one ``nvcc`` per source, started together,
  then a link) and of one ``nvcc`` call for all sources, each into an
  empty directory, in turns (parallel, one, one, parallel);
- ``gram``: ``gram._cuda_gram`` at 11,001,856 x 29 and 1,048,576 x 690,
  with z, beside one ``torch.mm`` of the same product, and
  ``chip_smoke.gram_tf32_probe`` at each width (the kernel's error against
  the float64 Gram on operands TF32 cannot hold).

Each time is CUDA events around ``--reps`` launches after a warm-up. One
more launch per case runs under ``torch.profiler``, whose device time by
kernel name splits a wrapper's time among its internal launches (for the
histogram: the absmax pass, the accumulation, the finalize). One JSON line
per case. Imports nothing of JAX or of ``h2o_tpu``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sass_counts(lib_path: str) -> dict:
    """{kernel function: {atomic opcode: count}} from ``cuobjdump -sass``."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                         text=True, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
            continue
        m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG)\.[A-Z0-9.]+)", line)
        if m and fn is not None:
            counts[fn][m.group(1)] += 1
    return {f: dict(c) for f, c in counts.items() if c}


def _build_seconds(kernels) -> None:
    """Wall seconds of the parallel build against one nvcc call."""
    import time

    srcs = [str(s) for s in sorted(kernels.CSRC_DIR.glob("*.cu"))]
    saved, out = kernels.BUILD_DIR, {"parallel": [], "one_nvcc": []}
    for how in ("parallel", "one_nvcc", "one_nvcc", "parallel"):
        d = saved / f"timing-{how}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        t0 = time.perf_counter()
        if how == "parallel":
            kernels.BUILD_DIR = d
            try:
                kernels._build()
            finally:
                kernels.BUILD_DIR = saved
        else:
            subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                            "-o", str(d / "lib.so"), *srcs], check=True,
                           capture_output=True)
        out[how].append(time.perf_counter() - t0)
        shutil.rmtree(d)
    print("build_s", json.dumps(out), flush=True)


def _profile_ms(fn) -> dict:
    """Device ms by kernel name for one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3
            for e in prof.key_averages() if e.self_device_time_total > 0}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", default=None)
    ap.add_argument("--what", default="grouped,flat,gram")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if args.pkg:
        sys.path.insert(0, os.path.abspath(args.pkg))
    import chip_smoke as cs
    from h2o_tpu_torch.backend import kernels
    from h2o_tpu_torch.backend.kernels import gram, hist
    from h2o_tpu_torch.parallel.mesh import padded_len

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print("package", os.path.dirname(kernels.__file__), flush=True)
    lib = kernels.load_library()
    for line in kernels.BUILD_LOG.splitlines():
        if "registers" in line or "smem" in line or "Compiling" in line:
            print("ptxas", line.strip(), flush=True)
    if args.sass:
        print("sass_atomics", json.dumps(_sass_counts(lib._name)), flush=True)
    dev = torch.device("cuda", 0)
    what = set(args.what.split(","))
    if "build" in what:
        _build_seconds(kernels)
    g = torch.Generator(device=dev).manual_seed(116)

    if "grouped" in what:
        B = 301
        groups = (((0, 2, 4, 7, 8), 32, "onehot"), ((1,), 16, "onehot"),
                  ((3,), 8, "segsum"), ((5, 6), 301, "onehot"))
        widths = (22, 12, 31, 7, 22, 300, 300, 20, 20)
        rl = padded_len(cs.AIRLINES_ROWS)
        total = 0.0
        for n_lv in (1, 2, 4, 8, 16):
            codes, lc, vv = cs._airlines_plan_inputs(dev, rl, widths, B,
                                                     n_lv, g)

            def call():
                return hist._cuda_grouped(codes, lc, vv, groups, n_lv, B - 1)
            ms = cs._cuda_ms(call, args.reps)
            total += ms
            print("grouped", json.dumps(dict(
                rows=rl, n_lv=n_lv, ms=ms, device_ms=_profile_ms(call))),
                flush=True)
            del codes, lc, vv
        print("grouped_tree_ms", total, flush=True)
        torch.cuda.empty_cache()

    if "flat" in what:
        rl, F, V, B = padded_len(cs.HIGGS_ROWS), cs.HIGGS_F, 3, 21
        codes = torch.randint(0, B - 1, (rl, F), generator=g, device=dev,
                              dtype=torch.int8)
        vv = torch.randn((rl, V), generator=g, device=dev)
        total = 0.0
        for n_lv in (1, 2, 4, 8, 16):
            lc = torch.randint(0, n_lv, (rl,), generator=g, device=dev,
                               dtype=torch.int32)

            def call():
                return hist._cuda_flat(codes, lc, vv, n_lv, B)
            ms = cs._cuda_ms(call, args.reps)
            total += ms
            print("flat", json.dumps(dict(rows=rl, n_lv=n_lv, ms=ms,
                                          device_ms=_profile_ms(call))),
                  flush=True)
        print("flat_tree_ms", total, flush=True)
        del codes, vv, lc
        torch.cuda.empty_cache()

    if "gram" in what:
        for R, P in (cs.GRAM_MAIN, cs.GRAM_WIDE):
            X = torch.randn((R, P), generator=g, device=dev)
            W = torch.rand((R,), generator=g, device=dev) * 0.25
            z = torch.randn((R,), generator=g, device=dev)

            def call():
                return gram._cuda_gram(X, W, z)
            ms = cs._cuda_ms(call, args.reps)
            A = X * W[:, None]
            Bm = torch.cat([X, z[:, None]], dim=1)
            mm = cs._cuda_ms(lambda: torch.mm(A.T, Bm), args.reps)
            del A, Bm
            # float32 accuracy on operands TF32 cannot hold
            f32_rel, tf32_rel = cs.gram_tf32_probe(dev, min(R, 1 << 20), P, g)
            print("gram", json.dumps(dict(
                rows=R, cols=P, ms=ms, mm_ms=mm, probe_kernel_rel=f32_rel,
                probe_tf32_rel=tf32_rel, device_ms=_profile_ms(call))),
                flush=True)
            del X, W, z
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
