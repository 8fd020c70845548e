#!/usr/bin/env python3
"""Where the train wall of the PyTorch/CUDA port goes, on one GPU.

    python3 tools/port_profile.py [airlines|higgs] [--rows N] [--trees T]

Builds the shape's frame with ``chip_smoke.py``'s generator (airlines:
116M rows by default, higgs: 11M), trains the GBM of ``chip_smoke.py``
twice — a warm-up, then the timed run — and prints one JSON line per run
with the seconds spent in each phase of ``GBM.train_model``:

- ``features``: feature selection and column rollups;
- ``edges``: bin edges (quantile sketch, categorical cuts);
- ``binned_view``: bin codes packed into the int8/int16 matrix;
- ``hist``: level histograms (node window, kernel launch, scatter-back);
- ``splits``: split search; ``route``: node routing;
- ``leaf_totals``: the per-node totals that give leaf values;
- ``metrics``: training metrics; ``other``: the rest of the wall.

Each phase is timed on the host clock between two ``torch.cuda.synchronize``
calls, so a phase's device work is charged to it. The synchronisations add
a little to the wall (about 60 per tree), which is why the timed run's
``train_s`` is printed beside the plain ``train_s`` of a run without them.
Then one tree under ``torch.profiler`` gives the device time by kernel name
(top 12) and the device's busy share of that tree's wall. Imports nothing
of JAX or of ``h2o_tpu``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timers(T):
    """Wrap the phases of the build in synchronised host timers."""
    import torch

    from h2o_tpu_torch.frame import chunks
    from h2o_tpu_torch.models import gbm, model_base
    from h2o_tpu_torch.models.tree import engine

    def wrap(owner, name, phase, static=False):
        fn = getattr(owner, name)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            T[phase] += time.perf_counter() - t0
            return out

        setattr(owner, name, staticmethod(timed) if static else timed)

    wrap(model_base.ModelBuilder, "feature_names", "features")
    wrap(gbm, "compute_bin_edges_cols", "edges")
    wrap(chunks.BinnedView, "build", "binned_view", static=True)
    wrap(engine, "_build_level_hist", "hist")
    wrap(engine, "_find_splits", "splits")
    wrap(engine, "_route_all", "route")
    wrap(engine, "_node_totals", "leaf_totals")
    wrap(gbm, "make_metrics", "metrics")


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("shape", nargs="?", default="airlines",
                    choices=("airlines", "higgs"))
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--trees", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_profile: no CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    if args.shape == "airlines":
        rows = args.rows or cs.AIRLINES_ROWS
        fr, response = cs._airlines_frame(rows, dev), "IsDepDelayed"
    else:
        rows = args.rows or cs.HIGGS_ROWS
        fr, response = cs._higgs_frame(rows, dev), "response"

    def train():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = cs._gbm(fr, args.trees, response=response)
        return model, time.perf_counter() - t0

    train()                                     # warm-up: build, allocator
    _, plain_s = train()
    T = collections.defaultdict(float)
    _timers(T)
    model, timed_s = train()
    phases = dict(T, other=timed_s - sum(T.values()))
    print("phases", json.dumps(dict(
        shape=args.shape, rows=rows, ntrees=args.trees, train_s=plain_s,
        timed_train_s=timed_s, auc=model.output.training_metrics.auc,
        phase_s=phases)), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs._gbm(fr, 1, response=response)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows_k = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages() if e.self_device_time_total > 0]
    rows_k.sort(key=lambda r: -r[1])
    # device busy share: union of the kernels' intervals over the wall
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    print("profile", json.dumps(dict(
        ntrees=1, wall_s=wall, device_busy_s=busy / 1e6,
        top_device_ms=[[k, ms, n] for k, ms, n in rows_k[:12]])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
