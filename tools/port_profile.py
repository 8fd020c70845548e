#!/usr/bin/env python3
"""Where the train wall of the PyTorch/CUDA port goes, on one GPU.

    python3 tools/port_profile.py [airlines|higgs|glm|covtype|xgboost]
                                  [--rows N] [--trees T] [--solver S]

Builds the shape's frame with ``chip_smoke.py``'s generator (airlines:
116M rows by default, higgs, glm and xgboost: 11M, covtype: 581,012),
trains the GBM (for ``glm`` the binomial GLM, for ``covtype`` the
multinomial DRF, for ``xgboost`` the gbtree of ``chip_smoke.py``'s
``xgboost_train``: depth 6, up to 50 rounds scored every 5, early
stopping) of ``chip_smoke.py`` twice — a warm-up, then the timed run — and prints one
JSON line per run with the seconds spent in each phase of
``GBM.train_model`` (``DRF`` shares it):

- ``features``: feature selection and column rollups;
- ``edges``: bin edges (quantile sketch, categorical cuts);
- ``binned_view``: bin codes packed into the int8/int16 matrix;
- ``hist``: level histograms (node window, kernel launch, scatter-back);
- ``splits``: split search; ``route``: node routing;
- ``leaf_totals``: the per-node totals that give leaf values;
- ``sampling``: the threefry draws (row sample, column subsample, each
  level's column mask);
- ``metrics``: training metrics (out of bag for DRF); ``other``: the rest
  of the wall — for DRF mostly the host's launches of the small per-level
  and per-tree ops;

or of ``GLM.train_model``:

- ``features``: feature selection and column rollups;
- ``expand``: ``DataInfo.make`` and the design expansion;
- ``eta_w_z``: each IRLS step's linear predictor, mu, W, z and deviance
  sum (the step's wall less its Gram);
- ``gram``: the Gram kernel (``gram_accumulate``);
- ``host_solve``: the P x P solve on the host (ADMM or coordinate descent);
- ``dev_probe``: the deviance probe after each solve;
- ``score``, ``metrics``: training predictions and metrics; ``other``: the
  rest (the Gram's copy to the host, intercept and null deviance).

Each phase is timed on the host clock between two ``torch.cuda.synchronize``
calls, so a phase's device work is charged to it. The synchronisations add
a little to the wall (about 60 per tree), which is why the timed run's
``train_s`` is printed beside the plain ``train_s`` of a run without them.
Then one tree (one GLM fit; one DRF iteration, a tree per class) under
``torch.profiler`` gives the device time by kernel name (top 12) and the
device's busy share of its wall.
Imports nothing of JAX or of ``h2o_tpu``.
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


def _timed(fn, T, phase):
    """``fn`` between two synchronisations, its wall added to ``T[phase]``."""
    import torch

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        T[phase] += time.perf_counter() - t0
        return out

    return timed


def _wrap(owner, name, T, phase, static=False):
    timed = _timed(getattr(owner, name), T, phase)
    setattr(owner, name, staticmethod(timed) if static else timed)


def _glm_timers(T):
    """Wrap the phases of the GLM build in synchronised host timers; the
    IRLS step's own wall goes to ``eta_w_z`` less its Gram."""
    from h2o_tpu_torch.models import datainfo, glm, model_base

    _wrap(model_base.ModelBuilder, "feature_names", T, "features")
    _wrap(datainfo.DataInfo, "make", T, "expand", static=True)
    _wrap(datainfo.DataInfo, "expand", T, "expand")
    _wrap(glm, "gram_accumulate", T, "gram")
    _wrap(glm, "_admm_solve", T, "host_solve")
    _wrap(glm, "_cod_solve", T, "host_solve")
    _wrap(glm.GLMModel, "score0", T, "score")
    _wrap(glm, "make_metrics", T, "metrics")
    make_step, make_dev = glm._make_irls_kernel, glm._make_dev_kernel
    glm._make_irls_kernel = lambda fam: _timed(make_step(fam), T, "step")
    glm._make_dev_kernel = lambda fam: _timed(make_dev(fam), T, "dev_probe")


def _timers(T, oob=False):
    """Wrap the phases of the build in synchronised host timers."""
    from h2o_tpu_torch.frame import chunks
    from h2o_tpu_torch.models import gbm, model_base
    from h2o_tpu_torch.models.tree import engine
    from h2o_tpu_torch.utils import threefry

    _wrap(model_base.ModelBuilder, "feature_names", T, "features")
    _wrap(gbm, "compute_bin_edges_cols", T, "edges")
    _wrap(chunks.BinnedView, "build", T, "binned_view", static=True)
    _wrap(engine, "_build_level_hist", T, "hist")
    _wrap(engine, "_find_splits", T, "splits")
    _wrap(engine, "_route_all", T, "route")
    _wrap(engine, "_node_totals", T, "leaf_totals")
    _wrap(threefry, "uniform", T, "sampling")
    # a row-sampled DRF scores out of bag: make_metrics runs inside
    _wrap(gbm, "_oob_metrics" if oob else "make_metrics", T, "metrics")


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("shape", nargs="?", default="airlines",
                    choices=("airlines", "higgs", "glm", "covtype",
                             "xgboost"))
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--trees", type=int, default=None,
                    help="10 (GBM), 50 (covtype DRF, xgboost)")
    ap.add_argument("--solver", default="IRLSM")
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
    covtype = args.shape == "covtype"
    xgb = args.shape == "xgboost"
    args.trees = args.trees or (50 if covtype or xgb else 10)
    if args.shape == "airlines":
        rows = args.rows or cs.AIRLINES_ROWS
        fr, response = cs._airlines_frame(rows, dev), "IsDepDelayed"
    elif covtype:
        rows = args.rows or cs.COVTYPE_ROWS
        fr, response = cs._covtype_frame(rows, dev), "Cover_Type"
    else:                                       # higgs, glm, xgboost
        rows = args.rows or cs.HIGGS_ROWS
        fr, response = cs._higgs_frame(rows, dev), "response"

    glm = args.shape == "glm"

    def fit(ntrees):
        if glm:
            return cs._glm(fr, solver=args.solver)
        if covtype:
            return cs._drf(fr, ntrees)
        if xgb:
            return cs._xgboost(fr, ntrees=ntrees, score_tree_interval=5,
                               stopping_rounds=2, stopping_tolerance=1e-3)
        return cs._gbm(fr, ntrees, response=response)

    def train():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = fit(args.trees)
        return model, time.perf_counter() - t0

    train()                                     # warm-up: build, allocator
    _, plain_s = train()
    T = collections.defaultdict(float)
    if glm:
        _glm_timers(T)
    else:
        _timers(T, oob=covtype)
    model, timed_s = train()
    if glm:
        T["eta_w_z"] = T.pop("step") - T["gram"]
    phases = dict(T, other=timed_s - sum(T.values()))
    extra = (dict(solver=args.solver, iterations=model.output.scoring_history[
        -1]["iterations"]) if glm else dict(ntrees=args.trees,
                                            trees_built=model.ntrees))
    m = model.output.training_metrics
    quality = (dict(oob_logloss=m.logloss,
                    mean_per_class_error=m.mean_per_class_error)
               if covtype else dict(auc=m.auc))
    print("phases", json.dumps(dict(
        shape=args.shape, rows=rows, **extra, train_s=plain_s,
        timed_train_s=timed_s, **quality, phase_s=phases)), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(1)
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
        **({} if glm else dict(ntrees=1)), wall_s=wall,
        device_busy_s=busy / 1e6,
        top_device_ms=[[k, ms, n] for k, ms, n in rows_k[:12]])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
