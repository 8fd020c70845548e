#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``h2o_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``h2o_tpu_torch/csrc``, then drives two
paths: the flagship numeric GBM (HIGGS-shaped, flat histogram plan) and the
airlines-shaped categorical GBM (grouped plan, set splits). In order:

1. ``level_hist``: holds the kernel, through its flat wrapper, against its
   plain PyTorch version at the HIGGS shapes (11,001,856 padded rows, 28
   int8 features, V = 3) for every level width of a depth-5 tree (n_lv = 1,
   2, 4, 8, 16): the integer-valued weight channel must match exactly, the
   real channels within 1e-4 of each cell's absolute mass, and two launches
   must be bit-identical; times the kernel, the plain version, one
   ``index_add_`` call on precomputed keys (a yardstick the port never
   calls) and the memory-traffic bound;
2. ``train``: trains the flagship GBM end to end — bernoulli, 11M x 28
   HIGGS-shaped rows from the benchmark's generator, depth 5, 20 bins,
   learn rate 0.1, seed 42, 10 trees scored once — and requires 50 flat
   launches (ntrees x max_depth), no grouped launch and a finite training
   AUC above 0.6;
3. ``card_vs_cpu``: the same GBM on 1M rows x 5 trees on the card and on
   the CPU: equal forest structure (split features, NA directions, split
   bins), leaf values and predictions within 1e-5;
4. ``level_hist_grouped``: the same checks and timings for the kernel
   through its grouped wrapper at the airlines plan (9 int16 features in
   width buckets 32/16/8/301, 5% NA) at 11,001,856 rows and at the airlines
   train's 116,006,912 padded rows, whose numbers the kernel line reports;
   the weight channel must equal the exact int64 count, and the plain
   version wherever that count is below 2^24 (above it float32 sums stop
   counting exactly); plus one wide case (a 1025-bin bucket at n_lv = 16)
   that needs the node-range tiling;
5. ``airlines_train``: the airlines-shaped GBM end to end — 116M rows from
   the benchmark's airlines generator (seven categoricals, Origin/Dest at
   300 levels, two numerics), depth 5, nbins 20, nbins_cats 1024, learn
   rate 0.1, seed 42, 10 trees — requiring 50 grouped launches, no flat
   launch, a finite training AUC above 0.6, at least one set split and
   finite predictions;
6. ``airlines_card_vs_cpu``: that GBM on 1M rows x 5 trees on the card and
   on the CPU: equal split features, NA directions, set-split tables and
   split bins, leaf values and predictions within 1e-5.

It prints the card's name and power limit, one JSON line of per-kernel
numbers, and last ``{"ok": true, "device": {...}}``. Any failed phase
raises and exits non-zero without that line; so does a machine without a
CUDA GPU. Imports nothing of JAX or of ``h2o_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HIGGS_ROWS = 11_000_000
HIGGS_F = 28
AIRLINES_ROWS = 116_000_000     # bench.py's airlines default (knobs.py:415)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
REAL_TOL = 1e-4                # real channels: |kernel - plain| <= this x cell |mass|
CPU_TOL = 1e-5                 # card vs CPU: leaf values and predictions


def _higgs_cols(nrow: int, seed: int = 42):
    """The benchmark's HIGGS-shaped generator (``bench.py:_higgs_frame``):
    28 normal features, every third mixed with a latent factor, and a
    binary response through a logistic link."""
    rng = np.random.default_rng(seed)
    cols = {}
    latent = rng.normal(size=nrow).astype(np.float32)
    for j in range(HIGGS_F):
        mix = 0.3 if j % 3 == 0 else 0.0
        cols[f"f{j}"] = (rng.normal(size=nrow).astype(np.float32)
                         + mix * latent).astype(np.float32)
    logits = latent + 0.5 * cols["f0"] - 0.25 * cols["f3"]
    y = (rng.random(nrow) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return cols, y


def _higgs_frame(nrow: int, device):
    from h2o_tpu_torch import Frame, Vec
    from h2o_tpu_torch.frame.vec import T_CAT

    cols, y = _higgs_cols(nrow)
    fr = Frame.from_dict(cols, device=device)
    fr.add("response", Vec.from_numpy(y, type=T_CAT, domain=["b", "s"],
                                      device=device))
    return fr


def _airlines_cols(nrow: int, seed: int = 116):
    """The benchmark's airlines generator (``bench.py:_airlines_frame``):
    hub-skewed Origin/Dest over 300 airports, 22 carriers, calendar
    columns, departure time and distance, and a response wired through
    per-level effects. Returns (name -> (values, domain or None)) and y."""
    rng = np.random.default_rng(seed)
    n_air, n_car = 300, 22
    p_air = 1.0 / (np.arange(n_air) + 5.0)
    p_air /= p_air.sum()
    origin = rng.choice(n_air, size=nrow, p=p_air).astype(np.int16)
    dest = rng.choice(n_air, size=nrow, p=p_air).astype(np.int16)
    carrier = rng.integers(0, n_car, nrow).astype(np.int8)
    year = rng.integers(0, 22, nrow).astype(np.int8)
    month = rng.integers(0, 12, nrow).astype(np.int8)
    dom = rng.integers(0, 31, nrow).astype(np.int8)
    dow = rng.integers(0, 7, nrow).astype(np.int8)
    deptime = (rng.integers(5, 24, nrow) * 100
               + rng.integers(0, 60, nrow)).astype(np.float32)
    dist = np.exp(rng.normal(6.5, 0.8, nrow)).astype(np.float32)
    air_eff = rng.normal(0, 0.6, n_air)
    car_eff = rng.normal(0, 0.4, n_car)
    mon_eff = rng.normal(0, 0.3, 12)
    logit = (air_eff[origin] + 0.7 * air_eff[dest] + car_eff[carrier]
             + mon_eff[month] + 0.6 * np.sin(deptime / 2400 * 2 * np.pi)
             + 0.2 * (dist / 1000.0) - 0.4)
    y = (rng.random(nrow) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    airports = [f"A{i:03d}" for i in range(n_air)]
    cols = {"Year": (year, [str(1987 + i) for i in range(22)]),
            "Month": (month, [str(i + 1) for i in range(12)]),
            "DayofMonth": (dom, [str(i + 1) for i in range(31)]),
            "DayOfWeek": (dow, [str(i + 1) for i in range(7)]),
            "UniqueCarrier": (carrier, [f"C{i:02d}" for i in range(n_car)]),
            "Origin": (origin, airports), "Dest": (dest, airports),
            "CRSDepTime": (deptime, None), "Distance": (dist, None)}
    return cols, y


def _airlines_frame(nrow: int, device):
    from h2o_tpu_torch import Frame, Vec
    from h2o_tpu_torch.frame.vec import T_CAT

    cols, y = _airlines_cols(nrow)
    fr = Frame()
    for name, (vals, dom) in cols.items():
        fr.add(name, Vec.from_numpy(vals, type=T_CAT if dom else None,
                                    domain=dom, device=device))
    fr.add("IsDepDelayed", Vec.from_numpy(y, type=T_CAT, domain=["NO", "YES"],
                                          device=device))
    return fr


def _gbm(fr, ntrees: int, response: str = "response"):
    from h2o_tpu_torch import GBM, GBMParameters

    return GBM(GBMParameters(training_frame=fr, response_column=response,
                             ntrees=ntrees, max_depth=5, nbins=20,
                             nbins_cats=1024, learn_rate=0.1,
                             seed=42)).train_model()


def _cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def phase_kernel(dev) -> dict:
    """The kernel through its flat wrapper against its plain version at
    HIGGS shapes."""
    import torch

    from h2o_tpu_torch.backend.kernels import hist
    from h2o_tpu_torch.parallel.mesh import padded_len

    rl, F, V, B = padded_len(HIGGS_ROWS), HIGGS_F, 3, 21
    g = torch.Generator(device=dev).manual_seed(42)
    codes = torch.randint(0, B - 1, (rl, F), generator=g, device=dev,
                          dtype=torch.int8)
    codes[torch.rand((rl, F), generator=g, device=dev) < 0.05] = B - 1  # NA
    vv = torch.randn((rl, V), generator=g, device=dev)
    vv[:, 0] = torch.randint(0, 4, (rl,), generator=g, device=dev).float()
    per_level = []
    for n_lv in (1, 2, 4, 8, 16):
        lc = torch.randint(0, n_lv, (rl,), generator=g, device=dev,
                           dtype=torch.int32)
        k1 = hist._cuda_flat(codes, lc, vv, n_lv, B)
        k2 = hist._cuda_flat(codes, lc, vv, n_lv, B)
        plain = hist._torch_flat(codes, lc, vv, n_lv, B, 8192)
        mass = hist._torch_flat(codes, lc, vv.abs(), n_lv, B, 8192)
        torch.cuda.synchronize()
        _check(torch.equal(k1, k2), f"n_lv={n_lv}: two launches differ")
        _check(torch.equal(k1[..., 0], plain[..., 0]),
               f"n_lv={n_lv}: integer channel differs from the plain version")
        err = (k1 - plain).abs()
        rel = float((err / (mass + 1e-30)).max())
        _check(rel <= REAL_TOL, f"n_lv={n_lv}: real channels off by {rel:.3g} "
                                f"of the cell mass (limit {REAL_TOL})")
        # yardstick: one index_add_ over precomputed flat keys
        f_idx = torch.arange(F, device=dev)[None, :]
        keys = (((f_idx * n_lv + lc[:, None].long()) * B + codes.long())
                .reshape(-1))
        src = vv[:, None, :].expand(rl, F, V).reshape(-1, V)
        lib = torch.zeros((F * n_lv * B, V), device=dev)
        kernel_ms = _cuda_ms(lambda: hist._cuda_flat(codes, lc, vv, n_lv, B), 20)
        plain_ms = _cuda_ms(lambda: hist._torch_flat(codes, lc, vv, n_lv, B,
                                                     8192), 2)
        library_ms = _cuda_ms(lambda: lib.zero_().index_add_(0, keys, src), 5)
        del keys, src, lib
        nbytes = rl * F * codes.element_size() + rl * 4 + rl * V * 4 \
            + F * n_lv * B * V * 4
        bound_ms = max(nbytes / HBM_BYTES_PER_S, rl * F * V / F32_OPS_PER_S) * 1e3
        row = dict(n_lv=n_lv, max_abs_err=float(err.max()), max_rel_mass=rel,
                   ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms)
        print("level_hist", json.dumps(row), flush=True)
        per_level.append(row)
    return {k: (max(r[k] for r in per_level) if k == "max_abs_err"
                else sum(r[k] for r in per_level))
            for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                      "bound_ms")}


def phase_train(dev) -> int:
    """The flagship GBM end to end; returns the kernel launches it made."""
    import torch

    from h2o_tpu_torch.backend.kernels import hist

    t0 = time.perf_counter()
    fr = _higgs_frame(HIGGS_ROWS, dev)
    print(f"higgs frame {HIGGS_ROWS}x{HIGGS_F}: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    hist.LAUNCHES = hist.GROUPED_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _gbm(fr, ntrees=10)     # train_model synchronises the card
    train_s = time.perf_counter() - t0
    launches, grouped = hist.LAUNCHES, hist.GROUPED_LAUNCHES
    m = model.output.training_metrics
    t0 = time.perf_counter()
    pred = model.predict(fr)
    p1 = pred.vec("ps").data[:fr.nrow]
    finite = bool(torch.isfinite(p1).all())
    predict_s = time.perf_counter() - t0
    print("train", json.dumps(dict(
        rows=HIGGS_ROWS, ntrees=10, train_s=train_s, predict_s=predict_s,
        auc=m.auc, logloss=m.logloss, kernel_launches=launches,
        grouped_launches=grouped,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)),
        flush=True)
    _check(launches == 10 * 5 and grouped == 0,
           f"{launches} flat and {grouped} grouped launches, want 50 and 0")
    _check(bool(np.isfinite(m.auc)) and m.auc > 0.6, f"AUC {m.auc}")
    _check(finite and p1.shape == (HIGGS_ROWS,), "predictions not finite")
    return launches


def _split_bins(model) -> np.ndarray:
    """Each split node's cut as a bin index into the model's own edges."""
    feat = model.forest["feat"].cpu().numpy()
    thr = model.forest["thr"].cpu().numpy()
    e = model.edges[np.clip(feat, 0, None)]
    with np.errstate(invalid="ignore"):
        bins = np.sum(e < thr[..., None], axis=-1)
    return np.where(feat >= 0, bins, -1)


def phase_card_vs_cpu(dev) -> None:
    """The HIGGS GBM on 1M rows x 5 trees, on the card and on the CPU."""
    import torch

    rows, ntrees = 1_000_000, 5
    models, preds = {}, {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        fr = _higgs_frame(rows, d)
        models[d] = _gbm(fr, ntrees)
        preds[d] = models[d].predict(fr).vec("ps").data[:rows].cpu().numpy()
        print(f"card_vs_cpu {d}: {time.perf_counter() - t0:.3f} s", flush=True)
    a, b = models[dev], models["cpu"]
    for k in ("feat", "nanL"):
        _check(torch.equal(a.forest[k].cpu(), b.forest[k]),
               f"1M rows: {k} differs between card and CPU")
    _check(np.array_equal(_split_bins(a), _split_bins(b)),
           "1M rows: split bins differ between card and CPU")
    edge_ulps = int(np.nanmax(np.abs(a.edges.view(np.int32).astype(np.int64)
                                     - b.edges.view(np.int32).astype(np.int64))))
    val_err = float((a.forest["val"].cpu() - b.forest["val"]).abs().max())
    pred_err = float(np.abs(preds[dev] - preds["cpu"]).max())
    print("card_vs_cpu", json.dumps(dict(
        rows=rows, ntrees=ntrees, edge_max_ulps=edge_ulps,
        leaf_max_abs_err=val_err, pred_max_abs_err=pred_err,
        auc_card=a.output.training_metrics.auc,
        auc_cpu=b.output.training_metrics.auc)), flush=True)
    _check(val_err <= CPU_TOL and pred_err <= CPU_TOL,
           f"1M rows: leaf values off by {val_err}, predictions by {pred_err}")


def _airlines_plan_inputs(dev, rl: int, widths, B: int, n_lv: int, g):
    """int16 codes with each feature's data bins 0..w-1 and 5% NA (code
    B-1), node ids, and [weight, g, h]-like channels with integer weights."""
    import torch

    codes = torch.stack([torch.randint(0, w, (rl,), generator=g, device=dev,
                                       dtype=torch.int16) for w in widths], 1)
    codes[torch.rand(codes.shape, generator=g, device=dev) < 0.05] = B - 1
    lc = torch.randint(0, n_lv, (rl,), generator=g, device=dev,
                       dtype=torch.int32)
    vv = torch.randn((rl, 3), generator=g, device=dev)
    vv[:, 0] = torch.randint(0, 4, (rl,), generator=g, device=dev).float()
    return codes.contiguous(), lc, vv


def _grouped_level(dev, codes, lc, vv, groups, n_lv: int, B: int,
                   reps: int) -> dict:
    """One grouped level: kernel vs plain checks and the four timings.

    The integer channel is held against the exact per-cell count (int64
    ``index_add_``, rounded once to float32) and against the plain version
    wherever that count is below 2^24: above it the plain version's float32
    running sums no longer count exactly (at 116M rows, n_lv = 1, each
    7-level DayOfWeek bin weighs ~2.4e7), while the kernel's 64-bit fixed
    point does."""
    import torch

    from h2o_tpu_torch.backend.kernels import hist

    rl, F = codes.shape
    V = vv.shape[1]
    xgs = [codes[:, list(idxs)] for idxs, _Bg, _mode in groups]
    # each row's cell per feature in the packed output, NA remapped to its
    # group's last slot: keys of the exact count and the index_add_ yardstick
    keys, n_cells = [], 0
    for (idxs, Bg, _m), xg in zip(groups, xgs):
        c = xg.long()
        c = torch.where(c == B - 1, Bg - 1, c)
        slot = torch.arange(len(idxs), device=dev)[None, :]
        keys.append(n_cells + (slot * n_lv + lc[:, None].long()) * Bg + c)
        n_cells += len(idxs) * n_lv * Bg
    keys = torch.cat(keys, 1).reshape(-1)
    exact = torch.zeros(n_cells, dtype=torch.int64, device=dev).index_add_(
        0, keys, vv[:, 0].long()[:, None].expand(rl, F).reshape(-1))
    k1 = hist._cuda_grouped(codes, lc, vv, groups, n_lv, B - 1)
    k2 = hist._cuda_grouped(codes, lc, vv, groups, n_lv, B - 1)
    # the plain version is timed on its checking call: at 116M rows one
    # call takes seconds, so it runs once
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    plain = hist._torch_grouped(xgs, lc, vv, groups, n_lv, B - 1, 8192)
    stop.record()
    mass = hist._torch_grouped(xgs, lc, vv.abs(), groups, n_lv, B - 1, 8192)
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    k0 = torch.cat([a[..., 0].reshape(-1) for a in k1])
    p0 = torch.cat([p[..., 0].reshape(-1) for p in plain])
    _check(torch.equal(k0, exact.float()),
           f"grouped n_lv={n_lv}: integer channel differs from the exact count")
    below = exact < 2 ** 24
    _check(torch.equal(k0[below], p0[below]),
           f"grouped n_lv={n_lv}: integer channel differs from the plain "
           f"version where its float32 sums are exact")
    err, rel = 0.0, 0.0
    for (idxs, Bg, _m), a, b, p, m in zip(groups, k1, k2, plain, mass):
        _check(torch.equal(a, b), f"grouped n_lv={n_lv} Bg={Bg}: two "
                                  f"launches differ")
        d = (a - p).abs()
        err = max(err, float(d.max()))
        rel = max(rel, float((d[..., 1:] / (m[..., 1:] + 1e-30)).max()))
    _check(rel <= REAL_TOL, f"grouped n_lv={n_lv}: real channels off by "
                            f"{rel:.3g} of the cell mass (limit {REAL_TOL})")
    over = int((~below).sum())
    del plain, mass, exact
    # yardstick: one index_add_ over the keys into the same packed output
    src = vv[:, None, :].expand(rl, F, V).reshape(-1, V)
    lib = torch.zeros((n_cells, V), device=dev)
    kernel_ms = _cuda_ms(lambda: hist._cuda_grouped(codes, lc, vv, groups,
                                                    n_lv, B - 1), reps)
    library_ms = _cuda_ms(lambda: lib.zero_().index_add_(0, keys, src), 3)
    del keys, src, lib
    nbytes = (rl * F * codes.element_size() + rl * 4 + rl * V * 4
              + n_cells * V * 4)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, rl * F * V / F32_OPS_PER_S) * 1e3
    return dict(rows=rl, n_lv=n_lv, max_abs_err=err, max_rel_mass=rel,
                cells_over_2_24=over, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms)


def phase_grouped_kernel(dev) -> dict:
    """The grouped wrapper against its plain version at the airlines plan
    (the widths `plan_hist_groups` gives the airlines frame), every level
    width of a depth-5 tree, at 11,001,856 rows and at the airlines train's
    own 116,006,912; then one 1025-wide bucket at n_lv = 16. Returns the
    per-tree sums at the train's row count."""
    import torch

    from h2o_tpu_torch.parallel.mesh import padded_len

    B = 301
    groups = (((0, 2, 4, 7, 8), 32, "onehot"), ((1,), 16, "onehot"),
              ((3,), 8, "segsum"), ((5, 6), 301, "onehot"))
    # data bins per feature: Year 22, Month 12, DayofMonth 31, DayOfWeek 7,
    # UniqueCarrier 22, Origin/Dest 300, CRSDepTime/Distance 20
    widths = (22, 12, 31, 7, 22, 300, 300, 20, 20)
    g = torch.Generator(device=dev).manual_seed(116)
    for rl in (padded_len(HIGGS_ROWS), padded_len(AIRLINES_ROWS)):
        per_level = []
        for n_lv in (1, 2, 4, 8, 16):
            codes, lc, vv = _airlines_plan_inputs(dev, rl, widths, B, n_lv, g)
            row = _grouped_level(dev, codes, lc, vv, groups, n_lv, B, 20)
            print("level_hist_grouped", json.dumps(row), flush=True)
            per_level.append(row)
            del codes, lc, vv
        torch.cuda.empty_cache()
    # wide case: a 1025-bin bucket needs 16 x 1025 x 3 x 8 = 393 KB at
    # n_lv = 16, so the plan cuts it into node ranges
    Bw, rw = 1025, 2 ** 21
    wide_groups = (((0, 2), 32, "onehot"), ((1, 3), 1025, "onehot"))
    codes, lc, vv = _airlines_plan_inputs(dev, rw, (30, 1023, 30, 1023), Bw,
                                          16, g)
    row = _grouped_level(dev, codes, lc, vv, wide_groups, 16, Bw, 5)
    print("level_hist_grouped_wide", json.dumps(dict(row, B=Bw)), flush=True)
    out = {k: (max(r[k] for r in per_level) if k == "max_abs_err"
               else sum(r[k] for r in per_level))
           for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                     "bound_ms")}
    out["max_abs_err"] = max(out["max_abs_err"], row["max_abs_err"])
    return out


def _set_split_nodes(model) -> int:
    feat = model.forest["feat"].cpu().numpy()
    return int(((feat >= 0) & model.is_cat[np.clip(feat, 0, None)]).sum())


def phase_airlines_train(dev) -> int:
    """The airlines-shaped GBM end to end; returns its grouped launches."""
    import torch

    from h2o_tpu_torch.backend.kernels import hist

    t0 = time.perf_counter()
    fr = _airlines_frame(AIRLINES_ROWS, dev)
    print(f"airlines frame {AIRLINES_ROWS}x9: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    hist.LAUNCHES = hist.GROUPED_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _gbm(fr, ntrees=10, response="IsDepDelayed")
    train_s = time.perf_counter() - t0
    launches, flat = hist.GROUPED_LAUNCHES, hist.LAUNCHES
    m = model.output.training_metrics
    t0 = time.perf_counter()
    pred = model.predict(fr)
    p1 = pred.vec("pYES").data[:fr.nrow]
    finite = bool(torch.isfinite(p1).all())
    predict_s = time.perf_counter() - t0
    sets = _set_split_nodes(model)
    print("airlines_train", json.dumps(dict(
        rows=AIRLINES_ROWS, ntrees=10, train_s=train_s, predict_s=predict_s,
        auc=m.auc, logloss=m.logloss, grouped_launches=launches,
        flat_launches=flat, set_split_nodes=sets,
        hist_groups=[[list(i), w, md] for i, w, md in model.cfg.hist_groups],
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)),
        flush=True)
    _check(launches == 10 * 5 and flat == 0,
           f"{launches} grouped and {flat} flat launches, want 50 and 0")
    _check(bool(np.isfinite(m.auc)) and m.auc > 0.6, f"airlines AUC {m.auc}")
    _check(sets >= 1, "no set-split node in the airlines forest")
    _check(finite and p1.shape == (AIRLINES_ROWS,),
           "airlines predictions not finite")
    return launches


def phase_airlines_card_vs_cpu(dev) -> None:
    """The airlines GBM on 1M rows x 5 trees, on the card and on the CPU."""
    import torch

    rows, ntrees = 1_000_000, 5
    models, preds = {}, {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        fr = _airlines_frame(rows, d)
        models[d] = _gbm(fr, ntrees, response="IsDepDelayed")
        preds[d] = models[d].predict(fr).vec("pYES").data[:rows].cpu().numpy()
        print(f"airlines_card_vs_cpu {d}: {time.perf_counter() - t0:.3f} s",
              flush=True)
    a, b = models[dev], models["cpu"]
    for k in ("feat", "nanL", "catd"):
        _check(torch.equal(a.forest[k].cpu(), b.forest[k]),
               f"airlines 1M rows: {k} differs between card and CPU")
    _check(np.array_equal(_split_bins(a), _split_bins(b)),
           "airlines 1M rows: split bins differ between card and CPU")
    val_err = float((a.forest["val"].cpu() - b.forest["val"]).abs().max())
    pred_err = float(np.abs(preds[dev] - preds["cpu"]).max())
    print("airlines_card_vs_cpu", json.dumps(dict(
        rows=rows, ntrees=ntrees, set_split_nodes=_set_split_nodes(a),
        leaf_max_abs_err=val_err, pred_max_abs_err=pred_err,
        auc_card=a.output.training_metrics.auc,
        auc_cpu=b.output.training_metrics.auc)), flush=True)
    _check(_set_split_nodes(a) >= 1, "airlines 1M rows: no set split")
    _check(val_err <= CPU_TOL and pred_err <= CPU_TOL,
           f"airlines 1M rows: leaf values off by {val_err}, predictions by "
           f"{pred_err}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from h2o_tpu_torch.backend import kernels

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version: full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s", flush=True)
    for line in kernels.BUILD_LOG.splitlines():
        if "registers" in line or "smem" in line:
            print("ptxas", line.strip(), flush=True)

    phases = {}

    def run(name, fn):
        t0 = time.perf_counter()
        out = fn(dev)
        phases[name] = time.perf_counter() - t0
        return out

    flat = run("level_hist", phase_kernel)
    launches = run("train", phase_train)
    run("card_vs_cpu", phase_card_vs_cpu)
    grouped = run("level_hist_grouped", phase_grouped_kernel)
    grouped_launches = run("airlines_train", phase_airlines_train)
    run("airlines_card_vs_cpu", phase_airlines_card_vs_cpu)
    print("phase_s", json.dumps(phases), flush=True)
    src = "h2o_tpu_torch/csrc/level_hist.cu"
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=replaces,
             launches=n, max_abs_err=nums["max_abs_err"], ms=nums["ms"],
             plain_ms=nums["plain_ms"], bound_ms=nums["bound_ms"],
             bound_by="bytes", library_ms=nums["library_ms"])
        for name, replaces, n, nums in (
            ("level_hist", "h2o_tpu/backend/kernels/hist.py:158", launches,
             flat),
            ("level_hist_grouped", "h2o_tpu/backend/kernels/hist.py:181",
             grouped_launches, grouped))]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
