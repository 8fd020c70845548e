"""Grid search — hyperparameter space walking (``h2o_tpu/models/grid.py``).

Analog of `hex/grid/`: `HyperSpaceWalker`'s Cartesian and RandomDiscrete
strategies with max_models / max_runtime_secs / early-stopping search
criteria (`hex/grid/HyperSpaceWalker.java:409,511`), and the keyed ``Grid``
of trained models ranked by a sort metric. RandomDiscrete visits the
Cartesian combos in the order of numpy's ``default_rng(seed).permutation``,
the reference's, so both packages walk the same combos in the same order.

Builds run one after another by default; ``parallelism > 1`` runs them on
a thread pool (the `ParallelModelBuilder` role). On the card every worker
thread makes the training frame's card its current device, as
``backend/jobs.py`` does, and the kernels' launch counters are guarded by
a lock; the card's one stream serialises the device work, so the gain is
the host-side overlap.

Re-training under an existing ``grid_id`` appends only combos whose full
parameters the grid has not trained yet. A failed combo is recorded in
``Grid.failures`` and the walk goes on. ``recovery_dir`` writes every
trained model and a manifest through ``backend/persist.py``; after a crash
``GridSearch.resume`` reloads them and skips their combos
(`hex/faulttolerance/Recovery.java`). ``export_grid``/``import_grid``
write and read a grid's models and manifest. The reference dispatches the
search through its workload manager; the port runs it as a plain ``Job``,
and a ``priority`` other than the default ``"batch"`` is refused until the
workload tier is ported (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import importlib
import itertools
import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..backend.jobs import Job
from ..backend.kvstore import STORE, Keyed
from ..frame.frame import Frame

DEFAULT_PRIORITY = "batch"
_WORKLOAD_TODO = "ROADMAP Queue 1 item 14"


def check_priority(priority: str, what: str) -> None:
    """The workload tier's lanes are not ported: the default priority runs
    as a plain job, any other raises."""
    if priority != DEFAULT_PRIORITY:
        raise NotImplementedError(
            f"{what}: priority {priority!r} needs the workload manager, "
            f"which is not ported yet ({_WORKLOAD_TODO}); the default "
            f"{DEFAULT_PRIORITY!r} runs as a plain job")


@dataclass
class SearchCriteria:
    """`HyperSpaceSearchCriteria`: Cartesian or RandomDiscrete."""

    strategy: str = "Cartesian"  # Cartesian | RandomDiscrete
    max_models: int = 0
    max_runtime_secs: float = 0.0
    seed: int = -1
    stopping_rounds: int = 0
    stopping_metric: str = "AUTO"
    stopping_tolerance: float = 1e-3


def _metrics_of(m):
    o = m.output
    return (o.cross_validation_metrics or o.validation_metrics
            or o.training_metrics)


class Grid(Keyed):
    """Keyed container of trained models — `hex/grid/Grid.java`."""

    def __init__(self, builder_cls, hyper_params, key=None):
        super().__init__(key=key, prefix="grid")
        self.builder_cls = builder_cls
        self.hyper_params = hyper_params
        self.models: list = []
        self.failures: list = []
        # full-params signatures of every trained combo, taken before
        # training (a builder may swap params in place): the retrain
        # dedup ledger
        self.trained_param_keys: set = set()
        STORE.put_keyed(self)

    def sorted_models(self, by: str | None = None,
                      decreasing: bool | None = None):
        """Models ranked by a metric (default: by category)."""
        if not self.models:
            return []
        metric, decr = _sort_metric(self.models[0], by, decreasing)

        def val(m):
            v = getattr(_metrics_of(m), metric, np.nan)
            return -np.inf if v is None or np.isnan(v) else v

        return sorted(self.models, key=val, reverse=decr)

    @property
    def model_count(self):
        return len(self.models)

    def summary_table(self, by: str | None = None):
        """Grid summary as a TwoDimTable (`Grid.createSummaryTable`)."""
        from ..utils.twodimtable import TwoDimTable

        rows = self.summary(by)
        if not rows:
            return TwoDimTable(table_header="Grid Summary")
        cols = {k: [r.get(k) for r in rows] for k in rows[0]}
        return TwoDimTable.from_dict("Grid Summary", cols)

    def summary(self, by: str | None = None):
        ms = self.sorted_models(by)
        metric, _ = _sort_metric(ms[0], by, None) if ms else ("mse", False)
        return [{"model": m.key,
                 **{k: getattr(m.params, k) for k in self.hyper_params},
                 metric: getattr(_metrics_of(m), metric, None)} for m in ms]


def _sort_metric(model, by, decreasing):
    if by:
        return by, (decreasing if decreasing is not None
                    else by.lower() in ("auc", "aucpr", "r2", "accuracy"))
    cat = model.output.model_category
    if cat == "Binomial":
        return "auc", True
    if cat == "Multinomial":
        return "logloss", False
    return "mse", False


class GridSearch:
    """`water/api/GridSearchHandler` + HyperSpaceWalker orchestration."""

    def __init__(self, builder_cls, params, hyper_params: dict,
                 search_criteria: SearchCriteria | None = None,
                 recovery_dir: str | None = None, parallelism: int = 1,
                 grid_id: str | None = None,
                 priority: str = DEFAULT_PRIORITY):
        check_priority(priority, "grid search")
        self.builder_cls = builder_cls
        self.base_params = params
        self.hyper_params = {k: list(v) for k, v in hyper_params.items()}
        self.criteria = search_criteria or SearchCriteria()
        self.recovery_dir = recovery_dir
        self.parallelism = max(1, int(parallelism))
        self.grid_id = grid_id
        self.priority = priority
        self._recovered_models: list = []
        self._recovered_done: list = []

    def _walk(self):
        names = list(self.hyper_params)
        combos = list(itertools.product(*(self.hyper_params[n]
                                          for n in names)))
        if self.criteria.strategy.lower() == "randomdiscrete":
            rng = np.random.default_rng(
                None if self.criteria.seed in (-1, None)
                else self.criteria.seed)
            order = rng.permutation(len(combos))
            combos = [combos[i] for i in order]
        for combo in combos:
            yield dict(zip(names, combo))

    def train(self, background: bool = False) -> "Grid | Job":
        # re-training an existing grid_id appends to it (a grid
        # accumulates models across train calls and after import_grid)
        existing = STORE.get(self.grid_id) if self.grid_id else None
        if isinstance(existing, Grid):
            grid = existing
            grid.hyper_params = sorted(set(grid.hyper_params)
                                       | set(self.hyper_params))
        else:
            grid = Grid(self.builder_cls, list(self.hyper_params),
                        key=self.grid_id)
        # combos already in the grid (an earlier train on this grid_id, or
        # crash-recovered models) are skipped, and the budget counts only
        # this search's models; the dedup keys cover the full effective
        # params, so other base params or dimensions make new models
        prior = set(grid.trained_param_keys)
        prior |= {_full_params_key(m.params) for m in grid.models}
        grid.models.extend(self._recovered_models)
        job = Job(f"grid {self.builder_cls.algo_name}", work=1.0)
        job.dest_key = grid.key
        rec = self._init_recovery() if self.recovery_dir else None
        done = list(self._recovered_done)
        built = {"n": len(self._recovered_models)}
        dev = self.base_params.training_frame.device

        def build_one(overrides):
            """(model or None, overrides, error or None, params key); the
            key is taken before training."""
            params = self.base_params.clone(**overrides)
            sig = _full_params_key(params)
            try:
                return (self.builder_cls(params).train_model(), overrides,
                        None, sig)
            except NotImplementedError:
                raise   # what the port has not ported stops the search
            except Exception as e:  # failed combos are data, not fatal
                return None, overrides, repr(e), sig

        def accept(m, overrides, err, sig):
            if m is not None:
                grid.models.append(m)
                grid.trained_param_keys.add(sig)
                built["n"] += 1
                if rec is not None:
                    self._record(rec, done, _combo_key(overrides), m,
                                 len(grid.models) - 1)
            elif err is not None:
                grid.failures.append({"params": overrides, "error": err})
            job.update(0.0)

        def skip(overrides) -> bool:
            if _combo_key(overrides) in self._recovered_done:
                return True
            return _full_params_key(
                self.base_params.clone(**overrides)) in prior

        def run():
            t0 = time.time()
            c = self.criteria
            scores = []
            if self.parallelism > 1 and c.stopping_rounds <= 0:
                # concurrent builds; early stopping needs the scores in
                # order, so it keeps the sequential walk
                combos = [o for o in self._walk() if not skip(o)]
                init = None
                if dev is not None and dev.type == "cuda":
                    def init():
                        torch.cuda.set_device(dev)
                with cf.ThreadPoolExecutor(max_workers=self.parallelism,
                                           initializer=init) as ex:
                    futs = [ex.submit(build_one, o) for o in combos]
                    try:
                        for fut in cf.as_completed(futs):
                            if (job.stop_requested
                                    or (c.max_models
                                        and built["n"] >= c.max_models)
                                    or (c.max_runtime_secs
                                        and time.time() - t0
                                        > c.max_runtime_secs)):
                                break
                            accept(*fut.result())
                    finally:
                        for f in futs:
                            f.cancel()     # pending combos only
                job.check_cancelled()
                return grid
            for overrides in self._walk():
                job.check_cancelled()
                if c.max_models and built["n"] >= c.max_models:
                    break
                if (c.max_runtime_secs
                        and time.time() - t0 > c.max_runtime_secs):
                    break
                if skip(overrides):
                    continue
                m, overrides, err, sig = build_one(overrides)
                accept(m, overrides, err, sig)
                if (m is not None and c.stopping_rounds > 0
                        and self._early_stop(grid, scores, c)):
                    break
            return grid

        job.start(run, background=background, device=dev)
        return job if background else job.join()

    # -- auto-recovery (`hex/faulttolerance/Recovery.java`) -------------------
    def _init_recovery(self):
        from ..backend.persist import Recovery, _dumps, save_frame

        rec = Recovery(self.recovery_dir)
        if rec.read() is None:
            p = self.base_params
            frame_fields = [f.name for f in dataclasses.fields(p)
                            if isinstance(getattr(p, f.name), Frame)]
            for fname in frame_fields:  # training, validation, blending, ...
                save_frame(getattr(p, fname), os.path.join(
                    self.recovery_dir, f"frame_{fname}.npz"))
            spec = {"builder_module": self.builder_cls.__module__,
                    "builder_name": self.builder_cls.__name__,
                    "hyper_params": _canon(self.hyper_params),
                    "criteria": dataclasses.asdict(self.criteria),
                    "frame_fields": frame_fields,
                    "done": [], "models": []}
            params = dataclasses.replace(p, **{f: None for f in frame_fields})
            with open(os.path.join(self.recovery_dir, "base_params.pkl"),
                      "wb") as fh:
                fh.write(_dumps(params))
            rec.write(spec)
        return rec

    def _record(self, rec, done, key, model, idx):
        from ..backend.persist import save_model

        save_model(model, rec.model_path(idx))
        done.append(key)
        manifest = rec.read()
        manifest["done"] = done
        manifest["models"] = manifest.get("models", []) + [rec.model_path(idx)]
        rec.write(manifest)

    @classmethod
    def resume(cls, recovery_dir: str, device=None) -> "GridSearch":
        """Rebuild a GridSearch from a recovery dir after a crash, frames
        and models on ``device`` (default ``cuda``): the trained models are
        reloaded and their combos skipped — the reference's grid
        auto-resume (`test_grid_auto_recover.py:50-62`)."""
        from ..backend.persist import Recovery, _loads, load_frame, load_model

        rec = Recovery(recovery_dir)
        manifest = rec.read()
        if manifest is None:
            raise ValueError(f"no recovery manifest in {recovery_dir}")
        builder_cls = _builder_class(manifest)
        with open(os.path.join(recovery_dir, "base_params.pkl"), "rb") as fh:
            params = _loads(fh, device)
        params = dataclasses.replace(params, **{
            fname: load_frame(os.path.join(recovery_dir,
                                           f"frame_{fname}.npz"),
                              device=device)
            for fname in manifest.get("frame_fields", ["training_frame"])})
        gs = cls(builder_cls, params, manifest["hyper_params"],
                 SearchCriteria(**manifest["criteria"]),
                 recovery_dir=recovery_dir)
        gs._recovered_done = list(manifest["done"])
        gs._recovered_models = [load_model(p, device=device)
                                for p in manifest.get("models", [])]
        return gs

    def _early_stop(self, grid: Grid, scores: list, c: SearchCriteria) -> bool:
        metric, decr = _sort_metric(grid.models[0],
                                    None if c.stopping_metric == "AUTO"
                                    else c.stopping_metric, None)
        v = getattr(_metrics_of(grid.models[-1]), metric, None)
        if v is None:
            return False
        scores.append(-v if decr else v)  # lower-is-better series
        k = c.stopping_rounds
        if len(scores) <= k:
            return False
        return min(scores[-k:]) > min(scores[:-k]) * (1 - c.stopping_tolerance)


def _canon(v):
    """A value in JSON-stable form: numpy scalars as Python numbers,
    tuples as lists, dict keys as strings in their order — so a combo's
    key is the same before a crash and after its resume reads the manifest
    back."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {str(k): _canon(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    return v


def _combo_key(overrides: dict) -> str:
    return repr(sorted(_canon(overrides).items()))


def _param_value_key(v):
    if isinstance(v, Keyed):           # frames, models (checkpoints)
        return v.key
    if isinstance(v, (list, tuple)) and any(isinstance(x, Keyed) for x in v):
        return [_param_value_key(x) for x in v]
    return repr(_canon(v))


def _full_params_key(params) -> str:
    """Canonical signature over all parameter fields (frames and models by
    key) — the `Grid` dedup checksum role."""
    return repr(sorted((f.name, _param_value_key(getattr(params, f.name)))
                       for f in dataclasses.fields(params)))


def _builder_class(manifest: dict):
    if manifest["builder_module"].split(".", 1)[0] != "h2o_tpu_torch":
        raise ValueError("builder class must live in h2o_tpu_torch")
    return getattr(importlib.import_module(manifest["builder_module"]),
                   manifest["builder_name"])


# -- grid export/import (`water/api/GridImportExportHandler`) ----------------
def export_grid(grid: Grid, directory: str) -> str:
    """Write the grid's manifest and every model binary into ``directory``
    (the `POST /3/Grid.bin/{grid_id}/export` payload)."""
    from ..backend.persist import save_model

    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, m in enumerate(grid.models):
        name = f"model_{i}.bin"
        save_model(m, os.path.join(directory, name))
        paths.append(name)
    manifest = {"grid_id": grid.key,
                "builder_module": grid.builder_cls.__module__,
                "builder_name": grid.builder_cls.__name__,
                "hyper_params": list(grid.hyper_params),
                "models": paths,
                "failures": _canon(grid.failures),
                "trained_param_keys": sorted(grid.trained_param_keys)}
    with open(os.path.join(directory, "grid_manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    return directory


def import_grid(directory: str, device=None) -> Grid:
    """Rebuild a Grid and re-register its models, on ``device`` (default
    ``cuda``), from an export directory (`POST /3/Grid.bin/import`)."""
    from ..backend.persist import load_model

    with open(os.path.join(directory, "grid_manifest.json")) as fh:
        manifest = json.load(fh)
    grid = Grid(_builder_class(manifest), manifest["hyper_params"],
                key=manifest["grid_id"])
    grid.models = [load_model(os.path.join(directory, p), device=device)
                   for p in manifest["models"]]
    grid.failures = list(manifest.get("failures", []))
    grid.trained_param_keys = set(manifest.get("trained_param_keys", []))
    return grid
