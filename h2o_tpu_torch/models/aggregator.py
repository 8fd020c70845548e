"""Aggregator — exemplar-based dataset aggregation
(``h2o_tpu/models/aggregator.py``, `hex/aggregator/`).

Reduces a frame to about ``target_num_exemplars`` representative rows,
each carrying the count of member rows within a Euclidean radius in the
transformed space. The radius multiplier is binary-searched on Lee's base
radius (`Aggregator.java:142`, .1 / log(nrow)^(1/ncol)) until the exemplar
count lands within ``rel_tol_num_exemplars`` of the target
(`Aggregator.java:150-200`).

The greedy pass keeps the reference's order exactly (the result depends on
it): rows in batches of 65,536, each batch's rows against the exemplar
matrix as it stood at the batch's start — one NA-aware distance product on
the frame's device (``_sqdist``: full float32, TF32 off, since the
distances decide a sharp ``<= radius²``) — then the rows no exemplar took,
in row order, against the exemplars added since. That candidate scan is
the reference's ``np.nansum`` of squared differences on the host, which
does not apply ``_sqdist``'s ncol/nobs rescale for missing values
(ROADMAP Queue 3: a fault of the reference, reproduced on purpose). Rows an
exemplar took are counted in one ``bincount``; a candidate scans the new
exemplars in blocks and stops at the first within the radius.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import Vec
from .datainfo import DataInfo
from .model_base import Model, ModelBuilder, ModelOutput, Parameters


@dataclass
class AggregatorParameters(Parameters):
    target_num_exemplars: int = 5000
    rel_tol_num_exemplars: float = 0.5
    transform: str = "NORMALIZE"  # NONE|STANDARDIZE|NORMALIZE|DEMEAN|DESCALE
    categorical_encoding: str = "AUTO"


def _sqdist(X: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """(n, f) × (m, f) → (n, m) squared Euclidean distances, NA-aware:
    missing values are skipped pairwise and the partial sum is rescaled by
    ncol / n_observed (`Aggregator.java:68-100` squaredEuclideanDistance)."""
    okX, okE = ~torch.isnan(X), ~torch.isnan(E)
    Xz = torch.where(okX, X, 0.0)
    Ez = torch.where(okE, E, 0.0)
    okXf, okEf = okX.to(torch.float32), okE.to(torch.float32)
    cross = Xz @ Ez.T
    x2 = (Xz * Xz) @ okEf.T
    e2 = okXf @ (Ez * Ez).T
    nobs = okXf @ okEf.T
    ncol = X.shape[1]
    return (x2 - 2.0 * cross + e2) * (ncol / torch.clamp_min(nobs, 1.0))


#: new exemplars a candidate scans per numpy step before it looks for the
#: first one within the radius
_SCAN_BLOCK = 256


def _first_within(x: np.ndarray, Enew: np.ndarray, radius2: float) -> int:
    """Index of the first row of ``Enew`` whose ``nansum`` of squared
    differences to ``x`` is <= radius2, else -1 (the reference's scan,
    one block of rows per numpy step)."""
    for s in range(0, Enew.shape[0], _SCAN_BLOCK):
        dd = np.nansum((x - Enew[s:s + _SCAN_BLOCK]) ** 2, axis=1)
        # the reference compares each sum as a Python float: in float64
        hit = np.flatnonzero(dd.astype(np.float64) <= radius2)
        if hit.size:
            return s + int(hit[0])
    return -1


def _aggregate(Xh: np.ndarray, radius2: float, limit: int, device,
               batch: int = 65536):
    """Greedy exemplar pass. Returns (exemplar_rows, counts, assignment), or
    None once the exemplar count exceeds ``limit`` (the reference's
    `upperLimit` early out)."""
    n, f = Xh.shape
    if radius2 <= 0.0:
        return np.arange(n), np.ones(n, dtype=np.int64), np.arange(n)
    ex_rows: list[int] = [0]
    counts = np.zeros(n + 1, dtype=np.int64)
    counts[0] = 1
    assign = np.zeros(n, dtype=np.int64)
    Xd = torch.from_numpy(Xh.astype(np.float32)).to(device)
    # the batch test compares float32 distances with the radius rounded to
    # float32, as numpy compares the reference's float32 array
    r2 = torch.tensor(np.float32(radius2), device=device)
    for s in range(1, n, batch):
        chunk = Xh[s:s + batch]
        ne = len(ex_rows)
        d2 = _sqdist(Xd[s:s + batch],
                     Xd[torch.tensor(ex_rows, device=device)])
        dmin, best = torch.min(d2, dim=1)
        ok = (dmin <= r2).cpu().numpy()
        best = best.cpu().numpy()
        taken = best[ok]
        assign[s:s + len(chunk)][ok] = taken
        counts[:ne] += np.bincount(taken, minlength=ne)
        cand = np.flatnonzero(~ok)
        Enew = np.empty((min(len(cand), limit + 1), f), dtype=Xh.dtype)
        nn = 0                       # exemplars added in this batch
        for j in cand:
            row = s + int(j)
            e = _first_within(chunk[j], Enew[:nn], radius2) if nn else -1
            if e >= 0:
                counts[ne + e] += 1
                assign[row] = ne + e
                continue
            ex_rows.append(row)
            counts[len(ex_rows) - 1] = 1
            assign[row] = len(ex_rows) - 1
            if len(ex_rows) > limit:
                return None
            Enew[nn] = chunk[j]
            nn += 1
    return np.asarray(ex_rows), counts[:len(ex_rows)].copy(), assign


def _transform(X: np.ndarray, mode: str) -> np.ndarray:
    """Column transforms — `hex/DataInfo.TransformType` semantics."""
    mode = (mode or "NORMALIZE").upper()
    if mode == "NONE":
        return X
    mean = np.nanmean(X, axis=0)
    if mode == "DEMEAN":
        return X - mean
    if mode == "DESCALE":
        sd = np.nanstd(X, axis=0, ddof=1)
        return X / np.where(sd > 0, sd, 1.0)
    if mode == "STANDARDIZE":
        sd = np.nanstd(X, axis=0, ddof=1)
        return (X - mean) / np.where(sd > 0, sd, 1.0)
    # NORMALIZE: scale to unit range around the mean
    rng = np.nanmax(X, axis=0) - np.nanmin(X, axis=0)
    return (X - mean) / np.where(rng > 0, rng, 1.0)


class AggregatorModel(Model):
    algo_name = "aggregator"

    def __init__(self, params, output, key=None):
        super().__init__(params, output, key=key)
        self.aggregated_frame: Frame | None = None
        self.exemplar_assignment: np.ndarray | None = None

    def score0(self, X):  # Aggregator doesn't score rows
        raise NotImplementedError("Aggregator has no row scoring")

    def predict(self, fr):
        raise NotImplementedError("Aggregator has no predict; use "
                                  "aggregated_frame")


class Aggregator(ModelBuilder):
    algo_name = "aggregator"
    supervised = False

    def build_impl(self, job) -> AggregatorModel:
        p: AggregatorParameters = self.params
        if p.target_num_exemplars <= 0:
            raise ValueError("target_num_exemplars must be > 0")
        if not (0.0 < p.rel_tol_num_exemplars < 1.0):
            raise ValueError("rel_tol_num_exemplars must be inside 0...1")
        fr = p.training_frame
        dev = fr.device
        feats = self.feature_names()
        di = DataInfo.make(fr, feats, standardize=False,
                           missing_values_handling="MeanImputation")
        X, _ = di.expand(fr)
        Xh = X[: fr.nrow].cpu().numpy()
        del X
        Xh = np.ascontiguousarray(_transform(Xh, p.transform))

        n, f = fr.nrow, Xh.shape[1]
        target = int(min(p.target_num_exemplars, n))
        radius_base = 0.1 / math.pow(max(math.log(max(n, 3)), 1e-9), 1.0 / f)
        tol = p.rel_tol_num_exemplars
        upper = int(target * (1.0 + tol) + 1)

        # binary search on radius_scale (`Aggregator.java:150-200`): start
        # at 8, grow or shrink by 2x until bracketed, then bisect
        lo, hi, mid = 0.0, float("inf"), 8.0
        best, met = None, False
        passes = 0
        for _ in range(100):
            job.check_cancelled()
            radius = 0.0 if target == n else mid * radius_base
            res = _aggregate(Xh, radius * radius, upper, dev)
            passes += 1
            num = upper + 1 if res is None else len(res[0])
            if res is not None and (target == n or
                                    abs(num - target) <= tol * target):
                best, met = res, True
                break
            if num > target:
                lo = mid
                mid = mid * 2 if hi == float("inf") else (mid + hi) / 2
            else:
                hi = mid
                best = res  # an undershoot is usable if bisection stalls
                mid = (lo + mid) / 2
            if hi - lo < 1e-9:
                break
        fallback = not met    # the search ended outside the tolerance
        if best is None:  # stuck with too many exemplars: accept (ref :177-181)
            best = _aggregate(Xh, (mid * radius_base) ** 2, n, dev)
            passes += 1
        ex_rows, counts, assign = best

        out = ModelOutput()
        out.model_category = "Clustering"
        out.names = feats
        out.domains = {name: fr.vec(name).domain for name in feats}
        model = AggregatorModel(p, out)
        agg_cols: dict[str, Vec] = {}
        for name in fr.names:
            v = fr.vec(name)
            if v.is_string():
                agg_cols[name] = Vec(None, len(ex_rows), type=v.type,
                                     host_data=v.host_data[ex_rows])
            else:
                agg_cols[name] = Vec.from_numpy(v.to_numpy()[ex_rows],
                                                type=v.type, domain=v.domain,
                                                device=dev)
        agg_cols["counts"] = Vec.from_numpy(counts.astype(np.float64),
                                            device=dev)
        model.aggregated_frame = Frame(list(agg_cols), list(agg_cols.values()))
        model.exemplar_assignment = assign
        model.output.scoring_history = [{"exemplars": len(ex_rows),
                                         "mapped_rows": int(counts.sum()),
                                         "passes": passes,
                                         "fallback": fallback}]
        job.update(1.0)
        return model
