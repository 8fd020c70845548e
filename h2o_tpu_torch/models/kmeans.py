"""KMeans — Lloyd iterations (``h2o_tpu/models/kmeans.py``).

Each iteration is one pass over the design: the (rows, k) squared distances
as ``||x||² − 2·X·Cᵀ + ||c||²`` (one ``torch.matmul``), the nearest center
per row, and the per-center {count, sum, within-SS} as products with the
weighted one-hot assignment matrix. The reference computes these products
outside any Pallas kernel, so they stay plain float32 ``torch.matmul``:
``torch.backends.cuda.matmul.allow_tf32`` must be False (PyTorch's default)
or the distances lose bits and near-tie rows flip. The host loop checks
convergence once per iteration. Seeding (Random, PlusPlus, Furthest, User)
and ``estimate_k`` draw from ``jax.random``'s streams as the reference's
do (``utils/threefry.py``: ``choice`` with ``p``).

``KMeansModel.score_raw`` (the serving path's assignment from a raw
feature matrix) waits for ``DataInfo.expand_matrix`` and the serving layer
(ROADMAP Queue 1 item 8, step L).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, Vec
from ..parallel.mesh import resolve_device
from ..utils import threefry
from .datainfo import DataInfo
from .model_base import Model, ModelBuilder, ModelOutput, Parameters


@dataclass
class KMeansParameters(Parameters):
    """Mirrors `hex/schemas/KMeansV3` / KMeansModel.KMeansParameters."""

    k: int = 1
    max_iterations: int = 10
    init: str = "Furthest"  # Random | PlusPlus | Furthest | User
    user_points: np.ndarray | None = None
    standardize: bool = True
    estimate_k: bool = False


class ClusteringMetrics:
    """ModelMetricsClustering analog: within/between/total sums of squares."""

    def __init__(self, totss, tot_withinss, withinss, sizes):
        self.totss = float(totss)
        self.tot_withinss = float(tot_withinss)
        self.betweenss = self.totss - self.tot_withinss
        self.withinss = np.asarray(withinss)
        self.sizes = np.asarray(sizes)

    def __repr__(self):
        return (f"ClusteringMetrics(totss={self.totss:.4f}, "
                f"tot_withinss={self.tot_withinss:.4f}, "
                f"betweenss={self.betweenss:.4f}, sizes={self.sizes.tolist()})")


def _pairwise_d2(X, centers):
    """(rows, k) squared distances, clipped at 0."""
    return torch.clamp_min(
        (X * X).sum(dim=1, keepdim=True) - 2.0 * (X @ centers.T)
        + (centers * centers).sum(dim=1)[None, :], 0.0)


def _lloyd_step(X, wmask, centers, k: int):
    """One Lloyd iteration: assign + accumulate. Returns (new_centers,
    stats)."""
    d2 = _pairwise_d2(X, centers)
    best, assign = torch.min(d2, dim=1)
    oh = torch.nn.functional.one_hot(assign, k).to(torch.float32) \
        * wmask[:, None]
    counts = oh.sum(dim=0)
    sums = oh.T @ X
    withinss = oh.T @ best
    new_centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp_min(counts[:, None], 1.0),
                              centers)
    return new_centers, dict(assign=assign, counts=counts, withinss=withinss,
                             tot_withinss=withinss.sum())


def _assign_only(X, centers):
    best, assign = torch.min(_pairwise_d2(X, centers), dim=1)
    return assign, best


def _row_mask(X, nrow):
    return (torch.arange(X.shape[0], device=X.device) < nrow).to(
        torch.float32)


def _totss(X, wmask) -> float:
    mu = (X * wmask[:, None]).sum(dim=0) / torch.clamp_min(wmask.sum(), 1.0)
    return float((wmask * ((X - mu) ** 2).sum(dim=1)).sum())


class KMeansModel(Model):
    algo_name = "kmeans"

    def __init__(self, params, output, centers, centers_std, dinfo, key=None):
        self.centers = centers          # de-standardized (k, P) numpy array
        self.centers_std = centers_std  # standardized (k, P) tensor, scores
        self.dinfo = dinfo
        super().__init__(params, output, key=key)

    @property
    def k(self):
        return self.centers.shape[0]

    @staticmethod
    def from_reference(ref, device=None) -> "KMeansModel":
        """Carry a JAX-trained KMeans over from its plain fields:
        ``centers``, ``centers_std``, the ``DataInfo`` fields and the
        output's names, domains and training metrics. Given the same frame
        it assigns the rows the reference assigns."""
        dev = resolve_device(device)
        cstd = torch.from_numpy(np.array(ref.centers_std, np.float32)).to(dev)
        out = ModelOutput.carried(ref.output)
        out.training_metrics = ref.output.training_metrics
        params = KMeansParameters(k=int(cstd.shape[0]),
                                  standardize=bool(ref.dinfo.standardize))
        return KMeansModel(params, out, np.array(ref.centers, np.float32),
                           cstd, DataInfo.carried(ref.dinfo))

    def predict(self, fr: Frame) -> Frame:
        X, _ = self.dinfo.expand(fr)
        assign, _ = _assign_only(X, self.centers_std.to(X.device))
        return Frame(["predict"],
                     [Vec(assign.to(torch.float32), fr.nrow, type=T_CAT,
                          domain=[str(i) for i in range(self.k)])])

    def model_performance(self, fr: Frame | None = None):
        if fr is None:
            return self.output.training_metrics
        X, ok = self.dinfo.expand(fr)
        wmask = _row_mask(X, fr.nrow) * ok.to(torch.float32)
        _, stats = _lloyd_step(X, wmask, self.centers_std.to(X.device),
                               self.k)
        return ClusteringMetrics(_totss(X, wmask),
                                 float(stats["tot_withinss"]),
                                 stats["withinss"].cpu().numpy(),
                                 stats["counts"].cpu().numpy())


class KMeans(ModelBuilder):
    algo_name = "kmeans"
    supervised = False

    def build_impl(self, job) -> KMeansModel:
        p: KMeansParameters = self.params
        fr = p.training_frame
        names = self.feature_names()
        dinfo = DataInfo.make(fr, names, standardize=p.standardize,
                              use_all_factor_levels=True)
        X, okrows = dinfo.expand(fr)
        wmask = _row_mask(X, fr.nrow) * okrows.to(torch.float32)
        seed = p.seed if p.seed not in (-1, None) else 1234
        key = threefry.prng_key(seed)

        if p.estimate_k:
            centers, stats, history = self._estimate_k(X, wmask, p, key, job)
        else:
            centers = self._init_centers(X, wmask, p.k, p.init, key, p, dinfo)
            centers, stats, history = self._lloyd(X, wmask, centers, p.k,
                                                  p.max_iterations, job)

        output = ModelOutput()
        output.names = names
        output.domains = {n: fr.vec(n).domain for n in names}
        output.model_category = "Clustering"
        output.training_metrics = ClusteringMetrics(
            _totss(X, wmask), float(stats["tot_withinss"]), stats["withinss"],
            stats["counts"])
        output.scoring_history = history
        #: Lloyd iterations actually run (h2o-py ``num_iterations()``)
        output.num_iterations = len(history)

        # de-standardize the centers back to the input scale for reporting
        centers_np = centers.cpu().numpy()
        denorm = centers_np.copy()
        col = 0
        for n in dinfo.names:
            if n in dinfo.domains:
                col += len(dinfo.domains[n])
            else:
                if dinfo.standardize:
                    denorm[:, col] = (centers_np[:, col] * dinfo.num_sigmas[n]
                                      + dinfo.num_means[n])
                col += 1
        return KMeansModel(p, output, denorm, centers, dinfo)

    # -- seeding (`hex/kmeans/KMeans.java` initial_points) --------------------
    def _init_centers(self, X, wmask, k, init, key, p, dinfo):
        init = (init or "Furthest").lower()
        if init == "user":
            # user_points is (k, n_source_cols) in SOURCE column order;
            # categorical entries are level codes, expanded to model space
            pts = np.asarray(p.user_points, dtype=np.float32)
            if pts.shape != (k, len(dinfo.names)):
                raise ValueError(
                    f"user_points must be ({k}, {len(dinfo.names)}), got "
                    f"{pts.shape}")
            blocks = []
            for j, n in enumerate(dinfo.names):
                if n in dinfo.domains:
                    oh = np.zeros((k, len(dinfo.domains[n])), dtype=np.float32)
                    oh[np.arange(k), pts[:, j].astype(np.int64)] = 1.0
                    blocks.append(oh)
                else:
                    x = pts[:, j]
                    if dinfo.standardize:
                        if dinfo.center:
                            x = x - dinfo.num_means[n]
                        x = x / dinfo.num_sigmas[n]
                    blocks.append(x[:, None])
            return torch.from_numpy(np.concatenate(blocks, axis=1)).to(
                X.device)
        probs = wmask / wmask.sum()
        R = X.shape[0]
        if init == "random":
            idx = threefry.choice(key, R, shape=(k,), replace=False, p=probs)
            return X[idx]
        # PlusPlus / Furthest: iterative d²-sampled or farthest seeding
        i0 = threefry.choice(key, R, p=probs)
        centers = [X[i0]]
        d2 = ((X - centers[0]) ** 2).sum(dim=1)
        for j in range(1, k):
            d2m = torch.where(wmask > 0, d2, 0.0)
            if init == "plusplus":
                pr = d2m / torch.clamp_min(d2m.sum(), 1e-12)
                idx = threefry.choice(threefry.fold_in(key, j), R, p=pr)
            else:  # furthest
                idx = torch.argmax(d2m)
            c = X[idx]
            centers.append(c)
            d2 = torch.minimum(d2, ((X - c) ** 2).sum(dim=1))
        return torch.stack(centers)

    # -- Lloyd loop -----------------------------------------------------------
    def _lloyd(self, X, wmask, centers, k, max_iter, job, tol=1e-6):
        history = []
        prev = np.inf
        for it in range(max(max_iter, 1)):
            job.check_cancelled()
            centers, stats = _lloyd_step(X, wmask, centers, k)
            tw = float(stats["tot_withinss"])
            history.append({"iteration": it, "tot_withinss": tw})
            if prev - tw <= tol * max(abs(prev), 1.0):
                break
            prev = tw
        # one final assignment pass, so the reported stats match the
        # returned centers (the loop's were measured against the old ones)
        _, stats = _lloyd_step(X, wmask, centers, k)
        stats = {kk: v.cpu().numpy() for kk, v in stats.items()
                 if kk != "assign"}
        return centers, stats, history

    def _estimate_k(self, X, wmask, p, key, job):
        """Grow k while the total within-SS improves markedly."""
        best = None
        prev_tw = None
        for k in range(1, max(p.k, 2) + 1):
            if k > 1:
                centers = self._init_centers(X, wmask, k, "furthest",
                                             threefry.fold_in(key, k), p,
                                             None)
            else:
                centers = (X * wmask[:, None]).sum(dim=0, keepdim=True) \
                    / wmask.sum()
            res = self._lloyd(X, wmask, centers, k, p.max_iterations, job)
            tw = res[1]["tot_withinss"]
            if prev_tw is not None and tw > 0.9 * prev_tw:
                break
            best, prev_tw = res, tw
        return best
