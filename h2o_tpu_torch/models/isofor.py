"""Isolation Forest and Extended Isolation Forest
(``h2o_tpu/models/isofor.py``; `hex/tree/isofor/`,
`hex/tree/isoforextended/`).

Each tree isolates a row subsample (default 256 rows) with random cuts;
a row's anomaly score is 2^(-E[path length] / c(n)). All trees grow
together as batched tensors over their (T, S, F) subsamples, as the
reference's ``vmap`` grows them: per level each (tree, node) draws its
direction on jax's stream (``utils/threefry.py``) — an axis from
``randint`` for the classic forest, a hyperplane of ``extension_level +
1`` nonzero normal components for the extended one — and takes a cut
uniform between its rows' extremes (a scatter min and max over the
subsample). The subsample is ``choice`` without replacement (a
permutation's first S) up to 100,000 rows and ``randint`` above, as in
the reference.

Scoring walks every tree over blocks of rows on the device. An axis-aligned
forest reads each row's value at the node's feature, exactly the
reference's projection on a one-hot direction; a hyperplane's projection
is a float64 dot product rounded once, and ``c(n)`` is taken in float64,
so the card and the CPU score alike, within a few ulps of the reference's
float32 sums.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import Vec
from ..parallel.mesh import resolve_device
from ..utils import threefry
from .model_base import Model, ModelBuilder, ModelOutput, Parameters
from .tree.engine import _fma

#: rows per scoring block: bounds the (rows, F) projection temporaries
_SCORE_ROWS = 1 << 20


@dataclass
class IsolationForestParameters(Parameters):
    ntrees: int = 50
    sample_size: int = 256
    max_depth: int = 0        # 0 = ceil(log2(sample_size)), reference default
    extension_level: int = 0  # 0 = classic axis-aligned (IF); >0 = extended


def _avg_path(n: torch.Tensor) -> torch.Tensor:
    """c(n): the average unsuccessful-search path length of a binary
    search tree of n nodes, in float64 and rounded once to float32."""
    n = torch.clamp(n.double(), min=2.0)
    H = torch.log(n - 1.0) + 0.5772156649
    return (2.0 * H - 2.0 * (n - 1.0) / n).to(torch.float32)


def _directions(keys, level: int, n_lv: int, F: int, nnz: int,
                extended: bool):
    """(T, n_lv, F) float32 split directions of one level: each tree's key
    folded with the level, then its draws (``_grow_trees``), and (T, n_lv)
    float32 uniforms that place the cuts. A level's draws are a few
    thousand numbers: they are made on the host, where a draw costs no
    kernel launches, and so are the same for every device."""
    ws, us = [], []
    for key in keys:
        lkey = threefry.fold_in(key, level)
        if extended:
            w = threefry.normal(threefry.fold_in(lkey, 0), (n_lv, F))
            if nnz < F:
                # keep nnz random components of each hyperplane
                u = threefry.uniform(threefry.fold_in(lkey, 2), (n_lv, F))
                kth = torch.sort(u, dim=1).values[:, nnz - 1]
                w = torch.where(u <= kth[:, None], w, 0.0)
            norm = torch.sqrt((w.double() ** 2).sum(dim=1, keepdim=True))
            w = w / torch.clamp(norm.to(torch.float32), min=1e-9)
        else:
            f = threefry.randint(threefry.fold_in(lkey, 0), (n_lv,), 0, F)
            w = torch.nn.functional.one_hot(f, F).to(torch.float32)
        ws.append(w)
        us.append(threefry.uniform(threefry.fold_in(lkey, 1), (n_lv,)))
    return torch.stack(ws), torch.stack(us)


def _project(X, w) -> torch.Tensor:
    """Each row's projection on its direction, rows of X (..., F) against
    w (..., F): the coordinate itself for a one-hot direction (the
    reference's sum of x times 0 and 1 is exact), else a float64 dot
    product rounded once."""
    return (X.double() * w.double()).sum(dim=-1).to(torch.float32)


def _grow_trees(Xs, keys, depth: int, ext_level: int):
    """Xs (T, S, F) per-tree subsamples, ``keys`` (T, 2) tree keys. Returns
    (wvec (T, N, F), thr (T, N), is_split (T, N), counts (T, N)) in the
    full-binary layout (children 2i+1, 2i+2): each node's direction and
    cut, whether it split, and the subsample rows that end in it. A node
    splits when it holds more than one row and its rows' projections
    differ."""
    T, S, F = Xs.shape
    dev = Xs.device
    N = 2 ** (depth + 1) - 1
    extended = ext_level > 0
    nnz = min(ext_level + 1, F)
    wvec = torch.zeros((T, N, F), dtype=torch.float32, device=dev)
    thr = torch.zeros((T, N), dtype=torch.float32, device=dev)
    is_split = torch.zeros((T, N), dtype=torch.bool, device=dev)
    node = torch.zeros((T, S), dtype=torch.int64, device=dev)
    tix = torch.arange(T, device=dev)[:, None]
    for level in range(depth):
        n_lv = 2 ** level
        offset = n_lv - 1
        w, u = (t.to(dev) for t in _directions(keys, level, n_lv, F, nnz,
                                                extended))
        local = node - offset
        active = (local >= 0) & (local < n_lv)
        lc = torch.clamp(local, 0, n_lv - 1)
        proj = _project(Xs, w[tix, lc])                      # (T, S)
        cell = torch.where(active, tix * n_lv + lc, T * n_lv).reshape(-1)
        pv = proj.reshape(-1)
        mn = torch.full((T * n_lv + 1,), torch.inf, device=dev).scatter_reduce(
            0, cell, pv, "amin")[:-1].view(T, n_lv)
        mx = torch.full((T * n_lv + 1,), -torch.inf, device=dev
                        ).scatter_reduce(0, cell, pv, "amax")[:-1].view(T, n_lv)
        cnt = torch.zeros((T * n_lv + 1,), dtype=torch.int64, device=dev
                          ).index_add_(0, cell, torch.ones_like(cell))[:-1]
        cnt = cnt.view(T, n_lv)
        # XLA contracts mn + u * (mx - mn) into one FMA
        t = _fma(u, mx - mn, mn)
        do = (cnt > 1) & (mx > mn)
        sl = slice(offset, offset + n_lv)
        wvec[:, sl] = torch.where(do[..., None], w, 0.0)
        thr[:, sl] = torch.where(do, t, 0.0)
        is_split[:, sl] = do
        go_right = proj > torch.gather(t, 1, lc)
        row_do = torch.gather(do, 1, lc) & active
        node = torch.where(row_do, 2 * node + 1 + go_right.to(torch.int64),
                           node)
    counts = torch.zeros((T * N,), dtype=torch.float32, device=dev).index_add_(
        0, (tix * N + node).reshape(-1),
        torch.ones((T * S,), dtype=torch.float32, device=dev)).view(T, N)
    return wvec, thr, is_split, counts


def _path_lengths(X, wvec, thr, is_split, counts, depth: int) -> torch.Tensor:
    """Mean path length per row over all trees, (R,) float32: the levels a
    row descends through split nodes plus c(n) of the n subsample rows in
    its leaf. Rows go in blocks of `_SCORE_ROWS`; an axis-aligned forest
    reads the node's feature, a hyperplane forest projects."""
    T, N, F = wvec.shape
    nz = wvec != 0
    axis = bool((nz.sum(dim=2) <= 1).all() and (wvec[nz] == 1.0).all())
    feat = torch.argmax(nz.to(torch.int8), dim=2) if axis else None
    leaf_c = torch.where(counts > 1, _avg_path(counts), 0.0)
    out = []
    for r0 in range(0, X.shape[0], _SCORE_ROWS):
        Xr = X[r0:r0 + _SCORE_ROWS]
        acc = torch.zeros((Xr.shape[0],), dtype=torch.float32,
                          device=X.device)
        for t in range(T):
            node = torch.zeros((Xr.shape[0],), dtype=torch.int64,
                               device=X.device)
            d = torch.zeros_like(acc)
            for _ in range(depth):
                splitting = is_split[t][node]
                if axis:
                    proj = torch.gather(Xr, 1, feat[t][node][:, None])[:, 0]
                else:
                    proj = _project(Xr, wvec[t][node])
                go_right = proj > thr[t][node]
                node = torch.where(splitting,
                                   2 * node + 1 + go_right.to(torch.int64),
                                   node)
                d = d + splitting.to(torch.float32)
            acc = acc + (d + leaf_c[t][node])
        # a tensor divisor, as in `UpliftDRFModel.score0`: exact on the card
        out.append(acc / torch.tensor(float(T), device=X.device))
    return torch.cat(out)


class ModelMetricsAnomaly:
    """The reference's anomaly training metrics: the mean score and the
    mean path length over the training rows."""

    def __init__(self, mean_score: float, mean_length: float):
        self.mean_score = mean_score
        self.mean_length = mean_length

    def __repr__(self):
        return f"AnomalyMetrics(mean_length={self.mean_length:.3f})"


class IsolationForestModel(Model):
    algo_name = "isolationforest"

    def __init__(self, params, output, forest, depth, sample_size, key=None):
        self.forest = forest    # (wvec, thr, is_split, counts)
        self.depth = depth
        self.sample_size = sample_size
        super().__init__(params, output, key=key)

    @staticmethod
    def from_reference(ref, device=None) -> "IsolationForestModel":
        """Carry a JAX-trained (extended) isolation forest over: its four
        forest arrays, depth, subsample size, output and parameters."""
        dev = resolve_device(device)
        dtypes = (np.float32, np.float32, np.bool_, np.float32)
        forest = tuple(torch.from_numpy(np.array(a, t)).to(dev)
                       for a, t in zip(ref.forest, dtypes))
        out = ModelOutput.carried(ref.output)
        out.training_metrics = ref.output.training_metrics
        rp = ref.params
        params = IsolationForestParameters(
            ntrees=rp.ntrees, sample_size=rp.sample_size,
            max_depth=rp.max_depth, extension_level=rp.extension_level,
            seed=rp.seed)
        return IsolationForestModel(params, out, forest, int(ref.depth),
                                    int(ref.sample_size))

    def score0(self, X: torch.Tensor) -> torch.Tensor:
        """(R, 2): the anomaly score and the mean path length."""
        forest = tuple(a.to(X.device) for a in self.forest)
        h = _path_lengths(torch.nan_to_num(X), *forest, depth=self.depth)
        c = _avg_path(torch.tensor(float(self.sample_size), device=X.device))
        return torch.stack([torch.exp2(-h / c), h], dim=1)

    def predict(self, fr: Frame) -> Frame:
        raw = self.score0(self.adapt_frame(fr))
        return Frame(["predict", "mean_length"],
                     [Vec(raw[:, 0].contiguous(), fr.nrow),
                      Vec(raw[:, 1].contiguous(), fr.nrow)])


class IsolationForest(ModelBuilder):
    algo_name = "isolationforest"
    supervised = False

    def build_impl(self, job) -> IsolationForestModel:
        p: IsolationForestParameters = self.params
        fr = p.training_frame
        names = self.feature_names()
        X = torch.nan_to_num(fr.as_matrix(names))
        dev = X.device
        nrow = fr.nrow
        S = min(p.sample_size, nrow)
        depth = p.max_depth or max(int(math.ceil(math.log2(max(S, 2)))), 1)
        seed = p.seed if p.seed not in (-1, None) else 1234
        tkeys = threefry.split(threefry.prng_key(seed), p.ntrees)
        # subsample: without replacement up to 100,000 rows, else randint
        idx = torch.stack([
            threefry.choice(k, nrow, (S,), replace=False)
            if nrow <= 100_000 else
            threefry.randint(k, (S,), 0, nrow) for k in tkeys]).to(dev)
        job.check_cancelled()
        forest = _grow_trees(X[idx], tkeys, depth, int(p.extension_level))

        output = ModelOutput()
        output.names = names
        output.domains = {n: fr.vec(n).domain for n in names}
        output.model_category = "AnomalyDetection"
        model = IsolationForestModel(p, output, forest, depth, S)
        h = _path_lengths(X[:nrow], *forest, depth=depth)
        c = _avg_path(torch.tensor(float(S), device=dev))
        output.training_metrics = ModelMetricsAnomaly(
            float(torch.exp2(-h / c).sum() / nrow), float(h.sum() / nrow))
        job.update(1.0)
        return model


class ExtendedIsolationForest(IsolationForest):
    algo_name = "extendedisolationforest"

    def __init__(self, params):
        if params.extension_level <= 0:
            params.extension_level = 1
        super().__init__(params)
