"""Uplift DRF (``h2o_tpu/models/uplift.py``) — the treatment-effect random
forest of `hex/tree/uplift/UpliftDRF.java`.

The tree engine's level loop with a four-channel histogram: per level one
level-histogram launch (`engine._build_level_hist`) accumulates {w_t,
w_t y, w_c, w_c y} per (feature, node, bin) — the kernel at V = 4 — and
each node takes the cut of largest divergence gain

    gain = sum_child (n_child / n) D(p_child, q_child) - D(p, q),

p and q the treated and control response rates, D one of KL, Euclidean or
ChiSquared (`hex/tree/uplift/Divergence.java`). The reference's choices are
kept: depth capped at 12, ``nbins_cats`` pinned to ``nbins`` (categoricals
split ordinally), NA rows routed right, the width-bucketed plan of
`plan_hist_groups(..., nvals=4)`, the row sample from ``fold_in(key, 0)``
and the column masks of DRF's ``mtries`` on jax's streams. Leaves hold both
rates, and a prediction is (uplift, p_y1_ct1, p_y1_ct0).

The split search takes the reference's candidate layout and first-maximum
rule. Its float32 ``log`` and divisions are done here in float64 and
rounded once: the gains then round alike on the card and on the CPU, and
sit within a few ulps of the reference's (a split the two could order
differently is a near tie, kept out of the parity fixtures).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..backend.memory import hbm_budget_bytes
from ..frame.chunks import BinnedView
from ..frame.frame import Frame
from ..frame.vec import Vec
from ..parallel.mesh import resolve_device
from ..utils import threefry
from .drf import DRFParameters
from .gbm import _JAX_ONLY_CFG, _seed
from .metrics import ModelMetrics
from .model_base import Model, ModelBuilder, ModelOutput
from .tree.binning import compute_bin_edges
from .tree.engine import (TreeConfig, _build_level_hist, _cumsum64, _f32,
                          _level_col_mask, _node_sums, _node_totals,
                          _route_all, _route_tree, plan_hist_groups)


@dataclass
class UpliftDRFParameters(DRFParameters):
    """Mirrors `hex/schemas/UpliftDRFV3`."""

    treatment_column: str = "treatment"
    uplift_metric: str = "AUTO"   # AUTO(=KL) | KL | Euclidean | ChiSquared
    auuc_type: str = "AUTO"       # AUTO(=qini) | qini | lift | gain
    auuc_nbins: int = -1          # -1 -> min(1000, 10% rows)


def _divergence(metric: str):
    """D(p, q) on float64 tensors of float32 rates: the reference's clips
    in float32 (its constants rounded to float32), the rest in float64."""
    eps = _f32(1e-6)
    hi = _f32(1 - 1e-6)

    def clip(x):
        return torch.clamp(x, eps, hi)

    def kl(p, q):
        p, q = clip(p).double(), clip(q).double()
        return p * torch.log(p / q) + (1 - p) * torch.log((1 - p) / (1 - q))

    def euclid(p, q):
        return 2.0 * (p.double() - q.double()) ** 2

    def chisq(p, q):
        p, q = p.double(), clip(q).double()
        return (p - q) ** 2 / q + (p - q) ** 2 / (1 - q)

    fns = {"KL": kl, "AUTO": kl, "EUCLIDEAN": euclid, "CHISQUARED": chisq}
    key = (metric or "AUTO").upper()
    if key not in fns:
        raise ValueError(f"uplift_metric '{metric}' must be one of AUTO, KL, "
                         "Euclidean, ChiSquared")
    return fns[key]


def _find_uplift_splits(hist, colmask, edge_ok, div, cfg: TreeConfig):
    """hist (F, n_lv, B, 4) = {wt, wty, wc, wcy} -> (gain, feature, bin,
    node weight) per node. Cuts b in 0..nb-2 send bins <= b left and the
    NA bucket right; a cut needs ``min_rows`` on each side and treated and
    control rows on each side. Candidates flatten as (n_lv, F * (nb - 1))
    and the first maximum wins."""
    nb = cfg.nbins
    eps = _f32(1e-10)
    WT, WTY, WC, WCY = (hist[..., c] for c in range(4))
    WTt, WTYt, WCt, WCYt = _node_sums(hist)          # (n_lv,) each

    cwt = _cumsum64(WT[:, :, :nb])[:, :, :-1]         # (F, n_lv, nb-1)
    cwty = _cumsum64(WTY[:, :, :nb])[:, :, :-1]
    cwc = _cumsum64(WC[:, :, :nb])[:, :, :-1]
    cwcy = _cumsum64(WCY[:, :, :nb])[:, :, :-1]

    def rate(num, den):
        return num / torch.clamp(den, min=eps)

    pL, qL = rate(cwty, cwt), rate(cwcy, cwc)
    wtR = WTt[None, :, None] - cwt
    wcR = WCt[None, :, None] - cwc
    pR = rate(WTYt[None, :, None] - cwty, wtR)
    qR = rate(WCYt[None, :, None] - cwcy, wcR)
    pP, qP = rate(WTYt, WTt), rate(WCYt, WCt)

    nL = cwt + cwc
    nR = wtR + wcR
    n = torch.clamp(nL + nR, min=eps).double()
    gain = ((nL.double() / n) * div(pL, qL) + (nR.double() / n) * div(pR, qR)
            - div(pP, qP)[None, :, None]).to(torch.float32)
    ok = ((nL >= cfg.min_rows) & (nR >= cfg.min_rows)
          & (cwt > 0) & (cwc > 0) & (wtR > 0) & (wcR > 0))
    ok = ok & colmask[:, :, None] & edge_ok[:, None, :]
    gain = torch.where(ok, gain, -torch.inf)

    n_lv = gain.shape[1]
    flat = gain.permute(1, 0, 2).reshape(n_lv, -1)
    best = torch.argmax(flat, dim=1)
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    return best_gain, best // (nb - 1), (best % (nb - 1)).to(torch.int32), \
        WTt + WCt


def _grow_uplift_tree(Xb, y, treat, w, edges, edge_ok, colkey, div,
                      cfg: TreeConfig):
    """One uplift tree on the device: (feat, thr, gain, val_t, val_c), each
    (N,) in the full-binary layout. ``colkey`` is the tree's key."""
    Rl, F = Xb.shape
    N = cfg.n_nodes
    B = cfg.nbins + 1
    dev = Xb.device
    feat = torch.full((N,), -1, dtype=torch.int32, device=dev)
    thr = torch.zeros((N,), dtype=torch.float32, device=dev)
    garr = torch.zeros((N,), dtype=torch.float32, device=dev)
    node = torch.zeros((Rl,), dtype=torch.int32, device=dev)
    wt = w * treat
    wc = w * (1.0 - treat)
    vals4 = torch.stack([wt, wt * y, wc, wc * y], dim=1)

    tree_cols = (threefry.uniform(threefry.fold_in(colkey, 997), (F,), dev)
                 < _f32(cfg.col_sample_rate_per_tree))
    tree_cols = torch.where(tree_cols.any(), tree_cols, True)
    no_nal = torch.zeros((1,), dtype=torch.bool, device=dev)

    route_args = None
    for level in range(cfg.max_depth):
        n_lv = 2 ** level
        offset = n_lv - 1
        sl = slice(offset, offset + n_lv)
        if route_args is not None:
            node = _route_all(Xb, node, route_args, cfg)
        hist = _build_level_hist(Xb, node, vals4, offset, n_lv, B,
                                 cfg.block_rows, groups=cfg.hist_groups)
        cmask = _level_col_mask(threefry.fold_in(colkey, level), F, n_lv,
                                cfg, tree_cols)
        gain, bf, bb, Wt = _find_uplift_splits(hist, cmask, edge_ok, div, cfg)
        do_split = (gain > cfg.min_split_improvement) & (Wt >= 2 * cfg.min_rows)
        feat[sl] = torch.where(do_split, bf.to(torch.int32), -1)
        thr[sl] = edges[bf, bb.long()]
        garr[sl] = torch.where(do_split, gain, 0.0)
        # the NA bucket (code nbins) is above every cut: it routes right
        route_args = (bf, bb, no_nal.expand(n_lv), do_split, None, None,
                      offset, n_lv)
    if route_args is not None:
        node = _route_all(Xb, node, route_args, cfg)
    tot = _node_totals(node, vals4, N)
    val_t = tot[:, 1] / torch.clamp(tot[:, 0], min=_f32(1e-10))
    val_c = tot[:, 3] / torch.clamp(tot[:, 2], min=_f32(1e-10))
    return feat, thr, garr, val_t, val_c


class ModelMetricsBinomialUplift(ModelMetrics):
    """AUUC-based metrics (`hex/ModelMetricsBinomialUplift`)."""

    def __init__(self, auuc, auuc_normalized, qini, ate, att, atc, nbins):
        super().__init__()
        self.auuc = auuc
        self.auuc_normalized = auuc_normalized
        self.qini = qini
        self.ate = ate   # average treatment effect
        self.att = att   # ... on the treated
        self.atc = atc   # ... on control
        self.nbins = nbins

    def __repr__(self):
        return (f"ModelMetricsBinomialUplift(AUUC={self.auuc:.4f}, "
                f"qini={self.qini:.4f}, ATE={self.ate:.4f})")


def make_uplift_metrics(y, treat, uplift, nbins=-1, auuc_type="AUTO"):
    """AUUC from the rows sorted by predicted uplift (`hex/AUUC.java`), on
    host arrays, the reference's arithmetic: the curve of ``auuc_type``
    (qini = AUTO: treated positives minus control positives scaled to the
    treated count; lift: the treated rate minus the control rate among the
    targeted rows; gain: lift times the rows targeted) sampled at
    ``nbins`` ranks, its mean the AUUC; ATE, ATT and ATC the mean predicted
    uplift over all, treated and control rows."""
    y = np.asarray(y)
    treat = np.asarray(treat)
    uplift = np.asarray(uplift)
    ok = ~np.isnan(y)
    y, treat, uplift = y[ok], treat[ok], uplift[ok]
    n = len(y)
    nbins = int(min(nbins if nbins > 0 else 1000, max(n // 10, 1)))
    order = np.argsort(-uplift)
    ys, ts = y[order], treat[order]
    ct = np.cumsum(ts)
    cc = np.cumsum(1 - ts)
    cyt = np.cumsum(ys * ts)
    cyc = np.cumsum(ys * (1 - ts))
    idx = np.linspace(0, n - 1, nbins, dtype=np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        qini_curve = cyt[idx] - np.where(
            cc[idx] > 0, cyc[idx] * ct[idx] / np.maximum(cc[idx], 1), 0)
        lift_curve = (np.where(ct[idx] > 0, cyt[idx] / np.maximum(ct[idx], 1),
                               0)
                      - np.where(cc[idx] > 0,
                                 cyc[idx] / np.maximum(cc[idx], 1), 0))
        gain_curve = lift_curve * (idx + 1)
    curves = {"QINI": qini_curve, "LIFT": lift_curve, "GAIN": gain_curve,
              "AUTO": qini_curve}
    auuc = float(np.mean(curves[(auuc_type or "AUTO").upper()]))
    qini = float(np.mean(qini_curve))
    ate = float(np.mean(uplift)) if n else np.nan
    att = float(np.mean(uplift[treat == 1])) if (treat == 1).any() else np.nan
    atc = float(np.mean(uplift[treat == 0])) if (treat == 0).any() else np.nan
    rand_auuc = ate * (n + 1) / 2
    norm = float(auuc / rand_auuc) if abs(rand_auuc) > 1e-12 else np.nan
    return ModelMetricsBinomialUplift(auuc, norm, qini, ate, att, atc, nbins)


class UpliftDRFModel(Model):
    algo_name = "upliftdrf"

    def __init__(self, params, output, forest, cfg: TreeConfig, key=None):
        self.forest = forest  # feat/thr/gain/val_t/val_c: (T, N)
        self.cfg = cfg
        super().__init__(params, output, key=key)

    @staticmethod
    def from_reference(ref, device=None) -> "UpliftDRFModel":
        """Carry a JAX-trained uplift forest over: its forest arrays, tree
        config fields, output and parameters. Given the same frame it
        predicts what the reference model predicts."""
        dev = resolve_device(device)
        dtypes = dict(feat=np.int32, thr=np.float32, gain=np.float32,
                      val_t=np.float32, val_c=np.float32)
        forest = {k: torch.from_numpy(np.array(ref.forest[k], t)).to(dev)
                  for k, t in dtypes.items()}
        cfg = TreeConfig(**{k: v for k, v in
                            dataclasses.asdict(ref.cfg).items()
                            if k not in _JAX_ONLY_CFG})
        out = ModelOutput.carried(ref.output)
        out.training_metrics = ref.output.training_metrics
        rp = ref.params
        params = UpliftDRFParameters(
            response_column=rp.response_column,
            treatment_column=rp.treatment_column, ntrees=rp.ntrees,
            max_depth=rp.max_depth, uplift_metric=rp.uplift_metric,
            auuc_type=rp.auuc_type, auuc_nbins=rp.auuc_nbins, seed=rp.seed)
        return UpliftDRFModel(params, out, forest, cfg)

    def score0(self, X: torch.Tensor) -> torch.Tensor:
        """(R, 3): uplift, the treated rate and the control rate, each the
        mean over the trees of the leaf a row reaches (NA goes right)."""
        fo = self.forest
        T = fo["feat"].shape[0]
        nanL = torch.zeros_like(fo["feat"][0], dtype=torch.bool)
        pt = torch.zeros((X.shape[0],), dtype=torch.float32, device=X.device)
        pc = torch.zeros_like(pt)
        for t in range(T):
            node = _route_tree(X, fo["feat"][t], fo["thr"][t], nanL, None,
                               None, None, self.cfg.max_depth)
            pt = pt + fo["val_t"][t][node]
            pc = pc + fo["val_c"][t][node]
        # a tensor divisor: the card divides a tensor by a host scalar as
        # a product with its rounded reciprocal, an ulp off the CPU's
        # quotient
        tt = torch.tensor(float(T), device=X.device)
        pt, pc = pt / tt, pc / tt
        return torch.stack([pt - pc, pt, pc], dim=1)

    def _predictions_frame(self, raw, nrow) -> Frame:
        names = ["uplift_predict", "p_y1_ct1", "p_y1_ct0"]
        return Frame(names, [Vec(raw[:, j].contiguous(), nrow)
                             for j in range(3)])

    def model_performance(self, fr: Frame | None = None):
        if fr is None:
            return self.output.training_metrics
        p = self.params
        raw = self.score0(self.adapt_frame(fr))[:fr.nrow, 0]
        return make_uplift_metrics(
            fr.vec(p.response_column).to_numpy(),
            fr.vec(p.treatment_column).to_numpy(), raw.cpu().numpy(),
            p.auuc_nbins, p.auuc_type)


class UpliftDRF(ModelBuilder):
    algo_name = "upliftdrf"

    def _validate(self):
        super()._validate()
        p = self.params
        if not p.treatment_column or \
                p.training_frame.find(p.treatment_column) < 0:
            raise ValueError("upliftdrf: treatment_column must name a column")

    def feature_names(self):
        names = super().feature_names()
        return [n for n in names if n != self.params.treatment_column]

    def build_impl(self, job) -> UpliftDRFModel:
        p = self.params
        fr = p.training_frame
        dev = fr.device
        names = self.feature_names()
        y_dev, category, resp_domain = self.response_info()
        if category != "Binomial":
            raise ValueError("upliftdrf requires a binary (2-level) response "
                             "(`hex/tree/uplift/UpliftDRF.java` binomial-only)")
        X = fr.as_matrix(names)
        is_cat = np.array([fr.vec(n).is_categorical() for n in names])
        tvec = fr.vec(p.treatment_column)
        tv = tvec.data[:fr.nrow]
        n_na = int(torch.isnan(tv).sum())
        if n_na:
            raise ValueError(
                f"upliftdrf: treatment_column '{p.treatment_column}' has "
                f"{n_na} missing values; treatment assignment must be known "
                "for every row")
        uniq = torch.unique(tv).cpu().numpy()
        if not np.isin(uniq, (0.0, 1.0)).all():
            # the reference requires a 2-level categorical treatment
            # (`hex/tree/uplift/UpliftDRF.java` init checks)
            raise ValueError(
                f"upliftdrf: treatment_column '{p.treatment_column}' must be "
                f"binary 0/1 (2-level categorical); found values {uniq[:5]}")
        treat = torch.nan_to_num(tvec.data)
        y = torch.nan_to_num(y_dev)
        w = (~torch.isnan(y_dev)).to(torch.float32)
        if p.weights_column:
            w = w * torch.nan_to_num(fr.vec(p.weights_column).data)

        F = len(names)
        mtries = p.mtries if p.mtries and p.mtries > 0 else max(
            1, int(math.sqrt(F)))
        seed = _seed(p)
        # nbins_cats pinned to nbins: categoricals split ordinally here, so
        # a bin space wider than nbins only widens the (F, n_lv, B, 4)
        # histograms
        edges_np = compute_bin_edges(X, is_cat, p.nbins, seed=seed,
                                     nbins_cats=p.nbins)
        del X
        cfg = TreeConfig(
            ntrees=p.ntrees, max_depth=min(p.max_depth, 12),
            # small-data exact binning may widen the bins past p.nbins
            nbins=edges_np.shape[1] + 1,
            min_rows=p.min_rows, sample_rate=p.sample_rate, mtries=mtries,
            min_split_improvement=max(p.min_split_improvement, 1e-9),
            col_sample_rate_per_tree=p.col_sample_rate_per_tree,
            drf_mode=True)
        nedges_np = (~np.isnan(edges_np)).sum(axis=1).astype(np.int32)
        hist_groups, blk = plan_hist_groups(
            nedges_np, cfg.nbins + 1, cfg.block_rows,
            budget_bytes=hbm_budget_bytes(dev),
            n_lv_max=2 ** max(cfg.max_depth - 1, 0), nvals=4)
        cfg = dataclasses.replace(cfg, hist_groups=hist_groups,
                                  block_rows=blk)
        edges = torch.from_numpy(np.nan_to_num(edges_np, nan=np.inf)).to(dev)
        edge_ok = torch.from_numpy(~np.isnan(edges_np)).to(dev)
        Xb = BinnedView.build([fr.vec(n) for n in names], edges_np,
                              names=names).matrix
        div = _divergence(p.uplift_metric)
        keys = threefry.split(threefry.prng_key(seed), p.ntrees)
        Rl = Xb.shape[0]
        trees = []
        for key in keys:
            job.check_cancelled()
            if cfg.sample_rate < 1.0:
                s = (threefry.uniform(threefry.fold_in(key, 0), (Rl,), dev)
                     < _f32(cfg.sample_rate)).to(torch.float32)
            else:
                s = torch.ones((Rl,), dtype=torch.float32, device=dev)
            trees.append(_grow_uplift_tree(Xb, y, treat, w * s, edges,
                                           edge_ok, key, div, cfg))
            job.update(1.0 / max(p.ntrees, 1))
        forest = {k: torch.stack(t) for k, t in
                  zip(("feat", "thr", "gain", "val_t", "val_c"), zip(*trees))}

        output = ModelOutput()
        output.names = names
        output.domains = {n: fr.vec(n).domain for n in names}
        output.response_domain = list(resp_domain)
        output.model_category = "BinomialUplift"
        model = UpliftDRFModel(p, output, forest, cfg)
        raw = model.score0(fr.as_matrix(names))
        output.training_metrics = make_uplift_metrics(
            y_dev[:fr.nrow].cpu().numpy(), treat[:fr.nrow].cpu().numpy(),
            raw[:fr.nrow, 0].cpu().numpy(), p.auuc_nbins, p.auuc_type)
        return model
