"""GBM — gradient boosting on the shared tree engine
(``h2o_tpu/models/gbm.py``), bernoulli/gaussian slice with numeric and
categorical features.

The build: feature selection and response info, bin edges (quantile cuts
for numeric features, one cut per level for categorical ones) and the
int8/int16 binned view, the histogram plan (flat, or width-bucketed groups
for mixed bin widths), categorical set splits whenever a feature is
categorical, the intercept ``f0``, then the chunk loop over
``score_tree_interval`` — each chunk grows its trees on the device
(`engine.train_trees`) and scores the carried margin once. Options the slice
does not reproduce raise ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import time
import types
from dataclasses import dataclass

import numpy as np
import torch

from ..backend.memory import hbm_budget_bytes
from ..frame.chunks import BinnedView
from ..parallel.mesh import resolve_device
from .distributions import Bernoulli, Gaussian, get_distribution
from .metrics import make_metrics
from .model_base import Model, ModelBuilder, ModelOutput, Parameters
from .tree.binning import compute_bin_edges_cols
from .tree.engine import (TreeConfig, plan_hist_groups, predict_forest,
                          train_trees)

_FOREST_KEYS = ("feat", "thr", "nanL", "val", "gain", "catd")
#: the reference TreeConfig's JAX execution options: no bearing on the model
_JAX_ONLY_CFG = ("pipeline", "async_psum", "fused_score")


@dataclass
class GBMParameters(Parameters):
    """The reference's GBM fields and defaults (`hex/schemas/GBMV3`)."""

    ntrees: int = 50
    max_depth: int = 5
    min_rows: float = 10.0
    learn_rate: float = 0.1
    learn_rate_annealing: float = 1.0
    sample_rate: float = 1.0
    histogram_type: str = "AUTO"
    col_sample_rate: float = 1.0
    col_sample_rate_per_tree: float = 1.0
    col_sample_rate_change_per_level: float = 1.0
    max_abs_leafnode_pred: float = float("inf")
    nbins: int = 20
    nbins_cats: int = 1024
    min_split_improvement: float = 1e-5
    score_tree_interval: int = 0
    tweedie_power: float = 1.5
    quantile_alpha: float = 0.5
    huber_alpha: float = 0.9
    reg_lambda: float = 0.0
    custom_distribution_func: object = None
    monotone_constraints: dict = None
    interaction_constraints: list = None
    calibrate_model: bool = False
    calibration_frame: object = None


class GBMModel(Model):
    algo_name = "gbm"

    def __init__(self, params, output, forest, f0, dist, cfg: TreeConfig,
                 is_cat, edges=None, cat_nedges=None):
        super().__init__(params, output)
        self.forest = forest    # feat/thr/nanL/val/gain (T, N), catd (T, N, B)
        self.f0 = f0            # 0-d float32 tensor: initial link prediction
        self.dist = dist
        self.cfg = cfg
        self.is_cat = is_cat    # (F,) bool numpy: categorical features
        self.edges = edges      # (F, W) float32 bin edges of the training run
        # per-feature cut counts (categorical level -> bin map: bin =
        # min(level, n_edges)); only read when cfg.use_sets
        self.cat_nedges = cat_nedges

    def _set_args(self):
        """(catd, iscat, nedges) for `predict_forest` on the forest's device
        — Nones when this model has no categorical set splits."""
        if not self.cfg.use_sets:
            return None, None, None
        dev = self.forest["catd"].device
        return (self.forest["catd"],
                torch.from_numpy(np.asarray(self.is_cat, np.bool_)).to(dev),
                torch.from_numpy(np.asarray(self.cat_nedges, np.int64)).to(dev))

    @staticmethod
    def from_reference(forest, f0, edges, names, domains, cfg_fields, *,
                       category: str = "Binomial", response_domain=None,
                       device=None) -> "GBMModel":
        """Carry a JAX-trained GBM over: ``forest`` is the reference's forest
        dict (``feat, thr, nanL, val, gain, catd`` as numpy arrays in the
        ``gbm.py:_assemble_forest`` layout), ``f0`` its intercept, ``edges``
        its bin edges, ``names``/``domains`` the feature columns,
        ``cfg_fields`` its TreeConfig fields. The model's ``is_cat`` (the
        features with a domain) and ``cat_nedges`` (each edge row's cut
        count) follow from these as in the reference's build. The port model
        scores the same rows as the reference model."""
        cfg = TreeConfig(**{k: v for k, v in dict(cfg_fields).items()
                            if k not in _JAX_ONLY_CFG})
        cfg.check_supported()
        dev = resolve_device(device)
        edges = np.asarray(edges, np.float32)
        is_cat = np.array([domains.get(n) is not None for n in names])
        dtypes = dict(feat=np.int32, thr=np.float32, nanL=np.bool_,
                      val=np.float32, gain=np.float32, catd=np.float32)
        ft = {k: torch.from_numpy(np.array(forest[k], dtypes[k])).to(dev)
              for k in _FOREST_KEYS}
        output = ModelOutput()
        output.names = list(names)
        output.domains = {n: domains.get(n) for n in names}
        output.model_category = category
        if category == "Binomial":
            output.response_domain = list(response_domain or ["0", "1"])
            dist = Bernoulli()
        elif category == "Regression":
            dist = Gaussian()
        else:
            raise NotImplementedError(f"{category} models are not ported "
                                      f"yet (ROADMAP Queue 1 item 6)")
        params = GBMParameters(ntrees=ft["feat"].shape[0],
                               max_depth=cfg.max_depth)
        f0_t = torch.tensor(float(np.asarray(f0)), dtype=torch.float32,
                            device=dev)
        return GBMModel(params, output, ft, f0_t, dist, cfg, is_cat,
                        edges=edges, cat_nedges=(~np.isnan(edges)).sum(
                            axis=1).astype(np.int32))

    def _raw_f(self, X) -> torch.Tensor:
        fo = self.forest
        catd, iscat, nedges = self._set_args()
        return self.f0 + predict_forest(X, fo["feat"], fo["thr"], fo["nanL"],
                                        fo["val"], self.cfg.max_depth,
                                        catd=catd, iscat=iscat, nedges=nedges)

    def score0(self, X: torch.Tensor) -> torch.Tensor:
        f = self._raw_f(X)
        if self.output.model_category == "Regression":
            return self.dist.linkinv(f)
        p1 = self.dist.linkinv(f)
        # >= matches the MOJO reader and the reference's getPrediction
        label = (p1 >= 0.5).to(torch.float32)
        return torch.stack([label, 1 - p1, p1], dim=1)


def _metrics_raw(category, dist, f):
    """Carried link-scale margin -> score0 layout, for training metrics."""
    if category == "Regression":
        return dist.linkinv(f)
    p1 = dist.linkinv(f)
    return torch.stack([(p1 > 0.5).to(torch.float32), 1 - p1, p1], dim=1)


class GBM(ModelBuilder):
    algo_name = "gbm"
    _constant_response_check = True  # `hex/tree/SharedTree.init` check

    def _validate(self):
        super()._validate()
        p = self.params
        for bad, what in ((p.monotone_constraints, "monotone_constraints"),
                          (p.interaction_constraints, "interaction_constraints"),
                          (p.calibrate_model, "calibrate_model"),
                          (p.custom_distribution_func is not None,
                           "custom distributions")):
            if bad:
                raise NotImplementedError(
                    f"gbm: {what} is not ported yet (ROADMAP Queue 1 items "
                    f"5-6)")

    def _tree_config(self, nbins: int) -> TreeConfig:
        p = self.params
        return TreeConfig(
            ntrees=p.ntrees, max_depth=p.max_depth, nbins=nbins,
            min_rows=p.min_rows, learn_rate=p.learn_rate,
            reg_lambda=p.reg_lambda,
            min_split_improvement=p.min_split_improvement,
            sample_rate=p.sample_rate, col_sample_rate=p.col_sample_rate,
            col_sample_rate_per_tree=p.col_sample_rate_per_tree,
            col_sample_rate_change_per_level=p.col_sample_rate_change_per_level,
            max_abs_leafnode_pred=p.max_abs_leafnode_pred)

    def _distribution(self, category):
        name = (self.params.distribution or "AUTO").lower()
        if name == "auto":
            name = {"Binomial": "bernoulli", "Regression": "gaussian"}[category]
        return get_distribution(name)

    def _setup_build(self):
        """Design inputs, bin edges, binned view, intercept and tree config
        — everything the chunk loop needs, on the training frame's device."""
        p = self.params
        fr = p.training_frame
        dev = fr.device
        names = self.feature_names()
        y_dev, category, resp_domain = self.response_info()
        dist = self._distribution(category)
        is_cat = np.array([fr.vec(n).is_categorical() for n in names])
        y = torch.nan_to_num(y_dev)
        ymask = ~torch.isnan(y_dev)
        base = (torch.nan_to_num(fr.vec(p.weights_column).data)
                if p.weights_column else torch.ones_like(y))
        w = base * ymask.to(torch.float32)
        ym = torch.where(ymask, y, torch.nan)

        feat_vecs = [fr.vec(n) for n in names]
        edges_np = compute_bin_edges_cols(
            feat_vecs, is_cat, p.nbins, histogram_type=p.histogram_type,
            nbins_cats=int(p.nbins_cats or 1024))
        edges = torch.from_numpy(np.nan_to_num(edges_np, nan=np.inf)).to(dev)
        edge_ok = torch.from_numpy(~np.isnan(edges_np)).to(dev)
        Xb = BinnedView.build(feat_vecs, edges_np, names=names).matrix

        f0 = torch.nan_to_num(dist.init_f(y, w))
        # effective bin count follows the edge matrix: small-data exact
        # binning and nbins_cats may widen it past p.nbins
        cfg = self._tree_config(nbins=edges_np.shape[1] + 1)
        nedges_np = (~np.isnan(edges_np)).sum(axis=1).astype(np.int32)
        hist_groups, blk = plan_hist_groups(
            nedges_np, cfg.nbins + 1, cfg.block_rows,
            budget_bytes=hbm_budget_bytes(dev),
            n_lv_max=2 ** max(cfg.max_depth - 1, 0), nvals=3)
        # categorical SET splits whenever a feature is categorical
        cfg = dataclasses.replace(cfg, use_sets=bool(is_cat.any()),
                                  block_rows=blk, hist_groups=hist_groups)
        cfg.check_supported()
        return types.SimpleNamespace(
            names=names, category=category, resp_domain=resp_domain,
            dist=dist, w=w, y=y, ym=ym, edges_np=edges_np, edges=edges,
            edge_ok=edge_ok, Xb=Xb, f0=f0, cfg=cfg, is_cat=is_cat,
            nedges_np=nedges_np,
            iscat=torch.from_numpy(is_cat.astype(np.bool_)).to(dev),
            nedges=torch.from_numpy(nedges_np.astype(np.int64)).to(dev),
            f=f0.expand(y.shape).clone())

    def build_impl(self) -> GBMModel:
        s = self._setup_build()
        p, fr, dist, cfg = self.params, self.params.training_frame, s.dist, s.cfg
        anneal = float(p.learn_rate_annealing or 1.0)
        rates = torch.from_numpy(
            (anneal ** np.arange(p.ntrees)).astype(np.float32)).to(fr.device)
        interval = min(p.score_tree_interval or p.ntrees, p.ntrees)

        def grad_fn(y, f, w):
            return dist.gradient(y, f, w), dist.hessian(y, f, w)

        output = ModelOutput()
        output.names = s.names
        output.domains = {n: fr.vec(n).domain for n in s.names}
        output.response_domain = list(s.resp_domain) if s.resp_domain else None
        output.model_category = s.category
        f = s.f
        parts, history = [], []
        weights = s.w if p.weights_column else None
        for c0 in range(0, p.ntrees, interval):
            f, trees = train_trees(s.Xb, s.y, s.w, f, s.edges, s.edge_ok,
                                   rates[c0:c0 + interval], cfg, grad_fn,
                                   iscat=s.iscat, nedges=s.nedges)
            parts.append(trees)
            m = make_metrics(s.category, s.ym,
                             _metrics_raw(s.category, dist, f), weights)
            history.append({"timestamp": time.time(),
                            "number_of_trees": min(c0 + interval, p.ntrees),
                            "training_metrics": m})
        output.scoring_history = history
        output.training_metrics = history[-1]["training_metrics"]
        forest = {k: torch.cat([t[i] for t in parts])
                  for i, k in enumerate(_FOREST_KEYS)}
        model = GBMModel(p, output, forest, s.f0, dist, cfg, s.is_cat,
                         edges=s.edges_np, cat_nedges=s.nedges_np)
        if p.validation_frame is not None:
            output.validation_metrics = model.model_performance(
                p.validation_frame)
        return model
