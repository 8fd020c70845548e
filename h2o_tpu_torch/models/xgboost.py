"""XGBoost (``h2o_tpu/models/xgboost.py``): xgboost's parameter surface
mapped onto the shared tree engine and GLM.

``tree_method=hist`` semantics (global quantile bins, Newton leaves
-G/(H + lambda), the L1 soft threshold alpha) are what the tree engine
computes, so this builder maps parameters: xgboost's defaults (eta 0.3,
min_child_weight 1, lambda 1), its aliases, and ``reg_alpha`` into the
tree config. Boosters: ``gbtree`` (the GBM build), ``dart`` (each round
drops a random subset of the trees built so far, fits the new tree against
the rest and rescales, the weights baked into the stored leaves), and
``gblinear`` (the elastic-net GLM with xgboost's absolute penalties, by
coordinate descent on the raw features). ``tree_method`` and ``backend``
are accepted and ignored.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import threefry
from .gbm import (_FOREST_KEYS, GBM, GBMModel, GBMParameters,
                  _assemble_forest, _metrics_raw, _seed, _varimp)
from .glm import GLM, GLMParameters
from .metrics import make_metrics
from .model_base import ModelOutput
from .tree.engine import predict_forest, train_trees


@dataclass
class XGBoostParameters(GBMParameters):
    """`hex/tree/xgboost/XGBoostModel.XGBoostParameters` field names.

    xgboost's defaults are dataclass defaults; the xgboost-native spellings
    are aliases with a "not set" sentinel that, when set, overwrite their
    H2O-named twin and return to the sentinel, so re-running
    ``__post_init__`` (``dataclasses.replace``) changes nothing and an
    explicit H2O-named value is never overwritten."""

    learn_rate: float = 0.3   # xgboost default eta
    min_rows: float = 1.0     # xgboost default min_child_weight
    reg_lambda: float = 1.0   # xgboost default lambda
    reg_alpha: float = 0.0

    # DART
    rate_drop: float = 0.0
    skip_drop: float = 0.0
    one_drop: bool = False
    normalize_type: str = "tree"   # tree | forest

    # gblinear's coordinate-descent knobs: accepted, the GLM path ignores them
    feature_selector: str = "cyclic"
    top_k: int = 0
    updater: str | None = None

    # xgboost-native spellings; sentinel = "not set"
    n_estimators: int = 0          # ntrees
    eta: float = -1.0              # learn_rate
    min_child_weight: float = -1.0  # min_rows
    subsample: float = -1.0        # sample_rate
    colsample_bytree: float = -1.0  # col_sample_rate_per_tree
    colsample_bylevel: float = -1.0  # col_sample_rate
    max_bins: int = 0              # nbins
    gamma: float = -1.0            # min_split_improvement
    booster: str = "gbtree"
    tree_method: str = "hist"
    backend: str = "auto"

    def __post_init__(self):
        if self.n_estimators > 0:
            self.ntrees, self.n_estimators = self.n_estimators, 0
        if self.eta >= 0:
            self.learn_rate, self.eta = self.eta, -1.0
        if self.min_child_weight >= 0:
            self.min_rows, self.min_child_weight = self.min_child_weight, -1.0
        if self.subsample > 0:
            self.sample_rate, self.subsample = self.subsample, -1.0
        if self.colsample_bytree > 0:
            self.col_sample_rate_per_tree, self.colsample_bytree = \
                self.colsample_bytree, -1.0
        if self.colsample_bylevel > 0:
            self.col_sample_rate, self.colsample_bylevel = \
                self.colsample_bylevel, -1.0
        if self.max_bins > 0:
            self.nbins, self.max_bins = self.max_bins, 0
        if self.gamma >= 0:
            self.min_split_improvement, self.gamma = self.gamma, -1.0


class XGBoost(GBM):
    algo_name = "xgboost"

    def _tree_config(self, K, nbins):
        cfg = super()._tree_config(K, nbins)
        return dataclasses.replace(cfg, reg_alpha=self.params.reg_alpha)

    def build_impl(self, job):
        booster = (self.params.booster or "gbtree").lower()
        if booster == "dart":
            model = self._build_dart(job)
        elif booster == "gblinear":
            model = self._build_gblinear(job)
        else:
            model = super().build_impl(job)
        # a GBM or GLM model that reports "xgboost" as its algo, as the
        # reference does
        model.algo_override = "xgboost"
        return model

    def _build_gblinear(self, job):
        """xgboost's L1/L2-penalised linear booster as the elastic-net GLM
        on the raw features. xgboost's penalties are absolute, so
        alpha * lambda * nrow = reg_alpha and (1 - alpha) * lambda * nrow =
        reg_lambda fix (lambda, alpha). A multinomial response takes the
        multinomial GLM (IRLSM), as in the reference."""
        p = self.params
        fr = p.training_frame
        nrow = max(int(fr.nrow), 1)
        l1, l2 = max(p.reg_alpha, 0.0), max(p.reg_lambda, 0.0)
        tot = l1 + l2
        _, category, _ = self.response_info()
        family = {"Binomial": "binomial", "Multinomial": "multinomial",
                  "Regression": "gaussian"}[category]
        gp = GLMParameters(
            training_frame=fr, response_column=p.response_column,
            validation_frame=p.validation_frame,
            weights_column=p.weights_column, offset_column=p.offset_column,
            ignored_columns=list(p.ignored_columns or []),
            family=family, alpha=(l1 / tot) if tot > 0 else 0.0,
            lambda_=tot / nrow,
            solver="COORDINATE_DESCENT" if category != "Multinomial"
            else "IRLSM",
            standardize=False, max_iterations=max(p.ntrees, 50), seed=p.seed)
        model = GLM(gp).build_impl(job)
        model.booster = "gblinear"
        return model

    def _build_dart(self, job):
        """DART (Rashmi & Gilad-Bachrach 2015, xgboost ``booster=dart``).
        Each round after the first, unless ``skip_drop`` skips it, drops
        every earlier tree with probability ``rate_drop`` (at least one
        under ``one_drop``), draws from numpy ``default_rng(seed)`` in the
        reference's order. The new tree is built at rate 1 against the
        margin without the dropped trees; with k dropped, ``normalize_type``
        "tree" gives it weight lr / (k + lr) and scales the dropped by
        k / (k + lr), "forest" lr / (1 + lr) and 1 / (1 + lr). The dropped
        trees' sum is one `predict_forest` over the raw features with
        their weights in the leaves. A multinomial round's K class trees
        share one weight. The weights are baked into the stored leaves,
        then ``max_abs_leafnode_pred`` caps them. The model's
        ``dropped_trees`` lists, for each round this build trained, the
        earlier tree indices it dropped.

        A checkpoint continuation restarts the dropout trajectory over the
        prior's baked trees, as the reference's does: they enter with
        weight 1.0, the draws start afresh from the seed at round
        ``n_prior``, and the carried sum is the prior's replayed margin.
        ``export_checkpoints_dir`` gets the forest with its current weights
        baked at every scoring interval. DART writes no auto-recovery
        state, as in the reference: a killed DART job replays from the
        start."""
        s = self._setup_build()
        p = self.params
        K = s.K
        rng = np.random.default_rng(_seed(p))
        cfg = s.cfg
        f0 = s.f0
        fr = p.training_frame
        dev = fr.device
        # the dropped trees are scored over raw thresholds
        X = torch.stack([fr.vec(n).data for n in s.names], dim=1)
        parts, weights = [], []
        prior = None
        if p.checkpoint is not None:
            prior = self._resolve_checkpoint(p.checkpoint)
            if p.ntrees <= prior.ntrees:
                raise ValueError(
                    f"checkpoint model already has {prior.ntrees} trees; "
                    f"ntrees must exceed that (got {p.ntrees})")
            for fld, ours, theirs in (
                    ("max_depth", p.max_depth, prior.cfg.max_depth),
                    ("nbins", p.nbins, getattr(prior.params, "nbins",
                                               prior.cfg.nbins)),
                    ("nclasses", K, prior.cfg.nclass),
                    ("drf_mode", False, prior.cfg.drf_mode)):
                if ours != theirs:
                    raise ValueError(
                        f"checkpoint incompatible: {fld} differs "
                        f"(checkpoint={theirs}, request={ours})")
            p = self.params = dataclasses.replace(p, checkpoint=prior.key)
            if cfg.use_sets != prior.cfg.use_sets:
                cfg = dataclasses.replace(cfg, use_sets=prior.cfg.use_sets)
            pf = {k: v.to(dev) for k, v in prior.forest.items()}
            for t in range(prior.ntrees):
                parts.append(tuple(pf[k][t:t + 1] for k in _FOREST_KEYS))
                weights.append(1.0)
            f0 = prior.f0.to(dev)
        # trees build at rate 1 and uncapped: DART owns the scaling
        cfg1 = dataclasses.replace(cfg, ntrees=1, learn_rate=1.0,
                                   max_abs_leafnode_pred=float("inf"))
        keys = threefry.split(threefry.prng_key(_seed(p)), p.ntrees)
        one_rate = torch.ones((1,), dtype=torch.float32, device=dev)
        grad_fn = self._make_grad_fn(s.dist, K)
        lr = float(p.learn_rate)
        f0b = f0[:, None] if K > 1 else f0
        S = torch.zeros_like(s.f)   # sum of w_i * raw_i over the built trees
        if prior is not None:
            fprev = prior._raw_f(X.to(prior.forest["feat"].device)).to(dev)
            S = (fprev.T if K > 1 else fprev).to(torch.float32) - f0b
        history, stop_series = [], []
        drops = []      # per round this build trains, the trees it dropped
        interval = min(p.score_tree_interval or p.ntrees, p.ntrees)
        n_prior = last_scored = len(parts)
        use_sets = cfg.use_sets
        output = ModelOutput()
        output.names = s.names
        output.domains = {n: fr.vec(n).domain for n in s.names}
        output.response_domain = (list(s.resp_domain) if s.resp_domain
                                  else None)
        output.model_category = s.category

        def dropped_sum(idxs):
            """sum over D of w_i * raw_i, one forest evaluation with each
            weight multiplied into its tree's leaves; (K, R) for K > 1."""
            cat = [torch.cat([parts[i][j] for i in idxs]) for j in range(3)]
            val = torch.cat([parts[i][3] * float(np.float32(weights[i]))
                             for i in idxs])
            catd = (torch.cat([parts[i][5] for i in idxs]) if use_sets
                    else None)
            out = predict_forest(X, *cat, val, cfg.max_depth, catd=catd,
                                 iscat=s.iscat if use_sets else None,
                                 nedges=s.nedges if use_sets else None)
            return out.T if K > 1 else out

        def bake():
            """Each tree's weight multiplied into its leaves, then the
            ``max_abs_leafnode_pred`` cap on the stored leaf."""
            cap = float(p.max_abs_leafnode_pred or float("inf"))
            baked = []
            for tree, wgt in zip(parts, weights):
                v = tree[3] * float(np.float32(wgt))
                if np.isfinite(cap):
                    v = torch.clamp(v, -cap, cap)
                baked.append(tree[:3] + (v,) + tree[4:])
            return baked

        for t in range(n_prior, p.ntrees):
            job.check_cancelled()
            if history and job.time_exceeded():
                break   # keep the partial forest
            dropped: list[int] = []
            if t > 0 and rng.random() >= p.skip_drop:
                dropped = [i for i in range(t) if rng.random() < p.rate_drop]
                if not dropped and p.one_drop:
                    dropped = [int(rng.integers(t))]
            drops.append(dropped)
            drop_raw = dropped_sum(dropped) if dropped else None
            margin = f0b + S - drop_raw if dropped else f0b + S
            f_out, _os, _oc, trees = train_trees(
                s.Xb, s.y, s.w, margin, s.edges, s.edge_ok, keys[t:t + 1],
                one_rate, cfg1, grad_fn, iscat=s.iscat, nedges=s.nedges,
                mono=s.mono, imat=s.imat)
            raw_new = f_out - margin
            k = len(dropped)
            if k == 0:
                w_new, scale_dropped = lr, 1.0
            elif (p.normalize_type or "tree").lower() == "forest":
                w_new, scale_dropped = lr / (1.0 + lr), 1.0 / (1.0 + lr)
            else:
                w_new, scale_dropped = lr / (k + lr), k / (k + lr)
            if dropped:
                S = S + (scale_dropped - 1.0) * drop_raw
                for i in dropped:
                    weights[i] *= scale_dropped
            S = S + w_new * raw_new
            parts.append(trees)
            weights.append(w_new)
            if (t + 1) % interval == 0 or t + 1 == p.ntrees:
                m = make_metrics(
                    s.category, s.ym,
                    _metrics_raw(s.category, s.dist, f0b + S, False, t + 1),
                    s.w if p.weights_column else None, auc_type=p.auc_type,
                    domain=s.resp_domain)
                history.append({"timestamp": time.time(),
                                "number_of_trees": t + 1,
                                "training_metrics": m})
                job.update((t + 1 - last_scored) / p.ntrees)
                last_scored = t + 1
                if p.export_checkpoints_dir:
                    self._export_snapshot(p, output, bake(), f0, s.dist, cfg,
                                          s, t + 1, m)
                if self._should_stop(m, stop_series):
                    break

        forest = _assemble_forest(bake())
        output.scoring_history = history
        output.training_metrics = history[-1]["training_metrics"]
        output.variable_importances = _varimp(forest, s.names)
        model = GBMModel(p, output, forest, f0, s.dist, cfg, s.is_cat,
                         edges=s.edges_np, cat_nedges=s.nedges_np)
        model.dropped_trees = drops
        if p.calibrate_model:
            # the leaves are baked: the calibrator sees the final margin
            model.calib = self._fit_calibration(model, s.category)
        if p.validation_frame is not None:
            output.validation_metrics = model.model_performance(
                p.validation_frame)
        return model
