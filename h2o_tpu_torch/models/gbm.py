"""GBM — gradient boosting on the shared tree engine
(``h2o_tpu/models/gbm.py``): every built-in distribution (laplace, quantile
and huber with their quantile leaves), numeric and categorical features,
row and column sampling, monotone and interaction constraints, early
stopping and variable importances; and the engine's DRF mode that `drf.py`
builds on.

The build: feature selection and response info, bin edges (quantile,
uniform or random cuts for numeric features, one cut per level for
categorical ones) and the int8/int16 binned view, the histogram plan (flat,
or width-bucketed groups for mixed bin widths), categorical set splits
whenever a feature is categorical, the intercept ``f0`` (class priors for
multinomial, zeros for DRF), the tree keys ``split(PRNGKey(seed), ntrees)``
(seed -1 -> 1234), then the chunk loop over ``score_tree_interval`` — each
chunk grows its trees on the device (`engine.train_trees`) and scores once:
the carried margin, or for a row-sampled DRF the out-of-bag outputs — and
stops early when ``stopping_rounds`` scores show no gain, or at a chunk
boundary once ``max_runtime_secs`` has passed.

Checkpoint continuation (``checkpoint=`` a model or its key,
`hex/tree/SharedTree.java:146,243,470`): the prior's parameters are
checked, its forest is replayed over the binned view in bin-code space
(``GBMModel._raw_f_codes``: GBM splits sit on bin edges, so routing by
codes is exact; a prior whose thresholds are off the current grid replays
over the raw columns instead), and boosting continues with the tree keys
and annealed rates of trees ``n_prior..ntrees``. A continued DRF reports
in-bag metrics (the prior trees' bags are not known). At every chunk
boundary a build may write a snapshot model to ``export_checkpoints_dir``
and offers its exact carried state (margin, trees, OOB sums, history) to
auto-recovery (``model_base._recovery_tick``); the ``train.gbm.chunk``
failpoint sits at the top of each chunk.
Options the port does not reproduce raise ``NotImplementedError`` naming the
ROADMAP item.
"""

from __future__ import annotations

import copy
import dataclasses
import time
import types
from dataclasses import dataclass

import numpy as np
import torch

from ..backend.memory import hbm_budget_bytes
from ..frame.chunks import BinnedView
from ..frame.frame import Frame
from ..frame.vec import Vec
from ..parallel.mesh import resolve_device
from ..utils import failpoints, threefry
from ..utils.log import info
from .distributions import (Bernoulli, Gaussian, Multinomial, _exp,
                            _sigmoid, get_distribution)
from .metrics import make_metrics
from .model_base import (Model, ModelBuilder, ModelOutput, Parameters,
                         _columns_frame)
from .tree.binning import compute_bin_edges_cols
from .tree.engine import (TreeConfig, forest_covers, leaf_nodes,
                          plan_hist_groups, predict_forest, train_trees)

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
                 is_cat, edges=None, cat_nedges=None, key=None):
        super().__init__(params, output, key=key)
        self.forest = forest    # feat/thr/nanL/val/gain (T,[K,]N), catd (...,B)
        self.f0 = f0            # float32 tensor: 0-d, or (K,) per class
        self.dist = dist
        self.cfg = cfg
        self.is_cat = is_cat    # (F,) bool numpy: categorical features
        self.edges = edges      # (F, W) float32 bin edges of the training run
        # per-feature cut counts (categorical level -> bin map: bin =
        # min(level, n_edges)); only read when cfg.use_sets
        self.cat_nedges = cat_nedges

    calib = None    # (a, b) Platt coefficients when calibrate_model was set

    @property
    def ntrees(self) -> int:
        return int(self.forest["feat"].shape[0])

    def predict(self, fr):
        out = super().predict(fr)
        if self.calib is not None:
            # `CalibrationHelper.postProcessPredictions`: cal_p columns
            a, b = self.calib
            pc = torch.clamp(out.vec(2).data, 1e-6, 1 - 1e-6)
            cal = _sigmoid(a * torch.log(pc / (1 - pc)) + b)
            out.add("cal_p0", Vec(1.0 - cal, fr.nrow))
            out.add("cal_p1", Vec(cal, fr.nrow))
        return out

    def _set_args(self):
        """(catd, iscat, nedges) for `predict_forest` on the forest's device
        — Nones when this model has no categorical set splits."""
        if not self.cfg.use_sets:
            return None, None, None
        dev = self.forest["catd"].device
        return (self.forest["catd"],
                torch.from_numpy(np.asarray(self.is_cat, np.bool_)).to(dev),
                torch.from_numpy(np.asarray(self.cat_nedges, np.int64)).to(dev))

    @classmethod
    def from_reference(cls, forest, f0, edges, names, domains, cfg_fields, *,
                       category: str = "Binomial", response_domain=None,
                       cat_nedges=None, response_column=None,
                       device=None) -> "GBMModel":
        """Carry a JAX-trained tree model over: ``forest`` is the
        reference's forest dict (``feat, thr, nanL, val, gain, catd`` as
        numpy arrays in the ``gbm.py:_assemble_forest`` layout, (T, K, N) for
        a multinomial forest, with ``cover`` when the reference computed
        its node covers), ``f0`` its intercept (scalar, or (K,)),
        ``edges`` its bin edges, ``names``/``domains`` the feature columns,
        ``cfg_fields`` its TreeConfig fields (``drf_mode`` marks a DRF or
        XRT forest). The model's ``is_cat`` (the features with a domain) and
        ``cat_nedges`` (each edge row's cut count) follow from these as in
        the reference's build; ``response_column`` names the response (a
        MOJO's last column). A reference model keeps no edges: with
        ``edges`` None, ``cat_nedges`` comes from the reference model's own
        (the model scores; a checkpoint continuation from it takes the raw
        replay). The port model scores the same rows as the reference
        model."""
        cfg = TreeConfig(**{k: v for k, v in dict(cfg_fields).items()
                            if k not in _JAX_ONLY_CFG})
        cfg.check_supported()
        dev = resolve_device(device)
        if edges is not None:
            edges = np.asarray(edges, np.float32)
            cat_nedges = (~np.isnan(edges)).sum(axis=1).astype(np.int32)
        elif cat_nedges is not None:
            cat_nedges = np.asarray(cat_nedges, np.int32)
        is_cat = np.array([domains.get(n) is not None for n in names])
        dtypes = dict(feat=np.int32, thr=np.float32, nanL=np.bool_,
                      val=np.float32, gain=np.float32, catd=np.float32)
        ft = {k: torch.from_numpy(np.array(forest[k], dtypes[k])).to(dev)
              for k in _FOREST_KEYS}
        if "cover" in forest:   # the node covers, once SHAP computed them
            ft["cover"] = torch.from_numpy(
                np.array(forest["cover"], np.float32)).to(dev)
        output = ModelOutput()
        output.names = list(names)
        output.domains = {n: domains.get(n) for n in names}
        output.model_category = category
        if category == "Binomial":
            output.response_domain = list(response_domain or ["0", "1"])
        elif category == "Multinomial":
            output.response_domain = list(response_domain)
        # DRF leaves are response means: the reference's DRF scores through
        # Gaussian's identity link
        dist = (Gaussian() if cfg.drf_mode else
                {"Binomial": Bernoulli, "Regression": Gaussian,
                 "Multinomial": Multinomial}[category]())
        params = GBMParameters(ntrees=ft["feat"].shape[0],
                               max_depth=cfg.max_depth,
                               response_column=response_column)
        f0_t = torch.from_numpy(np.array(f0, np.float32)).to(dev)
        return cls(params, output, ft, f0_t, dist, cfg, is_cat, edges=edges,
                   cat_nedges=cat_nedges)

    def _raw_f(self, X) -> torch.Tensor:
        """f0 plus the summed trees: (R,), or (R, K); DRF averages them."""
        fo = self.forest
        catd, iscat, nedges = self._set_args()
        s = predict_forest(X, fo["feat"], fo["thr"], fo["nanL"], fo["val"],
                           self.cfg.max_depth, catd=catd, iscat=iscat,
                           nedges=nedges)
        if self.cfg.drf_mode:
            return self.f0 + s / max(self.ntrees, 1)
        return self.f0 + s

    #: rows of one code-space replay block: bounds the float32 copy of
    #: the binned codes, never a whole (R, F) matrix
    _CODE_SCORE_CELLS = 1 << 26

    def _raw_f_codes(self, Xb, thr_codes: np.ndarray, na_code: int):
        """The forest's ``_raw_f`` over the BINNED view, in bin-code space
        — the checkpoint replay that never stacks the raw float32 matrix.
        Codes are ``#edges < x``, so for a threshold that is an edge value
        (GBM splits only at edges) ``x > thr <=> code(x) > #edges < thr``.
        Per row block the codes become float32 with the NA code as NaN and
        `predict_forest` runs with the code-space thresholds: every routing
        decision, and so the sum, equals the raw traversal's."""
        fo = self.forest
        catd, iscat, nedges = self._set_args()
        thr = torch.from_numpy(np.asarray(thr_codes, np.float32)).to(
            Xb.device)
        step = max(8192, self._CODE_SCORE_CELLS // max(Xb.shape[1], 1))
        parts = []
        for r0 in range(0, Xb.shape[0], step):
            bi = Xb[r0:r0 + step].to(torch.int32)
            xf = torch.where(bi == na_code, torch.nan, bi.to(torch.float32))
            parts.append(predict_forest(
                xf, fo["feat"], thr, fo["nanL"], fo["val"],
                self.cfg.max_depth, catd=catd, iscat=iscat, nedges=nedges))
        s = parts[0] if len(parts) == 1 else torch.cat(parts)
        if self.cfg.drf_mode:
            return self.f0 + s / max(self.ntrees, 1)
        return self.f0 + s

    def score0(self, X: torch.Tensor) -> torch.Tensor:
        cat = self.output.model_category
        f = self._raw_f(X)
        if cat == "Regression":
            return self.dist.linkinv(f)
        if cat == "Binomial":
            p1 = (torch.clamp(f, 0.0, 1.0) if self.cfg.drf_mode
                  else self.dist.linkinv(f))
            # >= matches the MOJO reader and the reference's getPrediction
            label = (p1 >= 0.5).to(torch.float32)
            return torch.stack([label, 1 - p1, p1], dim=1)
        if self.cfg.drf_mode:
            p = torch.clamp(f, 1e-9, 1.0)
            p = p / torch.sum(p, dim=1, keepdim=True)
        else:
            p = _softmax(f, dim=1)
        label = torch.argmax(p, dim=1).to(torch.float32)
        return torch.cat([label[:, None], p], dim=1)

    # -- TreeSHAP, leaf assignments, staged predictions (reference
    #    ``gbm.py:289-440``; `Model.scoreContributions`,
    #    `scoreLeafNodeAssignment`, `scoreStagedPredictions`) ------------------
    def _rows(self, fr) -> torch.Tensor:
        """The frame's (nrow, F) training-order matrix on its device."""
        return self.adapt_frame(fr)[: fr.nrow]

    def set_split_arrays_np(self):
        """(catd, iscat, nedges, cards) on the host for TreeSHAP's
        recursion and the MOJO and POJO writers (reference ``gbm.py:188``),
        all None without set splits; ``cards`` is each feature's domain
        size (0 for a numeric one)."""
        if not self.cfg.use_sets or "catd" not in self.forest:
            return None, None, None, None
        cards = np.array([len(self.output.domains.get(n) or [])
                          for n in self.output.names], dtype=np.int64)
        return (self.forest["catd"].cpu().numpy(),
                np.asarray(self.is_cat, np.bool_),
                np.asarray(self.cat_nedges, dtype=np.int64), cards)

    def predict_contributions(self, fr) -> Frame:
        """Per-feature SHAP contributions and ``BiasTerm``, on the link
        scale: each row sums to the raw prediction. Regression and
        binomial models only, as in the reference; a DRF's trees are
        scaled by 1/ntrees."""
        from .tree.shap import tree_shap

        if self.output.model_category not in ("Regression", "Binomial"):
            raise ValueError("predict_contributions supports regression and "
                             "binomial tree models only (as in the "
                             "reference)")
        self._ensure_covers()
        fo = {k: self.forest[k].cpu().numpy()
              for k in ("feat", "thr", "nanL", "val", "cover")}
        catd, iscat, nedges, _ = self.set_split_arrays_np()
        scale = 1.0 / max(self.ntrees, 1) if self.cfg.drf_mode else 1.0
        phi = tree_shap(self._rows(fr), fo["feat"], fo["thr"], fo["nanL"],
                        fo["val"], fo["cover"], bias0=float(self.f0),
                        scale=scale, depth=self.cfg.max_depth, catd=catd,
                        iscat=iscat, nedges=nedges)
        return _columns_frame(list(self.output.names) + ["BiasTerm"],
                              phi.to(torch.float32))

    def _ensure_covers(self) -> None:
        """Each node's weighted count of training rows, computed once, on
        first use, from the attached training frame (reference
        ``gbm.py:311``): one routing pass per tree. Rows with an NA
        response and padding rows weigh 0, as in training."""
        if "cover" in self.forest:
            return
        p = self.params
        fr = p.training_frame
        if fr is None:
            raise ValueError(
                "model has no stored node covers and no attached training "
                "frame to compute them from (model was imported without node "
                "weights)")
        X = self.adapt_frame(fr)
        if p.weights_column:
            w = torch.nan_to_num(fr.vec(p.weights_column).data)
        else:
            w = torch.ones(X.shape[0], dtype=torch.float32, device=X.device)
        w = w * (~torch.isnan(fr.vec(p.response_column).data)).to(w.dtype)
        catd, iscat, nedges = self._set_args()
        fo = self.forest
        self.forest["cover"] = forest_covers(
            X, w, fo["feat"], fo["thr"], fo["nanL"], self.cfg.max_depth,
            catd=catd, iscat=iscat, nedges=nedges)

    def _leaf_nodes(self, X: torch.Tensor) -> torch.Tensor:
        """(R, T[*K]) final heap node of each row in each tree, routed on
        X's device."""
        catd, iscat, nedges = self._set_args()
        fo = self.forest
        return leaf_nodes(X, fo["feat"], fo["thr"], fo["nanL"],
                          self.cfg.max_depth, catd=catd, iscat=iscat,
                          nedges=nedges)

    def predict_leaf_node_assignment(self, fr, type: str = "Path"):
        """Each row's leaf in each tree: the root-to-leaf path as an L/R
        string, a categorical column whose domain is the paths present,
        sorted (``type="Path"``), or the heap node id (``"Node_ID"``).
        Columns ``T<t>``, or ``T<t>.C<class>`` for a multinomial forest."""
        nodes = self._leaf_nodes(self._rows(fr))
        feat = self.forest["feat"]
        multi = feat.dim() == 3
        K = feat.shape[1] if multi else 1
        dom = self.output.response_domain or [str(i) for i in range(K)]
        names = [f"T{t + 1}" if not multi else f"T{t + 1}.C{dom[k]}"
                 for t in range(feat.shape[0]) for k in range(K)]
        if type == "Node_ID":
            return _columns_frame(names, nodes.to(torch.float32))
        codes, domains = torch.empty_like(nodes, dtype=torch.float32), []
        for i in range(len(names)):
            uniq = [int(u) for u in torch.unique(nodes[:, i]).cpu()]
            paths = {u: _heap_path(u) for u in uniq}
            domain = sorted(set(paths.values()))
            code = {s: j for j, s in enumerate(domain)}
            lut = torch.zeros(feat.shape[-1], dtype=torch.float32)
            for u in uniq:
                lut[u] = code[paths[u]]
            codes[:, i] = lut.to(nodes.device)[nodes[:, i]]
            domains.append(domain)
        out = _columns_frame(names, codes)
        return Frame(names, [v.astype_cat(d)
                             for v, d in zip(out.vecs, domains)])

    def staged_predict_proba(self, fr):
        """The class-1 probability (binomial) or the prediction
        (regression) after each tree, ``T1..T<ntrees>``: the leaf values
        summed tree by tree in float32; a DRF's running mean in float64,
        clipped to [0, 1] for a binomial forest."""
        if self.output.model_category not in ("Regression", "Binomial"):
            raise ValueError("staged predictions support regression and "
                             "binomial models only")
        nodes = self._leaf_nodes(self._rows(fr))
        val = self.forest["val"]
        T = val.shape[0]
        cum = torch.zeros(nodes.shape[0], dtype=torch.float32,
                          device=nodes.device)
        stages = []
        for t in range(T):
            cum = cum + val[t][nodes[:, t]]
            if self.cfg.drf_mode:
                f = float(self.f0) + cum.double() / (t + 1)
                if self.output.model_category == "Binomial":
                    stages.append(torch.clamp(f, 0.0, 1.0).to(torch.float32))
                else:
                    stages.append(self.dist.linkinv(f.to(torch.float32)))
            else:
                stages.append(self.dist.linkinv(cum + float(self.f0)))
        return _columns_frame([f"T{t + 1}" for t in range(T)],
                              torch.stack(stages, dim=1))


def _softmax(f, dim: int) -> torch.Tensor:
    """``jax.nn.softmax``'s formula, so both packages round alike; the exp
    and the class sum in float64, each rounded once, so the card and the
    CPU round alike too."""
    e = _exp(f - torch.amax(f, dim=dim, keepdim=True))
    return e / e.double().sum(dim=dim, keepdim=True).to(e.dtype)


def _metrics_raw(category, dist, f, drf_mode: bool, ntrees: int):
    """Carried link-scale margin -> score0 layout, for training metrics.
    DRF carries the sum of its trees' leaf means: the prediction is their
    average."""
    nt = float(max(ntrees, 1))
    if category == "Regression":
        return f / nt if drf_mode else dist.linkinv(f)
    if category == "Binomial":
        p1 = torch.clamp(f / nt, 0, 1) if drf_mode else dist.linkinv(f)
        return torch.stack([(p1 > 0.5).to(torch.float32), 1 - p1, p1], dim=1)
    if drf_mode:
        p = torch.clamp(f.T / nt, 1e-9, 1.0)
        p = p / torch.sum(p, dim=1, keepdim=True)
    else:
        p = _softmax(f, dim=0).T
    label = torch.argmax(p, dim=1).to(torch.float32)
    return torch.cat([label[:, None], p], dim=1)


def _oob_metrics(category, osum, ocnt, y, ymask, w, auc_type="AUTO",
                 domain=None):
    """Metrics over the out-of-bag outputs: rows never out of bag (tiny
    forests) are left out, like the reference's OOB scorer. None when no
    row was."""
    seen = ocnt > 0
    if not bool((seen & ymask).any()):
        return None
    cnt = torch.clamp(ocnt, min=1.0)
    ym = torch.where(ymask & seen, y, torch.nan)
    if category == "Regression":
        raw = osum / cnt
    elif category == "Binomial":
        p1 = torch.clamp(osum / cnt, 0.0, 1.0)
        raw = torch.stack([(p1 > 0.5).to(torch.float32), 1 - p1, p1], dim=1)
    else:  # per-class sums (K, R)
        p = torch.clamp(osum / cnt[None, :], 1e-9, 1.0).T
        p = p / torch.sum(p, dim=1, keepdim=True)
        label = torch.argmax(p, dim=1).to(torch.float32)
        raw = torch.cat([label[:, None], p], dim=1)
    return make_metrics(category, ym, raw, w, auc_type=auc_type,
                        domain=domain)


class GBM(ModelBuilder):
    algo_name = "gbm"
    drf_mode = False
    # the reference's tree builders take an offset column, drop it from
    # the features (`model_base.py:373,386`) and never read it; XGBoost's
    # gblinear passes it to its GLM. Reproduced on purpose: H2O-3's GBM
    # fits offsets (ROADMAP Queue 3 item 19)
    model_class = GBMModel
    _constant_response_check = True  # `hex/tree/SharedTree.init` check

    def _tree_config(self, K: int, nbins: int) -> TreeConfig:
        p = self.params
        if p.monotone_constraints and K > 1:
            raise ValueError("monotone_constraints are not supported for "
                             "multinomial models (reference restriction)")
        return TreeConfig(
            use_monotone=bool(p.monotone_constraints),
            use_interaction=bool(p.interaction_constraints),
            ntrees=p.ntrees, max_depth=p.max_depth, nbins=nbins,
            min_rows=p.min_rows, learn_rate=p.learn_rate,
            reg_lambda=p.reg_lambda,
            min_split_improvement=p.min_split_improvement,
            sample_rate=p.sample_rate, col_sample_rate=p.col_sample_rate,
            col_sample_rate_per_tree=p.col_sample_rate_per_tree,
            col_sample_rate_change_per_level=p.col_sample_rate_change_per_level,
            max_abs_leafnode_pred=p.max_abs_leafnode_pred,
            drf_mode=self.drf_mode, nclass=K)

    def _distribution(self, category):
        if self.drf_mode:
            return Gaussian()  # DRF leaves = per-leaf response means
        p = self.params
        name = (p.distribution or "AUTO").lower()
        if name == "custom":
            if p.custom_distribution_func is None:
                raise ValueError("distribution='custom' requires "
                                 "custom_distribution_func")
            return p.custom_distribution_func
        if name == "auto":
            name = {"Binomial": "bernoulli", "Multinomial": "multinomial",
                    "Regression": "gaussian"}[category]
        return get_distribution(name, tweedie_power=p.tweedie_power,
                                quantile_alpha=p.quantile_alpha,
                                huber_alpha=p.huber_alpha)

    def _make_grad_fn(self, dist, K: int):
        """(y, f, w) -> (g, h), the reference's ``_make_grad_fn``: DRF
        trees fit at f = 0 (g = -w y, h = w: leaf = weighted mean of y, or
        per class of the class indicator); multinomial GBM takes the softmax
        over the classes of the (K, Rl) margin."""
        if K == 1:
            if self.drf_mode:
                return lambda y, f, w: (-w * y, w)
            return lambda y, f, w: (dist.gradient(y, f, w),
                                    dist.hessian(y, f, w))

        def grad(y, f, w):
            y1h = (y[None, :] == torch.arange(K, device=y.device)[:, None]
                   ).to(torch.float32)
            if self.drf_mode:
                return -w * y1h, w.expand(y1h.shape)
            p = _softmax(f, dim=0)
            return (w * (p - y1h),
                    torch.clamp(w * p * (1 - p), min=1e-10))
        return grad

    def _init_f(self, K: int, dist, y, w) -> torch.Tensor:
        """The intercept: zeros for DRF, log class priors for multinomial,
        the distribution's intercept-only fit otherwise."""
        dev = y.device
        if self.drf_mode:
            return torch.zeros((K,) if K > 1 else (), dtype=torch.float32,
                               device=dev)
        if K > 1:
            counts = torch.stack([torch.sum(w * (y == k)) for k in range(K)])
            pri = counts / torch.clamp(torch.sum(counts), min=1e-10)
            return torch.log(torch.clamp(pri, min=1e-10))
        return torch.nan_to_num(dist.init_f(y, w))

    def _setup_build(self):
        """Design inputs, bin edges, binned view, intercept and tree config
        — everything the chunk loop needs, on the training frame's device."""
        p = self.params
        fr = p.training_frame
        dev = fr.device
        names = self.feature_names()
        y_dev, category, resp_domain = self.response_info()
        K = len(resp_domain) if category == "Multinomial" else 1
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
            feat_vecs, is_cat, p.nbins, seed=_seed(p),
            histogram_type=p.histogram_type,
            nbins_top_level=int(getattr(p, "nbins_top_level", 1024) or 1024),
            nbins_cats=int(p.nbins_cats or 1024))
        edges = torch.from_numpy(np.nan_to_num(edges_np, nan=np.inf)).to(dev)
        mono_np = np.zeros(len(names), dtype=np.float32)
        for col, d in (p.monotone_constraints or {}).items():
            if col not in names:
                raise ValueError(f"monotone_constraints column '{col}' is not "
                                 f"a feature")
            if fr.vec(col).is_categorical():
                raise ValueError(f"monotone_constraints on categorical column "
                                 f"'{col}' (numeric only, as in the reference)")
            mono_np[names.index(col)] = float(np.sign(d))
        imat_np = _interaction_matrix(names, p.interaction_constraints)
        edge_ok = torch.from_numpy(~np.isnan(edges_np)).to(dev)
        Xb = BinnedView.build(feat_vecs, edges_np, names=names).matrix

        f0 = self._init_f(K, dist, y, w)
        # effective bin count follows the edge matrix: small-data exact
        # binning and nbins_cats may widen it past p.nbins
        cfg = self._tree_config(K, nbins=edges_np.shape[1] + 1)
        nedges_np = (~np.isnan(edges_np)).sum(axis=1).astype(np.int32)
        hist_groups, blk = plan_hist_groups(
            nedges_np, cfg.nbins + 1, cfg.block_rows,
            budget_bytes=hbm_budget_bytes(dev),
            n_lv_max=2 ** max(cfg.max_depth - 1, 0), nvals=3)
        # categorical SET splits whenever a feature is categorical; RuleFit's
        # forests opt out (its rule language is threshold conjunctions)
        use_sets = bool(is_cat.any()) and getattr(self, "_use_set_splits",
                                                  True)
        cfg = dataclasses.replace(cfg, use_sets=use_sets,
                                  block_rows=blk, hist_groups=hist_groups)
        if not self.drf_mode and K == 1 and dist.name in ("laplace",
                                                          "quantile"):
            # leaves are the median (laplace) or the alpha-quantile of the
            # leaf's residuals, not a Newton step
            cfg = dataclasses.replace(
                cfg, leaf_quantile=(0.5 if dist.name == "laplace"
                                    else p.quantile_alpha))
        elif not self.drf_mode and K == 1 and dist.name == "huber":
            cfg = dataclasses.replace(cfg, huber_leaf_alpha=p.huber_alpha)
        cfg.check_supported()
        f = (f0[:, None].expand(K, y.shape[0]) if K > 1
             else f0.expand(y.shape)).clone()
        return types.SimpleNamespace(
            names=names, category=category, resp_domain=resp_domain,
            dist=dist, K=K, w=w, y=y, ymask=ymask, ym=ym, edges_np=edges_np,
            edges=edges, edge_ok=edge_ok, Xb=Xb, f0=f0, cfg=cfg,
            is_cat=is_cat, nedges_np=nedges_np,
            iscat=torch.from_numpy(is_cat.astype(np.bool_)).to(dev),
            nedges=torch.from_numpy(nedges_np.astype(np.int64)).to(dev), f=f,
            mono=torch.from_numpy(mono_np).to(dev),
            imat=torch.from_numpy(imat_np).to(dev))

    def build_impl(self, job) -> GBMModel:
        rs = self._take_resume_state()
        # an auto-recovery resume carries the margin in its state: no
        # replay of a prior at all
        prior = None
        if self.params.checkpoint is not None and rs is None:
            prior = self._resolve_checkpoint(self.params.checkpoint)
        s = self._setup_build()
        p, fr, dist, cfg = self.params, self.params.training_frame, s.dist, s.cfg
        K, f0, f = s.K, s.f0, s.f
        dev = s.Xb.device
        parts = []
        if prior is not None:
            p, cfg, f0, f = self._continue_from(prior, s)
            parts = [tuple(prior.forest[k].to(dev) for k in _FOREST_KEYS)]
        n_prior = prior.ntrees if prior is not None else 0
        if rs is not None:
            # the state carries what the prior block derived
            n_prior = int(rs["n_prior"])
            f0 = rs["f0"].to(dev)
            if bool(rs["use_sets"]) != cfg.use_sets:
                cfg = dataclasses.replace(cfg, use_sets=bool(rs["use_sets"]))
        n_new = p.ntrees - n_prior
        # keys and annealed rates are indexed by the global tree number, so
        # a continuation or a resume draws the trees' own streams
        keys = threefry.split(threefry.prng_key(_seed(p)), p.ntrees)[n_prior:]
        anneal = 1.0 if self.drf_mode else float(p.learn_rate_annealing or 1.0)
        rates = torch.from_numpy((anneal ** np.arange(n_prior, p.ntrees)
                                  ).astype(np.float32)).to(dev)
        interval = min(p.score_tree_interval or n_new, n_new)
        chunks = [(keys[i:i + interval], rates[i:i + interval])
                  for i in range(0, n_new, interval)]
        grad_fn = self._make_grad_fn(dist, K)

        output = ModelOutput()
        output.names = s.names
        output.domains = {n: fr.vec(n).domain for n in s.names}
        output.response_domain = list(s.resp_domain) if s.resp_domain else None
        output.model_category = s.category
        history, stop_series = [], []
        oob_sum = oob_cnt = None
        start_ci = 0
        if rs is not None and rs.get("chunks_done"):
            # the exact carried state: the remaining chunks see the inputs
            # the uninterrupted run gave them
            start_ci = int(rs["chunks_done"])
            parts = [tuple(t.to(dev) for t in part) for part in rs["parts"]]
            f = rs["f"].to(dev)
            oob_sum = None if rs["oob_sum"] is None else rs["oob_sum"].to(dev)
            oob_cnt = None if rs["oob_cnt"] is None else rs["oob_cnt"].to(dev)
            history = list(rs["history"])
            stop_series = list(rs["stop_series"])
        weights = s.w if p.weights_column else None
        for ci in range(start_ci, len(chunks)):
            failpoints.hit("train.gbm.chunk")
            job.check_cancelled()
            if history and job.time_exceeded():
                break   # keep the partial forest; the first chunk always
                        # trains (the reference's max_runtime contract)
            keys_c, rates_c = chunks[ci]
            f, osum, ocnt, trees = train_trees(
                s.Xb, s.y, s.w, f, s.edges, s.edge_ok, keys_c, rates_c, cfg,
                grad_fn, iscat=s.iscat, nedges=s.nedges, mono=s.mono,
                imat=s.imat)
            oob_sum = osum if oob_sum is None else oob_sum + osum
            oob_cnt = ocnt if oob_cnt is None else oob_cnt + ocnt
            parts.append(trees)
            ntrees_done = sum(int(t[0].shape[0]) for t in parts)
            # DRF scores out of bag throughout, like the reference; a
            # continuation's OOB would cover only its own trees, so it
            # reports in-bag metrics
            m = None
            if self.drf_mode and p.sample_rate < 1.0 and n_prior == 0:
                m = _oob_metrics(s.category, oob_sum, oob_cnt, s.y, s.ymask,
                                 weights, p.auc_type, output.response_domain)
                if m is not None:
                    m.description = "Reported on OOB data"
            if m is None:
                m = make_metrics(s.category, s.ym,
                                 _metrics_raw(s.category, dist, f,
                                              self.drf_mode, ntrees_done),
                                 weights, auc_type=p.auc_type,
                                 domain=output.response_domain)
            history.append({"timestamp": time.time(),
                            "number_of_trees": ntrees_done,
                            "training_metrics": m})
            job.update(len(keys_c) / max(n_new, 1))
            if p.export_checkpoints_dir:
                self._export_snapshot(p, output, parts, f0, dist, cfg, s,
                                      ntrees_done, m)
            if self._should_stop(m, stop_series):
                break
            # the exact carried state at this resumable boundary, written
            # when the interval is due (after the stop decision, so a
            # resumed run sees the same stopping series)
            self._recovery_tick(
                lambda ci=ci: {
                    "algo": self.algo_name, "chunks_done": ci + 1,
                    "n_prior": n_prior, "f0": f0,
                    "use_sets": bool(cfg.use_sets), "parts": list(parts),
                    "f": f, "oob_sum": oob_sum, "oob_cnt": oob_cnt,
                    "history": list(history),
                    "stop_series": list(stop_series)},
                progress={"ntrees_done": ntrees_done,
                          "ntrees_total": int(p.ntrees)})
        output.scoring_history = history
        output.training_metrics = history[-1]["training_metrics"]
        forest = _assemble_forest(parts)
        output.variable_importances = _varimp(forest, s.names)
        model = self.model_class(p, output, forest, f0, dist, cfg, s.is_cat,
                                 edges=s.edges_np, cat_nedges=s.nedges_np)
        if p.calibrate_model:
            model.calib = self._fit_calibration(model, s.category)
        if p.validation_frame is not None:
            output.validation_metrics = model.model_performance(
                p.validation_frame)
        return model

    def _continue_from(self, prior: GBMModel, s):
        """Checkpoint restart: check the prior against this build, then
        replay it. Returns (params with the prior as a key, tree config,
        f0, the carried margin)."""
        p, cfg, K = self.params, s.cfg, s.K
        if p.ntrees <= prior.ntrees:
            raise ValueError(
                f"checkpoint model already has {prior.ntrees} trees; "
                f"ntrees must exceed that (got {p.ntrees})")
        prior_mono = getattr(prior.params, "monotone_constraints", None) or {}
        for fld, ours, theirs in (
                ("max_depth", p.max_depth, prior.cfg.max_depth),
                # cfg.nbins is the effective bin count (exact small-data
                # binning may widen it); the user contract is the param
                ("nbins", p.nbins, getattr(prior.params, "nbins",
                                           prior.cfg.nbins)),
                ("nbins_cats", p.nbins_cats,
                 getattr(prior.params, "nbins_cats", 1024)),
                ("nclasses", K, prior.cfg.nclass),
                ("drf_mode", self.drf_mode, prior.cfg.drf_mode),
                ("monotone_constraints", dict(p.monotone_constraints or {}),
                 dict(prior_mono))):
            if ours != theirs:
                raise ValueError(f"checkpoint incompatible: {fld} differs "
                                 f"(checkpoint={theirs}, request={ours})")
        # the stored params name the prior by key, not by object
        p = self.params = dataclasses.replace(p, checkpoint=prior.key)
        # continuation trees speak the prior forest's split language
        if cfg.use_sets != prior.cfg.use_sets:
            cfg = dataclasses.replace(cfg, use_sets=prior.cfg.use_sets)
        dev = s.Xb.device
        if prior.forest["feat"].device != dev:
            prior = copy.copy(prior)    # the user's model stays where it is
            prior.forest = {k: v.to(dev) for k, v in prior.forest.items()}
            prior.f0 = prior.f0.to(dev)
        thr_codes = _prior_thr_codes(prior, s.edges_np)
        if thr_codes is not None:
            fprev = prior._raw_f_codes(s.Xb, thr_codes,
                                       s.edges_np.shape[1] + 1)
        else:
            info("checkpoint restart: prior split thresholds are not on the "
                 "current bin grid — replaying over the raw columns instead")
            fr = p.training_frame
            fprev = prior._raw_f(torch.stack(
                [fr.vec(n).data for n in prior.output.names], dim=1))
        f = (fprev.T if K > 1 else fprev).to(torch.float32).contiguous()
        if self.drf_mode:
            f = f * prior.ntrees    # _raw_f averages; the margin is the sum
        return p, cfg, prior.f0, f

    @staticmethod
    def _resolve_checkpoint(cp) -> GBMModel:
        """The prior model, given as itself or by its key in the store."""
        from ..backend.kvstore import STORE

        prior = STORE.get(cp) if isinstance(cp, str) else cp
        if prior is None:
            raise ValueError(f"checkpoint model '{cp}' not found")
        return prior

    def _export_snapshot(self, p, output, parts, f0, dist, cfg, s,
                         ntrees_done: int, metrics) -> None:
        """In-training snapshot every scoring interval
        (`hex/tree/SharedTree.java:164,202-204,515`): the forest so far as
        a model file ``<algo>_<ntrees:05d>.bin``."""
        import os

        from ..backend.kvstore import STORE
        from ..backend.persist import save_model

        snap_out = ModelOutput()
        snap_out.__dict__.update(output.__dict__)
        snap_out.training_metrics = metrics
        snap = self.model_class(p, snap_out, _assemble_forest(parts), f0,
                                dist, cfg, s.is_cat, edges=s.edges_np,
                                cat_nedges=s.nedges_np,
                                key=f"{self.algo_name}_checkpoint_snapshot")
        try:
            os.makedirs(p.export_checkpoints_dir, exist_ok=True)
            save_model(snap, os.path.join(
                p.export_checkpoints_dir,
                f"{self.algo_name}_{ntrees_done:05d}.bin"))
        finally:
            STORE.remove(snap.key, cascade=False)

    def _fit_calibration(self, model, category):
        """Platt scaling on ``calibration_frame``
        (`hex/tree/CalibrationHelper`): sigmoid(a f + b) fitted to the
        actuals by 25 two-parameter Newton steps on the model's margin (a
        DRF's probability through a clipped logit), in float32 as the
        reference fits it; the 2x2 solves on the host."""
        p = self.params
        if category != "Binomial":
            raise ValueError("calibrate_model requires a binomial model")
        if p.calibration_frame is None:
            raise ValueError("calibrate_model requires calibration_frame")
        cf = p.calibration_frame
        f = model._raw_f(model.adapt_frame(cf))
        if model.cfg.drf_mode:
            pc = torch.clamp(f, 1e-6, 1 - 1e-6)
            f = torch.log(pc / (1 - pc))
        yv = cf.vec(p.response_column).data
        y = torch.nan_to_num(yv)
        wm = (~torch.isnan(yv)).to(torch.float32)
        ab = np.array([1.0, 0.0], dtype=np.float32)
        for _ in range(25):
            mu = _sigmoid(float(ab[0]) * f + float(ab[1]))
            g_eta = wm * (mu - y)
            h_eta = torch.clamp(wm * mu * (1 - mu), min=1e-10)
            s = torch.stack([torch.sum(g_eta * f), torch.sum(g_eta),
                             torch.sum(h_eta * f * f), torch.sum(h_eta * f),
                             torch.sum(h_eta)]).cpu().numpy()
            H = np.array([[s[2], s[3]], [s[3], s[4]]], dtype=np.float32)
            ab = ab - np.linalg.solve(H + np.float32(1e-8) * np.eye(
                2, dtype=np.float32), s[:2])
        return (float(ab[0]), float(ab[1]))


    def _should_stop(self, m, series) -> bool:
        """The reference's stopping rule: append this scoring's metric to
        ``series`` and stop once the best of the last ``stopping_rounds``
        is not better than the best before them by ``stopping_tolerance``
        (relative). AUTO reads the metrics' class name: logloss for a
        classifier, else DEVIANCE — which reads the MSE."""
        p = self.params
        if p.stopping_rounds <= 0:
            return False
        name = p.stopping_metric.upper()
        if name == "AUTO":
            name = {"Binomial": "LOGLOSS", "Multinomial": "LOGLOSS",
                    "Regression": "DEVIANCE"}.get(
                        type(m).__name__.replace("ModelMetrics", ""),
                        "DEVIANCE")
        val = {
            "LOGLOSS": getattr(m, "logloss", np.nan),
            "AUC": -getattr(m, "auc", np.nan),
            "MSE": m.mse, "RMSE": m.rmse, "DEVIANCE": m.mse,
            "MAE": getattr(m, "mae", np.nan),
        }.get(name, m.mse)
        series.append(val)
        k = p.stopping_rounds
        if len(series) <= k:
            return False
        return min(series[-k:]) > min(series[:-k]) * (1 - p.stopping_tolerance)


def _varimp(forest, names):
    """Variable importances: each feature's split gains summed over the
    forest on the host (float32 gains into float64, the reference's
    order), then scaled by the largest and by the total. None when no
    split gained anything."""
    gains = forest["gain"].cpu().numpy()
    feats = forest["feat"].cpu().numpy()
    imp = np.zeros(len(names))
    np.add.at(imp, feats[feats >= 0].ravel(), gains[feats >= 0].ravel())
    if imp.sum() <= 0:
        return None
    rel = imp / imp.max() if imp.max() > 0 else imp
    order = np.argsort(-imp)
    return {"variable": [names[i] for i in order],
            "relative_importance": imp[order],
            "scaled_importance": rel[order],
            "percentage": (imp / imp.sum())[order]}


def _interaction_matrix(names, groups) -> np.ndarray:
    """(F, F) may-interact matrix from ``interaction_constraints`` groups
    (lists of column names); a feature in no group may only split with
    itself. All True when no groups are given."""
    F = len(names)
    if not groups:
        return np.ones((F, F), dtype=bool)
    M = np.eye(F, dtype=bool)
    idx = {n: i for i, n in enumerate(names)}
    for grp in groups:
        if isinstance(grp, str) or not isinstance(grp, (list, tuple)):
            raise ValueError(
                "interaction_constraints must be a list of column-name "
                f"LISTS (e.g. [['a','b'],['c']]), got group {grp!r}")
        ids = []
        for col in grp:
            if col not in idx:
                raise ValueError(f"interaction_constraints column '{col}' is "
                                 f"not a feature")
            ids.append(idx[col])
        for a in ids:
            for b in ids:
                M[a, b] = True
    return M


def _seed(p) -> int:
    """The reference's seed rule: -1 (or None) means 1234."""
    return 1234 if p.seed in (-1, None) else int(p.seed)


def _prior_thr_codes(prior: GBMModel, edges_np: np.ndarray):
    """A prior forest's split thresholds on the current bin grid, for the
    code-space replay (``GBMModel._raw_f_codes``): the threshold array in
    codes (float32, the forest's thr shape), or None when a numeric split
    threshold is not an edge of the grid (a continuation on other data or
    binning, where code-space routing would diverge)."""
    feat = prior.forest["feat"].cpu().numpy()
    thr = prior.forest["thr"].cpu().numpy().astype(np.float32)
    internal = feat >= 0
    f_idx = np.clip(feat, 0, None)
    e = edges_np[f_idx]          # (..., W) each node's edge row
    with np.errstate(invalid="ignore"):
        codes = np.sum(e < thr[..., None], axis=-1).astype(np.float32)
        on_grid = np.any(e == thr[..., None], axis=-1)
    needs_grid = internal
    if prior.cfg.use_sets and prior.is_cat is not None:
        # set-split nodes route through their catd rows; their threshold is
        # never compared
        needs_grid = internal & ~np.asarray(prior.is_cat)[f_idx]
    if not bool(np.all(on_grid[needs_grid])):
        return None
    return codes


def _assemble_forest(parts) -> dict:
    """Chunks' tree arrays -> the model's forest dict. A narrower catd
    table (a prior built where exact binning chose fewer bins) is padded on
    the right with each node's NA direction: a level landing in a bin the
    prior never had is routed like a missing value."""
    out = {}
    for i, k in enumerate(_FOREST_KEYS):
        arrs = [t[i] for t in parts]
        if k == "catd":
            w = max(a.shape[-1] for a in arrs)
            arrs = [a if a.shape[-1] == w else torch.cat(
                [a, (~part[2]).to(torch.float32)[..., None].expand(
                    *a.shape[:-1], w - a.shape[-1])], dim=-1)
                for a, part in zip(arrs, parts)]
        out[k] = torch.cat(arrs)
    return out


def _heap_path(node: int) -> str:
    """Heap index -> its root-to-leaf L/R path ('' for the root)."""
    return "".join("R" if b == "1" else "L" for b in bin(node + 1)[3:])

