"""RuleFit — rules from a tree ensemble + a sparse linear model
(``h2o_tpu/models/rulefit.py``).

`RuleFit.java` trains one tree ensemble per depth in
``min_rule_length..max_rule_length``, takes every root→node path of a
length in that range as a binary rule (`RuleExtractor.java`), drops
duplicates, then fits an L1 GLM over [rules | linear terms] (``model_type``
rules_and_linear / rules / linear) and ranks the surviving rules by their
coefficients (`Rule.java` importance).

The sub-forests are the port's DRF (or GBM) builders, so each level of
their trees is one launch of the level-histogram kernel; set splits are
off (the rule language is threshold conjunctions). Rule memberships are
integer work: a rule's conditions read the raw feature values by index
(the reference's bf16 hi/lo one-hot trick is its way to select float32
values exactly on the MXU; an index gives the same values). The L1 path
runs over the Gram kernel in one of two ways, chosen as the reference
chooses: a design of at most ``_STREAM_CELL_BUDGET`` cells is built once
and fitted by ``GLM._fit``; a larger one is never built whole — each IRLS
step walks the rows in blocks, builds each block's design on the device
and calls ``gram_accumulate`` on it, and the partials are added in
ascending block order in float32, as the reference's scan adds them.
Rule supports are read off the forests' node covers
(``engine.forest_covers``), with ``_stream_rule_support`` kept as the
membership oracle they are tested against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..backend.jobs import Job
from ..backend.kernels.gram import gram_accumulate
from ..frame.frame import Frame
from ..frame.vec import Vec
from ..parallel.mesh import resolve_device
from .drf import DRF, DRFParameters
from .gbm import GBM, GBMParameters
from .glm import (GLM, GLMModel, GLMParameters, _admm_solve, _carried_family,
                  _safe)
from .metrics import make_metrics
from .model_base import Model, ModelBuilder, ModelOutput
from .tree.binning import _pow2_block
from .tree.engine import forest_covers


@dataclass
class RuleFitParameters(GLMParameters):
    """Mirrors `hex/schemas/RuleFitV3`."""

    algorithm: str = "AUTO"        # AUTO(=DRF) | DRF | GBM
    min_rule_length: int = 3
    max_rule_length: int = 3
    max_num_rules: int = -1        # -1 = no cap (reference default)
    model_type: str = "rules_and_linear"  # rules_and_linear | rules | linear
    rule_generation_ntrees: int = 50
    beta_epsilon: float = 1e-4     # the reference GLM IRLSM default (the
                                   # GLM's own pins 1e-5)
    objective_epsilon: float = 1e-4  # the lambda-search default of the
                                   # reference's GLM


class Rule:
    """A conjunction of (feature, op, threshold, na_goes_left) conditions."""

    __slots__ = ("conds", "support", "coef", "rule_id", "origin",
                 "model_idx")

    def __init__(self, conds, rule_id, origin=None):
        self.conds = conds          # list of (fidx, '<='|'>', thr, na_left)
        self.support = 0.0
        self.coef = 0.0
        self.rule_id = rule_id
        #: (flat tree index, heap node) the rule's path ends at: the rows
        #: satisfying the conds are exactly the rows that visit that node
        self.origin = origin
        self.model_idx = 0          # which depth-ensemble produced it

    def describe(self, names):
        return " & ".join(f"({names[fidx]} {op} {thr:.6g})"
                          for fidx, op, thr, _ in self.conds)


def extract_rules(forest: dict, max_depth: int, min_len: int, max_len: int):
    """Walk the (T, N) full-binary-tree arrays (host copies); emit one rule
    per internal path of length in [min_len, max_len]
    (`hex/rulefit/RuleExtractor.java`)."""
    feat, thr, nanL = (np.asarray(forest[k].cpu().numpy()
                                  if torch.is_tensor(forest[k])
                                  else forest[k])
                       for k in ("feat", "thr", "nanL"))
    if feat.ndim == 3:  # multinomial (T, K, N) -> flatten classes
        T, K, N = feat.shape
        feat, thr, nanL = (a.reshape(T * K, N) for a in (feat, thr, nanL))
    rules = []
    seen = set()
    for t in range(feat.shape[0]):
        stack = [(0, [])]
        while stack:
            node, conds = stack.pop()
            if conds and min_len <= len(conds) <= max_len:
                key = tuple(conds)
                if key not in seen:
                    seen.add(key)
                    rules.append(Rule(list(conds), len(rules),
                                      origin=(t, node)))
            f = feat[t, node]
            if f < 0 or len(conds) >= max_len:
                continue
            c_left = (int(f), "<=", float(thr[t, node]), bool(nanL[t, node]))
            c_right = (int(f), ">", float(thr[t, node]), bool(nanL[t, node]))
            stack.append((2 * node + 1, conds + [c_left]))
            stack.append((2 * node + 2, conds + [c_right]))
    return rules


def _rules_tensor(rules, F):
    """Rules packed per (rule, condition slot) as host tensors: feature
    index, threshold, is '>', NA goes left, slot active."""
    L = max(len(r.conds) for r in rules)
    R = len(rules)
    fidx = np.zeros((R, L), np.int64)
    thr = np.zeros((R, L), np.float32)
    is_gt = np.zeros((R, L), bool)
    na_left = np.zeros((R, L), bool)
    act = np.zeros((R, L), bool)
    for i, r in enumerate(rules):
        for j, (f, op, t, nl) in enumerate(r.conds):
            fidx[i, j] = f
            thr[i, j] = t
            is_gt[i, j] = op == ">"
            na_left[i, j] = nl
            act[i, j] = True
    return tuple(map(torch.from_numpy, (fidx, thr, is_gt, na_left, act)))


def _membership(xv, isna, thr, gt, nal, act):
    """(rows, R) bool: every active condition of each rule holds; ``xv``
    and ``isna`` (rows, R, L) hold each condition's feature value."""
    le = torch.where(isna, nal, xv <= thr)
    cond = torch.where(act, torch.where(gt, ~le, le), True)
    return torch.all(cond, dim=2)


def eval_rules(X, fidx, thr, is_gt, na_left, act):
    """(rows, rules) 0/1 float32 membership of the raw matrix ``X``."""
    a = [t.to(X.device) for t in (fidx, thr, is_gt, na_left, act)]
    xv = X[:, a[0]]                       # (rows, R, L)
    return _membership(xv, torch.isnan(xv), *a[1:]).to(torch.float32)


def _build_design_block(xb, fidx, thr, gt, nal, act, lsel, mu_l, sg_l):
    """(rb, F) raw block -> (rb, P) design block: rule memberships, then
    the linear terms standardized with NA -> mean imputation (as
    ``RuleFitModel._design``). The tensors are on ``xb``'s device."""
    blocks = []
    if fidx.shape[0]:
        R, L = fidx.shape
        xv = xb.index_select(1, fidx.reshape(-1)).reshape(-1, R, L)
        blocks.append(_membership(xv, torch.isnan(xv), thr, gt, nal,
                                  act).to(torch.float32))
    if lsel.shape[0]:
        lv = xb.index_select(1, lsel)
        lv = torch.where(torch.isnan(lv), mu_l[None, :], torch.nan_to_num(lv))
        blocks.append((lv - mu_l[None, :]) / sg_l[None, :])
    return torch.cat(blocks, dim=1)


#: design cells above which RuleFit streams (~2 GB of f32): the reference's
_STREAM_CELL_BUDGET = 1 << 29
#: design cells of one streamed block on the card (~1 GB of f32)
_CARD_BLOCK_CELLS = 1 << 28


def _stream_block(R: int, P: int, device) -> int:
    """Rows per streamed block. On the CPU the reference's
    (``rulefit.py:205``: the largest power-of-two divisor of R up to
    65,536 rows or 2^27 cells), so the plain Gram adds the blocks the
    reference adds; on the card blocks of up to ``_CARD_BLOCK_CELLS``
    design cells, a multiple of 256 rows, the last one ragged — one Gram
    launch per block."""
    if device.type == "cpu":
        return _pow2_block(R, max(256, min(65536, (1 << 27) // max(P, 1))))
    return max(256, _CARD_BLOCK_CELLS // max(P, 1) // 256 * 256)


def _stream_prelude(y_dev, wcol, nrow, family):
    """(y, w, offset, neff, intercept init): the response with NAs zeroed,
    the weights (response present, real row, times the weights column)."""
    y = torch.nan_to_num(y_dev)
    w = (~torch.isnan(y_dev)).to(torch.float32)
    w = w * (torch.arange(y.shape[0], device=y.device) < nrow) * wcol
    return y, w, torch.zeros_like(y), torch.sum(w), family.init_intercept(y, w)


def _stream_step(family, rb, Xraw, y, w, beta, offset, sargs):
    """One streamed GLMIterationTask: each block's design built on the
    device, its (Gram, XWz) from one ``gram_accumulate`` call, the
    partials, deviance and weight summed in ascending block order."""
    P1 = beta.shape[0]
    dev = Xraw.device
    G = torch.zeros((P1, P1), dtype=torch.float32, device=dev)
    b = torch.zeros((P1,), dtype=torch.float32, device=dev)
    devn = torch.zeros((), dtype=torch.float32, device=dev)
    neff = torch.zeros((), dtype=torch.float32, device=dev)
    for s in range(0, Xraw.shape[0], rb):
        e = min(s + rb, Xraw.shape[0])
        A = _build_design_block(Xraw[s:e], *sargs)
        Ai = torch.cat([A, torch.ones((e - s, 1), dtype=torch.float32,
                                      device=dev)], dim=1)
        yb, wb, ob = y[s:e], w[s:e], offset[s:e]
        eta = Ai @ beta + ob
        mu = family.linkinv(eta)
        d = family.dmu_deta(eta)
        W = wb * d * d / torch.clamp(family.variance(mu), min=1e-10)
        z = eta - ob + (yb - mu) / _safe(d)
        dG, db = gram_accumulate(Ai, W, z)
        G = G + dG
        b = b + db
        devn = devn + torch.sum(family.deviance(yb, mu, wb))
        neff = neff + torch.sum(wb)
    return G, b, devn, neff


def _stream_eta(Xraw, beta, sargs, rb):
    """X @ beta over the streamed design, block by block."""
    return torch.cat([
        _build_design_block(Xraw[s:s + rb], *sargs) @ beta[:-1] + beta[-1]
        for s in range(0, Xraw.shape[0], rb)])


def _covers_support(submodels, rules, Xraw, nrow: int) -> np.ndarray:
    """Per-rule support read off the generating forests' node covers: the
    rows satisfying a rule's conditions are the rows that visit its
    origin node, counted by ``engine.forest_covers`` (exact fixed-point
    sums) in one routing pass per sub-forest."""
    valid = (torch.arange(Xraw.shape[0], device=Xraw.device)
             < nrow).to(torch.float32)
    sup = np.zeros(len(rules), np.float32)
    by_model: dict[int, list[int]] = {}
    for i, r in enumerate(rules):
        by_model.setdefault(r.model_idx, []).append(i)
    for mi, idxs in sorted(by_model.items()):
        fo = submodels[mi].forest
        cov = forest_covers(Xraw, valid, fo["feat"], fo["thr"], fo["nanL"],
                            submodels[mi].cfg.max_depth).cpu().numpy()
        if cov.ndim == 3:  # multinomial (T, K, N): extract_rules flattened
            cov = cov.reshape(-1, cov.shape[-1])
        for i in idxs:
            t, node = rules[i].origin
            sup[i] = cov[t, node] / max(nrow, 1)
    return sup


def _stream_rule_support(Xraw, rule_arrays, nrow: int) -> torch.Tensor:
    """Per-rule membership frequency over the real rows, streamed — the
    parity oracle for `_covers_support`."""
    dev = Xraw.device
    R = rule_arrays[0].shape[0]
    arrs = [t.to(dev) for t in rule_arrays]
    empty_i = torch.zeros((0,), dtype=torch.int64, device=dev)
    empty_f = torch.zeros((0,), dtype=torch.float32, device=dev)
    rb = _stream_block(int(Xraw.shape[0]), R, dev)
    valid = (torch.arange(Xraw.shape[0], device=dev) < nrow).to(torch.float32)
    tot = torch.zeros((R,), dtype=torch.float32, device=dev)
    for s in range(0, Xraw.shape[0], rb):
        memb = _build_design_block(Xraw[s:s + rb], *arrs, empty_i, empty_f,
                                   empty_f)
        tot = tot + (memb * valid[s:s + rb, None]).sum(dim=0)
    return tot / max(nrow, 1)


class RuleFitModel(Model):
    algo_name = "rulefit"

    #: streaming mode (large designs): adapt_frame returns the RAW feature
    #: matrix and score0 builds design blocks on the fly
    stream = False
    beta = None      # [rules..., linear..., intercept]
    family = None    # GLM family object (single-block fits)
    #: the lambda the path ended at; a streamed fit's rows per block, IRLS
    #: steps and lambdas walked
    lambda_used = stream_block_rows = stream_steps = lambdas_walked = None

    def __init__(self, params, output, rules, rule_arrays, lin_names,
                 lin_stats, glm_model, key=None):
        super().__init__(params, output, key=key)
        self.rules = rules
        self.rule_arrays = rule_arrays    # packed host tensors or None
        self.lin_names = lin_names        # linear-term feature names
        self.lin_stats = lin_stats        # (means, sigmas) for linear terms
        self.glm_model = glm_model        # the multinomial sub-GLM, or None

    @staticmethod
    def from_reference(ref, device=None) -> "RuleFitModel":
        """Carry a JAX-trained RuleFit over: the rules (conditions,
        supports, coefficients, origins), the packed rule arrays, the
        linear terms' statistics, ``beta``, the family and the streaming
        flag (a multinomial model's sub-GLM through
        ``GLMModel.from_reference``). Given the same frame it scores what
        the reference scores."""
        resolve_device(device)
        rules = []
        for r in ref.rules:
            c = Rule([tuple(cd) for cd in r.conds], r.rule_id, r.origin)
            c.support, c.coef, c.model_idx = r.support, r.coef, r.model_idx
            rules.append(c)
        arrays = None
        if ref.rule_arrays is not None:
            arrays = tuple(torch.from_numpy(np.array(a)) for a in
                           ref.rule_arrays)
            arrays = (arrays[0].to(torch.int64),) + arrays[1:]
        stats = (None if ref.lin_stats is None
                 else tuple(list(s) for s in ref.lin_stats))
        glm = (None if ref.glm_model is None
               else GLMModel.from_reference(ref.glm_model, device))
        params = RuleFitParameters(
            model_type=ref.params.model_type,
            response_column=ref.params.response_column)
        model = RuleFitModel(params, ModelOutput.carried(ref.output), rules,
                             arrays, list(ref.lin_names), stats, glm)
        model.stream = bool(ref.stream)
        if ref.beta is not None:
            model.beta = np.asarray(ref.beta, np.float64).copy()
        if ref.family is not None:
            model.family = _carried_family(ref.family)[0]
        return model

    def _stream_args(self, device):
        """The design builder's tensors (rules + linear stats) on
        ``device``."""
        names = self.output.names
        if self.rule_arrays is not None:
            rule = [t.to(device) for t in self.rule_arrays]
        else:
            rule = [torch.zeros((0, 1), dtype=dt, device=device)
                    for dt in (torch.int64, torch.float32, torch.bool,
                               torch.bool, torch.bool)]
        lin_sel = [names.index(n) for n in self.lin_names]
        means, sigmas = self.lin_stats if self.lin_stats else ([], [])
        return (*rule,
                torch.tensor(lin_sel, dtype=torch.int64, device=device),
                torch.tensor(np.asarray(means, np.float32), device=device),
                torch.tensor(np.asarray(sigmas, np.float32), device=device))

    def _design(self, fr: Frame) -> torch.Tensor:
        """The whole [rules | linear] design of ``fr``, built as one block."""
        X = fr.as_matrix(self.output.names)
        return _build_design_block(X, *self._stream_args(X.device))

    def adapt_frame(self, fr: Frame) -> torch.Tensor:
        fr = self.pre_adapt(fr)
        if self.stream:
            return fr.as_matrix(self.output.names)
        return self._design(fr)

    def score0(self, X: torch.Tensor) -> torch.Tensor:
        if self.glm_model is not None:
            # multinomial fits carry the full sub-GLM
            return self.glm_model.score0(X)
        beta = torch.as_tensor(self.beta, dtype=torch.float32,
                               device=X.device)
        if self.stream:
            rb = _stream_block(int(X.shape[0]), len(self.beta), X.device)
            eta = _stream_eta(X, beta, self._stream_args(X.device), rb)
        else:
            eta = X @ beta[:-1] + beta[-1]
        mu = self.family.linkinv(eta)
        if self.output.model_category == "Binomial":
            label = (mu >= 0.5).to(torch.float32)
            return torch.stack([label, 1 - mu, mu], dim=1)
        return mu

    def rule_importance(self):
        """Rules the L1 fit kept, ranked by |coef| (`Rule.java` importance)."""
        names = self.output.names
        rows = [{"rule": r.describe(names), "coefficient": r.coef,
                 "support": r.support}
                for r in self.rules if abs(r.coef) > 1e-8]
        rows.sort(key=lambda d: -abs(d["coefficient"]))
        return rows


class RuleFit(ModelBuilder):
    algo_name = "rulefit"

    def build_impl(self, job) -> RuleFitModel:
        p = self.params
        fr = p.training_frame
        names = self.feature_names()
        y_dev, category, resp_domain = self.response_info()
        model_type = p.model_type.lower()

        rules, rule_arrays, submodels = [], None, []
        if "rules" in model_type:
            # depth-varying ensembles (`RuleFit.java` treeParameters loop)
            depths = range(p.min_rule_length, p.max_rule_length + 1)
            ntrees = max(p.rule_generation_ntrees // max(len(depths), 1), 5)
            for depth in depths:
                job.check_cancelled()
                algo = (p.algorithm or "AUTO").upper()
                # the sub-forests split on RuleFit's own features only, so
                # a rule's feature index is a column of the design (the
                # reference trains them on every column, and an offset or
                # ignored column shifts its indices: ROADMAP Queue 3)
                common = dict(training_frame=fr,
                              response_column=p.response_column,
                              weights_column=p.weights_column, ntrees=ntrees,
                              max_depth=depth, seed=p.seed,
                              distribution=p.distribution,
                              ignored_columns=[
                                  n for n in fr.names if n not in names
                                  and n not in (p.response_column,
                                                p.weights_column)])
                sub = (DRF(DRFParameters(**common)) if algo in ("AUTO", "DRF")
                       else GBM(GBMParameters(**common)))
                # threshold conjunctions only: no categorical set splits
                sub._use_set_splits = False
                m = sub.build_impl(Job(f"rulefit_trees_d{depth}", 1.0))
                new_rules = extract_rules(m.forest, m.cfg.max_depth,
                                          p.min_rule_length,
                                          p.max_rule_length)
                for r in new_rules:
                    r.model_idx = len(submodels)
                submodels.append(m)
                rules += new_rules
            if p.max_num_rules > 0:
                rules = rules[: p.max_num_rules]
            for i, r in enumerate(rules):
                r.rule_id = i
            rule_arrays = _rules_tensor(rules, len(names)) if rules else None

        lin_names, lin_stats = [], None
        if "linear" in model_type:
            lin_names = [n for n in names if not fr.vec(n).is_categorical()]
            means = [float(np.nan_to_num(fr.vec(n).rollups().mean))
                     for n in lin_names]
            sigmas = [max(float(np.nan_to_num(fr.vec(n).rollups().sigma)),
                          1e-6) for n in lin_names]
            lin_stats = (means, sigmas)

        output = ModelOutput()
        output.names = names
        output.domains = {n: fr.vec(n).domain for n in names}
        output.response_domain = list(resp_domain) if resp_domain else None
        output.model_category = category
        model = RuleFitModel(p, output, rules, rule_arrays, lin_names,
                             lin_stats, None)

        P_design = len(rules) + len(lin_names)
        model.stream = fr.vec(0).plen * max(P_design, 1) > _STREAM_CELL_BUDGET
        if model.stream:
            # the design never materializes: the L1 path runs on the
            # streamed IRLS
            beta = self._fit_streaming(job, model, fr, y_dev, category)
        else:
            Xd = model._design(fr)
            beta = self._fit_design(job, model, Xd, y_dev, fr, category)
        model.beta = beta

        # coefficients back onto the rules; support = rule frequency, from
        # the generating forests' node covers
        if rules:
            sup = _covers_support(submodels, rules, fr.as_matrix(names),
                                  fr.nrow)
            for i, r in enumerate(rules):
                r.coef = float(beta[i])
                r.support = float(sup[i])

        raw = model.score0(model.adapt_frame(fr) if model.stream else Xd)
        wm = (torch.nan_to_num(fr.vec(p.weights_column).data)
              if p.weights_column else None)
        output.training_metrics = make_metrics(category, y_dev, raw, wm,
                                               auc_type=p.auc_type,
                                               domain=output.response_domain)
        output.variable_importances = None
        job.update(1.0)
        return model

    def _glm_params(self, fr: Frame) -> GLMParameters:
        """The L1 path's GLM (`RuleFit.java` glmParameters: alpha 1,
        lambda search, at most 20 lambdas)."""
        p = self.params
        return GLMParameters(
            training_frame=fr, response_column=p.response_column,
            weights_column=p.weights_column, alpha=1.0,
            lambda_search=p.lambda_search or p.lambda_ is None,
            lambda_=p.lambda_, nlambdas=min(p.nlambdas, 20),
            standardize=False, family=p.family, seed=p.seed,
            max_iterations=p.max_iterations, beta_epsilon=p.beta_epsilon,
            objective_epsilon=p.objective_epsilon)

    def _weights_col(self, fr: Frame, dev) -> torch.Tensor:
        p = self.params
        if p.weights_column:
            return torch.nan_to_num(fr.vec(p.weights_column).data)
        return torch.ones((), dtype=torch.float32, device=dev)

    def _fit_design(self, job, model, Xd, y_dev, fr, category) -> np.ndarray:
        """The L1 lambda path over the built rule/linear design:
        ``GLM._fit`` (the Gram kernel once per IRLS iteration) on the
        design with its intercept column; a multinomial response goes
        through the GLM builder on a frame of the design's columns."""
        p = self.params
        if category == "Multinomial":
            design = Frame([f"c{i}" for i in range(Xd.shape[1])],
                           [Vec(Xd[:, i].contiguous(), fr.nrow)
                            for i in range(Xd.shape[1])])
            design.add(p.response_column, fr.vec(p.response_column))
            if p.weights_column:
                design.add(p.weights_column, fr.vec(p.weights_column))
            glm_model = GLM(self._glm_params(design)).build_impl(
                Job("rulefit_glm", 1.0))
            model.glm_model = glm_model
            return np.asarray(glm_model.beta)
        family = GLM._family(self, category)
        model.family = family
        gb = GLM(self._glm_params(fr))
        y, w, offset, _neff, _b0 = _stream_prelude(
            y_dev, self._weights_col(fr, Xd.device), fr.nrow, family)
        Xi = torch.cat([Xd, torch.ones((Xd.shape[0], 1), dtype=torch.float32,
                                       device=Xd.device)], dim=1)
        beta, lam, _dev, _nulldev, _neff2, _iters = gb._fit(
            Xi, y, w, offset, family, job)
        model.lambda_used = float(lam)
        return np.asarray(beta, np.float64)

    def _fit_streaming(self, job, model, fr, y_dev, category) -> np.ndarray:
        """The L1 lambda path over the streamed IRLS, the reference's loop:
        the lambda-max pass's Gram seeds the first lambda, each lambda is
        warm-started and takes at most 5 steps, and the path stops once a
        lambda buys less than 3e-4 of the null deviance."""
        p = self.params
        if category == "Multinomial":
            raise NotImplementedError(
                "rulefit: a multinomial response needs a built design (at "
                "most 2^29 cells); the reference's streamed path fits it "
                "as binomial (ROADMAP Queue 3 item 27)")
        family = GLM._family(self, category)
        model.family = family
        Xraw = fr.as_matrix(model.output.names)
        dev = Xraw.device
        y, w, offset, neff_d, b0_d = _stream_prelude(
            y_dev, self._weights_col(fr, dev), fr.nrow, family)
        neff = float(neff_d)
        sargs = model._stream_args(dev)
        P1 = len(model.rules) + len(model.lin_names) + 1
        rb = _stream_block(int(Xraw.shape[0]), P1, dev)
        model.stream_block_rows = rb
        steps = 0

        def step(bb):
            nonlocal steps
            steps += 1
            G, b, dv, _ = _stream_step(
                family, rb, Xraw, y, w,
                torch.from_numpy(bb.astype(np.float32)).to(dev), offset,
                sargs)
            return (G.cpu().numpy().astype(np.float64),
                    b.cpu().numpy().astype(np.float64), float(dv))

        beta = np.zeros(P1, np.float64)
        beta[-1] = float(b0_d)
        free = np.zeros(P1, bool)
        free[-1] = True
        G0, b0, dev0 = step(beta)
        grad0 = np.abs(b0 - G0 @ beta)[:-1]
        lmax = float(grad0.max()) / max(neff, 1.0)
        nl = min(p.nlambdas, 20)
        lambdas = (np.geomspace(lmax, lmax * 1e-4, nl)
                   if (p.lambda_search or p.lambda_ is None)
                   else [p.lambda_])
        # the intercept-only pass's deviance is the null deviance, and its
        # Gram seeds the first lambda
        nulldev = dev0
        dev_lambda_prev = np.inf
        seeded = (G0, b0, dev0)
        walked = 0
        for lam in lambdas:
            job.check_cancelled()
            walked += 1
            l1 = float(lam) * neff  # alpha = 1 (pure lasso, like the ref)
            dv = np.inf
            for _it in range(min(max(p.max_iterations, 1), 5)):
                if seeded is not None:
                    G, b, dv = seeded
                    seeded = None
                else:
                    G, b, dv = step(beta)
                beta_new = _admm_solve(G, b, l1, 0.0, free)
                diff = np.max(np.abs(beta_new - beta))
                beta = beta_new
                if diff < p.beta_epsilon:
                    break
            # lambda-search early stop
            if (dev_lambda_prev - dv) < 3e-4 * abs(nulldev):
                break
            dev_lambda_prev = dv
        model.stream_steps = steps
        model.lambdas_walked = walked
        model.lambda_used = float(lam)
        return beta
