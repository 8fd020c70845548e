"""ModelSelection — best-subset GLM predictor selection
(``h2o_tpu/models/modelselection.py``, `hex/modelselection/`).

Modes maxr (the best model of each size by greedy add-and-replace sweeps),
maxrsweep (the same walk), forward, backward and allsubsets
(`hex/modelselection/ModelSelection.java`). The gaussian family scores
every candidate subset on the host from ONE weighted Gram of [X | 1 | y]
— on the card one launch of the Gram kernel, in its z = None form — by a
small float64 solve, with no further pass over the data; the other
families run the same search with one IRLS GLM fit per candidate, each
iteration of which is a Gram launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations

import numpy as np
import torch

from ..backend.jobs import Job
from ..backend.kernels.gram import gram_accumulate
from ..frame.frame import Frame
from .datainfo import DataInfo
from .glm import GLM, GLMParameters
from .model_base import Model, ModelBuilder, ModelOutput


@dataclass
class ModelSelectionParameters(GLMParameters):
    """The reference's `hex/schemas/ModelSelectionV3` fields."""

    mode: str = "maxr"        # maxr | maxrsweep | forward | backward | allsubsets
    max_predictor_number: int = -1   # -1 = all sizes up to #predictors
    min_predictor_number: int = 1
    p_values_threshold: float = 0.0  # declared by the reference, read by no
                                     # mode of it: accepted and ignored


def _subset_search(mode, k, score_of, min_k, max_k, check_cancelled):
    """The shared subset-search skeleton over items 0..k-1.

    score_of(list[int]) -> (score, payload); higher score wins. Returns
    [(subset, score, payload)] with one entry per model size (ascending),
    in the reference's four walk orders."""
    mode = mode.lower()
    out = []

    if mode == "backward":
        sel = list(range(k))
        s, pay = score_of(sel)
        out.append((sel.copy(), s, pay))
        while len(sel) > max(min_k, 1):
            check_cancelled()
            best = max(((g, *score_of([x for x in sel if x != g]))
                        for g in sel), key=lambda t: t[1])
            sel = [x for x in sel if x != best[0]]
            out.append((sel.copy(), best[1], best[2]))
        out.reverse()
        return [e for e in out if len(e[0]) <= max_k]

    if mode == "allsubsets":
        for size in range(max(min_k, 1), max_k + 1):
            check_cancelled()
            best = max(((list(c), *score_of(list(c)))
                        for c in combinations(range(k), size)),
                       key=lambda t: t[1])
            out.append((best[0], best[1], best[2]))
        return out

    # forward and maxr share the greedy add; maxr also tries replacing each
    # kept item after every add (the add-and-replace sweep)
    sel: list[int] = []
    for size in range(1, max_k + 1):
        check_cancelled()
        cands = [g for g in range(k) if g not in sel]
        if not cands:
            break
        best = max(((g, *score_of(sel + [g])) for g in cands),
                   key=lambda t: t[1])
        sel = sel + [best[0]]
        s, pay = best[1], best[2]
        if mode in ("maxr", "maxrsweep"):
            improved = True
            while improved:
                improved = False
                check_cancelled()
                for i in range(len(sel) - 1):
                    for g in range(k):
                        if g in sel:
                            continue
                        trial = sel.copy()
                        trial[i] = g
                        ts, tpay = score_of(trial)
                        if ts > s + 1e-12:
                            sel, s, pay = trial, ts, tpay
                            improved = True
        if len(sel) >= max(min_k, 1):
            out.append((sel.copy(), s, pay))
    return out


class ModelSelectionModel(Model):
    algo_name = "modelselection"

    def __init__(self, params, output, results):
        super().__init__(params, output)
        self.results = results   # per size: dict(predictors, r2, coefs)

    def result(self):
        return self.results

    def best_predictors(self, size=None):
        if size is None:
            return self.results[-1]["predictors"]
        for r in self.results:
            if len(r["predictors"]) == size:
                return r["predictors"]
        raise KeyError(f"no result of size {size}")

    def coef(self, size=None):
        r = (self.results[-1] if size is None else
             next(x for x in self.results if len(x["predictors"]) == size))
        return r["coefs"]

    def score0(self, X):
        raise NotImplementedError(
            "modelselection is a selection report; train a GLM on "
            "best_predictors() to score")


class ModelSelection(ModelBuilder):
    algo_name = "modelselection"

    def build_impl(self, job: Job) -> ModelSelectionModel:
        p = self.params
        fr = p.training_frame
        names = self.feature_names()
        y_dev, category, resp_domain = self.response_info()
        fam = (p.family or "AUTO").lower()
        if fam in ("auto", "gaussian") and category == "Regression":
            results = self._fit_gaussian_sweep(job, fr, names, y_dev)
        else:
            results = self._fit_irls(job, fr, names)

        output = ModelOutput()
        output.names = names
        output.domains = {n: fr.vec(n).domain for n in names}
        output.response_domain = list(resp_domain) if resp_domain else None
        output.model_category = category
        model = ModelSelectionModel(p, output, results)
        job.update(1.0)
        return model

    def _size_bounds(self, k):
        p = self.params
        kmax = p.max_predictor_number if p.max_predictor_number > 0 else k
        return max(p.min_predictor_number, 1), min(kmax, k)

    # -- gaussian: every candidate subset scored from ONE Gram ----------------
    def _fit_gaussian_sweep(self, job, fr: Frame, names, y_dev):
        p = self.params
        dinfo = DataInfo.make(fr, names, standardize=p.standardize)
        Xi, okrow = dinfo.expand(fr, intercept=True)
        y = torch.nan_to_num(y_dev)
        w = (~torch.isnan(y_dev)).to(torch.float32) * okrow.to(torch.float32)
        w = w * (torch.arange(Xi.shape[0], device=Xi.device) < fr.nrow)
        if p.weights_column:
            w = w * torch.nan_to_num(fr.vec(p.weights_column).data)

        # a categorical's one-hot block moves in and out of the model
        # together, as in the reference
        groups, gnames = [], []
        off = 0
        for n in dinfo.names:
            if n in dinfo.domains:
                lo = 0 if dinfo.use_all_factor_levels else 1
                sz = len(dinfo.domains[n]) - lo
            else:
                sz = 1
            groups.append(list(range(off, off + sz)))
            gnames.append(n)
            off += sz

        Z = torch.cat([Xi, y[:, None]], dim=1)   # [X | 1 | y]
        del Xi
        G, _ = gram_accumulate(Z, w, None)       # (W∘Z)ᵀZ, one pass
        G = G.cpu().numpy().astype(np.float64)
        del Z
        P = dinfo.ncols_expanded
        yty = G[P + 1, P + 1]
        sw = G[P, P]
        ybar = G[P, P + 1] / max(sw, 1e-10)
        sst = yty - sw * ybar * ybar

        def score_of(idx_groups):
            cols = [c for g in idx_groups for c in groups[g]] + [P]
            A = G[np.ix_(cols, cols)]
            b = G[cols, P + 1]
            try:
                beta = np.linalg.solve(A + 1e-8 * np.eye(len(cols)), b)
            except np.linalg.LinAlgError:
                return -np.inf, None
            sse = yty - 2 * beta @ b + beta @ A @ beta
            return 1.0 - sse / max(sst, 1e-10), beta

        min_k, max_k = self._size_bounds(len(groups))
        found = _subset_search(p.mode, len(groups), score_of, min_k, max_k,
                               job.check_cancelled)
        results = []
        for sel, r2, beta in found:
            cols = [c for g in sel for c in groups[g]]
            coefs = {dinfo.expanded_names[c]: float(beta[i])
                     for i, c in enumerate(cols)}
            coefs["Intercept"] = float(beta[-1])
            results.append({"predictors": [gnames[g] for g in sel],
                            "r2": float(r2), "coefs": coefs})
        return results

    # -- other families: the same search, one IRLS fit per candidate ----------
    def _fit_irls(self, job, fr: Frame, names):
        p = self.params
        cache: dict[tuple, tuple] = {}

        def score_of(idx):
            key = tuple(sorted(idx))
            if key not in cache:
                cols = [names[i] for i in idx]
                gp = GLMParameters(
                    training_frame=fr, response_column=p.response_column,
                    weights_column=p.weights_column, family=p.family,
                    alpha=0.0, lambda_=0.0,
                    ignored_columns=[n for n in names if n not in cols],
                    standardize=p.standardize, seed=p.seed,
                    max_iterations=p.max_iterations)
                m = GLM(gp).build_impl(Job("ms_sub", work=1.0))
                mm = m.output.training_metrics
                dev = float(getattr(mm, "residual_deviance", mm.mse))
                cache[key] = (-dev, m)
            return cache[key]

        min_k, max_k = self._size_bounds(len(names))
        found = _subset_search(p.mode, len(names), score_of, min_k, max_k,
                               job.check_cancelled)
        results = []
        for sel, _score, m in found:
            results.append({"predictors": [names[i] for i in sel],
                            "r2": float(getattr(m.output.training_metrics,
                                                "r2", np.nan)),
                            "coefs": m.coef()})
        return results
