"""ANOVA GLM — Type III analysis of deviance over a GLM
(``h2o_tpu/models/anovaglm.py``, `hex/anovaglm/`).

Fits the full GLM and one reduced GLM per term (each predictor, and with
``highest_interaction_term`` >= 2 each pairwise product of two numeric
predictors), then reports each term's deviance contribution with a
likelihood-ratio χ² test. Every fit is the port's GLM, so on the card each
IRLS iteration is one launch of the Gram kernel. The χ² tail is scipy's
regularized upper incomplete gamma in float64 (the reference takes
``1 - gammainc`` in float32).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..backend.jobs import Job
from ..frame.vec import Vec
from .glm import GLM, GLMParameters
from .model_base import Model, ModelBuilder, ModelOutput


def chi2_sf(x: float, df: float) -> float:
    """P(X > x) for X ~ χ²(df)."""
    if df <= 0 or not np.isfinite(x):
        return np.nan
    from scipy.special import gammaincc

    return float(gammaincc(df / 2.0, max(x, 0.0) / 2.0))


@dataclass
class ANOVAGLMParameters(GLMParameters):
    """The reference's `hex/schemas/ANOVAGLMV3` fields."""

    highest_interaction_term: int = 2   # 1 = main effects only; 2 = pairs
    save_transformed_framekeys: bool = False


class ANOVAGLMModel(Model):
    algo_name = "anovaglm"

    def __init__(self, params, output, full_model, anova_table):
        super().__init__(params, output)
        self.full_model = full_model
        self.anova_table = anova_table   # one dict per term

    def score0(self, X):
        return self.full_model.score0(X)

    def adapt_frame(self, fr):
        return self.full_model.adapt_frame(fr)

    def result(self):
        return self.anova_table


class ANOVAGLM(ModelBuilder):
    algo_name = "anovaglm"

    def build_impl(self, job: Job) -> ANOVAGLMModel:
        p = self.params
        fr = p.training_frame
        names = self.feature_names()
        _y, category, resp_domain = self.response_info()

        # terms: every main effect; pairwise products of (raw) numerics when
        # asked, as the reference's transformed frame holds them
        terms = list(names)
        work = fr
        if p.highest_interaction_term >= 2 and len(names) >= 2:
            work = fr.subframe(fr.names)
            for i in range(len(names)):
                for j in range(i + 1, len(names)):
                    a, b = names[i], names[j]
                    if (work.vec(a).is_categorical()
                            or work.vec(b).is_categorical()):
                        continue
                    cname = f"{a}:{b}"
                    work.add(cname, Vec(work.vec(a).data * work.vec(b).data,
                                        fr.nrow))
                    terms.append(cname)

        def fit(cols):
            gp = p.clone(training_frame=work, nfolds=0, ignored_columns=[
                c for c in terms if c not in cols])
            m = GLM(gp).build_impl(Job("anovaglm_sub", work=1.0))
            rank = int(np.sum(np.abs(np.asarray(m.beta)) > 1e-12))
            return m, float(m.output.training_metrics.residual_deviance), rank

        job.check_cancelled()
        full_model, full_dev, full_rank = fit(terms)
        # families with a free scale test the deviance scaled by the
        # deviance-based dispersion full_dev / (n - rank)
        fam = (p.family or "AUTO").lower()
        if fam == "auto":
            fam = "binomial" if category == "Binomial" else "gaussian"
        res_df = getattr(full_model.output.training_metrics,
                         "residual_degrees_of_freedom", None)
        if fam in ("gaussian", "tweedie", "gamma", "quasibinomial"):
            dispersion = full_dev / max(res_df or 1, 1)
        else:
            dispersion = 1.0

        table = []
        for term in terms:
            job.check_cancelled()
            _, red_dev, red_rank = fit([c for c in terms if c != term])
            df = max(full_rank - red_rank, 1)
            lr = max(red_dev - full_dev, 0.0)
            table.append({"term": term, "df": df, "deviance": lr,
                          "p_value": chi2_sf(lr / max(dispersion, 1e-300),
                                             df)})

        output = ModelOutput()
        output.names = names
        output.domains = {n: fr.vec(n).domain for n in names}
        output.response_domain = list(resp_domain) if resp_domain else None
        output.model_category = category
        output.training_metrics = full_model.output.training_metrics
        model = ANOVAGLMModel(p, output, full_model, table)
        job.update(1.0)
        return model
