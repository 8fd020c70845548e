"""Port parity: the multinomial GLM (``h2o_tpu_torch/models/glm.py``) and
stacked ensembles (``h2o_tpu_torch/models/ensemble.py``) against the
reference (``h2o_tpu/models/glm.py``, ``h2o_tpu/models/ensemble.py``), the
reference on a one-device mesh. Each reference model is trained once, in
module-scoped fixtures.

Contracts and tolerances:
- the multinomial GLM on a 3-class frame (per-class block IRLS, every step
  one Gram): coefficients within 1e-4 x max(1, |beta|) (the Gram's float32
  sums in other orders through 6 sweeps of host solves), training logloss,
  mean per-class error and MSE within 1e-5; a model carried over with
  ``GLMModel.from_reference`` scores the reference's probabilities within
  1e-6;
- ensembles of a GBM and a GLM (2 folds, Modulo, holdout
  predictions kept) in CV mode and in blending mode, under the ``AUTO``
  metalearner (a non-negative binomial GLM): the level-one columns within
  1e-5 (the bases' holdout or blending predictions), the metalearner's
  coefficients within 1e-4 x max(1, |beta|), the ensemble's predictions
  within 1e-4 and its AUC on a frame within 1e-4; an ensemble carried over
  with ``StackedEnsembleModel.from_reference`` scores the reference's
  predictions within 1e-5;
- a multiclass ensemble (a multinomial GBM and the multinomial GLM) under
  its multinomial GLM metalearner, which ignores ``non_negative`` as the
  reference's does: level-one columns within 1e-5, predictions within
  1e-4;
- base models without CV holdout predictions raise the reference's
  ``ValueError``; a saved ensemble loads and scores bit-equal.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from h2o_tpu.models.ensemble import StackedEnsemble as JStackedEnsemble
from h2o_tpu.models.ensemble import \
    StackedEnsembleParameters as JStackedEnsembleParameters
from h2o_tpu.models.gbm import GBM as JGBM
from h2o_tpu.models.gbm import GBMParameters as JGBMParameters
from h2o_tpu.models.glm import GLM as JGLM
from h2o_tpu.models.glm import GLMParameters as JGLMParameters
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import (GBM, GLM, GBMParameters,
                           GLMModel, GLMMultinomialModel, GLMParameters,
                           StackedEnsemble, StackedEnsembleModel,
                           StackedEnsembleParameters, load_model)

torch.set_num_threads(2)

COEF_TOL = 1e-4
#: frames whose GBM fold forests meet no near-tied gains (two candidate
#: splits whose gains differ only in float32 rounding, which either
#: package may break either way): the forest contract's precondition
BINOM_SEED = 1
MULTI_SEED = 6


def _binom(n, seed):
    rng = np.random.default_rng(seed)
    cols = {f"x{j}": rng.normal(size=n).astype(np.float32) for j in range(3)}
    logit = 1.5 * cols["x0"] - cols["x1"] + 0.5 * cols["x0"] * cols["x1"]
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return cols, y


def _multi(n, seed):
    rng = np.random.default_rng(seed)
    cols = {f"x{j}": rng.normal(size=n).astype(np.float32) for j in range(3)}
    eta = np.stack([cols["x0"], 0.8 * cols["x1"] - 0.5 * cols["x2"],
                    -0.6 * cols["x0"] + 0.4 * cols["x2"]], axis=1)
    p = np.exp(eta) / np.exp(eta).sum(axis=1, keepdims=True)
    u = rng.random(n)[:, None]
    y = (u > np.cumsum(p, axis=1)).sum(axis=1).astype(np.float32)
    return cols, y


def _assert_coef_close(tb, jb):
    tb, jb = np.asarray(tb, np.float64), np.asarray(jb, np.float64)
    assert tb.shape == jb.shape
    assert np.all(np.abs(tb - jb) <= COEF_TOL * np.maximum(1.0, np.abs(jb)))


def _probs(pred_frame, nrow):
    return np.stack([v.to_numpy()[:nrow] for v in pred_frame.vecs[1:]], 1)


def _assert_level_one_close(jse, tse):
    jl, tl = jse.metalearner.params.training_frame, \
        tse.metalearner.params.training_frame
    assert tl.ncol == jl.ncol and tl.nrow == jl.nrow
    for j in range(jl.ncol - 1):   # the last column is the response
        np.testing.assert_allclose(tl.vec(j).to_numpy(), jl.vec(j).to_numpy(),
                                   rtol=0, atol=1e-5)


def test_multinomial_glm_and_multiclass_ensemble_match_the_reference(
        multiclass):
    """The multiclass ensemble's GLM base (its main fit is the plain fit
    on the whole frame), then the ensemble. One test reads the fixture, so
    a parallel test runner trains it once."""
    one, jfr, fr, jb, tb, jse, tse = multiclass
    jm, tm = jb[-1], tb[-1]
    assert type(tm) is GLMMultinomialModel
    assert tm.beta.shape == np.asarray(jm.beta).shape == (3, 4)
    _assert_coef_close(tm.beta, jm.beta)
    jc, tc = jm.coef(), tm.coef()
    assert list(tc) == list(jc) == ["a", "b", "c"]
    for k in jc:
        assert list(tc[k]) == list(jc[k])
        _assert_coef_close(list(tc[k].values()), list(jc[k].values()))
    jmm, tmm = jm.output.training_metrics, tm.output.training_metrics
    for name in ("logloss", "mean_per_class_error", "mse"):
        assert getattr(tmm, name) == pytest.approx(getattr(jmm, name),
                                                   abs=1e-5)
    # the carried model scores the reference's probabilities
    carried = GLMModel.from_reference(jm, device="cpu")
    assert type(carried) is GLMMultinomialModel
    np.testing.assert_allclose(_probs(carried.predict(fr), fr.nrow),
                               _probs(jm.predict(jfr), fr.nrow),
                               rtol=0, atol=1e-6)
    # the ensemble
    assert tse.output.model_category == "Multinomial"
    assert tse.metalearner.params.non_negative   # set, and not acted on
    _assert_level_one_close(jse, tse)
    np.testing.assert_allclose(_probs(tse.predict(fr), fr.nrow),
                               _probs(jse.predict(jfr), fr.nrow),
                               rtol=0, atol=1e-4)


def _bases_both(one, jfr, fr, common, multiclass=False):
    """The same base models in both packages, a GBM and a GLM:
    (reference list, port list)."""
    specs = [(JGBM, JGBMParameters, GBM, GBMParameters,
              dict(ntrees=5, max_depth=3)),
             (JGLM, JGLMParameters, GLM, GLMParameters,
              dict(family="multinomial" if multiclass else "binomial"))]
    js, ts = [], []
    for jb, jp, tb, tpc, kw in specs:
        with meshmod.use_mesh(one):
            js.append(jb(jp(training_frame=jfr, **common, **kw)).train_model())
        ts.append(tb(tpc(training_frame=fr, **common, **kw)).train_model())
    return js, ts


def _ensemble_both(one, jfr, fr, jbases, tbases, **kw):
    with meshmod.use_mesh(one):
        jse = JStackedEnsemble(JStackedEnsembleParameters(
            training_frame=jfr, response_column="y", base_models=jbases,
            seed=11, **kw.get("j", {}))).train_model()
    tse = StackedEnsemble(StackedEnsembleParameters(
        training_frame=fr, response_column="y", base_models=tbases, seed=11,
        **kw.get("t", {}))).train_model()
    return jse, tse


CV = dict(response_column="y", nfolds=2, seed=11, fold_assignment="Modulo",
          keep_cross_validation_predictions=True)


@pytest.fixture(scope="module")
def cv_mode():
    cols, y = _binom(600, BINOM_SEED)
    one, jfr, fr = tp.frames(cols, y, ["n", "p"])
    jb, tb = _bases_both(one, jfr, fr, CV)
    jse, tse = _ensemble_both(one, jfr, fr, jb, tb)
    return one, jfr, fr, jb, tb, jse, tse


@pytest.fixture(scope="module")
def multiclass():
    cols, y = _multi(600, MULTI_SEED)
    one, jfr, fr = tp.frames(cols, y, ["a", "b", "c"])
    jb, tb = _bases_both(one, jfr, fr, CV, multiclass=True)
    jse, tse = _ensemble_both(one, jfr, fr, jb, tb)
    return one, jfr, fr, jb, tb, jse, tse


def _assert_ensembles_close(jse, tse, jfr, fr):
    _assert_level_one_close(jse, tse)
    _assert_coef_close(tse.metalearner.beta, jse.metalearner.beta)
    np.testing.assert_allclose(_probs(tse.predict(fr), fr.nrow),
                               _probs(jse.predict(jfr), fr.nrow),
                               rtol=0, atol=1e-4)


def test_cv_stacking_and_blending_match_the_reference(cv_mode, tmp_path):
    """CV stacking, the carried ensemble, a save and load, and blending on
    the same bases. One test reads the fixture, so a parallel test runner
    trains it once."""
    one, jfr, fr, jb, tb, jse, tse = cv_mode
    assert type(tse) is StackedEnsembleModel
    assert [m.key for m in tse.base_models] == [m.key for m in tb]
    # AUTO: a non-negative binomial GLM over the bases' p1 columns
    assert tse.metalearner.params.non_negative
    assert np.all(tse.metalearner.beta[:-1] >= 0)
    _assert_ensembles_close(jse, tse, jfr, fr)
    with meshmod.use_mesh(one):
        jauc = jse.model_performance(jfr).auc
    assert tse.model_performance(fr).auc == pytest.approx(jauc, abs=1e-4)
    assert tse.model_performance(fr).auc > 0.7
    # carried over with from_reference
    carried = StackedEnsembleModel.from_reference(jse, device="cpu")
    assert [m.key for m in carried.base_models] == \
        [m.key for m in jse.base_models]
    np.testing.assert_allclose(_probs(carried.predict(fr), fr.nrow),
                               _probs(jse.predict(jfr), fr.nrow),
                               rtol=0, atol=1e-5)
    # saved and loaded
    path = tse.save(str(tmp_path / "se.bin"))
    back = load_model(path, device="cpu")
    assert type(back) is StackedEnsembleModel
    for a, b in zip(tse.predict(fr).vecs, back.predict(fr).vecs):
        assert torch.equal(a.data, b.data)
    # blending: the same bases score a held-out frame of the generator
    bcols, by = _binom(300, 5)
    _, jbl, bl = tp.frames(bcols, by, ["n", "p"])
    jse, tse = _ensemble_both(one, jfr, fr, jb, tb, j=dict(blending_frame=jbl),
                              t=dict(blending_frame=bl))
    _assert_ensembles_close(jse, tse, jbl, bl)
    with meshmod.use_mesh(one):
        jauc = jse.model_performance(jbl).auc
    assert tse.model_performance(bl).auc == pytest.approx(jauc, abs=1e-4)


def test_bases_without_holdout_predictions_raise():
    cols, y = _binom(300, BINOM_SEED)
    fr = tp.frames(cols, y, ["n", "p"])[2]
    gbm = GBM(GBMParameters(training_frame=fr, response_column="y", ntrees=2,
                            seed=1)).train_model()
    with pytest.raises(ValueError, match="holdout"):
        StackedEnsemble(StackedEnsembleParameters(
            training_frame=fr, response_column="y",
            base_models=[gbm])).train_model()


@pytest.mark.parametrize("algo", ["glm", "gbm", "drf", "deeplearning"])
def test_every_metalearner_trains(algo):
    """Each ``metalearner_algorithm`` of the reference builds its model on
    the level-one frame and the ensemble scores every row."""
    cols, y = _binom(300, BINOM_SEED)
    fr = tp.frames(cols, y, ["n", "p"])[2]
    common = dict(training_frame=fr, **CV)
    bases = [GBM(GBMParameters(ntrees=3, max_depth=3, **common)).train_model(),
             GLM(GLMParameters(family="binomial", **common)).train_model()]
    params = {"gbm": dict(ntrees=3, max_depth=2),
              "drf": dict(ntrees=3, max_depth=3),
              "deeplearning": dict(hidden=[3], epochs=1)}.get(algo, {})
    se = StackedEnsemble(StackedEnsembleParameters(
        training_frame=fr, response_column="y", base_models=bases, seed=3,
        metalearner_algorithm=algo,
        metalearner_params=params)).train_model()
    assert se.metalearner.algo_name == algo
    assert se.metalearner.output.names == [m.key for m in bases]
    p1 = se.predict(fr).vec(2).to_numpy()
    assert p1.shape == (300,) and np.isfinite(p1).all()
    assert np.isfinite(se.model_performance(fr).auc)
