"""Port parity: MOJO and POJO export, the standalone MOJO scorer and
Generic models (``h2o_tpu_torch/mojo``, ``models/generic.py``) against the
reference (``h2o_tpu/mojo``, ``h2o_tpu/models/generic.py``).

Every reference model is trained once per worker, in a lazy module fixture
on a one-device mesh, on the frames of ``tests/test_mojo.py`` and
``tests/test_mojo_extended.py`` (at most 600 rows, fewer trees and
epochs), and carried over with the port's ``from_reference``. Contracts:

- MOJO entries: the port's writer and the reference's write the same entry
  names and the same bytes in every entry, but the random ``uuid`` line of
  each ``model.ini`` (tolerance 0);
- readers: each package's reader scores the other's MOJO bit-equal to its
  own reader, on the same feature matrix, which both readers build alike
  from their frames (tolerance 0); seven kinds (isolation forest,
  isotonic, word2vec, GLRM, target encoder, uplift DRF, PSVM) take the
  reference writer's MOJO, and the port's writers for isolation forests
  (both forms), isotonic, the target encoder and uplift DRF, carried
  from the reference's models, write the reference's entries (tolerance
  0);
- the port MOJO scores the carried model's own ``predict`` within the
  reference's round-trip tolerances (``test_mojo.py:_roundtrip``: atol
  1e-5, rtol 1e-4; GLM atol 1e-4, its multinomial 2e-4; DL, CoxPH, GAM
  atol 1e-4; RuleFit and the ensemble atol 1e-4, rtol 1e-3);
- POJO source text equal to the reference's for tree and GLM models (the
  oracles ``test_explain_pojo_arff.py:77,95`` and ``test_set_splits.py:
  132``), and a set-split MOJO holding a bitset node
  (``test_set_splits.py:101``: the tree models split their categorical
  column by sets);
- ``Generic`` predictions bit-equal to the scorer's output cast to
  float32, on the model's device (the binomial GBM's MOJOs);
- what the reference's writers refuse (an SVD, a DL autoencoder, a POJO
  of a model that is neither a tree nor a GLM) the port refuses with the
  same message; an XGBoost model exports as the GBM or GLM model it is, as
  in the reference.
"""

import dataclasses
import os
import zipfile

import numpy as np
import pytest

import jax

from h2o_tpu.frame.frame import Frame as JFrame
from h2o_tpu.frame.vec import T_CAT as J_CAT
from h2o_tpu.frame.vec import T_STR as J_STR
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.mojo import easy as jeasy
from h2o_tpu.mojo.pojo import pojo_source as jpojo_source
from h2o_tpu.mojo.reader import MojoModel as JMojo
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import Frame, import_mojo
from h2o_tpu_torch.frame.vec import T_CAT, Vec
from h2o_tpu_torch.mojo import easy as teasy
from h2o_tpu_torch.mojo.format import MojoZipReader, decode_tree
from h2o_tpu_torch.mojo.pojo import pojo_source as tpojo_source
from h2o_tpu_torch.mojo.reader import MojoModel as TMojo

import test_mojo_fixtures as jvm_fixtures
from torch_parity import LazyCases

ONE = meshmod.make_mesh(jax.devices()[:1])


def _frames(cols, cats=None):
    """(reference frame on the one-device mesh, port frame on the CPU) of
    the same numpy columns; ``cats`` maps a column to its domain."""
    cats = cats or {}
    jfr, tfr = JFrame(), Frame()
    for name, arr in cols.items():
        dom = cats.get(name)
        kw = dict(type=J_CAT, domain=list(dom)) if dom else {}
        jfr.add(name, JVec.from_numpy(arr, mesh=ONE, **kw))
        kw = dict(type=T_CAT, domain=list(dom)) if dom else {}
        tfr.add(name, Vec.from_numpy(arr, device="cpu", **kw))
    return jfr, tfr


def _mojo_frame(n=300, seed=1, classes=2):
    """``test_mojo.py:_frame``: two numerics, a 3-level categorical and a
    response (regression, binomial or K-class)."""
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n).astype(np.float32)
    x2 = rng.normal(size=n).astype(np.float32)
    cat = rng.integers(0, 3, size=n).astype(np.float32)
    cats = {"cat": ["a", "b", "c"]}
    if classes == 0:
        y = (x1 * 2 + np.sin(x2) + cat * 0.5
             + rng.normal(scale=0.1, size=n)).astype(np.float32)
    else:
        logits = x1 + 0.8 * x2 * (cat - 1)
        y = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
        if classes > 2:
            y = rng.integers(0, classes, size=n).astype(np.float32)
        cats["y"] = [f"c{i}" for i in range(classes)]
    return _frames({"x1": x1, "x2": x2, "cat": cat, "y": y}, cats)


def _binomial(n, seed, f=2):
    rng = np.random.default_rng(seed)
    cols = {f"x{j + 1}": rng.normal(size=n).astype(np.float32)
            for j in range(f)}
    return rng, cols


def _fit(case):
    """(reference model, reference frame, port frame, port model or None)
    for one case; the port model is the reference's carried over."""
    from h2o_tpu.models import coxph as jcox
    from h2o_tpu.models import deeplearning as jdl
    from h2o_tpu.models import drf as jdrf
    from h2o_tpu.models import ensemble as jens
    from h2o_tpu.models import gam as jgam
    from h2o_tpu.models import gbm as jgbm
    from h2o_tpu.models import glm as jglm
    from h2o_tpu.models import kmeans as jkm
    from h2o_tpu.models import pca as jpca
    from h2o_tpu.models import rulefit as jrf
    from h2o_tpu_torch import (CoxPHModel, DRFModel, GAMModel, GBMModel,
                               KMeansModel, PCAModel, RuleFitModel,
                               StackedEnsembleModel)
    from h2o_tpu_torch.models.deeplearning import DeepLearningModel
    from h2o_tpu_torch.models.glm import GLMModel

    def tree(builder, params, fr, cls=GBMModel, **kw):
        m = builder(params(training_frame=fr[0], response_column="y",
                           **kw)).train_model()
        port = cls.from_reference(
            {k: np.asarray(v) for k, v in m.forest.items()},
            np.asarray(m.f0), None, m.output.names, m.output.domains,
            dataclasses.asdict(m.cfg),
            category=m.output.model_category,
            response_domain=m.output.response_domain,
            cat_nedges=m.cat_nedges, response_column="y", device="cpu")
        return m, fr[0], fr[1], port

    def glm(fr, **kw):
        m = jglm.GLM(jglm.GLMParameters(training_frame=fr[0],
                                        response_column="y", lambda_=0.0,
                                        seed=4, **kw)).train_model()
        return m, fr[0], fr[1], GLMModel.from_reference(m, device="cpu")

    with meshmod.use_mesh(ONE):
        if case == "gbm_regression":
            return tree(jgbm.GBM, jgbm.GBMParameters, _mojo_frame(classes=0),
                        ntrees=3, max_depth=3, seed=1)
        if case == "gbm_binomial":
            return tree(jgbm.GBM, jgbm.GBMParameters, _mojo_frame(classes=2),
                        ntrees=3, max_depth=3, seed=1)
        if case == "gbm_multinomial":
            return tree(jgbm.GBM, jgbm.GBMParameters, _mojo_frame(classes=3),
                        ntrees=3, max_depth=3, seed=2,
                        distribution="multinomial")
        if case == "drf_binomial":
            return tree(jdrf.DRF, jdrf.DRFParameters, _mojo_frame(classes=2),
                        cls=DRFModel, ntrees=3, max_depth=3, seed=3)
        if case == "drf_regression":
            return tree(jdrf.DRF, jdrf.DRFParameters, _mojo_frame(classes=0),
                        cls=DRFModel, ntrees=3, max_depth=3, seed=3)
        if case == "glm_regression":
            return glm(_mojo_frame(classes=0))
        if case == "glm_binomial":
            return glm(_mojo_frame(classes=2))
        if case == "glm_multinomial":
            rng, cols = _binomial(400, 6)
            y = np.argmax(np.stack([cols["x1"], cols["x2"],
                                    -cols["x1"] - cols["x2"]], axis=1)
                          + 0.3 * rng.normal(size=(400, 3)), axis=1)
            cols["y"] = y.astype(np.float32)
            return glm(_frames(cols, {"y": ["r", "g", "b"]}),
                       family="multinomial")
        if case == "kmeans":
            rng = np.random.default_rng(5)
            fr = _frames({"a": rng.normal(size=200).astype(np.float32),
                          "b": rng.normal(size=200).astype(np.float32)})
            m = jkm.KMeans(jkm.KMeansParameters(training_frame=fr[0], k=3,
                                                seed=5)).train_model()
            return m, fr[0], fr[1], KMeansModel.from_reference(m, "cpu")
        if case == "deeplearning":
            rng = np.random.default_rng(0)
            x1 = rng.normal(size=400).astype(np.float32)
            c = rng.integers(0, 3, 400)
            y = (x1 + (c == 1) > 0.5).astype(np.float32)
            fr = _frames({"x1": x1, "c": c.astype(np.float32), "y": y},
                         {"c": ["a", "b", "cc"], "y": ["n", "p"]})
            m = jdl.DeepLearning(jdl.DeepLearningParameters(
                training_frame=fr[0], response_column="y", hidden=[8, 8],
                epochs=1, seed=1)).train_model()
            return m, fr[0], fr[1], DeepLearningModel.from_reference(m, "cpu")
        if case == "pca":
            rng = np.random.default_rng(4)
            X = rng.normal(size=(200, 5)).astype(np.float32)
            X[:, 1] = X[:, 0] * 2 + 0.1 * X[:, 1]
            fr = _frames({f"x{j}": X[:, j] for j in range(5)})
            m = jpca.PCA(jpca.PCAParameters(training_frame=fr[0], k=3,
                                            seed=1)).train_model()
            return m, fr[0], fr[1], PCAModel.from_reference(m, "cpu")
        if case == "coxph":
            rng, cols = _binomial(300, 7)
            cols["t"] = rng.exponential(scale=np.exp(
                -(0.8 * cols["x1"] - 0.4 * cols["x2"]))).astype(np.float32)
            cols["event"] = (rng.random(300) < 0.8).astype(np.float32)
            fr = _frames(cols)
            m = jcox.CoxPH(jcox.CoxPHParameters(
                training_frame=fr[0], response_column="event",
                stop_column="t")).train_model()
            return m, fr[0], fr[1], CoxPHModel.from_reference(m, "cpu")
        if case == "gam":
            rng = np.random.default_rng(0)
            x = rng.uniform(-3, 3, 500).astype(np.float32)
            z = rng.normal(size=500).astype(np.float32)
            y = (np.sin(x) * 2 + 0.5 * z
                 + 0.1 * rng.normal(size=500)).astype(np.float32)
            fr = _frames({"x": x, "z": z, "y": y})
            m = jgam.GAM(jgam.GAMParameters(
                training_frame=fr[0], response_column="y", gam_columns=["x"],
                num_knots=8, scale=0.1, family="gaussian", lambda_=0.0,
                alpha=0.0)).train_model()
            return m, fr[0], fr[1], GAMModel.from_reference(m, "cpu")
        if case == "rulefit":
            rng, cols = _binomial(500, 5)
            cols = {"a": cols["x1"], "b": cols["x2"]}
            cols["y"] = ((cols["a"] > 0.5) & (cols["b"] < 0.0)).astype(
                np.float32)
            fr = _frames(cols, {"y": ["0", "1"]})
            m = jrf.RuleFit(jrf.RuleFitParameters(
                training_frame=fr[0], response_column="y", min_rule_length=2,
                max_rule_length=2, rule_generation_ntrees=2, seed=5,
                family="binomial", model_type="rules_and_linear")
            ).train_model()
            return m, fr[0], fr[1], RuleFitModel.from_reference(m, "cpu")
        if case == "stackedensemble":
            # the gbm_binomial and glm_binomial cases' models as bases,
            # blended on their own training frame
            gbm, jfr, tfr, _ = CASES["gbm_binomial"]
            glm_m = CASES["glm_binomial"][0]
            m = jens.StackedEnsemble(jens.StackedEnsembleParameters(
                training_frame=jfr, response_column="y", blending_frame=jfr,
                base_models=[gbm, glm_m], seed=11)).train_model()
            return m, jfr, tfr, StackedEnsembleModel.from_reference(m, "cpu")
    return _fit_reader_only(case)


def _fit_reader_only(case):
    """A reference model of a kind the reader-only test scores: (reference
    model, reference frame, port frame, the port's carried model, or None
    for the kinds the port cannot train yet)."""
    from h2o_tpu_torch import (IsolationForestModel, IsotonicRegressionModel,
                               TargetEncoderModel, UpliftDRFModel)

    carriers = {"isofor": IsolationForestModel, "eif": IsolationForestModel,
                "isotonic": IsotonicRegressionModel,
                "targetencoder": TargetEncoderModel,
                "uplift": UpliftDRFModel}
    with meshmod.use_mesh(ONE):
        if case in ("isofor", "eif"):
            from h2o_tpu.models.isofor import (ExtendedIsolationForest,
                                               IsolationForest,
                                               IsolationForestParameters)

            X = np.random.default_rng(2).normal(size=(300, 4)).astype(
                np.float32)
            X[:5] += 6.0
            fr = _frames({f"x{j}": X[:, j] for j in range(4)})
            builder = (ExtendedIsolationForest if case == "eif"
                       else IsolationForest)
            m = builder(IsolationForestParameters(
                training_frame=fr[0], ntrees=2, sample_size=64,
                extension_level=2 if case == "eif" else 0,
                seed=3)).train_model()
        elif case == "isotonic":
            from h2o_tpu.models.isotonic import (IsotonicParameters,
                                                 IsotonicRegression)

            rng = np.random.default_rng(2)
            x = rng.uniform(0, 10, 400).astype(np.float32)
            y = (np.sqrt(x) + 0.1 * rng.normal(size=400)).astype(np.float32)
            fr = _frames({"x": x, "y": y})
            m = IsotonicRegression(IsotonicParameters(
                training_frame=fr[0], response_column="y")).train_model()
        elif case == "word2vec":
            from h2o_tpu.models.word2vec import Word2Vec, Word2VecParameters

            rng = np.random.default_rng(6)
            topics = {"fruit": ["apple", "pear", "plum", "grape"],
                      "tech": ["cpu", "gpu", "ram", "disk"]}
            words = []
            for _ in range(200):
                t = "fruit" if rng.random() < 0.5 else "tech"
                words.extend(rng.choice(topics[t], size=5).tolist())
                words.append(None)
            v = JVec(None, len(words), type=J_STR,
                     host_data=np.array(words, dtype=object))
            jfr = JFrame(["words"], [v])
            m = Word2Vec(Word2VecParameters(
                training_frame=jfr, vec_size=8, epochs=2, min_word_freq=5,
                window_size=3, seed=6)).train_model()
            return m, jfr, None, None
        elif case == "glrm":
            from h2o_tpu.models.glrm import GLRM, GLRMParameters

            rng = np.random.default_rng(0)
            A = (rng.normal(size=(150, 3)) @ rng.normal(size=(3, 6))).astype(
                np.float32)
            fr = _frames({f"c{i}": A[:, i] for i in range(6)})
            m = GLRM(GLRMParameters(training_frame=fr[0], k=3,
                                    max_iterations=30, init="SVD",
                                    seed=1)).train_model()
        elif case == "targetencoder":
            from h2o_tpu.models.target_encoder import (
                TargetEncoder, TargetEncoderParameters)

            rng = np.random.default_rng(4)
            c = rng.integers(0, 4, 500)
            y = ((c == 2) | (rng.random(500) < 0.3)).astype(np.float32)
            fr = _frames({"x": rng.normal(size=500).astype(np.float32),
                          "c": c.astype(np.float32), "y": y},
                         {"c": ["a", "b", "c", "d"], "y": ["no", "yes"]})
            m = TargetEncoder(TargetEncoderParameters(
                training_frame=fr[0], response_column="y",
                columns_to_encode=["c"], noise=0.0,
                blending=True)).train_model()
        elif case == "uplift":
            from h2o_tpu.models.uplift import UpliftDRF, UpliftDRFParameters

            rng, cols = _binomial(400, 42)
            treat = rng.integers(0, 2, 400).astype(np.float32)
            p = 0.3 + 0.3 * (cols["x1"] > 0) * treat
            cols["treatment"] = treat
            cols["y"] = (rng.random(400) < p).astype(np.float32)
            fr = _frames(cols, {"treatment": ["0", "1"], "y": ["0", "1"]})
            m = UpliftDRF(UpliftDRFParameters(
                training_frame=fr[0], response_column="y",
                treatment_column="treatment", ntrees=2, max_depth=3, seed=1,
                uplift_metric="KL")).train_model()
        elif case == "psvm":
            from h2o_tpu.models.psvm import PSVM, SVMParameters

            rng = np.random.default_rng(3)
            x = rng.normal(size=(300, 2)).astype(np.float32)
            y = (np.sqrt((x ** 2).sum(1)) < 1.1).astype(np.float32)
            fr = _frames({"x1": x[:, 0], "x2": x[:, 1], "y": y},
                         {"y": ["0", "1"]})
            m = PSVM(SVMParameters(training_frame=fr[0], response_column="y",
                                   kernel_type="gaussian", hyper_param=1.0,
                                   seed=4)).train_model()
        else:
            raise KeyError(case)
    port = (carriers[case].from_reference(m, "cpu") if case in carriers
            else None)
    return m, fr[0], fr[1], port


CASES = LazyCases(_fit)

#: the ensemble's bases are the gbm_binomial and glm_binomial cases' models:
#: the three stay adjacent, so xdist's chunks give them one worker
WRITABLE = ["gbm_regression", "gbm_multinomial", "drf_binomial",
            "drf_regression", "gbm_binomial", "glm_binomial",
            "stackedensemble", "glm_regression", "glm_multinomial", "kmeans",
            "deeplearning", "pca", "coxph", "gam", "rulefit"]
READER_ONLY = ["isofor", "isotonic", "word2vec", "glrm", "targetencoder",
               "uplift", "psvm"]
#: kinds whose writers came with their builders: written by the port from
#: the carried model
NEW_WRITERS = ["isofor", "eif", "isotonic", "targetencoder", "uplift"]
#: (atol, rtol) of the port MOJO against the carried model's predict
_TOL = {"glm_regression": (1e-4, 1e-4), "glm_binomial": (1e-4, 1e-4),
        "glm_multinomial": (2e-4, 1e-4), "deeplearning": (1e-4, 1e-4),
        "pca": (1e-4, 1e-4), "coxph": (1e-4, 1e-4), "gam": (1e-4, 1e-4),
        "rulefit": (1e-4, 1e-3), "stackedensemble": (1e-4, 1e-3)}


def _entries(path) -> dict:
    """name -> bytes of every zip entry, each model.ini's uuid line
    dropped."""
    out = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            data = z.read(name)
            if name.endswith("model.ini"):
                data = b"\n".join(ln for ln in data.split(b"\n")
                                  if not ln.startswith(b"uuid = "))
            out[name] = data
    return out


def _predict_matrix(model, fr) -> np.ndarray:
    """The port model's predictions as the scorer's layout: (R,) or (R, C)
    float64."""
    p = model.predict(fr)
    cols = [p.vec(i).to_numpy().astype(np.float64) for i in range(p.ncol)]
    return cols[0] if len(cols) == 1 else np.stack(cols, axis=1)


def _scores_alike(path, jfr, tfr) -> np.ndarray:
    """Both readers load ``path``; the feature matrices they build from
    their frames are equal and their scores bit-equal. Returns the port
    reader's scores."""
    jr, tr = JMojo.load(path), TMojo.load(path)
    assert tr.columns == jr.columns and tr.domains == jr.domains
    X = tr.feature_frame_matrix(tfr)
    assert np.array_equal(X, jr.feature_frame_matrix(jfr), equal_nan=True)
    a, b = jr.score(X), tr.score(X)
    assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    return b


@pytest.mark.parametrize("case", WRITABLE)
def test_mojo_matches_the_reference(case, tmp_path):
    """The carried model's MOJO equals the reference's entry by entry
    (uuid lines aside); each reader scores the other package's MOJO
    bit-equal to its own (tolerance 0); the port MOJO scores the port
    model's predictions within the round-trip tolerances above. Tree and
    GLM models' POJO source equals the reference's; the binomial GBM's
    splits on its categorical column are set splits, a bitset node in the
    MOJO and a group in the POJO (``test_set_splits.py:101,132``)."""
    jm, jfr, tfr, tm = CASES[case]
    jpath, tpath = str(tmp_path / "ref.zip"), str(tmp_path / "port.zip")
    jm.save_mojo(jpath)
    if case == "gbm_binomial":      # the h2o-py names
        assert tm.download_mojo(tpath) == tpath
    else:
        assert tm.save_mojo(tpath) == tpath
    je, te = _entries(jpath), _entries(tpath)
    assert sorted(te) == sorted(je)
    for name in je:
        assert te[name] == je[name], name
    _scores_alike(jpath, jfr, tfr)
    scores = _scores_alike(tpath, jfr, tfr)
    atol, rtol = _TOL.get(case, (1e-5, 1e-4))
    want = _predict_matrix(tm, tfr)
    if case == "kmeans":
        assert np.array_equal(scores, want)
    elif scores.ndim == 1 or case == "pca":
        np.testing.assert_allclose(scores, want, atol=atol, rtol=rtol)
    else:   # probabilities: the label's cut (> or >= 0.5) may differ
        np.testing.assert_allclose(scores[:, 1:], want[:, 1:], atol=atol,
                                   rtol=rtol)
    if case == "glm_multinomial":   # the reference refuses its POJO
        with pytest.raises(NotImplementedError) as jerr:
            jpojo_source(jm)
        with pytest.raises(NotImplementedError) as terr:
            tpojo_source(tm)
        assert str(terr.value) == str(jerr.value)
    elif tm.algo_name in ("gbm", "drf", "glm"):
        assert tpojo_source(tm) == jpojo_source(jm)
        assert tpojo_source(tm, "SetSplitPojo") == \
            jpojo_source(jm, "SetSplitPojo")
        tm.save_pojo(str(tmp_path / "p.java"))
        assert open(tmp_path / "p.java").read() == jpojo_source(jm)
    if case == "gbm_binomial":   # splits on the 3-level "cat" are sets
        assert "static final boolean[] GRP_" in tpojo_source(tm)
        zr = MojoZipReader(tpath)
        stack = [decode_tree(zr.blob(f"trees/t00_{j:03d}.bin"))
                 for j in range(3)]
        found = False
        while stack:
            nd = stack.pop()
            if nd.leaf_val is None:
                found |= nd.bitset is not None
                stack.extend([nd.left, nd.right])
        assert found, "no bitset node in the set-split MOJO"
        _check_generic_and_easy(jm, tm, tfr, jpath, tpath)


@pytest.mark.parametrize("case", READER_ONLY)
def test_reference_mojo_scores_alike_in_the_port(case, tmp_path):
    """The reference writer's MOJO of the reader-only kinds, scored by
    the port's reader bit-equal to the reference's reader
    (tolerance 0); word2vec's lookups and synonyms alike."""
    jm, jfr, tfr, _ = CASES[case]
    path = str(tmp_path / f"{case}.zip")
    jm.save_mojo(path)
    if case == "word2vec":
        jr, tr = JMojo.load(path), TMojo.load(path)
        words = list(jr.vocab) + ["zzz"]
        assert np.array_equal(tr.transform(words), jr.transform(words),
                              equal_nan=True)
        assert tr.find_synonyms("apple", 3) == jr.find_synonyms("apple", 3)
        return
    scores = _scores_alike(path, jfr, tfr)
    assert np.isfinite(scores).all()


def test_new_writers_match_the_reference(tmp_path):
    """The isolation forest (both forms), isotonic, target encoder and
    uplift DRF writers, one kind after another (one test item: the
    driver's xdist chunks move with the test count): the carried model's
    MOJO equals the reference's entry by entry, uuid lines aside
    (tolerance 0); both readers score it alike (tolerance 0); it scores
    the carried model's ``predict`` within 1e-5 (the isolation forests'
    score column, the isotonic fit, the uplift columns; the target
    encoder's encoded column within 1e-6)."""
    for case in NEW_WRITERS:
        _check_new_writer(case, tmp_path)


def _check_new_writer(case, tmp_path):
    jm, jfr, tfr, tm = CASES[case]
    jpath = str(tmp_path / f"{case}_ref.zip")
    tpath = str(tmp_path / f"{case}_port.zip")
    jm.save_mojo(jpath)
    assert tm.save_mojo(tpath) == tpath
    je, te = _entries(jpath), _entries(tpath)
    assert sorted(te) == sorted(je)
    for name in je:
        assert te[name] == je[name], name
    scores = _scores_alike(tpath, jfr, tfr)
    pred = tm.predict(tfr)
    if case == "targetencoder":
        want = pred.vec("c_te").to_numpy()
        got = scores[:, 0] if scores.ndim == 2 else scores
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    elif case in ("isofor", "eif"):
        got = scores[:, 0] if scores.ndim == 2 else scores
        np.testing.assert_allclose(got, pred.vec(0).to_numpy(), rtol=0,
                                   atol=1e-5)
    else:
        want = _predict_matrix(tm, tfr)
        np.testing.assert_allclose(scores, want, rtol=0, atol=1e-5)


def _check_generic_and_easy(jm, tm, tfr, jpath, tpath):
    """``import_mojo`` (``Generic``) of the port's MOJO and of the
    reference's: predictions on the model's device, bit-equal to the
    scorer's output cast to float32, the label a categorical over the
    response domain; the row wrapper's predictions equal the reference's
    wrapper's."""
    for path in (tpath, jpath):
        g = import_mojo(path, device="cpu")
        assert g.output.model_category == "Binomial"
        assert g.params.response_column == "y"
        p = g.predict(tfr)
        want = TMojo.load(path).predict(tfr).astype(np.float32)
        assert p.names == ["predict", "pc0", "pc1"]
        assert p.vec(0).domain == ["c0", "c1"]
        for j in range(3):
            v = p.vec(j)
            assert v.data.device.type == "cpu"
            assert np.array_equal(v.data[:tfr.nrow].numpy().view(np.int32),
                                  want[:, j].view(np.int32))
    rows = [{"x1": 0.3, "x2": -1.2, "cat": "b"}, {"x1": -2.0, "cat": "zz"}]
    tw = teasy.EasyPredictModelWrapper(
        TMojo.load(tpath), convert_unknown_categorical_levels_to_na=True)
    jw = jeasy.EasyPredictModelWrapper(
        JMojo.load(jpath), convert_unknown_categorical_levels_to_na=True)
    for row in rows:
        assert dataclasses.asdict(tw.predict(row)) == \
            dataclasses.asdict(jw.predict(row))


@pytest.mark.parametrize("case", ["upload_key", "missing_file"])
def test_generic_refuses_what_it_cannot_load(case):
    """A path that names no file: an uploaded MOJO's key (the REST tier)
    raises naming ROADMAP Queue 1 item 13; a missing file path raises
    ``FileNotFoundError``."""
    from h2o_tpu_torch import Generic, GenericParameters

    if case == "upload_key":
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 13"):
            Generic(GenericParameters(path="upload_mojo_7", device="cpu"))
    else:
        with pytest.raises(FileNotFoundError):
            Generic(GenericParameters(path="/nonexistent/m.zip",
                                      device="cpu"))


@pytest.mark.parametrize("booster", ["gbtree", "gblinear"])
def test_xgboost_exports_as_its_model(booster, tmp_path):
    """An XGBoost model is a GBM (gbtree, DART) or GLM (gblinear) model that
    reports "xgboost" on the wire; the reference exports it as that model's
    MOJO and POJO (``algo`` "gbm" or "glm"), and so does the port. Its MOJO
    scores its ``predict`` within 1e-5 (gbtree) or 1e-4 (gblinear)."""
    from h2o_tpu_torch import XGBoost, XGBoostParameters

    _, tfr = _mojo_frame(classes=2)
    m = XGBoost(XGBoostParameters(training_frame=tfr, response_column="y",
                                  ntrees=2, max_depth=2,
                                  booster=booster)).train_model()
    assert m.algo_override == "xgboost"
    path = m.save_mojo(str(tmp_path / "x.zip"))
    scorer = TMojo.load(path)
    assert scorer.algo == ("gbm" if booster == "gbtree" else "glm")
    np.testing.assert_allclose(scorer.predict(tfr)[:, 2],
                               _predict_matrix(m, tfr)[:, 2],
                               atol=1e-5 if booster == "gbtree" else 1e-4,
                               rtol=1e-4)
    assert "score0" in open(m.save_pojo(str(tmp_path / "x.java"))).read()


@pytest.mark.parametrize("case", ["svd_mojo", "autoencoder_mojo",
                                  "kmeans_pojo"])
def test_export_refuses_as_the_reference(case, tmp_path):
    """What the reference's writers refuse raises the same
    ``NotImplementedError`` message in the port: an SVD MOJO (no writer),
    a DL autoencoder's MOJO, a POJO of a model that is neither a tree nor
    a GLM (a KMeans model: its message from the reference's codegen)."""
    rng = np.random.default_rng(3)
    cols = {f"x{j}": rng.normal(size=200).astype(np.float32)
            for j in range(3)}
    tfr = Frame.from_dict(cols, device="cpu")
    if case == "svd_mojo":
        from h2o_tpu_torch import SVD, SVDParameters

        m = SVD(SVDParameters(training_frame=tfr, nv=2)).train_model()
        want, call = "MOJO export not implemented for 'svd'", m.save_mojo
    elif case == "autoencoder_mojo":
        from h2o_tpu_torch import DeepLearning, DeepLearningParameters

        m = DeepLearning(DeepLearningParameters(
            training_frame=tfr, autoencoder=True, hidden=[2], epochs=1,
            seed=1)).train_model()
        want = ("autoencoder MOJO export not supported (the reference "
                "exports supervised DL only)")
        call = m.save_mojo
    else:
        from h2o_tpu_torch import KMeans, KMeansParameters

        m = KMeans(KMeansParameters(training_frame=tfr, k=2,
                                    seed=5)).train_model()
        with pytest.raises(NotImplementedError) as e:
            jpojo_source(m)         # the reference's codegen, same model
        want, call = str(e.value), m.save_pojo
    with pytest.raises(NotImplementedError) as e:
        call(str(tmp_path / "out"))
    assert str(e.value) == want


#: the JVM-written MOJOs of ``tests/test_mojo_fixtures.py``, from there
JVM_ROOT, JVM_FIXTURES = jvm_fixtures.ROOT, jvm_fixtures.FIXTURES


@pytest.mark.skipif(not os.path.isdir(JVM_ROOT),
                    reason="reference fixtures not present")
def test_jvm_fixtures_score_alike():
    """``test_mojo_fixtures.py``'s JVM-written MOJOs load through the
    port's reader and score bit-equal to the reference's reader
    (tolerance 0), each fixture in turn."""
    for rel in JVM_FIXTURES:
        path = os.path.join(JVM_ROOT, rel)
        jr, tr = JMojo.load(path), TMojo.load(path)
        if jr.algo == "word2vec":
            words = list(jr.vocab)[:3]
            assert np.array_equal(tr.transform(words), jr.transform(words))
            continue
        nf = jr.n_features or (len(jr.columns) - (1 if jr.supervised else 0))
        rng = np.random.default_rng(0)
        X = rng.normal(size=(6, nf))
        for ci, dom in enumerate(jr.domains[:nf]):
            if dom is not None:
                X[:, ci] = rng.integers(0, len(dom), size=6)
        assert np.array_equal(np.asarray(tr.score(X)),
                              np.asarray(jr.score(X)), equal_nan=True), rel
