"""Port parity: split finding, the GBM build, scoring, metrics and the
weights carry-over of ``h2o_tpu_torch`` against the reference
(``h2o_tpu/models``), plus the port's import and refusal contracts.

The end-to-end case trains the same bernoulli GBM (20k rows x 6 features,
5 trees at depth 3, all sampling rates 1) in both packages, the JAX one on
a one-device mesh. Contracts and tolerances:

- forest structure (split features, NA directions) exactly equal, split
  thresholds within 1e-6 relative (the bin edges' own tolerance);
- leaf values and predictions within 1e-5: the histograms' g/h sums run in
  different orders, and XLA's and torch's exp differ in the last ulp;
- training AUC within 1e-4: the 1024-bin AUC can move by one row's share
  when a prediction crosses a bin edge;
- the reference forest loaded with ``GBMModel.from_reference`` scores the
  reference's rows within 1e-6;
- split finding on one histogram: identical (feature, bin, NA direction)
  and gains at rtol 1e-5.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o_tpu.backend.kernels import hist as jhist
from h2o_tpu.frame.frame import Frame as JFrame
from h2o_tpu.frame.vec import T_CAT as J_CAT
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.models import distributions as jdist
from h2o_tpu.models import metrics as jmetrics
from h2o_tpu.models.gbm import GBM as JGBM
from h2o_tpu.models.gbm import GBMParameters as JGBMParameters
from h2o_tpu.models.tree import binning as jbinning
from h2o_tpu.models.tree import engine as jengine
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import (GBM, Frame, GBMModel, GBMParameters, XGBoost,
                           XGBoostParameters)
from h2o_tpu_torch.frame.vec import T_CAT, Vec
from h2o_tpu_torch.models import distributions as tdist
from h2o_tpu_torch.models import metrics as tmetrics
from h2o_tpu_torch.models.tree import engine as tengine

torch.set_num_threads(2)

N, F = 20_000, 6
KW = dict(response_column="y", ntrees=5, max_depth=3, seed=42)


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    cols = {f"x{j}": rng.normal(size=n).astype(np.float32) for j in range(F)}
    cols["x1"][rng.random(n) < 0.1] = np.nan
    logit = (cols["x0"] - 0.5 * np.nan_to_num(cols["x1"])
             + 0.3 * cols["x2"] * cols["x3"])
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return cols, y


def _port_frame(cols, y):
    fr = Frame.from_dict(cols, device="cpu")
    fr.add("y", Vec.from_numpy(y, type=T_CAT, domain=["0", "1"],
                               device="cpu"))
    return fr


def _train_both():
    cols, y = _data()
    one = meshmod.make_mesh(jax.devices()[:1])
    with meshmod.use_mesh(one):
        jfr = JFrame.from_dict(cols, mesh=one)
        jfr.add("y", JVec.from_numpy(y, type=J_CAT, domain=["0", "1"],
                                     mesh=one))
        jm = JGBM(JGBMParameters(training_frame=jfr, **KW)).train_model()
        jraw = np.asarray(jm.score0(jm.adapt_frame(jfr)))[:N]
        jedges = jbinning.compute_bin_edges_cols(
            [jfr.vec(n) for n in jm.output.names], np.zeros(F, bool), 20)
    fr = _port_frame(cols, y)
    tm = GBM(GBMParameters(training_frame=fr, **KW)).train_model()
    traw = tm.score0(tm.adapt_frame(fr)).numpy()[:N]
    return jm, jraw, jedges, tm, traw, fr


def test_gbm_end_to_end_matches_the_reference():
    """One test for the whole slice (the reference's training compile is
    most of its time, so it is paid once): forest structure, leaf values,
    predictions, training metrics, and the carry-over of the reference's
    forest into the port."""
    jm, jraw, jedges, tm, traw, fr = _train_both()
    jf = {k: np.asarray(v) for k, v in jm.forest.items()}
    tf = {k: v.numpy() for k, v in tm.forest.items()}

    assert np.array_equal(jf["feat"], tf["feat"])
    assert np.array_equal(jf["nanL"], tf["nanL"])
    split = jf["feat"] >= 0
    assert split[:, 0].all() and split.sum() > 5 * 3
    np.testing.assert_allclose(tf["thr"][split], jf["thr"][split], rtol=1e-6)

    np.testing.assert_allclose(tf["val"], jf["val"], atol=1e-5)
    assert float(tm.f0) == pytest.approx(float(jm.f0), rel=1e-6)
    np.testing.assert_allclose(traw, jraw, atol=1e-5)

    jmm, tmm = jm.output.training_metrics, tm.output.training_metrics
    assert tmm.auc == pytest.approx(jmm.auc, abs=1e-4)
    assert tmm.logloss == pytest.approx(jmm.logloss, rel=1e-5)
    assert tmm.nobs == jmm.nobs == N

    m = GBMModel.from_reference(
        jf, np.asarray(jm.f0), jedges, jm.output.names, jm.output.domains,
        dataclasses.asdict(jm.cfg), category="Binomial",
        response_domain=["0", "1"], device="cpu")
    raw = m.score0(m.adapt_frame(fr)).numpy()[:N]
    np.testing.assert_allclose(raw[:, 1:], jraw[:, 1:], atol=1e-6)
    pred = m.predict(fr)
    assert pred.names == ["predict", "p0", "p1"]
    assert pred.vec("p1").to_numpy().shape == (N,)


def _split_hist(n_lv=8, seed=1):
    """A level histogram of bernoulli channels from the reference's scan:
    feature 0 has no NAs and carries the signal (NA-left/NA-right ties),
    node n_lv-1 is empty (all candidates -inf)."""
    rng = np.random.default_rng(seed)
    R, Fh, B = 8192, 5, 21
    codes = rng.integers(0, B - 1, (R, Fh))
    codes[:, 1:] = np.where(rng.random((R, Fh - 1)) < 0.1, B - 1,
                            codes[:, 1:])
    lc = rng.integers(0, n_lv - 1, R).astype(np.int32)
    p = 1 / (1 + np.exp(-(codes[:, 0] - 9.5) / 4))
    y = (rng.random(R) < p).astype(np.float32)
    f = rng.normal(scale=0.1, size=R).astype(np.float32)
    pr = 1 / (1 + np.exp(-f))
    vv = np.stack([np.ones(R), pr - y, pr * (1 - pr)], 1).astype(np.float32)
    return np.array(jhist.level_hist_blocks(
        jnp.asarray(codes, jnp.int8), jnp.asarray(lc), jnp.asarray(vv),
        n_lv=n_lv, nbins_tot=B, block=1024, backend="xla"))


@pytest.mark.parametrize("reg_lambda,reg_alpha", [(0.0, 0.0), (1.0, 0.5)])
def test_find_splits_matches_the_reference(reg_lambda, reg_alpha):
    hist = _split_hist()
    Fh, n_lv = hist.shape[:2]
    edge_ok = np.ones((Fh, 19), bool)
    edge_ok[3, 12:] = False                       # a column with fewer cuts
    colmask = np.ones((Fh, n_lv), bool)
    kw = dict(nbins=20, min_rows=10.0, reg_lambda=reg_lambda,
              reg_alpha=reg_alpha)
    ref = jengine._find_splits(jnp.asarray(hist), jnp.asarray(colmask),
                               jnp.asarray(edge_ok), jengine.TreeConfig(**kw))
    port = tengine._find_splits(torch.from_numpy(hist),
                                torch.from_numpy(colmask),
                                torch.from_numpy(edge_ok),
                                tengine.TreeConfig(**kw))
    for i in (1, 2, 3):                            # feat, bin, NA direction
        assert np.array_equal(np.asarray(ref[i]), port[i].numpy())
    assert int(port[1][0]) == 0 and not bool(port[3][0])   # tie -> NA right
    assert not np.isfinite(port[0][-1].item())             # empty node
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), rtol=1e-5)
    for i in (4, 5, 6):                            # node weight, child values
        np.testing.assert_allclose(port[i].numpy(), np.asarray(ref[i]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B", [3, 21, 65, 301])
def test_split_sums_keep_the_cpu_rounding(B):
    """The split search's node totals and prefix sums, written so the card
    rounds as the CPU does, equal the CPU's own ``sum`` and ``cumsum`` of
    a float32 histogram bit for bit (values over 12 binary orders of
    magnitude, so any other order of adds would show)."""
    rng = np.random.default_rng(B)
    hist = torch.from_numpy((rng.normal(size=(5, 7, B, 3))
                             * np.exp2(rng.integers(-6, 6, (5, 7, B, 3))))
                            .astype(np.float32))
    for c, tot in enumerate(tengine._node_sums(hist)):
        assert torch.equal(tot, hist[..., c].sum(dim=2)[0])
    assert torch.equal(tengine._cumsum64(hist[..., 1]),
                       torch.cumsum(hist[..., 1], dim=2))


@pytest.mark.parametrize("name", ["bernoulli", "gaussian"])
def test_distributions_match_the_reference(name):
    rng = np.random.default_rng(2)
    y = (rng.random(1000) < 0.4).astype(np.float32)
    f = rng.normal(size=1000).astype(np.float32)
    w = rng.random(1000).astype(np.float32)
    jd = jdist.get_distribution(name)
    td = tdist.get_distribution(name)
    jy, jf, jw = map(jnp.asarray, (y, f, w))
    ty, tf, tw = map(torch.from_numpy, (y, f, w))
    for fn in ("gradient", "hessian", "deviance"):
        np.testing.assert_allclose(getattr(td, fn)(ty, tf, tw).numpy(),
                                   np.asarray(getattr(jd, fn)(jy, jf, jw)),
                                   rtol=1e-6, atol=1e-7)
    assert float(td.init_f(ty, tw)) == pytest.approx(
        float(jd.init_f(jy, jw)), rel=1e-6)


def test_metrics_match_the_reference():
    rng = np.random.default_rng(4)
    y = (rng.random(5000) < 0.3).astype(np.float32)
    p = np.clip(0.3 + 0.4 * (y - 0.3) + rng.normal(scale=0.2, size=5000),
                0.01, 0.99).astype(np.float32)
    y[::50] = np.nan                              # NA / padding rows drop out
    jb = jmetrics.make_binomial_metrics(jnp.asarray(y), jnp.asarray(p))
    tb = tmetrics.make_binomial_metrics(torch.from_numpy(y),
                                        torch.from_numpy(p))
    assert tb.nobs == jb.nobs
    for k in ("auc", "pr_auc", "ks", "max_f1", "mean_per_class_error"):
        assert getattr(tb, k) == pytest.approx(getattr(jb, k), abs=1e-6)
    for k in ("logloss", "mse"):
        assert getattr(tb, k) == pytest.approx(getattr(jb, k), rel=1e-5)
    jr = jmetrics.make_regression_metrics(jnp.asarray(y), jnp.asarray(p))
    tr = tmetrics.make_regression_metrics(torch.from_numpy(y),
                                          torch.from_numpy(p))
    for k in ("mse", "mae", "r2", "rmsle"):
        assert getattr(tr, k) == pytest.approx(getattr(jr, k), rel=1e-5)


def test_import_loads_no_jax_and_nothing_of_the_reference():
    code = ("import sys, h2o_tpu_torch, h2o_tpu_torch.models.gbm, "
            "h2o_tpu_torch.backend.kernels.hist, "
            "h2o_tpu_torch.models.tree.engine, "
            "h2o_tpu_torch.models.tree.binning, "
            "h2o_tpu_torch.models.model_base, h2o_tpu_torch.frame.chunks, "
            "h2o_tpu_torch.models.glm, h2o_tpu_torch.models.datainfo, "
            "h2o_tpu_torch.backend.kernels.gram, h2o_tpu_torch.models.drf, "
            "h2o_tpu_torch.utils.threefry, h2o_tpu_torch.models.xgboost, "
            "h2o_tpu_torch.models.distributions, h2o_tpu_torch.io.parser, "
            "h2o_tpu_torch.frame.split, h2o_tpu_torch.utils.twodimtable, "
            "h2o_tpu_torch.backend.kvstore, h2o_tpu_torch.backend.jobs, "
            "h2o_tpu_torch.backend.persist, h2o_tpu_torch.utils.failpoints, "
            "h2o_tpu_torch.utils.log, h2o_tpu_torch.models.deeplearning, "
            "h2o_tpu_torch.models.kmeans, h2o_tpu_torch.models.pca, "
            "h2o_tpu_torch.models.grid, h2o_tpu_torch.models.automl, "
            "h2o_tpu_torch.models.ensemble, h2o_tpu_torch.models.explain, "
            "h2o_tpu_torch.models.tree.shap, h2o_tpu_torch.utils.linalg, "
            "h2o_tpu_torch.models.anovaglm, "
            "h2o_tpu_torch.models.modelselection, "
            "h2o_tpu_torch.utils.optim, h2o_tpu_torch.models.gam, "
            "h2o_tpu_torch.models.rulefit, h2o_tpu_torch.models.coxph, "
            "h2o_tpu_torch.mojo.format, h2o_tpu_torch.mojo.reader, "
            "h2o_tpu_torch.mojo.writer, h2o_tpu_torch.mojo.pojo, "
            "h2o_tpu_torch.mojo.easy, h2o_tpu_torch.models.generic, "
            "h2o_tpu_torch.io.avro, h2o_tpu_torch.io.xlsx, "
            "h2o_tpu_torch.io.xls, h2o_tpu_torch.models.uplift, "
            "h2o_tpu_torch.models.dt, h2o_tpu_torch.models.isofor, "
            "h2o_tpu_torch.models.adaboost, h2o_tpu_torch.models.naivebayes, "
            "h2o_tpu_torch.models.target_encoder, "
            "h2o_tpu_torch.models.isotonic, h2o_tpu_torch.models.quantile, "
            "h2o_tpu_torch.models.infogram, h2o_tpu_torch.models.segments, "
            "h2o_tpu_torch.models.psvm, h2o_tpu_torch.models.glrm, "
            "h2o_tpu_torch.models.aggregator, "
            "h2o_tpu_torch.models.word2vec; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'h2o_tpu', 'optax')); print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _one_tree(fr):
    return GBM(GBMParameters(training_frame=fr, **dict(KW, ntrees=1))
               ).train_model()


def _grid_lbfgs(fr, _tmp):
    """A GLM grid that meets a refusal: L_BFGS trains now, so the combo
    that refuses is ``feature_parallelism=2`` (the case keeps its id)."""
    from h2o_tpu_torch import GLM, GLMParameters, GridSearch

    GridSearch(GLM, GLMParameters(training_frame=fr, response_column="y",
                                  family="binomial"),
               {"solver": ["IRLSM", "L_BFGS"],
                "feature_parallelism": [1, 2]}).train()


def _automl_lbfgs(fr, _tmp):
    """An AutoML step that meets a refusal (``feature_parallelism=2``; the
    case keeps its id from when L_BFGS was refused)."""
    from h2o_tpu_torch import H2OAutoML
    from h2o_tpu_torch.models import automl

    plan = [automl.Step("GBM", "def_1", automl._model_step(
                "gbm", dict(ntrees=1, max_depth=2))),
            automl.Step("GLM", "lbfgs", automl._model_step(
                "glm", dict(solver="L_BFGS", feature_parallelism=2)))]
    H2OAutoML(max_models=2, nfolds=0, seed=1,
              modeling_plan=plan).train(y="y", training_frame=fr)


#: the model surface's exports, refused until the MOJO slice: the call
_EXPORTS = {
    "save_mojo": lambda m, d: m.save_mojo(str(d / "m")),
    "download_mojo": lambda m, d: m.download_mojo(str(d / "m")),
    "save_pojo": lambda m, d: m.save_pojo(str(d / "p")),
    "download_pojo": lambda m, d: m.download_pojo(str(d / "p")),
}

#: what the model surface refuses: (ROADMAP Queue 1 item, the call)
_REFUSALS = {
    "score_raw": (14, lambda fr, d: _one_tree(fr).score_raw(
        torch.zeros((4, 3)))),
    "python_udf": (13, lambda fr, d: GBM(GBMParameters(
        training_frame=fr, custom_metric_func="python:key=mod.Metric",
        **KW))),
    "grid_lbfgs": (1, _grid_lbfgs),
    "automl_lbfgs": (1, _automl_lbfgs),
}


@pytest.mark.parametrize("change", [
    dict(nfolds=3), dict(calibrate_model=True), dict(checkpoint="prior_gbm"),
    dict(distribution="custom", custom_distribution_func=tdist.Gaussian()),
    "multinomial_auc", "goss", "dart_checkpoint", "parquet", "avro_uri",
    "coded_vec", "save_mojo", "download_mojo", "save_pojo", "download_pojo",
    "score_raw", "python_udf", "grid_lbfgs", "automl_lbfgs",
])
def test_out_of_slice_options_raise(change, tmp_path):
    """What the port still refuses raises naming its ROADMAP item: GOSS
    (no port knob: the reference reads H2O_TPU_GOSS, so its case is a
    TreeConfig that asks for it), file formats other than CSV/TSV and URI
    schemes. The options a later slice ported are now taken: cross-
    validation, calibration, a custom distribution (here the port's own
    Gaussian, which grows the built-in's forest), the multinomial AUC
    family (their parity with the reference is in test_torch_cv.py), the
    chunk codecs (``compress`` codes the columns and decodes them bit for
    bit) and checkpoints, GBM's and DART's, where a key the store does not
    hold raises the reference's ``ValueError`` (their parity is in
    test_torch_recovery.py). MOJO and POJO export are taken: the file
    written scores the model (MOJO: its ``predict`` within 1e-5; POJO:
    one method a tree; their parity is in test_torch_mojo.py). The model
    surface's refusals name their items: ``score_raw`` (serving), a custom
    metric
    uploaded as a ``"python:"`` reference; a grid or an AutoML run that
    meets a refusal (GLM's ``feature_parallelism=2``) raises it."""
    if change == "goss":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tengine.TreeConfig(goss=(0.2, 0.1)).check_supported()
        return
    if change in ("parquet", "avro_uri"):
        from h2o_tpu_torch import import_file

        path = str(tmp_path / "f.parquet")
        if change == "avro_uri":
            path = "s3://bucket/f.avro"
        else:
            open(path, "wb").close()
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            import_file(path, device="cpu")
        return
    cols, y = _data(n=2000, seed=5)
    fr = _port_frame(cols, y)
    if isinstance(change, str) and change in _EXPORTS:
        from h2o_tpu_torch import MojoModel

        m = _one_tree(fr)
        path = _EXPORTS[change](m, tmp_path)
        if "mojo" in change:
            got = MojoModel.load(path).predict(fr)[:, 2]
            want = m.predict(fr).vec(2).to_numpy()
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
        else:
            assert open(path).read().count("static double tree_") == 1
        return
    if isinstance(change, str) and change in _REFUSALS:
        item, call = _REFUSALS[change]
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP Queue 1 item {item}\\b"):
            call(fr, tmp_path)
        return
    if change == "coded_vec":
        cfr = fr.compress()
        assert cfr.names == fr.names
        for n in fr.names:
            a, b = fr.vec(n).data.numpy(), cfr.vec(n).data.numpy()
            assert np.array_equal(a.view(np.int32), b.view(np.int32))
        assert cfr.vec("y").meta.kind == "cat8"
        return
    kw = dict(KW, ntrees=1)
    builder, params = GBM, GBMParameters
    if change == "multinomial_auc":
        fr.add("y3", Vec.from_numpy(np.arange(2000) % 3,
                                    domain=["a", "b", "c"], device="cpu"))
        kw.update(response_column="y3", auc_type="MACRO_OVR")
    elif change == "dart_checkpoint":
        builder, params = XGBoost, XGBoostParameters
        kw.update(booster="dart", checkpoint="prior_dart")
    else:
        kw.update(change)
    if change == dict(calibrate_model=True):
        kw.update(calibration_frame=fr)
    if change in (dict(checkpoint="prior_gbm"), "dart_checkpoint"):
        with pytest.raises(ValueError, match="checkpoint model .* not found"):
            builder(params(training_frame=fr, **kw)).train_model()
        return
    m = builder(params(training_frame=fr, **kw)).train_model()
    if change == dict(nfolds=3):
        assert len(m.output.cv_models) == 3
        assert np.isfinite(m.output.cross_validation_metrics.auc)
    elif change == dict(calibrate_model=True):
        a, b = m.calib
        assert np.isfinite(a) and np.isfinite(b)
        assert "cal_p1" in m.predict(fr).names
    elif change == "multinomial_auc":
        mm = m.output.training_metrics
        assert mm.auc_type == "macro_ovr" and 0.0 <= mm.auc <= 1.0
    else:
        gm = GBM(GBMParameters(training_frame=fr, **dict(
            KW, ntrees=1, distribution="gaussian"))).train_model()
        for k in ("feat", "thr", "nanL", "val"):
            assert torch.equal(m.forest[k], gm.forest[k])
