"""Port parity: DeepLearning of ``h2o_tpu_torch`` against the reference
(``h2o_tpu/models/deeplearning.py``), plus its checkpoints, its
kill-and-resume and the carry-over of a reference net.

The reference side runs once per module (a one-device mesh; each of its
builds compiles its own step). Contracts and tolerances:

- UniformAdaptive init, the epoch shuffles and the dropout masks
  bit-equal (the masks compared themselves, through both ``_forward``s);
- after 2 epochs at hidden [8, 8] — every activation, the WithDropout
  variants, ADADELTA and SGD with momentum, l1/l2, each loss, the
  autoencoder: weights, biases and optimizer state within 1e-5,
  predictions within 1e-5, training metrics within 1e-5 relative
  (float32 sums in other orders, carried through the steps);
- the scenarios of ``tests/test_deeplearning.py`` through the port, with
  the reference tests' own assertions, and the ``dl_regression_rmse``
  band of ``tests/accuracy_expectations.json``;
- the checkpoint scenarios of ``tests/test_checkpoint.py``: the same
  assertions, and the port's continuation of the reference's checkpoint
  within 1e-4 of the reference's continuation;
- a job killed at ``train.dl.epoch:raise(preempt)@3`` and resumed:
  weights and optimizer state bit-equal to the uninterrupted run;
- a reference net carried over with ``from_reference`` scores the
  reference's rows within 1e-6.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from h2o_tpu.frame.frame import Frame as JFrame
from h2o_tpu.frame.vec import T_CAT as J_CAT
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.models import deeplearning as jdl
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import (DeepLearning, DeepLearningModel,
                           DeepLearningParameters, Frame, load_model,
                           resume_training)
from h2o_tpu_torch.frame.vec import T_CAT, Vec
from h2o_tpu_torch.models import deeplearning as tdl
from h2o_tpu_torch.utils import failpoints, threefry

from torch_parity import LazyCases

torch.set_num_threads(2)

N = 300


def _cols(n=N, seed=0):
    """Five normal features (x4 with NAs), a 3-level categorical, and
    binomial, 3-class and real responses built from them."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    cols = {f"x{j}": X[:, j].copy() for j in range(5)}
    cols["x4"][::41] = np.nan
    g = rng.integers(0, 3, n).astype(np.float32)
    lin = X[:, 0] + X[:, 1] ** 2 - 0.5 * g
    resp = {"bin": (lin > 1).astype(np.float32),
            "multi": np.digitize(lin, [0.0, 1.5]).astype(np.float32),
            "reg": (np.sin(X[:, 0]) + 0.3 * X[:, 2]).astype(np.float32)}
    return cols, g, resp


def _frames():
    cols, g, resp = _cols()
    one = meshmod.make_mesh(jax.devices()[:1])
    doms = {"g": ["a", "b", "c"], "bin": ["n", "p"],
            "multi": ["lo", "mid", "hi"]}
    with meshmod.use_mesh(one):
        jfr = JFrame.from_dict(cols, mesh=one)
    fr = Frame.from_dict(cols, device="cpu")
    for name, arr in (("g", g), *resp.items()):
        dom = doms.get(name)
        with meshmod.use_mesh(one):
            jfr.add(name, JVec.from_numpy(arr, type=J_CAT if dom else None,
                                          domain=dom, mesh=one))
        fr.add(name, Vec.from_numpy(arr, type=T_CAT if dom else None,
                                    domain=dom, device="cpu"))
    return jfr, fr, one


#: (response, parameters) of each 2-epoch parity case
CASES = {
    "rectifier": ("bin", dict()),
    "tanh_dropout_multinomial_l2": ("multi", dict(
        activation="TanhWithDropout", hidden_dropout_ratios=[0.2, 0.3],
        l2=1e-3)),
    "maxout_sgd_momentum_l1_l2": ("bin", dict(
        activation="Maxout", adaptive_rate=False, rate=0.05,
        momentum_stable=0.9, l1=1e-3, l2=1e-3)),
    "rectifier_dropout_huber": ("reg", dict(
        activation="RectifierWithDropout", input_dropout_ratio=0.1,
        loss="Huber")),
    "maxout_dropout_sgd_absolute": ("reg", dict(
        activation="MaxoutWithDropout", adaptive_rate=False, rate=0.02,
        loss="Absolute")),
    "autoencoder": (None, dict(autoencoder=True, activation="Tanh")),
}
OTHER = ["bin", "multi", "reg"]


def _params(resp, kw, **more):
    base = dict(hidden=[8, 8], epochs=2, seed=42, **kw, **more)
    if resp:
        base["response_column"] = resp
    base["ignored_columns"] = [r for r in OTHER if r != resp]
    return base


@pytest.fixture(scope="module")
def fits():
    """Each case once in both packages, on first use; the reference's
    checkpoint continuation, on first use; and the frames: (cases,
    continuation, frames)."""
    jfr, fr, one = _frames()

    def fit(case):
        resp, kw = CASES[case]
        common = _params(resp, kw)
        with meshmod.use_mesh(one):
            jm = jdl.DeepLearning(jdl.DeepLearningParameters(
                training_frame=jfr, **common)).train_model()
            if kw.get("autoencoder"):
                jpred = np.asarray(jm._raw(jm.adapt_frame(jfr)))[:N]
            else:
                jpred = np.asarray(jm.score0(jm.adapt_frame(jfr)))[:N]
        tm = DeepLearning(DeepLearningParameters(training_frame=fr, **common)
                          ).train_model()
        return jm, jpred, tm

    out = LazyCases(fit)

    def continuation(_key):
        with meshmod.use_mesh(one):
            return jdl.DeepLearning(jdl.DeepLearningParameters(
                training_frame=jfr, checkpoint=out["rectifier"][0],
                **dict(_params("bin", {}), epochs=5))).train_model()

    return out, LazyCases(continuation), (jfr, fr, one)


def _assert_tree_close(a, b, atol):
    for la, lb in zip(a, b):
        for n in ("W", "b"):
            np.testing.assert_allclose(np.asarray(lb[n]), la[n].numpy(),
                                       atol=atol)


def _assert_opt_close(tstate, jstate, atol):
    ref = tdl._opt_from_reference(jstate)
    assert set(ref) == set(tstate)
    for slot in ref:
        for la, lb in zip(tstate[slot], ref[slot]):
            for n in ("W", "b"):
                np.testing.assert_allclose(la[n].numpy(), lb[n], atol=atol)


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("maxout", [False, True])
def test_init_is_bit_equal(maxout):
    sizes = [12, 8, 8, 3]
    ref = jdl._init_params(jax.random.PRNGKey(7), sizes, "UniformAdaptive",
                           1.0, maxout)
    port = tdl._init_params(threefry.prng_key(7), sizes, "UniformAdaptive",
                            1.0, maxout, "cpu")
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(b["W"].numpy(), np.asarray(a["W"]))
        assert not b["b"].any()


@pytest.mark.parametrize("plen,epoch", [(304, 0), (304, 7), (60160, 1)])
def test_epoch_shuffle_is_bit_equal(plen, epoch):
    base = jax.random.fold_in(jax.random.PRNGKey(42), 1)
    ref = jax.random.permutation(jax.random.fold_in(base, epoch), plen)
    tbase = threefry.fold_in(threefry.prng_key(42), 1)
    port = threefry.permutation(threefry.fold_in(tbase, epoch), plen)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_dropout_masks_are_bit_equal():
    """Identity layers over a ones input: the output is mask / (1 - r)
    for the input dropout, then for the hidden layer's, so both
    ``_forward``s hand back their masks."""
    B, F = 32, 6
    eye = np.eye(F, dtype=np.float32)
    jnet = [{"W": jax.numpy.asarray(eye), "b": jax.numpy.zeros(F)}] * 2
    tnet = [{"W": torch.from_numpy(eye), "b": torch.zeros(F)}] * 2
    X = np.ones((B, F), np.float32)
    for gs in (0, 5, 1879):
        jk = jax.random.fold_in(jax.random.PRNGKey(42), 2 + gs)
        tk = threefry.fold_in(threefry.prng_key(42), 2 + gs)
        for in_drop, hid in ((0.25, None), (0.0, [0.5]), (0.1, [0.3])):
            ref = jdl._forward(jnet, jax.numpy.asarray(X), "Rectifier", jk,
                               in_drop, hid, train=True)
            port = tdl._forward(tnet, torch.from_numpy(X), "Rectifier", tk,
                                in_drop, hid, train=True)
            np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# trained nets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_two_epochs_match_the_reference(fits, case):
    jm, jpred, tm = fits[0][case]
    _assert_tree_close(tm.net, jm.net, 1e-5)
    _assert_opt_close(tm.opt_state, jm.opt_state, 1e-5)
    assert tm.epochs_trained == pytest.approx(jm.epochs_trained)
    assert tm.loss_kind == jm.loss_kind
    out = tm.output
    assert out.model_category == jm.output.model_category
    assert out.names == jm.output.names
    assert out.response_domain == jm.output.response_domain
    assert tm.dinfo.expanded_names == jm.dinfo.expanded_names
    _jfr, fr, _one = fits[2]
    X = tm.adapt_frame(fr)
    tpred = (tm._raw(X) if tm.params.autoencoder else tm.score0(X)).numpy()
    np.testing.assert_allclose(tpred[:N], jpred, atol=1e-5)
    jt, tt = jm.output.training_metrics, out.training_metrics
    for f in ("mse", "rmse", "logloss", "auc", "mean_per_class_error"):
        if getattr(jt, f, None) is not None:
            assert getattr(tt, f) == pytest.approx(getattr(jt, f), rel=1e-5,
                                                   abs=1e-6, nan_ok=True)
    carried = DeepLearningModel.from_reference(jm, device="cpu")
    cp = (carried._raw(X) if carried.params.autoencoder
          else carried.score0(X)).numpy()
    np.testing.assert_allclose(cp[:N], jpred, atol=1e-6)


def test_autoencoder_outputs(fits):
    jm, _jpred, tm = fits[0]["autoencoder"]
    jfr, fr, one = fits[2]
    pred = tm.predict(fr)
    assert pred.names == [f"reconstr_{n}" for n in jm.dinfo.expanded_names]
    with meshmod.use_mesh(one):
        janom = np.asarray(jm.anomaly(jfr).vec(0).to_numpy())
        jdf = jm.deepfeatures(jfr, 1)
    anom = tm.anomaly(fr)
    assert anom.names == ["Reconstruction.MSE"]
    np.testing.assert_allclose(anom.vec(0).to_numpy(), janom, atol=1e-5)
    df = tm.deepfeatures(fr, 1)
    assert df.names == jdf.names and df.ncol == 8
    np.testing.assert_allclose(
        np.stack([v.to_numpy() for v in df.vecs], 1),
        np.stack([np.asarray(v.to_numpy()) for v in jdf.vecs], 1),
        atol=1e-5)
    with pytest.raises(ValueError, match="layer"):
        tm.deepfeatures(fr, 2)


def test_weights_and_biases_frames():
    cols, g, resp = _cols()
    fr = Frame.from_dict(dict(cols, bin=resp["bin"]), device="cpu")
    m = DeepLearning(DeepLearningParameters(
        training_frame=fr, response_column="bin", hidden=[8, 8], epochs=1,
        seed=42, distribution="bernoulli", export_weights_and_biases=True)
    ).train_model()
    from h2o_tpu_torch import STORE

    w0 = STORE.get(m.output.weights_keys[0])
    b2 = STORE.get(m.output.biases_keys[2])
    assert (w0.nrow, w0.ncol) == (8, m.net[0]["W"].shape[0])
    np.testing.assert_array_equal(
        np.stack([v.to_numpy() for v in w0.vecs], 1), m.net[0]["W"].T.numpy())
    np.testing.assert_array_equal(b2.vec(0).to_numpy(), m.net[2]["b"].numpy())


# ---------------------------------------------------------------------------
# the reference's DL scenarios (tests/test_deeplearning.py) and its band
# ---------------------------------------------------------------------------
def _xor_frame():
    rng = np.random.default_rng(0)
    n = 800
    a = rng.random(n) > 0.5
    b = rng.random(n) > 0.5
    fr = Frame.from_dict({
        "a": a.astype(np.float32) + 0.05 * rng.normal(size=n).astype(
            np.float32),
        "b": b.astype(np.float32) + 0.05 * rng.normal(size=n).astype(
            np.float32)}, device="cpu")
    fr.add("y", Vec.from_numpy((a ^ b).astype(np.float32), type=T_CAT,
                               domain=["no", "yes"], device="cpu"))
    return fr


def test_scenario_binomial_xor_and_sgd_dropout():
    fr = _xor_frame()
    m = DeepLearning(DeepLearningParameters(
        training_frame=fr, response_column="y", hidden=[16, 16], epochs=60,
        seed=42, mini_batch_size=64)).train_model()
    assert m.output.training_metrics.auc > 0.95
    m = DeepLearning(DeepLearningParameters(
        training_frame=fr, response_column="y", hidden=[16], epochs=30,
        seed=7, adaptive_rate=False, rate=0.05,
        activation="RectifierWithDropout", hidden_dropout_ratios=[0.2],
        input_dropout_ratio=0.05, mini_batch_size=64)).train_model()
    assert m.output.training_metrics.auc > 0.8


def test_scenario_multinomial_and_autoencoder():
    rng = np.random.default_rng(2)
    n = 600
    x1 = rng.normal(size=n).astype(np.float32)
    x2 = rng.normal(size=n).astype(np.float32)
    cls = (x1 > 0).astype(int) + (x2 > 0).astype(int)
    fr = Frame.from_dict({"x1": x1, "x2": x2}, device="cpu")
    fr.add("y", Vec.from_numpy(cls.astype(np.float32), type=T_CAT,
                               domain=["lo", "mid", "hi"], device="cpu"))
    m = DeepLearning(DeepLearningParameters(
        training_frame=fr, response_column="y", hidden=[16], epochs=40,
        seed=4, mini_batch_size=64)).train_model()
    assert m.output.training_metrics.logloss < 0.5
    pred = m.predict(fr)
    assert pred.names[0] == "predict" and pred.ncol == 4
    rng = np.random.default_rng(5)
    z = rng.normal(size=(400, 2))
    X = (z @ rng.normal(size=(2, 6))).astype(np.float32)
    fr = Frame.from_dict({f"c{i}": X[:, i] for i in range(6)}, device="cpu")
    m = DeepLearning(DeepLearningParameters(
        training_frame=fr, autoencoder=True, hidden=[4], epochs=60, seed=6,
        mini_batch_size=64, activation="Tanh")).train_model()
    assert m.anomaly(fr).names == ["Reconstruction.MSE"]
    assert m.output.training_metrics.mse < 0.5


def test_scenario_regression_and_deepfeatures():
    rng = np.random.default_rng(1)
    n = 600
    x = rng.normal(size=n).astype(np.float32)
    y = (np.sin(2 * x) + 0.05 * rng.normal(size=n)).astype(np.float32)
    fr = Frame.from_dict({"x": x, "y": y}, device="cpu")
    m = DeepLearning(DeepLearningParameters(
        training_frame=fr, response_column="y", hidden=[32, 32], epochs=80,
        seed=3, mini_batch_size=64, activation="Tanh")).train_model()
    assert m.output.training_metrics.rmse < 0.25
    assert m.predict(fr).nrow == n
    X = rng.normal(size=(300, 4)).astype(np.float32)
    cols = {f"x{j}": X[:, j] for j in range(4)}
    cols["y"] = (X[:, 0] + X[:, 1] ** 2).astype(np.float32)
    fr = Frame.from_dict(cols, device="cpu")
    m = DeepLearning(DeepLearningParameters(
        training_frame=fr, response_column="y", hidden=[16, 8], epochs=3,
        seed=1)).train_model()
    df0, df1 = m.deepfeatures(fr, 0), m.deepfeatures(fr, 1)
    assert df0.ncol == 16 and df1.ncol == 8 and df0.nrow == 300
    assert df0.names[0] == "DF.L1.C1"


#: the reference's training RMSE on this case on a one-device mesh (jax
#: 0.9.0 on an x86 CPU). The stored band (0.361947 +- 8%) does not always
#: hold for the reference itself: run alone on such a CPU,
#: ``tests/test_accuracy.py`` gives 0.26898 on the 8-device mesh (ROADMAP
#: Queue 3). The port is held to the reference's own value with the band's
#: 8%, and to the band's upper edge
REF_DL_REGRESSION_RMSE = 0.27121729715157933


def test_dl_regression_rmse_band():
    """The reference's accuracy case (``tests/accuracy_util.py``,
    ``regression_dataset``) through the port."""
    rng = np.random.default_rng(12)
    n = 4000
    x1 = rng.normal(size=n).astype(np.float32)
    x2 = rng.normal(size=n).astype(np.float32)
    y = (2 * x1 + np.sin(3 * x2) + 0.2 * rng.normal(size=n)).astype(
        np.float32)
    fr = Frame.from_dict({"x1": x1, "x2": x2, "y": y}, device="cpu")
    m = DeepLearning(DeepLearningParameters(
        training_frame=fr, response_column="y", hidden=[32, 32], epochs=30,
        seed=7)).train_model()
    with open(os.path.join(os.path.dirname(__file__),
                           "accuracy_expectations.json")) as f:
        exp = json.load(f)["dl_regression_rmse"]["value"]
    rmse = m.output.training_metrics.rmse
    assert abs(rmse - REF_DL_REGRESSION_RMSE) <= 0.08 * REF_DL_REGRESSION_RMSE
    assert rmse <= 1.08 * exp


# ---------------------------------------------------------------------------
# checkpoints (tests/test_checkpoint.py:143-200) and recovery
# ---------------------------------------------------------------------------
def _ckpt_frame(n, seed):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n).astype(np.float32)
    x2 = rng.normal(size=n).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(2 * x1 - x2)))).astype(np.float32)
    fr = Frame.from_dict({"x1": x1, "x2": x2}, device="cpu")
    fr.add("y", Vec.from_numpy(y, type=T_CAT, domain=["no", "yes"],
                               device="cpu"))
    return fr


def test_checkpoint_continues_training():
    base = DeepLearningParameters(training_frame=_ckpt_frame(600, 3),
                                  response_column="y", hidden=[16, 16],
                                  epochs=4, seed=7)
    m1 = DeepLearning(base).train_model()
    assert m1.epochs_trained == pytest.approx(4.0)
    m2 = DeepLearning(dataclasses.replace(base, checkpoint=m1, epochs=12)
                      ).train_model()
    assert m2.epochs_trained == pytest.approx(12.0)
    ll1 = m1.output.training_metrics.logloss
    ll2 = m2.output.training_metrics.logloss
    assert ll2 < ll1, (ll1, ll2)
    fresh = DeepLearning(dataclasses.replace(base, epochs=8)).train_model()
    assert ll2 < fresh.output.training_metrics.logloss * 1.05


def test_checkpoint_by_key_rejects_changes_and_saves(tmp_path):
    base = DeepLearningParameters(training_frame=_ckpt_frame(400, 4),
                                  response_column="y", hidden=[8], epochs=2,
                                  seed=9)
    m1 = DeepLearning(base).train_model()
    assert m1.opt_state is not None and "e_g" in m1.opt_state
    m2 = DeepLearning(dataclasses.replace(base, checkpoint=m1.key, epochs=4)
                      ).train_model()
    assert m2.epochs_trained == pytest.approx(4.0)
    assert m2.params.checkpoint == m1.key
    for change, what in ((dict(hidden=[16]), "hidden"),
                         (dict(activation="Tanh"), "activation"),
                         (dict(epochs=2), "epochs")):
        with pytest.raises(ValueError, match=what):
            DeepLearning(dataclasses.replace(
                base, checkpoint=m1, **dict(dict(epochs=4), **change))
            ).train_model()
    m3 = load_model(m2.save(str(tmp_path / "dl.bin")), device="cpu")
    assert m3.epochs_trained == pytest.approx(4.0)
    fr = base.training_frame
    np.testing.assert_allclose(m3.predict(fr).vec(2).to_numpy(),
                               m2.predict(fr).vec(2).to_numpy(), atol=1e-6)


def test_continuation_of_the_reference_checkpoint(fits):
    """The port continues the reference's 2-epoch net (carried with its
    ADADELTA state) to 5 epochs as the reference's continuation does."""
    jm = fits[0]["rectifier"][0]
    jcont = fits[1]["rectifier"]
    _jfr, fr, _one = fits[2]
    prior = DeepLearningModel.from_reference(jm, device="cpu")
    cont = DeepLearning(DeepLearningParameters(
        training_frame=fr, checkpoint=prior,
        **dict(_params("bin", {}), epochs=5))).train_model()
    assert cont.epochs_trained == pytest.approx(jcont.epochs_trained)
    _assert_tree_close(cont.net, jcont.net, 1e-4)
    _assert_opt_close(cont.opt_state, jcont.opt_state, 1e-4)


def test_kill_and_resume_is_bit_equal(tmp_path, monkeypatch):
    monkeypatch.setenv("H2O_TORCH_CHECKPOINT_SECS", "0")
    fr = _ckpt_frame(500, 0)

    def params(**kw):
        return DeepLearningParameters(training_frame=fr, response_column="y",
                                      hidden=[8], epochs=4, seed=5,
                                      mini_batch_size=32, **kw)

    base = DeepLearning(params()).train_model()
    rdir = str(tmp_path / "dl")
    failpoints.arm("train.dl.epoch", "raise(preempt)@3")
    try:
        with pytest.raises(failpoints.InjectedPreemption):
            DeepLearning(params(auto_recovery_dir=rdir)).train_model()
    finally:
        failpoints.reset()
    m = resume_training(rdir, device="cpu")
    for la, lb in zip(base.net, m.net):
        for n in ("W", "b"):
            assert torch.equal(la[n], lb[n])
    for slot in ("e_g", "e_x"):
        for la, lb in zip(base.opt_state[slot], m.opt_state[slot]):
            for n in ("W", "b"):
                assert torch.equal(la[n], lb[n])
    assert m.epochs_trained == base.epochs_trained
