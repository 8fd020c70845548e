"""Port parity: PSVM, GLRM, Aggregator and Word2Vec
(``h2o_tpu_torch/models/{psvm,glrm,aggregator,word2vec}.py``), their MOJO
writers, and ``offset_column`` in every builder, against the reference
(``h2o_tpu/models/...``) on a one-device mesh.

Two test items (the suite's xdist chunks move with the test count): each
loops over its checks, and each reference model is trained once.
Tolerances, and why:

- pure functions fed the same inputs: integers, masks, projections of
  equal inputs and the numpy parts exactly; float32 elementwise losses
  and gradients within 2e-6 of the value's scale (XLA's and torch's
  ``exp``/``log``/``cos`` differ by an ulp or two); products and sums
  (the squared-hinge gradient and Hessian through the plain Gram, the
  NA-aware distances) within 1e-5 relative;
- PSVM, four Newton steps in each package but on the ring, which runs to
  its stop (the stopping rule compares two float32 objective sums at 1e-8
  relative, so a fit run to its stop may take one iteration more in
  either): the linear fit's weights within
  1e-4·max(1, |β|) and its decision values within 1e-4; the Gaussian fits draw the same landmark indices,
  and the landmark rows agree within 1e-6 (the design's means and sigmas
  are float32 sums in other orders). On the reference's 2-D ring
  (`test_gam_rulefit_svm.py:80`) K(L, L) has eigenvalues down to 1e-15,
  floored at 1e-10 by the whitening, so an ulp in a landmark moves the
  whitening by O(10) and the weights with it: the decision values agree
  within 1e-2 (measured 4.1e-3; 3.4e-3 for the carried model, whose float32
  products K(X, L)·W meet the same 1e5-scaled whitening) and the training
  AUC within 1e-6. On a
  10-feature frame (a well-conditioned K(L, L)) the weights agree within
  1e-4·max(1, |β|) and the decision values within 1e-4;
- GLRM: the objective history within 1e-5·max(|f|, 1), Y within 1e-4 and
  X within 1e-3 (rows with missing cells are weakly determined: measured
  6.5e-4) over the iterations ``GLRM_RUNS`` lists. Where the loss or the
  prox is not smooth (Absolute's sign, L1, Hinge, the Ordinal blocks) an
  ulp flips a cell's subgradient or a backtracking decision, and the two
  trajectories part later (Absolute with OneSparse: Y 4e-3 apart after 50
  iterations, 7e-6 after 15), so those runs are held over fewer
  iterations; the loss and prox functions are held on their own for every
  kind;
- Aggregator: exemplar rows, counts and assignments exactly;
- Word2Vec: vocabulary, training pairs, every step's centers, contexts,
  negatives and learning rate exactly; the vectors within 1e-7 after one
  step from the same state, 2e-7 after one epoch and 5e-5 after ten
  (measured 4.5e-8 and 9.1e-6: the einsum and ``rsqrt`` round differently
  in XLA and torch, and SGNS repeats each word's updates).

The second item holds the three MOJO writers entry for entry against the
reference's for carried models (uuid lines aside; tolerance 0), the port's
reader scoring them as the port model does (PSVM, linear and on the
well-conditioned 10-feature frame, within the reference's round trip,
atol 1e-4 rtol 1e-3 — the ring's 1e5-scaled whitening puts its float64
scorer 7.8e-4 from the float32 ``predict``; GLRM atol 1e-3 rtol 1e-3, the reference's
`test_mojo_extended.py:59`; word2vec's vectors exactly), and
``offset_column`` across every builder kind: each builder that does not
read it trains bit-equal to its twin with the column ignored
(``ignored_columns``; AdaBoost's weak learners, quantiles, the target
encoder and an ensemble's metalearner see the column as the reference's
do, so their twin keeps it as a plain column), the ones that read it (GLM, GAM, ANOVA GLM) move, and the
reference trains with the column where it trains, the ANOVA table within
1e-4 relative of the port's.
"""

import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o_tpu.frame.frame import Frame as JFrame
from h2o_tpu.frame.vec import T_CAT as J_CAT
from h2o_tpu.frame.vec import T_STR as J_STR
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import Frame
from h2o_tpu_torch.frame.vec import T_CAT, T_STR, Vec
from h2o_tpu_torch.mojo.reader import MojoModel as TMojo

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


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rtol, atol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# PSVM
# ---------------------------------------------------------------------------
def _psvm_frames(kind):
    if kind == "wide":
        rng = np.random.default_rng(11)
        n = 800
        x = rng.normal(size=(n, 10)).astype(np.float32)
        y = ((x[:, :3] ** 2).sum(1) < 3.0).astype(np.float32)
        cols = {f"x{j}": x[:, j] for j in range(10)}
    else:
        rng = np.random.default_rng(3)
        n = 1500
        x = rng.normal(size=(n, 2)).astype(np.float32)
        y = ((x[:, 0] + x[:, 1] > 0) if kind == "linear"
             else (np.sqrt((x ** 2).sum(1)) < 1.1)).astype(np.float32)
        cols = {"x1": x[:, 0], "x2": x[:, 1]}
    cols["y"] = y
    return n, _frames(cols, {"y": ["0", "1"]})


def _check_psvm():
    from h2o_tpu.models import psvm as jps
    from h2o_tpu_torch.models import psvm as tps

    rng = np.random.default_rng(0)
    Phib = rng.normal(size=(500, 11)).astype(np.float32)
    y = np.where(rng.random(500) < 0.5, -1.0, 1.0).astype(np.float32)
    w = (rng.random(500) < 0.9).astype(np.float32)
    beta = (0.1 * rng.normal(size=11)).astype(np.float32)
    jo = jps._sq_hinge_grad_hess(*map(jnp.asarray, (Phib, y, w, beta)))
    to = tps._sq_hinge_grad_hess(*map(_t, (Phib, y, w, beta)))
    for a, b, nm in zip(to, jo, ("grad", "hess", "loss")):
        _close(a, b, 1e-5, 1e-4, f"psvm {nm}")

    fits = {}
    for kind in ("linear", "ring", "wide"):
        n, (jfr, tfr) = _psvm_frames(kind)
        kt = "linear" if kind == "linear" else "gaussian"
        kw = dict(response_column="y", kernel_type=kt, hyper_param=1.0,
                  seed=4, max_iterations=30 if kind == "ring" else 4)
        with meshmod.use_mesh(ONE):
            jm = jps.PSVM(jps.SVMParameters(training_frame=jfr,
                                            **kw)).train_model()
        tm = tps.PSVM(tps.SVMParameters(training_frame=tfr,
                                        **kw)).train_model()
        Xt = tm.adapt_frame(tfr)
        jd = np.asarray(jm.decision_function(jm.adapt_frame(jfr)))[:n]
        td = tm.decision_function(Xt).numpy()[:n]
        # the Gram kernel weights rows and masks none: every row of the
        # design it is given (padding and zero-weight rows) is finite
        assert torch.isfinite(tm._features(Xt)).all()
        assert 0 < tm.sv_count <= n and tm.iterations >= 1
        ja = jm.output.training_metrics.auc
        assert abs(tm.output.training_metrics.auc - ja) <= 1e-6, kind
        if kt == "gaussian":
            assert tm.landmarks.shape == np.asarray(jm.landmarks).shape
            _close(tm.landmarks, jm.landmarks, 0, 1e-6, "landmarks")
        if kind == "ring":
            _close(td, jd, 0, 1e-2, "ring decision")
        else:
            jb = np.asarray(jm.beta)
            np.testing.assert_array_less(
                np.abs(tm.beta.numpy() - jb), 1e-4 * np.maximum(1, np.abs(jb)))
            _close(td, jd, 0, 1e-4, f"{kind} decision")
            assert abs(tm.bias - jm.bias) <= 1e-4 * max(1, abs(jm.bias))
            assert abs(tm.sv_count - jm.sv_count) <= 1
        # the carrier: the reference's model scores alike in the port
        cm = tps.SVMModel.from_reference(jm, "cpu")
        _close(cm.decision_function(cm.adapt_frame(tfr)).numpy()[:n], jd,
               0, 1e-2 if kind == "ring" else 1e-4, f"{kind} carried")
        acc = (tm.predict(tfr).vec("predict").to_numpy()
               == tfr.vec("y").to_numpy()).mean()
        assert acc > 0.9, (kind, acc)
        fits[kind] = (jm, tm, jfr, tfr)
    return fits


# ---------------------------------------------------------------------------
# GLRM
# ---------------------------------------------------------------------------
def _glrm_cols(kind):
    rng = np.random.default_rng(0)
    if kind == "noisy":
        A = (rng.normal(size=(200, 3)) @ rng.normal(size=(3, 8))
             + 0.3 * rng.normal(size=(200, 8))).astype(np.float32)
        A[rng.random(A.shape) < 0.1] = np.nan
        return {f"c{i}": A[:, i] for i in range(8)}, {}
    if kind == "lowrank":
        A = (rng.normal(size=(200, 3)) @ rng.normal(size=(3, 8))).astype(
            np.float32)
        return {f"c{i}": A[:, i] for i in range(8)}, {}
    if kind == "binary":
        B = ((rng.normal(size=(120, 2)) @ rng.normal(size=(2, 6))) > 0)
        return {f"c{i}": B[:, i].astype(np.float32) for i in range(6)}, {}
    if kind == "counts":
        lam = np.exp(rng.normal(scale=0.5, size=(150, 2))
                     @ rng.normal(scale=0.5, size=(2, 5)))
        A = rng.poisson(lam).astype(np.float32)
        return {f"c{i}": A[:, i] for i in range(5)}, {}
    if kind == "blobs":
        centers = np.array([[0, 0, 0], [8, 8, 0], [0, 8, 8]], np.float32)
        A = np.concatenate([c + rng.normal(scale=0.5, size=(60, 3))
                            for c in centers]).astype(np.float32)
        return {f"c{i}": A[:, i] for i in range(3)}, {}
    # mixed: two numerics, an ordinal-able categorical, a nominal one
    n = 200
    score = rng.normal(size=n)
    lv = np.digitize(score, [-0.8, 0.0, 0.8]).astype(np.float32)
    nom = rng.integers(0, 3, n).astype(np.float32)
    nom[rng.random(n) < 0.05] = np.nan
    x = (score + rng.normal(scale=0.3, size=n)).astype(np.float32)
    z = rng.normal(size=n).astype(np.float32)
    return ({"x": x, "z": z, "o": lv, "m": nom},
            {"o": ["lo", "mid", "hi", "top"], "m": ["a", "b", "c"]})


#: (data, parameters, iterations the trajectories are held over)
GLRM_RUNS = [
    ("noisy", dict(init="SVD", k=3), 100),
    ("noisy", dict(init="PlusPlus", k=3, transform="STANDARDIZE"), 100),
    ("noisy", dict(init="Random", k=3, regularization_x="Quadratic",
                   gamma_x=0.5, regularization_y="L1", gamma_y=0.1), 25),
    ("lowrank", dict(init="SVD", k=3), 60),
    ("blobs", dict(init="PlusPlus", k=3, regularization_x="UnitOneSparse"),
     100),
    ("noisy", dict(init="Random", k=3, loss="Huber",
                   regularization_x="Simplex"), 100),
    ("noisy", dict(init="Random", k=3, regularization_x="NonNegative",
                   regularization_y="NonNegative"), 30),
    ("noisy", dict(init="Random", k=3, loss="Absolute",
                   regularization_x="OneSparse"), 15),
    ("binary", dict(init="Random", k=2, loss="Logistic"), 100),
    ("binary", dict(init="Random", k=2, loss="Hinge"), 60),
    ("counts", dict(init="Random", k=2, loss="Poisson"), 100),
    ("noisy", dict(init="Random", k=2, loss="Periodic", period=3.0), 100),
    ("mixed", dict(init="Random", k=2, multi_loss="Ordinal",
                   loss_by_col={"m": "Categorical", "z": "Absolute"},
                   transform="NORMALIZE"), 12),
    ("mixed", dict(init="PlusPlus", k=2, multi_loss="Categorical"), 20),
]


def _check_glrm_functions():
    from h2o_tpu.models import glrm as jg
    from h2o_tpu_torch.models import glrm as tg

    rng = np.random.default_rng(1)
    U = (3 * rng.normal(size=(64, 6))).astype(np.float32)
    T = rng.normal(size=(64, 6)).astype(np.float32)
    T01 = (T > 0).astype(np.float32)
    Tc = np.round(np.abs(3 * T)).astype(np.float32)
    jl, tl = jg._cell_losses(1.7), tg._cell_losses(1.7)
    assert set(jl) == set(tl) == set(tg._NUMERIC_LOSSES)
    for kind in tl:
        tt = {"logistic": T01, "hinge": T01, "poisson": Tc}.get(kind, T)
        for i in range(2):
            a = tl[kind][i](_t(U), _t(tt)).numpy()
            b = np.asarray(jl[kind][i](jnp.asarray(U), jnp.asarray(tt)))
            scale = 1 + np.abs(b)
            assert np.all(np.abs(a - b) <= 2e-6 * scale), (kind, i)
    V = rng.normal(size=(7, 5)).astype(np.float32)
    for axis in (0, 1):
        _close(tg._simplex_project(_t(V), axis),
               jg._simplex_project(jnp.asarray(V), axis), 1e-6, 1e-7,
               "simplex")
        for unit in (False, True):
            assert np.array_equal(
                tg._argmax_keep(_t(V), axis, unit).numpy(),
                np.asarray(jg._argmax_keep(jnp.asarray(V), axis, unit)))
        for kind in ("None", "Quadratic", "L1", "NonNegative", "OneSparse",
                     "UnitOneSparse", "Simplex"):
            a = tg._prox(kind, 0.3, axis)(_t(V), 0.5)
            b = jg._prox(kind, 0.3, axis)(jnp.asarray(V), 0.5)
            _close(a, b, 1e-6, 1e-7, f"prox {kind}")
            _close(torch.as_tensor(tg._reg_value(kind, 0.3, _t(V))),
                   jg._reg_value(kind, 0.3, jnp.asarray(V)), 1e-6, 0, kind)
    for bad in (lambda m: m._prox("Bogus", 0.1, 0),):
        for mod in (jg, tg):
            with pytest.raises(ValueError):
                bad(mod)

    # the missing mask and the loss plan on a mixed frame with NAs
    cols, cats = _glrm_cols("mixed")
    jfr, tfr = _frames(cols, cats)
    p = dict(k=2, multi_loss="Ordinal", loss="Huber",
             loss_by_col={"m": "Categorical", "Z": "Poisson"})
    jp, tp = jg.GLRMParameters(**p), tg.GLRMParameters(**p)
    from h2o_tpu.models.datainfo import DataInfo as JDI
    from h2o_tpu_torch.models.datainfo import DataInfo as TDI
    names = ["x", "z", "o", "m"]
    with meshmod.use_mesh(ONE):
        jdi = JDI.make(jfr, names, standardize=True,
                       use_all_factor_levels=True)
        jA, _ = jdi.expand(jfr)
        jM = jg._missing_mask(jdi, jfr, jA.shape[0])
        jT, jLM, jids, jkinds = jg._loss_plan(jp, jdi, jA, jM)
    tdi = TDI.make(tfr, names, standardize=True, use_all_factor_levels=True)
    tA, _ = tdi.expand(tfr)
    tM = tg._missing_mask(tdi, tfr, tA.shape[0])
    assert tA.shape == jA.shape
    assert np.array_equal(tM.numpy(), np.asarray(jM))
    tT, tLM, tids, tkinds = tg._loss_plan(tp, tdi, tA, tM)
    assert tkinds == jkinds and np.array_equal(tids, jids)
    assert np.array_equal(tLM.numpy(), np.asarray(jLM))
    _close(tT, jT, 1e-6, 1e-6, "loss plan targets")
    # a bad loss, multi-loss, per-column loss or column is rejected alike
    for bad in (dict(loss="Bogus"), dict(multi_loss="Bogus"),
                dict(loss_by_col={"x": "Bogus"}),
                dict(loss_by_col={"nope": "Absolute"})):
        for mod, di, A, M in ((jg, jdi, jA, jM), (tg, tdi, tA, tM)):
            with pytest.raises(ValueError):
                mod._loss_plan(mod.GLRMParameters(k=2, **bad), di, A, M)
    jfr1, tfr1 = _frames({"a": np.arange(4, dtype=np.float32)})
    with pytest.raises(ValueError):
        tg.GLRM(tg.GLRMParameters(training_frame=tfr1, k=1,
                                  loss="Bogus")).train_model()


def _check_glrm():
    from h2o_tpu.models import glrm as jg
    from h2o_tpu_torch.models import glrm as tg

    _check_glrm_functions()
    fits = {}
    for i, (data, kw, iters) in enumerate(GLRM_RUNS):
        cols, cats = _glrm_cols(data)
        jfr, tfr = _frames(cols, cats)
        kw = dict(kw, max_iterations=iters, seed=i + 1)
        with meshmod.use_mesh(ONE):
            jm = jg.GLRM(jg.GLRMParameters(training_frame=jfr,
                                           **kw)).train_model()
        tm = tg.GLRM(tg.GLRMParameters(training_frame=tfr,
                                       **kw)).train_model()
        what = f"{data} {kw}"
        jh = np.array([h["objective"] for h in jm.output.scoring_history])
        th = np.array([h["objective"] for h in tm.output.scoring_history])
        assert len(th) == len(jh) == iters
        assert np.all(np.abs(th - jh) <= 1e-5 * np.maximum(np.abs(jh), 1)), \
            what
        assert np.all(np.diff(th) <= 0), what   # the history never rises
        _close(tm.Y, jm.Y, 0, 1e-4, what)
        _close(tm.X, jm.X, 0, 1e-3, what)
        assert tm.dinfo.expanded_names == jm.dinfo.expanded_names
        fits[i] = (jm, tm, jfr, tfr)
    # the recipes' structure (`test_glrm_w2v_ada.py:190-332`)
    X = fits[4][1].X.numpy()[:180]
    assert np.all(np.isin(X, [0.0, 1.0])) and np.all(X.sum(axis=1) == 1.0)
    X = fits[5][1].X.numpy()[:200]
    assert np.all(X >= 0) and np.allclose(X.sum(axis=1), 1.0, atol=1e-4)
    assert np.all(fits[6][1].archetypes() >= 0)
    # the carrier projects and transforms as the reference does
    for i in (0, 12):
        jm, tm, jfr, tfr = fits[i]
        cm = tg.GLRMModel.from_reference(jm, "cpu")
        with meshmod.use_mesh(ONE):
            jp = jm.predict(jfr)
            jt = jm.transform_frame(jfr)
        tp, tt = cm.predict(tfr), cm.transform_frame(tfr)
        assert tp.names == jp.names and tt.names == jt.names
        for a, b in ((tp, jp), (tt, jt)):
            for j in range(a.ncol):
                _close(a.vec(j).to_numpy(), b.vec(j).to_numpy(), 1e-4, 1e-4,
                       "glrm carried")
    return fits


# ---------------------------------------------------------------------------
# Aggregator
# ---------------------------------------------------------------------------
def _check_aggregator():
    from h2o_tpu.models import aggregator as ja
    from h2o_tpu_torch.models import aggregator as ta

    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 4)).astype(np.float32)
    E = rng.normal(size=(40, 4)).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = np.nan
    E[rng.random(E.shape) < 0.1] = np.nan
    _close(ta._sqdist(_t(X), _t(E)),
           ja._sqdist(jnp.asarray(X), jnp.asarray(E)), 1e-5, 1e-5, "sqdist")
    for mode in ("NONE", "DEMEAN", "DESCALE", "STANDARDIZE", "NORMALIZE"):
        assert np.array_equal(ta._transform(X, mode), ja._transform(X, mode),
                              equal_nan=True)

    n = 1500
    X = rng.normal(size=(n, 3)).astype(np.float32)
    X[rng.random(X.shape) < 0.03] = np.nan
    cols = {f"x{j}": X[:, j] for j in range(3)}
    cols["c"] = rng.integers(0, 3, n).astype(np.float32)
    jfr, tfr = _frames(cols, {"c": ["p", "q", "r"]})
    for kw in (dict(target_num_exemplars=60),
               dict(target_num_exemplars=200, transform="STANDARDIZE"),
               dict(target_num_exemplars=n)):
        with meshmod.use_mesh(ONE):
            jm = ja.Aggregator(ja.AggregatorParameters(training_frame=jfr,
                                                       **kw)).train_model()
        tm = ta.Aggregator(ta.AggregatorParameters(training_frame=tfr,
                                                   **kw)).train_model()
        jg_, tg_ = jm.aggregated_frame, tm.aggregated_frame
        assert tg_.names == jg_.names and tg_.nrow == jg_.nrow, kw
        for name in jg_.names:
            assert np.array_equal(tg_.vec(name).to_numpy(),
                                  jg_.vec(name).to_numpy(), equal_nan=True)
        assert np.array_equal(tm.exemplar_assignment, jm.exemplar_assignment)
        counts = tg_.vec("counts").to_numpy()
        assert counts.sum() == n
        assert np.array_equal(counts, np.bincount(tm.exemplar_assignment))
    assert tg_.nrow == n   # the last case: the target is every row


# ---------------------------------------------------------------------------
# Word2Vec
# ---------------------------------------------------------------------------
def _reference_pairs(ids, window):
    """The reference's pair loop (``h2o_tpu/models/word2vec.py:173-188``),
    the oracle of the port's numpy construction."""
    pairs, sent = [], []
    for t in ids:
        if t == -2:
            sent = []
            continue
        if t >= 0:
            for u in sent[-window:]:
                pairs.append((t, u))
                pairs.append((u, t))
            sent.append(t)
    return np.array(pairs, dtype=np.int32).reshape(-1, 2)


def _w2v_corpus():
    rng = np.random.default_rng(5)
    topics = {"fruit": ["apple", "banana", "cherry", "grape"],
              "tech": ["cpu", "gpu", "ram", "disk"]}
    words = []
    for _ in range(400):
        topic = "fruit" if rng.random() < 0.5 else "tech"
        words.extend(rng.choice(topics[topic], size=6).tolist())
        if rng.random() < 0.2:
            words.append("rare" if rng.random() < 0.5
                         else f"oov{rng.integers(100)}")
        words.append(None)
    return words


def _check_word2vec():
    from h2o_tpu.models import word2vec as jw
    from h2o_tpu_torch.models import word2vec as tw

    rng = np.random.default_rng(2)
    for window in (1, 3, 5):
        ids = rng.integers(-2, 9, size=700)
        ids[rng.random(700) < 0.3] = 0
        assert np.array_equal(tw._training_pairs(ids, window),
                              _reference_pairs(list(ids), window))
    V, D = 12, 6
    W = (rng.normal(size=(V, D)) * 0.1).astype(np.float32)
    C = (rng.normal(size=(V, D)) * 0.1).astype(np.float32)
    cen, ctx = rng.integers(0, V, 64), rng.integers(0, V, 64)
    negs = rng.integers(0, V, (64, 5))
    jW, jC = jw._sgns_step(jnp.asarray(W), jnp.asarray(C),
                           jnp.asarray(cen, jnp.int32),
                           jnp.asarray(ctx, jnp.int32),
                           jnp.asarray(negs, jnp.int32), jnp.float32(0.05))
    tW, tC = _t(W), _t(C)
    tw._sgns_step(tW, tC, torch.from_numpy(cen), torch.from_numpy(ctx),
                  torch.from_numpy(negs), float(np.float32(0.05)))
    _close(tW, jW, 0, 1e-7, "sgns W")
    _close(tC, jC, 0, 1e-7, "sgns C")

    words = _w2v_corpus()
    host = np.array(words, dtype=object)
    jfr = JFrame(["w"], [JVec(None, len(words), type=J_STR, host_data=host)])
    tfr = Frame(["w"], [Vec(None, len(words), type=T_STR, host_data=host)])
    steps = {}

    def recorder(mod, key):
        orig = mod._sgns_step

        def rec(W, C, centers, contexts, negs, lr):
            steps.setdefault(key, []).append(
                (np.asarray(centers).astype(np.int64),
                 np.asarray(contexts).astype(np.int64),
                 np.asarray(negs).astype(np.int64), float(lr)))
            return orig(W, C, centers, contexts, negs, lr)
        return orig, rec

    fits = {}
    for epochs, tol in ((1, 2e-7), (10, 5e-5)):
        kw = dict(vec_size=16, epochs=epochs, min_word_freq=5,
                  window_size=3, seed=6)
        origs = []
        for mod, key in ((jw, "ref"), (tw, "port")):
            orig, rec = recorder(mod, key)
            origs.append((mod, orig))
            mod._sgns_step = rec
        try:
            steps.clear()
            jm = jw.Word2Vec(jw.Word2VecParameters(training_frame=jfr,
                                                   **kw)).train_model()
            tm = tw.Word2Vec(tw.Word2VecParameters(training_frame=tfr,
                                                   device="cpu",
                                                   **kw)).train_model()
        finally:
            for mod, orig in origs:
                mod._sgns_step = orig
        assert tm.vocab == jm.vocab and "rare" in tm.vocab
        assert len(steps["port"]) == len(steps["ref"]) > 0
        for a, b in zip(steps["port"], steps["ref"]):
            for x, y in zip(a[:3], b[:3]):
                assert np.array_equal(x, y)
            assert a[3] == b[3]
        _close(tm.vectors, jm.vectors, 0, tol, f"vectors {epochs}")
        fits[epochs] = (jm, tm)
    jm, tm = fits[10]
    assert set(tm.find_synonyms("apple", 3)) <= {"banana", "cherry", "grape"}
    cm = tw.Word2VecModel.from_reference(jm, "cpu")
    assert np.array_equal(cm.vectors, np.asarray(jm.vectors))
    for agg in ("NONE", "AVERAGE"):
        jt = jm.transform(jfr.vec(0), aggregate_method=agg)
        tt = cm.transform(tfr.vec(0), aggregate_method=agg)
        assert tt.nrow == jt.nrow and tt.ncol == jt.ncol == 16
        for j in range(16):
            assert np.array_equal(tt.vec(j).to_numpy(), jt.vec(j).to_numpy(),
                                  equal_nan=True)
    assert cm.find_synonyms("cpu", 3) == jm.find_synonyms("cpu", 3)
    # pre-trained embeddings import alike
    pre = {"Word": np.array(["a", "b", "a", None], dtype=object)}
    pre.update({f"V{j}": np.arange(4, dtype=np.float32) + j
                for j in range(3)})
    jpre = JFrame(["Word"] + [f"V{j}" for j in range(3)],
                  [JVec(None, 4, type=J_STR, host_data=pre["Word"])]
                  + [JVec.from_numpy(pre[f"V{j}"]) for j in range(3)])
    tpre = Frame(["Word"] + [f"V{j}" for j in range(3)],
                 [Vec(None, 4, type=T_STR, host_data=pre["Word"])]
                 + [Vec.from_numpy(pre[f"V{j}"], device="cpu")
                    for j in range(3)])
    jm2 = jw.Word2Vec(jw.Word2VecParameters(pre_trained=jpre)).train_model()
    tm2 = tw.Word2Vec(tw.Word2VecParameters(pre_trained=tpre)).train_model()
    assert tm2.vocab == jm2.vocab
    assert np.array_equal(tm2.vectors, np.asarray(jm2.vectors))
    return fits


def test_last_families_match_the_reference():
    """PSVM, GLRM (every loss and regularizer, ``loss_by_col``, the bad
    losses rejected, the three inits), Aggregator and Word2Vec against the
    reference, each module's pure functions one by one, and each
    ``from_reference`` carrier; tolerances in the module docstring."""
    _check_psvm()
    _check_glrm()
    _check_aggregator()
    _check_word2vec()


# ---------------------------------------------------------------------------
# MOJO writers and offsets
# ---------------------------------------------------------------------------
def _entries(path) -> dict:
    """name -> bytes of every zip entry, model.ini's uuid line dropped."""
    out = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            data = z.read(name)
            if name.endswith("model.ini"):
                data = b"\n".join(ln for ln in data.split(b"\n")
                                  if not ln.startswith(b"uuid = "))
            out[name] = data
    return out


def _check_writers(tmp_path):
    from h2o_tpu.models import glrm as jg
    from h2o_tpu.models import psvm as jps
    from h2o_tpu.models import word2vec as jw
    from h2o_tpu_torch.models import glrm as tg
    from h2o_tpu_torch.models import psvm as tps
    from h2o_tpu_torch.models import word2vec as tw

    cases = []
    for kind in ("linear", "wide"):
        n, (jfr, tfr) = _psvm_frames(kind)
        kt = "linear" if kind == "linear" else "gaussian"
        with meshmod.use_mesh(ONE):
            jm = jps.PSVM(jps.SVMParameters(
                training_frame=jfr, response_column="y", kernel_type=kt,
                seed=4)).train_model()
        cases.append(("psvm", jm, tps.SVMModel.from_reference(jm, "cpu"),
                      jfr, tfr))
    cols, cats = _glrm_cols("mixed")
    jfr, tfr = _frames(cols, cats)
    with meshmod.use_mesh(ONE):
        jm = jg.GLRM(jg.GLRMParameters(training_frame=jfr, k=2,
                                       max_iterations=30, seed=1,
                                       transform="STANDARDIZE")).train_model()
    cases.append(("glrm", jm, tg.GLRMModel.from_reference(jm, "cpu"),
                  jfr, tfr))
    words = np.array(_w2v_corpus() + ["naïve, \"q\""] * 5, dtype=object)
    jfr = JFrame(["w"], [JVec(None, len(words), type=J_STR,
                              host_data=words)])
    jm = jw.Word2Vec(jw.Word2VecParameters(training_frame=jfr, vec_size=8,
                                           epochs=2, seed=6)).train_model()
    cases.append(("word2vec", jm, tw.Word2VecModel.from_reference(jm, "cpu"),
                  jfr, None))
    for i, (kind, jm, tm, jfr, tfr) in enumerate(cases):
        jpath = str(tmp_path / f"{kind}{i}_ref.zip")
        tpath = str(tmp_path / f"{kind}{i}_port.zip")
        jm.save_mojo(jpath)
        assert tm.save_mojo(tpath) == tpath
        je, te = _entries(jpath), _entries(tpath)
        assert sorted(te) == sorted(je), kind
        for name in je:
            assert te[name] == je[name], (kind, name)
        tr = TMojo.load(tpath)
        if kind == "word2vec":
            ws = list(tm.vocab) + ["zzz"]
            got = tr.transform(ws)
            assert np.array_equal(got[:-1], tm.vectors[[tm.vocab[w]
                                                        for w in ws[:-1]]])
            assert np.isnan(got[-1]).all()
            assert list(tr.find_synonyms("apple", 3)) == list(
                tm.find_synonyms("apple", 3))
            continue
        X = tr.feature_frame_matrix(tfr)
        got = tr.score(X)
        if kind == "psvm":
            pred = tm.predict(tfr)
            want = np.stack([pred.vec(j).to_numpy() for j in range(3)], 1)
            np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-3,
                                       atol=1e-4)
            assert (got[:, 0] == want[:, 0]).mean() > 0.99
        else:
            rec = tm.predict(tfr)
            want = np.stack([rec.vec(j).to_numpy() for j in range(rec.ncol)],
                            1)
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def _offset_frame(with_words=False):
    rng = np.random.default_rng(21)
    n = 400
    x = rng.normal(size=(n, 4)).astype(np.float32)
    cols = {f"x{j}": x[:, j] for j in range(4)}
    cols["c"] = rng.integers(0, 3, n).astype(np.float32)
    cols["off"] = (0.3 * rng.normal(size=n)).astype(np.float32)
    logit = x[:, 0] + 0.5 * x[:, 1] + cols["off"]
    cols["y"] = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    cols["yr"] = (logit + 0.2 * rng.normal(size=n)).astype(np.float32)
    cols["t"] = rng.integers(0, 2, n).astype(np.float32)
    cols["time"] = rng.integers(1, 60, n).astype(np.float32)
    cols["event"] = (rng.random(n) < 0.6).astype(np.float32)
    return _frames(cols, {"c": ["a", "b", "c"], "y": ["n", "p"],
                          "t": ["0", "1"]})


def _sub(fr, drop):
    return fr.subframe([n for n in fr.names if n not in drop])


def _same(a, b, path="model", depth=0):
    """Two port models (or parts of them) bit-equal: tensors, arrays,
    floats, containers and nested models, recursively."""
    assert depth < 8, path
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.shape == b.shape, path
        assert torch.equal(torch.nan_to_num(a, 7.25), torch.nan_to_num(b, 7.25)), path
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, float):
        assert a == b or (np.isnan(a) and np.isnan(b)), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]", depth + 1)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]", depth + 1)
    elif isinstance(a, Frame):
        assert a.names == b.names, path
        for name in a.names:
            _same(a.vec(name).to_numpy(), b.vec(name).to_numpy(),
                  f"{path}.{name}", depth + 1)
    elif hasattr(a, "__slots__") and not isinstance(a, type):
        assert type(a) is type(b), path
        for k in a.__slots__:
            _same(getattr(a, k), getattr(b, k), f"{path}.{k}", depth + 1)
    elif hasattr(a, "__dict__") and not isinstance(a, type):
        assert type(a) is type(b), path
        for k, v in vars(a).items():
            if k in ("params", "output", "key", "_key", "job") or callable(v):
                continue
            _same(v, getattr(b, k), f"{path}.{k}", depth + 1)
    else:
        assert a == b, path


def _check_offsets():
    import h2o_tpu_torch as t
    from h2o_tpu_torch.models.ensemble import (StackedEnsemble,
                                               StackedEnsembleParameters)

    jfr, fr = _offset_frame()
    sup = ["x0", "x1", "x2", "x3", "c", "off", "y"]
    uns = ["x0", "x1", "x2", "x3", "c", "off"]
    gcv = dict(nfolds=2, fold_assignment="Modulo", seed=1,
               keep_cross_validation_predictions=True)
    base = fr.subframe(sup)
    bases = [t.GBM(t.GBMParameters(training_frame=_sub(base, ["off"]),
                                   response_column="y", ntrees=2,
                                   max_depth=2, **gcv)).train_model(),
             t.GLM(t.GLMParameters(training_frame=_sub(base, ["off"]),
                                   response_column="y", family="binomial",
                                   **gcv)).train_model()]
    words = np.array(_w2v_corpus()[:400], dtype=object)
    wfr = Frame(["w", "off"], [Vec(None, 400, type=T_STR, host_data=words),
                               Vec.from_numpy(np.zeros(400, np.float32),
                                              device="cpu")])
    # (builder, params class, columns, parameters, twin: "ignore" = the
    # column in ``ignored_columns``, "keep" = the column as a plain one)
    kinds = [
        (t.GBM, t.GBMParameters, sup, dict(ntrees=3, max_depth=3), "ignore"),
        (t.DRF, t.DRFParameters, sup, dict(ntrees=3, max_depth=3), "ignore"),
        (t.XRT, t.XRTParameters, sup, dict(ntrees=3, max_depth=3), "ignore"),
        (t.DT, t.DTParameters, sup, dict(max_depth=3), "ignore"),
        (t.XGBoost, t.XGBoostParameters, sup, dict(ntrees=3, max_depth=3),
         "ignore"),
        (t.DeepLearning, t.DeepLearningParameters, sup,
         dict(hidden=[4], epochs=1), "ignore"),
        (t.KMeans, t.KMeansParameters, uns, dict(k=3, init="PlusPlus"),
         "ignore"),
        (t.PCA, t.PCAParameters, uns, dict(k=2), "ignore"),
        (t.SVD, t.SVDParameters, uns, dict(nv=2), "ignore"),
        (t.NaiveBayes, t.NaiveBayesParameters, sup, {}, "ignore"),
        (t.IsolationForest, t.IsolationForestParameters, uns,
         dict(ntrees=3, sample_size=64), "ignore"),
        (t.ExtendedIsolationForest, t.IsolationForestParameters, uns,
         dict(ntrees=3, sample_size=64, extension_level=1), "ignore"),
        (t.UpliftDRF, t.UpliftDRFParameters, sup + ["t"],
         dict(treatment_column="t", ntrees=2, max_depth=3), "ignore"),
        (t.AdaBoost, t.AdaBoostParameters, sup, dict(nlearners=3), "keep"),
        (t.Infogram, t.InfogramParameters, sup,
         dict(infogram_algorithm_params={"ntrees": 2}), "ignore"),
        (t.TargetEncoder, t.TargetEncoderParameters, sup,
         dict(columns_to_encode=["c"], noise=0.0), "keep"),
        (t.IsotonicRegression, t.IsotonicParameters, ["x0", "off", "yr"],
         {}, "ignore"),
        (t.QuantileBuilder, t.QuantileParameters, uns, {}, "keep"),
        (t.CoxPH, t.CoxPHParameters, ["x0", "x1", "c", "off", "time",
                                      "event"],
         dict(stop_column="time"), "ignore"),
        (t.RuleFit, t.RuleFitParameters, sup,
         dict(rule_generation_ntrees=10, max_rule_length=2,
              min_rule_length=1), "ignore"),
        (t.ModelSelection, t.ModelSelectionParameters,
         ["x0", "x1", "x2", "off", "yr"], dict(mode="maxr"), "ignore"),
        (StackedEnsemble, StackedEnsembleParameters, sup,
         dict(base_models=bases), "keep"),
        (t.PSVM, t.SVMParameters, sup, dict(kernel_type="gaussian"), "ignore"),
        (t.GLRM, t.GLRMParameters, uns, dict(k=2, max_iterations=10),
         "ignore"),
        (t.Aggregator, t.AggregatorParameters, uns,
         dict(target_num_exemplars=40), "ignore"),
        (t.Word2Vec, t.Word2VecParameters, None,
         dict(vec_size=4, epochs=1, min_word_freq=2), "ignore"),
    ]
    for builder, pcls, cols, kw, twin in kinds:
        f = wfr if cols is None else fr.subframe(cols)
        resp = {"IsotonicRegression": "yr", "ModelSelection": "yr",
                "CoxPH": "event"}.get(builder.__name__, "y")
        if builder.supervised:
            kw = dict(kw, response_column=resp)
        kw = dict(kw, seed=1)
        m = builder(pcls(training_frame=f, offset_column="off",
                         **kw)).train_model()
        if twin == "ignore":
            kw = dict(kw, ignored_columns=["off"])
        m2 = builder(pcls(training_frame=f, **kw)).train_model()
        what = builder.__name__
        _same(m, m2, what)
        if what == "Word2Vec":              # scores words, not rows
            continue
        try:
            pa = m.predict(f)
        except (NotImplementedError, TypeError):   # no row predictions
            continue
        _same(pa, m2.predict(f), what + ".predict")
    # the builders that read the column fit it: the twin differs
    for builder, pcls, kw in ((t.GLM, t.GLMParameters,
                               dict(family="binomial")),
                              (t.GAM, t.GAMParameters,
                               dict(family="binomial", gam_columns=["x1"],
                                    num_knots=5))):
        f = fr.subframe(sup)
        m = builder(pcls(training_frame=f, offset_column="off",
                         response_column="y", **kw)).train_model()
        m2 = builder(pcls(training_frame=_sub(f, ["off"]),
                          response_column="y", **kw)).train_model()
        a, b = (torch.as_tensor(np.asarray(x.beta if not isinstance(
            x.beta, torch.Tensor) else x.beta.numpy())) for x in (m, m2))
        assert a.shape == b.shape and not torch.equal(a, b)
    # ANOVA GLM passes the column on to its GLM fits, as the reference's;
    # the reference trains with the column in the new builders and in
    # those that leave it out
    from h2o_tpu.models import aggregator as ja
    from h2o_tpu.models import anovaglm as jan
    from h2o_tpu.models import deeplearning as jdl
    from h2o_tpu.models import glrm as jg
    from h2o_tpu.models import psvm as jps

    cols = ["x0", "x1", "off", "yr"]
    kw = dict(response_column="yr", offset_column="off",
              highest_interaction_term=2)
    with meshmod.use_mesh(ONE):
        jm = jan.ANOVAGLM(jan.ANOVAGLMParameters(
            training_frame=jfr.subframe(cols), **kw)).train_model()
    tm = t.ANOVAGLM(t.ANOVAGLMParameters(training_frame=fr.subframe(cols),
                                         **kw)).train_model()
    tz = t.ANOVAGLM(t.ANOVAGLMParameters(
        training_frame=_sub(fr.subframe(cols), ["off"]),
        **dict(kw, offset_column=None))).train_model()
    jr, tr, zr = jm.result(), tm.result(), tz.result()
    assert [r["term"] for r in tr] == [r["term"] for r in jr]
    for a, b, z in zip(tr, jr, zr):
        assert abs(a["deviance"] - b["deviance"]) <= 1e-4 * max(
            1.0, abs(b["deviance"]))
    assert any(a["deviance"] != z["deviance"] for a, z in zip(tr, zr))
    for mod, pname, bname, cols, kw in (
            (jps, "SVMParameters", "PSVM", sup,
             dict(response_column="y", kernel_type="linear")),
            (jg, "GLRMParameters", "GLRM", uns,
             dict(k=2, max_iterations=5)),
            (ja, "AggregatorParameters", "Aggregator", uns,
             dict(target_num_exemplars=40)),
            (jdl, "DeepLearningParameters", "DeepLearning", sup,
             dict(response_column="y", hidden=[4], epochs=1))):
        with meshmod.use_mesh(ONE):
            getattr(mod, bname)(getattr(mod, pname)(
                training_frame=jfr.subframe(cols), offset_column="off",
                seed=1, **kw)).train_model()


def test_last_writers_and_offsets(tmp_path):
    """The PSVM, GLRM and word2vec MOJO writers against the reference's,
    the port's reader on their MOJOs, and ``offset_column`` in every
    builder kind; tolerances in the module docstring."""
    _check_writers(tmp_path)
    _check_offsets()
