"""Port parity: the categorical encodings (``h2o_tpu_torch/utils/
linalg.py``), their replay at scoring, the custom metric and the Model
surface (``h2o_tpu_torch/models/model_base.py``) against the reference
(``h2o_tpu/utils/linalg.py``, ``h2o_tpu/models/model_base.py``), the
reference on a one-device mesh.

The frames: a numeric column and two categoricals (16 and 4 levels) with
NAs for training, and a scoring frame whose domains are permuted and hold
a level the training never saw. Contracts and tolerances:
- each scheme's frozen state (domains, kept levels, orders, eigen
  loadings) and its encoded training and scoring frames (names, types,
  domains, every value) bit for bit;
- a GBM trained under EnumLimited and under SortByResponse (each once in
  each package): forests structurally equal, leaves and predictions
  through the replay within 1e-5; the custom metric's value within 1e-6
  of the reference's; the variable-importance and scoring-history tables
  the reference's (floats within 1e-5); ``auc()`` within 1e-4;
- ``balance_classes`` is accepted and changes nothing; CV models carry the
  encoding; a saved and loaded encoded model scores bit for bit alike.
"""

import numpy as np
import pytest
import torch

import jax

from h2o_tpu.frame.frame import Frame as JFrame
from h2o_tpu.frame.vec import T_CAT as J_CAT
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.models.gbm import GBM as JGBM
from h2o_tpu.models.gbm import GBMParameters as JGBMParameters
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu.utils import linalg as jlinalg
from h2o_tpu_torch import GBM, Frame, GBMParameters, load_model
from h2o_tpu_torch.frame.vec import T_CAT, Vec
from h2o_tpu_torch.utils import linalg as tlinalg

from torch_parity import assert_forest_equal

torch.set_num_threads(2)

N = 1500
C_DOM = [f"c{i:02d}" for i in range(16)]
D_DOM = ["p", "q", "r", "s"]
#: the scoring frame's domains: permuted, with an unseen level each
C_SCORE = C_DOM[::-1] + ["unseen"]
D_SCORE = ["s", "new", "q", "p", "r"]
TOL = 1e-5


def _cols(n, seed, cdom, ddom):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, len(cdom), size=n).astype(np.float32)
    d = rng.integers(0, len(ddom), size=n).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    c[::13] = np.nan
    d[::17] = np.nan
    x[::19] = np.nan
    return c, d, x, rng


def _train_cols():
    c, d, x, rng = _cols(N, 3, C_DOM, D_DOM)
    # level effects with a skewed level mix: EnumLimited's top 10 and
    # SortByResponse's order both carry signal
    effect = np.linspace(-1.5, 1.5, 16)[np.random.default_rng(4)
                                         .permutation(16)]
    eta = np.where(np.isnan(c), 0.0, effect[np.nan_to_num(c).astype(int)])
    eta = eta + 0.8 * np.nan_to_num(x) + 0.5 * (d == 2)
    y = (eta + rng.normal(0, 1.0, N) > 0).astype(np.float32)
    return c, d, x, y


def _frames(c, d, x, y, cdom, ddom):
    one = meshmod.make_mesh(jax.devices()[:1])
    jfr = JFrame(["c", "d", "x"], [
        JVec.from_numpy(c, type=J_CAT, domain=list(cdom), mesh=one),
        JVec.from_numpy(d, type=J_CAT, domain=list(ddom), mesh=one),
        JVec.from_numpy(x, mesh=one)])
    fr = Frame(["c", "d", "x"], [
        Vec.from_numpy(c, type=T_CAT, domain=list(cdom), device="cpu"),
        Vec.from_numpy(d, type=T_CAT, domain=list(ddom), device="cpu"),
        Vec.from_numpy(x, device="cpu")])
    if y is not None:
        jfr.add("y", JVec.from_numpy(y, type=J_CAT, domain=["n", "y"],
                                     mesh=one))
        fr.add("y", Vec.from_numpy(y, type=T_CAT, domain=["n", "y"],
                                   device="cpu"))
    return one, jfr, fr


def _train_frames():
    c, d, x, y = _train_cols()
    return _frames(c, d, x, y, C_DOM, D_DOM)


def _score_frames():
    c, d, x, _rng = _cols(400, 9, C_SCORE, D_SCORE)
    return _frames(c, d, x, None, C_SCORE, D_SCORE)


def _assert_frames_equal(jfr, fr):
    assert fr.names == jfr.names
    for name in fr.names:
        jv, tv = jfr.vec(name), fr.vec(name)
        assert tv.type == jv.type, name
        assert tv.domain == (list(jv.domain) if jv.domain else None), name
        a, b = np.asarray(jv.to_numpy(), np.float32), tv.to_numpy()
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), name


SCHEMES = ["Eigen", "OneHotExplicit", "Binary", "LabelEncoder",
           "EnumLimited", "SortByResponse", "sort_by_response", "AUTO"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_encoded_frames_are_the_references(scheme):
    one, jfr, fr = _train_frames()
    _one, jsc, sc = _score_frames()
    kw = dict(skip=["y"], response="y", max_levels=10)
    with meshmod.use_mesh(one):
        jstate = jlinalg.build_encoding_state(jfr, scheme, **kw)
    state = tlinalg.build_encoding_state(fr, scheme, **kw)
    if scheme == "AUTO":
        assert state is None and jstate is None
        return
    assert state["encoding"] == jstate["encoding"]
    assert list(state["columns"]) == list(jstate["columns"])
    for name, spec in jstate["columns"].items():
        ours = state["columns"][name]
        assert set(ours) == set(spec)
        for k, v in spec.items():
            if k == "loadings":
                assert np.array_equal(ours[k].view(np.int32),
                                      np.asarray(v).view(np.int32))
            else:
                assert ours[k] == v, (name, k)
    with meshmod.use_mesh(one):
        jtrain = jlinalg.apply_encoding_state(jfr, jstate)
        jscore = jlinalg.apply_encoding_state(jsc, jstate)
    _assert_frames_equal(jtrain, tlinalg.apply_encoding_state(fr, state))
    _assert_frames_equal(jscore, tlinalg.apply_encoding_state(sc, state))


def test_eigen_vec_is_the_references():
    one, jfr, fr = _train_frames()
    with meshmod.use_mesh(one):
        ref = jlinalg.to_eigen_vec(jfr.vec("c")).to_numpy()
    ours = tlinalg.to_eigen_vec(fr.vec("c")).to_numpy()
    assert np.array_equal(ours.view(np.int32),
                          np.asarray(ref, np.float32).view(np.int32))


def _mean_p1(y, raw, w):
    """A custom metric: the weighted mean predicted p1 of class-1 rows."""
    ok = y == 1
    return "mean_p1_pos", float(np.sum(w[ok] * raw[ok, 2]) / np.sum(w[ok]))


@pytest.mark.parametrize("scheme", ["EnumLimited", "SortByResponse"])
def test_gbm_on_an_encoded_frame_matches_the_reference(scheme):
    one, jfr, fr = _train_frames()
    _one, jsc, sc = _score_frames()
    kw = dict(response_column="y", ntrees=5, max_depth=3, seed=1,
              score_tree_interval=2, categorical_encoding=scheme,
              custom_metric_func=_mean_p1)
    with meshmod.use_mesh(one):
        jm = JGBM(JGBMParameters(training_frame=jfr, **kw)).train_model()
        jraw = np.asarray(jm.score0(jm.adapt_frame(jsc)))[:sc.nrow]
        jvi, jsh = jm.varimp_table(), jm.scoring_history_table()
        jmm = jm.output.training_metrics
    tm = GBM(GBMParameters(training_frame=fr, **kw)).train_model()
    assert tm.output.names == jm.output.names
    assert tm.output.domains == {k: (list(v) if v is not None else None)
                                 for k, v in jm.output.domains.items()}
    assert_forest_equal(jm, tm, TOL)
    raw = tm.score0(tm.adapt_frame(sc))[:sc.nrow].numpy()
    np.testing.assert_allclose(raw, jraw, rtol=0, atol=TOL)
    pred = tm.predict(sc)
    np.testing.assert_allclose(pred.vec(2).to_numpy(), jraw[:, 2], rtol=0,
                               atol=TOL)

    tmm = tm.output.training_metrics
    assert tmm.custom_metric_name == jmm.custom_metric_name == "mean_p1_pos"
    assert tmm.custom_metric_value == pytest.approx(jmm.custom_metric_value,
                                                    abs=1e-6)
    assert tm.auc() == pytest.approx(jm.auc(), abs=1e-4)
    for ours, ref in ((tm.varimp_table(), jvi),
                      (tm.scoring_history_table(), jsh)):
        assert ours.table_header == ref.table_header
        assert ours.col_header == ref.col_header
        assert len(ours.cell_values) == len(ref.cell_values)
        for ro, rr in zip(ours.cell_values, ref.cell_values):
            for a, b in zip(ro, rr):
                if isinstance(b, str):
                    assert a == b
                elif ours.table_header == "Scoring History" and \
                        isinstance(b, float) and b > 1e9:
                    continue   # the timestamp column
                else:
                    assert a == pytest.approx(b, rel=1e-5, abs=1e-5)


def test_encoded_models_carry_their_encoding(tmp_path):
    """``balance_classes`` accepted and ignored (no builder of the
    reference reads it); each CV model carries the main model's
    encoding; the custom metric's value is the numpy recomputation; a
    saved and loaded encoded model scores the unencoded frame bit for bit
    as before."""
    _one, _jfr, fr = _train_frames()
    _one, _jsc, sc = _score_frames()
    kw = dict(training_frame=fr, response_column="y", ntrees=3, max_depth=3,
              seed=1, categorical_encoding="EnumLimited",
              max_categorical_levels=6)
    m = GBM(GBMParameters(balance_classes=True, nfolds=2,
                          custom_metric_func=_mean_p1, **kw)).train_model()
    plain = GBM(GBMParameters(nfolds=2, **kw)).train_model()
    for k in ("feat", "thr", "nanL", "val", "catd"):
        assert torch.equal(m.forest[k], plain.forest[k])
    assert "c.top_6_levels" in m.output.names and "d" in m.output.names
    assert [cv.output.encoding_state for cv in m.output.cv_models] == \
        [m.output.encoding_state] * 2
    y = fr.vec("y").to_numpy()
    raw = m.score0(m.adapt_frame(fr))[:fr.nrow].numpy()
    name, value = _mean_p1(y, raw, np.ones(fr.nrow, np.float32))
    assert m.output.training_metrics.custom_metric_value == value
    back = load_model(m.save(str(tmp_path / "m.bin")), device="cpu")
    assert back.params.custom_metric_func is None
    a, b = m.predict(sc), back.predict(sc)
    for j in range(a.ncol):
        assert np.array_equal(a.vec(j).to_numpy().view(np.int32),
                              b.vec(j).to_numpy().view(np.int32))
