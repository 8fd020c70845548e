"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
the same numpy columns into both packages, the reference on a one-device
mesh (its row samples draw over shard 0's padded length, which the port
reproduces), and the forest and variable-importance contracts.

Contracts the helpers hold (each test names its float tolerances):
- forest structure exactly: split features, NA directions, and at split
  nodes the set-split direction rows; split thresholds within 1e-6
  relative or 5e-7 absolute, the bin edges' own tolerance (a quantile cut
  may differ by up to 2 ulps at its column's magnitude, ROADMAP Queue 3
  item 1);
- leaf values within ``val_atol`` (0 asks for bit-equality);
- variable importances: the same variable order, percentages within 1e-5.
"""

import numpy as np

import jax

from h2o_tpu.frame.frame import Frame as JFrame
from h2o_tpu.frame.vec import T_CAT as J_CAT
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import Frame
from h2o_tpu_torch.frame.vec import T_CAT, Vec

THR_ATOL = 5e-7


class LazyCases(dict):
    """A module fixture's cases, each trained on first use: ``fit(case)``
    runs when a test first reads ``cases[case]``. Under xdist the tests
    of one module land on several workers, and each worker that reads a
    module fixture builds it; built lazily, a worker trains only the
    cases its own tests read."""

    def __init__(self, fit):
        super().__init__()
        self._fit = fit

    def __missing__(self, case):
        self[case] = out = self._fit(case)
        return out


def frames(cols, y=None, ydom=None):
    """(mesh, reference frame, port frame) of numeric ``cols`` plus the
    response ``y`` as "y" (categorical over ``ydom`` when given)."""
    one = meshmod.make_mesh(jax.devices()[:1])
    jfr = JFrame.from_dict(cols, mesh=one)
    fr = Frame.from_dict(cols, device="cpu")
    if y is not None:
        kw = dict(type=J_CAT, domain=list(ydom)) if ydom else {}
        jfr.add("y", JVec.from_numpy(y, mesh=one, **kw))
        kw = dict(type=T_CAT, domain=list(ydom)) if ydom else {}
        fr.add("y", Vec.from_numpy(y, device="cpu", **kw))
    return one, jfr, fr


def train_both(ref_builder, ref_params, builder, params, cols, y, ydom=None,
               **kw):
    """The same model trained by both packages: (reference model, port
    model, reference frame, port frame)."""
    one, jfr, fr = frames(cols, y, ydom)
    with meshmod.use_mesh(one):
        jm = ref_builder(ref_params(training_frame=jfr, response_column="y",
                                    **kw)).train_model()
    tm = builder(params(training_frame=fr, response_column="y",
                        **kw)).train_model()
    return jm, tm, jfr, fr


def assert_forest_equal(jm, tm, val_atol: float) -> None:
    jf = {k: np.asarray(v) for k, v in jm.forest.items()}
    tf = {k: v.numpy() for k, v in tm.forest.items()}
    assert jf["feat"].shape == tf["feat"].shape
    assert np.array_equal(jf["feat"], tf["feat"])
    assert np.array_equal(jf["nanL"], tf["nanL"])
    split = jf["feat"] >= 0
    assert split.any()
    assert np.array_equal(jf["catd"][split], tf["catd"][split])
    np.testing.assert_allclose(tf["thr"][split], jf["thr"][split], rtol=1e-6,
                               atol=THR_ATOL)
    if val_atol == 0:
        assert np.array_equal(tf["val"].view(np.int32),
                              jf["val"].view(np.int32))
    else:
        np.testing.assert_allclose(tf["val"], jf["val"], rtol=0,
                                   atol=val_atol)


def assert_varimp_equal(jm, tm) -> None:
    jv, tv = jm.output.variable_importances, tm.output.variable_importances
    assert (jv is None) == (tv is None)
    if jv is None:
        return
    assert tv["variable"] == jv["variable"]
    np.testing.assert_allclose(tv["percentage"], jv["percentage"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tv["scaled_importance"],
                               jv["scaled_importance"], rtol=0, atol=1e-5)
    assert abs(float(np.sum(tv["percentage"])) - 1.0) <= 1e-5


def one_mesh():
    return meshmod.make_mesh(jax.devices()[:1])


def both_frames(cols: dict, one=None):
    """(reference frame, port frame) of ``cols``: a numpy array is a
    numeric column (int64 past 2^24 keeps its exact copy), an object array
    a string column, ``(codes, domain)`` a categorical column. The
    reference frame lives on ``one`` (a one-device mesh)."""
    from h2o_tpu.frame.vec import T_STR as J_STR

    from h2o_tpu_torch.frame.vec import T_STR

    one = one or one_mesh()
    jn, jv, tv = [], [], []
    for name, c in cols.items():
        if isinstance(c, tuple):
            codes, dom = c
            jv.append(JVec.from_numpy(codes, mesh=one, type=J_CAT,
                                      domain=list(dom)))
            tv.append(Vec.from_numpy(codes, device="cpu", type=T_CAT,
                                     domain=list(dom)))
        elif np.asarray(c).dtype == object:
            c = np.asarray(c, dtype=object)
            jv.append(JVec(None, len(c), type=J_STR, host_data=c.copy()))
            tv.append(Vec(None, len(c), type=T_STR, host_data=c.copy()))
        else:
            jv.append(JVec.from_numpy(c, mesh=one))
            tv.append(Vec.from_numpy(c, device="cpu"))
        jn.append(name)
    return JFrame(jn, jv), Frame(list(jn), tv)


def _host(v):
    x = v.to_numpy()
    return np.asarray(x, dtype=object if x.dtype == object else np.float64)


def assert_same(j, t, rtol: float = 0.0, what: str = "", atol: float = 0.0):
    """A reference result and the port's: frames by names, types, domains
    and every column; Vecs likewise; numbers, lists, dicts and tuples
    element by element. ``rtol == atol == 0`` asks for equal values (NaN
    where NaN), else ``assert_allclose`` at the given tolerances."""
    from h2o_tpu.frame.frame import Frame as JF
    from h2o_tpu.frame.vec import Vec as JV

    if isinstance(j, JF):
        assert isinstance(t, Frame), (what, type(t))
        assert t.names == j.names, (what, t.names, j.names)
        assert t.nrow == j.nrow, (what, t.nrow, j.nrow)
        for n in j.names:
            assert_same(j.vec(n), t.vec(n), rtol, f"{what}[{n}]", atol)
        return
    if isinstance(j, JV):
        assert isinstance(t, Vec), (what, type(t))
        assert (t.type, t.nrow) == (j.type, j.nrow), (
            what, t.type, j.type, t.nrow, j.nrow)
        assert list(t.domain or []) == list(j.domain or []), what
        a, b = _host(j), _host(t)
        if t.exact_data is not None and j.exact_data is None:
            # the reference's sort and host merge drop the exact host copy
            # (ROADMAP Queue 3): hold the port's float32 projection to the
            # reference's values, and the port's exact copy to it
            b = t.data[:t.nrow].numpy().astype(np.float64)
            assert np.array_equal(t.exact_data.astype(np.float32), b,
                                  equal_nan=True), what
        if a.dtype == object:
            assert list(b) == list(a), what
        elif rtol == 0 and atol == 0:
            np.testing.assert_array_equal(b, a, err_msg=what)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                       err_msg=what)
        if t.data is not None:
            pad = t.data[t.nrow:]
            assert bool(pad.isnan().all()), f"{what}: padding not NaN"
        return
    if isinstance(j, dict):
        assert isinstance(t, dict) and sorted(t) == sorted(j), what
        for k in j:
            assert_same(j[k], t[k], rtol, f"{what}[{k}]", atol)
        return
    if isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(t) == len(j), (what, t, j)
        for i, (a, b) in enumerate(zip(j, t)):
            assert_same(a, b, rtol, f"{what}[{i}]", atol)
        return
    if isinstance(j, np.ndarray):
        if rtol == 0 and atol == 0:
            np.testing.assert_array_equal(np.asarray(t), j, err_msg=what)
        else:
            np.testing.assert_allclose(np.asarray(t), j, rtol=rtol,
                                       atol=atol, err_msg=what)
        return
    if j is None or isinstance(j, (str, bool)):
        assert t == j, (what, t, j)
        return
    a, b = float(j), float(t)
    if rtol == 0 and atol == 0:
        assert (np.isnan(a) and np.isnan(b)) or a == b, (what, b, a)
    else:
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=what)
