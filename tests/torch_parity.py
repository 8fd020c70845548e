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
