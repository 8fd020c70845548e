"""Port parity: monotone and interaction constraints of ``h2o_tpu_torch``
against the reference, on the scenarios of ``tests/test_monotone.py``
(the reference on a one-device mesh, ``tests/torch_parity.py``).

Contracts and tolerances:
- forests structurally equal (split features, NA directions; thresholds
  within the bin edges' tolerance), leaf values within 1e-5 (g/h sums in
  other orders; the per-node bounds clip at midpoints of such values);
- the port model keeps the property the reference test asserts: partial
  curves monotone within 1e-5, branches inside their interaction groups;
- the reference's ``ValueError``s for the same inputs: a column that is not
  a feature, a categorical column, a multinomial model.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.frame.vec import T_CAT as J_CAT
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.models.gbm import GBM as JGBM
from h2o_tpu.models.gbm import GBMParameters as JGBMParameters
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import GBM, Frame, GBMParameters
from h2o_tpu_torch.frame.vec import T_CAT, Vec

from torch_parity import (assert_forest_equal, assert_varimp_equal, frames,
                          train_both)

torch.set_num_threads(2)

LEAF_TOL = 1e-5


def _gbm_both(cols, y, ydom=None, **kw):
    return train_both(JGBM, JGBMParameters, GBM, GBMParameters, cols, y,
                      ydom, **kw)


def _cols(n=2000, seed=0):
    """``test_monotone.py:_frame``: increasing in x with a local dip."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, n).astype(np.float32)
    z = rng.normal(size=n).astype(np.float32)
    y = x + 1.5 * np.sin(2 * x) + 0.5 * z
    return {"x": x, "z": z}, y.astype(np.float32)


def _partial_curve(model, col=0, lo=-3.0, hi=3.0, npts=60, with_z=True):
    grid = np.linspace(lo, hi, npts).astype(np.float32)
    cols = {"x": grid}
    if with_z:
        cols["z"] = np.zeros(npts, np.float32)
    return model.predict(Frame.from_dict(cols, device="cpu")).vec(
        col).to_numpy()


@pytest.mark.parametrize("direction,seed,kw", [
    (1, 0, dict(ntrees=30, max_depth=4, seed=7, learn_rate=0.2)),
    (-1, 3, dict(ntrees=20, max_depth=4, seed=1))])
def test_monotone_regression_matches_the_reference(direction, seed, kw):
    cols, y = _cols(seed=seed)
    jm, tm, _, _ = _gbm_both(cols, y, monotone_constraints={"x": direction},
                             **kw)
    assert tm.cfg.use_monotone
    assert_forest_equal(jm, tm, LEAF_TOL)
    assert_varimp_equal(jm, tm)
    curve = _partial_curve(tm)
    assert (direction * np.diff(curve) >= -1e-5).all()


def test_monotone_binomial_matches_the_reference():
    rng = np.random.default_rng(5)
    n = 1500
    x = rng.uniform(-2, 2, n).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x + np.sin(3 * x))))).astype(
        np.float32)
    jm, tm, _, _ = _gbm_both({"x": x}, y, ydom=["n", "p"], ntrees=20,
                             max_depth=3, seed=2,
                             monotone_constraints={"x": 1})
    assert_forest_equal(jm, tm, LEAF_TOL)
    p1 = _partial_curve(tm, col=2, lo=-2.0, hi=2.0, npts=50, with_z=False)
    assert (np.diff(p1) >= -1e-5).all()
    assert tm.output.training_metrics.auc == pytest.approx(
        jm.output.training_metrics.auc, abs=1e-4)


def _validation_frames(case):
    """(reference frame, port frame) of each error case."""
    rng = np.random.default_rng(0)
    if case == "monotone_categorical":
        one, jfr, fr = frames({"x": np.zeros(60, np.float32)},
                              np.arange(60, dtype=np.float32))
        c = (np.arange(60) % 3).astype(np.float32)
        jfr.add("c", JVec.from_numpy(c, type=J_CAT, domain=["a", "b", "c"],
                                     mesh=one))
        fr.add("c", Vec.from_numpy(c, type=T_CAT, domain=["a", "b", "c"],
                                   device="cpu"))
        return one, jfr, fr
    if case == "monotone_multinomial":
        return frames({"x": rng.normal(size=90).astype(np.float32)},
                      (np.arange(90) % 3).astype(np.float32),
                      ydom=["a", "b", "c"])
    return frames({"x": rng.uniform(-3, 3, 100).astype(np.float32)},
                  rng.normal(size=100).astype(np.float32))


@pytest.mark.parametrize("case,match", [
    ("monotone_unknown", "not a feature"), ("monotone_categorical",
                                            "categorical"),
    ("monotone_multinomial", "multinomial"),
    ("interaction_unknown", "not a feature"),
    ("interaction_not_lists", "LISTS")])
def test_constraint_errors_match_the_reference(case, match):
    one, jfr, fr = _validation_frames(case)
    kw = dict(response_column="y", ntrees=2)
    kw.update({"monotone_unknown": dict(monotone_constraints={"nope": 1}),
               "monotone_categorical": dict(monotone_constraints={"c": 1}),
               "monotone_multinomial": dict(monotone_constraints={"x": 1}),
               "interaction_unknown": dict(interaction_constraints=[["zzz"]]),
               "interaction_not_lists": dict(interaction_constraints=["x"]),
               }[case])
    with meshmod.use_mesh(one), pytest.raises(ValueError, match=match):
        JGBM(JGBMParameters(training_frame=jfr, **kw)).train_model()
    with pytest.raises(ValueError, match=match):
        GBM(GBMParameters(training_frame=fr, **kw)).train_model()


def _interaction_cols():
    rng = np.random.default_rng(0)
    n = 2000
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = (X[:, 0] * X[:, 2] + X[:, 1] * X[:, 3]
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    return {f"x{j}": X[:, j] for j in range(4)}, y


def _ancestor_pairs(feat):
    """Every (ancestor split feature, split feature) pair of a forest."""
    pairs = set()
    for t in range(feat.shape[0]):
        for node in range(feat.shape[1]):
            f = feat[t, node]
            p = node
            while f >= 0 and p > 0:
                p = (p - 1) // 2
                if feat[t, p] >= 0:
                    pairs.add((int(feat[t, p]), int(f)))
    return pairs


@pytest.mark.parametrize("groups", [[["x0", "x1"], ["x2", "x3"]], None])
def test_interaction_constraints_match_the_reference(groups):
    cols, y = _interaction_cols()
    jm, tm, _, _ = _gbm_both(cols, y, ntrees=10, max_depth=4, seed=1,
                             interaction_constraints=groups)
    assert tm.cfg.use_interaction == bool(groups)
    assert_forest_equal(jm, tm, LEAF_TOL)
    pairs = _ancestor_pairs(tm.forest["feat"].numpy())
    cross = {(0, 2), (0, 3), (1, 2), (1, 3), (2, 0), (3, 0), (2, 1), (3, 1)}
    # inside the groups when constrained; mixed branches when not
    assert bool(pairs & cross) == (groups is None)
