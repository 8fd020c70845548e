"""Port contracts and parity: checkpoint continuation, in-training
snapshots and kill-and-resume of ``h2o_tpu_torch`` (``models/gbm.py``,
``models/xgboost.py``, ``models/model_base.py``,
``backend/persist.py``).

The port's own drills, on 300-row frames (``tests/test_recovery.py:
86-283``, ``tests/test_checkpoint.py:59-115``):
- a GBM killed at every checkpoint boundary, then ``resume_training``:
  forest and predictions bit-equal to the uninterrupted run; a second
  resume refuses; an early-stopped build resumed at any boundary stops
  where it did; a reused recovery dir resumes on the new job's frame; a
  DRF resume keeps its forest, its out-of-bag sums and counts and its
  training metrics bit-equal; a continuation whose prior the store lost
  resumes from the prior saved in the dir; a kill before the first
  checkpoint replays from the start; a crash between a state's temp write
  and its rename leaves the previous state resumable; a crafted state file
  is refused by the allowlisted unpickler; a CV build trains without
  recovery, with the reference's warning;
- the prior's replay in bin-code space equals the raw replay bit for bit,
  and an off-grid prior falls back to the raw replay;
- a 4 -> 10-tree continuation equals the port's own 10-tree run in
  structure, with leaves and predictions within 1e-5 (the replayed margin
  sums in another order); the compatibility checks; the stored params
  name the prior by key; ``export_checkpoints_dir`` writes one loadable
  snapshot per scoring interval; a continued DRF reports in-bag metrics.

Against the reference (trained once, in a module-scoped fixture, on the
reference's one-device mesh):
- a 4 -> 10-tree GBM continuation: forest structure equal (thresholds at
  the bin edges' tolerance), leaves and predictions within 1e-5;
- a DART continuation from the same prior: the drops of the reference's
  draw order (fresh from the seed at round 4), forest structure equal,
  leaves within 1e-5.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from h2o_tpu.models.gbm import GBM as JGBM
from h2o_tpu.models.gbm import GBMParameters as JGBMParameters
from h2o_tpu.models.xgboost import XGBoost as JXGBoost
from h2o_tpu.models.xgboost import XGBoostParameters as JXGBoostParameters
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import (DRF, GBM, STORE, DRFParameters, Frame,
                           GBMParameters, XGBoost, XGBoostParameters,
                           load_model, resume_training)
from h2o_tpu_torch.backend.persist import Recovery
from h2o_tpu_torch.frame.vec import T_CAT, Vec
from h2o_tpu_torch.models import gbm as gbm_mod
from h2o_tpu_torch.utils import failpoints as fp

from torch_parity import assert_forest_equal, frames

torch.set_num_threads(2)

LEAF_TOL = 1e-5


@pytest.fixture(autouse=True)
def _fault_hygiene(monkeypatch):
    monkeypatch.delenv("H2O_TORCH_FAILPOINTS", raising=False)
    monkeypatch.setenv("H2O_TORCH_CHECKPOINT_SECS", "0")  # every boundary
    fp.reset()
    yield
    fp.reset()


_RNG = np.random.default_rng(7)
_N = 300
_COLS = {
    "x1": _RNG.normal(size=_N).astype(np.float32),
    "x2": _RNG.normal(size=_N).astype(np.float32),
    "c": _RNG.integers(0, 4, size=_N).astype(np.float32),
}
_Y = ((_COLS["x1"] - 0.4 * _COLS["x2"] + 0.3 * _COLS["c"]
       + _RNG.normal(scale=0.4, size=_N)) > 0.2).astype(np.float32)


def _frame(flip: bool = False):
    """The drill frame; ``flip`` gives a second, different dataset."""
    s = -1.0 if flip else 1.0
    fr = Frame.from_dict({"x1": s * _COLS["x1"],
                          "x2": _COLS["x2"] + (2.0 if flip else 0.0)},
                         device="cpu")
    fr.add("c", Vec.from_numpy(_COLS["c"], type=T_CAT,
                               domain=["a", "b", "c", "d"], device="cpu"))
    fr.add("y", Vec.from_numpy(1.0 - _Y if flip else _Y, type=T_CAT,
                               domain=["0", "1"], device="cpu"))
    return fr


def _forest_equal(a, b) -> bool:
    return set(a.forest) == set(b.forest) and all(
        torch.equal(a.forest[k], b.forest[k]) for k in a.forest)


def _p1(m, fr=None):
    return m.predict(fr if fr is not None else _frame()).vec(2).data


def _params(cls, **kw):
    base = dict(training_frame=_frame(), response_column="y", ntrees=6,
                max_depth=3, score_tree_interval=2, seed=42)
    base.update(kw)
    return cls(**base)


def _killed(cls, params, site="train.gbm.chunk", spec="raise(preempt)@1",
            exc=fp.InjectedPreemption):
    fp.reset()
    fp.arm(site, spec)
    with pytest.raises(exc):
        cls(params).train_model()
    fp.reset()


# ---------------------------------------------------------------------------
# kill-and-resume, bit-equal
# ---------------------------------------------------------------------------
def test_gbm_kill_resume_bit_parity_every_boundary(tmp_path):
    base = GBM(_params(GBMParameters)).train_model()
    for k in (1, 2, 3):    # ntrees 6 / interval 2
        rdir = str(tmp_path / f"gbm_k{k}")
        _killed(GBM, _params(GBMParameters, auto_recovery_dir=rdir),
                spec=f"raise(preempt)@{k}")
        m = resume_training(rdir, device="cpu")
        assert m.ntrees == 6
        assert _forest_equal(m, base), f"forest diverged at kill point {k}"
        assert torch.equal(_p1(m), _p1(base)), k
        with pytest.raises(ValueError, match="already completed"):
            resume_training(rdir, device="cpu")


def test_early_stopping_survives_a_resume(tmp_path):
    """The state is written after the stop decision, so a resumed build
    sees the whole stopping series and stops where the uninterrupted one
    did (the reference writes it before: ROADMAP Queue 3 item 8)."""
    kw = dict(ntrees=12, score_tree_interval=1, stopping_rounds=2,
              stopping_tolerance=0.1)
    base = GBM(_params(GBMParameters, **kw)).train_model()
    assert 3 < base.ntrees < 12
    for k in range(2, base.ntrees + 1):
        rdir = str(tmp_path / f"stop_k{k}")
        _killed(GBM, _params(GBMParameters, auto_recovery_dir=rdir, **kw),
                spec=f"raise(preempt)@{k}")
        m = resume_training(rdir, device="cpu")
        assert m.ntrees == base.ntrees and _forest_equal(m, base), k


def test_reused_recovery_dir_resumes_on_the_new_jobs_frame(tmp_path):
    rdir = str(tmp_path / "reuse")
    _killed(GBM, _params(GBMParameters, auto_recovery_dir=rdir))
    base = GBM(_params(GBMParameters, training_frame=_frame(True))
               ).train_model()
    _killed(GBM, _params(GBMParameters, training_frame=_frame(True),
                         auto_recovery_dir=rdir), spec="raise(preempt)@2")
    m = resume_training(rdir, device="cpu")
    assert _forest_equal(m, base)
    assert torch.equal(_p1(m, _frame(True)), _p1(base, _frame(True)))


def test_drf_kill_resume_bit_parity(tmp_path, monkeypatch):
    seen = []
    real = gbm_mod._oob_metrics

    def spy(category, osum, ocnt, *a, **kw):
        seen.append((osum.clone(), ocnt.clone()))
        return real(category, osum, ocnt, *a, **kw)

    monkeypatch.setattr(gbm_mod, "_oob_metrics", spy)
    base = DRF(_params(DRFParameters, ntrees=4, sample_rate=0.8)
               ).train_model()
    base_oob = seen[-1]
    rdir = str(tmp_path / "drf")
    _killed(DRF, _params(DRFParameters, ntrees=4, sample_rate=0.8,
                         auto_recovery_dir=rdir), spec="raise(preempt)@2")
    m = resume_training(rdir, device="cpu")
    assert m.ntrees == 4 and _forest_equal(m, base)
    assert torch.equal(seen[-1][0], base_oob[0])     # OOB sums
    assert torch.equal(seen[-1][1], base_oob[1])     # OOB counts
    assert torch.equal(_p1(m), _p1(base))
    tm, tb = m.output.training_metrics, base.output.training_metrics
    assert tm.description == tb.description == "Reported on OOB data"
    assert np.array_equal([tm.logloss, tm.auc], [tb.logloss, tb.auc],
                          equal_nan=True)


def test_continuation_prior_survives_a_fresh_process(tmp_path):
    """A continuation killed before its first state write resumes where
    the store never saw the prior: the dir holds the prior's file."""
    prior = GBM(_params(GBMParameters, ntrees=2)).train_model()
    base = GBM(_params(GBMParameters, checkpoint=prior)).train_model()
    rdir = str(tmp_path / "cont")
    _killed(GBM, _params(GBMParameters, checkpoint=prior,
                         auto_recovery_dir=rdir))
    STORE.remove(prior.key)
    m = resume_training(rdir, device="cpu")
    assert m.ntrees == 6 and torch.equal(_p1(m), _p1(base))


def test_kill_before_first_checkpoint_resumes_from_scratch(tmp_path):
    base = GBM(_params(GBMParameters)).train_model()
    rdir = str(tmp_path / "early")
    _killed(GBM, _params(GBMParameters, auto_recovery_dir=rdir))
    assert Recovery(rdir).read()["state_path"] is None
    assert _forest_equal(resume_training(rdir, device="cpu"), base)


def test_crash_between_tempwrite_and_rename_keeps_previous_state(tmp_path):
    base = GBM(_params(GBMParameters)).train_model()
    rdir = str(tmp_path / "torn")
    # writes: params (1), manifest (2); state 1 (3), manifest (4); state 2
    # (5) — killed after its temp bytes are durable, before the rename
    _killed(GBM, _params(GBMParameters, auto_recovery_dir=rdir),
            site="persist.checkpoint", spec="raise@5", exc=fp.InjectedFault)
    manifest = Recovery(rdir).read()
    assert manifest["checkpoints"] == 1 and not manifest["completed"]
    assert os.path.exists(os.path.join(rdir, "train_state.pkl.tmp"))
    assert _forest_equal(resume_training(rdir, device="cpu"), base)


def test_recovery_state_unpickler_is_allowlisted(tmp_path):
    rdir = str(tmp_path / "evil")
    _killed(GBM, _params(GBMParameters, auto_recovery_dir=rdir),
            spec="raise(preempt)@2")

    class Evil:
        def __reduce__(self):
            return (os.system, ("echo pwned",))

    with open(os.path.join(rdir, "train_state.pkl"), "wb") as f:
        pickle.dump({"algo": "gbm", "evil": Evil()}, f)
    with pytest.raises(pickle.UnpicklingError):
        resume_training(rdir, device="cpu")


def test_cv_build_trains_without_recovery(tmp_path, caplog):
    rdir = str(tmp_path / "cv")
    with caplog.at_level("WARNING", logger="h2o_tpu_torch"):
        m = GBM(_params(GBMParameters, nfolds=2, auto_recovery_dir=rdir)
                ).train_model()
    assert "not supported for CV builds" in caplog.text
    assert len(m.output.cv_models) == 2
    assert not os.path.exists(os.path.join(rdir, "recovery.json"))


# ---------------------------------------------------------------------------
# checkpoint continuation
# ---------------------------------------------------------------------------
def _cont_params(**kw):
    base = dict(training_frame=_frame(), response_column="y", max_depth=3,
                seed=9)
    base.update(kw)
    return GBMParameters(**base)


def test_binned_replay_matches_the_raw_replay(monkeypatch):
    prior = GBM(_cont_params(ntrees=3)).train_model()
    m_bin = GBM(_cont_params(ntrees=6, checkpoint=prior)).train_model()
    monkeypatch.setattr(gbm_mod, "_prior_thr_codes", lambda *a: None)
    m_raw = GBM(_cont_params(ntrees=6, checkpoint=prior)).train_model()
    assert _forest_equal(m_raw, m_bin)
    assert torch.equal(_p1(m_raw), _p1(m_bin))


def test_off_grid_prior_falls_back_to_the_raw_replay():
    prior = GBM(_cont_params(ntrees=2)).train_model()
    edges = prior.edges
    assert gbm_mod._prior_thr_codes(prior, edges) is not None
    thr = prior.forest["thr"].clone()
    node = tuple(torch.nonzero(prior.forest["feat"] >= 0)[0])
    thr[node] += 1e-3
    prior.forest["thr"] = thr
    assert gbm_mod._prior_thr_codes(prior, edges) is None
    m = GBM(_cont_params(ntrees=4, checkpoint=prior)).train_model()
    assert m.ntrees == 4


def test_continuation_matches_the_uninterrupted_run():
    full = GBM(_cont_params(ntrees=10)).train_model()
    first = GBM(_cont_params(ntrees=4)).train_model()
    cont = GBM(_cont_params(ntrees=10, checkpoint=first.key)).train_model()
    assert cont.ntrees == 10 and cont.params.checkpoint == first.key
    for k in ("feat", "nanL", "catd"):
        assert torch.equal(cont.forest[k], full.forest[k]), k
    torch.testing.assert_close(cont.forest["thr"], full.forest["thr"],
                               rtol=0, atol=0)
    torch.testing.assert_close(cont.forest["val"], full.forest["val"],
                               rtol=0, atol=LEAF_TOL)
    torch.testing.assert_close(_p1(cont), _p1(full), rtol=0, atol=LEAF_TOL)


@pytest.mark.parametrize("change,match", [
    (dict(ntrees=3), "ntrees must exceed"),
    (dict(ntrees=6, max_depth=4), "max_depth differs"),
    (dict(ntrees=6, nbins=30), "nbins differs"),
])
def test_checkpoint_compatibility_checks(change, match):
    m = GBM(_cont_params(ntrees=3)).train_model()
    with pytest.raises(ValueError, match=match):
        GBM(_cont_params(checkpoint=m, **change)).train_model()


def test_checkpointed_model_saves_without_the_prior(tmp_path):
    m = GBM(_cont_params(ntrees=3)).train_model()
    cont = GBM(_cont_params(ntrees=6, checkpoint=m)).train_model()
    assert cont.params.checkpoint == m.key
    m2 = load_model(cont.save(str(tmp_path / "cont.bin")), device="cpu")
    assert m2.ntrees == 6 and torch.equal(_p1(m2), _p1(cont))


def test_in_training_checkpoint_exports(tmp_path):
    d = str(tmp_path / "cps")
    m = GBM(_cont_params(ntrees=6, score_tree_interval=2,
                         export_checkpoints_dir=d)).train_model()
    snaps = sorted(os.listdir(d))
    assert snaps == ["gbm_00002.bin", "gbm_00004.bin", "gbm_00006.bin"]
    for i, name in enumerate(snaps):
        snap = load_model(os.path.join(d, name), device="cpu")
        assert snap.ntrees == 2 * (i + 1)
        assert snap.predict(_frame()).nrow == _N
    assert torch.equal(_p1(snap), _p1(m))


def test_drf_continuation_falls_back_to_in_bag_metrics():
    p = dict(training_frame=_frame(), response_column="y", max_depth=4,
             seed=1)
    base = DRF(DRFParameters(ntrees=4, **p)).train_model()
    assert base.output.training_metrics.description == "Reported on OOB data"
    cont = DRF(DRFParameters(ntrees=6, checkpoint=base, **p)).train_model()
    assert getattr(cont.output.training_metrics, "description", "") != \
        "Reported on OOB data"
    assert cont.ntrees == 6


# ---------------------------------------------------------------------------
# against the reference's continuations
# ---------------------------------------------------------------------------
_REF_KW = dict(max_depth=3, seed=11, score_tree_interval=2)
_DART_KW = dict(booster="dart", rate_drop=0.3, learn_rate=0.1, nbins=20,
                min_rows=10.0, reg_lambda=0.0)


def _dart_drops(ntrees, n_prior, seed, rate_drop):
    """The reference's DART draws of a continuation: a fresh
    ``default_rng(seed)`` from round ``n_prior`` on."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_prior, ntrees):
        d = []
        if t > 0 and rng.random() >= 0.0:
            d = [i for i in range(t) if rng.random() < rate_drop]
        out.append(d)
    return out


@pytest.fixture(scope="module")
def continuations():
    """The same 4 -> 10-tree GBM continuation and 4 -> 8-tree DART
    continuation (from the GBM prior) in both packages."""
    cols = {"x1": _COLS["x1"], "x2": _COLS["x2"]}
    one, jfr, fr = frames(cols, _Y, ydom=["0", "1"])
    kw = dict(response_column="y", **_REF_KW)
    with meshmod.use_mesh(one):
        jprior = JGBM(JGBMParameters(training_frame=jfr, ntrees=4, **kw)
                      ).train_model()
        jcont = JGBM(JGBMParameters(training_frame=jfr, ntrees=10,
                                    checkpoint=jprior, **kw)).train_model()
        jdart = JXGBoost(JXGBoostParameters(
            training_frame=jfr, ntrees=8, checkpoint=jprior, **_DART_KW,
            **kw)).train_model()
        jp = {"gbm": np.asarray(jcont.predict(jfr).vec(2).data)[:_N],
              "dart": np.asarray(jdart.predict(jfr).vec(2).data)[:_N]}
    prior = GBM(GBMParameters(training_frame=fr, ntrees=4, **kw)
                ).train_model()
    cont = GBM(GBMParameters(training_frame=fr, ntrees=10, checkpoint=prior,
                             **kw)).train_model()
    dart = XGBoost(XGBoostParameters(training_frame=fr, ntrees=8,
                                     checkpoint=prior, **_DART_KW, **kw)
                   ).train_model()
    tp = {"gbm": cont.predict(fr).vec(2).data[:_N].numpy(),
          "dart": dart.predict(fr).vec(2).data[:_N].numpy()}
    return {"gbm": (jcont, cont), "dart": (jdart, dart)}, jp, tp


@pytest.mark.parametrize("kind", ["gbm", "dart"])
def test_continuation_matches_the_reference(continuations, kind):
    models, jp, tp = continuations
    jm, tm = models[kind]
    assert tm.ntrees == jm.ntrees
    assert_forest_equal(jm, tm, val_atol=LEAF_TOL)
    np.testing.assert_allclose(tp[kind], jp[kind], rtol=0, atol=LEAF_TOL)
    if kind == "dart":
        assert tm.dropped_trees == _dart_drops(8, 4, 11, 0.3)
        assert any(tm.dropped_trees)
