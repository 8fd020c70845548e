"""Port parity and contracts: the K/V store, jobs, failpoints and
persistence of ``h2o_tpu_torch`` (``backend/kvstore.py``,
``backend/jobs.py``, ``utils/failpoints.py``, ``backend/persist.py``).

- Frames cross-load: a frame ``save_frame`` writes in either package
  loads in the other with equal names, types and domains, every device
  column bit for bit (the float32 column and the exact int64 copy), and
  string columns' values with ``None`` kept.
- A saved port model scores bit-identically after ``load_model``, in this
  process and in a fresh one, with its frames stripped and its tensors on
  the device asked for.
- The K/V store's put/get/remove/CAS/listing and ``leak_check``; models,
  compressed and loaded frames register under their keys, CV outputs
  under the reference's ``make_key`` names.
- ``Job``: a background build joins to its model; a stop request cancels
  at the next boundary; ``max_runtime_secs`` keeps the first chunk's
  partial model; a bounded join raises ``JobTimeoutError``; a failure
  re-raises; a preempt request parks an armed job ``PREEMPTED``.
- The failpoint grammar cases of ``tests/test_failpoints.py:30-100``.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from h2o_tpu.backend import persist as jpersist
from h2o_tpu.frame.frame import Frame as JFrame
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch import (GBM, GLM, STORE, Frame, GBMParameters,
                           GLMParameters, compress_frame, load_frame,
                           load_model, save_frame)
from h2o_tpu_torch.backend.jobs import (Job, JobCancelled, JobPreempted,
                                        JobTimeoutError)
from h2o_tpu_torch.backend.kvstore import KVStore, leak_check, make_key
from h2o_tpu_torch.frame.vec import T_CAT, T_STR, Vec
from h2o_tpu_torch.utils import failpoints as fp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_failpoints(monkeypatch):
    monkeypatch.delenv("H2O_TORCH_FAILPOINTS", raising=False)
    fp.reset()
    yield
    fp.reset()


def _columns(n=40):
    rng = np.random.default_rng(1)
    num = rng.normal(size=n).astype(np.float32)
    num[::7] = np.nan
    cat = (np.arange(n) % 3).astype(np.float32)
    cat[5] = np.nan
    ids = (np.int64(1) << 40) + np.arange(n, dtype=np.int64) * 3
    text = np.asarray([f"t{i}" for i in range(n - 1)] + [None], dtype=object)
    return num, cat, ids, text


def _port_frame():
    num, cat, ids, text = _columns()
    fr = Frame.from_dict({"num": num, "ids": ids}, device="cpu")
    fr.add("cat", Vec.from_numpy(cat, type=T_CAT, domain=["a", "b", "c"],
                                 device="cpu"))
    fr.add("s", Vec(None, len(num), type=T_STR, host_data=text))
    return fr


def _ref_frame():
    num, cat, ids, text = _columns()
    one = meshmod.make_mesh(jax.devices()[:1])
    fr = JFrame.from_dict({"num": num, "ids": ids}, mesh=one)
    fr.add("cat", JVec.from_numpy(cat, type="enum", domain=["a", "b", "c"],
                                  mesh=one))
    fr.add("s", JVec(None, len(num), type="string", host_data=text))
    return fr


def _assert_same_frame(jf, tf):
    assert tf.names == jf.names and tf.nrow == jf.nrow
    for n in jf.names:
        jv, tv = jf.vec(n), tf.vec(n)
        assert (tv.type, tv.domain) == (jv.type, jv.domain), n
        if jv.type == "string":
            assert list(tv.host_data) == list(jv.host_data), n
            continue
        ja, ta = np.asarray(jv.to_numpy()), tv.to_numpy()
        assert ta.dtype == ja.dtype and ta.tobytes() == ja.tobytes(), n
        jd = np.asarray(jv.data)[:jv.nrow]
        assert tv.data[:tv.nrow].numpy().tobytes() == jd.tobytes(), n


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_frames_cross_load_bit_equal(tmp_path, writer):
    path = str(tmp_path / "fr")
    jf, tf = _ref_frame(), _port_frame()
    if writer == "reference":
        p = jpersist.save_frame(jf, path)
        _assert_same_frame(jf, load_frame(p, device="cpu"))
    else:
        p = save_frame(tf, path)
        with meshmod.use_mesh(meshmod.make_mesh(jax.devices()[:1])):
            _assert_same_frame(jpersist.load_frame(p), tf)
    # and the writer's own package reads it back unchanged
    _assert_same_frame(jf, load_frame(p, device="cpu"))


def _gbm_frame(n=400, seed=0):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n).astype(np.float32)
    x2 = rng.normal(size=n).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(2 * x1 - x2)))).astype(np.float32)
    fr = Frame.from_dict({"x1": x1, "x2": x2}, device="cpu")
    fr.add("y", Vec.from_numpy(y, type=T_CAT, domain=["no", "yes"],
                               device="cpu"))
    return fr


@pytest.mark.parametrize("algo", ["gbm", "glm"])
def test_model_round_trip_scores_identically(tmp_path, algo):
    fr = _gbm_frame()
    if algo == "gbm":
        m = GBM(GBMParameters(training_frame=fr, response_column="y",
                              ntrees=5, max_depth=3, seed=7)).train_model()
    else:
        m = GLM(GLMParameters(training_frame=fr, response_column="y",
                              family="binomial")).train_model()
    before = m.predict(fr).vec(2).data
    path = m.save(str(tmp_path / f"{algo}.bin"))
    STORE.remove(m.key)
    m2 = load_model(path, device="cpu")
    assert STORE.get(m.key) is m2 and type(m2) is type(m)
    assert m2.params.training_frame is None      # frames are stripped
    assert torch.equal(m2.predict(fr).vec(2).data, before)


def test_saved_model_scores_identically_in_a_fresh_process(tmp_path):
    fr = _gbm_frame()
    m = GBM(GBMParameters(training_frame=fr, response_column="y", ntrees=4,
                          max_depth=3, seed=3)).train_model()
    m.save(str(tmp_path / "m.bin"))
    save_frame(fr, str(tmp_path / "fr"))
    code = ("import sys, numpy as np; sys.path.insert(0, sys.argv[1]); "
            "from h2o_tpu_torch import load_frame, load_model; "
            "m = load_model(sys.argv[2] + '/m.bin', device='cpu'); "
            "fr = load_frame(sys.argv[2] + '/fr.npz', device='cpu'); "
            "np.save(sys.argv[2] + '/p.npy', m.predict(fr).vec(2).data"
            ".numpy())")
    r = subprocess.run([sys.executable, "-c", code, REPO, str(tmp_path)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    got = np.load(str(tmp_path / "p.npy"))
    assert got.tobytes() == m.predict(fr).vec(2).data.numpy().tobytes()


def test_model_unpickler_refuses_foreign_callables(tmp_path):
    import pickle

    class Evil:
        def __reduce__(self):
            return (os.system, ("echo pwned",))

    path = str(tmp_path / "evil.bin")
    with open(path, "wb") as f:
        pickle.dump({"class_module": "h2o_tpu_torch.models.gbm",
                     "class_name": "GBMModel", "state": Evil()}, f)
    with pytest.raises(pickle.UnpicklingError):
        load_model(path, device="cpu")


def test_kv_store_and_leak_check():
    st = KVStore()
    st.put("a", 1)
    assert st.get("a") == 1 and "a" in st and st.keys() == ["a"]
    assert st.put_if_match("a", 2, expected=3) == 1
    assert st.put_if_match("a", 2, expected=1) == 2
    assert st.remove("a") == 2 and st.get("a") is None
    with leak_check(st, expect=["kept"]):
        st.put("kept", 0)
        st.put("tmp", 0)
        st.remove("tmp")
    with pytest.raises(AssertionError, match="leaked keys"):
        with leak_check(st):
            st.put("stray", 0)
    k1, k2 = make_key("x"), make_key("x")
    assert k1 != k2 and k1.startswith("x_")


def test_models_and_frames_register_under_their_keys(tmp_path):
    fr = _gbm_frame()
    with leak_check(expect=lambda: keys):
        m = GBM(GBMParameters(training_frame=fr, response_column="y",
                              ntrees=2, max_depth=2, seed=1, nfolds=2,
                              keep_cross_validation_predictions=True,
                              keep_cross_validation_fold_assignment=True)
                ).train_model()
        c = compress_frame(fr)
        lf = load_frame(save_frame(fr, str(tmp_path / "f")), device="cpu")
        out = m.output
        keys = ([m.key, c.key, lf.key, out.cv_holdout_predictions.key,
                 out.cv_fold_assignment.key]
                + [f.key for f in out.cv_fold_predictions]
                + [cv.key for cv in out.cv_models]
                + [j for j in STORE.keys(Job)])
    assert STORE.get(m.key) is m and STORE.get(c.key) is c
    assert m.key.startswith("gbm_model_")
    assert out.cv_holdout_predictions.key.startswith("cv_holdout_prediction_")
    assert [f.key.split("_")[:2] for f in out.cv_fold_predictions] == \
        [["cv", "1"], ["cv", "2"]]
    assert out.cv_fold_assignment.key.startswith("cv_fold_assignment_")
    STORE.remove(m.key)
    assert all(STORE.get(cv.key) is None for cv in out.cv_models)


def _gbm_params(**kw):
    base = dict(training_frame=_gbm_frame(), response_column="y", ntrees=4,
                max_depth=3, seed=5, score_tree_interval=1)
    base.update(kw)
    return GBMParameters(**base)


def test_background_job_joins_to_its_model():
    job = GBM(_gbm_params()).train()
    m = job.join(timeout=60)
    assert job.status == Job.DONE and job.progress == 1.0
    assert job.dest_key == m.key and m.ntrees == 4
    ref = GBM(_gbm_params()).train_model()
    assert all(torch.equal(m.forest[k], ref.forest[k]) for k in m.forest)


def test_stop_request_cancels_at_the_next_boundary():
    fp.arm("train.gbm.chunk", "sleep(300)*1")
    job = GBM(_gbm_params()).train()
    job.stop()
    assert job.join(timeout=60) is None
    assert job.status == Job.CANCELLED


def test_max_runtime_keeps_the_first_chunk():
    m = GBM(_gbm_params(max_runtime_secs=1e-9)).train_model()
    assert m.ntrees == 1


def test_typed_job_errors():
    gate = threading.Event()
    job = Job("waits").start(lambda: gate.wait(30))
    with pytest.raises(JobTimeoutError) as ei:
        job.join(timeout=0.05)
    assert ei.value.budget_s == 0.05 and ei.value.elapsed_s >= 0
    gate.set()
    assert job.join(timeout=30) is True and job.status == Job.DONE
    budget = Job("budget")
    budget.set_max_runtime(1e-9)
    time.sleep(0.01)
    assert budget.time_exceeded()
    with pytest.raises(JobTimeoutError):
        budget.check_max_runtime()

    def boom():
        raise KeyError("bad")

    failed = Job("fails").start(boom)
    with pytest.raises(KeyError):
        failed.join(timeout=30)
    assert failed.status == Job.FAILED and "KeyError" in failed.traceback

    def cancelled():
        raise JobCancelled("x")

    assert Job("c").start(cancelled, background=False).status == Job.CANCELLED

    def preempted():
        raise JobPreempted("p", "/some/dir")

    pj = Job("p").start(preempted, background=False)
    assert pj.status == Job.PREEMPTED and pj.preempt_dir == "/some/dir"


def test_preempt_request_parks_an_armed_job(tmp_path, monkeypatch):
    from h2o_tpu_torch import resume_training

    monkeypatch.setenv("H2O_TORCH_CHECKPOINT_SECS", "600")
    base = GBM(_gbm_params()).train_model()
    rdir = str(tmp_path / "rec")
    fp.arm("train.gbm.chunk", "sleep(300)*1")
    job = GBM(_gbm_params(auto_recovery_dir=rdir)).train()
    job.request_preempt()
    assert job.join(timeout=60) is None
    assert job.status == Job.PREEMPTED and job.preempt_dir == rdir
    m = resume_training(rdir, device="cpu")
    assert all(torch.equal(m.forest[k], base.forest[k]) for k in m.forest)


# ---------------------------------------------------------------------------
# failpoint grammar (`tests/test_failpoints.py:30-100`)
# ---------------------------------------------------------------------------
def test_bad_specs_raise_valueerror_at_arm_time():
    for spec in ("explode", "raise(nuclear)", "sleep", "sleep(abc)",
                 "http", "http(9999)", "raise*x", ""):
        with pytest.raises(ValueError):
            fp.arm("parser.parse", spec)


def test_unregistered_site_raises_keyerror_everywhere():
    site = "no." + "such.site"
    for fn in (lambda: fp.arm(site, "raise"), lambda: fp.hit(site),
               lambda: fp.is_armed(site)):
        with pytest.raises(KeyError):
            fn()
    assert sorted(fp.FAILPOINTS) == ["parser.parse", "persist.checkpoint",
                                     "train.checkpoint", "train.dl.epoch",
                                     "train.gbm.chunk", "workload.preempt"]
    assert all(decl.doc for decl in fp.FAILPOINTS.values())


def test_raise_every_first_n_and_kth_hit():
    fp.arm("parser.parse", "raise")
    for _ in range(3):
        with pytest.raises(fp.InjectedFault):
            fp.hit("parser.parse")
    assert fp.hits("parser.parse") == 3
    fp.arm("parser.parse", "raise*2")
    for i in (1, 2):
        with pytest.raises(fp.InjectedFault) as ei:
            fp.hit("parser.parse")
        assert ei.value.hit_no == i
    fp.hit("parser.parse")
    assert fp.hits("parser.parse") == 3
    fp.arm("parser.parse", "raise@3")
    fp.hit("parser.parse")
    fp.hit("parser.parse")
    with pytest.raises(fp.InjectedFault) as ei:
        fp.hit("parser.parse")
    assert ei.value.hit_no == 3
    fp.hit("parser.parse")


def test_kinds_map_to_typed_exceptions_and_sleep():
    fp.arm("persist.checkpoint", "raise(oom)")
    with pytest.raises(fp.InjectedOOM, match="RESOURCE_EXHAUSTED"):
        fp.hit("persist.checkpoint")
    fp.arm("train.gbm.chunk", "raise(preempt)")
    with pytest.raises(fp.InjectedPreemption):
        fp.hit("train.gbm.chunk")
    fp.arm("parser.parse", "raise(conn)")
    with pytest.raises(ConnectionResetError):
        fp.hit("parser.parse")
    fp.arm("train.checkpoint", "http(429)")
    with pytest.raises(fp.InjectedHTTPError) as ei:
        fp.hit("train.checkpoint")
    assert ei.value.status == 429 and ei.value.retry_after_s > 0
    fp.arm("workload.preempt", "sleep(40)")
    t0 = time.monotonic()
    fp.hit("workload.preempt")
    assert time.monotonic() - t0 >= 0.03


def test_env_arms_and_rearms_dynamically(monkeypatch, tmp_path):
    from h2o_tpu_torch import import_file

    path = tmp_path / "a.csv"
    path.write_text("a\n1\n")
    monkeypatch.setenv("H2O_TORCH_FAILPOINTS", "parser.parse:raise@2")
    import_file(str(path), device="cpu")
    with pytest.raises(fp.InjectedFault):
        import_file(str(path), device="cpu")
    assert fp.active() == {"parser.parse": "raise@2"}
    monkeypatch.setenv("H2O_TORCH_FAILPOINTS", "")
    import_file(str(path), device="cpu")
    assert not fp.is_armed("parser.parse")
