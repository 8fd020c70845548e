"""Persistence (``h2o_tpu/backend/persist.py``): frame save/load, binary
model export/import, atomic writes and the auto-recovery directories.

- Frames (`water/fvec/persist/FramePersist.java`): one ``.npz`` of the
  columns plus a JSON sidecar of names, types and domains — the
  reference's format, so a frame saved by either package loads in the
  other bit for bit (numeric columns as their logical values, the exact
  int64/float64 copy where float32 loses one; string columns as text with
  a NA mask).
- Models (`hex/Model.java` exportBinaryModel): the port's own pickle. Each
  torch tensor is written as its numpy copy through a persistent id, and
  every Frame the model refers to is stripped (the training data is
  cluster state, not model state, as in H2O-3). Loading goes through an
  allowlisted unpickler — numpy, the port's own classes, plain builtins —
  and puts the tensors back on ``device`` (default ``cuda``).
- ``atomic_write_bytes``: temp write, fsync, rename; the
  ``persist.checkpoint`` failpoint sits between the temp write and the
  rename.
- ``Recovery`` (`hex/faulttolerance/Recovery.java`) and
  ``TrainingRecovery``: periodic atomic checkpoints of a running training
  job, resumed bit-equal by ``model_base.resume_training``.

The reference's shard-aware state split (``_split_state_shards``: one
state file per device of a multi-chip mesh) waits for the port's
multi-card training (ROADMAP Queue 1 item 1); the port's state is one
file.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
import os
import pickle
import time

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from ..utils import failpoints, knobs
from ..utils.log import warn


# ---------------------------------------------------------------------------
# frames (`water/fvec/persist/FramePersist.java`)
# ---------------------------------------------------------------------------
def save_frame(fr, path: str) -> str:
    """Write a Frame to ``path`` (.npz + .json sidecar). Returns the .npz
    path."""
    base = path[:-4] if path.endswith(".npz") else path
    arrays, meta = {}, {"names": fr.names, "nrow": fr.nrow, "cols": []}
    for i, name in enumerate(fr.names):
        v = fr.vec(name)
        meta["cols"].append({"name": name, "type": v.type,
                             "domain": v.domain})
        if v.host_data is not None:
            arrays[f"c{i}"] = np.asarray(
                ["" if x is None else str(x) for x in v.host_data])
            arrays[f"c{i}_na"] = np.asarray(
                [x is None for x in v.host_data], dtype=bool)
        else:
            arrays[f"c{i}"] = v.to_numpy()
    np.savez_compressed(base + ".npz", **arrays)
    with open(base + ".json", "w") as f:
        json.dump(meta, f)
    return base + ".npz"


def load_frame(path: str, key: str | None = None, device=None):
    """Read a frame ``save_frame`` wrote (either package's) onto
    ``device`` (default ``cuda``) and register it in the store."""
    from ..frame.frame import Frame
    from ..frame.vec import T_STR, T_UUID, Vec
    from .kvstore import STORE

    dev = resolve_device(device)
    base = path[:-4] if path.endswith(".npz") else path
    with open(base + ".json") as f:
        meta = json.load(f)
    vecs = []
    with np.load(base + ".npz", allow_pickle=False) as data:
        for i, cmeta in enumerate(meta["cols"]):
            arr = data[f"c{i}"]
            if cmeta["type"] in (T_STR, T_UUID):
                na = data[f"c{i}_na"]
                host = np.asarray([None if na[j] else str(x)
                                   for j, x in enumerate(arr)], dtype=object)
                vecs.append(Vec(None, meta["nrow"], type=cmeta["type"],
                                host_data=host))
            else:
                vecs.append(Vec.from_numpy(arr, type=cmeta["type"],
                                           domain=cmeta["domain"],
                                           device=dev))
    fr = Frame(meta["names"], vecs, key=key)
    STORE.put_keyed(fr)
    return fr


# ---------------------------------------------------------------------------
# models (binary export/import)
# ---------------------------------------------------------------------------
class _HostPickler(pickle.Pickler):
    """Tensors travel as numpy copies, Frames as nothing."""

    def persistent_id(self, obj):
        from ..frame.frame import Frame

        if isinstance(obj, torch.Tensor):
            return ("tensor", obj.detach().cpu().numpy())
        if isinstance(obj, Frame):
            return ("frame", obj.key)
        return None


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


#: builtins a model pickle may reference — everything outside this list,
#: numpy, ``collections``, ``datetime`` and the port's own classes fails
#: to load: a crafted file cannot reach os/subprocess/eval through
#: ``__reduce__``
_SAFE_BUILTINS = frozenset({
    "object", "dict", "list", "tuple", "set", "frozenset", "bytearray",
    "complex", "range", "slice", "bool", "int", "float", "str", "bytes",
    "NoneType",
})
#: port modules whose classes act on the file system or threads when built
_UNSAFE_PORT_MODULES = frozenset({"h2o_tpu_torch.backend.persist",
                                  "h2o_tpu_torch.backend.jobs"})


class _ModelUnpickler(pickle.Unpickler):
    def __init__(self, file, device):
        super().__init__(file)
        self.device = device

    def find_class(self, module, name):
        root = module.split(".", 1)[0]
        if root in ("numpy", "collections", "datetime"):
            return super().find_class(module, name)
        if root == "h2o_tpu_torch" and module not in _UNSAFE_PORT_MODULES:
            obj = super().find_class(module, name)
            if isinstance(obj, type):
                return obj
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"model file references {module}.{name}, which is outside the "
            "model-state allowlist — refusing to load")

    def persistent_load(self, pid):
        kind, payload = pid
        if kind == "tensor":
            return torch.from_numpy(np.array(payload)).to(self.device)
        if kind == "frame":
            return None
        raise pickle.UnpicklingError(f"unknown persistent id {kind!r}")


def _loads(fh, device):
    return _ModelUnpickler(fh, resolve_device(device)).load()


def _model_payload(model) -> dict:
    state = dict(model.__dict__)
    params = state.get("params")
    if params is not None:
        from ..frame.frame import Frame

        reps = {f.name: getattr(params, f.name).key
                for f in dataclasses.fields(params)
                if isinstance(getattr(params, f.name), Frame)}
        state["params"] = dataclasses.replace(params,
                                              **{k: None for k in reps})
        state["__frame_keys__"] = reps
    return {"class_module": type(model).__module__,
            "class_name": type(model).__name__, "state": state}


def model_bytes(model) -> bytes:
    """The binary model export as bytes."""
    return _dumps(_model_payload(model))


def save_model(model, path: str) -> str:
    """Binary model export; Frames are stripped (params keep their keys
    under ``__frame_keys__``)."""
    if path.startswith("file://"):
        path = path[len("file://"):]
    if "://" in path:
        raise NotImplementedError("remote model destinations are not "
                                  "ported yet (ROADMAP Queue 1 item 13)")
    data = model_bytes(model)
    with open(path, "wb") as f:
        f.write(data)
    return path


def load_model(path: str, device=None):
    """Binary model import onto ``device`` (default ``cuda``); the model is
    registered back into the store under its key."""
    from .kvstore import STORE

    with open(path, "rb") as f:
        payload = _loads(f, device)
    if payload["class_module"].split(".", 1)[0] != "h2o_tpu_torch":
        raise ValueError("model class must live in h2o_tpu_torch")
    cls = getattr(importlib.import_module(payload["class_module"]),
                  payload["class_name"])
    model = object.__new__(cls)
    state = payload["state"]
    state.pop("__frame_keys__", None)
    model.__dict__.update(state)
    STORE.put_keyed(model)
    return model


# ---------------------------------------------------------------------------
# atomic writes (the checkpoint layer's durability primitive)
# ---------------------------------------------------------------------------
def _fsync_dir(path: str) -> None:
    """Make a rename durable (POSIX: only a directory fsync survives power
    loss). Best effort where a directory cannot be opened."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes,
                       failpoint: str = "persist.checkpoint") -> None:
    """Temp write + fsync + rename: a reader (or a resuming process) sees
    the complete previous content or the complete new content, never a
    torn write. The failpoint sits between the durable temp write and the
    rename, the window a preemption would hit."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    failpoints.hit(failpoint)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def _replace_durable(tmp: str, path: str) -> None:
    """Atomically promote a temp file another API wrote (fsync + rename +
    directory fsync)."""
    with open(tmp, "rb+") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


# ---------------------------------------------------------------------------
# auto-recovery dir (`hex/faulttolerance/Recovery.java`)
# ---------------------------------------------------------------------------
class Recovery:
    """A recovery directory and its JSON manifest, written atomically."""

    MANIFEST = "recovery.json"

    def __init__(self, dir: str):
        self.dir = dir
        os.makedirs(dir, exist_ok=True)

    def _manifest_path(self) -> str:
        return os.path.join(self.dir, self.MANIFEST)

    def read(self) -> dict | None:
        if not os.path.exists(self._manifest_path()):
            return None
        with open(self._manifest_path()) as f:
            return json.load(f)

    def write(self, manifest: dict) -> None:
        atomic_write_bytes(self._manifest_path(),
                           json.dumps(manifest).encode())


class TrainingRecovery:
    """Periodic atomic checkpoints of a running training job, so a
    preemption, OOM or kill loses at most one interval instead of the
    whole forest.

    Layout under ``dir`` (every write atomic, so a kill at any instant
    leaves a resumable directory):

    - ``recovery.json``     — manifest: builder class, frame and model
      fields, progress, ``completed`` (set last, on success)
    - ``params.pkl``        — the builder's Parameters, Frames stripped
    - ``frame_<field>.npz`` — every Frame the params referenced
    - ``model_<field>.bin`` — a checkpoint prior, so a fresh process can
      resume a continuation
    - ``train_state.pkl``   — the builder's iteration state, tensors as
      numpy copies: restoring it and replaying the remaining iterations is
      bit-equal to the uninterrupted run, because the random streams are
      indexed by global iteration, not by process history

    ``interval_s`` (default: the ``H2O_TORCH_CHECKPOINT_SECS`` knob) is a
    wall-clock floor between state writes; 0 writes at every boundary.
    ``writes`` and ``write_s`` count the state writes and their seconds."""

    STATE = "train_state.pkl"
    PARAMS = "params.pkl"

    def __init__(self, dir: str, interval_s: float | None = None):
        self.rec = Recovery(dir)
        self.dir = dir
        self.interval_s = (knobs.get_int("H2O_TORCH_CHECKPOINT_SECS")
                           if interval_s is None else float(interval_s))
        self.writes = 0
        self.write_s = 0.0
        self._last_write = 0.0

    def init_for(self, builder) -> bool:
        """Persist the builder's identity, params, frames and prior model.
        False (recovery disarmed) when the params cannot be pickled, e.g.
        an in-process callable: a job never dies for its insurance."""
        from ..frame.frame import Frame
        from ..models.model_base import Model

        p = builder.params
        frame_fields, model_fields, stripped = [], [], {}
        for f in dataclasses.fields(p):
            v = getattr(p, f.name)
            if isinstance(v, Frame):
                frame_fields.append(f.name)
                stripped[f.name] = None
            elif isinstance(v, Model):
                # saved into the dir: a fresh process has no store to
                # resolve a bare key against
                model_fields.append(f.name)
                stripped[f.name] = v.key
        try:
            params_bytes = _dumps(dataclasses.replace(p, **stripped))
        except Exception as e:  # noqa: BLE001 — degrade, don't kill the job
            warn(f"auto-recovery disabled: params not picklable ({e!r})")
            return False
        for fname in frame_fields:
            # always overwrite (a reused dir must never resume a new job on
            # an old job's frame), atomically: a re-init under a live
            # manifest must not leave a torn .npz behind it
            final = os.path.join(self.dir, f"frame_{fname}.npz")
            tmp = os.path.join(self.dir, f"frame_{fname}.tmp.npz")
            save_frame(getattr(p, fname), tmp)
            _replace_durable(tmp, final)
            _replace_durable(tmp[:-4] + ".json", final[:-4] + ".json")
        try:
            for fname in model_fields:
                final = os.path.join(self.dir, f"model_{fname}.bin")
                save_model(getattr(p, fname), final + ".tmp")
                _replace_durable(final + ".tmp", final)
        except Exception as e:  # noqa: BLE001 — degrade, don't kill the job
            warn(f"auto-recovery disabled: prior model not savable ({e!r})")
            return False
        atomic_write_bytes(os.path.join(self.dir, self.PARAMS), params_bytes)
        manifest = self.rec.read() or {}
        manifest.update({
            "kind": "training",
            "builder_module": type(builder).__module__,
            "builder_name": type(builder).__name__,
            "algo": builder.algo_name,
            "frame_fields": frame_fields,
            "model_fields": model_fields,
            "params_path": self.PARAMS,
            "state_path": None,
            "completed": False,
            "checkpoints": 0,
            "started": time.time(),
        })
        self.rec.write(manifest)
        self._last_write = time.monotonic()
        return True

    def due(self) -> bool:
        return (time.monotonic() - self._last_write) >= self.interval_s

    def save_state(self, state: dict, progress: dict | None = None) -> None:
        """Write the iteration state, then the manifest: a kill between the
        two leaves the previous manifest pointing at the previous complete
        state, never at a missing one."""
        t0 = time.monotonic()
        manifest = self.rec.read() or {}
        atomic_write_bytes(os.path.join(self.dir, self.STATE),
                           _dumps(state))
        manifest["state_path"] = self.STATE
        manifest["checkpoints"] = int(manifest.get("checkpoints", 0)) + 1
        if progress:
            manifest["progress"] = progress
        self.rec.write(manifest)
        self.writes += 1
        self.write_s += time.monotonic() - t0
        self._last_write = time.monotonic()
        failpoints.hit("train.checkpoint")

    def mark_completed(self, model_key: str | None = None) -> None:
        manifest = self.rec.read() or {}
        manifest["completed"] = True
        if model_key:
            manifest["model_key"] = model_key
        self.rec.write(manifest)

    @staticmethod
    def load(dir: str, device=None):
        """(builder class, params with frames, state or None, manifest)
        from a recovery dir, frames and tensors on ``device`` (default
        ``cuda``). The params and state load through the allowlisted
        unpickler."""
        rec = Recovery(dir)
        manifest = rec.read()
        if manifest is None or manifest.get("kind") != "training":
            raise ValueError(f"no training recovery manifest in {dir}")
        if manifest["builder_module"].split(".", 1)[0] != "h2o_tpu_torch":
            raise ValueError("builder class must live in h2o_tpu_torch")
        builder_cls = getattr(
            importlib.import_module(manifest["builder_module"]),
            manifest["builder_name"])
        with open(os.path.join(dir, manifest["params_path"]), "rb") as fh:
            params = _loads(fh, device)
        updates = {}
        for fname in manifest.get("frame_fields", []):
            updates[fname] = load_frame(
                os.path.join(dir, f"frame_{fname}.npz"), device=device)
        for fname in manifest.get("model_fields", []):
            # load_model registers the prior under its key, so a key-based
            # checkpoint resolves in a fresh process
            updates[fname] = load_model(
                os.path.join(dir, f"model_{fname}.bin"), device=device)
        params = dataclasses.replace(params, **updates)
        state = None
        if manifest.get("state_path"):
            with open(os.path.join(dir, manifest["state_path"]), "rb") as fh:
                state = _loads(fh, device)
        return builder_cls, params, state, manifest
