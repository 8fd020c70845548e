"""Job tracking (``h2o_tpu/backend/jobs.py``, `water/Job.java`).

A Job wraps a worker thread; progress is a float in [0, 1] the running
builder updates, and a stop request is cooperative: builders poll
``check_cancelled`` between iterations (`Job.stop_requested()` in H2O-3).
``max_runtime_secs`` arms a deadline the builders poll with
``time_exceeded`` to keep a partial model; ``request_preempt`` asks the
builder to checkpoint and unwind at its next boundary (``JobPreempted``).

A background job on a CUDA frame makes that frame's card the current
device of its worker thread before the build starts, since the current
CUDA device is per thread. The reference's workload manager, telemetry
and compile-cache hygiene are not ported (ROADMAP step L).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Callable

import torch

from .kvstore import STORE, Keyed


class JobCancelled(Exception):
    pass


class JobPreempted(Exception):
    """Cooperative chunk-boundary preemption: the training loop saw a
    preempt request at a safe boundary, force-checkpointed its state and
    unwound. The work is not lost — ``recovery_dir`` names the checkpoint
    ``resume_training`` replays to a bit-equal model."""

    def __init__(self, job_key: str, recovery_dir: str | None):
        self.recovery_dir = recovery_dir
        super().__init__(
            f"{job_key} preempted at a chunk boundary"
            + (f" (state parked in {recovery_dir})" if recovery_dir else ""))


class JobTimeoutError(Exception):
    """Typed wall-clock expiry: ``Job.join(timeout=...)`` when the wait
    runs out, ``Job.check_max_runtime()`` when ``max_runtime_secs`` expires
    before a builder has a partial result to keep. ``elapsed_s`` spent
    against ``budget_s`` allowed."""

    def __init__(self, what: str, elapsed_s: float, budget_s: float):
        self.elapsed_s = elapsed_s
        self.budget_s = budget_s
        super().__init__(
            f"{what}: {elapsed_s:.1f}s elapsed of a {budget_s:.1f}s budget")


class Job(Keyed):
    CREATED = "CREATED"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"
    PREEMPTED = "PREEMPTED"

    def __init__(self, description: str = "", work: float = 1.0,
                 dest_key: str | None = None):
        super().__init__(prefix="job")
        self.description = description
        self.dest_key = dest_key
        # status, result, exception and progress are written by the worker
        # thread and read by pollers: one lock makes each transition atomic
        self._lock = threading.Lock()
        self.status = Job.CREATED
        self.exception: BaseException | None = None
        self.traceback: str | None = None
        self._work_total = max(work, 1e-12)
        self._worked = 0.0
        self.progress_msg = ""
        self.start_time = 0.0
        self.end_time = 0.0
        self._stop_requested = False
        self._thread: threading.Thread | None = None
        self.result: Any = None
        self._preempt_requested = False
        #: the checkpoint dir a preemption parked its state in
        self.preempt_dir: str | None = None
        self.deadline: float | None = None       # max_runtime_secs expiry
        self.max_runtime_s: float | None = None
        STORE.put_keyed(self)

    # -- lifecycle -----------------------------------------------------------
    def start(self, fn: Callable[[], Any], background: bool = True,
              device=None) -> "Job":
        """Run ``fn`` on a worker thread (or inline). ``device``: the card
        the work runs on, made the worker thread's current CUDA device."""
        def _run():
            with self._lock:
                self.status = Job.RUNNING
                self.start_time = time.time()
            try:
                dev = None if device is None else torch.device(device)
                if background and dev is not None and dev.type == "cuda":
                    torch.cuda.set_device(dev)
                result = fn()
                with self._lock:
                    self.result = result
                    self.status = (Job.CANCELLED if self._stop_requested
                                   else Job.DONE)
            except JobCancelled:
                with self._lock:
                    self.status = Job.CANCELLED
            except JobPreempted as e:
                with self._lock:
                    self.preempt_dir = e.recovery_dir
                    self.status = Job.PREEMPTED
            except BaseException as e:  # noqa: BLE001 — surfaced by join
                with self._lock:
                    self.exception = e
                    self.traceback = traceback.format_exc()
                    self.status = Job.FAILED
            finally:
                with self._lock:
                    self.end_time = time.time()

        if background:
            self._thread = threading.Thread(target=_run, daemon=True,
                                            name=self.key)
            self._thread.start()
        else:
            _run()
        return self

    def join(self, timeout: float | None = None) -> Any:
        """Wait for the job; re-raise its failure. A bounded wait that runs
        out raises ``JobTimeoutError`` (the job keeps running)."""
        if self._thread is not None:
            self._thread.join(timeout)
            if timeout is not None and self._thread.is_alive():
                with self._lock:
                    status = self.status
                raise JobTimeoutError(
                    f"join on {self.key} ({self.description!r}) timed out "
                    f"with the job still {status}",
                    elapsed_s=self.run_time, budget_s=timeout)
        with self._lock:
            status, exc, result = self.status, self.exception, self.result
        if status == Job.FAILED and exc is not None:
            raise exc
        return result

    # -- progress / cancel ---------------------------------------------------
    @property
    def progress(self) -> float:
        with self._lock:
            if self.status == Job.DONE:
                return 1.0
            return min(1.0, self._worked / self._work_total)

    def update(self, worked: float, msg: str = "") -> None:
        with self._lock:
            self._worked += worked
            if msg:
                self.progress_msg = msg

    def stop(self) -> None:
        """Request cooperative cancellation (`Job.stop_requested`)."""
        with self._lock:
            self._stop_requested = True

    @property
    def stop_requested(self) -> bool:
        with self._lock:
            return self._stop_requested

    def check_cancelled(self) -> None:
        """Builders call this between iterations; raises to unwind."""
        if self.stop_requested:
            raise JobCancelled(self.key)

    def set_max_runtime(self, secs: float) -> None:
        """Arm the per-model time budget (`max_runtime_secs`: training
        stops and keeps the partial model)."""
        if secs and secs > 0:
            self.max_runtime_s = float(secs)
            self.deadline = time.time() + secs

    def time_exceeded(self) -> bool:
        """Iterative builders poll this between iterations and break,
        keeping the partial model."""
        return self.deadline is not None and time.time() > self.deadline

    def check_max_runtime(self) -> None:
        """``JobTimeoutError`` once the budget expired — for call sites
        with no partial result to keep."""
        if self.time_exceeded():
            raise JobTimeoutError(
                f"job {self.key} ({self.description!r}) exceeded "
                f"max_runtime_secs before producing a keepable result",
                elapsed_s=self.run_time, budget_s=self.max_runtime_s or 0.0)

    # -- preemption ----------------------------------------------------------
    def request_preempt(self) -> None:
        """Ask the running builder to checkpoint and unwind at its next
        chunk boundary (``model_base._preempt_tick`` polls this). Ignored
        by a build without auto-recovery, which would lose its work."""
        with self._lock:
            self._preempt_requested = True

    @property
    def preempt_requested(self) -> bool:
        with self._lock:
            return self._preempt_requested

    def clear_preempt(self) -> None:
        with self._lock:
            self._preempt_requested = False

    @property
    def run_time(self) -> float:
        with self._lock:
            end = self.end_time or time.time()
            return end - self.start_time if self.start_time else 0.0
