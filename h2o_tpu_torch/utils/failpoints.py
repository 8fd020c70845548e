"""Deterministic fault injection — the failpoint registry
(``h2o_tpu/utils/failpoints.py``).

Named sites call :func:`hit`, a no-op until a spec arms the site, so every
failure the recovery layer handles can be driven on the CPU at an exact
iteration. Every site is declared here with a docstring, and the
accessors raise ``KeyError`` for an undeclared name. The port declares the
sites it has: ``parser.parse``, ``train.gbm.chunk``, ``train.checkpoint``,
``persist.checkpoint`` and ``workload.preempt``.

Activation — ``H2O_TORCH_FAILPOINTS=site:spec,site2:spec`` (re-read on
every hit, so tests can arm and disarm mid-process), or :func:`arm` and
:func:`reset`. Spec grammar::

    spec     := action [ "(" arg ")" ] [ "*" N | "@" K ]
    action   := "raise" | "sleep" | "http"
    raise    — raise an injected fault; arg picks the kind:
               fault (default) | oom | preempt | conn (ConnectionResetError)
    sleep    — inject latency; arg = milliseconds
    http     — raise InjectedHTTPError; arg = status code
    *N       — fire on the first N hits only (default: every hit)
    @K       — fire on exactly the K-th hit (1-based) — the kill-at-every-
               checkpoint-boundary driver

Example: ``train.gbm.chunk:raise(preempt)@3``.

Hit counters are per site and monotonic from the moment a site is armed
(``reset()`` zeroes them): two runs arming the same spec and hitting the
site in the same order inject identically.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
import time


# ---------------------------------------------------------------------------
# injected exception types
# ---------------------------------------------------------------------------
class InjectedFault(RuntimeError):
    """Base class of every failpoint-raised error; carries the site and the
    1-based hit number so tests can pin exactly which injection fired."""

    def __init__(self, site: str, hit_no: int, detail: str = ""):
        self.site = site
        self.hit_no = hit_no
        super().__init__(
            f"injected fault at failpoint '{site}' (hit {hit_no})"
            + (f": {detail}" if detail else ""))


class InjectedOOM(InjectedFault):
    """Shaped like a device OOM: the message carries the reference's
    RESOURCE_EXHAUSTED marker."""

    def __init__(self, site: str, hit_no: int):
        super().__init__(site, hit_no, "RESOURCE_EXHAUSTED: out of memory")


class InjectedPreemption(InjectedFault):
    """Simulated preemption / SIGTERM mid-train — the driver the
    kill-resume bit-parity tests use (a real kill is just this exception
    that nobody catches)."""


class InjectedHTTPError(InjectedFault):
    """REST-layer injection, kept for the grammar: ``http(status)``
    raises this with ``status`` and, for 429/503, ``retry_after_s``."""

    def __init__(self, site: str, hit_no: int, status: int,
                 retry_after_s: float = 0.05):
        self.status = int(status)
        self.retry_after_s = retry_after_s
        super().__init__(site, hit_no, f"HTTP {status}")


_KINDS = {
    "fault": InjectedFault,
    "oom": InjectedOOM,
    "preempt": InjectedPreemption,
}


# ---------------------------------------------------------------------------
# site registry (the knobs.py discipline)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Failpoint:
    name: str
    doc: str


FAILPOINTS: dict[str, Failpoint] = {}


def _failpoint(name: str, doc: str) -> None:
    FAILPOINTS[name] = Failpoint(name, doc)


_failpoint("parser.parse",
           "io/parser.py parse_file entry — a corrupt or unreadable ingest")
_failpoint("train.gbm.chunk",
           "models/gbm.py boosting chunk-loop top (GBM and DRF) — "
           "raise(preempt)@K kills the job before chunk K trains")
_failpoint("train.dl.epoch",
           "models/deeplearning.py epoch boundary — preemption mid-SGD")
_failpoint("train.checkpoint",
           "model_base auto-checkpoint, fires after each successful "
           "recovery-state write — kill exactly between checkpoints")
_failpoint("persist.checkpoint",
           "backend/persist.py atomic state write, between temp-write and "
           "rename — a crash here must leave the previous state intact")
_failpoint("workload.preempt",
           "the preemption poll at every training chunk boundary "
           "(model_base._recovery_tick) — raise@K preempts the job exactly "
           "before boundary K trains: state force-checkpointed, job parked "
           "PREEMPTED; resume_training replays to a bit-equal model")


# ---------------------------------------------------------------------------
# spec parsing / arming
# ---------------------------------------------------------------------------
_SPEC_RE = re.compile(
    r"^(?P<action>raise|sleep|http)"
    r"(?:\((?P<arg>[^)]*)\))?"
    r"(?:\*(?P<times>\d+)|@(?P<at>\d+))?$")


@dataclasses.dataclass
class _Armed:
    site: str
    action: str             # raise | sleep | http
    arg: str                # kind / ms / status
    times: int | None       # fire on first N hits
    at: int | None          # fire on exactly the K-th hit
    spec: str               # original text (repr / observability)
    count: int = 0          # hits seen since armed (armed or not fired)

    def should_fire(self, n: int) -> bool:
        if self.at is not None:
            return n == self.at
        if self.times is not None:
            return n <= self.times
        return True


def _parse_spec(site: str, spec: str) -> _Armed:
    m = _SPEC_RE.match(spec.strip())
    if not m:
        raise ValueError(
            f"bad failpoint spec {spec!r} for site '{site}' — grammar: "
            f"action[(arg)][*N|@K], action in raise|sleep|http "
            f"(h2o_tpu_torch/utils/failpoints.py)")
    action, arg = m.group("action"), (m.group("arg") or "").strip()
    if action == "raise":
        if arg and arg not in _KINDS and arg != "conn":
            raise ValueError(
                f"unknown raise kind {arg!r} for failpoint '{site}' — "
                f"one of {sorted(_KINDS) + ['conn']}")
    elif action == "sleep":
        if not arg or not arg.isdigit():
            raise ValueError(
                f"sleep spec for '{site}' needs integer milliseconds, "
                f"got {arg!r}")
    elif action == "http":
        if not arg.isdigit() or not 100 <= int(arg) <= 599:
            raise ValueError(
                f"http spec for '{site}' needs a status code, got {arg!r}")
    return _Armed(site=site, action=action, arg=arg,
                  times=int(m.group("times")) if m.group("times") else None,
                  at=int(m.group("at")) if m.group("at") else None,
                  spec=spec.strip())


def _lookup(name: str) -> Failpoint:
    try:
        return FAILPOINTS[name]
    except KeyError:
        raise KeyError(
            f"unregistered failpoint {name!r} — declare it in "
            f"h2o_tpu_torch/utils/failpoints.py") from None


_lock = threading.Lock()
_armed: dict[str, _Armed] = {}       # programmatic + env-derived, merged
_env_cache: str | None = None        # last-parsed H2O_TORCH_FAILPOINTS value
_env_sites: dict[str, _Armed] = {}   # the env-derived subset


def _sync_env() -> None:
    """Re-parse H2O_TORCH_FAILPOINTS when its value changed (reads are
    dynamic, like knobs — monkeypatching tests keep working). Counters of
    unchanged site:spec pairs survive the re-parse, so appending a second
    site mid-run never resets the first one's determinism."""
    global _env_cache
    raw = os.environ.get("H2O_TORCH_FAILPOINTS", "")
    if raw == _env_cache:
        return
    with _lock:
        if raw == _env_cache:
            return
        fresh: dict[str, _Armed] = {}
        for pair in filter(None, (p.strip() for p in raw.split(","))):
            site, _, spec = pair.partition(":")
            site = site.strip()
            _lookup(site)
            armed = _parse_spec(site, spec)
            prev = _env_sites.get(site)
            if prev is not None and prev.spec == armed.spec:
                armed.count = prev.count
            fresh[site] = armed
        for site in list(_armed):
            if site in _env_sites and _armed[site] is _env_sites[site]:
                del _armed[site]     # env-owned entry: env now rules again
        _env_sites.clear()
        _env_sites.update(fresh)
        for site, armed in fresh.items():
            _armed.setdefault(site, armed)
        _env_cache = raw


def arm(name: str, spec: str) -> None:
    """Programmatically arm a site (tests); overrides any env spec."""
    _lookup(name)
    armed = _parse_spec(name, spec)
    with _lock:
        _armed[name] = armed


def reset() -> None:
    """Disarm every site and zero every counter (test teardown)."""
    global _env_cache
    with _lock:
        _armed.clear()
        _env_sites.clear()
        _env_cache = None


def is_armed(name: str) -> bool:
    _lookup(name)
    _sync_env()
    return name in _armed


def hits(name: str) -> int:
    """Hits seen at an armed site since arming (0 when disarmed)."""
    _lookup(name)
    _sync_env()
    with _lock:
        a = _armed.get(name)
        return a.count if a else 0


def active() -> dict[str, str]:
    """{site: spec} of every armed site (observability / /3/Cloud debug)."""
    _sync_env()
    with _lock:
        return {k: v.spec for k, v in _armed.items()}


def hit(name: str) -> None:
    """The instrumented-site call. No-op (one env read + two dict lookups)
    unless the site is armed; armed sites count the hit, then inject per
    spec. Undeclared names raise KeyError whether or not anything is armed
    — same contract as the knobs accessors."""
    if name not in FAILPOINTS:
        _lookup(name)
    _sync_env()
    if not _armed:
        return
    with _lock:
        armed = _armed.get(name)
        if armed is None:
            return
        armed.count += 1
        n = armed.count
        fire = armed.should_fire(n)
    if not fire:
        return
    if armed.action == "sleep":
        time.sleep(int(armed.arg) / 1000.0)
        return
    if armed.action == "http":
        raise InjectedHTTPError(name, n, int(armed.arg))
    kind = armed.arg or "fault"
    if kind == "conn":
        raise ConnectionResetError(
            f"injected connection reset at failpoint '{name}' (hit {n})")
    raise _KINDS[kind](name, n)
