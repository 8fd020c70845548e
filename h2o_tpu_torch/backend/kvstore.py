"""Keyed object store — the control-plane analog of H2O's DKV
(``h2o_tpu/backend/kvstore.py``).

H2O-3 runs a distributed K/V store with home-node hashing, caching reads,
invalidation and CAS transactions (`water/DKV.java:52-222`,
`water/Key.java:12-120`) because every node runs control logic. Here one
Python process drives the card: bulk data lives on the device as torch
tensors, and only control objects (frames, models, jobs) need a keyed
registry. The Key / put / get / remove semantics (names, types, lifecycle,
listing) stay; the distributed mechanism goes.

Jobs run on worker threads, so all mutation is under a lock;
``put_if_match`` keeps `DKV.DputIfMatch`'s CAS semantics.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any

_counter = itertools.count()


def make_key(prefix: str = "obj") -> str:
    """Generate a unique key name (analog of `water/Key.java` make())."""
    return f"{prefix}_{next(_counter):06d}"


class Keyed:
    """Base for objects that live in the store under a key.

    Mirrors `water/Keyed.java`: the object knows its own key and can remove
    itself (subclasses override ``remove_impl`` to drop dependent keys).
    """

    def __init__(self, key: str | None = None, prefix: str | None = None):
        self.key = key or make_key(prefix or type(self).__name__.lower())

    def remove_impl(self, store: "KVStore") -> None:  # pragma: no cover - default no-op
        pass


class KVStore:
    def __init__(self) -> None:
        self._store: dict[str, Any] = {}
        self._lock = threading.RLock()

    def put(self, key: str, value: Any) -> Any:
        with self._lock:
            self._store[key] = value
        return value

    def put_keyed(self, value: Keyed) -> Keyed:
        return self.put(value.key, value)

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._store.get(key, default)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._store

    def remove(self, key: str, cascade: bool = True) -> Any:
        with self._lock:
            val = self._store.pop(key, None)
        if cascade and isinstance(val, Keyed):
            val.remove_impl(self)
        return val

    def put_if_match(self, key: str, new: Any, expected: Any) -> Any:
        """CAS put: only store ``new`` if the current value is ``expected``.

        Returns the value now in the store (analog of `water/DKV.java`
        DputIfMatch which returns the witnessed old value).
        """
        with self._lock:
            cur = self._store.get(key)
            if cur is expected or cur == expected:
                self._store[key] = new
                return new
            return cur

    def keys(self, of_type: type | None = None) -> list[str]:
        with self._lock:
            if of_type is None:
                return list(self._store)
            return [k for k, v in self._store.items() if isinstance(v, of_type)]

    def clear(self) -> None:
        with self._lock:
            self._store.clear()

    def snapshot(self) -> frozenset:
        """Current key set — the `CheckKeysTask` view the leak rule diffs."""
        with self._lock:
            return frozenset(self._store)


class leak_check:
    """Context manager asserting an operation leaves no new keys behind —
    the `water/junit/rules/CheckLeakedKeysRule.java:20-35` analog for the
    single-controller store. Keys the caller DID mean to create are passed
    out by returning them from the block and listing them in ``expect``
    (a callable evaluated at exit, or an iterable of keys)."""

    def __init__(self, store: KVStore | None = None, expect=()):
        self.store = store or STORE
        self.expect = expect

    def __enter__(self):
        self._before = self.store.snapshot()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        expected = self.expect() if callable(self.expect) else self.expect
        leaked = self.store.snapshot() - self._before - frozenset(expected)
        if leaked:
            raise AssertionError(
                f"leaked keys: {sorted(leaked)} — operations must remove "
                f"their temporaries (CheckLeakedKeysRule)")
        return False


#: Process-global store (the analog of `H2O.STORE`).
STORE = KVStore()
