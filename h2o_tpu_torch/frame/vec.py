"""Vec — one padded column on a torch device (``h2o_tpu/frame/vec.py``).

Storage is one float32 tensor of ``padded_len(nrow)`` rows on the frame's
device; missing values and padding rows are both NaN. Rollups (min, max,
mean, sigma, NA count) are computed by one pass and cached, with the
reference's centred variance.

String and UUID columns stay on the host (``T_STR``/``T_UUID``: ``data`` is
None, ``host_data`` an object array), as in the reference. Where float32
cannot hold a column's values (integer ids above 2^24, milliseconds since
the epoch), ``from_numpy`` keeps the exact host copy in ``exact_data`` and
``to_numpy``/``at`` return it; the device column is its float32 projection.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..parallel.mesh import padded_len, resolve_device

T_NUM = "real"
T_INT = "int"
T_CAT = "enum"
T_TIME = "time"
T_STR = "string"
T_UUID = "uuid"
T_BAD = "bad"  # all-NA column

NUMERIC_TYPES = (T_NUM, T_INT, T_CAT, T_TIME, T_BAD)


@dataclass
class Rollups:
    """Cached summary stats — ``water/fvec/RollupStats.java`` fields."""

    mins: float
    maxs: float
    mean: float
    sigma: float
    nacnt: int
    nrow: int
    zerocnt: int = 0
    is_int: bool = False


def _rollups(data: torch.Tensor, nrow: int) -> Rollups:
    ok = ~torch.isnan(data)
    n = int(ok.sum())
    if n == 0:
        return Rollups(np.nan, np.nan, np.nan, np.nan, nrow, nrow)
    x = torch.where(ok, data, 0.0)
    mean = x.sum() / n
    d = torch.where(ok, data - mean, 0.0)
    var = float((d * d).sum() / n) * (n / max(n - 1, 1))  # sample variance
    return Rollups(
        mins=float(torch.where(ok, data, torch.inf).min()),
        maxs=float(torch.where(ok, data, -torch.inf).max()),
        mean=float(mean), sigma=float(np.sqrt(max(var, 0.0))),
        nacnt=nrow - n, nrow=nrow, zerocnt=int((ok & (data == 0.0)).sum()),
        is_int=bool(torch.where(ok, data == torch.floor(data), True).all()))


class Vec:
    def __init__(self, data: torch.Tensor | None, nrow: int,
                 type: str = T_NUM, domain: list[str] | None = None,
                 host_data: np.ndarray | None = None,
                 exact_data: np.ndarray | None = None):
        self.data = data        # (plen,) float32, NaN = NA or padding;
                                # None for host string columns
        self.nrow = int(nrow)
        self.type = type
        self.domain = domain    # categorical level names (host-side)
        self.host_data = host_data    # T_STR/T_UUID: object array
        self.exact_data = exact_data  # exact int64/float64 copy when
                                      # float32 is lossy
        self._rollups: Rollups | None = None

    @staticmethod
    def from_numpy(arr, type: str | None = None,
                   domain: list[str] | None = None, device=None) -> "Vec":
        """Host array -> padded float32 column on ``device`` (default
        ``cuda``); a string array becomes a host ``T_STR`` column."""
        arr = np.asarray(arr)
        nrow = arr.shape[0]
        if arr.dtype == object or arr.dtype.kind in "US":
            return Vec(None, nrow, type=T_STR,
                       host_data=np.asarray(arr, dtype=object))
        buf = np.full(padded_len(nrow), np.nan, dtype=np.float32)
        f32 = arr.astype(np.float32)
        buf[:nrow] = f32
        if type is None:
            if domain is not None:
                type = T_CAT
            elif arr.dtype.kind in "iub":
                type = T_INT
            else:
                type = T_NUM
        # float32 is lossy above 2^24: keep the exact values on the host
        # (the reference's rule, `h2o_tpu/frame/vec.py:302-315`)
        exact = None
        if arr.dtype.kind in "iuf" and arr.dtype.itemsize > 4 and nrow:
            back = (f32.astype(arr.dtype) if arr.dtype.kind in "iu"
                    else f32.astype(np.float64))
            with np.errstate(invalid="ignore"):
                lossy = ~np.isclose(back, arr, rtol=0, atol=0, equal_nan=True)
            if lossy.any():
                exact = arr.copy()
        data = torch.from_numpy(buf).to(resolve_device(device))
        return Vec(data, nrow, type=type, domain=domain, exact_data=exact)

    @property
    def device(self) -> torch.device | None:
        return None if self.data is None else self.data.device

    @property
    def plen(self) -> int:
        return self.nrow if self.data is None else int(self.data.shape[0])

    def __len__(self) -> int:
        return self.nrow

    def is_numeric(self) -> bool:
        return self.type in (T_NUM, T_INT)

    def is_categorical(self) -> bool:
        return self.type == T_CAT

    def is_string(self) -> bool:
        return self.type == T_STR

    def cardinality(self) -> int:
        return len(self.domain) if self.domain else -1

    def to_numpy(self) -> np.ndarray:
        """The logical column on the host (NA as NaN; exact values where
        float32 is lossy; the object array of a string column)."""
        if self.data is None:
            return self.host_data
        if self.exact_data is not None:
            return self.exact_data
        return self.data[: self.nrow].cpu().numpy()

    def at(self, i: int):
        """One element (``Chunk.at()``); syncs with the device."""
        if not -self.nrow <= i < self.nrow:
            raise IndexError(f"row {i} out of range for Vec of {self.nrow} "
                             f"rows")
        if i < 0:
            i += self.nrow
        if self.data is None:
            return self.host_data[i]
        if self.exact_data is not None:
            return self.exact_data[i]
        return float(self.data[i])

    def rollups(self) -> Rollups:
        if self._rollups is None:
            if self.data is None:
                nacnt = int(sum(1 for v in self.host_data if v is None))
                self._rollups = Rollups(np.nan, np.nan, np.nan, np.nan,
                                        nacnt, self.nrow)
            else:
                self._rollups = _rollups(self.data, self.nrow)
        return self._rollups

    def min(self) -> float:
        return self.rollups().mins

    def max(self) -> float:
        return self.rollups().maxs

    def mean(self) -> float:
        return self.rollups().mean

    def sigma(self) -> float:
        return self.rollups().sigma

    def nacnt(self) -> int:
        return self.rollups().nacnt

    def with_data(self, data: torch.Tensor, type: str | None = None,
                  domain: Any = "__same__") -> "Vec":
        return Vec(data, self.nrow, type=type or self.type,
                   domain=self.domain if domain == "__same__" else domain)

    def astype_cat(self, domain: list[str]) -> "Vec":
        return Vec(self.data, self.nrow, type=T_CAT, domain=domain)

    def __repr__(self) -> str:
        dom = f", card={len(self.domain)}" if self.domain else ""
        return (f"Vec(nrow={self.nrow}, type={self.type}{dom}, "
                f"device={self.device})")
