"""Frame — a named collection of Vecs on one device
(``h2o_tpu/frame/frame.py``). Every column shares the frame's padded length
and device; ``Model.adapt_frame`` stacks a model's columns into its dense
(plen, ncol) float32 matrix."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from .vec import Vec


class Frame:
    def __init__(self, names: Sequence[str] | None = None,
                 vecs: Sequence[Vec] | None = None):
        self._names: list[str] = list(names or [])
        self._vecs: list[Vec] = list(vecs or [])
        if len(self._names) != len(self._vecs):
            raise ValueError("one name per column")
        for v in self._vecs[1:]:
            self._check_aligned(v)

    @staticmethod
    def from_dict(cols: dict, device=None) -> "Frame":
        """Columns (numpy arrays or Vecs) -> Frame on ``device`` (default
        ``cuda``; raises when no GPU is present)."""
        dev = resolve_device(device)
        names, vecs = [], []
        for name, col in cols.items():
            names.append(str(name))
            vecs.append(col if isinstance(col, Vec)
                        else Vec.from_numpy(np.asarray(col), device=dev))
        return Frame(names, vecs)

    def _check_aligned(self, vec: Vec) -> None:
        first = self._vecs[0]
        if vec.nrow != first.nrow or vec.plen != first.plen:
            raise ValueError(f"column has {vec.nrow} rows, frame has "
                             f"{first.nrow}")
        if vec.device != first.device:
            raise ValueError(f"column on {vec.device}, frame on "
                             f"{first.device}")

    @property
    def device(self) -> torch.device:
        return self._vecs[0].device

    @property
    def nrow(self) -> int:
        return self._vecs[0].nrow if self._vecs else 0

    @property
    def names(self) -> list[str]:
        return list(self._names)

    def vec(self, name_or_idx) -> Vec:
        if isinstance(name_or_idx, int):
            return self._vecs[name_or_idx]
        return self._vecs[self._names.index(name_or_idx)]

    def find(self, name: str) -> int:
        return self._names.index(name) if name in self._names else -1

    def add(self, name: str, vec: Vec) -> "Frame":
        if self._vecs:
            self._check_aligned(vec)
        self._names.append(name)
        self._vecs.append(vec)
        return self

    def __repr__(self) -> str:
        return f"Frame({self.nrow}x{len(self._vecs)} {self._names[:8]})"
