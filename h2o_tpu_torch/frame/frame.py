"""Frame — a named collection of Vecs on one device
(``h2o_tpu/frame/frame.py``). Every device column shares the frame's padded
length and device; string columns live on the host. ``Model.adapt_frame``
stacks a model's columns into its dense (plen, ncol) float32 matrix.

``take`` and ``concat_rows`` are the row operations behind ``split_frame``
and cross-validation's fold frames: device columns are gathered or joined
on the device, string columns (and columns with an exact host copy) on the
host, as the reference does for every column. A Frame is ``Keyed``:
``destination_frame`` names it, else it takes a generated key; parsed,
loaded and compressed frames are registered in the K/V store, as the
reference registers them. ``compress`` codes the columns
(``frame/chunks.py``). ``from_pandas``/``to_pandas`` are not ported (the
card's machine has no pandas).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from ..backend.kvstore import Keyed
from ..parallel.mesh import padded_len, resolve_device
from .vec import Vec


class Frame(Keyed):
    def __init__(self, names: Sequence[str] | None = None,
                 vecs: Sequence[Vec] | None = None, key: str | None = None):
        super().__init__(key=key, prefix="frame")
        self._names: list[str] = list(names or [])
        self._vecs: list[Vec] = list(vecs or [])
        if len(self._names) != len(self._vecs):
            raise ValueError("one name per column")
        for v in self._vecs[1:]:
            self._check_aligned(v)

    @staticmethod
    def from_dict(cols: dict, device=None, key: str | None = None) -> "Frame":
        """Columns (numpy arrays or Vecs) -> Frame on ``device`` (default
        ``cuda``; raises when no GPU is present)."""
        dev = resolve_device(device)
        names, vecs = [], []
        for name, col in cols.items():
            names.append(str(name))
            vecs.append(col if isinstance(col, Vec)
                        else Vec.from_numpy(np.asarray(col), device=dev))
        return Frame(names, vecs, key=key)

    def _check_aligned(self, vec: Vec) -> None:
        first = self._vecs[0]
        if vec.nrow != first.nrow:
            raise ValueError(f"column has {vec.nrow} rows, frame has "
                             f"{first.nrow}")
        ref = next((v for v in self._vecs if v.device is not None), None)
        if ref is None or vec.device is None or ref is vec:
            return
        if vec.plen != ref.plen:
            raise ValueError(f"column padded to {vec.plen} rows, frame to "
                             f"{ref.plen}")
        if vec.device != ref.device:
            raise ValueError(f"column on {vec.device}, frame on "
                             f"{ref.device}")

    @property
    def device(self) -> torch.device | None:
        """The device of the frame's device columns (None when every
        column is a host string column)."""
        return next((v.device for v in self._vecs if v.device is not None),
                    None)

    @property
    def nrow(self) -> int:
        return self._vecs[0].nrow if self._vecs else 0

    @property
    def ncol(self) -> int:
        return len(self._vecs)

    @property
    def names(self) -> list[str]:
        return list(self._names)

    @property
    def vecs(self) -> list[Vec]:
        return list(self._vecs)

    def vec(self, name_or_idx) -> Vec:
        if isinstance(name_or_idx, int):
            return self._vecs[name_or_idx]
        return self._vecs[self._names.index(name_or_idx)]

    def __getitem__(self, sel):
        if isinstance(sel, str):
            return self.vec(sel)
        if isinstance(sel, (list, tuple)):
            return self.subframe(sel)
        return self._vecs[sel]

    def find(self, name: str) -> int:
        return self._names.index(name) if name in self._names else -1

    def types(self) -> dict[str, str]:
        return dict(zip(self._names, (v.type for v in self._vecs)))

    def as_matrix(self, names: Sequence[str] | None = None) -> torch.Tensor:
        """The columns ``names`` (all by default) stacked into a (plen,
        ncol) float32 matrix on the frame's device
        (``h2o_tpu/frame/frame.py:183``); string columns refuse."""
        cols = [self.vec(n) for n in (self._names if names is None
                                      else names)]
        if any(c.data is None for c in cols):
            raise ValueError("string columns have no device matrix")
        return torch.stack([c.data for c in cols], dim=1)

    def ensure_rollups(self, names: Sequence[str] | None = None) -> None:
        """Compute every missing column rollup: coded columns in code space,
        batched per code width (``chunks.batch_code_rollups``), the others
        one pass each. The reference batches the plain columns into fused
        multi-column passes over its mesh; the values are the same."""
        from .chunks import CodedVec, batch_code_rollups

        todo = [self.vec(n) for n in (names if names is not None
                                      else self._names)]
        rest = set(map(id, batch_code_rollups(
            [v for v in todo if isinstance(v, CodedVec)])))
        for v in todo:
            if not isinstance(v, CodedVec) or id(v) in rest:
                v.rollups()

    def add(self, name: str, vec: Vec) -> "Frame":
        if self._vecs:
            self._check_aligned(vec)
        self._names.append(name)
        self._vecs.append(vec)
        return self

    def remove(self, name: str) -> Vec:
        i = self._names.index(name)
        self._names.pop(i)
        return self._vecs.pop(i)

    def replace(self, name: str, vec: Vec) -> "Frame":
        self._check_aligned(vec)
        self._vecs[self._names.index(name)] = vec
        return self

    def subframe(self, names: Iterable[str]) -> "Frame":
        names = list(names)
        return Frame(names, [self.vec(n) for n in names])

    def rename(self, old: str, new: str) -> "Frame":
        self._names[self._names.index(old)] = new
        return self

    def take(self, idx) -> "Frame":
        """Row subset by an integer index array (split_frame, CV folds):
        an ``index_select`` on the device for device columns, the host
        array for string columns and exact host copies."""
        idx = np.asarray(idx, dtype=np.int64)
        n = len(idx)
        dev_idx = {}
        vecs = []
        for v in self._vecs:
            if v.is_string():
                vecs.append(Vec(None, n, type=v.type,
                                host_data=v.host_data[idx]))
            elif v.exact_data is not None:
                vecs.append(Vec.from_numpy(v.exact_data[idx], type=v.type,
                                           domain=v.domain, device=v.device))
            else:
                if v.device not in dev_idx:
                    dev_idx[v.device] = torch.from_numpy(idx).to(v.device)
                vecs.append(Vec(_padded(v.data.index_select(
                    0, dev_idx[v.device]), n), n, type=v.type,
                    domain=v.domain))
        return Frame(self.names, vecs)

    def concat_rows(self, *others: "Frame") -> "Frame":
        """Row-wise concatenation (rbind), keeping ``self``'s types and
        domains: the other frames' codes are taken as they are, as the
        reference takes them (`h2o_tpu/frame/frame.py:163`)."""
        n = self.nrow + sum(o.nrow for o in others)
        vecs = []
        for name, v0 in zip(self._names, self._vecs):
            parts = [v0] + [o.vec(name) for o in others]
            if v0.is_string():
                vecs.append(Vec(None, n, type=v0.type, host_data=np.concatenate(
                    [p.host_data for p in parts])))
            elif any(p.exact_data is not None for p in parts):
                vecs.append(Vec.from_numpy(
                    np.concatenate([p.to_numpy() for p in parts]),
                    type=v0.type, domain=v0.domain, device=v0.device))
            else:
                data = torch.cat([p.data[:p.nrow].to(v0.device)
                                  for p in parts])
                vecs.append(Vec(_padded(data, n), n, type=v0.type,
                                domain=v0.domain))
        return Frame(self.names, vecs)

    def compress(self) -> "Frame":
        """Compressed copy of this frame: every column re-encoded with the
        narrowest bit-exact codec (``frame/chunks.py``); columns no codec
        reproduces stay plain (shared, not copied)."""
        from .chunks import compress_frame

        return compress_frame(self)

    def __repr__(self) -> str:
        key = f"{self.key}, " if self.key else ""
        return (f"Frame({key}{self.nrow}x{len(self._vecs)} "
                f"{self._names[:8]})")


def _padded(data: torch.Tensor, nrow: int) -> torch.Tensor:
    """``nrow`` logical rows -> the column padded with NaN to
    ``padded_len(nrow)``, as ``Vec.from_numpy`` lays it out."""
    out = torch.full((padded_len(nrow),), float("nan"), dtype=data.dtype,
                     device=data.device)
    out[:nrow] = data[:nrow]
    return out
