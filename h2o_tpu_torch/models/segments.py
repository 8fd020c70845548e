"""Segment models (``h2o_tpu/models/segments.py``; `hex/segments/
SegmentModelsBuilder.java`, `SegmentModels.java`): one model per segment
of a frame.

A blueprint set of parameters is trained once per distinct combination of
the segment columns (in first-appearance order, NA combinations left out)
on that segment's rows, the segment columns ignored; the results — each
segment's model, status and error — collect in a keyed ``SegmentModels``.
A segment whose build raises records ``FAILED`` with the message, as the
reference's does. ``parallelism`` > 1 trains that many segments at once
from a thread pool on the one device: the kernel wrappers' launch
counters take a lock, and every build is deterministic, so each model is
bit-equal to the same segment trained alone.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..backend.jobs import Job
from ..backend.kvstore import STORE, Keyed
from ..frame.frame import Frame
from ..frame.vec import T_STR, Vec


@dataclass
class SegmentModelsParameters:
    """`SegmentModelsBuilder.SegmentModelsParameters` (:171)."""

    segment_columns: list = field(default_factory=list)
    segments: Frame | None = None  # explicit segments frame (unique combos)
    parallelism: int = 1


def _string_col(vals) -> Vec:
    return Vec(None, len(vals), type=T_STR,
               host_data=np.asarray(vals, dtype=object))


class SegmentModels(Keyed):
    """The keyed result container (`hex/segments/SegmentModels.java`)."""

    def __init__(self, segments: Frame, key: str | None = None):
        super().__init__(key=key, prefix="segment_models")
        self.segments = segments          # one row per segment
        self.results: list[dict] = []     # segment, model, status, errors
        STORE.put_keyed(self)

    @staticmethod
    def from_reference(ref, device=None) -> "SegmentModels":
        """Carry a reference result set over: each segment's model through
        the port's carriers (tree, GLM and DeepLearning models)."""
        from .ensemble import carry_model

        segs = Frame(ref.segments.names,
                     [_string_col(ref.segments.vec(n).to_numpy())
                      for n in ref.segments.names])
        out = SegmentModels(segs)
        out.results = [dict(r, model=None if r["model"] is None
                            else carry_model(r["model"], device))
                       for r in ref.results]
        return out

    def as_frame(self) -> Frame:
        """Results table: segment values, model key, status and errors."""
        cols: dict[str, list] = {n: [] for n in self.segments.names}
        cols["model"], cols["status"], cols["errors"] = [], [], []
        for r in self.results:
            for n, v in r["segment"].items():
                cols[n].append(v)
            cols["model"].append(r["model"].key if r["model"] else None)
            cols["status"].append(r["status"])
            cols["errors"].append(r["errors"])
        return Frame(list(cols), [_string_col(v) for v in cols.values()])

    def models(self) -> list:
        return [r["model"] for r in self.results if r["model"] is not None]


def _unique_segments(fr: Frame, seg_cols: list[str]) -> list[dict]:
    """Distinct combinations of the segment columns, in first-appearance
    order, NA combinations left out (`SegmentModelsBuilder.java:35`
    makeSegmentsFrame)."""
    cols = [fr.vec(c).to_numpy() for c in seg_cols]
    host = np.stack([a.astype(np.float64) for a in cols], axis=1)
    keep = ~np.isnan(host).any(axis=1)
    rows = np.flatnonzero(keep)
    _, first = np.unique(host[keep], axis=0, return_index=True)
    out = []
    for r in np.sort(rows[first]):
        combo = tuple(a[r] for a in cols)
        disp = {}
        for c, v in zip(seg_cols, combo):
            d = fr.vec(c).domain
            disp[c] = d[int(v)] if d is not None else v
        out.append({"mask_vals": combo, "display": disp})
    return out


class SegmentModelsBuilder:
    def __init__(self, builder_cls, params,
                 segment_params: SegmentModelsParameters):
        self.builder_cls = builder_cls
        self.params = params
        self.seg = segment_params
        if not self.seg.segment_columns and self.seg.segments is None:
            raise ValueError("segment_columns or segments frame required")

    def build_segment_models(self) -> SegmentModels:
        fr = self.params.training_frame
        seg_cols = list(self.seg.segment_columns)
        if not seg_cols and self.seg.segments is not None:
            seg_cols = self.seg.segments.names
        combos = _unique_segments(fr, seg_cols)
        if self.seg.segments is not None:
            # the requested combinations only, in the segments frame's order
            want = []
            host = {c: self.seg.segments.vec(c).to_numpy() for c in seg_cols}
            sdoms = {c: self.seg.segments.vec(c).domain for c in seg_cols}
            by_disp = {tuple(c["display"][k] for k in seg_cols): c
                       for c in combos}
            for i in range(self.seg.segments.nrow):
                disp = tuple(
                    (sdoms[c][int(host[c][i])] if sdoms[c] is not None
                     else host[c][i]) for c in seg_cols)
                if disp in by_disp:
                    want.append(by_disp[disp])
            combos = want

        seg_frame = Frame(seg_cols,
                          [_string_col([co["display"][c] for co in combos])
                           for c in seg_cols])
        out = SegmentModels(seg_frame)
        host = np.stack([fr.vec(c).to_numpy().astype(np.float64)
                         for c in seg_cols], axis=1)

        def build_one(combo):
            idx = np.flatnonzero((host == np.asarray(combo["mask_vals"])
                                  ).all(axis=1))
            sub_fr = fr.take(idx)
            drop = [c for c in seg_cols if c in sub_fr.names]
            p = self.params.clone(
                training_frame=sub_fr,
                ignored_columns=list(self.params.ignored_columns) + drop)
            try:
                m = self.builder_cls(p).build_impl(Job("segment", work=1.0))
                return {"segment": combo["display"], "model": m,
                        "status": "SUCCEEDED", "errors": ""}
            except Exception as e:  # a segment's failure is data, not a crash
                return {"segment": combo["display"], "model": None,
                        "status": "FAILED", "errors": str(e)}

        par = max(1, int(self.seg.parallelism))
        if par > 1:
            with ThreadPoolExecutor(max_workers=par) as ex:
                out.results = list(ex.map(build_one, combos))
        else:
            out.results = [build_one(c) for c in combos]
        return out
