"""Categorical encodings (``h2o_tpu/utils/linalg.py``,
`hex/util/LinearAlgebraUtils.java` and the encoders of
`water/util/FrameUtils.java`).

``build_encoding_state`` freezes a ``categorical_encoding`` on the training
frame as host data — numpy domains, eigen loadings, kept levels and level
orders — so that ``apply_encoding_state`` replays the identical mapping on
any frame, levels matched by name. The statistics it needs (level counts,
weighted response sums) are taken on the host in float64, as the
reference takes them, so the state is the reference's bit for bit on any
device. The encoded columns are built on the frame's device: a level's
code goes through a small lookup table indexed on the device, never
through a per-row host loop.

Eigen replaces a categorical column by its level's loading on the dominant
eigenvector of the centered one-hot covariance ``diag(p) - p pᵀ`` (k x k,
``eigh`` in float64 on the host, as the reference).
"""

from __future__ import annotations

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, T_NUM, Vec


def _level_counts(v: Vec) -> np.ndarray:
    """(k,) float64 counts of each level of a categorical column."""
    host = v.to_numpy()
    ok = ~np.isnan(host)
    return np.bincount(host[ok].astype(np.int64),
                       minlength=len(v.domain)).astype(np.float64)


def _eigen_loadings(v: Vec) -> np.ndarray:
    """Per-level loading on the dominant eigenvector of the centered
    one-hot covariance, its sign fixed so the largest entry is positive
    (reference ``linalg.py:41``)."""
    counts = _level_counts(v)
    p = counts / max(counts.sum(), 1.0)
    C = np.diag(p) - np.outer(p, p)
    _, vecs = np.linalg.eigh(C)
    v1 = vecs[:, -1]
    if v1[np.argmax(np.abs(v1))] < 0:
        v1 = -v1
    return v1.astype(np.float32)


def to_eigen_vec(v: Vec) -> Vec:
    """Categorical Vec -> numeric Vec of per-level eigen loadings
    (reference ``linalg.py:21``); a numeric Vec passes through."""
    if not v.is_categorical():
        return v
    load = torch.from_numpy(_eigen_loadings(v)).to(v.data.device)
    return Vec(_lookup(load, v.data), v.nrow, type=T_NUM)


#: wire-name spellings accepted for each frozen scheme
_ENC_CANON = {
    "eigen": "Eigen", "onehotexplicit": "OneHotExplicit",
    "one_hot_explicit": "OneHotExplicit", "binary": "Binary",
    "labelencoder": "LabelEncoder", "label_encoder": "LabelEncoder",
    "enumlimited": "EnumLimited", "enum_limited": "EnumLimited",
    "sortbyresponse": "SortByResponse", "sort_by_response": "SortByResponse",
}


def build_encoding_state(fr: Frame, encoding: str,
                         skip: list[str] | None = None,
                         response: str | None = None,
                         weights: str | None = None,
                         max_levels: int = 10) -> dict | None:
    """Freeze ``encoding`` on the training frame (reference ``linalg.py:
    66-138``); None for AUTO/Enum/OneHotInternal, which the builders
    handle themselves.

    - Eigen: the per-level eigen loading.
    - OneHotExplicit: one 0/1 column ``name.level`` per level.
    - Binary: ``1 + floor(log2(card))`` bit columns ``name:k`` of
      ``code + 1``; NA gives all zeros.
    - LabelEncoder: the level code as a numeric column.
    - EnumLimited: a column of more than ``max_levels`` levels keeps its
      ``max_levels`` most frequent ones (in domain order), every other
      level becomes a trailing ``other``; renamed
      ``name.top_<max_levels>_levels``. Smaller columns stay as they are.
    - SortByResponse: levels reordered by weighted mean response,
      ascending (stable; empty levels last); the column stays categorical.
    """
    skip = set(skip or [])
    enc = _ENC_CANON.get((encoding or "AUTO").lower())
    if enc is None:
        return None
    if enc == "SortByResponse" and (response is None
                                    or response not in fr.names):
        return None   # unsupervised: nothing to sort by
    cols = {}
    for name in fr.names:
        v = fr.vec(name)
        if not v.is_categorical() or name in skip:
            continue
        card = len(v.domain)
        if enc == "EnumLimited":
            if card <= max_levels:
                continue
            counts = _level_counts(v)
            top = np.sort(np.argsort(-counts, kind="stable")[:max_levels])
            cols[name] = {"domain": list(v.domain),
                          "keep": [v.domain[i] for i in top],
                          "max_levels": int(max_levels)}
            continue
        cols[name] = {"domain": list(v.domain)}
        if enc == "Eigen":
            cols[name]["loadings"] = _eigen_loadings(v)
        elif enc == "Binary":
            cols[name]["nbits"] = 1 + int(np.floor(np.log2(max(card, 1))))
        elif enc == "SortByResponse":
            host = v.to_numpy()
            y = fr.vec(response).to_numpy().astype(np.float64)
            w = (fr.vec(weights).to_numpy().astype(np.float64)
                 if weights and weights in fr.names else np.ones_like(y))
            ok = ~(np.isnan(host) | np.isnan(y) | np.isnan(w))
            c = host[ok].astype(np.int64)
            wsum = np.bincount(c, weights=w[ok], minlength=card)
            ysum = np.bincount(c, weights=(w * y)[ok], minlength=card)
            mean = np.where(wsum > 0, ysum / np.maximum(wsum, 1e-300),
                            np.inf)
            order = np.argsort(mean, kind="stable")
            cols[name] = {"domain": [v.domain[i] for i in order]}
    if not cols:
        return None
    return {"encoding": enc, "columns": cols}


def _remap_codes(v: Vec, levels: list, default: float = np.nan):
    """This column's codes mapped onto ``levels`` by level name, on the
    column's device: (plen,) float32, NaN for NA and padding, ``default``
    for a level ``levels`` lacks."""
    lut = {lvl: i for i, lvl in enumerate(levels)}
    table = np.array([lut.get(lvl, default) for lvl in (v.domain or [])],
                     np.float32)
    return _lookup(torch.from_numpy(table).to(v.data.device), v.data)


def _lookup(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``table[codes]`` with NaN where ``codes`` is NaN."""
    ok = ~torch.isnan(codes)
    if table.numel() == 0:
        return torch.full_like(codes, torch.nan)
    idx = torch.where(ok, codes, 0.0).to(torch.int64)
    return torch.where(ok, table[idx], torch.nan)


def apply_encoding_state(fr: Frame, state: dict) -> Frame:
    """Replay a frozen encoding on any frame (reference ``linalg.py:
    141-205``): a column the state names that is still categorical is
    encoded; every other column passes through. Levels the training frame
    never had become NA (EnumLimited: ``other``)."""
    enc = state["encoding"]
    names, vecs = [], []
    for name in fr.names:
        v = fr.vec(name)
        spec = state["columns"].get(name)
        if spec is None or not v.is_categorical():
            names.append(name)
            vecs.append(v)
            continue
        n = v.nrow
        if enc == "EnumLimited":
            keep = list(spec["keep"])
            codes = _remap_codes(v, keep, default=float(len(keep)))
            names.append(f"{name}.top_{spec['max_levels']}_levels")
            vecs.append(Vec(codes, n, type=T_CAT,
                            domain=keep + ["other"]))
            continue
        codes = _remap_codes(v, spec["domain"])
        if enc == "Eigen":
            load = torch.from_numpy(np.asarray(spec["loadings"],
                                               np.float32)).to(codes.device)
            names.append(name)
            vecs.append(Vec(_lookup(load, codes), n, type=T_NUM))
        elif enc == "LabelEncoder":
            names.append(name)
            vecs.append(Vec(codes, n, type=T_NUM))
        elif enc == "SortByResponse":
            names.append(name)
            vecs.append(Vec(codes, n, type=T_CAT,
                            domain=list(spec["domain"])))
        elif enc == "Binary":
            # val = NA ? 0 : 1 + code, little-endian bits across name:k
            # (`FrameUtils.CategoricalBinaryEncoder`); padding stays NaN
            val = torch.where(torch.isnan(codes), 0.0, codes + 1).to(
                torch.int64)
            pad = torch.arange(codes.shape[0], device=codes.device) >= n
            for k in range(int(spec["nbits"])):
                bit = ((val >> k) & 1).to(torch.float32)
                names.append(f"{name}:{k}")
                vecs.append(Vec(torch.where(pad, torch.nan, bit), n))
        else:   # OneHotExplicit
            for j, lvl in enumerate(spec["domain"]):
                col = torch.where(torch.isnan(codes), torch.nan,
                                  (codes == j).to(torch.float32))
                names.append(f"{name}.{lvl}")
                vecs.append(Vec(col, n))
    return Frame(names, vecs)


def apply_categorical_encoding(fr: Frame, encoding: str,
                               skip: list[str] | None = None) -> Frame:
    """One-shot transform: the state built and replayed on the same frame
    (reference ``linalg.py:208``)."""
    state = build_encoding_state(fr, encoding, skip)
    return fr if state is None else apply_encoding_state(fr, state)
