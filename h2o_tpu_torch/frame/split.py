"""Frame splitters (``h2o_tpu/frame/split.py``; `hex/splitframe/`).

H2O's split is probabilistic, not exact: each row draws a uniform and lands
in the first split whose cumulative ratio exceeds it. ``split_frame``
reproduces that and ``split_exact`` gives shuffled splits of exact row
counts. Both draw from numpy's ``default_rng(seed)`` as the reference does,
so the rows of each split are the reference's.
"""

from __future__ import annotations

import numpy as np

from .frame import Frame


def split_frame(fr: Frame, ratios=(0.75,), seed: int | None = None
                ) -> list[Frame]:
    """Random split by a per-row uniform draw: ``len(ratios) + 1`` frames,
    the last takes the remainder (ratios must sum to less than 1)."""
    ratios = list(ratios)
    if sum(ratios) >= 1.0:
        raise ValueError("ratios must sum to less than 1.0")
    rng = np.random.default_rng(None if seed in (None, -1) else seed)
    u = rng.random(fr.nrow)
    bounds = np.cumsum(ratios + [1.0 - sum(ratios)])
    which = np.minimum(np.searchsorted(bounds, u, side="right"),
                       len(bounds) - 1)
    return [fr.take(np.flatnonzero(which == k)) for k in range(len(bounds))]


def split_exact(fr: Frame, ratios=(0.75,), seed: int | None = None
                ) -> list[Frame]:
    """Row-count splits of a shuffle, each split's rows in frame order."""
    ratios = list(ratios)
    rng = np.random.default_rng(None if seed in (None, -1) else seed)
    perm = rng.permutation(fr.nrow)
    counts = [int(r * fr.nrow) for r in ratios]
    counts.append(fr.nrow - sum(counts))
    out, s = [], 0
    for c in counts:
        out.append(fr.take(np.sort(perm[s:s + c])))
        s += c
    return out
