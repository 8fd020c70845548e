"""DataInfo — the modeling row codec (``h2o_tpu/models/datainfo.py``).

Expands a Frame into the dense design matrix GLM consumes: categorical
one-hot blocks first, then numeric columns (the reference's layout), with
optional standardization of numerics, ``use_all_factor_levels`` control
(drop-first by default, as GLM does) and missing-value handling
(MeanImputation: numeric -> mean, categorical -> mode; or Skip: rows flagged
invalid). Means, sigmas and modes are frozen at train time and replayed at
score time.

The expansion writes into one preallocated (plen, P) float32 tensor on the
frame's device, column block by column block, instead of concatenating
per-column blocks: at HIGGS scale that is one 1.3 GB allocation, not two.
Padding rows (NaN in every column) impute like any NA, so the matrix stays
finite everywhere.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from ..frame.frame import Frame


@dataclass
class DataInfo:
    names: list                      # source column names (feature order)
    is_cat: np.ndarray               # per source column
    domains: dict                    # name -> domain (cats)
    cat_modes: dict                  # name -> mode code (imputation)
    num_means: dict                  # name -> mean
    num_sigmas: dict                 # name -> sigma
    use_all_factor_levels: bool
    standardize: bool                 # divide numerics by sigma
    missing_values_handling: str      # MeanImputation | Skip
    expanded_names: list = field(default_factory=list)
    center: bool | None = None        # subtract numeric means; None = follow
                                      # `standardize`. Imputation always uses
                                      # the mean regardless.

    @property
    def ncols_expanded(self) -> int:
        return len(self.expanded_names)

    @property
    def effective_center(self) -> bool:
        """Whether numeric columns are mean-centered (center defaults to
        following `standardize`)."""
        return self.standardize if self.center is None else self.center

    @staticmethod
    def carried(ref) -> "DataInfo":
        """A copy of another ``DataInfo``'s fields — the reference's, for
        ``from_reference``."""
        return DataInfo(**{f.name: copy.deepcopy(getattr(ref, f.name))
                           for f in dataclasses.fields(DataInfo)})

    @staticmethod
    def make(fr: Frame, names, standardize=True, use_all_factor_levels=False,
             missing_values_handling="MeanImputation") -> "DataInfo":
        # categoricals first, then numerics — mirrors DataInfo column ordering
        fr.ensure_rollups(names)
        cats = [n for n in names if fr.vec(n).is_categorical()]
        nums = [n for n in names if not fr.vec(n).is_categorical()]
        ordered = cats + nums
        is_cat = np.array([True] * len(cats) + [False] * len(nums))
        domains, modes, means, sigmas = {}, {}, {}, {}
        expanded = []
        for n in cats:
            v = fr.vec(n)
            domains[n] = list(v.domain)
            host = v.to_numpy()
            ok = host[~np.isnan(host)].astype(np.int64)
            modes[n] = int(np.bincount(ok).argmax()) if ok.size else 0
            lo = 0 if use_all_factor_levels else 1
            expanded += [f"{n}.{v.domain[i]}" for i in range(lo, len(v.domain))]
        for n in nums:
            r = fr.vec(n).rollups()
            means[n] = float(np.nan_to_num(r.mean))
            sg = float(r.sigma)
            sigmas[n] = sg if np.isfinite(sg) and sg > 0 else 1.0
            expanded.append(n)
        return DataInfo(ordered, is_cat, domains, modes, means, sigmas,
                        use_all_factor_levels, standardize,
                        missing_values_handling, expanded)

    # -- device expansion -----------------------------------------------------
    def expand(self, fr: Frame, intercept: bool = False):
        """Frame -> (X (plen, P) device matrix, valid_row mask (plen,)).

        Rows with NAs are imputed (MeanImputation) or flagged invalid (Skip).
        Unseen categorical levels at score time behave like NAs. With
        ``intercept`` the matrix gets one more column of ones, last (GLM's
        design; the reference appends it with a concatenate)."""
        plen = fr.vec(self.names[0]).plen if self.names else 0
        P = self.ncols_expanded
        dev = fr.device
        X = torch.empty((plen, P + int(intercept)), dtype=torch.float32,
                        device=dev)
        if intercept:
            X[:, P] = 1.0
        bad = torch.zeros(plen, dtype=torch.bool, device=dev)
        skip = self.missing_values_handling == "Skip"
        lo = 0 if self.use_all_factor_levels else 1
        j = 0
        for n in self.names:
            v = fr.vec(n)
            col = v.data
            if n in self.domains:
                dom = self.domains[n]
                if v.domain != dom and v.domain is not None:
                    col = _remap_codes(v, dom)
                card = len(dom)
                isna = torch.isnan(col) | (col >= card)
                if skip:
                    bad |= isna
                codes = torch.where(isna, float(self.cat_modes[n]),
                                    col).to(torch.int64)
                width = card - lo
                blk = X[:, j:j + width]
                blk.zero_()
                hot = codes - lo                       # the dropped level: -1
                keep = hot >= 0
                rows = torch.arange(plen, device=dev)[keep]
                blk[rows, hot[keep]] = 1.0
                j += width
            else:
                isna = torch.isnan(col)
                if skip:
                    bad |= isna
                x = torch.where(isna, self.num_means[n], col)
                if self.effective_center:
                    x = x - self.num_means[n]
                if self.standardize:
                    x = x / self.num_sigmas[n]
                X[:, j] = x
                j += 1
        return X, ~bad


def _remap_codes(v, train_dom) -> torch.Tensor:
    """A categorical column's codes on the training domain, by level name;
    levels unseen in training become NaN (the reference's remap)."""
    remap = {lvl: i for i, lvl in enumerate(train_dom)}
    codes = np.full(len(v.domain), np.nan, dtype=np.float32)
    for i, lvl in enumerate(v.domain):
        if lvl in remap:
            codes[i] = remap[lvl]
    host = v.to_numpy()
    out = np.full(v.plen, np.nan, dtype=np.float32)
    ok = ~np.isnan(host)
    out[: len(host)][ok] = codes[host[ok].astype(np.int64)]
    return torch.from_numpy(out).to(v.device)
