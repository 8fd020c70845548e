"""BinnedView — the packed (plen, F) bin-code matrix the tree engine trains
on (``h2o_tpu/frame/chunks.py:BinnedView``). Codes are stored in the
narrowest signed dtype that holds ``0..nbins_tot`` (int8 at the default 20
bins, int16 once a 300-level categorical widens the bin space) and are
widened only inside the histogram kernel. The chunk codecs
wait for a later slice."""

from __future__ import annotations

import numpy as np
import torch


class BinnedView:
    def __init__(self, matrix: torch.Tensor, edges_np: np.ndarray,
                 names=None):
        self.matrix = matrix            # (plen, F) int8/int16/int32
        self.edges_np = edges_np
        self.col_names = list(names) if names is not None else None

    @staticmethod
    def code_dtype(nbins_tot: int) -> torch.dtype:
        """Narrowest signed dtype holding codes 0..nbins_tot (NA bucket)."""
        if nbins_tot <= np.iinfo(np.int8).max:
            return torch.int8
        if nbins_tot <= np.iinfo(np.int16).max:
            return torch.int16
        return torch.int32

    @staticmethod
    def build(cols, edges_np: np.ndarray, names=None) -> "BinnedView":
        """Bin column by column against ``edges_np`` ((F, W) NaN-padded cut
        rows) and pack into one contiguous narrow-dtype matrix; the raw f32
        matrix is never stacked."""
        from ..models.tree.binning import _coldata, bin_column

        cols = list(cols)
        if len(cols) != edges_np.shape[0]:
            raise ValueError("one edge row per column")
        dtype = BinnedView.code_dtype(edges_np.shape[1] + 1)
        dev = _coldata(cols[0]).device
        edges = torch.from_numpy(
            np.ascontiguousarray(edges_np, np.float32)).to(dev)
        codes = [bin_column(_coldata(c), edges[f], dtype=dtype)
                 for f, c in enumerate(cols)]
        return BinnedView(torch.stack(codes, dim=1), edges_np, names=names)

    def __repr__(self) -> str:
        return f"BinnedView(shape={tuple(self.matrix.shape)}, " \
               f"dtype={self.matrix.dtype})"
