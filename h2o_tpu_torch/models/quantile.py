"""Quantile (``h2o_tpu/models/quantile.py``, `hex/quantile/Quantile.java`):
exact quantiles from one device sort per column.

Combine methods as `QuantileModel.CombineMethod`: INTERPOLATE (type 7,
the default), AVERAGE, LOW, HIGH. With weights, the rows sorted by value
(a stable argsort) walk their cumulative weight, the reference's weighted
ranks; that cumulative sum is jax's float32 ``cumsum`` as its CPU backend
runs it (`threefry.cumsum`), so both packages pick the same ranks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..frame.frame import Frame
from ..utils.threefry import cumsum as _xla_cumsum
from .model_base import Model, ModelBuilder, ModelOutput, Parameters
from .tree.engine import _fma

DEFAULT_PROBS = (0.001, 0.01, 0.1, 0.25, 1 / 3, 0.5, 2 / 3, 0.75, 0.9, 0.99,
                 0.999)


@dataclass
class QuantileParameters(Parameters):
    probs: tuple = DEFAULT_PROBS
    combine_method: str = "INTERPOLATE"  # INTERPOLATE | AVERAGE | LOW | HIGH


def quantiles_device(col: torch.Tensor, nrow: int, probs,
                     method="INTERPOLATE",
                     weights: torch.Tensor | None = None) -> np.ndarray:
    """Exact quantiles of one padded device column (NaN = NA or padding),
    as a host float32 array aligned with ``probs``."""
    dev = col.device
    probs = torch.tensor(np.asarray(probs, np.float32), device=dev)
    method = (method or "INTERPOLATE").upper()
    if weights is None:
        s = torch.sort(col).values          # NaN sorts last
        n = (~torch.isnan(col)).sum()
        pos = probs * (n - 1).to(torch.float32)
        fl = torch.floor(pos)
        lo = torch.clamp(fl.to(torch.int64), min=0)
        hi = torch.clamp(torch.ceil(pos).to(torch.int64), min=0)
        vlo, vhi = s[lo], s[hi]
        if method == "LOW":
            out = vlo
        elif method == "HIGH":
            out = vhi
        elif method == "AVERAGE":
            out = 0.5 * (vlo + vhi)
        else:
            out = _fma(pos - fl, vhi - vlo, vlo)
        return torch.where(n > 0, out, torch.nan).cpu().numpy()
    ok = ~torch.isnan(col) & (weights > 0)
    order = torch.argsort(torch.where(ok, col, torch.inf), stable=True)
    sv = col[order]
    sw = torch.where(ok, weights, 0.0)[order]
    cw = _xla_cumsum(sw)
    tot = cw[-1]
    targets = _fma(probs, tot - sw[0], sw[0] * 0.5)
    idx = torch.clamp(torch.searchsorted(cw, targets), 0, col.shape[0] - 1)
    return torch.where(tot > 0, sv[idx], torch.nan).cpu().numpy()


class QuantileModel(Model):
    algo_name = "quantile"

    def __init__(self, params, output, table, key=None):
        self.quantiles = table  # column -> np.ndarray aligned with probs
        super().__init__(params, output, key=key)

    @staticmethod
    def from_reference(ref, device=None) -> "QuantileModel":
        """Carry a reference quantile table over (host arrays; ``device``
        is taken for the carriers' common signature)."""
        out = ModelOutput.carried(ref.output)
        params = QuantileParameters(probs=tuple(ref.params.probs),
                                    combine_method=ref.params.combine_method)
        return QuantileModel(params, out,
                             {k: np.array(v, np.float32)
                              for k, v in ref.quantiles.items()})

    def predict(self, fr):
        raise TypeError("Quantile is a summary model; read .quantiles")


class QuantileBuilder(ModelBuilder):
    algo_name = "quantile"
    supervised = False

    def build_impl(self, job) -> QuantileModel:
        p: QuantileParameters = self.params
        fr = p.training_frame
        w = (torch.nan_to_num(fr.vec(p.weights_column).data)
             if p.weights_column else None)
        table = {}
        for name in fr.names:
            v = fr.vec(name)
            if v.data is None or v.is_categorical():
                continue
            table[name] = quantiles_device(v.data, v.nrow, p.probs,
                                           p.combine_method, w)
            job.update(1.0 / fr.ncol)
        output = ModelOutput()
        output.names = list(table)
        output.model_category = "Unknown"
        return QuantileModel(p, output, table)


def frame_quantiles(fr: Frame, probs=DEFAULT_PROBS, method="INTERPOLATE"):
    """Column -> quantile array (the rapids ``quantile``)."""
    m = QuantileBuilder(QuantileParameters(
        training_frame=fr, probs=tuple(probs),
        combine_method=method)).train_model()
    return m.quantiles
