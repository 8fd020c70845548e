"""DRF / Extremely Randomized Trees (``h2o_tpu/models/drf.py``).

The GBM builder's engine in DRF mode, with the reference's semantics: each
tree an independent fit at f = 0 on a row subsample (default 0.632), per
level column subsampling through ``mtries`` (-1 = floor(sqrt(F)) for
classification, F // 3 for regression), leaves holding per-leaf response
means (class frequencies for classification), predictions averaged over
the trees, depth capped at 12. XRT is DRF on ``histogram_type="Random"``
bin edges. Training metrics are out of bag (``"Reported on OOB data"``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from .gbm import GBM, GBMModel, GBMParameters


@dataclass
class DRFParameters(GBMParameters):
    ntrees: int = 50
    max_depth: int = 20
    sample_rate: float = 0.632
    mtries: int = -1
    histogram_type: str = "AUTO"

    def __post_init__(self):
        # DRF trees are not shrunk (`DRF.java` has no learn_rate)
        self.learn_rate = 1.0


class DRFModel(GBMModel):
    algo_name = "drf"


class DRF(GBM):
    algo_name = "drf"
    drf_mode = True
    model_class = DRFModel

    def _tree_config(self, K, nbins):
        cfg = super()._tree_config(K, nbins)
        p = self.params
        mtries = p.mtries
        if mtries in (-1, 0, None):
            F = len(self.feature_names())
            _, category, _ = self.response_info()
            mtries = (max(1, int(math.sqrt(F))) if category != "Regression"
                      else max(1, F // 3))
        # the static tree layout caps the depth; deeper trees are masked work
        return dataclasses.replace(cfg, mtries=int(mtries), drf_mode=True,
                                   max_depth=min(p.max_depth, 12),
                                   learn_rate=1.0)


@dataclass
class XRTParameters(DRFParameters):
    histogram_type: str = "Random"  # random split thresholds ARE the XRT


class XRT(DRF):
    algo_name = "xrt"
