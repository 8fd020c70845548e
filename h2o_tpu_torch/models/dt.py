"""DT — one decision tree (``h2o_tpu/models/dt.py``,
`hex/tree/dt/DT.java`).

One unsampled DRF tree on ``Exact`` bins: a column's cuts are the
midpoints between its distinct values, at any row count, for columns of at
most ``nbins_top_level`` (2,048) distinct values; a column with more keeps
its quantile cuts. DRF mode fits the leaves as response means (class
frequencies), and with sample rate 1 and every column a candidate
(``mtries`` -2) nothing random is left. The wide ``Exact`` bins make
width-bucketed histogram plans, up to 4,096 bins a bucket. The reference
limits DT to classification in its Java original and allows regression
here; so does the port.
"""

from __future__ import annotations

from dataclasses import dataclass

from .drf import DRF
from .gbm import GBMParameters


@dataclass
class DTParameters(GBMParameters):
    """Mirrors `hex/schemas/DTV3` (max_depth, min_rows). A DT is one
    unsampled tree, so the ntrees and sampling fields GBMParameters brings
    are pinned here; ``mtries`` -2 means every column."""

    nbins_top_level: int = 2048   # exact-split distinct-value cap

    def __post_init__(self):
        self.ntrees = 1
        self.sample_rate = 1.0
        self.col_sample_rate = 1.0
        self.col_sample_rate_per_tree = 1.0
        self.mtries = -2
        self.histogram_type = "Exact"


class DT(DRF):
    """One unsampled DRF tree: the greedy decision tree on binned splits."""

    algo_name = "dt"
