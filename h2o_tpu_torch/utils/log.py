"""Logging facade (``h2o_tpu/utils/log.py``, `water/util/Log.java`):
``info`` and ``warn`` under the ``h2o_tpu_torch`` logger, warnings to
stderr. The reference's in-process ring and its `/3/Logs` route wait for
the REST layer (ROADMAP step K)."""

from __future__ import annotations

import logging
import sys

_LOGGER = logging.getLogger("h2o_tpu_torch")
if not _LOGGER.handlers:
    _stderr = logging.StreamHandler(sys.stderr)
    _stderr.setLevel(logging.WARNING)
    _stderr.setFormatter(logging.Formatter("h2o_tpu_torch %(levelname)s: "
                                           "%(message)s"))
    _LOGGER.addHandler(_stderr)
_LOGGER.setLevel(logging.INFO)


def info(msg: str) -> None:
    _LOGGER.info(msg)


def warn(msg: str) -> None:
    _LOGGER.warning(msg)
