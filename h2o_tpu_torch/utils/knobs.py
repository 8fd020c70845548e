"""Registry of every ``H2O_TORCH_*`` environment knob of the port.

The same discipline as the reference's ``h2o_tpu/utils/knobs.py``: a knob is
declared here with its type, default and a one-line doc string, reads stay
dynamic (``os.environ`` at call time), and every accessor raises
``KeyError`` for an undeclared name so a knob cannot ship without its
registry line.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    kind: str           # only "int" so far
    default: object
    doc: str


KNOBS: dict[str, Knob] = {}


def _knob(name: str, kind: str, default, doc: str) -> None:
    KNOBS[name] = Knob(name, kind, default, doc)


_knob("H2O_TORCH_CHECKPOINT_SECS", "int", 600,
      "wall-clock floor in seconds between auto-recovery state writes of "
      "a training job; 0 writes at every chunk boundary "
      "(backend/persist.py TrainingRecovery)")
_knob("H2O_TORCH_EXACT_BIN_ROWS", "int", 16384,
      "padded rows at or below which tree binning may use exact "
      "small-data cuts (models/tree/binning.py)")
_knob("H2O_TORCH_HIST_SEG_WIDTH", "int", 8,
      "bin widths at/below this form segment-sum buckets in "
      "plan_hist_groups (models/tree/engine.py)")
_knob("H2O_TORCH_MAX_FRAME_BYTES", "int", 60 * 1024 ** 3,
      "refuse parses whose float32 device frame would exceed this "
      "(io/parser.py; the FrameSizeMonitor of `h2o_tpu/io/parser.py:115`)")


def _declared(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(f"undeclared knob {name!r} — declare it in "
                       f"h2o_tpu_torch/utils/knobs.py") from None


def get_int(name: str) -> int:
    k = _declared(name)
    v = os.environ.get(name)
    return int(k.default) if v is None or v.strip() == "" else int(v)

