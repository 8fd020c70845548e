"""Rapids — frame algebra (``h2o_tpu/rapids/``), the analog of
`water/rapids/`.

The reference evaluates client-submitted Lisp ASTs (`Rapids.exec`,
`water/rapids/Rapids.java:60,86`) over ~200 primitive ops. Here the same
operations are plain Python functions over Vecs/Frames on a torch device;
``exec.Rapids``/``rapids_exec`` evaluate the Lisp strings over them.
"""

from .ops import (binop, cumulative, hist, ifelse, reduce_op, round_digits,
                  signif, table, time_part, unique, unop)
from .groupby import group_by
from .merge import merge, sort
from . import strings
from .exec import Rapids, Session, rapids_exec

__all__ = [
    "binop", "unop", "reduce_op", "cumulative", "ifelse", "table", "unique",
    "hist", "round_digits", "signif", "time_part", "group_by", "merge",
    "sort", "strings", "Rapids", "Session", "rapids_exec",
]
