"""MOJO import and export (``h2o_tpu/mojo/``): the `h2o-genmodel` role, a
standalone scoring format in the reference's zip layout. ``format.py``
holds the tree bytecode, ``model.ini``, the zip reader and writer and the
GAM spline bases; ``reader.py`` the host numpy scorer of every MOJO kind;
``writer.py`` and ``pojo.py`` the export of the port's models; ``easy.py``
the row-at-a-time wrapper."""

from .format import decode_tree, encode_tree, score_tree
from .pojo import export_pojo, pojo_source
from .reader import MojoModel
from .writer import export_mojo

__all__ = ["MojoModel", "export_mojo", "export_pojo", "pojo_source",
           "encode_tree", "decode_tree", "score_tree"]
