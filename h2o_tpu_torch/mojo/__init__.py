"""MOJO support (``h2o_tpu/mojo/``): only the GAM spline bases so far
(``format.py``); the tree codec, ``model.ini`` and the zip reader and
writer are ROADMAP Queue 1 item 10."""
