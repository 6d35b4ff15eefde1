"""Host utilities of the port: run directories, Euler angles, PLY files,
point-cloud volumes and renders, scene visualisation and dataset-prep IO
(numpy copies of the JAX package's ``utils/``; its TPU-only
``platform.py`` has no counterpart)."""
