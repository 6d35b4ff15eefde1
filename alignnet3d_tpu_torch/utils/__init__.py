"""Host utilities of the port: run directories, Euler angles, PLY files and
point-cloud volumes and renders (numpy copies of the JAX package's
``utils/``; its TPU-only ``platform.py`` has no counterpart)."""
