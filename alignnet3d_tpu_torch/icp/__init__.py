"""Registration refinement on PyTorch: constrained point-to-point ICP."""
