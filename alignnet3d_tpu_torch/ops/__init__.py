"""PyTorch ops of the port: the angle codec, transforms, flip resolution,
and the CUDA kernels with their plain twins."""
