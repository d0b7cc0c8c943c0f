"""Plain PyTorch layers of the paper's CNN, NHWC activations and HWIO
kernels as in the JAX package (``repro/layers/``)."""
