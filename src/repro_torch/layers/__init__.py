"""Plain PyTorch layers of the port, in the JAX package's layouts
(``repro/layers/``): the CNN's conv, norm and dense layers (NHWC
activations, HWIO kernels), and the model zoo's norms, embedding, mlp,
attention and mamba2."""
