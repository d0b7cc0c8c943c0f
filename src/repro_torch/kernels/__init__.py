"""Hand-written Hopper kernels of the port (``csrc/``), their wrappers,
and their plain PyTorch versions (``ref.py``)."""
