"""PyTorch/CUDA port of the ``repro`` package (the JAX reference).

Mirrors ``repro``'s layout module by module, imports neither jax nor
anything of ``repro``, and runs its entry points on the card unless the
caller asks for the CPU.
"""
