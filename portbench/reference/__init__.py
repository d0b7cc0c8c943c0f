"""Plain PyTorch references of the benchmark's models.  They import
nothing of the program (``repro_torch``), of JAX or of the JAX package
(``repro``): ``tests/test_portbench_imports.py`` holds them to that."""
