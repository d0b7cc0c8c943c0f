"""The port's models: the paper's CIFAR CNN (``cnn.py``) and the
decoder-only transformer of the model zoo (``transformer.py``, behind
``registry.build_model``)."""
