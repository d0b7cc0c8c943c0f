"""The port's models: the paper's CIFAR CNN (``cnn.py``)."""
