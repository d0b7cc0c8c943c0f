"""The port's model configs: ``base.CNNConfig`` and the paper's four
CIFAR CNN sizes (``cifar_cnn.CONFIGS``).  The model zoo's configs come
with the model zoo."""
