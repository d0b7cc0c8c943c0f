"""The paper's own CIFAR-10 CNN configs (§5.2), four sizes:
(C1:C2) kernels = 50:500, 150:800, 300:1000, 500:1500."""
from repro_torch.configs.base import CNNConfig

CONFIGS = {
    f"cifar_cnn_{c1}_{c2}": CNNConfig(
        arch_id=f"cifar_cnn_{c1}_{c2}", c1_kernels=c1, c2_kernels=c2
    )
    for c1, c2 in [(50, 500), (150, 800), (300, 1000), (500, 1500)]
}
CONFIG = CONFIGS["cifar_cnn_500_1500"]  # the paper's largest (headline) net
