"""step_mfu_resnet.train: the operations the window's images require by
``work_resnet.image_flops`` (every conv's forward and dW at its
published stride, dX but conv1's, the fc's three products: 22.9 G an
image of ResNet-50), over the window's seconds times fp32's peak, in %.
None for a configuration without bottleneck stages."""
from portbench import work, work_resnet


def read(run):
    if "stages" not in run.cfg or not run.window.get("images"):
        return None
    ops = work_resnet.image_flops(run.cfg) * run.window["images"]
    return 100.0 * ops / (run.window["seconds"] * work.PEAK_FP32_FLOPS)
