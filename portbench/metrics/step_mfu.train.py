"""step_mfu.train: the operations a step of the cell's CNN requires
(``work_chain.train_step_flops``, for the paper's CIFAR net as for
VGG-16: every conv's forward and dW, dX but the first conv's, the dense
layers' three products) times the window's steps, over the window's
seconds times fp32's peak, in %."""
from portbench import work, work_chain


def read(run):
    if "steps" not in run.window:
        return None
    ops = work_chain.train_step_flops(run.cfg, run.cell["batch"]) * run.window["steps"]
    return 100.0 * ops / (run.window["seconds"] * work.PEAK_FP32_FLOPS)
