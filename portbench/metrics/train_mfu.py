"""train_mfu: the operations the model requires a step (from the
configuration's shapes: conv1's forward and dW, conv2's forward, dX and
dW, the fc's three products) times the window's steps, over the
window's seconds times fp32's peak, in %."""
from portbench import work


def read(run):
    if "steps" not in run.window:
        return None
    ops = work.train_step_flops(run.cfg, run.cell["batch"]) * run.window["steps"]
    return 100.0 * ops / (run.window["seconds"] * work.PEAK_FP32_FLOPS)
