"""serve_mfu: the operations each answered request requires (conv1,
conv2 and the fc head's forward, from the configuration's shapes), over
the window's seconds (to the last answer) times fp32's peak, in %."""
from portbench import work


def read(run):
    if "answered_ok" not in run.window:
        return None
    ops = work.serve_image_flops(run.cfg) * run.window["answered_ok"]
    return 100.0 * ops / (run.window["seconds"] * work.PEAK_FP32_FLOPS)
