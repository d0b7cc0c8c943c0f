"""conv_bwd_roofline.train: K2 + K3 through CudaBackend.conv_vjp, each
call's bound (dX's plus dW's) over the kernel time launched inside the
call, in %."""
from portbench import readers


def read(run):
    return readers.roofline_pct(run, "conv_vjp")
