"""conv_fwd_roofline: K1 through CudaBackend.conv, each call's bound
(2*B*H*W*k*k*Cin*Cout operations at fp32's peak, or its bytes at HBM's
rate, the larger) over the kernel time launched inside the call, in %."""
from portbench import readers


def read(run):
    return readers.roofline_pct(run, "conv")
