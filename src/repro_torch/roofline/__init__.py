"""The port's roofline: per-device op counts of one step (``op_count``),
the three-term H100 roofline (``analysis``) and the dry-run tables
(``report``)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    HW,
    HWSpec,
    RooflineReport,
    active_params,
    model_flops,
    report_from_counts,
)
from repro_torch.roofline.op_count import OpCounter  # noqa: F401
