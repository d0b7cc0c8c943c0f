"""plan_cpu_kernel_fraction.train: the share of the widest conv layer's
kernels (conv2's) that the training plans of the traced window put on
devices whose backend is not ``cuda``, from the program's
``cluster.plan`` spans (labels ``units`` and ``cpu_units``): the mean
over the plans with the most units, in %.  None for a program without
the span."""


def read(run):
    try:
        import repro_torch.core.spans as spans
    except ImportError:
        return None
    planned = [s.attrs for s in spans.spans()
               if s.name == "cluster.plan" and s.attrs.get("units")]
    if not planned:
        return None
    widest = max(a["units"] for a in planned)
    shares = [a["cpu_units"] / a["units"] for a in planned if a["units"] == widest]
    return 100.0 * sum(shares) / len(shares)
