"""device_idle_share: the share of the traced window in which no kernel,
copy or set ran on the card (overlaps counted once), in %."""
from portbench import readers


def read(run):
    return readers.idle_pct(run)
