"""``calibrate.py`` for the chain CNN cells (mode ``train_chain``): the
same readings, with the faults a training cell on one device can have
(half the batch, a state left unchanged) beside the TF32 control:

    python3 -m portbench.calibrate_chain --workload vgg16_train_gpu \
        --seeds 12 --first-seed <n> --seconds 0 [--faults 3]
"""
from __future__ import annotations

import os
import sys

from portbench import calibrate

FAULTS = ("half_batch", "unchanged")


def main(argv=None) -> int:
    calibrate.FAULTS = dict(calibrate.FAULTS, train_chain=FAULTS)
    return calibrate.main(argv)


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
