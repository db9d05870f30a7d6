"""scan_roofline.train: the least time of the traced steps' scan work
(``count/scan.py``: bytes at the HBM rate or operations at the exp and
fp32 rates, each input and output once) over the device time of the
scan kernels, those whose names match :data:`KERNELS`, in %."""

import re

LAYER = "scan kernels"
UNIT, SOURCE, MOVES = "%", "device_trace", "device_samples_per_s"
KERNELS = re.compile(r"(bidir|grouped|folded)_(fwd|bwd)_kernel")


def read(record):
    tr = record.get("trace")
    if not tr or "scan_least_s" not in record:
        return None
    scan_s = sum(v for k, v in tr["op_s"].items() if KERNELS.search(k))
    if not scan_s:
        return None
    return 100.0 * record["scan_least_s"] * tr["steps"] / scan_s
