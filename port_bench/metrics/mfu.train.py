"""mfu.train: the FLOPs of a step (counted on the plain reference at the
cell's shapes, ``count/step.py``) times the traced steps, over the
seconds in which the card was busy in them times its dense bf16 peak,
in %: the whole step's share of the peak, which bounds
``device_samples_per_s`` as the kernels' rooflines bound their parts."""

from port_bench.count.peaks import BF16_FLOP_PER_S

LAYER = "model"
UNIT, SOURCE, MOVES = "%", "device_trace", "device_samples_per_s"


def read(record):
    tr = record.get("trace")
    if not tr or not tr["busy_s"] or "flops" not in record:
        return None
    return 100.0 * record["flops"] * tr["steps"] / (
        tr["busy_s"] * BF16_FLOP_PER_S)
