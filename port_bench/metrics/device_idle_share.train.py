"""device_idle_share.train: the share of the untraced steps' host
seconds in which no operation ran on the card, in %: 1 - busy / host
time per step, where busy is the union of the device's intervals per
traced step (the device's time does not depend on the host's pace; the
profiler's own cost on the host stays out of the host's time)."""

LAYER = "device"
UNIT, SOURCE, MOVES = "%", "device_trace", "device_samples_per_s"


def read(record):
    tr = record.get("trace")
    if not tr or not tr["busy_s"] or not tr.get("untraced_steps"):
        return None
    busy = tr["busy_s"] / tr["steps"]
    return 100.0 * (1.0 - busy * tr["untraced_steps"] / tr["untraced_s"])
