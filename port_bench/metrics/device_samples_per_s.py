"""device_samples_per_s: every sample the optimizer stepped on in the
window, over the seconds in which the card ran an operation in that
window (the union of the device's intervals in the profiler's trace of
the whole window): the rate of ``fit`` where the host keeps the card
fed."""

UNIT, SOURCE = "samples/s", "device_trace"


def read(record):
    tr = record.get("trace")
    if not tr or not tr["busy_s"]:
        return None
    return record["samples"] / tr["busy_s"]
