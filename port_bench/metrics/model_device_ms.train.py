"""model_device_ms.train: the device time of every operation the profiler
traced on the card (kernels, copies, fills), per traced step."""

LAYER = "model"
UNIT, SOURCE, MOVES = "ms", "device_trace", "device_samples_per_s"


def read(record):
    tr = record.get("trace")
    if not tr or not tr["device_s"] or not tr["steps"]:
        return None
    return 1e3 * tr["device_s"] / tr["steps"]
