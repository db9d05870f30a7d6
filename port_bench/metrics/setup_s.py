"""setup_s: seconds from the process's start to the window: imports, the
phantom data, the model and its weights, the trainer, the checked steps
and the warm-up (a checkout's first run also builds the kernels)."""

UNIT, SOURCE = "s", "host_clock"


def read(record):
    return record["setup_s"]
