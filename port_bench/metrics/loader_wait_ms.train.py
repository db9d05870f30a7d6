"""loader_wait_ms.train: the mean time per step that ``fit`` waits in
``next()`` on the feed for its batch (the loader's thread, its
prefetch and the copy to the card), over the untraced steps of the
traced run."""

LAYER = "loader"
UNIT, SOURCE, MOVES = "ms", "host_clock", "device_samples_per_s"


def read(record):
    waits = record.get("trace", {}).get("loader_waits")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
