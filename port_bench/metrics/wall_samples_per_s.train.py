"""wall_samples_per_s.train: the samples of the traced run's untraced
stretch (``fit`` for the run's seconds), over that stretch's host
seconds, the card synchronised at both ends: the rate a user of ``fit``
sees, the host's pace included."""

LAYER = "entry"
UNIT, SOURCE, MOVES = "samples/s", "host_clock", "device_samples_per_s"


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("untraced_steps"):
        return None
    batch = record["samples"] / record["steps"]
    return tr["untraced_steps"] * batch / tr["untraced_s"]
