"""Shape arithmetic: the FLOPs of a training step and the least time of
its scans, counted on the plain reference at the cell's shapes, so the
count is the same whatever implements the work."""
