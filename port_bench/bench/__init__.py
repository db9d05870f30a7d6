"""The harness: finding a cell's files by name, the chip check, the feed
that times the loader, the trace reduction, the correctness check and
the run that ties them together."""
