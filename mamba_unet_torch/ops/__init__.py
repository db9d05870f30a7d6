"""Device ops: the selective scan (kernel + plain version) and cross-scan."""
