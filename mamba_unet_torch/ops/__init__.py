"""Device ops: the selective scans (kernels + plain versions), cross-scan,
causal conv1d and the decode state update."""
