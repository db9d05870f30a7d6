"""Host-side (numpy/scipy) evaluation: metrics and volume inference."""
