"""Host-side data: ACDC volume reader and synthetic phantoms."""
