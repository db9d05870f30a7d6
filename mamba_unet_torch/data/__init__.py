"""Host-side data: the ACDC and BTCV readers, their transforms and the
synthetic phantoms."""
