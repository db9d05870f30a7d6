"""``nn.Module``s: the Mamba-UNet's SS2D mixer, VSS blocks and patch ops,
and the 1-D Mamba mixer and block."""
