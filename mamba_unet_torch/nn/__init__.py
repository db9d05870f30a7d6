"""``nn.Module``s of the Mamba-UNet: SS2D mixer, VSS blocks, patch ops."""
