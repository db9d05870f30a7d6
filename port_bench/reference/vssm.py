"""``ViM_seg``: Mamba-UNet (Wang et al., arXiv:2402.05079), the VSSM
encoder and decoder of :mod:`port_bench.reference.net` under the prefix
``mamba_unet.``, ending in a 1x1 convolution to the classes without a
bias. A grey input is repeated to 3 channels."""

from __future__ import annotations

import torch

from port_bench.reference.net import Net, Spec, _conv, _decoder, _encoder

PREFIX = "mamba_unet."


def param_spec(cfg: dict) -> Spec:
    spec: Spec = []
    _encoder(spec, PREFIX, cfg, 3 if cfg["in_chans"] == 1 else cfg["in_chans"])
    _decoder(spec, PREFIX, cfg)
    _conv(spec, f"{PREFIX}output", cfg["dims"][0], cfg["num_classes"], 1,
          bias=False)
    return spec


def forward(net: Net, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, in_chans) -> logits (B, H, W, classes)."""
    x = net.decode(net.encode(x, PREFIX), PREFIX)
    return net.prec.linear(x, net.P[f"{PREFIX}output.weight"].flatten(1))
