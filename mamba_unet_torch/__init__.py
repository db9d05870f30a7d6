"""PyTorch + CUDA port of ``mamba_unet_tpu`` for NVIDIA Hopper (H100).

The port mirrors the JAX package's subpackage and module names, so every
file here has one reference file there, and keeps its channels-last
(B, H, W, C) layout at every public function. It imports ``torch`` and never
``jax``. The selective scan runs in a hand-written CUDA kernel
(``csrc/selective_scan_bidir_fwd.cu``) on CUDA tensors and in its plain
PyTorch version on CPU tensors.

This package covers Mamba-UNet serving: the no-grad forward of
``ViM_seg``, its checkpoint/predict helpers, and the test CLI.
"""
