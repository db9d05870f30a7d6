"""PyTorch + CUDA port of ``mamba_unet_tpu`` for NVIDIA Hopper (H100).

The port mirrors the JAX package's subpackage and module names, so every
file here has one reference file there, and keeps its channels-last
(B, H, W, C) layout at every public function. It imports ``torch`` and never
``jax``. The selective scan runs in hand-written CUDA kernels
(``csrc/selective_scan_bidir_fwd.cu``, ``csrc/selective_scan_bidir_bwd.cu``)
on CUDA tensors and in their plain PyTorch versions on CPU tensors.

This package covers Mamba-UNet serving and fully-supervised training:
``ViM_seg``'s forward and backward, CE + Dice, poly-SGD, the trainer and
its data pipeline, checkpoint/predict helpers, and the train and test
CLIs.
"""
