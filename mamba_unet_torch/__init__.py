"""PyTorch + CUDA port of ``mamba_unet_tpu`` for NVIDIA Hopper (H100).

The port mirrors the JAX package's subpackage and module names, so every
file here has one reference file there, and keeps its layouts at every
public function (channels-last (B, H, W, C) images, (B, L, d_model)
sequences, (B, D, L) for ``ops/selective_scan.py``). It imports ``torch``
and never ``jax``. The selective scan runs in hand-written CUDA kernels
(``csrc/selective_scan_bidir_fwd.cu``, ``csrc/selective_scan_bidir_bwd.cu``,
``csrc/selective_scan_fwd.cu``) on CUDA tensors and in their plain PyTorch
versions on CPU tensors.

This package covers Mamba-UNet serving and fully-supervised training:
``ViM_seg``'s forward and backward, CE + Dice, poly-SGD, the trainer and
its data pipeline, checkpoint/predict helpers, and the train and test
CLIs; and Mamba-LM serving: the 1-D Mamba stack (``nn/mamba1d.py``), the
LM with prefill, decode and ``generate`` (``models/mamba_lm.py``), the
loglikelihood evaluator (``eval/lm_eval.py``) and its weight loaders
(``utils/convert_lm.py``).
"""
