"""Evaluation: host-side (numpy/scipy) metrics, slice and sliding-window
3-D volume inference (with MAD's corrupted-label and stacked
validations), and the Mamba-LM loglikelihood evaluator."""

from mamba_unet_torch.eval.inference import (  # noqa: F401
    test_single_volume,
    test_single_volume_mad,
    test_single_volume_stacked,
)
