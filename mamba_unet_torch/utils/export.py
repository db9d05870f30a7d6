"""Serving: the predict function of a model, and its ``torch.export``
artifact; the Mamba LM's whole generation as one artifact.

Port of ``make_predict_fn``, ``export_predict``, ``export_lm_generate``,
``save_exported`` and ``load_exported`` from
``mamba_unet_tpu/utils/export.py``. Both keep that
module's ABI: (B, H, W, C) fp32 images in, (B, H, W, classes) fp32 logits
of the main head out, whatever the compute dtype (:class:`Predictor`).

The artifact is a ``torch.export.ExportedProgram`` saved as one ``.pt2``
file: it carries the graph and the weights, and loading it needs no model
code or checkpoint. It does need ``mamba_unet_torch.ops`` imported, since
the scan kernels are custom ops (``torch.ops.mamba_unet.*``) that the graph
calls by name: the kernels are not inside the artifact, and
:func:`load_exported` imports the package before it loads. A string batch
exports a symbolic batch dimension, so one artifact serves any batch of 2
to 65535. The JAX function's ``platforms`` (its TPU lowering) has no
counterpart: a program runs on the device it was exported on.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn


# the largest symbolic batch: cuDNN's convolutions take at most 65535
# images per call, a bound the exporter finds on the card (the UNet family)
MAX_BATCH = 65535


class Predictor(nn.Module):
    """The predict ABI as a module: (B, H, W, C) images -> fp32 logits of
    the main head (multi-head models give their first output), under no
    grad; ``dtype=torch.bfloat16`` runs the model under bf16 autocast
    (weights stay fp32, the scan state stays fp32)."""

    def __init__(self, model: nn.Module, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported serving dtype {dtype}")
        self.model = model
        self.bf16 = dtype == torch.bfloat16

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), torch.autocast(x.device.type, torch.bfloat16,
                                             enabled=self.bf16):
            out = self.model(x.float())
        out = out[0] if isinstance(out, (tuple, list)) else out
        return out.float()


def make_predict_fn(model: nn.Module, dtype: Optional[torch.dtype] = None
                    ) -> Callable[[np.ndarray], np.ndarray]:
    """``(B, H, W, C) fp32 -> (B, H, W, classes) fp32`` logits.

    Accepts a numpy array or a tensor and returns the same kind. Runs
    :class:`Predictor` under ``torch.inference_mode()`` in eval mode on the
    model's device."""
    predictor = Predictor(model.eval(), dtype)
    device = next(model.parameters()).device

    def predict(x):
        as_numpy = isinstance(x, np.ndarray)
        xt = torch.as_tensor(x, dtype=torch.float32, device=device)
        with torch.inference_mode():
            out = predictor(xt)
        return out.cpu().numpy() if as_numpy else out

    return predict


def export_predict(model: nn.Module, patch_size, in_channels: int = 1,
                   batch: Union[int, str] = "b",
                   dtype: Optional[torch.dtype] = None
                   ) -> torch.export.ExportedProgram:
    """Export ``model``'s :class:`Predictor` (eval mode, on the model's
    device) for (batch, *patch_size, in_channels) fp32 images.

    ``batch``: an int pins the batch dimension; a string (default ``"b"``)
    names a symbolic one, from 2 to MAX_BATCH, so the artifact serves any
    batch in that range.
    ``dtype=torch.bfloat16`` exports bf16 serving."""
    device = next(model.parameters()).device
    symbolic = isinstance(batch, str)
    example = torch.zeros(2 if symbolic else int(batch), *patch_size,
                          in_channels, device=device)
    dynamic = ({0: torch.export.Dim(batch, min=2, max=MAX_BATCH)},
               ) if symbolic else None
    # a guard on the batch that the exporter cannot prove (e.g. a stride
    # order such as min(192 b, 10752 b) == 192 b on the folded branch)
    # becomes an assert checked at run time instead of failing the export
    return torch.export.export(
        Predictor(model.eval(), dtype), (example,), dynamic_shapes=dynamic,
        prefer_deferred_runtime_asserts_over_guards=True)


def export_lm_generate(model: nn.Module, prompt_len: int,
                       max_new_tokens: int, batch: Union[int, str] = "b",
                       temperature: float = 1.0, top_k: int = 1,
                       top_p: float = 0.0) -> torch.export.ExportedProgram:
    """Export ``model``'s (a ``MambaLMHeadModel``, on its device) prefill
    and ``max_new_tokens - 1`` unrolled decode steps as one artifact:
    ``tokens (b, prompt_len + max_new_tokens) = f(input_ids (b,
    prompt_len) int64, seed () int64)``
    (``models.mamba_lm.SeededGenerate``). The sampling settings are fixed
    in the graph; the sampling noise is derived inside it from ``seed``
    (greedy, ``top_k=1``, the default, draws none). The prefill's scans
    are the custom ops ``torch.ops.mamba_unet.*``. ``batch`` as in
    :func:`export_predict`, from 1 to MAX_BATCH when symbolic. The JAX
    function takes a uint32 seed; this one an int64 (its low 31 bits)."""
    from mamba_unet_torch.models.mamba_lm import SeededGenerate

    device = model.backbone.embedding.weight.device
    symbolic = isinstance(batch, str)
    ids = torch.zeros(2 if symbolic else int(batch), int(prompt_len),
                      dtype=torch.long, device=device)
    seed = torch.zeros((), dtype=torch.long, device=device)
    dynamic = ({0: torch.export.Dim(batch, min=1, max=MAX_BATCH)}, None
               ) if symbolic else None
    # traced under no grad: the graph holds no autograd
    with torch.no_grad():
        return torch.export.export(
            SeededGenerate(model.eval(), max_new_tokens, temperature, top_k,
                           top_p), (ids, seed), dynamic_shapes=dynamic,
            prefer_deferred_runtime_asserts_over_guards=True)


def save_exported(exported: torch.export.ExportedProgram, path: str) -> str:
    """Write the artifact (``torch.export.save``); returns ``path``."""
    torch.export.save(exported, path)
    return path


def load_exported(path: str) -> torch.export.ExportedProgram:
    """Read an artifact written by :func:`save_exported`, after importing
    ``mamba_unet_torch.ops`` so that its custom ops exist. Call it as
    ``loaded.module()(images)`` (an LM generation artifact:
    ``loaded.module()(input_ids, seed)``, under ``torch.no_grad()``)."""
    import mamba_unet_torch.ops  # noqa: F401  (registers the custom ops)

    return torch.export.load(path)
