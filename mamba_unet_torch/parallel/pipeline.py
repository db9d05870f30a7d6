"""GPipe pipeline parallelism for the Mamba LM's block stack.

Port of ``mamba_unet_tpu/parallel/pipeline.py``. ``MambaLMHeadModel``'s
body is ``n_layer`` identical pre-norm residual blocks, so the stack maps
onto a ``pipe`` mesh axis as ``n_layer // S`` layers per stage.

Schedule: plain GPipe, as in JAX. With M microbatches over S stages the
tick loop runs ``T = M + S - 1`` ticks; every rank runs its stage every
tick, and the wavefront decides which activations are real: stage ``i``
holds a real microbatch at tick t only for 0 <= t - i < M, and its dead
lanes run on zeros (a known-safe value: a stale activation could
overflow in bf16 and leak NaN into the gradients). A stage's output goes
to the next stage by ``comm.ring_shift`` (an all-gather, which ``gloo``
and ``nccl`` both run on CUDA tensors; ``gloo`` has no point-to-point on
CUDA tensors), and the last stage's outputs are shared to every rank
(``comm.sum_replicated``).
Every rank takes part in every tick's collective, and its graph reaches
every one of them (masks multiply, they do not select), so the backward
runs the same collectives in the same order on every rank: the mirror
schedule, as JAX's autodiff transposes its ``ppermute``.

Gradients follow JAX's global view: after a backward every rank holds
the full gradient of the replicated embedding, norm and tied head, and
of the layers it runs (all layers' with the replicated stack of
:func:`pipeline_lm_apply`'s default, this stage's with
:func:`prestack_lm_params`'s). The blocks run the grouped scan kernels
(``nn/mamba1d.py``) on CUDA tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from mamba_unet_torch.parallel.comm import (
    copy_in,
    ring_shift,
    scatter_in,
    sum_replicated,
)
from mamba_unet_torch.parallel.mesh import Mesh

LAYER_PREFIX = "backbone.layers."


def stack_layer_params(params: Dict[str, torch.Tensor], n_layer: int,
                       prefix: str = LAYER_PREFIX
                       ) -> Dict[str, torch.Tensor]:
    """Stack the per-layer entries ``params[f'{prefix}{i}.{name}']`` into
    ``{name: (n_layer, ...)}``. Differentiable (``torch.stack``), so
    gradients flow back to the per-layer tensors it was built from."""
    names = [k[len(f"{prefix}0."):] for k in params
             if k.startswith(f"{prefix}0.")]
    return {name: torch.stack([params[f"{prefix}{i}.{name}"]
                               for i in range(n_layer)])
            for name in names}


def prestack_lm_params(state_dict: Dict[str, torch.Tensor], n_layer: int,
                       mesh: Mesh, axis: str = "pipe",
                       prefix: str = LAYER_PREFIX
                       ) -> Tuple[Dict[str, torch.Tensor],
                                  Dict[str, nn.Parameter]]:
    """The production layout for :func:`pipeline_lm_apply`: split an LM
    state dict into ``(nonlayer_state_dict, stage_stack)``, where
    ``stage_stack`` holds only this stage's ``n_layer // S`` layers, each
    entry one ``nn.Parameter`` with a leading layer axis (trainable: its
    gradients stay on this stage); the embedding and the final norm stay
    in ``nonlayer_state_dict``."""
    layer_keys = {k for k in state_dict
                  if any(k.startswith(f"{prefix}{i}.")
                         for i in range(n_layer))}
    missing = [i for i in range(n_layer)
               if not any(k.startswith(f"{prefix}{i}.") for k in layer_keys)]
    if missing:
        raise ValueError(f"state dict misses layers {missing}")
    S, idx = mesh.shape[axis], mesh.index(axis)
    if n_layer % S:
        raise ValueError(f"n_layer={n_layer} not divisible by S={S}")
    per = n_layer // S
    stack = stack_layer_params(state_dict, n_layer, prefix)
    stage = {name: nn.Parameter(t[idx * per:(idx + 1) * per].detach()
                                .clone())
             for name, t in stack.items()}
    nonlayer = {k: v for k, v in state_dict.items() if k not in layer_keys}
    return nonlayer, stage


def pipeline_blocks(block_apply: Callable, stage_params: Dict[str,
                                                              torch.Tensor],
                    x_mb: torch.Tensor, mesh: Mesh, axis: str = "pipe"
                    ) -> torch.Tensor:
    """Run microbatches through a pipelined stack of identical blocks.

    Args:
      block_apply: ``f(layer_params, h) -> h`` applying ONE block.
      stage_params: this stage's layers, every entry with a leading layer
        axis of ``n_layer // S`` (:func:`prestack_lm_params`, or this
        stage's slice of :func:`stack_layer_params`).
      x_mb: ``(M, mb, ...)`` microbatched activations, replicated (they
        are consumed on stage 0).
      mesh: mesh with a pipeline axis named ``axis`` of size S.

    Returns ``(M, mb, ...)`` outputs of the whole stack, replicated.
    """
    group = mesh.group(axis)
    S, idx = mesh.shape[axis], mesh.index(axis)
    per = next(iter(stage_params.values())).shape[0]
    M = x_mb.shape[0]
    T = M + S - 1
    first = 1.0 if idx == 0 else 0.0
    last = 1.0 if idx == S - 1 else 0.0
    x_all = copy_in(x_mb, group)

    def run_stage(h):
        for k in range(per):
            h = block_apply({n: p[k] for n, p in stage_params.items()}, h)
        return h

    h_recv = torch.zeros_like(x_mb[0])
    outs = [None] * M
    for t in range(T):
        live = 1.0 if 0 <= t - idx < M else 0.0
        # stage 0 reads microbatch t, the others what the previous stage
        # sent; masks multiply, so every rank's graph reaches every input
        h = (first * x_all[min(t, M - 1)] + (1.0 - first) * h_recv) * live
        y = run_stage(h)
        out_t = t - (S - 1)
        if out_t >= 0:  # the last stage's output is microbatch out_t's
            outs[out_t] = last * y
        if t + 1 < T:
            h_recv = ring_shift(y, group)
    return sum_replicated(torch.stack(outs), group)


def _microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    return x.reshape((n_micro, B // n_micro) + x.shape[1:])


def pipeline_lm_apply(model, input_ids: torch.Tensor, mesh: Mesh,
                      axis: str = "pipe", n_micro: int = 4,
                      deterministic: bool = True,
                      stacked: Optional[Dict[str, torch.Tensor]] = None
                      ) -> torch.Tensor:
    """``MambaLMHeadModel.forward`` with the block stack pipelined over
    ``axis``: the same per-layer math (microbatching only re-batches the
    rows); returns fp32 logits ``(B, L, padded_vocab)``.

    ``stacked``: this stage's layers from :func:`prestack_lm_params` (the
    model then needs only its embedding and final norm); by default the
    model's own per-layer parameters are stacked and this stage takes its
    slice (differentiably: every rank gets every layer's gradient).

    ``deterministic`` must stay True: the pipelined blocks run without
    dropout, as in JAX."""
    if not deterministic:
        raise ValueError(
            "pipeline_lm_apply only supports deterministic=True - the "
            "pipelined block stack runs without dropout")
    group = mesh.group(axis)
    n_layer = len(model.backbone.layers)
    if stacked is None:
        params = {k: v for k, v in model.named_parameters()
                  if k.startswith(LAYER_PREFIX)}
        stacked = {k: scatter_in(v, 0, group) for k, v in
                   stack_layer_params(params, n_layer).items()}
    block = model.backbone.layers[0]
    h = model._embed(input_ids)
    y_mb = pipeline_blocks(
        lambda p, hh: functional_call(block, p, (hh,)), stacked,
        _microbatch(h, n_micro), mesh, axis)
    return model._head(y_mb.reshape((-1,) + y_mb.shape[2:]))


def pipeline_lm_loss(model, input_ids: torch.Tensor, targets: torch.Tensor,
                     mesh: Mesh, axis: str = "pipe", n_micro: int = 4,
                     stacked: Optional[Dict[str, torch.Tensor]] = None
                     ) -> torch.Tensor:
    """Mean next-token cross-entropy through the pipelined forward;
    differentiable (the backward pipeline is autograd's reverse of the
    tick loop)."""
    logits = pipeline_lm_apply(model, input_ids, mesh, axis, n_micro,
                               stacked=stacked)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))
