"""Mamba language model and generation.

Port of ``mamba_unet_tpu/models/mamba_lm.py`` (the reference's
``mixer_seq_simple.py``: embedding -> n x Block -> norm_f -> tied lm_head,
vocab padded to a multiple of 8; ``generation.py``'s top-k / top-p /
temperature sampling and decode loop). The modules carry upstream's names
(``backbone.embedding``, ``backbone.layers.{i}.{norm,mixer}``,
``backbone.norm_f``), so a state-spaces checkpoint loads by key; the head
is the embedding matrix itself, so the model has no ``lm_head.weight``.

Where the JAX package compiles prefill and the whole decode loop into one
program, :func:`generate` runs a prefill and then a Python loop of
:meth:`MambaLMHeadModel.decode_step` under ``torch.inference_mode``. The
prefill scans with the CUDA kernel (24 launches at mamba-130m); the decode
step is plain tensor ops.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.nn.mamba1d import NORM_EPS, MambaBlock


class MixerModel(nn.Module):
    """The LM's backbone (upstream ``MixerModel``): its parameters only; the
    LM runs them."""

    def __init__(self, padded_vocab: int, d_model: int, n_layer: int,
                 d_state: int, rms_norm: bool, bimamba_type: str, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = nn.Embedding(padded_vocab, d_model, device=device)
        with torch.no_grad():
            self.embedding.weight.copy_(0.02 * torch.randn(
                padded_vocab, d_model, generator=generator))
        self.layers = nn.ModuleList(
            MambaBlock(d_model, d_state, bimamba_type, rms_norm,
                       device=device, generator=generator)
            for _ in range(n_layer))
        norm_cls = nn.RMSNorm if rms_norm else nn.LayerNorm
        self.norm_f = norm_cls(d_model, eps=NORM_EPS, device=device)


class MambaLMHeadModel(nn.Module):
    def __init__(self, vocab_size: int, d_model: int = 768, n_layer: int = 24,
                 d_state: int = 16, rms_norm: bool = True,
                 pad_vocab_size_multiple: int = 8,
                 bimamba_type: str = "none", *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab_size = vocab_size
        m = pad_vocab_size_multiple
        self.padded_vocab = -(-vocab_size // m) * m
        self.backbone = MixerModel(self.padded_vocab, d_model, n_layer,
                                   d_state, rms_norm, bimamba_type,
                                   device=device, generator=generator)

    def _head(self, hidden):
        # tied lm_head: logits = h @ E^T (mixer_seq_simple.py:231-233)
        bb = self.backbone
        return F.linear(bb.norm_f(hidden), bb.embedding.weight).float()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, L) -> fp32 logits (B, L, padded_vocab)."""
        h = self.backbone.embedding(input_ids)
        for blk in self.backbone.layers:
            h = blk(h)
        return self._head(h)

    def prefill(self, input_ids: torch.Tensor):
        """(B, L) -> (last-token logits (B, V), caches: one
        (conv_state, ssm_state) per layer)."""
        h = self.backbone.embedding(input_ids)
        caches = []
        for blk in self.backbone.layers:
            h, conv_state, ssm_state = blk.forward_with_cache(h)
            caches.append((conv_state, ssm_state))
        return self._head(h[:, -1:])[:, 0], tuple(caches)

    def decode_step(self, token: torch.Tensor, caches):
        """token (B,) + caches -> (logits (B, V), new caches)."""
        h = self.backbone.embedding(token[:, None])
        new = []
        for blk, (conv_state, ssm_state) in zip(self.backbone.layers, caches):
            h, conv_state, ssm_state = blk.step(h, conv_state, ssm_state)
            new.append((conv_state, ssm_state))
        return self._head(h)[:, 0], tuple(new)


def filter_logits(logits: torch.Tensor, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """Temperature, then top-k, then top-p (the smallest set whose
    probability reaches ``top_p``) masking to -inf (generation.py:39-91)."""
    logits = logits / max(temperature, 1e-6)
    if top_k > 0:
        kth = logits.sort(dim=-1).values[:, -top_k, None]
        logits = logits.masked_fill(logits < kth, -torch.inf)
    if top_p > 0.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        cum = sorted_logits.softmax(dim=-1).cumsum(dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(
            max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, -torch.inf)
    return logits


def sample_token(logits, temperature=1.0, top_k=1, top_p=0.0,
                 generator: Optional[torch.Generator] = None):
    """Next tokens (B,) from logits (B, V); ``top_k=1`` is greedy. Random
    draws come from ``generator`` (on the logits' device)."""
    if top_k == 1:
        return logits.argmax(dim=-1)
    probs = filter_logits(logits, temperature, top_k, top_p).softmax(dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(model: MambaLMHeadModel, input_ids: torch.Tensor,
             max_new_tokens: int = 20, temperature: float = 1.0,
             top_k: int = 1, top_p: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Prefill, then ``max_new_tokens - 1`` decode steps. Returns
    (B, L + max_new_tokens) token ids on the model's device. Without a
    ``generator``, sampling draws from one seeded with 0."""
    dev = model.backbone.embedding.weight.device
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    with torch.inference_mode():
        ids = input_ids.to(dev)
        logits, caches = model.prefill(ids)
        token = sample_token(logits, temperature, top_k, top_p, generator)
        new = [token]
        for _ in range(max_new_tokens - 1):
            logits, caches = model.decode_step(token, caches)
            token = sample_token(logits, temperature, top_k, top_p, generator)
            new.append(token)
        return torch.cat([ids, torch.stack(new, dim=1)], dim=1)
