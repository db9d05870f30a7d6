"""Mamba language model and generation.

Port of ``mamba_unet_tpu/models/mamba_lm.py`` (the reference's
``mixer_seq_simple.py``: embedding -> n x Block -> norm_f -> tied lm_head,
vocab padded to a multiple of 8; ``generation.py``'s top-k / top-p /
temperature sampling and decode loop). The modules carry upstream's names
(``backbone.embedding``, ``backbone.layers.{i}.{norm,mixer}``,
``backbone.norm_f``), so a state-spaces checkpoint loads by key; the head
is the embedding matrix itself, so the model has no ``lm_head.weight``.
``dtype`` is the compute dtype (the JAX model's ``dtype``): the parameters
stay fp32, the embedding's output, the residual stream and each
projection run in it (bf16: the scan kernel gets bf16 inputs with its
fp32 state), the norms compute in fp32, and the logits are fp32.

Where the JAX package compiles prefill and the whole decode loop into one
program, :func:`generate` runs a prefill and then a Python loop of
:meth:`MambaLMHeadModel.decode_step` under ``torch.inference_mode``. The
prefill scans with the CUDA kernel (24 launches at mamba-130m); the decode
step is plain tensor ops. :class:`SeededGenerate` is the same loop as one
module of ``(input_ids, seed)``, unrolled, whose sampling noise is a
function of the seed (no ``torch.Generator``): the module that
``utils.export.export_lm_generate`` exports.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.nn.mamba1d import NORM_EPS, MambaBlock, check_dtype


class MixerModel(nn.Module):
    """The LM's backbone (upstream ``MixerModel``): its parameters only; the
    LM runs them."""

    def __init__(self, padded_vocab: int, d_model: int, n_layer: int,
                 d_state: int, rms_norm: bool, bimamba_type: str, *,
                 device=None, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding = nn.Embedding(padded_vocab, d_model, device=device)
        with torch.no_grad():
            self.embedding.weight.copy_(0.02 * torch.randn(
                padded_vocab, d_model, generator=generator))
        self.layers = nn.ModuleList(
            MambaBlock(d_model, d_state, bimamba_type, rms_norm,
                       device=device, generator=generator, dtype=dtype)
            for _ in range(n_layer))
        norm_cls = nn.RMSNorm if rms_norm else nn.LayerNorm
        self.norm_f = norm_cls(d_model, eps=NORM_EPS, device=device)


class MambaLMHeadModel(nn.Module):
    def __init__(self, vocab_size: int, d_model: int = 768, n_layer: int = 24,
                 d_state: int = 16, rms_norm: bool = True,
                 pad_vocab_size_multiple: int = 8,
                 bimamba_type: str = "none", *, device=None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.vocab_size = vocab_size
        m = pad_vocab_size_multiple
        self.padded_vocab = -(-vocab_size // m) * m
        self.backbone = MixerModel(self.padded_vocab, d_model, n_layer,
                                   d_state, rms_norm, bimamba_type,
                                   device=device, generator=generator,
                                   dtype=dtype)

    def _embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.backbone.embedding(input_ids).to(self.dtype)

    def _head(self, hidden):
        # tied lm_head: logits = h @ E^T (mixer_seq_simple.py:231-233)
        bb = self.backbone
        h = bb.norm_f(hidden.float()).to(self.dtype)
        return F.linear(h, bb.embedding.weight.to(self.dtype)).float()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, L) -> fp32 logits (B, L, padded_vocab)."""
        h = self._embed(input_ids)
        for blk in self.backbone.layers:
            h = blk(h)
        return self._head(h)

    def prefill(self, input_ids: torch.Tensor):
        """(B, L) -> (last-token logits (B, V), caches: one
        (conv_state, ssm_state) per layer)."""
        h = self._embed(input_ids)
        caches = []
        for blk in self.backbone.layers:
            h, conv_state, ssm_state = blk.forward_with_cache(h)
            caches.append((conv_state, ssm_state))
        return self._head(h[:, -1:])[:, 0], tuple(caches)

    def decode_step(self, token: torch.Tensor, caches):
        """token (B,) + caches -> (logits (B, V), new caches)."""
        h = self._embed(token[:, None])
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


_MASK31 = 0x7FFFFFFF


def _mix31(x: torch.Tensor) -> torch.Tensor:
    """An integer hash of int64 values in [0, 2^31) into [0, 2^31); every
    product stays below 2^62, so no platform's int64 overflows."""
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & _MASK31
    x = ((x ^ (x >> 12)) * 0x297A2D39) & _MASK31
    return x ^ (x >> 15)


def gumbel_noise(seed: torch.Tensor, step: int, shape, device
                 ) -> torch.Tensor:
    """Counter-based Gumbel(0, 1) noise of ``shape`` (B, V), fp32: a hash
    of (``seed``, ``step``, the element's index), a function of the seed
    alone, so a traced graph computes it from its ``seed`` input."""
    key = _mix31((seed.long() & _MASK31) ^ ((step * 0x3C6EF35F) & _MASK31))
    idx = torch.arange(shape[0] * shape[1], device=device).reshape(shape)
    bits = _mix31((_mix31(idx & _MASK31) + key) & _MASK31)
    u = (bits.float() + 0.5) * (1.0 / 2 ** 31)
    return -torch.log(-torch.log(u))


def sample_token_seeded(logits: torch.Tensor, seed: torch.Tensor, step: int,
                        temperature: float = 1.0, top_k: int = 1,
                        top_p: float = 0.0) -> torch.Tensor:
    """:func:`sample_token` with the categorical draw taken as the argmax
    of the filtered logits plus :func:`gumbel_noise` (the Gumbel-max
    trick); ``top_k=1`` is greedy and draws nothing."""
    if top_k == 1:
        return logits.argmax(dim=-1)
    filtered = filter_logits(logits.float(), temperature, top_k, top_p)
    noise = gumbel_noise(seed, step, filtered.shape, filtered.device)
    return (filtered + noise).argmax(dim=-1)


class SeededGenerate(nn.Module):
    """``(input_ids (B, L) int64, seed () int64) -> (B, L +
    max_new_tokens)``: prefill, then ``max_new_tokens - 1`` decode steps
    unrolled, each token drawn by :func:`sample_token_seeded` with the
    sampling settings fixed. Call it under ``torch.no_grad()`` (or
    ``inference_mode``), as ``utils.export.export_lm_generate`` traces it.
    Greedy (``top_k=1``, the default) gives :func:`generate`'s tokens."""

    def __init__(self, model: MambaLMHeadModel, max_new_tokens: int,
                 temperature: float = 1.0, top_k: int = 1,
                 top_p: float = 0.0):
        super().__init__()
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        self.model = model
        self.max_new_tokens = max_new_tokens
        self.sampling = dict(temperature=temperature, top_k=top_k,
                             top_p=top_p)

    def forward(self, input_ids: torch.Tensor, seed: torch.Tensor
                ) -> torch.Tensor:
        logits, caches = self.model.prefill(input_ids)
        token = sample_token_seeded(logits, seed, 0, **self.sampling)
        new = [token]
        for step in range(1, self.max_new_tokens):
            logits, caches = self.model.decode_step(token, caches)
            token = sample_token_seeded(logits, seed, step, **self.sampling)
            new.append(token)
        return torch.cat([input_ids, torch.stack(new, dim=1)], dim=1)
