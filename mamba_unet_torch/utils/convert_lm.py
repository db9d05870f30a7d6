"""Mamba LM weights: JAX (flax) parameters and local HF snapshots.

``params_from_jax_lm`` is the inverse of
``mamba_unet_tpu/utils/convert_lm.py``'s ``lm_torch_key_for`` +
``_transform`` (copied here, not imported: the port does not import the
JAX package). It takes a flax parameter tree flattened to ``"/"``-joined
paths (numpy leaves) of a ``MambaLMHeadModel``, a ``MambaBlock`` or a bare
``Mamba`` and returns the ``state_dict`` of the port's module of the same
kind. Layout transforms (flax -> torch):

  Dense kernel (in, out)         -> Linear weight (out, in)
  conv1d{,_b}_weight (D, W)      -> Conv1d weight (D, 1, W)
  RMSNorm / LayerNorm scale      -> weight (LayerNorm bias -> bias)
  embedding/embedding            -> backbone.embedding.weight
  x_proj, dt_proj, A_log, D (and their ``_b`` mirror set) -> unchanged

``load_hf_snapshot`` builds the port's model from a LOCAL state-spaces
snapshot directory (``config.json`` + ``pytorch_model.bin`` or
``model.safetensors``), the offline leg of upstream ``from_pretrained``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping

import numpy as np
import torch

from mamba_unet_torch.utils.device import require_device

_LAYER = re.compile(r"layers_(\d+)$")
_MIXER_PARAM = re.compile(
    r"(conv1d|x_proj|dt_proj)(_b)?_(weight|bias)$|A(_b)?_log$|D(_b)?$")


def _mixer_key(parts):
    """Path inside a ``Mamba`` -> (port key, kind)."""
    if len(parts) == 2 and parts[0] in ("in_proj", "out_proj"):
        leaf = "weight" if parts[1] == "kernel" else parts[1]
        return f"{parts[0]}.{leaf}", ("linear" if leaf == "weight" else "raw")
    (leaf,) = parts
    hit = _MIXER_PARAM.fullmatch(leaf)
    if hit is None:
        raise KeyError(f"no port parameter for Mamba leaf {leaf!r}")
    if hit.group(1):  # conv1d / x_proj / dt_proj, maybe _b, weight / bias
        mod, tag, kind = hit.group(1), hit.group(2) or "", hit.group(3)
        shape = "conv1d" if (mod, kind) == ("conv1d", "weight") else "raw"
        return f"{mod}{tag}.{kind}", shape
    return leaf, "raw"  # A_log, A_b_log, D, D_b


def _norm_key(leaf):
    return {"scale": "weight", "bias": "bias"}[leaf]


def lm_port_key(path: str):
    """``"/"``-joined flax path -> (port ``state_dict`` key, kind), kind
    one of linear | conv1d | raw."""
    parts = path.split("/")
    head = parts[0]
    if head == "embedding":
        return "backbone.embedding.weight", "raw"
    if head == "norm_f":
        return f"backbone.norm_f.{_norm_key(parts[1])}", "raw"
    hit = _LAYER.match(head)
    if hit:
        key, kind = lm_port_key("/".join(parts[1:]))
        return f"backbone.layers.{hit.group(1)}.{key}", kind
    if head == "norm":
        return f"norm.{_norm_key(parts[1])}", "raw"
    if head == "mixer":
        key, kind = _mixer_key(parts[1:])
        return f"mixer.{key}", kind
    return _mixer_key(parts)


def _transform(value: np.ndarray, kind: str) -> np.ndarray:
    if kind == "linear":
        return value.T
    if kind == "conv1d":  # (D, W) -> (D, 1, W)
        return value[:, None, :]
    return value


def params_from_jax_lm(flat: Mapping[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
    """Flattened flax params -> port ``state_dict`` (fp32 CPU tensors).
    Raises ``KeyError`` for a path with no port key."""
    sd = {}
    for path, value in flat.items():
        key, kind = lm_port_key(path)
        arr = np.array(_transform(np.asarray(value), kind), dtype=np.float32,
                       order="C")  # an owned, writable copy
        sd[key] = torch.from_numpy(arr)
    return sd


def _read_state(path: str) -> Dict[str, torch.Tensor]:
    bin_path = os.path.join(path, "pytorch_model.bin")
    st_path = os.path.join(path, "model.safetensors")
    if os.path.isfile(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    if os.path.isfile(st_path):
        from safetensors.torch import load_file  # optional dependency

        return load_file(st_path)
    raise FileNotFoundError(
        f"no pytorch_model.bin or model.safetensors under {path}")


def load_hf_snapshot(path: str, device="cuda", dtype=None):
    """Build a ``MambaLMHeadModel`` in eval mode from a LOCAL snapshot
    directory and load its weights strictly. Vocabulary rows are
    zero-padded up to the padded vocabulary; a tied ``lm_head.weight`` in
    the file must equal the embedding and is dropped. ``dtype`` is the
    compute dtype (default fp32; the weights load as fp32 either way).
    Runs on the card unless ``device`` asks for the CPU (raises when CUDA
    is asked for and not available)."""
    from mamba_unet_torch.models.mamba_lm import MambaLMHeadModel

    device = require_device(device)
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    ssm_cfg = cfg.get("ssm_cfg", {}) or {}
    model = MambaLMHeadModel(
        vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
        n_layer=cfg["n_layer"], d_state=ssm_cfg.get("d_state", 16),
        rms_norm=cfg.get("rms_norm", True),
        pad_vocab_size_multiple=cfg.get("pad_vocab_size_multiple", 8),
        bimamba_type=ssm_cfg.get("bimamba_type", "none"),
        dtype=torch.float32 if dtype is None else dtype)
    sd = {k: v.float() for k, v in _read_state(path).items()}
    emb = sd["backbone.embedding.weight"]
    head = sd.pop("lm_head.weight", None)
    if head is not None and not torch.equal(head.float(), emb):
        raise ValueError("lm_head.weight is not tied to the embedding")
    pad = model.padded_vocab - emb.shape[0]
    if pad > 0:
        sd["backbone.embedding.weight"] = torch.cat(
            [emb, emb.new_zeros(pad, emb.shape[1])])
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()
