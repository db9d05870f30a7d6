"""JAX (flax) -> port parameter conversion, and the upstream warm start.

``params_from_jax`` is the inverse of ``mamba_unet_tpu/utils/convert.py``'s
``torch_key_for`` + ``_transform``: it takes a flax parameter tree flattened
to ``"/"``-joined paths (numpy leaves), and optionally the ``batch_stats``
collection flattened the same way, and returns a ``state_dict`` for the
port's module with the same structure. It works for the whole ``MambaUnet``
(flax root ``vssm`` -> ``mamba_unet``), ``SwinUnet`` (``swin_unet``), the
UNet family (``encoder``, ``decoder``, ``main_decoder``,
``aux_decoder{i}``, ``mask_encoder``, ``mask_decoder``; ``in_conv``,
``down{i}`` -> ``down{i}.maxpool_conv.1``, ``up{i}``, ``out_conv``,
``out_conv_dp{k}``; a conv block's ``Conv_0``, ``BatchNorm_0``, ``Conv_1``,
``BatchNorm_1`` -> ``conv_conv.{0,1,4,5}``) and any of their submodules.
The key map lives here, so the port does not import the JAX package.

Layout transforms (flax -> torch):
  Dense kernel (in, out)              -> Linear weight (out, in)
  Conv kernel (kh, kw, in, out)       -> Conv2d weight (out, in, kh, kw)
  depthwise (kh, kw, 1, C)            -> (C, 1, kh, kw)
  ConvTranspose kernel (kh, kw, in, out), the module ``up`` of an UpBlock
                                      -> ConvTranspose2d weight
                                         (in, out, kh, kw), flipped in kh
                                         and kw (flax applies the kernel
                                         unflipped, torch flipped)
  LayerNorm / BatchNorm scale, bias   -> weight / bias
  BatchNorm batch_stats mean, var     -> running_mean / running_var, with
                                         num_batches_tracked set
  SS2D raw params (x_proj_weight, dt_projs_*, A_logs, Ds) and the Swin
  relative_position_bias_table        -> unchanged

``load_torch_checkpoint``, ``mirror_encoder_keys`` and
``load_upstream_state`` port the warm start from an upstream torch ``.pth``
(the ImageNet VMamba or Swin encoder, or a whole Mamba-UNet or Swin-UNet)
of ``mamba_unet_tpu/utils/convert.py`` (``load_torch_checkpoint``,
``mirror_encoder_keys``, ``convert_vssm``). The port's parameter names are
the upstream ones, so no key map or layout transform is needed: the load is
a shape-checked, non-strict ``load_state_dict``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

# flax module name -> torch module path; {0} is the index in the flax name
_INDEXED = (
    (re.compile(r"layers_up_(\d+)$"), "layers_up.{0}"),
    (re.compile(r"layers_(\d+)$"), "layers.{0}"),
    (re.compile(r"blocks_(\d+)$"), "blocks.{0}"),
    (re.compile(r"downsample_(\d+)$"), "layers.{0}.downsample"),
    (re.compile(r"upsample_(\d+)$"), "layers_up.{0}.upsample"),
    (re.compile(r"concat_back_dim_(\d+)$"), "concat_back_dim.{0}"),
    (re.compile(r"down(\d+)$"), "down{0}.maxpool_conv.1"),
    (re.compile(r"(up\d+|aux_decoder\d+|out_conv_dp\d+)$"), "{0}"),
)
_RENAMED = {"vssm": "mamba_unet", "first_expand": "layers_up.0",
            "Conv_0": "conv_conv.0", "BatchNorm_0": "conv_conv.1",
            "Conv_1": "conv_conv.4", "BatchNorm_1": "conv_conv.5",
            "mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2"}
_PLAIN = frozenset({
    "patch_embed", "proj", "norm", "norm_up", "up", "expand", "output",
    "reduction", "ln_1", "self_attention", "in_proj", "out_proj", "conv2d",
    "out_norm", "swin_unet", "attn", "qkv", "norm1", "norm2", "encoder",
    "decoder", "main_decoder", "mask_encoder", "mask_decoder", "in_conv",
    "conv", "out_conv",
})
_RAW_LEAVES = frozenset({"x_proj_weight", "dt_projs_weight", "dt_projs_bias",
                         "A_logs", "Ds", "bias",
                         "relative_position_bias_table"})
_STATS = {"mean": "running_mean", "var": "running_var"}


def torch_key(path: str) -> str:
    """Port ``state_dict`` key for a ``"/"``-joined flax parameter path."""
    *mods, leaf = path.split("/")
    out = []
    for name in mods:
        if name in _RENAMED:
            out.append(_RENAMED[name])
        elif name in _PLAIN:
            out.append(name)
        else:
            for pat, fmt in _INDEXED:
                hit = pat.match(name)
                if hit:
                    out.append(fmt.format(hit.group(1)))
                    break
            else:
                raise KeyError(f"no port module for flax name {name!r} "
                               f"in {path!r}")
    if leaf in ("kernel", "scale"):
        out.append("weight")
    elif leaf in _RAW_LEAVES:
        out.append(leaf)
    elif leaf in _STATS:
        out.append(_STATS[leaf])
    else:
        raise KeyError(f"no port parameter for flax leaf {leaf!r} in {path!r}")
    return ".".join(out)


def to_torch_layout(path: str, value: np.ndarray) -> np.ndarray:
    """Transpose a flax leaf into the torch layout of its port parameter."""
    if path.endswith("/kernel"):
        if value.ndim == 2:
            return value.T
        if value.ndim == 4 and path.split("/")[-2] == "up":
            return value[::-1, ::-1].transpose(2, 3, 0, 1)  # ConvTranspose
        if value.ndim == 4:
            return value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel {path!r} has rank {value.ndim}")
    return value


def params_from_jax(
    flat: Mapping[str, np.ndarray],
    like: Optional[Mapping[str, torch.Tensor]] = None,
    batch_stats: Optional[Mapping[str, np.ndarray]] = None,
    num_batches_tracked: int = 0,
) -> Dict[str, torch.Tensor]:
    """Flattened flax params (and ``batch_stats``) -> port ``state_dict``
    (fp32 CPU tensors; each BatchNorm's ``num_batches_tracked`` is
    ``num_batches_tracked``, a count flax does not keep).

    Raises ``KeyError`` for a flax path with no port key, or two paths that
    map to one key. With ``like`` (the target module's ``state_dict``) it
    also raises ``KeyError`` when the key sets differ and ``ValueError`` on
    a shape mismatch."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in {**flat, **(batch_stats or {})}.items():
        key = torch_key(path)
        if key in sd:
            raise KeyError(f"two flax paths map to {key!r}")
        arr = np.array(to_torch_layout(path, np.asarray(value)),
                       dtype=np.float32, order="C")  # an owned, writable copy
        sd[key] = torch.from_numpy(arr)
        if key.endswith(".running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = (
                torch.tensor(num_batches_tracked))
    if like is not None:
        missing = sorted(set(like) - set(sd))
        extra = sorted(set(sd) - set(like))
        if missing or extra:
            raise KeyError(f"state_dict mismatch: missing {missing[:5]} "
                           f"({len(missing)}), unexpected {extra[:5]} "
                           f"({len(extra)})")
        for key, t in sd.items():
            if tuple(t.shape) != tuple(like[key].shape):
                raise ValueError(f"{key}: converted shape {tuple(t.shape)} "
                                 f"!= {tuple(like[key].shape)}")
    return sd


_UPSTREAM_PREFIXES = ("mamba_unet.", "swin_unet.", "module.")
# the attribute under which a wrapper model holds its upstream network
_ROOTS = ("mamba_unet", "swin_unet")


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.pth`` state dict on the CPU (``weights_only``), unwrapping
    the ``{"model": sd}`` of the VMamba/Swin pretrained files and a
    ``{"state_dict": sd}``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


def mirror_encoder_keys(sd: Mapping[str, Any], num_layers: int = 4
                        ) -> Dict[str, Any]:
    """An encoder-only checkpoint's ``layers.i.*`` also as
    ``layers_up.(num_layers - 1 - i).*``, where that key is absent: the
    decoder stages start from their mirrored encoder stages."""
    out = dict(sd)
    for k, v in sd.items():
        if k.startswith("layers."):
            i = int(k.split(".")[1])
            mirrored = f"layers_up.{num_layers - 1 - i}" + k[len(f"layers.{i}"):]
            if mirrored not in sd:
                out[mirrored] = v
    return out


def load_upstream_state(model: torch.nn.Module, sd: Mapping[str, Any],
                        mirror_decoder: bool = True) -> Dict[str, List]:
    """Load an upstream torch state dict into ``model`` (its ``mamba_unet``
    or ``swin_unet`` network when it has one), in place.

    The ``mamba_unet.``/``swin_unet.``/``module.`` prefixes are stripped,
    and with ``mirror_decoder`` the encoder stages are mirrored onto the
    decoder (:func:`mirror_encoder_keys`). Every parameter whose key is
    present with the same shape is loaded; the rest keep their values.
    Returns ``{"loaded": [key], "missing": [key], "shape_skipped": [(key,
    checkpoint shape, model shape)]}`` over the model's keys."""
    sd = dict(sd)
    for prefix in _UPSTREAM_PREFIXES:
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):] if k.startswith(prefix) else k: v
                  for k, v in sd.items()}
    if mirror_decoder:
        sd = mirror_encoder_keys(sd)
    root = next((getattr(model, name) for name in _ROOTS
                 if hasattr(model, name)), model)
    loaded, missing, skipped, update = [], [], [], {}
    for key, own in root.state_dict().items():
        if key not in sd:
            missing.append(key)
            continue
        value = torch.as_tensor(sd[key])
        if tuple(value.shape) != tuple(own.shape):
            skipped.append((key, tuple(value.shape), tuple(own.shape)))
            continue
        update[key] = value
        loaded.append(key)
    root.load_state_dict(update, strict=False)
    return {"loaded": loaded, "missing": missing, "shape_skipped": skipped}
