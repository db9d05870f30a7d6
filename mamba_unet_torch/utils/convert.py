"""JAX (flax) -> port parameter conversion.

``params_from_jax`` is the inverse of ``mamba_unet_tpu/utils/convert.py``'s
``torch_key_for`` + ``_transform``: it takes a flax parameter tree flattened
to ``"/"``-joined paths (numpy leaves) and returns a ``state_dict`` for the
port's module with the same structure. It works for the whole ``MambaUnet``
(flax root ``vssm`` -> ``mamba_unet``) and for any of its submodules
(``SS2D``, the patch ops, ...). The key map lives here, so the port does not
import the JAX package.

Layout transforms (flax -> torch):
  Dense kernel (in, out)              -> Linear weight (out, in)
  Conv kernel (kh, kw, in, out)       -> Conv2d weight (out, in, kh, kw)
  depthwise (kh, kw, 1, C)            -> (C, 1, kh, kw)
  LayerNorm scale / bias              -> weight / bias
  SS2D raw params (x_proj_weight, dt_projs_*, A_logs, Ds) -> unchanged
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

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
)
_RENAMED = {"vssm": "mamba_unet", "first_expand": "layers_up.0"}
_PLAIN = frozenset({
    "patch_embed", "proj", "norm", "norm_up", "up", "expand", "output",
    "reduction", "ln_1", "self_attention", "in_proj", "out_proj", "conv2d",
    "out_norm",
})
_RAW_LEAVES = frozenset({"x_proj_weight", "dt_projs_weight", "dt_projs_bias",
                         "A_logs", "Ds", "bias"})


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
    else:
        raise KeyError(f"no port parameter for flax leaf {leaf!r} in {path!r}")
    return ".".join(out)


def to_torch_layout(path: str, value: np.ndarray) -> np.ndarray:
    """Transpose a flax leaf into the torch layout of its port parameter."""
    if path.endswith("/kernel"):
        if value.ndim == 2:
            return value.T
        if value.ndim == 4:
            return value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel {path!r} has rank {value.ndim}")
    return value


def params_from_jax(
    flat: Mapping[str, np.ndarray],
    like: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Flattened flax params -> port ``state_dict`` (fp32 CPU tensors).

    Raises ``KeyError`` for a flax path with no port key, or two paths that
    map to one key. With ``like`` (the target module's ``state_dict``) it
    also raises ``KeyError`` when the key sets differ and ``ValueError`` on
    a shape mismatch."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        key = torch_key(path)
        if key in sd:
            raise KeyError(f"two flax paths map to {key!r}")
        arr = np.array(to_torch_layout(path, np.asarray(value)),
                       dtype=np.float32, order="C")  # an owned, writable copy
        sd[key] = torch.from_numpy(arr)
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
