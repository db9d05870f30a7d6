"""Config system: yaml model configs and ``--opts KEY VALUE`` overrides.

Port of ``mamba_unet_tpu/utils/config.py`` (``Config``,
``default_config``, ``get_config``, ``build_model_from_config``): the
reference's DATA / MODEL.VSSM / MODEL.SWIN / TEST trees as an attribute
dict, merged with a yaml file (``configs/*.yaml``) and dot-path
overrides, whose values are parsed as yaml scalars and flow lists
(``yaml.safe_load``). ``build_model_from_config`` builds the port's
``MambaUnet`` (``vssm``) or ``SwinUnet`` (``swin``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import yaml


class Config(dict):
    """dict with attribute access and recursive merge."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config({k: Config._wrap(x) for k, x in v.items()})
        return v

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        return cls({k: cls._wrap(v) for k, v in d.items()})

    def merge(self, other: Dict[str, Any]) -> "Config":
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), dict):
                self[k].merge(v)
            else:
                self[k] = self._wrap(v)
        return self

    def set_dotted(self, key: str, value: Any) -> None:
        parts = key.split(".")
        node = self
        for p in parts[:-1]:
            node = node.setdefault(p, Config())
        node[parts[-1]] = yaml.safe_load(str(value))

    def clone(self) -> "Config":
        return Config.from_dict(copy.deepcopy(dict(self)))


def default_config() -> Config:
    """The reference config's defaults (its model-relevant subset)."""
    return Config.from_dict({
        "DATA": {"IMG_SIZE": 224, "BATCH_SIZE": 24},
        "MODEL": {
            "TYPE": "vssm",
            "NAME": "vmamba_tiny",
            "DROP_RATE": 0.0,
            "DROP_PATH_RATE": 0.2,
            "NUM_CLASSES": 4,
            "PRETRAIN_CKPT": None,
            "VSSM": {
                "PATCH_SIZE": 4,
                "IN_CHANS": 3,
                "EMBED_DIM": 96,
                "DEPTHS": [2, 2, 2, 2],
                "D_STATE": 16,
            },
            "SWIN": {
                "PATCH_SIZE": 4,
                "IN_CHANS": 3,
                "EMBED_DIM": 96,
                "DEPTHS": [2, 2, 2, 2],
                "DECODER_DEPTHS": [2, 2, 2, 1],
                "NUM_HEADS": [3, 6, 12, 24],
                "WINDOW_SIZE": 7,
                "MLP_RATIO": 4.0,
            },
        },
        "TEST": {"CROP": True},
    })


def get_config(cfg_file: Optional[str] = None,
               opts: Optional[List[str]] = None) -> Config:
    """Load the defaults, merge a yaml file, apply --opts KEY VALUE
    pairs."""
    cfg = default_config()
    if cfg_file:
        with open(cfg_file) as f:
            cfg.merge(yaml.safe_load(f) or {})
    if opts:
        if len(opts) % 2:
            raise ValueError(f"--opts expects KEY VALUE pairs, got {opts}")
        for k, v in zip(opts[0::2], opts[1::2]):
            cfg.set_dotted(k, v)
    return cfg


def build_model_from_config(cfg: Config, num_classes: Optional[int] = None,
                            img_size: Optional[int] = None,
                            drop_path_rate: Optional[float] = None,
                            **kwargs):
    """The reference wrappers' config -> model construction.
    ``drop_path_rate`` overrides the config's when given (the CLI's
    --drop_path applies to config-built models too); ``kwargs``
    (``generator``, ``device``, ``scan_impl`` for ``vssm``) go to the
    model. The port's ``MambaUnet`` takes no image size (its stages follow
    the input)."""
    from mamba_unet_torch.models.swin_unet import SwinUnet
    from mamba_unet_torch.models.vssm import MambaUnet

    nc = num_classes or cfg.MODEL.NUM_CLASSES
    dpr = (drop_path_rate if drop_path_rate is not None
           else cfg.MODEL.DROP_PATH_RATE)
    if cfg.MODEL.TYPE == "vssm":
        v = cfg.MODEL.VSSM
        dims = [v.EMBED_DIM * 2 ** i for i in range(len(v.DEPTHS))]
        return MambaUnet(num_classes=nc, depths=tuple(v.DEPTHS),
                         dims=tuple(dims), drop_path_rate=dpr, **kwargs)
    if cfg.MODEL.TYPE == "swin":
        s = cfg.MODEL.SWIN
        kwargs.pop("scan_impl", None)
        return SwinUnet(num_classes=nc,
                        img_size=img_size or cfg.DATA.IMG_SIZE,
                        embed_dim=s.EMBED_DIM, depths=tuple(s.DEPTHS),
                        num_heads=tuple(s.NUM_HEADS),
                        window_size=s.WINDOW_SIZE, drop_path_rate=dpr,
                        **kwargs)
    raise ValueError(f"unknown MODEL.TYPE {cfg.MODEL.TYPE!r}")
