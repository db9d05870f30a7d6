"""The chip, the caches, and what a run may not load.

:func:`set_cache_dirs` points the build and kernel caches (``nvcc``
through torch's extension builder, Triton) at fixed directories inside
the checkout, so only a checkout's first run builds.
:func:`require_chips` refuses to run without the CUDA devices a cell
asks for.
:func:`forbidden_modules` lists the loaded modules whose top-level name
is JAX's, its libraries' or the JAX package's.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "mamba_unet_tpu"})


def set_cache_dirs(root: Path) -> None:
    cache = Path(root) / "build" / "port_bench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)


def require_chips(count: int) -> None:
    """Exit with code 2 unless ``count`` CUDA devices are there."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: the cell needs {count} CUDA device(s), found "
              f"{found}", file=sys.stderr)
        raise SystemExit(2)


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def describe(device, chips: int) -> Dict[str, object]:
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit_w() -> Optional[float]:
    """The card's power limit from ``nvidia-smi`` (None where it cannot
    be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
