"""1-D Mamba mixer with optional bidirectional "bimamba v2", and its block.

Port of ``mamba_unet_tpu/nn/mamba1d.py`` (the reference's
``mamba_simple.py``): in_proj -> (x, z); depthwise causal conv1d + SiLU;
x_proj -> (dt, B, C); dt_proj; selective scan; * silu(z); out_proj.
``bimamba_type="v2"`` adds a mirrored parameter set (``A_b_log``,
``conv1d_b``, ``x_proj_b``, ``dt_proj_b``, ``D_b``) and sums the forward
scan with the flipped scan of the flipped sequence. ``forward_with_cache``
is the prefill (forward direction only), ``step`` the single-token decode.

Parameter names are upstream ``mamba_simple.py``'s, so a state-spaces
checkpoint loads by key. ``dtype`` is the compute dtype, as flax's: the
parameters stay fp32 and are cast to it at each projection (in_proj,
x_proj, dt_proj, out_proj), the norms compute in fp32 and round their
output to it, and with bf16 the scan gets bf16 inputs beside its fp32
state; the conv and the decode state update compute in fp32 and round to
it. The activations stay time-major, (B, L, d_inner),
from in_proj to out_proj: the scan is ``selective_scan_grouped`` with one
group, which launches the CUDA kernel ``csrc/selective_scan_fwd.cu`` on
CUDA tensors (with its final-state output in prefill) and runs its plain
version on CPU tensors. The decode step is plain tensor ops.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.nn.layers import lecun_normal_, uniform_
from mamba_unet_torch.nn.ss2d import a_log_init, dt_bias_init
from mamba_unet_torch.ops.causal_conv1d import (
    causal_conv1d,
    causal_conv1d_update,
)
from mamba_unet_torch.ops.selective_scan_grouped import (
    selective_scan_grouped,
    silu_gate,
)
from mamba_unet_torch.ops.state_update import selective_state_update

# Fixed hyper-parameters of the 1-D Mamba (the JAX module's defaults, which
# no caller overrides, and state-spaces/mamba-130m's): inner width =
# 2 * d_model, causal depthwise conv of width 4 with bias, no bias on
# in_proj/out_proj, dt_rank = ceil(d_model / 16), softplus(dt bias) ~
# LogUniform(0.001, 0.1) floored at 1e-4 (SS2D's ``dt_bias_init``);
# norm epsilon 1e-5.
EXPAND, D_CONV, NORM_EPS = 2, 4, 1e-5


def _project(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` (no bias) with its weight cast to ``x``'s dtype."""
    return F.linear(x, layer.weight.to(x.dtype))


def check_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got "
                         f"{dtype}")
    return dtype


class Mamba(nn.Module):
    def __init__(self, d_model: int, d_state: int = 16,
                 bimamba_type: str = "none", *, device=None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        if bimamba_type not in ("none", "v2"):
            raise ValueError(f"bimamba_type must be 'none' or 'v2', got "
                             f"{bimamba_type!r}")
        self.d_inner = din = EXPAND * d_model
        self.dt_rank = rank = math.ceil(d_model / 16)
        self.d_state = n = d_state
        self.bimamba_type = bimamba_type

        def dense(fan_in, fan_out):  # flax Dense's default init, no bias
            layer = nn.Linear(fan_in, fan_out, bias=False, device=device)
            lecun_normal_(layer.weight, generator)
            return layer

        self.in_proj = dense(d_model, 2 * din)
        self.out_proj = dense(din, d_model)
        for tag in ("", "_b") if bimamba_type == "v2" else ("",):
            conv = nn.Conv1d(din, din, D_CONV, groups=din, device=device)
            uniform_(conv.weight, 1.0 / math.sqrt(D_CONV), generator)
            uniform_(conv.bias, 1.0 / math.sqrt(D_CONV), generator)
            x_proj = nn.Linear(din, rank + 2 * n, bias=False, device=device)
            uniform_(x_proj.weight, 1.0 / math.sqrt(din), generator)
            dt_proj = nn.Linear(rank, din, device=device)
            uniform_(dt_proj.weight, rank ** -0.5, generator)
            with torch.no_grad():
                dt_proj.bias.copy_(dt_bias_init((din,), generator))
            setattr(self, f"conv1d{tag}", conv)
            setattr(self, f"x_proj{tag}", x_proj)
            setattr(self, f"dt_proj{tag}", dt_proj)
            setattr(self, f"A{tag}_log",
                    nn.Parameter(a_log_init(din, n).to(device)))
            setattr(self, f"D{tag}",
                    nn.Parameter(torch.ones(din, device=device)))

    def _ssm_inputs(self, x, tag):
        """Conv'd, activated x -> (dt, B, C, A) of direction ``tag``."""
        rank, n = self.dt_rank, self.d_state
        x_dbl = _project(x, getattr(self, f"x_proj{tag}"))
        dt, Bm, Cm = x_dbl.split([rank, n, n], dim=-1)
        dt = _project(dt, getattr(self, f"dt_proj{tag}"))
        A = -torch.exp(getattr(self, f"A{tag}_log").float())
        return dt, Bm, Cm, A

    def _scan_direction(self, x, z, tag, return_last_state=False):
        """x, z: (B, L, d_inner) -> y (B, L, d_inner) [, fp32 last state
        (B, d_inner, N)]."""
        conv = getattr(self, f"conv1d{tag}")
        xc = causal_conv1d(x.transpose(1, 2), conv.weight[:, 0], conv.bias,
                           "silu").transpose(1, 2).contiguous()
        dt, Bm, Cm, A = self._ssm_inputs(xc, tag)
        out = selective_scan_grouped(
            xc[:, None], dt[:, None].contiguous(), A,
            Bm[:, None].contiguous(), Cm[:, None].contiguous(),
            getattr(self, f"D{tag}").float(),
            getattr(self, f"dt_proj{tag}").bias.float(), True,
            return_last_state)
        y, last = out if return_last_state else (out, None)
        y = silu_gate(y[:, 0], z, x.dtype)
        return (y, last) if return_last_state else y

    def _in_proj(self, hidden_states: torch.Tensor):
        """(x, z) in the compute dtype."""
        return _project(hidden_states.to(self.dtype),
                        self.in_proj).chunk(2, dim=-1)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        """hidden_states: (B, L, d_model) -> (B, L, d_model) in the compute
        dtype."""
        x, z = self._in_proj(hidden_states)
        y = self._scan_direction(x, z, "")
        if self.bimamba_type == "v2":
            y = y + self._scan_direction(x.flip(1), z.flip(1), "_b").flip(1)
        return _project(y, self.out_proj)

    def forward_with_cache(self, hidden_states: torch.Tensor):
        """Prefill: the forward direction's output and its decode cache,
        (out, conv_state (B, d_inner, d_conv) fp32 = the last d_conv
        inputs of the conv, ssm_state (B, d_inner, N) fp32 = the final
        scan state)."""
        x, z = self._in_proj(hidden_states)
        L = x.shape[1]
        conv_state = F.pad(x.transpose(1, 2).float(),
                           (max(D_CONV - L, 0), 0))[..., -D_CONV:]
        y, ssm_state = self._scan_direction(x, z, "", return_last_state=True)
        return _project(y, self.out_proj), conv_state.contiguous(), ssm_state

    def init_cache(self, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(conv_state (B, d_inner, d_conv), ssm_state (B, d_inner, N)),
        fp32 zeros on the module's device."""
        dev = self.A_log.device
        return (torch.zeros(batch, self.d_inner, D_CONV, device=dev),
                torch.zeros(batch, self.d_inner, self.d_state, device=dev))

    def step(self, hidden_states, conv_state, ssm_state):
        """One token (B, 1, d_model) -> (out (B, 1, d_model), conv_state,
        ssm_state); forward direction only (decode caching is not defined
        for bidirectional scans). The states passed in are not changed."""
        x, z = self._in_proj(hidden_states[:, 0])
        x, conv_state = causal_conv1d_update(
            x, conv_state, self.conv1d.weight[:, 0], self.conv1d.bias, "silu")
        dt, Bm, Cm, A = self._ssm_inputs(x, "")
        y, ssm_state = selective_state_update(
            ssm_state, x, dt, A, Bm, Cm, D=self.D.float(), z=z,
            delta_bias=self.dt_proj.bias.float(), delta_softplus=True)
        return _project(y, self.out_proj)[:, None], conv_state, ssm_state


class MambaBlock(nn.Module):
    """Pre-norm residual wrapper: x + Mamba(Norm(x)), with RMSNorm or
    LayerNorm (upstream ``Block``: ``norm``, ``mixer``); the norm computes
    in fp32 and rounds to the compute ``dtype``."""

    def __init__(self, d_model: int, d_state: int = 16,
                 bimamba_type: str = "none", rms_norm: bool = False, *,
                 device=None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        norm_cls = nn.RMSNorm if rms_norm else nn.LayerNorm
        self.norm = norm_cls(d_model, eps=NORM_EPS, device=device)
        self.mixer = Mamba(d_model, d_state, bimamba_type, device=device,
                           generator=generator, dtype=dtype)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x.float()).to(self.mixer.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.mixer(self._norm(x))

    def step(self, x, conv_state, ssm_state):
        y, conv_state, ssm_state = self.mixer.step(self._norm(x), conv_state,
                                                   ssm_state)
        return x + y, conv_state, ssm_state

    def forward_with_cache(self, x):
        y, conv_state, ssm_state = self.mixer.forward_with_cache(
            self._norm(x))
        return x + y, conv_state, ssm_state
