"""The building blocks of Mamba-UNet as plain functions of a dict of
tensors.

Written from Mamba-UNet (Wang et al., arXiv:2402.05079; its
``vmamba_tiny`` config) and VMamba's SS2D (Liu et al., 2024): a VSSM
encoder of patch embedding and four stages of VSS blocks, each stage but
the last followed by patch merging, and a mirrored decoder of patch
expanding, skip concatenation and VSS blocks, ending in a x4 expand. A
VSS block is x + DropPath(SS2D(LN(x))).

A model family is a module of this package named by the configuration's
``reference`` key (``reference/<name>.py``): its ``param_spec(cfg)``
lists the parameters and its ``forward(net, x)`` gives the logits, from
these blocks. :func:`family` finds it by that name.

Tensors are channels-last. Parameter names are those of the upstream
torch checkpoints (``in_proj``, ``x_proj_weight``, ``dt_projs_*``,
``A_logs``, ``Ds``, ``layers_up``, ``concat_back_dim`` ...), so one dict
of weights loads into the program's model and drives this reference.
:func:`init_weights` makes that dict from a seed on the device: every
matrix from one truncated-normal draw and every uniform leaf from one
uniform draw, scaled per leaf.
"""

from __future__ import annotations

import importlib
import math
from types import ModuleType
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.precision import Precision

EXPAND, D_CONV = 2, 3
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4
TRUNC = 0.87962566103423978  # std of a unit normal truncated at +-2
LN_EPS = 1e-5

Spec = List[Tuple[str, Tuple[int, ...], str, float]]


# --- the parameter layout --------------------------------------------------
def _ln(spec: Spec, name: str, dim: int) -> None:
    spec += [(f"{name}.weight", (dim,), "one", 0.0),
             (f"{name}.bias", (dim,), "zero", 0.0)]


def _linear(spec: Spec, name: str, fan_in: int, fan_out: int,
            bias: bool = False, init: str = "tn02") -> None:
    std = 0.02 if init == "tn02" else math.sqrt(1.0 / fan_in) / TRUNC
    spec.append((f"{name}.weight", (fan_out, fan_in), "tn", std))
    if bias:
        spec.append((f"{name}.bias", (fan_out,), "zero", 0.0))


def _conv(spec: Spec, name: str, cin: int, cout: int, k: int,
          groups: int = 1, bias: bool = True) -> None:
    fan_in = cin // groups * k * k
    spec.append((f"{name}.weight", (cout, cin // groups, k, k), "tn",
                 math.sqrt(1.0 / fan_in) / TRUNC))
    if bias:
        spec.append((f"{name}.bias", (cout,), "zero", 0.0))


def _ss2d(spec: Spec, p: str, dm: int, n: int) -> None:
    di, r = EXPAND * dm, math.ceil(dm / 16)
    _linear(spec, f"{p}.in_proj", dm, 2 * di)
    _conv(spec, f"{p}.conv2d", di, di, D_CONV, groups=di)
    spec += [(f"{p}.x_proj_weight", (4, r + 2 * n, di), "unif",
              1.0 / math.sqrt(di)),
             (f"{p}.dt_projs_weight", (4, di, r), "unif", r ** -0.5),
             (f"{p}.dt_projs_bias", (4, di), "dtbias", 0.0),
             (f"{p}.A_logs", (4 * di, n), "alog", 0.0),
             (f"{p}.Ds", (4 * di,), "one", 0.0)]
    _ln(spec, f"{p}.out_norm", di)
    _linear(spec, f"{p}.out_proj", di, dm)


def _vss_layer(spec: Spec, p: str, dim: int, depth: int, n: int,
               down: bool = False, up: bool = False) -> None:
    for j in range(depth):
        _ln(spec, f"{p}.blocks.{j}.ln_1", dim)
        _ss2d(spec, f"{p}.blocks.{j}.self_attention", dim, n)
    if down:
        _ln(spec, f"{p}.downsample.norm", 4 * dim)
        _linear(spec, f"{p}.downsample.reduction", 4 * dim, 2 * dim)
    if up:
        _linear(spec, f"{p}.upsample.expand", dim, 2 * dim)
        _ln(spec, f"{p}.upsample.norm", dim // 2)


def _encoder(spec: Spec, p: str, cfg: dict, in_chans: int) -> None:
    dims, depths, n = cfg["dims"], cfg["depths"], cfg["d_state"]
    ps = cfg["patch_size"]
    _conv(spec, f"{p}patch_embed.proj", in_chans, dims[0], ps)
    _ln(spec, f"{p}patch_embed.norm", dims[0])
    for i in range(len(dims)):
        _vss_layer(spec, f"{p}layers.{i}", dims[i], depths[i], n,
                   down=i < len(dims) - 1)
    _ln(spec, f"{p}norm", dims[-1])


def _decoder(spec: Spec, p: str, cfg: dict) -> None:
    dims, depths, n = cfg["dims"], cfg["depths"], cfg["d_state"]
    k = len(dims)
    _linear(spec, f"{p}layers_up.0.expand", dims[-1], 2 * dims[-1])
    _ln(spec, f"{p}layers_up.0.norm", dims[-1] // 2)
    for i in range(1, k):
        c = dims[k - 1 - i]
        _linear(spec, f"{p}concat_back_dim.{i}", 2 * c, c,
                bias=True)
        _vss_layer(spec, f"{p}layers_up.{i}", c, depths[k - 1 - i], n,
                   up=i < k - 1)
    _ln(spec, f"{p}norm_up", dims[0])
    _linear(spec, f"{p}up.expand", dims[0], cfg["patch_size"] ** 2 * dims[0])
    _ln(spec, f"{p}up.norm", dims[0])


def family(cfg: dict) -> ModuleType:
    """``reference/<cfg["reference"]>.py``: the configuration's model."""
    name = cfg["reference"]
    if not name.isidentifier():
        raise ValueError(f"no reference {name!r}")
    return importlib.import_module(f"port_bench.reference.{name}")


def param_spec(cfg: dict) -> Spec:
    """(name, shape, init, scale) of every parameter of the
    configuration's model, in the program's naming."""
    return family(cfg).param_spec(cfg)


def init_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded initial weights, made on ``device`` in two
    draws: a truncated normal (+-2 std) for every ``tn`` leaf and a
    uniform for every ``unif``/``dtbias`` leaf, each scaled per leaf;
    LayerNorm scales 1, biases 0, A_log = log(1..N) (S4D
    real), D = 1, softplus(dt bias) ~ LogUniform(1e-3, 1e-1)."""
    spec = param_spec(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, 1]).generate_state(
        1, np.uint64)[0] >> 1))
    count = {k: sum(math.prod(s) for _, s, i, _ in spec if i in kinds)
             for k, kinds in (("tn", ("tn",)), ("u", ("unif", "dtbias")))}
    normal = torch.empty(count["tn"], device=device)
    torch.nn.init.trunc_normal_(normal, 0.0, 1.0, -2.0, 2.0, generator=gen)
    unif = torch.rand(count["u"], device=device, generator=gen)
    out: Dict[str, torch.Tensor] = {}
    offs = {"tn": 0, "u": 0}
    for name, shape, init, scale in spec:
        size = math.prod(shape)
        if init == "tn":
            t = normal[offs["tn"]:offs["tn"] + size] * scale
            offs["tn"] += size
        elif init in ("unif", "dtbias"):
            u = unif[offs["u"]:offs["u"] + size]
            offs["u"] += size
            if init == "unif":
                t = (2.0 * u - 1.0) * scale
            else:
                dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN))
                               + math.log(DT_MIN)).clamp(min=DT_FLOOR)
                t = dt + torch.log(-torch.expm1(-dt))
        elif init == "alog":
            t = torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float32,
                                       device=device)).repeat(shape[0], 1)
        elif init == "one":
            t = torch.ones(size, device=device)
        else:
            t = torch.zeros(size, device=device)
        out[name] = t.reshape(shape).clone()
    return out


# --- the forward passes ----------------------------------------------------
def stage_rates(depths: Sequence[int], rate: float) -> List[List[float]]:
    """Stochastic depth 0 -> ``rate`` linearly over the encoder's blocks,
    per stage; a decoder stage takes its mirrored encoder stage's."""
    dpr = np.linspace(0, rate, sum(depths)).tolist()
    offs = np.cumsum([0, *depths]).tolist()
    return [dpr[offs[i]:offs[i + 1]] for i in range(len(depths))]


def depth_to_space(x: torch.Tensor, s: int) -> torch.Tensor:
    b, h, w, c = x.shape
    c //= s * s
    return x.reshape(b, h, w, s, s, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, s * h, s * w, c)


class Net:
    """One forward's context: the weights ``P``, the precision of its
    products, the scan function and, in training, the generator the
    drop-path masks are drawn from (None: no drop path)."""

    def __init__(self, P: Dict[str, torch.Tensor], cfg: dict,
                 prec: Optional[Precision] = None,
                 scan: Optional[Callable] = None,
                 gen: Optional[torch.Generator] = None):
        from port_bench.reference.scan import scan_bidir

        self.P, self.cfg = P, cfg
        self.prec = prec or Precision("fp32")
        self.scan = scan or scan_bidir
        self.gen = gen

    # layers
    def lin(self, x, name, bias=False):
        return self.prec.linear(x, self.P[f"{name}.weight"],
                                self.P[f"{name}.bias"] if bias else None)

    def ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.P[f"{name}.weight"],
                            self.P[f"{name}.bias"], LN_EPS)

    def conv(self, x, name, bias=True, **kw):
        """Channels-last in and out."""
        y = self.prec.conv2d(x.permute(0, 3, 1, 2), self.P[f"{name}.weight"],
                             self.P[f"{name}.bias"] if bias else None, **kw)
        return y.permute(0, 2, 3, 1)

    def drop_path(self, x, rate):
        if self.gen is None or rate == 0.0:
            return x
        keep = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                          device=x.device, generator=self.gen) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    # SS2D and the VSS stages
    def ss2d(self, x, p):
        P, n = self.P, self.cfg["d_state"]
        b, h, w, dm = x.shape
        di, r, L = EXPAND * dm, math.ceil(dm / 16), h * w
        xx, z = self.lin(x, f"{p}.in_proj").chunk(2, dim=-1)
        xx = F.silu(self.conv(xx, f"{p}.conv2d", padding=D_CONV // 2,
                              groups=di))
        xs2 = torch.stack([xx.reshape(b, L, di),
                           xx.transpose(1, 2).reshape(b, L, di)], dim=1)
        wg = P[f"{p}.x_proj_weight"].reshape(2, 2, r + 2 * n, di)
        x_dbl = self.prec.einsum("bmld,jmcd->bjmlc", xs2, wg).reshape(
            b, 4, L, r + 2 * n)
        dts, bs, cs = x_dbl.split([r, n, n], dim=-1)
        dts = self.prec.einsum("bklr,kdr->bkld", dts,
                               P[f"{p}.dt_projs_weight"])
        y2 = self.scan(xs2, dts, -torch.exp(P[f"{p}.A_logs"]), bs, cs,
                       P[f"{p}.Ds"], P[f"{p}.dt_projs_bias"].reshape(-1))
        y = y2[:, 0].reshape(b, h, w, di) + y2[:, 1].reshape(
            b, w, h, di).transpose(1, 2)
        return self.lin(self.ln(y, f"{p}.out_norm") * F.silu(z),
                        f"{p}.out_proj")

    def vss_layer(self, x, p, rates, down=False, up=False):
        for j, rate in enumerate(rates):
            pb = f"{p}.blocks.{j}"
            x = x + self.drop_path(
                self.ss2d(self.ln(x, f"{pb}.ln_1"), f"{pb}.self_attention"),
                rate)
        if down:
            h, w = x.shape[1:3]
            x = x[:, :h - h % 2, :w - w % 2]
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                           x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
            x = self.lin(self.ln(x, f"{p}.downsample.norm"),
                         f"{p}.downsample.reduction")
        if up:
            x = self.ln(depth_to_space(self.lin(x, f"{p}.upsample.expand"),
                                       2), f"{p}.upsample.norm")
        return x

    def encode(self, x, p):
        """[the input of each stage ..., the normed bottleneck]."""
        cfg = self.cfg
        rates = stage_rates(cfg["depths"], cfg["drop_path_rate"])
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        x = self.conv(x, f"{p}patch_embed.proj", stride=cfg["patch_size"])
        x = self.ln(x, f"{p}patch_embed.norm")
        feats = []
        k = len(cfg["dims"])
        for i in range(k):
            feats.append(x)
            x = self.vss_layer(x, f"{p}layers.{i}", rates[i], down=i < k - 1)
        feats.append(self.ln(x, f"{p}norm"))
        return feats

    def decode(self, feats, p):
        """The decoder up to the final x4 expand (channels dims[0])."""
        cfg = self.cfg
        rates = stage_rates(cfg["depths"], cfg["drop_path_rate"])
        k = len(cfg["dims"])
        x = self.ln(depth_to_space(self.lin(feats[-1],
                                            f"{p}layers_up.0.expand"), 2),
                    f"{p}layers_up.0.norm")
        for i in range(1, k):
            x = torch.cat([x, feats[k - 1 - i]], dim=-1)
            x = self.lin(x, f"{p}concat_back_dim.{i}", bias=True)
            x = self.vss_layer(x, f"{p}layers_up.{i}", rates[k - 1 - i],
                               up=i < k - 1)
        x = self.ln(x, f"{p}norm_up")
        return self.ln(depth_to_space(self.lin(x, f"{p}up.expand"),
                                      cfg["patch_size"]), f"{p}up.norm")
