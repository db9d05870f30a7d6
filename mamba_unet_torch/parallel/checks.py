"""Multi-rank runs of the parallel paths, for holding them against one
process: the jobs that ``tests/test_torch_parallel.py`` runs on CPU
``gloo`` ranks and ``chip_smoke.py`` on ``gloo`` ranks that share one
card.

:func:`run_jobs` is the rank function for ``parallel.launch.run_ranks``:
one spawned group runs a list of jobs in order, each ``(name, kwargs)``
of :data:`JOBS`. Every job takes global inputs as numpy arrays and
returns numpy arrays: the global outputs and the gradients of
``sum(output * cot)`` with respect to every input or parameter (the same
on every rank: each path follows JAX's global view), and the launches of
the grouped scan kernels it made. Models are built from a ``builder``,
``(module, class name, keyword arguments)``, with their weights from a
numpy state dict or from ``torch.Generator().manual_seed(seed)``.
:func:`train` runs any trainer of ``mamba_unet_torch.train``: on a
one-rank group it is the one-process reference of the same job.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import importlib
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mamba_unet_torch.ops import selective_scan_bidir as ssb
from mamba_unet_torch.ops import selective_scan_grouped as ssg
from mamba_unet_torch.parallel.comm import gather_out, scatter_in
from mamba_unet_torch.parallel.mesh import make_mesh
from mamba_unet_torch.parallel.pipeline import (
    pipeline_lm_apply,
    pipeline_lm_loss,
    prestack_lm_params,
)
from mamba_unet_torch.parallel.seq_scan import (
    selective_scan_seq_sharded,
    sequence_sharding,
)
from mamba_unet_torch.parallel.tp_scan import (
    channel_sharding,
    gather_channels,
    selective_scan_tp_sharded,
    shard_channels,
)

KERNELS = (ssg.selective_scan_grouped, ssg.selective_scan_grouped_fwd_states,
           ssg.selective_scan_grouped_bwd)
BIDIR_KERNELS = (ssb.selective_scan_bidir, ssb.selective_scan_bidir_fwd_states,
                 ssb.selective_scan_bidir_bwd)


def _reset_launches() -> None:
    for k in KERNELS:
        k.launches = k.carry_launches = 0
    for k in BIDIR_KERNELS:
        k.launches = 0


def _launches() -> Dict[str, int]:
    """Each grouped and bidirectional kernel's launches, and the grouped
    kernels' carry variants' (``<name>.carry``)."""
    out = {k.__name__: k.launches for k in KERNELS + BIDIR_KERNELS}
    out.update({f"{k.__name__}.carry": k.carry_launches for k in KERNELS})
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    """fp32 numpy (fp64 stays fp64)."""
    t = t.detach()
    return t.to(torch.promote_types(t.dtype, torch.float32)).cpu().numpy()


def build_model(builder, weights=None, seed: int = 0,
                device: Optional[torch.device] = None) -> torch.nn.Module:
    """``builder`` = (module, class name, kwargs); weights from the numpy
    state dict ``weights`` or from a generator seeded with ``seed``."""
    module, name, kwargs = builder
    cls = getattr(importlib.import_module(module), name)
    model = cls(**kwargs, generator=torch.Generator().manual_seed(seed))
    if weights is not None:
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in weights.items()})
    return model.to(device)


# a patch embedding's bias at init is 0; drawn at this scale, as
# chip_smoke.py draws it
PATCH_BIAS_STD = 0.02


def warm_model(net_type: str, generator: Optional[torch.Generator] = None,
               bias_seed: int = 0, **kwargs) -> torch.nn.Module:
    """``net_factory(net_type, ...)`` warm-started, a builder for
    :func:`build_model` (``("mamba_unet_torch.parallel.checks",
    "warm_model", kwargs)``): the patch embedding's bias drawn
    N(0, PATCH_BIAS_STD²) from a generator seeded ``bias_seed``, and a
    position embedding's
    BatchNorm bias at 1. At init a mask model's position embedding is 0
    for the identity ids, and the first update's gradients then explode
    (ROADMAP §3), so steps from there would compare rounding noise."""
    from mamba_unet_torch.models import net_factory

    model = net_factory(net_type, generator=generator, **kwargs)
    root = getattr(model, "mamba_unet", getattr(model, "encoder", None))
    embed = getattr(root, "patch_embed", None)
    with torch.no_grad():
        if embed is not None:
            embed.proj.bias.copy_(PATCH_BIAS_STD * torch.randn(
                embed.proj.bias.shape,
                generator=torch.Generator().manual_seed(bias_seed)))
        if hasattr(model, "pos_embed_layer"):
            model.pos_embed_layer.bn.bias.fill_(1.0)
    return model


def _grads(named, full: bool = True) -> Dict[str, np.ndarray]:
    """The gradients, or with ``full`` False only their norms (a rank
    that need not send a large model's gradients back)."""
    return {k: _np(p.grad) if full else float(p.grad.float().norm())
            for k, p in named if p.grad is not None}


def _is_first() -> bool:
    return torch.distributed.get_rank() == 0


def scan(dev, route: str, inputs: Dict[str, np.ndarray], cot: np.ndarray,
         softplus: bool = True):
    """The public scan's sequence-sharded (``route="seq"``) or
    channel-sharded (``"tp"``) counterpart on global (B, D, L) inputs:
    each rank cuts its part, scans it and the parts are gathered. Returns
    y and the gradients of ``sum(y * cot)`` of u, delta, A, B, C, D,
    delta_bias."""
    names = ("u", "delta", "A", "B", "C", "D", "delta_bias")
    t = {k: torch.tensor(inputs[k], device=dev, requires_grad=True)
         for k in names}
    _reset_launches()
    if route == "seq":
        mesh = make_mesh(("seq",))
        g = mesh.group("seq")
        y = gather_out(selective_scan_seq_sharded(
            scatter_in(t["u"], 2, g), scatter_in(t["delta"], 2, g), t["A"],
            scatter_in(t["B"], 3, g), scatter_in(t["C"], 3, g), t["D"],
            delta_bias=t["delta_bias"], delta_softplus=softplus, mesh=mesh),
            2, g)
    else:
        mesh = make_mesh(("model",))
        G = t["B"].shape[1]

        def cut(x, dim=1):
            return shard_channels(x, G, dim, mesh)

        y = gather_channels(selective_scan_tp_sharded(
            cut(t["u"]), cut(t["delta"]), cut(t["A"], 0), t["B"], t["C"],
            cut(t["D"], 0), delta_bias=cut(t["delta_bias"], 0),
            delta_softplus=softplus, mesh=mesh), G, 1, mesh)
    (y.float() * torch.as_tensor(cot, device=dev)).sum().backward()
    return {"y": _np(y), "grads": {k: _np(t[k].grad) for k in names},
            "launches": _launches()}


def model(dev, builder, x: np.ndarray, cot: np.ndarray, route: str,
          weights=None, seed: int = 0, all_ranks: bool = True,
          data_ranks: int = 1):
    """A segmentation model (or an SS2D) whose SS2D scans ``route``
    ("seq": inside ``sequence_sharding``; "tp": inside
    ``channel_sharding``, over one ``model`` axis, or with ``data_ranks``
    > 1 over a (data, model) mesh of that many rows, the batch split over
    ``data``; "one": as it is, the one-process reference). Returns its
    output on
    ``x`` without grad (``eval``, the serving kernels) and with grad, and
    the gradients of ``sum(output * cot)`` of its parameters (with
    ``all_ranks`` False, only rank 0's; the others' norms)."""
    net = build_model(builder, weights, seed, dev).train()
    if route == "seq":
        ctx = sequence_sharding(make_mesh(("seq",)), "seq")
    elif route == "tp" and data_ranks > 1:
        world = torch.distributed.get_world_size()
        ctx = channel_sharding(
            make_mesh(("data", "model"), (data_ranks, world // data_ranks)),
            "model", batch_axis="data")
    elif route == "tp":
        ctx = channel_sharding(make_mesh(("model",)), "model")
    else:
        ctx = contextlib.nullcontext()
    xt = torch.as_tensor(x, device=dev)
    _reset_launches()
    with ctx:
        with torch.no_grad():
            served = net(xt)
        serve_launches = _launches()
        _reset_launches()
        logits = net(xt)
        (logits.float() * torch.as_tensor(cot, device=dev)).sum().backward()
    return {"eval": _np(served), "logits": _np(logits),
            "grads": _grads(net.named_parameters(),
                            all_ranks or _is_first()),
            "serve_launches": serve_launches, "launches": _launches()}


def pipeline(dev, builder, ids: np.ndarray, targets: np.ndarray,
             n_micro: int, weights=None, seed: int = 0,
             all_ranks: bool = True, prestack: bool = False):
    """The Mamba LM with its block stack pipelined over all ranks: the
    logits of ``ids``, the mean next-token loss against ``targets`` and
    its gradients of every parameter (``all_ranks`` as :func:`model`).
    With ``prestack`` the stage runs :func:`prestack_lm_params`'s layers
    (this stage's only): their gradients come back as ``stage_grads``
    ({name: (n_layer // S, ...)}), the replicated parameters' in
    ``grads``."""
    net = build_model(builder, weights, seed, dev)
    mesh = make_mesh(("pipe",))
    stage = None
    if prestack:
        _, stage = prestack_lm_params(net.state_dict(),
                                      len(net.backbone.layers), mesh)
    ids_t = torch.as_tensor(ids, device=dev)
    _reset_launches()
    with torch.no_grad():
        logits = pipeline_lm_apply(net, ids_t, mesh, n_micro=n_micro,
                                   stacked=stage)
    loss = pipeline_lm_loss(net, ids_t, torch.as_tensor(targets, device=dev),
                            mesh, n_micro=n_micro, stacked=stage)
    loss.backward()
    out = {"logits": _np(logits), "loss": float(loss.detach()),
           "grads": _grads(net.named_parameters(), all_ranks or _is_first()),
           "launches": _launches()}
    if stage is not None:
        out["stage_grads"] = _grads(stage.items())
    return out


def lm(dev, builder, ids: np.ndarray, targets: np.ndarray, weights=None,
       seed: int = 0):
    """The Mamba LM in one process, the reference of :func:`pipeline`:
    logits, the mean next-token loss and its gradients."""
    net = build_model(builder, weights, seed, dev)
    logits = net(torch.as_tensor(ids, device=dev))
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        torch.as_tensor(targets, device=dev).reshape(-1))
    loss.backward()
    return {"logits": _np(logits), "loss": float(loss.detach()),
            "grads": _grads(net.named_parameters())}


def _float_state(model) -> Dict[str, np.ndarray]:
    """A copy of the model's floating state (a CPU tensor's numpy view
    would follow the later steps)."""
    return {k: _np(v.clone()) for k, v in model.state_dict().items()
            if v.is_floating_point()}


# the trainers' further networks and EMA copies, by attribute
MEMBERS = ("model2", "model3", "mad_model", "den_model", "p3", "p4")
EMAS = ("ema", "p1", "p2")


def trainer_state(trainer) -> Dict[str, np.ndarray]:
    """The floating state of every network of ``trainer`` (the first
    model's keys as they are, the others' prefixed ``<attribute>.``) and
    of its EMA copies (``ema.``, ``p1.``, ``p2.``)."""
    out = _float_state(trainer.model)
    for name in MEMBERS:
        if hasattr(trainer, name):
            out.update({f"{name}.{k}": v for k, v in
                        _float_state(getattr(trainer, name)).items()})
    for name in EMAS:
        ema = getattr(trainer, name, None)
        if isinstance(ema, dict):
            out.update({f"{name}.{k}": _np(v.clone())
                        for k, v in ema.items()})
    return out


def _host_state(trainer) -> Dict[str, np.ndarray]:
    """What the trainer carries on the host or beside the weights:
    MagicNet's pseudo-label histogram and class distribution, the
    CTAugment rates of the contrastive trainer."""
    out = {}
    if hasattr(trainer, "dist_logger"):
        out["hist"] = trainer._hist.cpu().numpy()
        out["class_dist"] = trainer.dist_logger.get_class_dist()
    if getattr(trainer, "cta", None) is not None:
        out.update({f"cta.{k}.{i}": np.asarray(r) for k, rates in
                    trainer.cta.rates.items() for i, r in enumerate(rates)})
    return out


def _attach_cta(trainer, patch_size, seed: int) -> None:
    """The contrastive trainer's CTAugment policy, updated after every
    step (an epoch of one step), as its ``fit`` updates it."""
    from mamba_unet_torch.data.cta_transform import CTATransform
    from mamba_unet_torch.data.ctaugment import CTAugment

    trainer.cta = CTAugment(seed=seed)
    trainer.cta_transform = CTATransform(patch_size, trainer.cta, seed=seed)
    trainer._per_epoch = 1


def _steps(trainer, batches, wide) -> list:
    """The trainer's steps on ``batches``, each handed the global batch
    (its images in ``wide``) and followed by its host-side work
    (``_after_step``); returns the losses."""
    losses = []
    for b in batches:
        batch = {k: torch.as_tensor(v) for k, v in b.items()}
        batch = {k: v.to(wide) if v.is_floating_point() else v
                 for k, v in batch.items()}
        logs = trainer.train_step(batch)
        trainer._after_step(batch, logs)
        losses.append(float(logs["loss_total"]))
    return losses


def _ulp_off(nets, seed: int):
    """``nets`` (a model and {name: member}) with every floating
    parameter times 1 + e x its dtype's eps, e drawn from {-1, 0, 1}."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for net in (nets[0], *nets[1].values()):
            for p in net.parameters():
                if p.is_floating_point():
                    e = torch.randint(-1, 2, p.shape, generator=gen)
                    p.mul_(1 + torch.finfo(p.dtype).eps * e.to(p.dtype))
    return nets


def train(dev, builder, config: dict, batches, weights=None, seed: int = 0,
          start: bool = False, unscaled_grads: bool = False,
          method: Optional[Sequence[str]] = None,
          members: Optional[dict] = None, method_kw: Optional[dict] = None,
          unreduced: Sequence[str] = (), class_dist=None,
          dtype: str = "float32", all_ranks: bool = True,
          fp32_twin: bool = False, ulp_twins: int = 0):
    """``len(batches)`` data-parallel steps of a trainer over a ``data``
    axis of all ranks (:func:`_steps`). ``method`` is the trainer,
    (module, class name) (default the base ``Trainer``); ``members``
    {keyword: (builder, weights, seed)} its further networks
    (``model2``, ...), ``method_kw`` its other arguments. Returns the
    losses, the final state of every network and EMA copy
    (:func:`trainer_state`; with ``all_ranks`` False rank 0's alone) and
    every rank's SHA-1 digest of each leaf (``digests``), with ``start``
    each leaf's largest change over the steps (``moved``), the host state
    and the kernels' launches.

    Twins measure the job's own rounding spread: with ``fp32_twin`` (a
    bf16 config) the same networks take the same steps in fp32, and
    ``ulp_twins`` times from start weights one ulp off (:func:`_ulp_off`,
    each time another draw). Then
    ``twin`` holds the fp32 twin's losses and, over the twins, the largest
    distance of a loss (``loss_spread``), of each host array
    (``host_spread``) and of each leaf (``spread``) from these steps':
    scalars, so that a one-process reference ships no second state.

    Two controls break the step on purpose, for showing that a check can
    fail: ``unscaled_grads`` leaves the gradients summed over the ranks
    undivided by their count, ``unreduced`` leaves the named members'
    (e.g. ``("model2",)``) gradients unreduced. ``class_dist`` starts
    MagicNet's class distribution there, so that its first steps blend.
    ``dtype`` "float64" runs the networks and the batches' images in fp64
    (the trainers whose fp32 islands widen with them: MagicNet's)."""
    from mamba_unet_torch.train.trainer import TrainConfig, Trainer

    cls = Trainer
    if method is not None:
        cls = getattr(importlib.import_module(method[0]), method[1])
    wide = getattr(torch, dtype)
    nets = (build_model(builder, weights, seed).to(wide),
            {k: build_model(b, w, s).to(wide) for k, (b, w, s) in
             (members or {}).items()})
    twins = [("fp32", dict(config, bf16=False), copy.deepcopy(nets))
             ] if fp32_twin else []
    twins += [("ulp", config, _ulp_off(copy.deepcopy(nets), seed + i))
              for i in range(ulp_twins)]

    def make(cfg, net, extra):
        trainer = cls(net, TrainConfig(**cfg), device=dev,
                      mesh=make_mesh(("data",)), **extra,
                      **(method_kw or {}))
        if hasattr(trainer, "cta_transform"):
            _attach_cta(trainer, trainer.config.patch_size,
                        trainer.config.seed)
        if class_dist is not None:
            trainer.dist_logger.class_dist = np.asarray(class_dist,
                                                        np.float64)
        return trainer

    trainer = make(config, *nets)
    del nets  # the twins' copies alone outlive the trainer
    first = trainer_state(trainer) if start else None
    reduce = trainer._reduce_grads
    if unscaled_grads:
        def reduce_unscaled(*modules):
            reduce(*modules)
            for m in modules:
                for p in m.parameters():
                    if p.grad is not None:
                        p.grad.mul_(trainer._shard.count)

        trainer._reduce_grads = reduce_unscaled
    if unreduced:
        skip = [getattr(trainer, name) for name in unreduced]
        trainer._reduce_grads = lambda *modules: reduce(
            *(m for m in modules if not any(m is s for s in skip)))
    _reset_launches()
    losses = _steps(trainer, batches, wide)
    state = trainer_state(trainer)
    host = _host_state(trainer)
    out = {"losses": losses, "host": host, "launches": _launches(),
           "digests": {k: hashlib.sha1(v.tobytes()).hexdigest()
                       for k, v in state.items()}}
    if first is not None:
        out["moved"] = {k: float(np.abs(v - first[k]).max())
                        for k, v in state.items()}
    if twins:
        del trainer

        def far(a, b):
            return float(np.abs(np.asarray(a) - np.asarray(b)).max())

        spread = out["twin"] = {"spread": dict.fromkeys(state, 0.0),
                                "loss_spread": 0.0,
                                "host_spread": dict.fromkeys(host, 0.0)}
        while twins:  # one twin's networks on the device at a time
            kind, cfg, twin_nets = twins.pop(0)
            twin = make(cfg, *twin_nets)
            twin_losses = _steps(twin, batches, wide)
            if kind == "fp32":
                spread["losses"] = twin_losses
            spread["loss_spread"] = max(spread["loss_spread"],
                                        far(twin_losses, losses))
            for part, got, want in (
                    ("host_spread", _host_state(twin), host),
                    ("spread", trainer_state(twin), state)):
                for k, v in got.items():
                    spread[part][k] = max(spread[part][k], far(v, want[k]))
            del twin, twin_nets
    if all_ranks or _is_first():
        out["state"] = state
    return out


JOBS = {"scan": scan, "model": model, "pipeline": pipeline, "lm": lm,
        "train": train}


def run_jobs(rank: int, world: int, device: str, jobs) -> list:
    """Run ``jobs`` [(name, kwargs)] in order on this rank; ``device``
    "cpu" or "cuda" (every rank on card 0: ``gloo`` ranks sharing it).
    TF32 is off on the card, so fp32 compares with fp32. Each result
    carries its job's ``seconds``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = []
    for name, kwargs in jobs:
        t0 = time.perf_counter()
        out.append({**JOBS[name](dev, **kwargs),
                    "seconds": time.perf_counter() - t0})
        if dev.type == "cuda":  # the next job's models get the memory
            torch.cuda.empty_cache()
    return out
