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
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Dict, Optional

import numpy as np
import torch

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


def _reset_launches() -> None:
    for k in KERNELS:
        k.launches = k.carry_launches = 0


def _launches() -> Dict[str, int]:
    """Each grouped kernel's launches, and its carry variant's
    (``<name>.carry``)."""
    out = {k.__name__: k.launches for k in KERNELS}
    out.update({f"{k.__name__}.carry": k.carry_launches for k in KERNELS})
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


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


def train(dev, builder, config: dict, batches, weights=None, seed: int = 0,
          start: bool = False, unscaled_grads: bool = False):
    """``len(batches)`` data-parallel steps of the base ``Trainer`` over a
    ``data`` axis of all ranks, each step handed the global batch.
    Returns the losses and the final state dict (with ``start``, the
    first one too). ``unscaled_grads`` breaks the step on purpose, for
    showing that a check can fail: the gradients summed over the ranks
    are not divided by their count."""
    from mamba_unet_torch.train.trainer import TrainConfig, Trainer

    net = build_model(builder, weights, seed)
    trainer = Trainer(net, TrainConfig(**config), device=dev,
                      mesh=make_mesh(("data",)))
    out = {"start": _float_state(trainer.model)} if start else {}
    if unscaled_grads:
        reduce = trainer._reduce_grads

        def reduce_unscaled(*modules):
            reduce(*modules)
            for m in modules:
                for p in m.parameters():
                    if p.grad is not None:
                        p.grad.mul_(trainer._shard.count)

        trainer._reduce_grads = reduce_unscaled
    _reset_launches()
    losses = [float(trainer.train_step({k: torch.as_tensor(v)
                                        for k, v in b.items()})["loss_total"])
              for b in batches]
    return {**out, "losses": losses, "state": _float_state(trainer.model),
            "launches": _launches()}


JOBS = {"scan": scan, "model": model, "pipeline": pipeline, "lm": lm,
        "train": train}


def run_jobs(rank: int, world: int, device: str, jobs) -> list:
    """Run ``jobs`` [(name, kwargs)] in order on this rank; ``device``
    "cpu" or "cuda" (every rank on card 0: ``gloo`` ranks sharing it).
    TF32 is off on the card, so fp32 compares with fp32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return [JOBS[name](dev, **kwargs) for name, kwargs in jobs]
