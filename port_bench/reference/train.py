"""What the training references share: the losses' parts, the trainer's
per-step seed, and SGD followed over the first steps of a run.

A training method is a module of this package named by the traffic's
``method`` key (``reference/<method>.py``): its ``loss(cfg, traffic, P,
batch, scan)`` gives one step's loss (the work :mod:`port_bench.count`
counts) and its ``follow(cfg, traffic, P0, batches, seed, prec)`` the
readings the check compares. :func:`method` finds it by that name.

SGD: momentum 0.9 and weight decay 1e-4 added to the gradient before the
momentum, lr_k = base_lr (1 - k / max_iterations)^0.9 for update k; a
parameter the loss does not reach gets a zero gradient.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Callable, Dict, List

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from port_bench.reference.net import param_spec
from port_bench.reference.scan import scan_bidir


def method(traffic: dict) -> ModuleType:
    """``reference/<traffic["method"]>.py``: the traffic's training step."""
    name = traffic["method"]
    if not name.isidentifier():
        raise ValueError(f"no method {name!r}")
    return importlib.import_module(f"port_bench.reference.{name}")


def step_seed(seed: int, step: int) -> int:
    """The trainer's per-step seed: 63 bits of SeedSequence([seed, step])."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0]) >> 1


def checkpointed_scan(*args):
    """The scan, its activations recomputed in the backward, so that one
    call's graph at a time is held."""
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in args if torch.is_tensor(a)):
        return checkpoint(scan_bidir, *args, use_reentrant=False)
    return scan_bidir(*args)


def one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    return (labels.long()[..., None]
            == torch.arange(n, device=labels.device)).float()


def cross_entropy(logits, labels):
    logp = torch.nn.functional.log_softmax(logits.float(), dim=-1)
    return -(one_hot(labels, logits.shape[-1]) * logp).sum(-1).mean()


def dice(probs, labels, smooth=1e-5):
    """The per-class soft Dice loss with squared-sum denominators,
    averaged over the classes with the background."""
    t = one_hot(labels, probs.shape[-1])
    axes = tuple(range(probs.dim() - 1))
    inter = (probs * t).sum(axes)
    denom = (probs * probs).sum(axes) + (t * t).sum(axes)
    return (1.0 - (2.0 * inter + smooth) / (denom + smooth)).mean()


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's norm, in fp64."""
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].double())
                        for n in names]).cpu().tolist()
    return dict(zip(names, vals))


def follow_sgd(cfg: dict, traffic: dict, P0: Dict[str, torch.Tensor],
               batches: List[Dict[str, torch.Tensor]],
               step_loss: Callable[[Dict[str, torch.Tensor], dict, int],
                                   torch.Tensor]) -> Dict[str, object]:
    """SGD on ``step_loss(P, batch, k)`` over ``batches`` from ``P0``;
    returns ``losses`` (one per step), ``grad_norms`` (each leaf's first
    gradient with its weight decay, as SGD's momentum holds it after
    step 1) and ``update_norms`` (each leaf's change over the steps)."""
    names = [name for name, _, _, _ in param_spec(cfg)]
    P = {n: P0[n].detach().clone().requires_grad_(True) for n in names}
    lr0, iters = traffic["base_lr"], traffic["max_iterations"]
    mom, wd = 0.9, 1e-4
    buf: Dict[str, torch.Tensor] = {}
    out: Dict[str, object] = {"losses": []}
    for k, batch in enumerate(batches):
        loss = step_loss(P, batch, k)
        grads = torch.autograd.grad(loss, [P[n] for n in names],
                                    allow_unused=True)
        out["losses"].append(float(loss.detach()))
        lr = lr0 * max(0.0, 1.0 - k / iters) ** 0.9
        with torch.no_grad():
            for n, g in zip(names, grads):
                p = P[n]
                d = (torch.zeros_like(p) if g is None else g) + wd * p
                buf[n] = d.clone() if k == 0 else buf[n].mul_(mom).add_(d)
                p.sub_(lr * buf[n])
            if k == 0:
                out["grad_norms"] = norms(buf)
        del loss, grads
    with torch.no_grad():
        out["update_norms"] = norms({n: P[n] - P0[n] for n in names})
    return out
