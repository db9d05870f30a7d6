"""The contrastive losses of the contrastive-consistency trainers.

Port of ``mamba_unet_tpu/objectives/contrastive.py``: ``con_loss`` (the
patch-NCE of ``--method contrastive_consistency``; ``contrastive_loss_sup``
is the same function), and the exports no trainer calls: ``info_nce_loss``
(SimCLR-style NCE), ``MocoLoss`` (a key queue keyed by sample index,
capped at 1056 entries) and ``con_loss_queue`` (patch-NCE against an
external key bank). Features are channels-last; the keys take no
gradient. The losses compute in the dtype they are given: the trainer
hands them fp32 projector features.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F

from mamba_unet_torch.objectives.losses import batch_mean


def _flatten_patches(feat: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) or (B, N, C) -> (B, N, C), L1-normalized along C (the
    reference normalizes with p=1)."""
    if feat.dim() == 4:
        b, h, w, c = feat.shape
        feat = feat.reshape(b, h * w, c)
    norm = feat.abs().sum(-1, keepdim=True)
    return feat / norm.clamp_min(1e-12)


def con_loss(feat_q: torch.Tensor, feat_k: torch.Tensor,
             temperature: float = 0.07, group=None) -> torch.Tensor:
    """Patch-NCE: each patch's positive is the same patch of ``feat_k``,
    its negatives the other patches of the same sample. The (B, N, N)
    negatives are the memory this loss needs (0.63 GB in fp32 at B = 16,
    N = 56²). With a ``group`` the mean over B·N is taken over its ranks'
    rows of the global batch (the negatives stay within each sample)."""
    q = _flatten_patches(feat_q)
    k = _flatten_patches(feat_k).detach()
    n = q.shape[1]
    l_pos = (q * k).sum(-1).reshape(-1, 1)
    l_neg = torch.einsum("bnd,bmd->bnm", q, k)
    eye = torch.eye(n, dtype=torch.bool, device=q.device)
    l_neg = l_neg.masked_fill(eye, float("-inf")).reshape(-1, n)
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    return batch_mean(-F.log_softmax(logits, dim=-1)[:, 0], group)


# the reference defines contrastive_loss_sup twice; the surviving
# definition is the same patch-NCE
contrastive_loss_sup = con_loss


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def info_nce_loss(feats1: torch.Tensor, feats2: torch.Tensor
                  ) -> torch.Tensor:
    """SimCLR-style NCE where example i's positive sits n/2 rows away."""
    sim = _l2_normalize(feats1) @ _l2_normalize(feats2).T
    n = sim.shape[0]
    self_mask = torch.eye(n, dtype=torch.bool, device=sim.device)
    sim = sim.masked_fill(self_mask, -9e15)
    pos_mask = torch.roll(self_mask, shifts=n // 2, dims=0)
    sim = sim / 0.07
    nll = -sim[pos_mask] + torch.logsumexp(sim, dim=-1)
    return nll.mean()


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (_l2_normalize(a) * _l2_normalize(b)).sum(-1)


class MocoLoss:
    """MoCo-style loss with a key queue keyed by sample index.

    ``loss(feat_q (B, ...), feat_k (B, ...), idx (B,))``: the positives are
    the matching keys, the negatives the queued keys (the batch's own stale
    entries evicted first; the batch's keys when the queue is empty or off).
    The batch's keys then join the queue, the oldest leaving past
    ``max_entries``."""

    def __init__(self, temperature: float = 0.07, use_queue: bool = True,
                 max_entries: int = 1056):
        self.temperature = temperature
        self.use_queue = use_queue
        self.max_entries = max_entries
        self.queue: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def __call__(self, feat_q: torch.Tensor, feat_k: torch.Tensor, idx
                 ) -> torch.Tensor:
        b = feat_q.shape[0]
        q = feat_q.reshape(b, -1)
        k = feat_k.reshape(b, -1).detach()
        idx = [str(int(i)) for i in torch.as_tensor(idx).reshape(-1)]
        l_pos = _cos(q, k).reshape(-1, 1)
        if self.use_queue:
            for i in idx:
                self.queue.pop(i, None)
        if self.use_queue and self.queue:
            keys = torch.stack(list(self.queue.values())).to(q.device)
            l_neg = _cos(q[:, None, :], keys[None, :, :])
        else:
            l_neg = _cos(q[:, None, :], k[None, :, :])
        logits = torch.cat([l_pos, l_neg], dim=1) / self.temperature
        loss = -F.log_softmax(logits, dim=-1)[:, 0].mean()
        if self.use_queue:
            for i, key in zip(idx, k):
                self.queue[i] = key.clone()
                if len(self.queue) > self.max_entries:
                    self.queue.popitem(last=False)
        return loss


def con_loss_queue(feat_q: torch.Tensor, queue_keys: torch.Tensor,
                   feat_k_pos: torch.Tensor, temperature: float = 0.07
                   ) -> torch.Tensor:
    """NCE against an external key bank: the positive is the matching
    ``feat_k_pos``, the negatives ``queue_keys``."""
    b = feat_q.shape[0]
    q = feat_q.reshape(b, -1)
    kp = feat_k_pos.reshape(b, -1).detach()
    bank = queue_keys.reshape(queue_keys.shape[0], -1).detach()
    l_pos = _cos(q, kp).reshape(-1, 1)
    l_neg = _cos(q[:, None, :], bank[None, :, :])
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    return -F.log_softmax(logits, dim=-1)[:, 0].mean()
