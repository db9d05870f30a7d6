#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card:
Mamba-UNet serving and training, Mamba-LM serving, Mamba-UNet training on
SS2D's time-major branch and the 1-D Mamba stack's gradients, Mamba-UNet
training and serving on SS2D's batch-folded branch, the main path's
other entry points (activation recomputation, the ``torch.export``
artifact and the CLIs, SS2D's xla route among them), then the UNet
family and Swin-UNet, the semi-supervised methods (Semi-Mamba-UNet's
cross-teaching, mean teacher and UAMT), the scribble-supervised
Weak-Mamba-UNet, and a from-scratch trainability check.

    python3 chip_smoke.py

Phases, each printing lines tagged with its name (any failure raises and
exits non-zero; nothing is caught):

1. device   - require CUDA; print ``nvidia-smi`` name and power limit.
2. build    - compile the CUDA kernels from ``mamba_unet_torch/csrc``;
              then ``[kernel_occ]``: per bidirectional, grouped (G = 4) and
              folded kernel (serving forward, state-saving forward,
              backward) at each stage shape at bs24, and the grouped ones at
              the mamba-130m shape (serving at scoring's batch 8 x 1024,
              state-saving and backward at the same shape), the grid,
              threads per block, registers (fp32 and bf16), static and
              dynamic shared memory, local bytes (spills) and the resident
              warps per SM the card reports.
3. kernel   - ``selective_scan_bidir`` (CUDA) against its plain PyTorch
              version at the four stage shapes of the 224² model, batch 2,
              and at the ragged shapes BIDIR_EDGES, fp32 and bf16 inputs;
              then both timed at batch 24, where the timed calls' outputs
              are compared again.
4. parity   - full-width Mamba-UNet (vmamba-tiny, seeded weights), batch 2
              at 224²: logits on the card (kernel) against a CPU copy (plain
              scan), fp32 with TF32 off; then bf16 serving against fp32.
5. serving  - 3 synthetic phantom volumes (10 slices, native 256x216)
              through ``cli.test.infer_volume`` at batch 24, fp32 and bf16,
              with PyTorch's TF32 defaults restored; the kernel must launch
              14 times per served forward. Then the bs24 forward timed, fp32
              and bf16, on the bidir branch and, with the same weights, on
              the tm and folded branches (their serving kernels, 14
              launches per forward).
6. kernel_bwd - the training kernels (state-saving forward: y and cs;
              backward: all seven gradients) against their plain versions
              at the four stage shapes, batch 2, and at BIDIR_EDGES, fp32
              and bf16 inputs; then both timed at batch 24 and their outputs
              compared again. cs is (B, 4, ceil(L/16), dg, 16) fp32: the
              state with which each direction enters each 16-step chunk of
              data time, in that direction's scan order.
7. grad_parity - full-width Mamba-UNet, batch 2 at 224², fp32 with TF32
              off: loss and every parameter's gradient of one
              ``supervised_ce_dice`` backward on the card against a CPU copy;
              14 state-saving forward and 14 backward launches.
8. training - ``Trainer.fit`` with the ``Loader`` on in-memory phantom
              slices (native 256x216, RandomGenerator to 224²), bs24, bf16
              autocast, drop_path 0.2, poly-SGD at 0.01, 20 iterations with
              one eval; 14 state-saving forward and 14 backward launches per
              step, 14 serving launches per eval forward; step ms, slices/s,
              peak memory, a falling loss, and a short ``torch.profiler``
              breakdown (full table in ``build/train_profile.txt``) whose
              device time per step is printed beside that of the
              earlier bidir kernels (BIDIR_STEP_DEVICE_MS_BASELINE).
9. lm_kernel - ``selective_scan_grouped`` (CUDA kernel #3) against its
              plain version, y and the final state, batch 2, fp32 and bf16,
              at (G, L, dg) = (1, 1, 1536), (1, 7, 130), (1, 1000, 1536),
              (4, 257, 192), (1, 17, 129), (2, 33, 64); then timed at the
              scoring shape (batch 8, L=1024, dg=1536) and the prefill shape
              (batch 4, L=128, with the final state), outputs compared
              again.
10. lm_parity - full-width mamba-130m (vocab 50277, seeded weights),
              batch 2 x 64 tokens: logits, prefill logits and decode states
              on the card against a CPU copy, fp32 with TF32 off.
11. lm_serving - with PyTorch's TF32 defaults: ``LMEvaluator.loglikelihood``
              on 64 seeded requests (context 100-900 tokens, continuation
              1-20) at batch 8, 24 kernel launches per scoring forward;
              greedy ``generate`` of 64 tokens after 4 prompts of 128, 24
              launches for the prefill and none for the decode steps; each
              generated token's logit within GREEDY_TOL of its position's
              maximum in one full forward.
12. tm_kernel - the grouped training kernels (state-saving forward: y and
              cs; backward: all seven gradients) against their plain
              versions, batch 2, fp32 and bf16, at the four SS2D stage
              shapes with G = 4 and at (G, L, dg) = (1, 1000, 1536),
              (1, 7, 130), (1, 17, 129), (2, 33, 48); then timed at bs24 per
              stage shape and at the mamba-130m shape (batch 8, L=1024,
              dg=1536), the timed calls' outputs compared again.
13. tm_grad_parity - phase 7 through ``MambaUnet(scan_impl="tm")``: loss
              and every gradient card vs CPU, 14 + 14 grouped launches;
              then the same weights' logits on the card through the tm and
              the bidir branch.
14. tm_training - phase 8 with ``scan_impl="tm"``: per step 14 grouped
              state-saving forward and 14 backward launches and no
              bidirectional one, 14 grouped serving launches per eval
              forward; a falling loss; step ms, slices/s, peak memory and a
              profile (``build/train_tm_profile.txt``), its device time per
              step beside the earlier backward's (TM_STEP_DEVICE_MS_BASELINE)
              and the earlier forward's (TM_STEP_DEVICE_MS_BEFORE_FWD).
15. lm_grad - full-width mamba-130m, batch 2 x 128 tokens, fp32 with TF32
              off: next-token cross-entropy and every parameter's gradient
              card vs CPU, 24 + 24 grouped launches.
16. folded_kernel - the batch-folded kernels (serving forward: y;
              state-saving forward: y and cs; backward: all seven
              gradients) against their plain versions, fp32 and bf16, at
              the four SS2D stage shapes at batch 2 and at the ragged
              FOLDED_EDGES both bidirectional and unidirectional; then
              timed at bs24 per stage shape, the timed calls' outputs
              compared again.
17. folded_grad_parity - phase 7 through ``MambaUnet(scan_impl="folded")``:
              loss and every gradient card vs CPU, 14 + 14 folded launches
              and none of the other kernels; then the same weights' logits
              on the card through the folded and the bidir branch.
18. folded_training - phase 8 with ``scan_impl="folded"``: per step 14
              folded state-saving forward and 14 backward launches and none
              of the other kernels, 14 folded serving launches per eval
              forward; a falling loss; step ms, slices/s, peak memory and a
              profile (``build/train_folded_profile.txt``), its device time
              per step beside the earlier backward's
              (FOLDED_STEP_DEVICE_MS_BASELINE) and the earlier forward's
              (FOLDED_STEP_DEVICE_MS_BEFORE_FWD).
19. remat   - one bs24 bf16 step of the bidir branch at drop_path 0.2 with
              and without ``use_remat`` from the same weights, batch and
              DropPath seed: equal loss and gradients, 28 state-saving
              forward and 14 backward launches with remat, peak memory of
              each.
20. export  - ``export_predict`` of full-width ``ViM_seg`` with a symbolic
              batch, saved to build/ and reloaded: batches 2 and 24 against
              the eager predict function (14 serving launches per call),
              fp32 and bf16, both timed at bs24 beside eager; then the tm
              and folded branches exported with the same weights; then
              full-width ``unet`` and ``ViT_seg``, batches 2 and 24 against
              eager, device ms at bs24 beside eager's.
21. entry_points - ``cli.train`` (``--synthetic_hard``,
              ``--pretrained_ckpt``, ``--exp``, ``--scan_impl xla``),
              ``cli.test`` (``--ckpt_name``, ``--save_nii_dir``: the NIfTI
              files hold the predictions) and ``cli.export`` (the artifact
              serves the snapshot's logits), in a temporary directory.
22. zoo_parity - full-width ``unet`` and ``ViT_seg`` (img 224), batch 2,
              dropout and drop_path 0, fp32 with TF32 off: eval-mode and
              train-mode logits on the card against a CPU copy, the
              BatchNorm running statistics after the train-mode forward,
              bf16 against fp32 on the card; no scan kernel launches.
23. cross_teaching_parity - one ``CrossTeachingTrainer`` step of two
              full-width ``ViM_seg``, batch 4 (2 labeled + 2 unlabeled),
              fp32 with TF32 off, drop_path 0: the loss and both models'
              every gradient card vs CPU; 28 + 28 bidir training launches.
24. zoo_training - ``Trainer.fit`` of ``unet`` and ``ViT_seg``, bs24, bf16,
              ZOO_ITERS steps with one eval: a falling loss, moved weights
              and BatchNorm buffers, no scan launch; step ms, slices/s, peak
              memory, a profile's device ms per step.
25. cross_teaching - ``CrossTeachingTrainer.fit`` of two full-width
              ``ViM_seg``, bs24 with 8 labeled, bf16, drop_path 0.2,
              CROSS_ITERS steps, one eval (at CROSS_EVAL_EVERY): per step
              28 + 28 bidir training launches and no other kernel, 14
              serving launches per eval forward of each model, both
              models moving, a falling loss, ``best_{step}`` and
              ``best2_{step}`` written exactly where each model's val Dice
              beat 0 and its earlier evals, with their marks; step ms,
              peak memory, device ms per step beside the bidir baseline;
              then a fresh pair's one step with an eval after it writes
              ``best_1`` and ``best2_1`` (from scratch both models predict
              only background after their second update).
26. mean_teacher, uamt - ``fit`` of full-width ``ViM_seg``, bs24 with 8
              labeled, bf16, EMA_ITERS steps: per step 14 (mean teacher) or
              126 (UAMT, 9 teacher passes) serving launches under no grad
              plus 14 + 14 training ones; the EMA equals alpha * ema + (1 -
              alpha) * param after a step; step ms, peak memory, device ms.
27. entry_points - ``cli.train --synthetic`` with ``--method
              mean_teacher``, ``uamt``, ``cross_teaching --model2 unet``
              (``--model ViM_seg``), ``--model unet``, ``--model ViT_seg``
              and ``--method weak_scribble`` (its default trio; launch
              counts checked), then ``cli.test --model unet`` and ``--model
              ViT_seg`` on the snapshots written, and ``--model ViM_seg
              --ckpt_name best3`` on the weak run's.
28. weak_scribble - ``WeakScribbleTrainer.fit`` of the trio on phantom
              scribbles, bs24, bf16, WEAK_ITERS steps with one eval: per
              step 14 + 14 bidir training launches (model 3), 14 serving
              launches per eval forward of model 3, none for ``unet`` and
              ``ViT_seg``; ``best``/``best2``/``best3`` written exactly
              where each model's val Dice rose above 0; step ms, peak
              memory, device ms per step beside the prediction.
29. trainability - ``ViM_seg`` from scratch under ``warmup_adamw`` (1e-3)
              on the easy phantom, bs24 bf16, 300 steps with evals at 150
              and 300: every foreground class's val Dice above 0 at the
              end.
30. weak_parity - one Weak-Mamba-UNet step of the full-width trio
              (``unet``, ``ViT_seg``, ``ViM_seg``), batch 2 at 224² on
              phantom scribbles, dropout and drop_path 0, fp32 with TF32
              off, the same mix weights and pseudo-labels: the losses and
              the three models' every gradient card vs CPU (unet's against
              its largest gradient: fp32 conditioning); 14 + 14 bidir
              training launches. Last, as its CPU backward would share the
              host with a timed phase.

``[phase_seconds]`` follows each group of phases. Then one JSON line with
the kernel table, and the last line ``{"ok": true, "device": {...}}``. It
imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SS2D_PER_FORWARD = 14  # 8 encoder + 6 decoder blocks
# (L, dg) of SS2D's scan per stage at 224², and its calls per forward
STAGES = ((3136, 192, 4), (784, 384, 4), (196, 768, 4), (49, 1536, 2))
# kernel vs plain: both read the same values (bf16 is widened exactly), so
# only the fp32 summation order differs; 1e-4 bounds that over L=3136
KERNEL_TOL = 1e-4
# (batch, L, dg) where the bidirectional kernels' tiling is ragged: dg not a
# multiple of their 16-channel tile, L not a multiple of their 16- and
# 32-step chunks (odd and even chunk counts, so the direction-pair merge
# meets in a middle chunk or not), L = 1, batch 1
BIDIR_EDGES = ((1, 97, 33), (2, 7, 130), (1, 1, 40), (1, 64, 48))
# device ms per bidir train step under the profiler with the earlier bidir
# kernels (one thread per channel running both directions of a pair), on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 5)
BIDIR_STEP_DEVICE_MS_BASELINE = 129.72
# the same per tm and per folded train step with the earlier grouped and
# folded backwards (one thread per channel holding all 16 states), on the
# same card at 700 W (PERF.md, section 5)
TM_STEP_DEVICE_MS_BASELINE = 125.31
FOLDED_STEP_DEVICE_MS_BASELINE = 112.75
# the same with the redesigned backwards and the earlier grouped and folded
# forwards (one thread per channel holding all 16 states), on the same card
# at 700 W (PERF.md, section 5)
TM_STEP_DEVICE_MS_BEFORE_FWD = 81.20
FOLDED_STEP_DEVICE_MS_BEFORE_FWD = 71.73
# full model, card vs CPU, fp32 with TF32 off: 14 scans plus the stock
# layers in another summation order
LOGIT_TOL = 1e-3
MIN_ARGMAX_AGREEMENT = 0.999
# bf16 serving against fp32 on the card: bf16 rounds every matmul/conv input
# (8-bit mantissa) through 14 blocks, and random-weight logits have near
# ties; about 4x the max abs difference and 3x the disagreement measured on
# an H100 (0.06 of logits up to 4.6; 99.4 % argmax agreement)
BF16_LOGIT_TOL = 0.25
BF16_MIN_ARGMAX_AGREEMENT = 0.98
# training kernels vs plain: 1e-4 of the reference's max abs for outputs
# per element, 1e-3 for dA/dD/ddelta_bias (sums over batch and time); a bf16
# gradient may also differ by one bf16 rounding step (utils/compare.py)
GRAD_KERNEL_TOL, GRAD_SUM_TOL = 1e-4, 1e-3
SUMMED = ("A", "D", "delta_bias")
# full model, one backward, card vs CPU, fp32 with TF32 off: every
# parameter's gradient within 1e-3 of its own max abs; the loss within 1e-5
MODEL_GRAD_TOL, LOSS_TOL = 1e-3, 1e-5
TRAIN_BATCH, TRAIN_ITERS, TRAIN_EVAL_AT, TRAIN_WARMUP = 24, 20, 12, 3
PATCH, NATIVE = 224, (256, 216)  # model input and phantom slice sizes
# mamba-130m (state-spaces/mamba-130m config.json): d_model 768, 24 layers,
# d_state 16, RMSNorm, vocab 50277 padded to a multiple of 8; one grouped
# scan (G = 1, dg = 2 * 768) per layer and forward
LM_VOCAB, LM_DEPTH, LM_DINNER = 50277, 24, 1536
# (G, L, dg) of the kernel check at batch 2: one step, ragged L and dg,
# the full width over a long L, four groups with ragged L and dg, an odd dg
# whose last group is one channel wide at L = 17 (a partial 32-step chunk
# holding a full 16-step state chunk), and L = 33 (one step past a chunk)
LM_KERNEL_SHAPES = ((1, 1, 1536), (1, 7, 130), (1, 1000, 1536),
                    (4, 257, 192), (1, 17, 129), (2, 33, 64))
# (tag, batch, L, final state) of the timed kernel calls: scoring (the
# 1024-token bucket at batch 8) and prefill (4 prompts of 128 tokens)
LM_TIMED = (("scoring", 8, 1024, False), ("prefill", 4, 128, True))
LM_REQUESTS, LM_SCORE_BATCH = 64, 8
# (G, L, dg) of the grouped training kernels' check at batch 2: the four
# SS2D stage shapes of the tm branch (G = 4), the mamba-130m width over a
# long L, a ragged L and dg with a partial last 16-step chunk, and the odd
# dg and L = 17, 33 of LM_KERNEL_SHAPES
TM_KERNEL_SHAPES = tuple((4, L, dg) for L, dg, _ in STAGES) + (
    (1, 1000, 1536), (1, 7, 130), (1, 17, 129), (2, 33, 48))
LM_TRAIN_SHAPE = (8, 1024)  # (batch, L) of the timed mamba-130m-shape call
# (batch, L, dg) of the folded kernels' ragged checks, each both ways: 390
# lanes, L not a multiple of the 16-step chunk, the last channel tile of
# each batch 2 wide; an odd dg at batch 3 (odd batches' lanes at odd
# offsets: bf16 not by pairs) with L = 17, a partial 32-step chunk holding
# a full 16-step state chunk (where a reversed direction starts); L = 33
FOLDED_EDGES = ((3, 7, 130), (3, 17, 129), (2, 33, 48))
LM_GRAD_BATCH, LM_GRAD_LEN = 2, 128  # phase 15's tokens
# remat against no remat, one bf16 step: the same kernels on the same
# inputs recomputed, so the loss and every gradient agree to fp32 noise
REMAT_TOL = 1e-5
REMAT_TIMED_STEPS = 5  # forward + backward (no optimizer) timed per side
# [entry_points]: the CLIs' phantom scale (train cases, slices per case,
# val and test volumes, slice size), batch and steps
ENTRY_SPEC, ENTRY_BATCH, ENTRY_ITERS = (4, 8, 1, 2, 224), 8, 4
LM_PROMPTS, LM_PROMPT_LEN, LM_NEW_TOKENS = 4, 128, 64
# [zoo_*]: the UNet family's and Swin-UNet's parity batch, training steps
# and eval step; bf16 against fp32 logits on the card within this share of
# the fp32 logits' max abs (the ViM bound BF16_LOGIT_TOL is 5 % of its
# logits' max); BatchNorm running statistics card vs CPU within this share
# of each tensor's max abs
ZOO_ITERS, ZOO_EVAL_AT = 10, 6
ZOO_BF16_REL_TOL, ZOO_STATS_TOL = 0.05, 1e-5
# the semi-supervised phases: labeled slices per bs24 batch; the cross-
# teaching parity step's batch (labeled + unlabeled); fit steps of
# [cross_teaching] and its eval cadence, and of [mean_teacher] / [uamt];
# UAMT's teacher passes (the consistency target + T = 8 MC passes)
SEMI_LABELED = 8
CROSS_PARITY_BATCH, CROSS_PARITY_LABELED = 4, 2
CROSS_ITERS, CROSS_EVAL_EVERY, EMA_ITERS = 10, 6, 5
UAMT_TEACHER_PASSES = 9
# EMA after a step: alpha * ema + (1 - alpha) * param in fp32
EMA_TOL = 1e-6
# [weak_parity]'s batch; [weak_scribble]'s fit steps and eval step, and
# its prediction per bs24 bf16 step, made before its first card run from
# the device ms of the bidir ViM_seg (74.35), unet (24.46) and ViT_seg
# (31.86) steps on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 5)
WEAK_PARITY_BATCH = 2
# full-width unet's gradients at batch 2 are ill-conditioned in fp32: the
# train-mode BatchNorms' backward cancels a per-channel mean, so the small
# gradients of the BatchNorm-fed layers carry rounding of the large ones
# (the card's, with cuDNN's convolutions, stand up to 4.5e-2 of such a
# tensor's own max from the CPU's on an NVIDIA H100 80GB HBM3: [weak_parity]
# prints it). So [weak_parity] holds each of unet's gradients within
# MODEL_GRAD_TOL of unet's largest gradient; ViT_seg's and ViM_seg's
# within MODEL_GRAD_TOL of their own
WEAK_ITERS, WEAK_EVAL_AT = 10, 6
WEAK_PREDICTED_DEVICE_MS, WEAK_PREDICTED_PEAK_GB = 131, 14.5
# [trainability]: ViM_seg from scratch under warmup_adamw
TRAINABILITY_ITERS, TRAINABILITY_EVAL_EVERY = 300, 150
# full mamba-130m, card vs CPU, fp32 with TF32 off: 24 scans plus fp32
# matmuls in another summation order, on logits of magnitude ~2; the
# decode states within 1e-3 of their own max
LM_LOGIT_TOL, LM_STATE_TOL = 1e-3, 1e-3
# greedy tokens (decode path: plain state update) against one full forward
# (kernel path) on the card with PyTorch's TF32 defaults (cuDNN convolutions
# in TF32): the chosen token's logit within this of the position's maximum
GREEDY_TOL = 2e-2
# the least time of a scan call: device memory at 3.35 TB/s, fp32 FLOPs
# outside the tensor cores at 67 TFLOP/s (H100 SXM data sheet), and the
# special-function unit's exp2/log/reciprocal results at 16 per clock per SM
# (CUDA C++ guide, compute capability 9.0) x 132 SMs x 1.98 GHz boost
HBM_BYTES_PER_S, FP32_FLOP_PER_S = 3.35e12, 67e12
SFU_PER_S = 16 * 132 * 1.98e9


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def scan_inputs(torch, bsz, L, dg, dtype, device, seed, streams=2, dirs=4):
    """Scan operands at the magnitudes of the initialized model: A from the
    S4D init, delta_bias from the dt init, D = 1. u has ``streams`` data
    streams, the rest ``dirs`` directions: 2 and 4 for the bidirectional
    kernels, G and G for the grouped one."""
    from mamba_unet_torch.nn.ss2d import a_log_init, dt_bias_init

    g = torch.Generator().manual_seed(seed)
    n = 16
    args = [torch.randn(bsz, streams, L, dg, generator=g),
            0.5 * torch.randn(bsz, dirs, L, dg, generator=g),
            -torch.exp(a_log_init(dirs * dg, n)),
            torch.randn(bsz, dirs, L, n, generator=g),
            torch.randn(bsz, dirs, L, n, generator=g),
            torch.ones(dirs * dg),
            dt_bias_init((dirs * dg,), g)]
    args = [a.to(device) for a in args]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(dtype)
    return args


def warm_up(fn) -> None:
    """Two calls, the first one's output alive during the second, so that
    the caching allocator holds the two output buffers the timed loop
    alternates between: otherwise the second timed call allocates one with
    cudaMalloc inside the timed window (after ``empty_cache``, a stall of up
    to 100 ms)."""
    first = fn()
    fn()
    del first


def cuda_ms(torch, fn, iters):
    """(mean ms per call over ``iters`` calls after :func:`warm_up`, the
    last call's output)."""
    warm_up(fn)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def device_ms(torch, fn, iters):
    """As :func:`cuda_ms`, but the timed calls queue up behind a ~50 ms
    sleep on the card, so that a kernel shorter than its launch from the
    host is timed, not the host's enqueue rate."""
    warm_up(fn)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # clock cycles
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def check_kernel(torch, got, want, **where) -> float:
    """Raise unless the kernel's output matches the plain version's within
    KERNEL_TOL; return the max abs error."""
    err = (got - want).abs().max().item()
    ok = (torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL)
          and bool(torch.isfinite(got).all()))
    log("kernel", **where, max_abs_err=f"{err:.3e}",
        ref_max=f"{want.abs().max():.3f}", tol=KERNEL_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"kernel disagrees at {where}: max abs err {err}")
    return err


def scan_bound(kind: str, bsz: int, L: int, dg: int, itemsize: int,
               n: int = 16, groups: int = 1, last_state: bool = False):
    """(least ms, "bytes" or "operations") of one scan call of ``kind``
    (fwd, fwd_states, bwd: the bidirectional kernels; folded,
    folded_fwd_states, folded_bwd: the batch-folded ones, whose operands
    are the bidirectional ones' but whose y and gy are four directions in
    the input dtype; grouped, grouped_fwd_states, grouped_bwd: the
    unidirectional ones over ``groups`` groups of ``dg`` channels, whose y,
    gy, du, ddelta, dB and dC are in the input dtype; ``last_state`` adds
    the serving forward's fp32 final state): each input read once, each
    output written once;
    per (direction, step, channel, state) the forward needs 1 exp and ~6
    FLOPs, the backward 1 exp (a_t = exp(dt A), which the recompute of the
    states and the reverse scan can share) and ~20 FLOPs; softplus/sigmoid
    add 2 (fwd) and 5 (bwd) special-function results per (direction, step,
    channel)."""
    if kind.startswith("grouped"):
        trip = bsz * groups * L * dg                 # (step, channel)
        io_in = (2 * trip + 2 * bsz * groups * L * n) * itemsize  # u,Δ,B,C
        params = groups * dg * (n + 2) * 4                        # A, D, bias
        cs = bsz * groups * (-(-L // 16)) * n * dg * 4
        if kind == "grouped_bwd":  # + cs, gy in; gradients of all out
            nbytes = 2 * io_in + 2 * params + cs + trip * itemsize
            exps, flops = trip * (n + 5), trip * n * 20
        else:
            nbytes = (io_in + params + trip * itemsize
                      + (cs if kind == "grouped_fwd_states" else 0)
                      + (bsz * groups * dg * n * 4 if last_state else 0))
            exps, flops = trip * (n + 2), trip * n * 6
    else:
        trip = bsz * 4 * L * dg                      # (dir, step, channel)
        io_in = (bsz * 2 * L * dg + bsz * 4 * L * dg
                 + 2 * bsz * 4 * L * n) * itemsize
        params = 4 * dg * (n + 2) * 4
        cs = bsz * 4 * (-(-L // 16)) * n * dg * 4
        # y (and gy): pair-summed fp32 streams, or four folded directions
        y = (trip * itemsize if kind.startswith("folded")
             else bsz * 2 * L * dg * 4)
        if kind.endswith("bwd"):
            nbytes = 2 * io_in + 2 * params + cs + y  # + gy in, grads out
            exps, flops = trip * (n + 5), trip * n * 20
        else:
            nbytes = (io_in + params + y
                      + (cs if kind.endswith("fwd_states") else 0))
            exps, flops = trip * (n + 2), trip * n * 6
    mem_s = nbytes / HBM_BYTES_PER_S
    ops_s = max(exps / SFU_PER_S, flops / FP32_FLOP_PER_S)
    return 1e3 * max(mem_s, ops_s), ("bytes" if mem_s >= ops_s
                                     else "operations")


def timed_once(torch, fn):
    """(ms of one call, its output), by CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def training_kernels(kind: str):
    """(state-saving forward, its plain version, backward, its plain
    version, operand names) of the ``kind`` scan: bidir, grouped, folded
    (bidirectional) or folded_uni (unidirectional)."""
    if kind == "grouped":
        from mamba_unet_torch.ops import selective_scan_grouped as m
        return (m.selective_scan_grouped_fwd_states,
                m.selective_scan_grouped_states_ref,
                m.selective_scan_grouped_bwd,
                m.selective_scan_grouped_bwd_ref, m.ARG_NAMES)
    if kind.startswith("folded"):
        from functools import partial

        from mamba_unet_torch.ops import selective_scan_folded as m
        return tuple(partial(f, bidir=kind == "folded") for f in (
            m.selective_scan_folded_fwd_states,
            m.selective_scan_folded_states_ref, m.selective_scan_folded_bwd,
            m.selective_scan_folded_bwd_ref)) + (m.ARG_NAMES,)
    from mamba_unet_torch.ops import selective_scan_bidir as m
    return (m.selective_scan_bidir_fwd_states,
            m.selective_scan_bidir_states_ref, m.selective_scan_bidir_bwd,
            m.selective_scan_bidir_bwd_ref, m.ARG_NAMES)


def check_training_kernels(torch, args, gy, phase="kernel_bwd",
                           kind="bidir", **where):
    """State-saving forward and backward of the ``kind`` scan (see
    :func:`training_kernels`) against their plain versions on the same
    inputs; returns
    ({"fwd_states": max abs error of y and cs, "bwd": of the gradients}, ms
    of the plain forward, ms of the plain backward), each plain version
    timed once."""
    from mamba_unet_torch.utils.compare import assert_close_to_max

    fwd_states, states_ref, bwd, bwd_ref, arg_names = training_kernels(
        kind)
    at = " ".join(f"{k}={v}" for k, v in where.items())
    y, cs = fwd_states(*args)
    plain_fwd, (y_ref, cs_ref) = timed_once(
        torch, lambda: states_ref(*args))
    errs = {"y": assert_close_to_max(y, y_ref, GRAD_KERNEL_TOL, f"y at {at}"),
            "cs": assert_close_to_max(cs, cs_ref, GRAD_KERNEL_TOL,
                                      f"cs at {at}")}
    del y_ref, cs_ref
    got = bwd(*args, cs, gy)
    plain_bwd, want = timed_once(torch, lambda: bwd_ref(*args, gy))
    for name, g, w in zip(arg_names, got, want):
        rel = GRAD_SUM_TOL if name in SUMMED else GRAD_KERNEL_TOL
        errs["d" + name] = assert_close_to_max(g, w, rel, f"d{name} at {at}")
    log(phase, **where, **{k: f"{v:.2e}" for k, v in errs.items()}, ok=True)
    worst = {"fwd_states": max(errs["y"], errs["cs"]),
             "bwd": max(v for k, v in errs.items() if k[0] == "d")}
    return worst, plain_fwd, plain_bwd


def kernel_bwd_phase(torch, dev):
    """Phase 6; returns {kernel: (max_err, ms per train step, plain ms per
    train step, bound ms per train step, bound_by)} for the state-saving
    forward and the backward (fp32 inputs)."""
    from mamba_unet_torch.ops.selective_scan_bidir import (
        selective_scan_bidir_bwd,
        selective_scan_bidir_fwd_states,
    )

    max_err = {"fwd_states": 0.0, "bwd": 0.0}

    def note(errs):
        for kind, err in errs.items():
            max_err[kind] = max(max_err[kind], err)

    for bsz, L, dg in [(2, L, dg) for L, dg, _ in STAGES] + list(BIDIR_EDGES):
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(torch, bsz, L, dg, dtype, dev, seed=L + 1)
            gy = torch.randn(bsz, 2, L, dg, generator=torch.Generator()
                             .manual_seed(L)).to(dev)
            errs, _, _ = check_training_kernels(
                torch, args, gy, L=L, dg=dg, batch=bsz,
                dtype=str(dtype).split(".")[-1])
            note(errs)
    tot = {k: [0.0, 0.0, 0.0] for k in ("fwd_states", "bwd")}
    bound_by = {}
    for L, dg, calls in STAGES:
        row = {}
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[-1]
            args = scan_inputs(torch, TRAIN_BATCH, L, dg, dtype, dev, 0)
            gy = torch.randn(TRAIN_BATCH, 2, L, dg, generator=torch
                             .Generator().manual_seed(1)).to(dev)
            fwd_ms, (y, cs) = cuda_ms(
                torch, lambda: selective_scan_bidir_fwd_states(*args), 20)
            bwd_ms, _ = cuda_ms(
                torch, lambda: selective_scan_bidir_bwd(*args, cs, gy), 20)
            del y, cs
            # the kernels are deterministic (no atomics): these outputs are
            # the timed calls' outputs
            errs, plain_fwd, plain_bwd = check_training_kernels(
                torch, args, gy, L=L, dg=dg, batch=TRAIN_BATCH, dtype=tag)
            note(errs)
            row[tag] = (fwd_ms, bwd_ms, plain_fwd, plain_bwd)
            del args, gy
            torch.cuda.empty_cache()
        fwd_ms, bwd_ms, plain_fwd, plain_bwd = row["float32"]
        bf = row["bfloat16"]
        stage_bound = {}
        for kind, ms, plain in (("fwd_states", fwd_ms, plain_fwd),
                                ("bwd", bwd_ms, plain_bwd)):
            bound, bound_by[kind] = scan_bound(kind, TRAIN_BATCH, L, dg, 4)
            stage_bound[kind] = bound
            tot[kind][0] += calls * ms
            tot[kind][1] += calls * plain
            tot[kind][2] += calls * bound
        log("kernel_bwd_time", L=L, dg=dg, batch=TRAIN_BATCH,
            fwd_states_ms=f"{fwd_ms:.4f}", bwd_ms=f"{bwd_ms:.4f}",
            plain_fwd_states_ms=f"{plain_fwd:.2f}",
            plain_bwd_ms=f"{plain_bwd:.2f}",
            bf16_fwd_states_ms=f"{bf[0]:.4f}", bf16_bwd_ms=f"{bf[1]:.4f}",
            bf16_plain_fwd_states_ms=f"{bf[2]:.2f}",
            bf16_plain_bwd_ms=f"{bf[3]:.2f}",
            bound_fwd_states_ms=f"{stage_bound['fwd_states']:.4f}",
            bound_bwd_ms=f"{stage_bound['bwd']:.4f}")
    for kind, (ms, plain, bound) in tot.items():
        log("kernel_bwd_time", kernel=kind, per_step_ms=f"{ms:.4f}",
            plain_per_step_ms=f"{plain:.2f}", bound_per_step_ms=f"{bound:.4f}",
            calls=SS2D_PER_FORWARD)
    return {kind: (max_err[kind], *tot[kind], bound_by[kind])
            for kind in tot}


def kernel_occ_phase(torch):
    """``[kernel_occ]``: per kernel and shape, the launch configuration and
    occupancy the card reports (grid, threads per block, registers, static
    and dynamic shared memory, local bytes per thread, which count spills),
    the resident warps per SM the occupancy calculator allows, the grid's
    warps per SM and its waves: the bidirectional, grouped (G = 4) and
    folded (bidirectional) kernels at the stage shapes at bs24, and the
    grouped ones at the mamba-130m shape (serving at scoring's batch 8)."""
    from mamba_unet_torch.ops import selective_scan_bidir as ssb
    from mamba_unet_torch.ops import selective_scan_folded as ssf
    from mamba_unet_torch.ops import selective_scan_grouped as ssg

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(kind, TRAIN_BATCH, L, dg,
              lambda b, L, dg, bf16, k=kind: ssb.kernel_occupancy(
                  k, b, L, dg, bf16))
             for kind in ("serve", "fwd_states", "bwd")
             for L, dg, _ in STAGES]
    cases += [(f"grouped_{kind}", TRAIN_BATCH, L, dg,
               lambda b, L, dg, bf16, k=kind: ssg.kernel_occupancy(
                   k, b, 4, L, dg, bf16))
              for kind in ("serve", "fwd_states", "bwd")
              for L, dg, _ in STAGES]
    bsz, L = LM_TRAIN_SHAPE  # = scoring's (LM_TIMED)
    cases += [(f"grouped_{kind}", bsz, L, LM_DINNER,
               lambda b, L, dg, bf16, k=kind: ssg.kernel_occupancy(
                   k, b, 1, L, dg, bf16))
              for kind in ("serve", "fwd_states", "bwd")]
    cases += [(f"folded_{kind}", TRAIN_BATCH, L, dg,
               lambda b, L, dg, bf16, k=kind: ssf.kernel_occupancy(
                   k, b, L, dg, bf16=bf16))
              for kind in ("serve", "fwd_states", "bwd")
              for L, dg, _ in STAGES]
    for kind, bsz, L, dg, occupancy in cases:
        occ = occupancy(bsz, L, dg, False)
        bf16 = occupancy(bsz, L, dg, True)
        blocks = occ["grid_x"] * occ["grid_y"] * occ["grid_z"]
        warps = occ["threads"] // 32
        slots = occ["blocks_per_sm"] * sms
        log("kernel_occ", kernel=kind, L=L, dg=dg, batch=bsz,
            grid=f"{occ['grid_x']}x{occ['grid_y']}x{occ['grid_z']}",
            threads=occ["threads"], registers=occ["registers"],
            bf16_registers=bf16["registers"],
            static_smem=occ["static_smem"],
            dynamic_smem=occ["dynamic_smem"],
            local_bytes=occ["local_bytes"],
            bf16_local_bytes=bf16["local_bytes"],
            blocks_per_sm=occ["blocks_per_sm"],
            max_warps_per_sm=occ["blocks_per_sm"] * warps,
            grid_warps_per_sm=f"{blocks * warps / sms:.1f}",
            waves=f"{blocks / slots:.2f}" if slots else "inf", sms=sms)


def scan_kernels(scan_impl: str):
    """((serving, state-saving forward, backward) wrappers that SS2D's
    ``scan_impl`` branch launches, the same three of each other branch
    after one another)."""
    from mamba_unet_torch.ops import selective_scan_bidir as ssb
    from mamba_unet_torch.ops import selective_scan_folded as ssf
    from mamba_unet_torch.ops import selective_scan_grouped as ssg

    branches = {
        "auto": (ssb.selective_scan_bidir,
                 ssb.selective_scan_bidir_fwd_states,
                 ssb.selective_scan_bidir_bwd),
        "tm": (ssg.selective_scan_grouped,
               ssg.selective_scan_grouped_fwd_states,
               ssg.selective_scan_grouped_bwd),
        "folded": (ssf.selective_scan_folded_fwd,
                   ssf.selective_scan_folded_fwd_states,
                   ssf.selective_scan_folded_bwd),
    }
    kernels = branches.pop(scan_impl)
    return kernels, sum(branches.values(), ())


def branch_serving_phase(torch, dev, model, batch, iters=10):
    """Phase 5, last part: ``model``'s weights served at ``batch`` through
    SS2D's tm and folded branches, fp32 and bf16: forward ms beside the
    bidir branch's, and 14 launches of the branch's serving kernel per
    forward (none of the other kernels)."""
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.utils.export import make_predict_fn

    for scan_impl in ("tm", "folded"):
        (serve, *_), others = scan_kernels(scan_impl)
        other = MambaUnet(num_classes=4, scan_impl=scan_impl, device=dev)
        other.load_state_dict(model.state_dict())
        for tag, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
            fn = make_predict_fn(other, dtype)
            before = [k.launches for k in (serve, *others)]
            ms, out = cuda_ms(torch, lambda: fn(batch), iters)
            launched = [k.launches - b
                        for k, b in zip((serve, *others), before)]
            log("serving", scan_impl=scan_impl, dtype=tag,
                batch=len(batch), forward_ms=f"{ms:.2f}",
                slices_per_s=f"{len(batch) / ms * 1e3:.1f}",
                launches=launched[0])
            # cuda_ms runs two warm-up forwards before the timed ones
            want = [SS2D_PER_FORWARD * (iters + 2)] + [0] * len(others)
            if launched != want or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{scan_impl} serving launched "
                                     f"{launched}, expected {want}")
        del other


def grad_parity_phase(torch, dev, scan_impl="auto"):
    """Phases 7, 13 and 17: one full-width backward on the card against a
    CPU copy, through SS2D's ``scan_impl`` branch (14 state-saving forward
    and 14 backward launches of its kernels, none of the other branches');
    returns the card model."""
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.objectives import supervised_ce_dice

    phase = "grad_parity" if scan_impl == "auto" else f"{scan_impl}_grad_parity"
    kernels, others = scan_kernels(scan_impl)
    gen = torch.Generator().manual_seed(2)
    cpu_model = MambaUnet(num_classes=4, drop_path_rate=0.0,
                          scan_impl=scan_impl,
                          generator=torch.Generator().manual_seed(0))
    model = MambaUnet(num_classes=4, drop_path_rate=0.0, scan_impl=scan_impl,
                      device=dev)
    model.load_state_dict(cpu_model.state_dict())
    x = torch.randn(2, PATCH, PATCH, 1, generator=gen)
    label = torch.randint(0, 4, (2, PATCH, PATCH), generator=gen)
    losses, grads, secs = {}, {}, {}
    for tag, m in (("gpu", model), ("cpu", cpu_model)):
        d = next(m.parameters()).device
        before = [k.launches for k in kernels + others]
        t0 = time.perf_counter()
        loss = supervised_ce_dice(m.train()(x.to(d)), label.to(d))
        loss.backward()
        losses[tag] = loss.item()
        grads[tag] = {k: p.grad.cpu() for k, p in m.named_parameters()}
        secs[tag] = time.perf_counter() - t0
        if tag == "gpu":
            launched = [k.launches - b
                        for k, b in zip(kernels + others, before)]
            if launched != [0, SS2D_PER_FORWARD, SS2D_PER_FORWARD] + [
                    0] * len(others):
                raise AssertionError(f"one backward launched {launched} "
                                     f"(serve, fwd_states, bwd of the "
                                     f"{scan_impl} branch, then the others)")
    worst, worst_key = 0.0, None
    for k, want in grads["cpu"].items():
        scale = want.abs().max().item()
        rel = (grads["gpu"][k] - want).abs().max().item() / max(scale, 1e-30)
        if not math.isfinite(rel) or rel > worst:
            worst, worst_key = rel, k
    loss_err = abs(losses["gpu"] - losses["cpu"]) / abs(losses["cpu"])
    log(phase, params=len(grads["cpu"]), loss_gpu=losses["gpu"],
        loss_cpu=losses["cpu"], loss_rel_err=f"{loss_err:.2e}",
        worst_grad_rel_err=f"{worst:.2e}", worst_param=worst_key,
        tol=MODEL_GRAD_TOL, gpu_s=f"{secs['gpu']:.2f}",
        cpu_s=f"{secs['cpu']:.2f}")
    if not (worst <= MODEL_GRAD_TOL and loss_err <= LOSS_TOL):
        raise AssertionError(f"card gradients disagree with the CPU: worst "
                             f"{worst} at {worst_key}, loss rel err "
                             f"{loss_err}")
    return model


def branch_logits_phase(torch, dev, model, scan_impl):
    """Phases 13 and 17, second half: the same weights give the same logits
    on the card through SS2D's ``scan_impl`` branch (its serving kernel)
    and its bidir branch (the bidirectional serving kernel)."""
    from mamba_unet_torch.models.vssm import MambaUnet

    (serve, _, _), _ = scan_kernels(scan_impl)
    (bidir, _, _), _ = scan_kernels("auto")
    other = MambaUnet(num_classes=4, drop_path_rate=0.0, device=dev)
    other.load_state_dict(model.state_dict())
    x = torch.randn(2, PATCH, PATCH, 1,
                    generator=torch.Generator().manual_seed(3)).to(dev)
    before = (serve.launches, bidir.launches)
    with torch.inference_mode():
        got = model.eval()(x).cpu()
        bi = other.eval()(x).cpu()
    launched = (serve.launches - before[0], bidir.launches - before[1])
    err = (got - bi).abs().max().item()
    log(f"{scan_impl}_grad_parity", compare=f"{scan_impl}_vs_bidir_logits",
        max_abs_err=f"{err:.3e}", logit_max=f"{bi.abs().max():.3f}",
        tol=LOGIT_TOL, **{f"launches_{scan_impl}_bidir": launched})
    if launched != (SS2D_PER_FORWARD, SS2D_PER_FORWARD):
        raise AssertionError(f"serving launches {launched}")
    if not torch.isfinite(got).all() or err > LOGIT_TOL:
        raise AssertionError(f"{scan_impl} logits differ from bidir logits: "
                             f"{err}")


def training_phase(torch, dev, scan_impl="auto"):
    """Phases 8, 14 and 18: TRAIN_ITERS steps with one eval after step
    TRAIN_EVAL_AT; returns the launch counts (serve,
    fwd_states, bwd) of the ``scan_impl`` branch's kernels in the run."""
    from mamba_unet_torch.data.acdc import SliceDataset
    from mamba_unet_torch.data.augment import RandomGenerator
    from mamba_unet_torch.data.loader import Loader
    from mamba_unet_torch.data.sampler import EpochShuffleSampler
    from mamba_unet_torch.data.synthetic import phantom_acdc
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.train import TrainConfig, Trainer

    phase = "training" if scan_impl == "auto" else f"{scan_impl}_training"
    kernels, others = scan_kernels(scan_impl)
    splits = phantom_acdc(8, 8, 2, 0, *NATIVE, seed=0)
    cfg = TrainConfig(base_lr=0.01, max_iterations=TRAIN_ITERS,
                      batch_size=TRAIN_BATCH, patch_size=(PATCH, PATCH),
                      num_classes=4, eval_every=TRAIN_EVAL_AT,
                      log_every=1, seed=1337, bf16=True)
    model = MambaUnet(num_classes=4, drop_path_rate=0.2, scan_impl=scan_impl,
                      generator=torch.Generator().manual_seed(1337))
    trainer = Trainer(model, cfg, device=dev)
    before = {k: v.detach().clone() for k, v in
              trainer.model.state_dict().items()}
    train_ds = SliceDataset.from_samples(
        splits["train"], transform=RandomGenerator((PATCH, PATCH),
                                                   seed=1337))
    loader = Loader(train_ds, EpochShuffleSampler(len(train_ds), TRAIN_BATCH,
                                                  seed=1337), device=dev)
    marks = []  # (time, counts) synchronised before each batch is handed out

    def counted(batches):
        for batch in batches:
            torch.cuda.synchronize()
            marks.append((time.perf_counter(),
                          tuple(k.launches for k in kernels + others)))
            yield batch

    torch.cuda.reset_peak_memory_stats()
    for k in kernels + others:
        k.launches = 0
    result = trainer.fit(counted(loader), splits["val"])
    launches = tuple(k.launches for k in kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = [h["loss"] for h in result["history"] if "loss" in h]
    dice = [h["val_dice"] for h in result["history"] if "val_dice" in h]
    if result["iterations"] != TRAIN_ITERS or len(losses) != TRAIN_ITERS:
        raise AssertionError(f"fit ran {result['iterations']} iterations, "
                             f"logged {len(losses)} losses")
    if not all(math.isfinite(v) for v in losses) or len(dice) != 1:
        raise AssertionError(f"losses {losses}, evals {dice}")
    if not sum(losses[-5:]) < sum(losses[:5]):
        raise AssertionError(f"the loss did not fall: {losses}")
    changed = sum(not torch.equal(v, trainer.model.state_dict()[k])
                  for k, v in before.items())
    n_val_slices = sum(len(v["image"]) for v in splits["val"])
    eval_fwd = math.ceil(n_val_slices / cfg.eval_batch_size)
    step_ms = []
    for i in range(1, len(marks)):
        (t0, c0), (t1, c1) = marks[i - 1], marks[i]
        d = [b - a for a, b in zip(c0, c1)]
        evaled = i == TRAIN_EVAL_AT
        want = [SS2D_PER_FORWARD * eval_fwd if evaled else 0,
                SS2D_PER_FORWARD, SS2D_PER_FORWARD] + [0] * len(others)
        if d != want:
            raise AssertionError(f"step {i}: launches (serve, fwd_states, "
                                 f"bwd of the {scan_impl} branch, then the "
                                 f"others) {d}, expected {want}")
        if i > TRAIN_WARMUP and not evaled:
            step_ms.append(1e3 * (t1 - t0))
    step_ms.sort()
    med = step_ms[len(step_ms) // 2]
    log(phase, iterations=result["iterations"], batch=TRAIN_BATCH,
        patch=f"{PATCH}x{PATCH}", native="x".join(map(str, NATIVE)),
        dtype="bf16", drop_path=0.2, scan_impl=scan_impl,
        launches_serve_fwd_states_bwd=launches,
        params_changed=f"{changed}/{len(before)}", val_dice=f"{dice[0]:.4f}",
        eval_forwards=eval_fwd)
    log(phase, losses=" ".join(f"{v:.4f}" for v in losses))
    log(phase, step_ms_median=f"{med:.2f}",
        step_ms_min=f"{step_ms[0]:.2f}", step_ms_max=f"{step_ms[-1]:.2f}",
        steps_timed=len(step_ms),
        slices_per_s=f"{TRAIN_BATCH / med * 1e3:.1f}",
        peak_mem_gb=f"{peak_gb:.2f}")
    if changed < 0.99 * len(before):
        raise AssertionError(f"only {changed}/{len(before)} tensors changed")
    device_ms = profile_steps(
        torch, trainer, loader,
        "train" if scan_impl == "auto" else f"train_{scan_impl}")
    baseline = {"auto": BIDIR_STEP_DEVICE_MS_BASELINE,
                "tm": TM_STEP_DEVICE_MS_BASELINE,
                "folded": FOLDED_STEP_DEVICE_MS_BASELINE}.get(scan_impl)
    before_fwd = {"tm": TM_STEP_DEVICE_MS_BEFORE_FWD,
                  "folded": FOLDED_STEP_DEVICE_MS_BEFORE_FWD}.get(scan_impl)
    log(phase, device_ms_per_step=f"{device_ms:.2f}",
        **({} if baseline is None else {
            "baseline_device_ms_per_step": baseline,
            "change": f"{device_ms / baseline - 1:+.1%}"}),
        **({} if before_fwd is None else {
            "before_fwd_device_ms_per_step": before_fwd,
            "change_fwd": f"{device_ms / before_fwd - 1:+.1%}"}))
    return launches


def profile_steps(torch, trainer, loader, path, steps=3):
    """Device time by kernel over ``steps`` train steps on pre-loaded
    batches, after one warm-up step (``[profile] path=...``); returns the
    device ms per step."""
    batches = []
    for batch in loader:
        batches.append(batch)
        if len(batches) == steps:
            break
    trainer.train_step(batches[0])
    return profile_calls(torch, path, [lambda b=b: trainer.train_step(b)
                                       for b in batches])


def profile_calls(torch, path, calls, top=12):
    """Device time by kernel over the ``calls`` (torch.profiler), each one
    step of ``path``; prints the largest, writes the table to
    build/{path}_profile.txt and returns the device ms per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = len(calls)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3 / steps, e.count / steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / f"{path}_profile.txt").write_text(
        f"ms per step, launches per step, kernel ({steps} steps, wall "
        f"{wall_ms:.2f} ms/step, device busy {busy:.2f} ms/step)\n"
        + "\n".join(f"{ms:9.3f} {n:7.1f}  {k}" for ms, n, k in rows))
    log("profile", path=path, steps=steps, wall_ms_per_step=f"{wall_ms:.2f}",
        device_ms_per_step=f"{busy:.2f}",
        busy_share=f"{busy / wall_ms:.3f}" if rows else "not measured")
    for ms, n, key in rows[:top]:
        log("profile", path=path, ms_per_step=f"{ms:.3f}",
            launches_per_step=f"{n:.0f}", kernel=key[:90].replace(" ", "_"))
    return busy


def grouped_args(torch, bsz, L, G, dg, dtype, dev, seed):
    """scan_inputs of the grouped scan, with A drawn per (channel, state) and
    D per channel, as a trained checkpoint has them, so that a kernel
    reading another channel's or group's row disagrees."""
    args = scan_inputs(torch, bsz, L, dg, dtype, dev, seed, G, G)
    g = torch.Generator().manual_seed(seed + 1)
    args[2] = -torch.exp(0.5 * torch.randn(G * dg, 16, generator=g))
    args[5] = torch.randn(G * dg, generator=g)
    args[2], args[5] = args[2].to(dev), args[5].to(dev)
    return args


def lm_kernel_phase(torch, dev):
    """Phase 9; returns (max abs err, {tag: (ms, plain ms, bound ms,
    bound_by)}) of the grouped kernel, fp32 inputs at the timed shapes."""
    from mamba_unet_torch.ops.selective_scan_grouped import (
        selective_scan_grouped,
        selective_scan_grouped_ref,
    )
    from mamba_unet_torch.utils.compare import assert_close_to_max

    def check(args, last_state, out=None, **where):
        """Hold the kernel's ``out`` (launched here when not given)
        against the plain version on ``args``."""
        at = " ".join(f"{k}={v}" for k, v in where.items())
        if out is None:
            out = selective_scan_grouped(*args, True, last_state)
        plain, want = timed_once(
            torch, lambda: selective_scan_grouped_ref(*args, True,
                                                      last_state))
        if not last_state:
            out, want = (out,), (want,)
        errs = [assert_close_to_max(g, w, KERNEL_TOL, f"{name} at {at}")
                for name, g, w in zip(("y", "last_state"), out, want)]
        log("lm_kernel", **where, max_abs_err=f"{max(errs):.3e}",
            tol=KERNEL_TOL, ok=True)
        return max(errs), plain

    max_err = 0.0
    for G, L, dg in LM_KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            args = grouped_args(torch, 2, L, G, dg, dtype, dev, L)
            err, _ = check(args, True, G=G, L=L, dg=dg, batch=2,
                           dtype=str(dtype).split(".")[-1])
            max_err = max(max_err, err)
    times = {}
    for tag, bsz, L, last_state in LM_TIMED:
        args = grouped_args(torch, bsz, L, 1, LM_DINNER, torch.float32, dev,
                            0)
        ms, out = device_ms(torch, lambda: selective_scan_grouped(
            *args, True, last_state), 20)
        err, plain = check(args, last_state, out, G=1, L=L, dg=LM_DINNER,
                           batch=bsz, dtype="float32")
        max_err = max(max_err, err)
        bound, by = scan_bound("grouped", bsz, L, LM_DINNER, 4,
                               last_state=last_state)
        times[tag] = (ms, plain, bound, by)
        log("lm_kernel_time", path=tag, batch=bsz, L=L, dg=LM_DINNER,
            ms=f"{ms:.4f}", plain_ms=f"{plain:.2f}", bound_ms=f"{bound:.4f}",
            bound_by=by, per_forward_ms=f"{LM_DEPTH * ms:.3f}",
            calls=LM_DEPTH)
        del args
    return max_err, times


def seeded_lm(torch, dev):
    """Full-width mamba-130m with seeded weights, on the CPU and a copy on
    the card. The init gives every channel the same A_log row and D = 1, a
    trained checkpoint a different one in each: they are perturbed per
    channel."""
    from mamba_unet_torch.models.mamba_lm import MambaLMHeadModel

    cpu_model = MambaLMHeadModel(LM_VOCAB,
                                 generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in cpu_model.named_parameters():
            if name.endswith(("A_log", ".D")):
                p.add_(0.5 * torch.randn(p.shape, generator=g))
    model = MambaLMHeadModel(LM_VOCAB, device=dev)
    model.load_state_dict(cpu_model.state_dict())
    return cpu_model, model


def lm_parity_phase(torch, dev):
    """Phase 10: full-width mamba-130m (seeded weights) on the card against
    a CPU copy, fp32 with TF32 off; returns the card model."""
    from mamba_unet_torch.utils.compare import assert_close_to_max

    cpu_model, model = seeded_lm(torch, dev)
    cpu_model.eval(), model.eval()
    ids = torch.randint(0, LM_VOCAB, (2, 64),
                        generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        t0 = time.perf_counter()
        got = model(ids.to(dev)).cpu()
        gpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = cpu_model(ids)
        cpu_s = time.perf_counter() - t0
        err = (got - want).abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        log("lm_parity", shape=tuple(got.shape), params=sum(
            p.numel() for p in model.parameters()),
            max_abs_err=f"{err:.3e}", logit_max=f"{want.abs().max():.3f}",
            argmax_agree=f"{agree:.4f}", tol=LM_LOGIT_TOL,
            gpu_s=f"{gpu_s:.2f}", cpu_s=f"{cpu_s:.2f}")
        if got.shape != (2, 64, model.padded_vocab) or not bool(
                torch.isfinite(got).all()):
            raise AssertionError(f"bad logits: {tuple(got.shape)}")
        if err > LM_LOGIT_TOL:
            raise AssertionError(f"card logits disagree with the CPU: max "
                                 f"abs err {err}")
        logits, caches = model.prefill(ids.to(dev))
        want_logits, want_caches = cpu_model.prefill(ids)
        err = (logits.cpu() - want_logits).abs().max().item()
        if err > LM_LOGIT_TOL:
            raise AssertionError(f"prefill logits disagree: {err}")
        state_err = 0.0
        for i, (g, w) in enumerate(zip(caches, want_caches)):
            for name, gs, ws in zip(("conv", "ssm"), g, w):
                state_err = max(state_err, assert_close_to_max(
                    gs.cpu(), ws, LM_STATE_TOL, f"layer {i} {name} state"))
        log("lm_parity", compare="prefill", logits_max_abs_err=f"{err:.3e}",
            state_max_abs_err=f"{state_err:.3e}", tol=LM_LOGIT_TOL,
            state_tol=LM_STATE_TOL)
    return model


def lm_serving_phase(torch, np, dev, model):
    """Phase 11, with PyTorch's TF32 defaults: scoring through
    ``LMEvaluator.loglikelihood`` and greedy ``generate``; returns the
    grouped kernel's launches in the run."""
    from mamba_unet_torch.eval.lm_eval import LMEvaluator
    from mamba_unet_torch.models.mamba_lm import generate
    from mamba_unet_torch.ops import selective_scan_bidir as ssb
    from mamba_unet_torch.ops.selective_scan_grouped import (
        selective_scan_grouped,
    )

    rng = np.random.default_rng(0)

    def tokens(lo, hi):
        return rng.integers(0, LM_VOCAB, int(rng.integers(lo, hi))).tolist()

    reqs = [(tokens(100, 901), tokens(1, 21)) for _ in range(LM_REQUESTS)]
    prompts = torch.from_numpy(rng.integers(
        0, LM_VOCAB, (LM_PROMPTS, LM_PROMPT_LEN)))
    ev = LMEvaluator(model, batch_size=LM_SCORE_BATCH)
    ev.loglikelihood(reqs[:LM_SCORE_BATCH])  # first-call set-up (cuBLAS)
    generate(model, prompts, max_new_tokens=2)
    torch.cuda.synchronize()

    kernels = (selective_scan_grouped, ssb.selective_scan_bidir,
               ssb.selective_scan_bidir_fwd_states,
               ssb.selective_scan_bidir_bwd)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    scores = ev.loglikelihood(reqs)
    score_s = time.perf_counter() - t0
    score_launches = selective_scan_grouped.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(model, prompts, max_new_tokens=LM_NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = [k.launches for k in kernels]

    forwards = math.ceil(LM_REQUESTS / LM_SCORE_BATCH)
    n_tok = sum(len(c) + len(x) for c, x in reqs)
    n_cont = sum(len(x) for _, x in reqs)
    log("lm_serving", path="scoring", requests=LM_REQUESTS,
        batch=LM_SCORE_BATCH, forwards=forwards, launches=score_launches,
        expected=LM_DEPTH * forwards, seconds=f"{score_s:.3f}",
        requests_per_s=f"{LM_REQUESTS / score_s:.1f}",
        tokens_per_s=f"{n_tok / score_s:.0f}",
        scored_tokens_per_s=f"{n_cont / score_s:.1f}")
    if score_launches != LM_DEPTH * forwards:
        raise AssertionError(f"scoring launched the kernel {score_launches} "
                             f"times, expected {LM_DEPTH} per forward")
    if not all(math.isfinite(ll) and ll <= 0 for ll, _ in scores):
        raise AssertionError(f"bad loglikelihoods {scores[:4]}")

    gen_launches = launches[0] - score_launches
    with torch.inference_mode():
        prefill_ms, _ = cuda_ms(torch, lambda: model.prefill(prompts.to(dev)),
                                5)
    step_ms = (1e3 * gen_s - prefill_ms) / (LM_NEW_TOKENS - 1)
    log("lm_serving", path="generate", prompts=LM_PROMPTS,
        prompt_len=LM_PROMPT_LEN, new_tokens=LM_NEW_TOKENS,
        launches=gen_launches, expected=LM_DEPTH,
        generate_ms=f"{1e3 * gen_s:.1f}", prefill_ms=f"{prefill_ms:.3f}",
        decode_step_ms=f"{step_ms:.3f}",
        tokens_per_s=f"{LM_PROMPTS * LM_NEW_TOKENS / gen_s:.1f}")
    if gen_launches != LM_DEPTH or any(launches[1:]):
        raise AssertionError(f"generate launched the grouped kernel "
                             f"{gen_launches} times (expected {LM_DEPTH}: "
                             f"one prefill, no decode step), the bidir "
                             f"kernels {launches[1:]}")

    # greedy consistency: each generated token is its position's argmax in
    # one full forward, up to GREEDY_TOL
    if out.shape != (LM_PROMPTS, LM_PROMPT_LEN + LM_NEW_TOKENS):
        raise AssertionError(f"generated {tuple(out.shape)}")
    with torch.inference_mode():
        logits = model(out[:, :-1])[:, LM_PROMPT_LEN - 1:]
    chosen = logits.gather(-1, out[:, LM_PROMPT_LEN:, None])[..., 0]
    gap = (logits.max(-1).values - chosen).max().item()
    log("lm_serving", check="greedy_vs_forward", positions=chosen.numel(),
        worst_gap=f"{gap:.3e}", tol=GREEDY_TOL,
        exact_argmax=f"{(chosen == logits.max(-1).values).float().mean():.4f}")
    if not gap <= GREEDY_TOL:
        raise AssertionError(f"a greedy token is {gap} below its position's "
                             f"max logit in the full forward")

    # where the time goes: one scoring forward of the 1024 bucket at batch
    # 8, and 3 decode steps at batch 4
    ids = torch.from_numpy(rng.integers(0, LM_VOCAB, (LM_SCORE_BATCH, 1024)))
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        ev._score(ids.to(dev), mask.to(dev))
        profile_calls(torch, "lm_scoring", [
            lambda: ev._score(ids.to(dev), mask.to(dev))], top=8)
        token = out[:, -1].to(dev)
        _, caches = model.prefill(out.to(dev))
        model.decode_step(token, caches)
        profile_calls(torch, "lm_decode", [
            lambda: model.decode_step(token, caches)] * 3, top=8)
    return launches[0]


def tm_kernel_phase(torch, dev):
    """Phase 12; returns {kernel: (max_err, ms per train step, plain ms per
    train step, bound ms per train step, bound_by)} of the grouped
    state-saving forward and backward, fp32 inputs at bs24, summed over the
    14 SS2D calls of the tm branch."""
    fwd_states, _, bwd, _, _ = training_kernels("grouped")
    max_err = {"fwd_states": 0.0, "bwd": 0.0}

    def check(args, gy, **where):
        errs, plain_fwd, plain_bwd = check_training_kernels(
            torch, args, gy, "tm_kernel", "grouped", **where)
        for kind, err in errs.items():
            max_err[kind] = max(max_err[kind], err)
        return plain_fwd, plain_bwd

    def cotangent(args, seed):
        return torch.randn(args[0].shape, generator=torch.Generator()
                           .manual_seed(seed)).to(dev, args[0].dtype)

    for G, L, dg in TM_KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            args = grouped_args(torch, 2, L, G, dg, dtype, dev, L + dg)
            check(args, cotangent(args, L), G=G, L=L, dg=dg, batch=2,
                  dtype=str(dtype).split(".")[-1])

    def timed(bsz, G, L, dg, dtype):
        """(fwd_states ms, bwd ms, plain fwd ms, plain bwd ms); the timed
        calls' outputs are held against the plain versions (the kernels
        are deterministic: no atomics)."""
        args = grouped_args(torch, bsz, L, G, dg, dtype, dev, 0)
        gy = cotangent(args, 1)
        fwd_ms, (y, cs) = device_ms(torch, lambda: fwd_states(*args), 20)
        bwd_ms, _ = device_ms(torch, lambda: bwd(*args, cs, gy), 20)
        del y, cs
        plain = check(args, gy, G=G, L=L, dg=dg, batch=bsz,
                      dtype=str(dtype).split(".")[-1])
        del args, gy
        torch.cuda.empty_cache()
        return (fwd_ms, bwd_ms, *plain)

    tot = {k: [0.0, 0.0, 0.0] for k in ("fwd_states", "bwd")}
    bound_by = {}
    for L, dg, calls in STAGES:
        fwd_ms, bwd_ms, plain_fwd, plain_bwd = timed(TRAIN_BATCH, 4, L, dg,
                                                     torch.float32)
        bf = timed(TRAIN_BATCH, 4, L, dg, torch.bfloat16)
        stage_bound = {}
        for kind, ms, plain in (("fwd_states", fwd_ms, plain_fwd),
                                ("bwd", bwd_ms, plain_bwd)):
            bound, bound_by[kind] = scan_bound(f"grouped_{kind}", TRAIN_BATCH,
                                               L, dg, 4, groups=4)
            stage_bound[kind] = bound
            tot[kind][0] += calls * ms
            tot[kind][1] += calls * plain
            tot[kind][2] += calls * bound
        log("tm_kernel_time", L=L, dg=dg, G=4, batch=TRAIN_BATCH,
            fwd_states_ms=f"{fwd_ms:.4f}", bwd_ms=f"{bwd_ms:.4f}",
            plain_fwd_states_ms=f"{plain_fwd:.2f}",
            plain_bwd_ms=f"{plain_bwd:.2f}",
            bf16_fwd_states_ms=f"{bf[0]:.4f}", bf16_bwd_ms=f"{bf[1]:.4f}",
            bf16_bound_fwd_states_ms=f"""{scan_bound(
                "grouped_fwd_states", TRAIN_BATCH, L, dg, 2, groups=4)[0]:.4f}""",
            bf16_bound_bwd_ms=f"""{scan_bound(
                "grouped_bwd", TRAIN_BATCH, L, dg, 2, groups=4)[0]:.4f}""",
            bound_fwd_states_ms=f"{stage_bound['fwd_states']:.4f}",
            bound_bwd_ms=f"{stage_bound['bwd']:.4f}")
    for kind, (ms, plain, bound) in tot.items():
        log("tm_kernel_time", kernel=kind, per_step_ms=f"{ms:.4f}",
            plain_per_step_ms=f"{plain:.2f}", bound_per_step_ms=f"{bound:.4f}",
            calls=SS2D_PER_FORWARD)
    bsz, L = LM_TRAIN_SHAPE
    fwd_ms, bwd_ms, plain_fwd, plain_bwd = timed(bsz, 1, L, LM_DINNER,
                                                 torch.float32)
    log("tm_kernel_time", path="lm", batch=bsz, L=L, dg=LM_DINNER,
        fwd_states_ms=f"{fwd_ms:.4f}", bwd_ms=f"{bwd_ms:.4f}",
        plain_fwd_states_ms=f"{plain_fwd:.2f}",
        plain_bwd_ms=f"{plain_bwd:.2f}",
        bound_fwd_states_ms=f"""{scan_bound(
            "grouped_fwd_states", bsz, L, LM_DINNER, 4)[0]:.4f}""",
        bound_bwd_ms=f"{scan_bound('grouped_bwd', bsz, L, LM_DINNER, 4)[0]:.4f}",
        calls_per_step=LM_DEPTH)
    return {kind: (max_err[kind], *tot[kind], bound_by[kind])
            for kind in tot}


def folded_args(torch, bsz, L, dg, dtype, dev, seed, bidir=True):
    """Operands of the folded scan at the magnitudes of
    :func:`grouped_args` (A drawn per channel and state, D per channel),
    folded: u and delta (·, L, batch * dg), B and C (G, L, N, batch); G = 4
    directions over 2 streams (bidirectional) or 2 over their own."""
    G = 4 if bidir else 2
    args = grouped_args(torch, bsz, L, G, dg, dtype, dev, seed)
    if bidir:
        args[0] = args[0][:, :2]
    for i in (0, 1):
        args[i] = args[i].permute(1, 2, 0, 3).reshape(-1, L, bsz * dg)
    for i in (3, 4):
        args[i] = args[i].permute(1, 2, 3, 0)
    return [a.contiguous() for a in args]


def folded_kernel_phase(torch, dev):
    """Phase 16; returns {kernel: (max_err, ms, plain ms, bound ms,
    bound_by)} of the folded serving forward (per served forward), and of
    the state-saving forward and the backward (per train step), fp32 inputs
    at bs24, summed over the 14 SS2D calls."""
    from mamba_unet_torch.ops import selective_scan_folded as sf
    from mamba_unet_torch.utils.compare import assert_close_to_max

    max_err = {"serve": 0.0, "fwd_states": 0.0, "bwd": 0.0}

    def check(args, gy, bidir=True, y=None, **where):
        """The serving forward's ``y`` (launched here when not given) and
        the training pair against their plain versions; returns the plain
        versions' ms (serve, fwd_states, bwd)."""
        at = " ".join(f"{k}={v}" for k, v in where.items())
        if y is None:
            y = sf.selective_scan_folded_fwd(*args, bidir=bidir)
        plain, want = timed_once(
            torch, lambda: sf.selective_scan_folded_ref(*args, bidir=bidir))
        err = assert_close_to_max(y, want, KERNEL_TOL, f"serving y at {at}")
        max_err["serve"] = max(max_err["serve"], err)
        log("folded_kernel", **where, serve_y=f"{err:.2e}", ok=True)
        del y, want
        errs, plain_fwd, plain_bwd = check_training_kernels(
            torch, args, gy, "folded_kernel",
            "folded" if bidir else "folded_uni", **where)
        for kind, e in errs.items():
            max_err[kind] = max(max_err[kind], e)
        return plain, plain_fwd, plain_bwd

    def cotangent(args, seed):
        return torch.randn(args[1].shape, generator=torch.Generator()
                           .manual_seed(seed)).to(dev, args[0].dtype)

    shapes = [(2, L, dg, True) for L, dg, _ in STAGES] + [
        (*shape, bidir) for shape in FOLDED_EDGES for bidir in (True, False)]
    for bsz, L, dg, bidir in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            args = folded_args(torch, bsz, L, dg, dtype, dev, L + dg, bidir)
            check(args, cotangent(args, L), bidir, batch=bsz, L=L, dg=dg,
                  route="bidir" if bidir else "uni",
                  dtype=str(dtype).split(".")[-1])

    def timed(L, dg, dtype):
        """(serve, fwd_states, bwd ms, then their plain versions' ms) at
        bs24; the timed calls' outputs are held against the plain versions
        (the kernels are deterministic: no atomics)."""
        args = folded_args(torch, TRAIN_BATCH, L, dg, dtype, dev, 0)
        gy = cotangent(args, 1)
        serve_ms, y = device_ms(
            torch, lambda: sf.selective_scan_folded_fwd(*args), 20)
        fwd_ms, (_, cs) = device_ms(
            torch, lambda: sf.selective_scan_folded_fwd_states(*args), 20)
        bwd_ms, _ = device_ms(
            torch, lambda: sf.selective_scan_folded_bwd(*args, cs, gy), 20)
        del cs
        plain = check(args, gy, y=y, batch=TRAIN_BATCH, L=L, dg=dg,
                      route="bidir", dtype=str(dtype).split(".")[-1])
        del args, gy, y
        torch.cuda.empty_cache()
        return (serve_ms, fwd_ms, bwd_ms, *plain)

    kinds = ("serve", "fwd_states", "bwd")
    tot = {k: [0.0, 0.0, 0.0] for k in kinds}
    bound_by = {}
    for L, dg, calls in STAGES:
        fp32 = timed(L, dg, torch.float32)
        ms, plain = dict(zip(kinds, fp32)), dict(zip(kinds, fp32[3:]))
        bf = timed(L, dg, torch.bfloat16)
        stage = {}
        for kind in kinds:
            bkind = "folded" if kind == "serve" else f"folded_{kind}"
            bound, bound_by[kind] = scan_bound(bkind, TRAIN_BATCH, L, dg, 4)
            stage[kind] = (bound, scan_bound(bkind, TRAIN_BATCH, L, dg, 2)[0])
            tot[kind][0] += calls * ms[kind]
            tot[kind][1] += calls * plain[kind]
            tot[kind][2] += calls * bound
        log("folded_kernel_time", L=L, dg=dg, batch=TRAIN_BATCH,
            **{f"{k}_ms": f"{ms[k]:.4f}" for k in kinds},
            **{f"plain_{k}_ms": f"{plain[k]:.2f}" for k in kinds},
            **{f"bf16_{k}_ms": f"{v:.4f}" for k, v in zip(kinds, bf)},
            **{f"bound_{k}_ms": f"{v[0]:.4f}" for k, v in stage.items()},
            **{f"bf16_bound_{k}_ms": f"{v[1]:.4f}"
               for k, v in stage.items()})
    for kind, (ms, plain, bound) in tot.items():
        log("folded_kernel_time", kernel=kind,
            **{"per_forward_ms" if kind == "serve" else "per_step_ms":
               f"{ms:.4f}"},
            plain_ms=f"{plain:.2f}", bound_ms=f"{bound:.4f}",
            calls=SS2D_PER_FORWARD)
    return {kind: (max_err[kind], *tot[kind], bound_by[kind])
            for kind in tot}


def lm_grad_phase(torch, dev):
    """Phase 15: full-width mamba-130m, next-token cross-entropy and every
    parameter's gradient on the card against a CPU copy, fp32 with TF32
    off; 24 grouped state-saving forward and 24 backward launches."""
    import torch.nn.functional as F

    (serve, fwd_states, bwd), others = scan_kernels("tm")
    cpu_model, model = seeded_lm(torch, dev)
    ids = torch.randint(0, LM_VOCAB, (LM_GRAD_BATCH, LM_GRAD_LEN),
                        generator=torch.Generator().manual_seed(4))
    losses, grads, secs, launched = {}, {}, {}, {}
    for tag, m in (("gpu", model), ("cpu", cpu_model)):
        d = next(m.parameters()).device
        x = ids.to(d)
        before = [k.launches for k in (serve, fwd_states, bwd) + others]
        t0 = time.perf_counter()
        logits = m(x)[:, :-1]
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               x[:, 1:].reshape(-1))
        loss.backward()
        losses[tag] = loss.item()
        secs[tag] = time.perf_counter() - t0
        launched[tag] = [k.launches - b for k, b in
                         zip((serve, fwd_states, bwd) + others, before)]
        grads[tag] = {k: p.grad for k, p in m.named_parameters()}
    worst, worst_key = 0.0, None
    for k, want in grads["cpu"].items():
        got = grads["gpu"][k]
        if got is None:
            raise AssertionError(f"{k} got no gradient on the card")
        rel = (got.cpu() - want).abs().max().item() / max(
            want.abs().max().item(), 1e-30)
        if not math.isfinite(rel) or rel > worst:
            worst, worst_key = rel, k
    loss_err = abs(losses["gpu"] - losses["cpu"]) / abs(losses["cpu"])
    log("lm_grad", batch=LM_GRAD_BATCH, tokens=LM_GRAD_LEN,
        params=len(grads["cpu"]), launches_serve_fwd_states_bwd=tuple(
            launched["gpu"][:3]), loss_gpu=losses["gpu"],
        loss_cpu=losses["cpu"], loss_rel_err=f"{loss_err:.2e}",
        worst_grad_rel_err=f"{worst:.2e}", worst_param=worst_key,
        tol=MODEL_GRAD_TOL, gpu_s=f"{secs['gpu']:.2f}",
        cpu_s=f"{secs['cpu']:.2f}")
    if launched["gpu"] != [0, LM_DEPTH, LM_DEPTH] + [0] * len(others) or any(
            launched["cpu"]):
        raise AssertionError(f"launches (grouped serve, fwd_states, bwd, "
                             f"then the bidirectional and folded three): "
                             f"{launched}")
    if not (worst <= MODEL_GRAD_TOL and loss_err <= LOSS_TOL):
        raise AssertionError(f"card gradients disagree with the CPU: worst "
                             f"{worst} at {worst_key}, loss rel err "
                             f"{loss_err}")

def launch_counts(kernels):
    return [k.launches for k in kernels]


def remat_phase(torch, dev):
    """``[remat]``: one bs24 bf16 train step of the full-width bidir branch
    at drop_path 0.2 with ``use_remat`` and one without, from the same
    weights, batch and DropPath generator seed: the loss and every gradient
    agree (the recomputation drops what the first forward dropped), the
    remat step launches 28 state-saving forwards (14 recomputed) and 14
    backwards; peak memory of each."""
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.nn.layers import set_generator
    from mamba_unet_torch.objectives import supervised_ce_dice

    kernels, others = scan_kernels("auto")
    seeded = MambaUnet(num_classes=4, drop_path_rate=0.2,
                       generator=torch.Generator().manual_seed(1337))
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(TRAIN_BATCH, PATCH, PATCH, 1, generator=gen).to(dev)
    label = torch.randint(0, 4, (TRAIN_BATCH, PATCH, PATCH),
                          generator=gen).to(dev)
    out = {}
    # deterministic convolution backwards, so that only remat can differ
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for remat in (False, True):
        model = MambaUnet(num_classes=4, drop_path_rate=0.2,
                          use_remat=remat, device=dev).train()
        model.load_state_dict(seeded.state_dict())
        set_generator(model, torch.Generator(dev).manual_seed(7))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = launch_counts(kernels + others)
        t0 = time.perf_counter()
        with torch.autocast("cuda", torch.bfloat16):
            loss = supervised_ce_dice(model(x), label)
        loss.backward()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = [a - b for a, b in
                    zip(launch_counts(kernels + others), before)]
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        out[remat] = (loss.item(), {k: p.grad.float().cpu()
                                    for k, p in model.named_parameters()})

        def step():
            with torch.autocast("cuda", torch.bfloat16):
                supervised_ce_dice(model(x), label).backward()

        step_ms, _ = cuda_ms(torch, step, REMAT_TIMED_STEPS)
        log("remat", use_remat=remat, batch=TRAIN_BATCH, dtype="bf16",
            drop_path=0.2, loss=out[remat][0], first_step_s=f"{secs:.3f}",
            step_ms=f"{step_ms:.2f}", peak_step_gb=f"{peak:.2f}",
            launches_serve_fwd_states_bwd=tuple(launched[:3]))
        want = [0, (2 if remat else 1) * SS2D_PER_FORWARD,
                SS2D_PER_FORWARD] + [0] * len(others)
        if launched != want:
            raise AssertionError(f"use_remat={remat}: launches {launched}, "
                                 f"expected {want}")
        del model, loss
    torch.backends.cudnn.deterministic = deterministic
    (loss, grads), (loss_r, grads_r) = out[False], out[True]
    worst, worst_key = 0.0, None
    for k, want in grads.items():
        rel = (grads_r[k] - want).abs().max().item() / max(
            want.abs().max().item(), 1e-30)
        if not math.isfinite(rel) or rel > worst:
            worst, worst_key = rel, k
    log("remat", compare="remat_vs_plain", loss_diff=f"{loss_r - loss:.3e}",
        worst_grad_rel_err=f"{worst:.2e}", worst_param=worst_key,
        tol=REMAT_TOL)
    if abs(loss_r - loss) > REMAT_TOL * abs(loss) or worst > REMAT_TOL:
        raise AssertionError(f"remat changed the step: loss {loss} vs "
                             f"{loss_r}, worst gradient {worst} at "
                             f"{worst_key}")


def export_phase(torch, dev):
    """``[export]``: ``export_predict`` of full-width ``ViM_seg`` (seed-0
    weights) with a symbolic batch, saved to build/ and reloaded, served at
    batches 2 and 24 (14 serving launches per call) against the eager
    ``make_predict_fn``: fp32 with TF32 off, and bf16 against fp32; both
    timed at bs24 beside eager. Then the tm and folded branches exported
    with the same weights, at batch 2, against eager; then full-width
    ``unet`` and ``ViT_seg`` (img 224), fp32 at batches 2 and 24 against
    eager (no scan launch), their device ms at bs24 beside eager's."""
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.utils.checkpoint import load_model_snapshot
    from mamba_unet_torch.utils.export import (
        export_predict,
        load_exported,
        make_predict_fn,
        save_exported,
    )

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    model = load_model_snapshot("ViM_seg", 4, 1, device=dev)
    gen = torch.Generator().manual_seed(8)
    xs = {b: torch.randn(b, PATCH, PATCH, 1, generator=gen).to(dev)
          for b in (2, TRAIN_BATCH)}
    eager32 = make_predict_fn(model)
    want = {b: eager32(x) for b, x in xs.items()}
    for tag, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        t0 = time.perf_counter()
        exported = export_predict(model, (PATCH, PATCH), dtype=dtype)
        export_s = time.perf_counter() - t0
        path = save_exported(exported, str(out_dir / f"vim_{tag}.pt2"))
        served = load_exported(path).module()
        eager = make_predict_fn(model, dtype)
        for b, x in xs.items():
            (serve, *_), others = scan_kernels("auto")
            before = launch_counts([serve, *others])
            got = served(x)
            torch.cuda.synchronize()
            launched = [a - b_ for a, b_ in
                        zip(launch_counts([serve, *others]), before)]
            same = (got - eager(x)).abs().max().item()
            err = (got - want[b]).abs().max().item()
            agree = (got.argmax(-1) == want[b].argmax(-1)).float().mean(
            ).item()
            tol = LOGIT_TOL if dtype is None else BF16_LOGIT_TOL
            log("export", dtype=tag, batch=b, vs_eager=f"{same:.3e}",
                vs_fp32_eager=f"{err:.3e}", argmax_agree=f"{agree:.6f}",
                tol=tol, launches=launched[0])
            if launched != [SS2D_PER_FORWARD] + [0] * (len(launched) - 1):
                raise AssertionError(f"the exported program launched "
                                     f"{launched}")
            if (not torch.isfinite(got).all() or same > LOGIT_TOL
                    or err > tol or (dtype is not None
                                     and agree < BF16_MIN_ARGMAX_AGREEMENT)):
                raise AssertionError(f"exported {tag} logits at batch {b}: "
                                     f"{same} vs eager, {err} vs fp32")
        x = xs[TRAIN_BATCH]
        # wall (host enqueue included) and device time (calls queued behind
        # a sleep on the card), the exported program and eager in turns
        times = {}
        for name, fn in (("exported", served), ("eager", eager)) * 2:
            wall, _ = cuda_ms(torch, lambda: fn(x), 10)
            dev_ms, _ = device_ms(torch, lambda: fn(x), 10)
            times.setdefault(name, []).append((wall, dev_ms))
        log("export", dtype=tag, batch=TRAIN_BATCH, **{
            f"{name}_{kind}_ms": " ".join(f"{t[i]:.2f}" for t in runs)
            for name, runs in times.items()
            for i, kind in enumerate(("forward", "device"))},
            export_s=f"{export_s:.1f}",
            artifact_mib=f"{Path(path).stat().st_size / 2**20:.1f}")
    for scan_impl in ("tm", "folded"):
        (serve, *_), others = scan_kernels(scan_impl)
        other = MambaUnet(num_classes=4, scan_impl=scan_impl, device=dev)
        other.load_state_dict(model.state_dict())
        path = save_exported(export_predict(other, (PATCH, PATCH)),
                             str(out_dir / f"vim_{scan_impl}.pt2"))
        served = load_exported(path).module()
        before = launch_counts([serve, *others])
        got = served(xs[2])
        torch.cuda.synchronize()
        launched = [a - b for a, b in
                    zip(launch_counts([serve, *others]), before)]
        err = (got - make_predict_fn(other)(xs[2])).abs().max().item()
        log("export", scan_impl=scan_impl, batch=2, vs_eager=f"{err:.3e}",
            vs_bidir=f"{(got - want[2]).abs().max().item():.3e}",
            launches=launched[0], tol=LOGIT_TOL)
        if launched != [SS2D_PER_FORWARD] + [0] * (len(launched) - 1) or (
                err > LOGIT_TOL):
            raise AssertionError(f"exported {scan_impl}: launches "
                                 f"{launched}, {err} vs eager")
        del other
    kernels = all_scan_kernels()
    for name in ("unet", "ViT_seg"):
        other = zoo_model(torch, name, dev)
        t0 = time.perf_counter()
        exported = export_predict(other, (PATCH, PATCH))
        export_s = time.perf_counter() - t0
        path = save_exported(exported, str(out_dir / f"{name}.pt2"))
        served = load_exported(path).module()
        eager = make_predict_fn(other)
        errs = []
        for b, x in xs.items():
            before = launch_counts(kernels)
            got = served(x)
            torch.cuda.synchronize()
            launched = [a - b_ for a, b_ in zip(launch_counts(kernels),
                                                before)]
            errs.append((got - eager(x)).abs().max().item())
            if (got.shape != (b, PATCH, PATCH, 4) or any(launched)
                    or not bool(torch.isfinite(got).all())
                    or errs[-1] > LOGIT_TOL):
                raise AssertionError(f"exported {name} at batch {b}: "
                                     f"{errs[-1]} vs eager, launches "
                                     f"{launched}")
        x = xs[TRAIN_BATCH]
        times = {}
        for tag, fn in (("exported", served), ("eager", eager)) * 2:
            dev_ms, _ = device_ms(torch, lambda: fn(x), 10)
            times.setdefault(tag, []).append(dev_ms)
        log("export", model=name, dtype="fp32",
            vs_eager_b2_b24=" ".join(f"{e:.3e}" for e in errs),
            tol=LOGIT_TOL, scan_launches=0, batch=TRAIN_BATCH,
            **{f"{tag}_device_ms": " ".join(f"{t:.2f}" for t in runs)
               for tag, runs in times.items()},
            export_s=f"{export_s:.1f}",
            artifact_mib=f"{Path(path).stat().st_size / 2**20:.1f}")
        del other, served, exported


def entry_points_phase(torch, np, dev):
    """``[entry_points]``: the CLIs on the card, on hard synthetic
    phantoms (the test CLI's handed to :func:`cli.test.run_inference`, as
    the card has no h5 set), in a temporary directory: ``cli.train`` with
    ``--pretrained_ckpt`` (an encoder checkpoint this phase writes from a
    seeded model, wrapped as upstream files are, one tensor of the wrong
    shape), ``--exp``, ``--synthetic_hard`` and ``--scan_impl xla``, whose
    warm-start report and launches are checked; ``cli.test`` on its
    snapshot with ``--ckpt_name best --save_nii_dir``, whose NIfTI files
    must hold the labels and the predictions; ``cli.export`` of the
    snapshot, whose artifact must reload and serve the snapshot's
    logits."""
    import logging
    import tempfile

    class Records(logging.Handler):
        """Keeps the log records it is handed."""

        def __init__(self):
            super().__init__()
            self.records = []

        def emit(self, record):
            self.records.append(record)

    from mamba_unet_torch.cli import export as export_cli
    from mamba_unet_torch.cli import test as test_cli
    from mamba_unet_torch.cli import train as train_cli
    from mamba_unet_torch.data.nifti import read_nifti
    from mamba_unet_torch.data.synthetic import phantom_acdc
    from mamba_unet_torch.eval.inference import _zoom0
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.utils.checkpoint import load_model_snapshot
    from mamba_unet_torch.utils.export import load_exported, make_predict_fn

    spec = [str(v) for v in ENTRY_SPEC]
    kernels, others = scan_kernels("tm")  # the xla route is the tm branch
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S", stream=sys.stdout)
    records = Records()
    logging.getLogger().addHandler(records)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        source = MambaUnet(num_classes=4,
                           generator=torch.Generator().manual_seed(11))
        names = source.mamba_unet.state_dict()
        sd = {f"mamba_unet.{k}": v for k, v in names.items()
              if k.startswith(("layers.", "patch_embed."))}
        sd["mamba_unet.patch_embed.proj.weight"] = torch.zeros(96, 3, 2, 2)
        torch.save({"model": sd}, tmp / "vmamba_encoder.pth")
        # the expected report: every encoder tensor but the reshaped one,
        # and the encoder blocks mirrored onto decoder stages 1-3
        mirrored = [k for k in names if k.startswith(
            ("layers_up.1.blocks.", "layers_up.2.blocks.",
             "layers_up.3.blocks."))]
        loaded = len(sd) - 1 + len(mirrored)
        want_report = (loaded, len(names) - loaded - 1, 1)

        before = launch_counts(kernels + others)
        t0 = time.perf_counter()
        train_cli.main([
            "--model", "ViM_seg", "--synthetic", "--synthetic_hard",
            "--synthetic_spec", *spec,
            "--pretrained_ckpt", str(tmp / "vmamba_encoder.pth"),
            "--exp", "ACDC/Entry_Points", "--scan_impl", "xla", "--bf16",
            "--patch_size", str(PATCH), str(PATCH), "--batch_size",
            str(ENTRY_BATCH), "--max_iterations", str(ENTRY_ITERS),
            "--eval_every", "2", "--drop_path", "0",
            "--snapshot_dir", str(tmp / "snap"), "--device", "cuda"])
        train_s = time.perf_counter() - t0
        launched = [a - b for a, b in
                    zip(launch_counts(kernels + others), before)]
        report = [r.args for r in records.records
                  if str(r.msg).startswith("pretrained:")]
        log("entry_points", cli="train", seconds=f"{train_s:.1f}",
            pretrained_report=report, expected=want_report,
            launches_serve_fwd_states_bwd=tuple(launched[:3]))
        if report != [want_report]:
            raise AssertionError(f"warm-start report {report}, expected "
                                 f"{want_report}")
        want = [SS2D_PER_FORWARD * ENTRY_ITERS] * 2
        if launched[1:3] != want or any(launched[3:]) or not launched[0]:
            raise AssertionError(f"the xla training run launched {launched}")

        cases = phantom_acdc(*ENTRY_SPEC[:4], ENTRY_SPEC[4],
                             hard=True)["test"]
        t0 = time.perf_counter()
        test_cli.run_inference(test_cli.build_parser().parse_args([
            "--patch_size", str(PATCH), str(PATCH), "--checkpoint",
            str(tmp / "snap"), "--ckpt_name", "best", "--save_nii_dir",
            str(tmp / "nii"), "--device", "cuda"]), dataset=cases)
        test_s = time.perf_counter() - t0
        model = load_model_snapshot("ViM_seg", 4, 1, str(tmp / "snap"),
                                    device=dev, ckpt_name="best")
        predict = make_predict_fn(model)
        for case in cases:
            image, label = case["image"], case["label"]
            small, _ = test_cli.infer_volume(image, label, predict, 4,
                                             (PATCH, PATCH))
            pred = np.stack([_zoom0(p, label.shape[1:]) for p in small])
            got, spacing = read_nifti(str(tmp / "nii" /
                                          f"{case['case']}_pred.nii.gz"))
            gt, _ = read_nifti(str(tmp / "nii" / f"{case['case']}_gt.nii.gz"))
            if not (np.array_equal(got, pred.astype(np.uint8).transpose(
                    1, 2, 0)) and np.array_equal(gt, label.transpose(1, 2, 0))
                    and tuple(spacing) == (1, 1, 10)):
                raise AssertionError(f"{case['case']}: the NIfTI files do "
                                     f"not hold the prediction and label")
        log("entry_points", cli="test", seconds=f"{test_s:.1f}",
            volumes=len(cases), nifti_pairs_checked=len(cases))

        t0 = time.perf_counter()
        export_cli.main(["--checkpoint", str(tmp / "snap"), "--ckpt_name",
                         "best", "--out", str(tmp / "vim.pt2"),
                         "--patch_size", str(PATCH), str(PATCH)])
        export_s = time.perf_counter() - t0
        x = torch.randn(4, PATCH, PATCH, 1,
                        generator=torch.Generator().manual_seed(12)).to(dev)
        (serve, *_), _ = scan_kernels("auto")
        before = serve.launches
        got = load_exported(str(tmp / "vim.pt2")).module()(x)
        torch.cuda.synchronize()
        launched = serve.launches - before
        err = (got - predict(x)).abs().max().item()
        log("entry_points", cli="export", seconds=f"{export_s:.1f}",
            served_batch=4, vs_eager=f"{err:.3e}", launches=launched,
            tol=LOGIT_TOL)
        if launched != SS2D_PER_FORWARD or err > LOGIT_TOL:
            raise AssertionError(f"the exported snapshot: {err} vs eager")
    logging.getLogger().removeHandler(records)


def all_scan_kernels():
    """The nine scan wrappers: the bidir branch's (serving, state-saving
    forward, backward), then the tm and folded branches'."""
    kernels, others = scan_kernels("auto")
    return kernels + others


def zoo_model(torch, name, dev, seed=5, **kw):
    """Full-width ``unet`` or ``ViT_seg`` (img 224) from a seeded
    generator, on ``dev``."""
    from mamba_unet_torch.models import net_factory

    if name == "ViT_seg":
        kw["img_size"] = PATCH
    return net_factory(name, num_classes=4, device=dev,
                       generator=torch.Generator().manual_seed(seed), **kw)


def zoo_parity_phase(torch, dev):
    """``[zoo_parity]``: full-width ``unet`` and ``ViT_seg``, batch 2 at
    224², dropout and drop_path 0: eval-mode logits on the card against a
    CPU copy (fp32, TF32 off by the caller), train-mode logits and the
    BatchNorm running statistics after one train-mode forward, bf16 against
    fp32 on the card; no scan kernel launches."""
    from mamba_unet_torch.nn.layers import set_generator
    from mamba_unet_torch.utils.export import make_predict_fn

    kernels = all_scan_kernels()
    before = launch_counts(kernels)
    x = torch.randn(2, PATCH, PATCH, 1,
                    generator=torch.Generator().manual_seed(13))
    for name in ("unet", "ViT_seg"):
        kw = ({"dropout": (0.0,) * 5} if name == "unet"
              else {"drop_path_rate": 0.0})
        cpu = zoo_model(torch, name, "cpu", **kw)
        gpu = zoo_model(torch, name, dev, **kw)
        gpu.load_state_dict(cpu.state_dict())
        want = make_predict_fn(cpu)(x)
        got = make_predict_fn(gpu)(x.to(dev)).cpu()
        err = (got - want).abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        bf16 = make_predict_fn(gpu, torch.bfloat16)(x.to(dev)).cpu()
        err16 = (bf16 - got).abs().max().item() / got.abs().max().item()
        agree16 = (bf16.argmax(-1) == got.argmax(-1)).float().mean().item()
        for m, d in ((cpu, "cpu"), (gpu, dev)):
            set_generator(m, torch.Generator(d).manual_seed(0))
        with torch.no_grad():
            t_want = cpu.train()(x)
            t_got = gpu.train()(x.to(dev)).cpu()
        t_err = (t_got - t_want).abs().max().item()
        g_sd = gpu.state_dict()
        stats = [k for k in cpu.state_dict()
                 if k.endswith(("running_mean", "running_var"))]
        s_err = max([(g_sd[k].cpu() - v).abs().max().item()
                     / v.abs().max().item()
                     for k, v in cpu.state_dict().items() if k in stats],
                    default=0.0)
        log("zoo_parity", model=name, shape=tuple(got.shape),
            max_abs_err=f"{err:.3e}", logit_max=f"{want.abs().max():.3f}",
            argmax_agree=f"{agree:.6f}", train_max_abs_err=f"{t_err:.3e}",
            bn_stat_tensors=len(stats), bn_stats_rel_err=f"{s_err:.2e}",
            bf16_rel_diff=f"{err16:.3e}", bf16_argmax_agree=f"{agree16:.6f}",
            tol=LOGIT_TOL, bf16_tol=ZOO_BF16_REL_TOL)
        if (got.shape != (2, PATCH, PATCH, 4)
                or not bool(torch.isfinite(got).all())
                or err > LOGIT_TOL or agree < MIN_ARGMAX_AGREEMENT
                or t_err > LOGIT_TOL or s_err > ZOO_STATS_TOL
                or (name == "unet") != bool(stats)):
            raise AssertionError(f"{name}: card disagrees with the CPU")
        if (not bool(torch.isfinite(bf16).all()) or err16 > ZOO_BF16_REL_TOL
                or agree16 < BF16_MIN_ARGMAX_AGREEMENT):
            raise AssertionError(f"{name}: bf16 logits stray from fp32: "
                                 f"{err16}, {agree16}")
        del cpu, gpu
    launched = [a - b for a, b in zip(launch_counts(kernels), before)]
    log("zoo_parity", scan_launches=sum(launched))
    if any(launched):
        raise AssertionError(f"unet/ViT_seg launched scan kernels "
                             f"{launched}")


def phantom_loader(torch, dev, batch, labeled=None, seed=1337,
                   scribble=False):
    """(val volumes, a Loader of phantom slices at 224²: shuffled batches
    of ``batch``, or two-stream ones with ``labeled`` labeled slices
    first; with ``scribble`` the slices' scribbles are the labels, 4 in
    the rotated-out corners)."""
    from mamba_unet_torch.data.acdc import SliceDataset
    from mamba_unet_torch.data.augment import RandomGenerator
    from mamba_unet_torch.data.loader import Loader
    from mamba_unet_torch.data.sampler import (
        EpochShuffleSampler,
        TwoStreamBatchSampler,
    )
    from mamba_unet_torch.data.synthetic import phantom_acdc

    splits = phantom_acdc(8, 8, 2, 0, *NATIVE, seed=0, scribble=scribble)
    ds = SliceDataset.from_samples(
        splits["train"], sup_type="scribble" if scribble else "label",
        transform=RandomGenerator((PATCH, PATCH), seed=seed,
                                  label_cval=4 if scribble else 0))
    if labeled is None:
        sampler = EpochShuffleSampler(len(ds), batch, seed=seed)
    else:
        n_lab = len(ds) // 4
        sampler = TwoStreamBatchSampler(range(n_lab), range(n_lab, len(ds)),
                                        batch, batch - labeled, seed=seed)
    return splits["val"], Loader(ds, sampler, device=dev)


def counted_fit(torch, trainer, loader, val, iters, phase):
    """``trainer.fit`` over ``iters`` batches of ``loader`` (evaluating on
    ``val`` as its config says), every scan wrapper's count set to 0 just
    before and read after each batch; returns (result, per-step launch
    vectors over :func:`all_scan_kernels`, ms of each step, peak GB).
    A step's ms runs from its batch's hand-out to the next one's."""
    import itertools

    kernels = all_scan_kernels()
    marks = []

    def counted(batches):
        for batch in itertools.islice(batches, iters):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), launch_counts(kernels)))
            yield batch
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), launch_counts(kernels)))

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    result = trainer.fit(counted(loader), val)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = [[b - a for a, b in zip(c0, c1)]
             for (_, c0), (_, c1) in zip(marks, marks[1:])]
    ms = [1e3 * (t1 - t0) for (t0, _), (t1, _) in zip(marks, marks[1:])]
    losses = [h["loss"] for h in result["history"] if "loss" in h]
    if result["iterations"] != iters or len(losses) != iters or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"[{phase}] fit ran {result['iterations']} "
                             f"iterations, losses {losses}")
    return result, steps, ms, peak_gb


def check_step_launches(phase, steps, per_step, eval_steps=(),
                        per_eval=None):
    """Raise unless every step launched ``per_step`` (and the steps in
    ``eval_steps`` ``per_step`` + ``per_eval``) over all_scan_kernels."""
    for i, got in enumerate(steps, start=1):
        want = list(per_step)
        if i in eval_steps:
            want = [a + b for a, b in zip(want, per_eval)]
        if got != want:
            raise AssertionError(f"[{phase}] step {i}: launches {got} (bidir "
                                 f"serve, fwd_states, bwd, then tm and "
                                 f"folded), expected {want}")


def check_best_marks(phase, snap, dice):
    """The best-checkpoint protocol in ``snap`` after a fit: for each name
    (``best``, ``best2``) with its (step, val Dice) evals, the checkpoints
    ``{name}_{step}`` are the steps where the Dice beat every earlier one
    and 0, and ``best_marks.json`` holds the highest (no entry when no eval
    beat 0)."""
    from mamba_unet_torch.utils.checkpoint import load_best_marks

    marks = load_best_marks(snap)
    files = {p.name for p in Path(snap).iterdir()}
    for name, evals in dice.items():
        best, want = 0.0, set()
        for step, d in evals:
            if d > best:
                best = d
                want.add(f"{name}_{step}")
        got = {f for f in files if f.rsplit("_", 1)[0] == name
               and f.rsplit("_", 1)[1].isdigit()}
        if got != want or marks.get(name, 0.0) != best:
            raise AssertionError(f"[{phase}] {name}: checkpoints {got}, "
                                 f"mark {marks.get(name)}; expected {want}, "
                                 f"{best}")


def median_after_warmup(ms, skip=()):
    """The median of ``ms`` after TRAIN_WARMUP steps, leaving out the
    (1-based) steps in ``skip``."""
    kept = sorted(v for i, v in enumerate(ms, start=1)
                  if i > TRAIN_WARMUP and i not in skip)
    return kept[len(kept) // 2], kept


def zoo_training_phase(torch, dev):
    """``[zoo_training]``: ``Trainer.fit`` of full-width ``unet`` and
    ``ViT_seg`` on phantom slices, bs24 @ 224², bf16, drop_path 0.2
    (ViT_seg), ZOO_ITERS steps with one eval: a falling loss, every
    parameter moved (and unet's BatchNorm buffers), no scan launch; step
    ms, slices/s, peak GB and a profile's device ms per step."""
    from mamba_unet_torch.train import TrainConfig, Trainer

    out = {}
    for name in ("unet", "ViT_seg"):
        cfg = TrainConfig(base_lr=0.01, max_iterations=1000,
                          batch_size=TRAIN_BATCH, patch_size=(PATCH, PATCH),
                          num_classes=4, eval_every=ZOO_EVAL_AT, log_every=1,
                          seed=1337, bf16=True)
        trainer = Trainer(zoo_model(torch, name, "cpu", seed=1337), cfg,
                          device=dev)
        before = {k: v.detach().clone()
                  for k, v in trainer.model.state_dict().items()}
        val, loader = phantom_loader(torch, dev, TRAIN_BATCH)
        result, steps, ms, peak = counted_fit(torch, trainer, loader, val,
                                              ZOO_ITERS, "zoo_training")
        check_step_launches("zoo_training", steps, [0] * 9)
        losses = [h["loss"] for h in result["history"] if "loss" in h]
        after = trainer.model.state_dict()
        moved = sum(not torch.equal(v, after[k]) for k, v in before.items()
                    if v.is_floating_point())
        buffers = [k for k in before if k.endswith(("running_mean",
                                                    "running_var"))]
        moved_buffers = sum(not torch.equal(before[k], after[k])
                            for k in buffers)
        floats = sum(v.is_floating_point() for v in before.values())
        med, kept = median_after_warmup(ms, {ZOO_EVAL_AT})
        dice = [h["val_dice"] for h in result["history"] if "val_dice" in h]
        log("zoo_training", model=name, iterations=result["iterations"],
            batch=TRAIN_BATCH, dtype="bf16", params_moved=f"{moved}/{floats}",
            bn_buffers_moved=f"{moved_buffers}/{len(buffers)}",
            val_dice=f"{dice[0]:.4f}", scan_launches=0)
        log("zoo_training", model=name,
            losses=" ".join(f"{v:.4f}" for v in losses))
        device = profile_steps(torch, trainer, loader, f"train_{name}")
        log("zoo_training", model=name, step_ms_median=f"{med:.2f}",
            step_ms_min=f"{kept[0]:.2f}", step_ms_max=f"{kept[-1]:.2f}",
            slices_per_s=f"{TRAIN_BATCH / med * 1e3:.1f}",
            peak_mem_gb=f"{peak:.2f}", device_ms_per_step=f"{device:.2f}")
        if not sum(losses[-3:]) < sum(losses[:3]) or len(dice) != 1:
            raise AssertionError(f"{name}: the loss did not fall: {losses}")
        if moved < 0.99 * floats or moved_buffers != len(buffers):
            raise AssertionError(f"{name}: {moved}/{floats} tensors, "
                                 f"{moved_buffers}/{len(buffers)} BatchNorm "
                                 f"buffers moved")
        out[name] = (med, device, peak)
        del trainer, loader
    return out


def cross_teaching_parity_phase(torch, dev):
    """``[cross_teaching_parity]``: one cross-teaching step of two
    full-width ``ViM_seg`` (seeds 0 and 1), batch 4 (2 labeled + 2
    unlabeled) at 224², fp32 (TF32 off by the caller), drop_path 0: the
    loss and both models' every gradient on the card against a CPU copy;
    28 state-saving forward and 28 backward bidir launches."""
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.train import CrossTeachingTrainer, TrainConfig

    cfg = TrainConfig(base_lr=0.01, max_iterations=1000,
                      batch_size=CROSS_PARITY_BATCH,
                      patch_size=(PATCH, PATCH), num_classes=4, seed=1337)
    gen = torch.Generator().manual_seed(4)
    batch = {"image": torch.randn(CROSS_PARITY_BATCH, PATCH, PATCH, 1,
                                  generator=gen),
             "label": torch.randint(0, 4, (CROSS_PARITY_BATCH, PATCH, PATCH),
                                    generator=gen)}
    kernels = all_scan_kernels()
    grads, losses, secs = {}, {}, {}
    for tag, d in (("gpu", dev), ("cpu", "cpu")):
        m1, m2 = (MambaUnet(num_classes=4, drop_path_rate=0.0,
                            generator=torch.Generator().manual_seed(s))
                  for s in (0, 1))
        trainer = CrossTeachingTrainer(m1, cfg, model2=m2,
                                       labeled_bs=CROSS_PARITY_LABELED,
                                       device=d)
        before = launch_counts(kernels)
        t0 = time.perf_counter()
        logs = trainer.train_step(batch)
        losses[tag] = float(logs["loss_total"])
        secs[tag] = time.perf_counter() - t0
        # the step leaves its gradients in .grad
        grads[tag] = {f"m{i}.{k}": p.grad.cpu() for i, m in
                      ((1, trainer.model), (2, trainer.model2))
                      for k, p in m.named_parameters()}
        if tag == "gpu":
            launched = [a - b for a, b in zip(launch_counts(kernels),
                                              before)]
            want = [0, 2 * SS2D_PER_FORWARD, 2 * SS2D_PER_FORWARD] + [0] * 6
            if launched != want:
                raise AssertionError(f"one cross-teaching step launched "
                                     f"{launched}, expected {want}")
        del trainer, m1, m2
    worst, worst_key = 0.0, None
    for k, want in grads["cpu"].items():
        rel = ((grads["gpu"][k] - want).abs().max().item()
               / max(want.abs().max().item(), 1e-30))
        if not math.isfinite(rel) or rel > worst:
            worst, worst_key = rel, k
    loss_err = abs(losses["gpu"] - losses["cpu"]) / abs(losses["cpu"])
    log("cross_teaching_parity", params=len(grads["cpu"]),
        loss_gpu=losses["gpu"], loss_cpu=losses["cpu"],
        loss_rel_err=f"{loss_err:.2e}", worst_grad_rel_err=f"{worst:.2e}",
        worst_param=worst_key, tol=MODEL_GRAD_TOL,
        launches_fwd_states_bwd=(2 * SS2D_PER_FORWARD,) * 2,
        gpu_s=f"{secs['gpu']:.2f}", cpu_s=f"{secs['cpu']:.2f}")
    if not (worst <= MODEL_GRAD_TOL and loss_err <= LOSS_TOL):
        raise AssertionError(f"cross-teaching gradients disagree with the "
                             f"CPU: worst {worst} at {worst_key}, loss rel "
                             f"err {loss_err}")


def cross_teaching_phase(torch, dev):
    """``[cross_teaching]``: ``CrossTeachingTrainer.fit`` of two full-width
    ``ViM_seg`` on phantom slices, bs24 with 8 labeled, bf16, drop_path
    0.2, CROSS_ITERS steps with an eval every CROSS_EVAL_EVERY: per step 28
    + 28 bidir training launches and no other kernel, 14 serving launches
    per eval forward of each model; both models' weights move, the loss
    falls, and ``best`` / ``best2`` hold the protocol
    (:func:`check_best_marks`); step ms (steps without an eval), peak GB
    and a profile's device ms per step beside
    BIDIR_STEP_DEVICE_MS_BASELINE. From scratch both models predict only
    background after their second update, so a fresh pair then fits one
    step with an eval after it, which must write ``best_1`` and
    ``best2_1``. Returns (launches of the
    bidir serving, state-saving and backward kernels in the run, step ms,
    device ms per step, peak GB)."""
    import itertools
    import tempfile

    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.train import CrossTeachingTrainer, TrainConfig

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as snap:
        cfg = TrainConfig(base_lr=0.01, max_iterations=1000,
                          batch_size=TRAIN_BATCH, patch_size=(PATCH, PATCH),
                          num_classes=4, eval_every=CROSS_EVAL_EVERY,
                          log_every=1, seed=1337, bf16=True,
                          snapshot_dir=snap)
        m1, m2 = (MambaUnet(num_classes=4, drop_path_rate=0.2,
                            generator=torch.Generator().manual_seed(s))
                  for s in (1337, 1338))
        trainer = CrossTeachingTrainer(m1, cfg, model2=m2,
                                       labeled_bs=SEMI_LABELED, device=dev)
        before = [{k: v.detach().clone() for k, v in m.state_dict().items()}
                  for m in (trainer.model, trainer.model2)]
        val, loader = phantom_loader(torch, dev, TRAIN_BATCH, SEMI_LABELED)
        result, steps, ms, peak = counted_fit(torch, trainer, loader, val,
                                              CROSS_ITERS, "cross_teaching")
        eval_fwd = math.ceil(sum(len(v["image"]) for v in val)
                             / cfg.eval_batch_size)
        n = SS2D_PER_FORWARD
        evals = range(CROSS_EVAL_EVERY, CROSS_ITERS + 1, CROSS_EVAL_EVERY)
        check_step_launches("cross_teaching", steps, [0, 2 * n, 2 * n]
                            + [0] * 6, evals, [2 * n * eval_fwd] + [0] * 8)
        launches = [sum(s[i] for s in steps) for i in range(3)]
        saved = sorted(p.name for p in Path(snap).iterdir())
        dice = [(h["val_dice"], h["val_dice2"]) for h in result["history"]
                if "val_dice" in h]
        check_best_marks("cross_teaching", snap, {
            "best": [(i, d[0]) for i, d in zip(evals, dice)],
            "best2": [(i, d[1]) for i, d in zip(evals, dice)]})
    moved = [sum(not torch.equal(v, m.state_dict()[k]) for k, v in b.items())
             for b, m in zip(before, (trainer.model, trainer.model2))]
    losses = [h["loss"] for h in result["history"] if "loss" in h]
    med, kept = median_after_warmup(ms, set(evals))
    log("cross_teaching", iterations=result["iterations"], batch=TRAIN_BATCH,
        labeled=SEMI_LABELED, dtype="bf16", drop_path=0.2,
        launches_serve_fwd_states_bwd=tuple(launches),
        params_moved=f"{moved[0]}/{len(before[0])} {moved[1]}/"
                     f"{len(before[1])}",
        val_dice_dice2=" ".join(f"{a:.4f},{b:.4f}" for a, b in dice),
        eval_forwards=eval_fwd, saved=" ".join(saved))
    log("cross_teaching", losses=" ".join(f"{v:.4f}" for v in losses))
    device = profile_steps(torch, trainer, loader, "train_cross_teaching")
    log("cross_teaching", step_ms_median=f"{med:.2f}",
        step_ms_min=f"{kept[0]:.2f}", step_ms_max=f"{kept[-1]:.2f}",
        slices_per_s=f"{TRAIN_BATCH / med * 1e3:.1f}",
        peak_mem_gb=f"{peak:.2f}", device_ms_per_step=f"{device:.2f}",
        bidir_step_baseline_ms=BIDIR_STEP_DEVICE_MS_BASELINE,
        ratio_to_baseline=f"{device / BIDIR_STEP_DEVICE_MS_BASELINE:.3f}")
    if not sum(losses[-3:]) < sum(losses[:3]):
        raise AssertionError(f"the cross-teaching loss did not fall: "
                             f"{losses}")
    if min(moved[0] / len(before[0]), moved[1] / len(before[1])) < 0.99:
        raise AssertionError(f"weights moved {moved}")
    del trainer
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as snap:
        cfg.eval_every, cfg.snapshot_dir = 1, snap
        m1, m2 = (MambaUnet(num_classes=4, drop_path_rate=0.2,
                            generator=torch.Generator().manual_seed(s))
                  for s in (1337, 1338))
        trainer = CrossTeachingTrainer(m1, cfg, model2=m2,
                                       labeled_bs=SEMI_LABELED, device=dev)
        result = trainer.fit(itertools.islice(loader, 1), val)
        dice = [(h["val_dice"], h["val_dice2"]) for h in result["history"]
                if "val_dice" in h]
        check_best_marks("cross_teaching", snap, {
            "best": [(1, dice[0][0])], "best2": [(1, dice[0][1])]})
        saved = sorted(p.name for p in Path(snap).iterdir())
    log("cross_teaching", checkpoints_after_step=1,
        val_dice_dice2=f"{dice[0][0]:.4f},{dice[0][1]:.4f}",
        saved=" ".join(saved))
    if not {"best_1", "best2_1"} <= set(saved):
        raise AssertionError(f"best and best2 not both written: {saved}")
    del trainer, loader
    return launches, med, device, peak


def ema_teacher_phase(torch, dev, method):
    """``[mean_teacher]`` / ``[uamt]``: ``fit`` of full-width ``ViM_seg``
    on two-stream phantom batches, bs24 with 8 labeled, bf16, drop_path
    0.2, EMA_ITERS steps (consistency on from step 0): per step 14 (mean
    teacher) or 126 (UAMT: 9 teacher passes) serving launches under no
    grad, 14 state-saving forward and 14 backward ones; then one more step
    after which a sampled EMA tensor equals alpha * ema + (1 - alpha) *
    param; step ms, peak GB and a profile's device ms per step. Returns
    (launches of the bidir serving, state-saving and backward kernels,
    step ms, device ms per step, peak GB)."""
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.train import (
        MeanTeacherTrainer,
        TrainConfig,
        UAMTTrainer,
    )

    cls = MeanTeacherTrainer if method == "mean_teacher" else UAMTTrainer
    passes = 1 if method == "mean_teacher" else UAMT_TEACHER_PASSES
    cfg = TrainConfig(base_lr=0.01, max_iterations=1000,
                      batch_size=TRAIN_BATCH, patch_size=(PATCH, PATCH),
                      num_classes=4, log_every=1, seed=1337, bf16=True)
    trainer = cls(MambaUnet(num_classes=4, drop_path_rate=0.2,
                            generator=torch.Generator().manual_seed(1337)),
                  cfg, labeled_bs=SEMI_LABELED, warmup_iters=0, device=dev)
    _, loader = phantom_loader(torch, dev, TRAIN_BATCH, SEMI_LABELED)
    result, steps, ms, peak = counted_fit(torch, trainer, loader, None,
                                          EMA_ITERS, method)
    n = SS2D_PER_FORWARD
    check_step_launches(method, steps, [passes * n, n, n] + [0] * 6)
    launches = [sum(s[i] for s in steps) for i in range(3)]
    name = "mamba_unet.layers.0.blocks.0.self_attention.in_proj.weight"
    ema_before = trainer.ema[name].clone()
    batch = next(iter(loader))
    trainer.train_step(batch)
    alpha = min(1.0 - 1.0 / (trainer.step + 1.0), 0.99)
    param = dict(trainer.model.named_parameters())[name].detach()
    want = ema_before * alpha + param * (1.0 - alpha)
    ema_err = (trainer.ema[name] - want).abs().max().item()
    moved = (trainer.ema[name] - ema_before).abs().max().item()
    losses = [h["loss"] for h in result["history"] if "loss" in h]
    med, kept = median_after_warmup(ms)
    log(method, iterations=result["iterations"], batch=TRAIN_BATCH,
        labeled=SEMI_LABELED, dtype="bf16", drop_path=0.2,
        teacher_passes=passes, launches_serve_fwd_states_bwd=tuple(launches),
        losses=" ".join(f"{v:.4f}" for v in losses), ema_tensor=name,
        ema_alpha=f"{alpha:.6f}", ema_err=f"{ema_err:.2e}",
        ema_moved=f"{moved:.2e}", tol=EMA_TOL)
    device = profile_steps(torch, trainer, loader, f"train_{method}")
    log(method, step_ms_median=f"{med:.2f}", step_ms_min=f"{kept[0]:.2f}",
        step_ms_max=f"{kept[-1]:.2f}",
        slices_per_s=f"{TRAIN_BATCH / med * 1e3:.1f}",
        peak_mem_gb=f"{peak:.2f}", device_ms_per_step=f"{device:.2f}",
        bidir_step_baseline_ms=BIDIR_STEP_DEVICE_MS_BASELINE)
    if ema_err > EMA_TOL or moved == 0.0:
        raise AssertionError(f"EMA after a step: err {ema_err}, moved "
                             f"{moved}")
    del trainer, loader
    return launches, med, device, peak


def semi_entry_points_phase(torch, np, dev):
    """``[entry_points]``, second part: ``cli.train --synthetic`` with
    ``--method mean_teacher``, ``uamt`` (``--model ViM_seg``) and
    ``cross_teaching --model ViM_seg --model2 unet``, fully supervised
    ``--model unet`` and ``--model ViT_seg``, and ``--method
    weak_scribble`` (its default trio), each's scan launches checked; then
    ``cli.test --model unet`` and ``--model ViT_seg`` on the snapshots
    written (finite metrics, no scan launch), and ``cli.test --model
    ViM_seg --ckpt_name best3`` on the weak run's (its serving launches)."""
    import tempfile

    from mamba_unet_torch.cli import test as test_cli
    from mamba_unet_torch.cli import train as train_cli
    from mamba_unet_torch.data.synthetic import phantom_acdc

    spec = [str(v) for v in ENTRY_SPEC]
    kernels = all_scan_kernels()
    n, iters = SS2D_PER_FORWARD, 2
    # val: one volume of ENTRY_SPEC[1] slices, one eval forward per model
    runs = (
        ("mean_teacher", ["--method", "mean_teacher", "--model", "ViM_seg"],
         [iters * n + n, iters * n, iters * n]),
        ("uamt", ["--method", "uamt", "--model", "ViM_seg"],
         [iters * UAMT_TEACHER_PASSES * n + n, iters * n, iters * n]),
        ("cross_teaching", ["--method", "cross_teaching", "--model",
                            "ViM_seg", "--model2", "unet"],
         [n, iters * n, iters * n]),
        ("unet", ["--model", "unet"], [0, 0, 0]),
        ("ViT_seg", ["--model", "ViT_seg"], [0, 0, 0]),
        # the default trio (unet, ViT_seg, ViM_seg), evaluated after both
        # steps, so that model 3 has a best checkpoint to serve below
        ("weak_scribble", ["--method", "weak_scribble", "--eval_every", "1"],
         [iters * n, iters * n, iters * n]))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for tag, extra, want in runs:
            before = launch_counts(kernels)
            t0 = time.perf_counter()
            train_cli.main([
                "--synthetic", "--synthetic_spec", *spec, "--bf16",
                "--patch_size", str(PATCH), str(PATCH), "--batch_size",
                str(ENTRY_BATCH), "--labeled_bs", str(ENTRY_BATCH // 2),
                "--max_iterations", str(iters), "--eval_every", str(iters),
                "--snapshot_dir", f"{tmp}/{tag}", "--device", "cuda",
                *extra])
            launched = [a - b for a, b in zip(launch_counts(kernels),
                                              before)]
            saved = sorted(p.name for p in Path(tmp, tag).iterdir())
            log("entry_points", cli="train", run=tag,
                seconds=f"{time.perf_counter() - t0:.1f}",
                launches_serve_fwd_states_bwd=tuple(launched[:3]),
                saved=" ".join(saved))
            if launched != want + [0] * 6:
                raise AssertionError(f"{tag}: launched {launched}, expected "
                                     f"{want}")
        cases = phantom_acdc(*ENTRY_SPEC[:4], ENTRY_SPEC[4])["test"]
        forwards = sum(math.ceil(len(c["image"]) / test_cli.BATCH_SIZE)
                       for c in cases)
        # (model, snapshot, checkpoint name, serving launches)
        for model, snap, ckpt, serve in (
                ("unet", "unet", "best", 0), ("ViT_seg", "ViT_seg", "best", 0),
                ("ViM_seg", "weak_scribble", "best3", n * forwards)):
            before = launch_counts(kernels)
            t0 = time.perf_counter()
            out = test_cli.run_inference(test_cli.build_parser().parse_args([
                "--model", model, "--patch_size", str(PATCH), str(PATCH),
                "--checkpoint", f"{tmp}/{snap}", "--ckpt_name", ckpt,
                "--device", "cuda"]), dataset=cases)
            launched = [a - b for a, b in zip(launch_counts(kernels),
                                              before)]
            log("entry_points", cli="test", model=model, ckpt_name=ckpt,
                seconds=f"{time.perf_counter() - t0:.1f}", volumes=len(cases),
                mean_dice=f"{out['mean'][0]:.4f}", scan_launches=sum(launched))
            if (launched != [serve] + [0] * 8
                    or not np.isfinite(out["per_case"]).all()):
                raise AssertionError(f"cli.test --model {model} "
                                     f"--ckpt_name {ckpt}: launches "
                                     f"{launched}, metrics {out['mean']}")


def weak_trio(torch, dev, drop=True, seeds=(1337, 1338, 1339)):
    """Weak-Mamba-UNet's default trio at full width, from seeded
    generators: ``unet``, ``ViT_seg`` (img 224), ``ViM_seg``; with
    ``drop`` False their dropout and drop-path rates are 0."""
    kw = ({}, {}, {}) if drop else ({"dropout": (0.0,) * 5},
                                    {"drop_path_rate": 0.0},
                                    {"drop_path_rate": 0.0})
    return [zoo_model(torch, name, dev, seed=seed, **k)
            for name, seed, k in zip(("unet", "ViT_seg", "ViM_seg"), seeds,
                                     kw)]


def weak_parity_phase(torch, dev):
    """``[weak_parity]``: one Weak-Mamba-UNet step of the full-width trio
    (dropout and drop-path 0), batch WEAK_PARITY_BATCH at 224² (``ViT_seg``
    tiles only 224k inputs into its 7x7 windows) on phantom scribbles,
    fp32 (TF32 off by the caller), the same mix weights and pseudo-labels
    on both sides (the card's step is handed the CPU's pseudo-labels, and
    the share of its own that agree is printed): the losses and every
    parameter's gradient of the three models on the card against a CPU
    copy, at ``[cross_teaching_parity]``'s tolerance, ``unet``'s relative
    to its largest gradient (its fp32 conditioning); the exact zeros, the
    biases of ``unet``'s convolutions that feed a BatchNorm, below
    ZERO_GRAD_REL of the model's largest gradient on both sides; 14
    state-saving forward and 14 backward bidir launches (model 3)."""
    import numpy as np

    from mamba_unet_torch.data.synthetic import phantom_acdc
    from mamba_unet_torch.train import TrainConfig, WeakScribbleTrainer
    from mamba_unet_torch.utils.compare import (
        ZERO_GRAD_REL,
        batchnorm_fed_biases,
    )

    cfg = TrainConfig(base_lr=0.01, max_iterations=1000,
                      batch_size=WEAK_PARITY_BATCH,
                      patch_size=(PATCH, PATCH), num_classes=4, seed=1337)
    train = phantom_acdc(1, WEAK_PARITY_BATCH, 0, 0, PATCH, seed=2,
                         scribble=True)["train"]
    batch = {"image": torch.from_numpy(np.stack([s["image"] for s in train]))
             [..., None],
             "label": torch.from_numpy(np.stack([s["scribble"]
                                                 for s in train]))}
    mix = torch.tensor([0.5, 0.3, 0.2])
    kernels = all_scan_kernels()
    grads, losses, secs, pseudo = {}, {}, {}, {}
    for tag, d in (("cpu", "cpu"), ("gpu", dev)):
        m1, m2, m3 = weak_trio(torch, "cpu", drop=False)
        trainer = WeakScribbleTrainer(m1, cfg, model2=m2, model3=m3,
                                      device=d)
        trainer._mix_weights = lambda d=d: mix.to(d)
        own = trainer._pseudo_labels

        def shared(softs, weights, tag=tag, own=own):
            pseudo[tag] = own(softs, weights).cpu()
            return pseudo["cpu"].to(softs[0].device)

        trainer._pseudo_labels = shared
        before = launch_counts(kernels)
        t0 = time.perf_counter()
        logs = trainer.train_step(batch)
        losses[tag] = {k: float(v) for k, v in logs.items()
                       if k.startswith("loss")}
        secs[tag] = time.perf_counter() - t0
        grads[tag] = {f"m{i}.{k}": p.grad.cpu()
                      for i, (m, _, _) in enumerate(trainer._members(), 1)
                      for k, p in m.named_parameters()}
        zeros = {f"m{i}.{k}"
                 for i, (m, _, _) in enumerate(trainer._members(), 1)
                 for k in batchnorm_fed_biases(m)}
        if tag == "gpu":
            launched = [a - b for a, b in zip(launch_counts(kernels),
                                              before)]
            want = [0, SS2D_PER_FORWARD, SS2D_PER_FORWARD] + [0] * 6
            if launched != want:
                raise AssertionError(f"one weak step launched {launched}, "
                                     f"expected {want}")
        del trainer, m1, m2, m3
    model_max = {m: max(g.abs().max().item() for k, g in grads["cpu"].items()
                        if k.startswith(m)) for m in ("m1.", "m2.", "m3.")}
    # unet: (the worst error relative to unet's largest gradient, its
    # tensor), then the worst relative to its own max, reported only
    worst = {m: (0.0, None) for m in model_max}
    unet_own = (0.0, None)
    for k, want in grads["cpu"].items():
        if k in zeros:
            bound = ZERO_GRAD_REL * model_max[k[:3]]
            got = max(want.abs().max().item(),
                      grads["gpu"][k].abs().max().item())
            if got > bound:
                raise AssertionError(f"{k}: the gradient of a bias that "
                                     f"feeds a BatchNorm is {got}, above "
                                     f"{bound}")
            continue
        err = (grads["gpu"][k] - want).abs().max().item()
        own = err / max(want.abs().max().item(), 1e-30)
        rel = err / model_max["m1."] if k.startswith("m1.") else own
        if k.startswith("m1.") and own > unet_own[0]:
            unet_own = (own, k)
        if not math.isfinite(rel) or rel > worst[k[:3]][0]:
            worst[k[:3]] = (rel, k)
    loss_err = max(abs(losses["gpu"][k] - v) / max(abs(v), 1e-30)
                   for k, v in losses["cpu"].items() if v)
    agree = (pseudo["gpu"] == pseudo["cpu"]).float().mean().item()
    log("weak_parity", batch=WEAK_PARITY_BATCH, patch=PATCH,
        params=len(grads["cpu"]), zero_grads=len(zeros),
        zero_grad_rel=ZERO_GRAD_REL, mix="0.5,0.3,0.2",
        own_pseudo_label_agreement=f"{agree:.6f}",
        loss_gpu=losses["gpu"]["loss_total"],
        loss_cpu=losses["cpu"]["loss_total"],
        pseudo_dice_gpu=f"{losses['gpu']['loss_pseudo_dice']:.6f}",
        loss_rel_err=f"{loss_err:.2e}", loss_tol=LOSS_TOL,
        launches_fwd_states_bwd=(SS2D_PER_FORWARD,) * 2,
        gpu_s=f"{secs['gpu']:.2f}", cpu_s=f"{secs['cpu']:.2f}")
    bad = []
    for (m, (rel, key)), name in zip(worst.items(),
                                     ("unet", "ViT_seg", "ViM_seg")):
        extra = {} if name != "unet" else {
            "relative_to": "unet_max_grad",
            "worst_own_rel_err": f"{unet_own[0]:.2e}",
            "worst_own_param": unet_own[1]}
        log("weak_parity", model=name, worst_grad_rel_err=f"{rel:.2e}",
            worst_param=key, tol=MODEL_GRAD_TOL, **extra)
        if not rel <= MODEL_GRAD_TOL:
            bad.append((name, rel, key))
    if bad:
        raise AssertionError(f"weak-step gradients disagree with the CPU: "
                             f"{bad}")
    if loss_err > LOSS_TOL:
        raise AssertionError(f"weak-step losses disagree with the CPU: "
                             f"{losses}")


def weak_scribble_phase(torch, dev):
    """``[weak_scribble]``: ``WeakScribbleTrainer.fit`` of the full-width
    trio on phantom scribbles (native 256x216, RandomGenerator to 224²
    with the ignore index in rotated corners), bs24, bf16, WEAK_ITERS steps
    with one eval (after step WEAK_EVAL_AT): per step 14 state-saving
    forward and 14 backward bidir launches (``ViM_seg``; ``unet`` and
    ``ViT_seg`` none) and 14 serving launches per eval forward of model 3;
    the three models move, the loss falls, and ``best``/``best2``/
    ``best3`` hold the protocol (:func:`check_best_marks`); step ms in
    ``fit`` (steps without an eval), slices/s, peak GB, a profile's device
    ms per step beside the prediction. Returns (launches of the bidir
    serving, state-saving and backward kernels in the run, step ms, device
    ms per step, peak GB)."""
    import tempfile

    from mamba_unet_torch.train import TrainConfig, WeakScribbleTrainer

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as snap:
        cfg = TrainConfig(base_lr=0.01, max_iterations=1000,
                          batch_size=TRAIN_BATCH, patch_size=(PATCH, PATCH),
                          num_classes=4, eval_every=WEAK_EVAL_AT,
                          log_every=1, seed=1337, bf16=True,
                          snapshot_dir=snap)
        m1, m2, m3 = weak_trio(torch, "cpu")
        trainer = WeakScribbleTrainer(m1, cfg, model2=m2, model3=m3,
                                      device=dev)
        before = [{k: v.detach().clone() for k, v in m.state_dict().items()}
                  for m, _, _ in trainer._members()]
        val, loader = phantom_loader(torch, dev, TRAIN_BATCH, scribble=True)
        result, steps, ms, peak = counted_fit(torch, trainer, loader, val,
                                              WEAK_ITERS, "weak_scribble")
        eval_fwd = math.ceil(sum(len(v["image"]) for v in val)
                             / cfg.eval_batch_size)
        n = SS2D_PER_FORWARD
        evals = range(WEAK_EVAL_AT, WEAK_ITERS + 1, WEAK_EVAL_AT)
        check_step_launches("weak_scribble", steps, [0, n, n] + [0] * 6,
                            evals, [n * eval_fwd] + [0] * 8)
        launches = [sum(s[i] for s in steps) for i in range(3)]
        saved = sorted(p.name for p in Path(snap).iterdir())
        dice = [(h["val_dice"], h["val_dice2"], h["val_dice3"])
                for h in result["history"] if "val_dice" in h]
        check_best_marks("weak_scribble", snap, {
            name: [(i, d[j]) for i, d in zip(evals, dice)]
            for j, name in enumerate(("best", "best2", "best3"))})
    moved = [sum(not torch.equal(v, m.state_dict()[k]) for k, v in b.items()
                 if v.is_floating_point())
             for b, (m, _, _) in zip(before, trainer._members())]
    floats = [sum(v.is_floating_point() for v in b.values()) for b in before]
    losses = [h["loss"] for h in result["history"] if "loss" in h]
    med, kept = median_after_warmup(ms, set(evals))
    log("weak_scribble", iterations=result["iterations"], batch=TRAIN_BATCH,
        dtype="bf16", models="unet,ViT_seg,ViM_seg",
        launches_serve_fwd_states_bwd=tuple(launches),
        params_moved=" ".join(f"{a}/{b}" for a, b in zip(moved, floats)),
        val_dice_123=" ".join(",".join(f"{v:.4f}" for v in d) for d in dice),
        eval_forwards=eval_fwd, saved=" ".join(saved))
    log("weak_scribble", losses=" ".join(f"{v:.4f}" for v in losses))
    device = profile_steps(torch, trainer, loader, "train_weak_scribble")
    log("weak_scribble", step_ms_median=f"{med:.2f}",
        step_ms_min=f"{kept[0]:.2f}", step_ms_max=f"{kept[-1]:.2f}",
        slices_per_s=f"{TRAIN_BATCH / med * 1e3:.1f}",
        peak_mem_gb=f"{peak:.2f}", device_ms_per_step=f"{device:.2f}",
        predicted_device_ms=WEAK_PREDICTED_DEVICE_MS,
        predicted_peak_gb=WEAK_PREDICTED_PEAK_GB)
    if not sum(losses[-3:]) < sum(losses[:3]):
        raise AssertionError(f"the weak loss did not fall: {losses}")
    if min(a / b for a, b in zip(moved, floats)) < 0.99:
        raise AssertionError(f"weights moved {moved} of {floats}")
    del trainer, loader
    return launches, med, device, peak


def trainability_phase(torch, dev):
    """``[trainability]``: full-width ``ViM_seg`` from scratch under
    ``warmup_adamw`` (base lr 1e-3, weight decay 0.05, linear warm-up over
    250 iterations, then poly decay), drop_path 0.2, on the easy phantom,
    bs24 @ 224², bf16, TRAINABILITY_ITERS steps with an eval every
    TRAINABILITY_EVAL_EVERY: at the last eval every foreground class's val
    Dice must be above 0 (from scratch under poly-SGD the model predicts
    background only: PERF.md). Prints the loss every 25 steps and the
    per-class val Dice."""
    from mamba_unet_torch.eval.inference import evaluate_slice_volumes
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.train import TrainConfig, Trainer, warmup_adamw

    iters = TRAINABILITY_ITERS
    cfg = TrainConfig(base_lr=1e-3, max_iterations=iters,
                      batch_size=TRAIN_BATCH, patch_size=(PATCH, PATCH),
                      num_classes=4, eval_every=TRAINABILITY_EVAL_EVERY,
                      log_every=1, seed=1337, bf16=True)
    trainer = Trainer(
        MambaUnet(num_classes=4, drop_path_rate=0.2,
                  generator=torch.Generator().manual_seed(1337)),
        cfg, device=dev, make_optimizer=lambda params: warmup_adamw(
            params, cfg.base_lr, iters, weight_decay=0.05))
    val, loader = phantom_loader(torch, dev, TRAIN_BATCH)
    t0 = time.perf_counter()
    result = trainer.fit(loader, val)
    secs = time.perf_counter() - t0
    per_class = evaluate_slice_volumes(
        iter(val), trainer.predict_fn(), 4, patch_size=cfg.patch_size,
        batch_size=cfg.eval_batch_size)[:, :, 0].mean(0)
    losses = [h["loss"] for h in result["history"] if "loss" in h]
    dice = [(h["iter"], h["val_dice"]) for h in result["history"]
            if "val_dice" in h]
    log("trainability", model="ViM_seg", optimizer="warmup_adamw",
        base_lr=cfg.base_lr, iterations=result["iterations"],
        batch=TRAIN_BATCH, dtype="bf16", seconds=f"{secs:.1f}",
        ms_per_step=f"{1e3 * secs / iters:.1f}",
        losses_every_25=" ".join(f"{v:.4f}" for v in losses[::25]),
        last_loss=f"{losses[-1]:.4f}",
        val_mean_dice=" ".join(f"{i}:{d:.4f}" for i, d in dice),
        val_dice_per_class=" ".join(f"{d:.4f}" for d in per_class))
    if (result["iterations"] != iters or len(dice) != iters
            // TRAINABILITY_EVAL_EVERY or not (per_class > 0).all()):
        raise AssertionError(f"from scratch under AdamW, a foreground class "
                             f"is never predicted: per-class Dice "
                             f"{per_class}, evals {dice}")
    del trainer, loader


def main() -> int:
    import numpy as np
    import torch

    # --- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from mamba_unet_torch.cli.test import BATCH_SIZE as SERVE_BATCH
    from mamba_unet_torch.cli.test import infer_volume
    from mamba_unet_torch.ops import _build
    from mamba_unet_torch.ops.selective_scan_bidir import (
        selective_scan_bidir,
        selective_scan_bidir_ref,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device_name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log("device", name=repr(device_name), count=count, torch=torch.__version__,
        cuda=torch.version.cuda)
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    clock = [time.perf_counter()]

    def phase_done(name):
        """``[phase_seconds]``: the seconds since the last mark."""
        now = time.perf_counter()
        log("phase_seconds", group=name, seconds=f"{now - clock[0]:.1f}")
        clock[0] = now

    # --- 2. build
    t0 = time.perf_counter()
    _build.library()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        lib=_build.build().name)
    kernel_occ_phase(torch)
    phase_done("1-2 device, build")

    # --- 3. kernel vs plain at batch 2 and the ragged shapes, then timed
    # and compared at batch 24
    max_err = 0.0
    ms_fwd = plain_ms_fwd = 0.0
    for bsz, L, dg in BIDIR_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(torch, bsz, L, dg, dtype, dev, seed=L + dg)
            err = check_kernel(torch, selective_scan_bidir(*args),
                               selective_scan_bidir_ref(*args), L=L, dg=dg,
                               batch=bsz, dtype=str(dtype).split(".")[-1])
            max_err = max(max_err, err)
    for L, dg, calls in STAGES:
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(torch, 2, L, dg, dtype, dev, seed=L)
            err = check_kernel(torch, selective_scan_bidir(*args),
                               selective_scan_bidir_ref(*args), L=L, dg=dg,
                               batch=2, dtype=str(dtype).split(".")[-1])
            max_err = max(max_err, err)
        times = {}
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[-1]
            args = scan_inputs(torch, SERVE_BATCH, L, dg, dtype, dev, 0)
            ms, got = cuda_ms(torch, lambda: selective_scan_bidir(*args), 20)
            plain, want = cuda_ms(
                torch, lambda: selective_scan_bidir_ref(*args), 1)
            err = check_kernel(torch, got, want, L=L, dg=dg,
                               batch=SERVE_BATCH, dtype=tag)
            max_err = max(max_err, err)
            times[tag] = (ms, plain)
            del args, got, want
        ms, plain = times["float32"]
        ms_fwd += calls * ms
        plain_ms_fwd += calls * plain
        log("kernel_time", L=L, dg=dg, batch=SERVE_BATCH, ms=f"{ms:.4f}",
            plain_ms=f"{plain:.2f}", speedup=f"{plain / ms:.1f}x",
            bound_ms=f"{scan_bound('fwd', SERVE_BATCH, L, dg, 4)[0]:.4f}",
            bf16_ms=f"{times['bfloat16'][0]:.4f}",
            bf16_plain_ms=f"{times['bfloat16'][1]:.2f}")
    log("kernel_time", per_forward_ms=f"{ms_fwd:.4f}",
        plain_per_forward_ms=f"{plain_ms_fwd:.2f}", calls=SS2D_PER_FORWARD)
    phase_done("3 kernel")

    # --- 4. full-width model: card (kernel) vs CPU copy (plain scan)
    from mamba_unet_torch.data.synthetic import phantom_volumes
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.utils.checkpoint import load_model_snapshot
    from mamba_unet_torch.utils.export import make_predict_fn

    model = load_model_snapshot("ViM_seg", 4, 1, device=dev)
    cpu_model = MambaUnet(num_classes=4).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    x = torch.randn(2, 224, 224, 1, generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    got = make_predict_fn(model)(x.to(dev)).cpu()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = make_predict_fn(cpu_model)(x)
    cpu_s = time.perf_counter() - t0
    err = (got - want).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log("parity", shape=tuple(got.shape), max_abs_err=f"{err:.3e}",
        logit_max=f"{want.abs().max():.3f}", argmax_agree=f"{agree:.6f}",
        tol=LOGIT_TOL, gpu_s=f"{gpu_s:.2f}", cpu_s=f"{cpu_s:.2f}")
    if got.shape != (2, 224, 224, 4) or not torch.isfinite(got).all():
        raise AssertionError(f"bad logits: {tuple(got.shape)}")
    if err > LOGIT_TOL or agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"card logits disagree with the CPU: max abs "
                             f"err {err}, argmax agreement {agree}")
    del cpu_model
    bf16 = make_predict_fn(model, torch.bfloat16)(x.to(dev)).cpu()
    err16 = (bf16 - got).abs().max().item()
    agree16 = (bf16.argmax(-1) == got.argmax(-1)).float().mean().item()
    log("parity", compare="bf16_vs_fp32_card", max_abs_diff=f"{err16:.3e}",
        argmax_agree=f"{agree16:.6f}", tol=BF16_LOGIT_TOL)
    if (not torch.isfinite(bf16).all() or err16 > BF16_LOGIT_TOL
            or agree16 < BF16_MIN_ARGMAX_AGREEMENT):
        raise AssertionError(f"bf16 logits stray from fp32: max abs diff "
                             f"{err16}, argmax agreement {agree16}")

    # --- 5. serving through the test CLI's per-volume function, with the
    # TF32 settings a user of make_predict_fn gets
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    log("serving", matmul_tf32=tf32_defaults[0], cudnn_tf32=tf32_defaults[1])
    vols = phantom_volumes(3, 10, 256, 216, seed=0)
    forwards = sum(math.ceil(len(v["image"]) / SERVE_BATCH) for v in vols)
    fns = {"fp32": make_predict_fn(model),
           "bf16": make_predict_fn(model, torch.bfloat16)}
    warm = torch.zeros(SERVE_BATCH, 224, 224, 1, device=dev)
    for fn in fns.values():  # first-call set-up (cuDNN, autocast caches)
        fn(warm)
    torch.cuda.synchronize()

    selective_scan_bidir.launches = 0
    served = {}
    for tag, fn in fns.items():
        lat = []
        for v in vols:
            t0 = time.perf_counter()
            _, metrics = infer_volume(v["image"], v["label"], fn, 4,
                                      (224, 224))
            lat.append(time.perf_counter() - t0)
            if not all(math.isfinite(m) for row in metrics for m in row):
                raise AssertionError(f"non-finite metrics {metrics}")
        served[tag] = lat
    launches = selective_scan_bidir.launches
    expect = SS2D_PER_FORWARD * forwards * len(fns)
    log("serving", volumes=len(vols), slices_per_volume=10,
        native="256x216", forwards=forwards * len(fns), launches=launches,
        expected=expect)
    if launches != expect:
        raise AssertionError(f"kernel launched {launches} times, expected "
                             f"{expect} ({SS2D_PER_FORWARD} per forward)")

    batch = torch.randn(SERVE_BATCH, 224, 224, 1, device=dev)
    for tag, fn in fns.items():
        ms, _ = cuda_ms(torch, lambda: fn(batch), 10)
        lat = served[tag]
        log("serving", scan_impl="auto", dtype=tag, batch=SERVE_BATCH,
            forward_ms=f"{ms:.2f}",
            slices_per_s=f"{SERVE_BATCH / ms * 1e3:.1f}",
            volume_latency_ms=f"{1e3 * sum(lat) / len(lat):.1f}",
            volume_slices_per_s=f"{10 * len(lat) / sum(lat):.1f}")
    branch_serving_phase(torch, dev, model, batch)
    phase_done("4-5 parity, serving")

    # --- 6-8. the training path
    train_kernels = kernel_bwd_phase(torch, dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grad_parity_phase(torch, dev)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    del model, fns
    torch.cuda.empty_cache()
    _, train_fwd, train_bwd = training_phase(torch, dev)
    phase_done("6-8 training")

    # --- 9-11. the Mamba-LM serving path (mamba-130m)
    lm_err, lm_times = lm_kernel_phase(torch, dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lm_model = lm_parity_phase(torch, dev)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    lm_launches = lm_serving_phase(torch, np, dev, lm_model)
    del lm_model
    torch.cuda.empty_cache()
    phase_done("9-11 lm")

    # --- 12-15. Mamba-UNet training on SS2D's time-major branch, and the
    # gradients of the 1-D Mamba stack (mamba-130m)
    tm_kernels = tm_kernel_phase(torch, dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    branch_logits_phase(torch, dev, grad_parity_phase(torch, dev, "tm"), "tm")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    torch.cuda.empty_cache()
    _, tm_fwd, tm_bwd = training_phase(torch, dev, "tm")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lm_grad_phase(torch, dev)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    torch.cuda.empty_cache()
    phase_done("12-15 tm, lm_grad")

    # --- 16-18. Mamba-UNet training and serving on SS2D's batch-folded
    # branch
    folded_kernels = folded_kernel_phase(torch, dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    branch_logits_phase(torch, dev, grad_parity_phase(torch, dev, "folded"),
                        "folded")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    torch.cuda.empty_cache()
    folded_launches = training_phase(torch, dev, "folded")
    phase_done("16-18 folded")

    # --- the main path's remaining entry points: activation
    # recomputation, the exported artifact and the CLIs
    torch.cuda.empty_cache()
    remat_phase(torch, dev)
    phase_done("remat")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    export_phase(torch, dev)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    phase_done("export")
    torch.cuda.empty_cache()
    entry_points_phase(torch, np, dev)
    phase_done("entry_points")

    # --- the UNet family, Swin-UNet, and the semi-supervised methods
    # (Semi-Mamba-UNet's cross-teaching, mean teacher, UAMT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    zoo_parity_phase(torch, dev)
    cross_teaching_parity_phase(torch, dev)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    torch.cuda.empty_cache()
    zoo_training_phase(torch, dev)
    phase_done("zoo, cross_teaching_parity")
    cross_teaching_phase(torch, dev)
    for method in ("mean_teacher", "uamt"):
        ema_teacher_phase(torch, dev, method)
    phase_done("cross_teaching, mean_teacher, uamt")
    semi_entry_points_phase(torch, np, dev)
    phase_done("entry_points: semi-supervised methods, unet, ViT_seg, "
               "weak_scribble")

    # --- Weak-Mamba-UNet (scribble supervision), from-scratch trainability
    # under AdamW, then the weak step card vs CPU: last, so that its CPU
    # backward does not share the host with a timed phase
    torch.cuda.empty_cache()
    weak_launches, *_ = weak_scribble_phase(torch, dev)
    phase_done("weak_scribble")
    torch.cuda.empty_cache()
    trainability_phase(torch, dev)
    phase_done("trainability")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weak_parity_phase(torch, dev)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    phase_done("weak_parity")

    serve_bound = sum(calls * scan_bound("fwd", SERVE_BATCH, L, dg, 4)[0]
                      for L, dg, calls in STAGES)
    pallas = "mamba_unet_tpu/ops/selective_scan_pallas.py"
    # the bidir kernels' launches: their main path's run plus the weak
    # trio's (model 3)
    rows = [dict(name="selective_scan_bidir_fwd",
                 launches=launches + weak_launches[0],
                 max_abs_err=max_err, ms=ms_fwd, plain_ms=plain_ms_fwd,
                 bound_ms=serve_bound,
                 bound_by=scan_bound("fwd", SERVE_BATCH, 3136, 192, 4)[1],
                 source="mamba_unet_torch/csrc/selective_scan_bidir_fwd.cu",
                 replaces=("mamba_unet_tpu/ops/selective_scan_persistent.py"
                           f":130, {pallas}:229"))]
    for kernel, kind, n, src, where in (
            ("selective_scan_bidir_fwd_states", "fwd_states",
             train_fwd + weak_launches[1], "selective_scan_bidir_fwd.cu",
             f"{pallas}:238"),
            ("selective_scan_bidir_bwd", "bwd", train_bwd + weak_launches[2],
             "selective_scan_bidir_bwd.cu", f"{pallas}:318")):
        err, ms, plain, bound, by = train_kernels[kind]
        rows.append(dict(name=kernel, launches=n, max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=bound, bound_by=by,
                         source=f"mamba_unet_torch/csrc/{src}",
                         replaces=where))
    ms, plain, bound, by = lm_times["scoring"]
    rows.append(dict(name="selective_scan_fwd", launches=lm_launches,
                     max_abs_err=lm_err, ms=LM_DEPTH * ms,
                     plain_ms=LM_DEPTH * plain, bound_ms=LM_DEPTH * bound,
                     bound_by=by,
                     source="mamba_unet_torch/csrc/selective_scan_fwd.cu",
                     replaces=f"{pallas}:229 (unidirectional)"))
    for kernel, kind, n, src, where in (
            ("selective_scan_fwd_states", "fwd_states", tm_fwd,
             "selective_scan_fwd.cu",
             f"{pallas}:229 (unidirectional, save_cs: _scan_core_fwd :586)"),
            ("selective_scan_bwd", "bwd", tm_bwd, "selective_scan_bwd.cu",
             f"{pallas}:318 (unidirectional: _scan_core_bwd :701)")):
        err, ms, plain, bound, by = tm_kernels[kind]
        rows.append(dict(name=kernel, launches=n, max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=bound, bound_by=by,
                         source=f"mamba_unet_torch/csrc/{src}",
                         replaces=where))
    folded = "mamba_unet_tpu/ops/selective_scan_folded.py"
    for kernel, kind, n, src, where in (
            ("selective_scan_folded_fwd", "serve", folded_launches[0],
             "selective_scan_folded_fwd.cu",
             f"{folded}:162 (_scan_fwd_folded :431, save_cs=False)"),
            ("selective_scan_folded_fwd_states", "fwd_states",
             folded_launches[1], "selective_scan_folded_fwd.cu",
             f"{folded}:162 (_scan_fwd_folded :431, save_cs=True)"),
            ("selective_scan_folded_bwd", "bwd", folded_launches[2],
             "selective_scan_folded_bwd.cu",
             f"{folded}:241 (_scan_bwd_folded :495)")):
        err, ms, plain, bound, by = folded_kernels[kind]
        rows.append(dict(name=kernel, launches=n, max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=bound, bound_by=by,
                         source=f"mamba_unet_torch/csrc/{src}",
                         replaces=where))
    # no single PyTorch call computes the selective scan
    print(json.dumps({"kernels": [dict(route="cuda", library_ms=None, **r)
                                  for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": device_name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
