#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card:
Mamba-UNet serving and training, Mamba-LM serving, Mamba-UNet training on
SS2D's time-major branch and the 1-D Mamba stack's gradients, Mamba-UNet
training and serving on SS2D's batch-folded branch, the main path's
other entry points (activation recomputation, the ``torch.export``
artifact and the CLIs, SS2D's xla route among them), then the UNet
family and Swin-UNet, the semi-supervised methods (Semi-Mamba-UNet's
cross-teaching, mean teacher and UAMT), the scribble-supervised
Weak-Mamba-UNet, a from-scratch trainability check, contrastive
consistency (two ``ViM_seg`` with CTAugment views and projectors), the
Mamba mask model's self-supervised pretraining, MagicNet (on the Mamba
mask model, and the 3-D VNet on BTCV-style volumes), the Mamba LM's
bf16 compute and exported generation, MAD (the label denoiser's
pretraining, the stacked fine-tuning and the stacked test CLI), and the
rest of the model zoo: the 2-D models through the train CLI, the 3-D ones
a training step each, and SegMamba on the grouped scan kernels; then the
grouped kernels' carry over L, the sequence-, channel- and
pipeline-parallel paths and data parallelism on gloo ranks sharing the
card, and the remaining utilities.

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
              and every gradient card vs phase 7's CPU step (the same
              weights and batch), 14 + 14 grouped launches;
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
              loss and every gradient card vs phase 7's CPU step, 14 + 14
              folded launches
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
              full-width ``ViM_seg``, batch 2 (1 labeled + 1 unlabeled)
              at 64², fp32 with TF32 off, drop_path 0: the loss and both models'
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
30. cc_kernel_shapes - the bidir state-saving forward and backward
              against their plain versions at the mask-pretraining
              location pass's shapes (every 32² cube of a bs24 224² batch:
              batch 1,176 at (L, dg) = (64, 192), (16, 384), (4, 768),
              (1, 1536)), fp32 and bf16, each timed.
31. contrastive_consistency - ``ContrastiveConsistencyTrainer.fit`` of
              two full-width ``ViM_seg`` on the CTA-fed two-stream phantom
              ``Loader``, bs24 with 8 labeled, bf16, CC_ITERS steps with one
              eval: 56 + 56 bidir training launches per step and no serving
              one, 14 serving launches per eval forward of each model;
              ``best``/``best2``; the policy refreshed and
              ``cta_state.json`` beside the periodic checkpoint; the
              transform's host ms per batch, step ms in ``fit``, device ms,
              busy share and peak GB beside the prediction.
32. mask_pretrain - ``MaskPretrainTrainer.fit`` of full-width
              ``MambaUnetMask`` (224², 32² cubes), bs24, bf16: 50 + 50
              bidir training launches per step (three heads and the
              location pass's encoder); the same numbers.
33. cc_mask - the contrastive trainer's mask variant on a
              ``MambaUnetMask`` pair, a few steps: 98 + 98 launches per
              step, peak GB and device ms at bs24.
34. entry_points - ``cli.train --method contrastive_consistency --model
              ViM_seg`` and ``--method mask_pretrain --model
              MambaUnetMask`` on phantoms, launches checked, then
              ``cli.test`` serving ``best`` and ``best2`` of the first and
              the second's newest checkpoint.
35. magicnet_mamba, magicnet_mask - ``MagicNetTrainer.fit`` of
              full-width ``MambaUnetMask`` (224², 32² cubes, its patch
              embedding's bias drawn) on two-stream phantom batches, bs24
              with 8 labeled, bf16, MAGIC_ITERS steps, without and with
              ``--mask_recovery``: per step 14 serving launches (the EMA
              teacher) and 42 + 42 bidir training ones (two grad passes,
              the cube encoder and decoder at batch 1,176), 84 + 84 with
              the three mix-head passes; finite, falling losses; the class
              distribution refreshed at step 20 (every unlabeled pixel of
              20 steps counted); step ms, device ms, busy share and peak
              GB beside the prediction.
36. magicnet_3d - ``MagicNetTrainer.fit`` of the 3-D ``magicnet`` at the
              reference's BTCV protocol (96³, 16 filters, instance norm,
              14 classes, bs4 with 2 labeled, cubes of 32, fp32) on organ
              phantoms: no scan launch, weights moved, the same step
              numbers; then one sliding-window ``validation_all_case`` of
              a 112³ case (8 windows at stride 16), its seconds and its
              (1, 13, 4) array.
37. entry_points - ``cli.train --dataset btcv --method magicnet --model
              magicnet --synthetic`` (2 steps, ``metric_final.npy`` of (1,
              13, 4)) and ``--method magicnet --model MambaUnetMask
              --mask_recovery --synthetic``, launches checked.
38. lm_bf16 - mamba-130m with compute dtype bf16: one scoring forward (8 x
              1024) against fp32 on the card (logits within 5 % of the
              max, greedy agreement), both timed and the bf16 one
              profiled; 24 grouped launches; then a bf16 greedy
              ``generate`` of 8 tokens after 4 prompts (24 launches).
39. lm_export - ``export_lm_generate`` of mamba-130m's width cut to 2
              layers, for 4 prompts of 128 tokens and 16 greedy new
              tokens (the export's host time grows with layers x
              tokens): its seconds, the exported program's tokens equal
              eager ``generate``'s, ms per token of each, 2 grouped
              launches per call.
40. weak_parity - one Weak-Mamba-UNet step of the full-width trio
              (``unet``, ``ViT_seg``, ``ViM_seg``), batch 2 at 224² on
              phantom scribbles, dropout and drop_path 0, fp32 with TF32
              off, the same mix weights and pseudo-labels: the losses and
              the three models' every gradient card vs CPU (unet's against
              its largest gradient: fp32 conditioning); 14 + 14 bidir
              training launches.
41. cc_parity - one contrastive step of the full-width ``ViM_seg`` pair
              with its projectors (batch 2, 64²), then one mask-
              pretraining step of ``MambaUnetMask`` (batch 8, 64²), fp32
              with TF32
              off, drop_path 0: the losses and every gradient card vs CPU.
42. magicnet_parity - one MagicNet step card vs CPU, the same draws, of a
              reduced ``MambaUnetMask`` with ``--mask_recovery`` (depths
              1, 64², batch 8: 7 + 42 + 42 launches) in fp32 with TF32 off
              (the losses, the class histograms: argmax ties may move a
              few pixels, every gradient within MODEL_GRAD_TOL of its
              model's largest) and of a reduced 3-D ``magicnet`` (32³,
              cubes of 16, batch 2) in fp64 (the losses, the histogram
              and every gradient within MAGIC3D_FP64_TOL).
43. mad_pretrain - ``cli.train --method mad_pretrain --model unet`` (4
              input channels) on phantom slices, bs24 @ 224², bf16, 20
              steps and the corrupted-label validation: no scan launch,
              falling losses; step ms, device ms, peak GB; the
              validation Dice again with the denoiser's BatchNorm
              statistics re-estimated over 8 training batches.
44. mad_finetune - ``cli.train --method mad_finetune --model ViM_seg
              --mad_model unet``, warm-started from ``[trainability]``'s
              ``ViM_seg`` (``--seg_ckpt``) and the pretraining's snapshot
              (``--mad_ckpt``), bs24 bf16, 20 steps and one stacked
              validation: 14 + 14 bidir training launches per step, 14
              serving ones per validation forward; the trio's best,
              saved by the trainer (a stacked Dice above 0); the same
              step numbers.
45. mad_test - ``cli.test --model ViM_seg --denoiser_model unet`` on
              phantom volumes, with the pretrained denoiser and with the
              fine-tuned den (``--denoiser_ckpt_name best3``): both
              metric tables, 14 serving launches per segmenter forward,
              none per denoiser forward.
46. zoo_2d - ``cli.train`` of ``enet``, ``efficient_unet`` and
              ``preUnet``, bs24 @ 224², bf16, 6 steps each: no scan
              launch; device ms per step, peak GB; a bs24 forward of
              ``fc_discriminator``.
47. zoo_3d - one fp32 training step (TF32 convolutions) of ``unet_3D``,
              ``unet_3D_dv_semi``, ``voxresnet``, ``attention_unet``,
              ``nnUNet`` (a 24 x 192² patch), ``unetr`` and ``SwinUNETR``
              (window 6) at their default widths on 96³ at batch 2:
              device ms, peak GB, no scan launch.
48. segmamba_kernel - the grouped kernels (#3, #3s, #4u) against their
              plain versions at SegMamba's scan shapes (batch 2, (L,
              d_inner) = (13,824, 192) in bf16, (1,728, 384) and (216,
              768) in fp32 and bf16, stage 0's (110,592, 96) on its first
              4,096 tokens in both); each timed at every full stage shape
              beside its bound.
49. segmamba - full-width SegMamba on 96³ at batch 2, bf16: a no-grad
              forward (16 #3 launches) and a training step (16 #3s, 16
              #4u), their device ms and peak GB.
50. mad_parity - one MAD fine-tuning step of ``ViM_seg`` + two ``unet``
              (batch 2, 128², fp32, TF32 off) card vs CPU: the losses and
              every gradient within 1e-3 of its model's largest.
51. zoo3d_parity, segmamba_parity - the 3-D zoo's eval-mode logits
              (32³, nnU-Net 8 x 64²) and SegMamba's logits and gradients
              (32³, stage 0 L = 4,096) at full width, one Mamba layer
              per stage, card vs CPU: fp32 logits and loss, each Mamba
              layer's gradients alone (1e-3 of each leaf's max), the
              whole step's in fp64 with plain fp64 Mamba layers (1e-8 of
              the largest). 40-42
              and 50-51 last, as their CPU backwards would share the host
              with a timed phase. Before them, after 49:
52. scan_carry_kernel - #3, #3s and #4u with an incoming state
              (``x_init``), the last state and its cotangent (``g_last``,
              giving ``x_init``'s) against their plain versions at the
              mamba-130m shape (8 x 1024 x 1536, G = 1) and ViM stage 0
              (bs24, G = 4, dg 192, L 3136), fp32 and bf16; each timed
              with and without the new arguments (fp32).
53. seq_parallel, tp_parallel, pipeline, data_parallel,
    data_parallel_methods - one group of 2 ``gloo`` ranks sharing card 0
              (correctness, not speed), and a third process running the
              one-process references, started side by side before the
              card-vs-CPU parity phases (which print no times) and
              collected after them:
              full-width ``ViM_seg`` (bs8 @ 224², fp32) on
              ``scan_impl="seq_sharded"`` and ``"tp_sharded"``, served
              and trained, against the one-process tm branch of the same
              weights and batch (every gradient); the mamba-130m-width LM
              (24 layers) over 2 stages, 4 microbatches of 2 x 128
              tokens, logits, loss and gradients against one process; 2
              data-parallel steps of 2 x 12 rows of a bs24 bf16
              ``ViM_seg`` batch with drop-path 0.2 and of a ``unet`` (fp32,
              BatchNorm), losses and weights against the one-process
              bs24 steps; every multi-model trainer's 2 steps
              (cross-teaching ``ViM_seg`` + ``unet`` at bs24 bf16 with 8
              labeled; mean teacher, UAMT, Weak-Mamba-UNet's trio,
              contrastive consistency plain and with mask recovery, mask
              pretraining, MagicNet with and without mask recovery at a
              global batch of 4 (2 labeled) at 224², the 3-D MagicNet at
              96³ batch 4, MAD pretraining and fine-tuning): losses,
              each leaf's distance over its update, the host state, the
              replicas' digests and the scan launches per rank, with a
              control (model 2's gradients unreduced) that must fail.
              The carry variants' launches are counted here.
54. utils - ``cli.train --cfg configs/vmamba_tiny.yaml --opts
              MODEL.DROP_PATH_RATE 0.1`` on phantoms (3 bf16 steps, 14
              state-saving launches each), the native augmentation built
              with g++ into ``build/`` (bitwise against the Python
              generator), ``model_flops`` and ``parameter_count`` of
              ``ViM_seg`` at bs24 @ 224² (the scans' share), a
              ``profile_trace`` and a fit with ``TrainConfig.tensorboard``
              (its ``scalars.jsonl``).

``[phase_seconds]`` follows each group of phases. Then one JSON line with
the kernel table, and the last line ``{"ok": true, "device": {...}}``. It
imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
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
# the full-width backward card vs CPU of [grad_parity] and its tm and
# folded branches: 2 images at 224², so that a kernel that mixes up the
# batch stride shows in the model's gradients. [cross_teaching_parity] and
# [cc_parity] run smaller than before the MagicNet and LM-export phases
# joined (4 images at 224² and 2 at 224² / 8 at 128², then 2 at 128² and 2
# at 128² / 8 at 64², and since the MAD and zoo phases 2 at 64² and 2 at
# 64² / 8 at 64²), so that the whole script stays within its 1,200 s:
# their CPU backwards took ~300 s of a 1,290 s run on an NVIDIA H100 80GB
# HBM3 host; the kernels meet the full stage shapes at batch 2 here and in
# phases 3, 6 and 12-18, whose tm and folded branches hold their card step
# against this phase's one CPU step (cpu_reference_step)
GRAD_PARITY_BATCH = 2
# the semi-supervised phases: labeled slices per bs24 batch; the cross-
# teaching parity step's batch (labeled + unlabeled); fit steps of
# [cross_teaching] and its eval cadence, and of [mean_teacher] / [uamt];
# UAMT's teacher passes (the consistency target + T = 8 MC passes)
SEMI_LABELED = 8
CROSS_PARITY_BATCH, CROSS_PARITY_LABELED, CROSS_PARITY_PATCH = 2, 1, 64
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
# the mask-pretraining location pass runs the encoder on every 32² cube of
# a bs24 224² batch: batch 24 x 49 = 1176, at (L, dg) of its four stages
# (2 SS2D calls each), so 3 x 14 + 8 training scans per step
CUBE_SIZE = 32
CUBE_BATCH = TRAIN_BATCH * (PATCH // CUBE_SIZE) ** 2
CUBE_STAGES = ((64, 192), (16, 384), (4, 768), (1, 1536))
MASK_PER_STEP = 3 * SS2D_PER_FORWARD + 8
# [contrastive_consistency], [mask_pretrain], [cc_mask]: fit steps and the
# eval step; [cc_parity]'s batches; the predictions per bs24 bf16 step,
# made before the first card run from the cross-teaching step (two ViM_seg
# passes: 149.03 ms of device time, 15.03 GB) on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md, section 5): four passes plus the projectors; three
# passes plus an encoder pass of the same pixel count; seven passes
CC_ITERS, CC_EVAL_AT = 10, 6
MASK_ITERS, MASK_EVAL_AT = 10, 6
CC_MASK_ITERS = 4
# the mask step's card-vs-CPU check runs at batch 8 on 64² images (4
# cubes): its heads' train-mode BatchNorms normalize over the batch, and at
# batch 4 features whose variance nears eps move the gradients by 1.6e-2 of
# their largest (measured on an NVIDIA H100 80GB HBM3); the contrastive
# pair's step runs at 64²
CC_PARITY_BATCH, MASK_PARITY_BATCH, MASK_PARITY_PATCH = 2, 8, 64
CC_PARITY_PATCH = 64
CC_PREDICTED_DEVICE_MS, CC_PREDICTED_PEAK_GB = "300-320", 30
MASK_PREDICTED_DEVICE_MS, MASK_PREDICTED_PEAK_GB = "250-270", 25
CC_MASK_PREDICTED_DEVICE_MS, CC_MASK_PREDICTED_PEAK_GB = 520, 50
# [magicnet_mamba], [magicnet_mask]: MagicNet on full-width MambaUnetMask,
# bs24 (8 labeled) @ 224², cubes of 32, bf16, drop path 0.2 (the mix heads
# only: the other passes are deterministic), MAGIC_ITERS steps (the class
# distribution refreshes at step 20). Per step the bidir serving, state-
# saving and backward launches: the EMA teacher's no-grad pass (14), two
# grad passes (28), the cube encoder (8) and decoder (6) at batch 24 x 49;
# --mask_recovery adds three mix-head passes (42). The predictions per
# step, made before the first card run from [cross_teaching] (two ViM_seg
# grad passes: 149 ms of device time) and [mask_pretrain] (265.66 ms) on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 5)
MAGIC_ITERS = 21
MAGIC_PER_STEP = (SS2D_PER_FORWARD, 3 * SS2D_PER_FORWARD,
                  3 * SS2D_PER_FORWARD)
MAGIC_MASK_PER_STEP = (SS2D_PER_FORWARD, 6 * SS2D_PER_FORWARD,
                       6 * SS2D_PER_FORWARD)
MAGIC_PREDICTED_DEVICE_MS, MAGIC_PREDICTED_PEAK_GB = "220-260", "20-30"
MAGIC_MASK_PREDICTED_DEVICE_MS, MAGIC_MASK_PREDICTED_PEAK_GB = (
    "420-480", "40-55")
# [magicnet_3d]: the reference's BTCV protocol (BASELINE.md): magicnet (16
# filters, instance norm), 14 classes, 96³ patches, cubes of 32, bs4 with 2
# labeled, fp32 with PyTorch's TF32 defaults; 8 train phantoms of 96³ and
# one 112³ validation phantom (2³ windows at stride 16: a 128³ case's 27
# windows took 24-42 s of host softmax and EDT metrics on NVIDIA H100
# 80GB HBM3 hosts, beyond the script's time); fit steps; the
# prediction per step, made before the first card run from the model's
# FLOPs (~80 GFLOP per 96³ forward, 14 forward- and 12 backward-sample
# equivalents per step) and its fp32 GroupNorm passes
MAGIC3D_PATCH, MAGIC3D_BATCH, MAGIC3D_LABELED = 96, 4, 2
MAGIC3D_CLASSES, MAGIC3D_CUBE, MAGIC3D_VAL = 14, 32, 112
MAGIC3D_TRAIN_VOLUMES, MAGIC3D_ITERS = 8, 6
MAGIC3D_PREDICTED_DEVICE_MS, MAGIC3D_PREDICTED_PEAK_GB = "150-400", "15-35"
# [magicnet_parity]: one step card vs CPU of a reduced MambaUnetMask
# (depths 1, full widths, 64², batch 8 with 4 labeled, --mask_recovery: 7
# serving, 42 state-saving and 42 backward launches) in fp32, and of a
# reduced 3-D magicnet (16 filters, 32³, cubes of 16, batch 2 with 1
# labeled) in fp64 (~20 s of CPU at 64³). The teacher's argmax meets ties under the two devices'
# fp32 rounding: the class histograms may part by MAGIC_HIST_TOL of the
# pixels, and the consistency Dice against them by MAGIC_CONS_TOL
# (relative; its weight at step 0 is 6.7e-4, so the other losses hold
# LOSS_TOL). The 3-D VNet's fp32 gradients are ill-conditioned (instance
# norms over small maps, flax's fast variance: card and CPU parted by
# 1.2e-2 of the largest gradient in fp32 on an NVIDIA H100 80GB HBM3), so
# its step runs in fp64 on both sides, where that amplification of
# rounding (~2e5 x fp32's 6e-8) predicts ~3e-11: its losses and every
# gradient (against the model's largest) are held within MAGIC3D_FP64_TOL
MAGIC3D_FP64_TOL = 1e-8
MAGIC_PARITY_2D = (8, 4, 64)
MAGIC_PARITY_3D = (2, 1, 32, 16)  # batch, labeled, size, cube
MAGIC_HIST_TOL, MAGIC_CONS_TOL = 1e-4, 1e-3
# MAD: the pretraining and fine-tuning CLI runs' steps (an eval after the
# last), the test CLI's volumes, the card-vs-CPU step; predicted device ms
# per step and peak GB (PERF.md, section 6, PR 14)
MAD_ITERS, MAD_TEST_VOLUMES = 20, 2
# [mad_pretrain]'s witness: the denoiser's BatchNorm statistics
# re-estimated over this many training batches
MAD_BN_BATCHES = 8
MAD_PARITY_BATCH, MAD_PARITY_PATCH = 2, 128
MAD_PRE_PREDICTED = ("24-30", "1.5-2.5")
MAD_FT_PREDICTED = ("120-140", "10-13")
# the rest of the zoo: the 2-D models' CLI steps; the 3-D models' batch
# and classes (BTCV's 14); SegMamba's batch, depths and scan shapes per
# stage ((L, d_inner) on a 96³ volume: the stem's stride 2 leaves 48³
# tokens at stage 0), stage 0 checked on its first SEGMAMBA_L0_CHECK
# tokens
ZOO2D_ITERS = 6
ZOO3D_BATCH, ZOO3D_CLASSES = 2, 14
SEGMAMBA_BATCH, SEGMAMBA_DEPTHS = 2, (2, 2, 2, 2)
SEGMAMBA_VOLUME, SEGMAMBA_PARITY_VOLUME = 96, 32
SEGMAMBA_STAGES = ((48 ** 3, 96), (24 ** 3, 192), (12 ** 3, 384),
                   (6 ** 3, 768))
SEGMAMBA_L0_CHECK = 4096
SEGMAMBA_PREDICTED_STEP_MS = "500-800"
# [segmamba_parity]: SegMamba's fp32 step is ill-conditioned at full
# width: its fp32 gradients lie far from an fp64 step's, by an amount
# that depends on the arithmetic (the phase prints the card's distance and
# the CPU's). So the gradients are held in two well-conditioned parts:
# each Mamba layer alone (the grouped kernels' gradients), card vs CPU in
# fp32 on the CPU step's own input and upstream gradient, within
# MODEL_GRAD_TOL of each leaf's own max; and the rest of the model in fp64
# on both sides, its Mamba layers a plain fp64 reference
# (fp64_mamba_forward), within SEGMAMBA_FP64_TOL of the largest gradient,
# as [magicnet_parity]'s 3-D step
SEGMAMBA_FP64_TOL = 1e-8
FP64_SCAN_CHUNK = 16  # fp64_mamba_forward's steps per chunk
# [segmamba_parity] runs one Mamba layer per stage (full width): its CPU
# fp64 step costs tens of seconds per layer on a slow host
SEGMAMBA_PARITY_DEPTHS = (1, 1, 1, 1)
# [lm_bf16]: the scoring forward's shape; bf16 logits against fp32 on the
# card within this share of the fp32 logits' max abs (BF16_LOGIT_TOL is 5 %
# of ViM_seg's); fp32's device ms per scoring forward (PERF.md, section 5)
LM_BF16_SHAPE, LM_BF16_REL_TOL, LM_FP32_SCORING_MS = (8, 1024), 0.05, 65.52
LM_BF16_NEW_TOKENS = 8  # [lm_bf16]'s greedy generation
# [lm_export]: exported greedy generation's prompts, prompt length and new
# tokens, a pinned batch, and the depth of its mamba-130m-width model: the
# unrolled graph's export takes ~0.4-0.75 s of host time per layer and
# token on the card's machine (277.6 s for 32 tokens at 24 layers, 118.8
# for 8, 46.4-70.7 for 4, on NVIDIA H100 80GB HBM3 hosts), so the phase
# exports 16 tokens of a 2-layer cut (32 until the parallelism phases
# joined the script, 23.5 s of export); the CPU and card tests cover the
# symbolic batch and the save / load round trip
LM_EXPORT_BATCH, LM_EXPORT_PROMPT, LM_EXPORT_TOKENS = 4, 128, 16
LM_EXPORT_DEPTH = 2
# the new phases' Mamba models start with their patch embedding's bias
# drawn from N(0, 0.02²), as after a warm start (the reference's scripts
# load ImageNet weights into every ViM): from the init's zero bias, a
# blank region of an image (CTAugment's fills and uint8 rounding leave
# exact zeros; the mask model's clean pass blanks the whole image) gives
# tokens of exactly 0 through every LayerNorm, whose zero variance scales
# the gradient by 1/sqrt(eps) each: 1e30 on the first contrastive step, in
# JAX as in the port (ROADMAP, section 3), and the next step is NaN
PATCH_BIAS_STD = 0.02
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
               n: int = 16, groups: int = 1, last_state: bool = False,
               carry: bool = False):
    """(least ms, "bytes" or "operations") of one scan call of ``kind``
    (fwd, fwd_states, bwd: the bidirectional kernels; folded,
    folded_fwd_states, folded_bwd: the batch-folded ones, whose operands
    are the bidirectional ones' but whose y and gy are four directions in
    the input dtype; grouped, grouped_fwd_states, grouped_bwd: the
    unidirectional ones over ``groups`` groups of ``dg`` channels, whose y,
    gy, du, ddelta, dB and dC are in the input dtype; ``last_state`` adds
    the serving forward's fp32 final state): each input read once, each
    output written once (``carry``: the grouped kernels' carry variants
    also read the fp32 incoming state and write the last state, or read
    the last state's cotangent and write the incoming state's);
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
        if carry:
            nbytes += 2 * bsz * groups * dg * n * 4
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


_CPU_REFERENCE = {}


def cpu_reference_step(torch):
    """The CPU side of phases 7, 13 and 17, computed once: full-width
    ``ViM_seg`` (seed 0, drop_path 0) on the CPU (the bidir branch's plain
    scan), its loss and every gradient of one backward on a seeded batch
    of GRAD_PARITY_BATCH; each branch's card step is held against it (the
    three branches compute one function of the same weights)."""
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.objectives import supervised_ce_dice

    if not _CPU_REFERENCE:
        gen = torch.Generator().manual_seed(2)
        model = MambaUnet(num_classes=4, drop_path_rate=0.0,
                          generator=torch.Generator().manual_seed(0))
        x = torch.randn(GRAD_PARITY_BATCH, PATCH, PATCH, 1, generator=gen)
        label = torch.randint(0, 4, (GRAD_PARITY_BATCH, PATCH, PATCH),
                              generator=gen)
        t0 = time.perf_counter()
        loss = supervised_ce_dice(model.train()(x), label)
        loss.backward()
        _CPU_REFERENCE.update(
            state={k: v.clone() for k, v in model.state_dict().items()},
            x=x, label=label, loss=loss.item(),
            grads={k: p.grad.clone() for k, p in model.named_parameters()},
            seconds=time.perf_counter() - t0)
    return _CPU_REFERENCE


def grad_parity_phase(torch, dev, scan_impl="auto"):
    """Phases 7, 13 and 17: one full-width backward (batch
    GRAD_PARITY_BATCH) on the card through SS2D's ``scan_impl`` branch (14
    state-saving forward and 14 backward launches of its kernels, none of
    the other branches') against the CPU's (:func:`cpu_reference_step`);
    returns the card model."""
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.objectives import supervised_ce_dice

    phase = "grad_parity" if scan_impl == "auto" else f"{scan_impl}_grad_parity"
    kernels, others = scan_kernels(scan_impl)
    ref = cpu_reference_step(torch)
    model = MambaUnet(num_classes=4, drop_path_rate=0.0, scan_impl=scan_impl,
                      device=dev)
    model.load_state_dict(ref["state"])
    x, label = ref["x"], ref["label"]
    losses, grads, secs = ({"cpu": ref["loss"]}, {"cpu": ref["grads"]},
                           {"cpu": ref["seconds"]})
    for tag, m in (("gpu", model),):
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
    # the card's activity only: the host's op events, which no row reads,
    # cost seconds of post-processing per call
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def seeded_lm(torch, dev, n_layer=LM_DEPTH):
    """Full-width mamba-130m (``n_layer`` deep) with seeded weights, on the
    CPU and a copy on the card. The init gives every channel the same A_log row and D = 1, a
    trained checkpoint a different one in each: they are perturbed per
    channel."""
    from mamba_unet_torch.models.mamba_lm import MambaLMHeadModel

    cpu_model = MambaLMHeadModel(LM_VOCAB, n_layer=n_layer,
                                 generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in cpu_model.named_parameters():
            if name.endswith(("A_log", ".D")):
                p.add_(0.5 * torch.randn(p.shape, generator=g))
    model = MambaLMHeadModel(LM_VOCAB, n_layer=n_layer, device=dev)
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
    with the same weights (served without a save / load), at batch 2,
    against eager; then full-width
    ``unet`` and ``ViT_seg`` (img 224), saved and served from the program,
    fp32 at batches 2 and 24 against eager (no scan launch), their device
    ms at bs24 beside eager's."""
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
        # served from the program itself: the fp32 and bf16 artifacts above
        # made the save / load round trip
        served = export_predict(other, (PATCH, PATCH)).module()
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
        # saved for the artifact's size; served from the program itself
        # (loading it back takes longer than exporting)
        path = save_exported(exported, str(out_dir / f"{name}.pt2"))
        served = exported.module()
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


class Sized:
    """An iterable with the length of the loader it wraps (the contrastive
    trainer's epoch)."""

    def __init__(self, it, n):
        self.it, self.n = it, n

    def __iter__(self):
        return iter(self.it)

    def __len__(self):
        return self.n


def counted_fit(torch, trainer, loader, val, iters, phase, **fit_kw):
    """``trainer.fit`` over ``iters`` batches of ``loader`` (evaluating on
    ``val`` as its config says; ``fit_kw`` to ``fit``), every scan
    wrapper's count set to 0 just before and read after each batch;
    returns (result, per-step launch vectors over
    :func:`all_scan_kernels`, ms of each step, peak GB). A step's ms runs
    from its batch's hand-out to the next one's."""
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
    result = trainer.fit(Sized(counted(loader), len(loader)), val, **fit_kw)
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
    full-width ``ViM_seg`` (seeds 0 and 1), batch 2 (1 labeled + 1
    unlabeled) at CROSS_PARITY_PATCH², fp32 (TF32 off by the caller), drop_path 0: the
    loss and both models' every gradient on the card against a CPU copy;
    28 state-saving forward and 28 backward bidir launches."""
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.train import CrossTeachingTrainer, TrainConfig

    size = CROSS_PARITY_PATCH
    cfg = TrainConfig(base_lr=0.01, max_iterations=1000,
                      batch_size=CROSS_PARITY_BATCH,
                      patch_size=(size, size), num_classes=4, seed=1337)
    gen = torch.Generator().manual_seed(4)
    batch = {"image": torch.randn(CROSS_PARITY_BATCH, size, size, 1,
                                  generator=gen),
             "label": torch.randint(0, 4, (CROSS_PARITY_BATCH, size, size),
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


def trainability_phase(torch, dev, snap):
    """``[trainability]``: full-width ``ViM_seg`` from scratch under
    ``warmup_adamw`` (base lr 1e-3, weight decay 0.05, linear warm-up over
    250 iterations, then poly decay), drop_path 0.2, on the easy phantom,
    bs24 @ 224², bf16, TRAINABILITY_ITERS steps with an eval every
    TRAINABILITY_EVAL_EVERY: at the last eval every foreground class's val
    Dice must be above 0 (from scratch under poly-SGD the model predicts
    background only: PERF.md). Prints the loss every 25 steps and the
    per-class val Dice; saves the model as ``best`` in ``snap`` (the
    segmenter ``[mad_finetune]`` warm-starts from)."""
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
    from mamba_unet_torch.utils.checkpoint import save_checkpoint

    save_checkpoint(str(snap), iters, trainer.model.state_dict(),
                    name="best")
    del trainer, loader


def cc_kernel_shapes_phase(torch, dev):
    """``[cc_kernel_shapes]``: the bidir state-saving forward (#2b) and
    backward (#4) against their plain versions at the shapes of the
    mask-pretraining location pass (every 32² cube of a bs24 224² batch
    through the encoder: batch CUBE_BATCH, (L, dg) of CUBE_STAGES), fp32
    and bf16, each timed (device ms per call) beside its plain version's
    ms and its bound; returns the worst error of each kernel."""
    from mamba_unet_torch.ops.selective_scan_bidir import (
        selective_scan_bidir_bwd,
        selective_scan_bidir_fwd_states,
    )

    worst = {"fwd_states": 0.0, "bwd": 0.0}
    for L, dg in CUBE_STAGES:
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[-1]
            args = scan_inputs(torch, CUBE_BATCH, L, dg, dtype, dev,
                               seed=L + dg)
            gy = torch.randn(CUBE_BATCH, 2, L, dg, generator=torch
                             .Generator().manual_seed(L)).to(dev)
            fwd_ms, (y, cs) = device_ms(
                torch, lambda: selective_scan_bidir_fwd_states(*args), 10)
            bwd_ms, _ = device_ms(
                torch, lambda: selective_scan_bidir_bwd(*args, cs, gy), 10)
            del y, cs
            errs, plain_fwd, plain_bwd = check_training_kernels(
                torch, args, gy, phase="cc_kernel_shapes", L=L, dg=dg,
                batch=CUBE_BATCH, dtype=tag)
            for kind in worst:
                worst[kind] = max(worst[kind], errs[kind])
            itemsize = 4 if dtype == torch.float32 else 2
            bound = {kind: scan_bound(kind, CUBE_BATCH, L, dg, itemsize)[0]
                     for kind in worst}
            log("cc_kernel_shapes", L=L, dg=dg, batch=CUBE_BATCH, dtype=tag,
                fwd_states_ms=f"{fwd_ms:.4f}", bwd_ms=f"{bwd_ms:.4f}",
                plain_fwd_states_ms=f"{plain_fwd:.2f}",
                plain_bwd_ms=f"{plain_bwd:.2f}",
                bound_fwd_states_ms=f"{bound['fwd_states']:.4f}",
                bound_bwd_ms=f"{bound['bwd']:.4f}",
                max_abs_err_fwd_states=f"{errs['fwd_states']:.2e}",
                max_abs_err_bwd=f"{errs['bwd']:.2e}")
            del args, gy
            torch.cuda.empty_cache()
    return worst


def cta_loader(torch, dev, batch, labeled, seed=1337, patch=None):
    """(val volumes, a Loader of two-stream batches of CTATransform views
    of the phantom slices at ``patch``² (default PATCH), the CTAugment,
    the transform)."""
    from mamba_unet_torch.data.acdc import SliceDataset
    from mamba_unet_torch.data.cta_transform import CTATransform
    from mamba_unet_torch.data.ctaugment import CTAugment
    from mamba_unet_torch.data.loader import Loader
    from mamba_unet_torch.data.sampler import TwoStreamBatchSampler
    from mamba_unet_torch.data.synthetic import phantom_acdc

    splits = phantom_acdc(8, 8, 2, 0, *NATIVE, seed=0)
    cta = CTAugment(seed=seed)
    patch = patch or PATCH
    tf = CTATransform((patch, patch), cta, seed=seed)
    ds = SliceDataset.from_samples(splits["train"], transform=tf)
    n_lab = len(ds) // 4
    sampler = TwoStreamBatchSampler(range(n_lab), range(n_lab, len(ds)),
                                    batch, batch - labeled, seed=seed)
    return splits["val"], Loader(ds, sampler, device=dev), cta, tf


def draw_patch_bias(torch, patch_embed, seed):
    """The patch embedding's conv bias drawn from N(0, PATCH_BIAS_STD²)
    with ``seed``, in place; returns the module."""
    with torch.no_grad():
        patch_embed.proj.bias.copy_(PATCH_BIAS_STD * torch.randn(
            patch_embed.proj.bias.shape,
            generator=torch.Generator().manual_seed(seed)))
    return patch_embed


def vim_pair(torch, drop_path, seeds=(1337, 1338)):
    """Two full-width ``ViM_seg`` from seeded generators, their patch
    embeddings' biases drawn (:data:`PATCH_BIAS_STD`)."""
    from mamba_unet_torch.models.vssm import MambaUnet

    pair = [MambaUnet(num_classes=4, drop_path_rate=drop_path,
                      generator=torch.Generator().manual_seed(s))
            for s in seeds]
    for model, s in zip(pair, seeds):
        draw_patch_bias(torch, model.mamba_unet.patch_embed, s + 100)
    return pair


def mask_model(torch, drop_path, seed=1337, patch=None):
    """Full-width ``MambaUnetMask`` for ``patch``² (default PATCH) and 32²
    cubes, seeded, its patch embedding's bias drawn
    (:data:`PATCH_BIAS_STD`)."""
    from mamba_unet_torch.models.mamba_mask import MambaUnetMask

    model = MambaUnetMask(num_classes=4, img_size=patch or PATCH,
                          cube_size=CUBE_SIZE,
                          drop_path_rate=drop_path,
                          generator=torch.Generator().manual_seed(seed))
    draw_patch_bias(torch, model.encoder.patch_embed, seed + 100)
    return model


def report_fit(phase, trainer, loader, result, ms, peak, evals, predicted,
               **extra):
    """Profile 3 steps and print the step numbers of a phase's fit: device
    ms per step, the median step in ``fit`` (steps without an eval), the
    busy share, peak GB, beside the prediction; returns (median ms, device
    ms)."""
    import torch

    losses = [h["loss"] for h in result["history"] if "loss" in h]
    med, kept = median_after_warmup(ms, set(evals))
    device = profile_steps(torch, trainer, loader, f"train_{phase}")
    log(phase, losses=" ".join(f"{v:.4f}" for v in losses))
    log(phase, step_ms_median=f"{med:.2f}", step_ms_min=f"{kept[0]:.2f}",
        step_ms_max=f"{kept[-1]:.2f}", device_ms_per_step=f"{device:.2f}",
        busy_share=f"{device / med:.3f}", peak_mem_gb=f"{peak:.2f}",
        predicted_device_ms=predicted[0], predicted_peak_gb=predicted[1],
        **extra)
    return med, device


def contrastive_consistency_phase(torch, dev):
    """``[contrastive_consistency]``: ``ContrastiveConsistencyTrainer.fit``
    of two full-width ``ViM_seg`` on the CTA-fed two-stream phantom
    Loader, bs24 with 8 labeled @ 224², bf16, drop_path 0.2, CC_ITERS
    steps with one eval of both models (and a periodic checkpoint) after
    step CC_EVAL_AT: per step 56 state-saving forward and 56 backward
    bidir launches and no serving one, 14 serving launches per eval
    forward of each model; ``best``/``best2`` hold the protocol; the
    policy is refreshed (an epoch is 2 steps) and ``cta_state.json``
    holds rates that moved from their start; the host ms of the transform
    per batch; step numbers as :func:`report_fit`. Returns (launches of
    the bidir serving, state-saving and backward kernels, ...)."""
    import json
    import tempfile

    from mamba_unet_torch.train import (
        ContrastiveConsistencyTrainer,
        TrainConfig,
    )

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as snap:
        cfg = TrainConfig(base_lr=0.01, max_iterations=1000,
                          batch_size=TRAIN_BATCH, patch_size=(PATCH, PATCH),
                          num_classes=4, eval_every=CC_EVAL_AT,
                          ckpt_every=CC_EVAL_AT, log_every=1, seed=1337,
                          bf16=True, snapshot_dir=snap)
        m1, m2 = vim_pair(torch, 0.2)
        trainer = ContrastiveConsistencyTrainer(
            m1, cfg, model2=m2, labeled_bs=SEMI_LABELED, device=dev)
        val, loader, cta, tf = cta_loader(torch, dev, TRAIN_BATCH,
                                          SEMI_LABELED)
        t0 = time.perf_counter()
        for i in range(TRAIN_BATCH):
            loader.dataset[i]
        cta_ms = 1e3 * (time.perf_counter() - t0)
        first_policy = tf.ops_weak
        before = [{k: v.detach().clone() for k, v in m.state_dict().items()}
                  for m in (trainer.model, trainer.model2)]
        result, steps, ms, peak = counted_fit(
            torch, trainer, loader, val, CC_ITERS, "contrastive_consistency",
            cta=cta, cta_transform=tf)
        eval_fwd = math.ceil(sum(len(v["image"]) for v in val)
                             / cfg.eval_batch_size)
        n = SS2D_PER_FORWARD
        evals = range(CC_EVAL_AT, CC_ITERS + 1, CC_EVAL_AT)
        check_step_launches("contrastive_consistency", steps,
                            [0, 4 * n, 4 * n] + [0] * 6, evals,
                            [2 * n * eval_fwd] + [0] * 8)
        launches = [sum(s[i] for s in steps) for i in range(3)]
        saved = sorted(p.name for p in Path(snap).iterdir())
        dice = [(h["val_dice"], h["val_dice2"]) for h in result["history"]
                if "val_dice" in h]
        check_best_marks("contrastive_consistency", snap, {
            "best": [(i, d[0]) for i, d in zip(evals, dice)],
            "best2": [(i, d[1]) for i, d in zip(evals, dice)]})
        state = json.loads(Path(snap, "cta_state.json").read_text())
        moved_rates = sum(any(v != 1.0 for v in rate)
                          for bins in state["rates"].values()
                          for rate in bins)
    moved = [sum(not torch.equal(v, m.state_dict()[k]) for k, v in b.items())
             for b, m in zip(before, (trainer.model, trainer.model2))]
    log("contrastive_consistency", iterations=result["iterations"],
        batch=TRAIN_BATCH, labeled=SEMI_LABELED, dtype="bf16",
        launches_serve_fwd_states_bwd=tuple(launches),
        params_moved=f"{moved[0]}/{len(before[0])} {moved[1]}/"
                     f"{len(before[1])}",
        val_dice_dice2=" ".join(f"{a:.4f},{b:.4f}" for a, b in dice),
        saved=" ".join(saved),
        policy_refreshed=tf.ops_weak is not first_policy,
        cta_state_bins_moved=moved_rates,
        cta_transform_host_ms_per_batch=f"{cta_ms:.1f}")
    if tf.ops_weak is first_policy or not moved_rates:
        raise AssertionError("the CTAugment policy was not refreshed, or "
                             "cta_state.json holds the initial rates")
    if min(moved[0] / len(before[0]), moved[1] / len(before[1])) < 0.99:
        raise AssertionError(f"weights moved {moved}")
    med, device = report_fit("contrastive_consistency", trainer, loader,
                             result, ms, peak, evals,
                             (CC_PREDICTED_DEVICE_MS, CC_PREDICTED_PEAK_GB),
                             cta_transform_host_ms_per_batch=f"{cta_ms:.1f}")
    del trainer, loader
    return launches, med, device, peak


def mask_pretrain_phase(torch, dev):
    """``[mask_pretrain]``: ``MaskPretrainTrainer.fit`` of full-width
    ``MambaUnetMask`` (224², 32² cubes) on phantom slices, bs24, bf16,
    drop_path 0.2, MASK_ITERS steps with one eval after MASK_EVAL_AT: per
    step 50 state-saving forward and 50 backward bidir launches (3 heads
    x 14 + the location pass's encoder, 8, at batch 24 x 49 cubes), 14
    serving launches per eval forward; finite losses; step numbers as
    :func:`report_fit`. Returns (launches, ...)."""
    from mamba_unet_torch.train import MaskPretrainTrainer, TrainConfig

    cfg = TrainConfig(base_lr=0.01, max_iterations=1000,
                      batch_size=TRAIN_BATCH, patch_size=(PATCH, PATCH),
                      num_classes=4, eval_every=MASK_EVAL_AT, log_every=1,
                      seed=1337, bf16=True)
    trainer = MaskPretrainTrainer(mask_model(torch, 0.2), cfg,
                                  cube_size=CUBE_SIZE, device=dev)
    val, loader = phantom_loader(torch, dev, TRAIN_BATCH)
    result, steps, ms, peak = counted_fit(torch, trainer, loader, val,
                                          MASK_ITERS, "mask_pretrain")
    eval_fwd = math.ceil(sum(len(v["image"]) for v in val)
                         / cfg.eval_batch_size)
    n = SS2D_PER_FORWARD
    evals = range(MASK_EVAL_AT, MASK_ITERS + 1, MASK_EVAL_AT)
    check_step_launches("mask_pretrain", steps,
                        [0, MASK_PER_STEP, MASK_PER_STEP] + [0] * 6, evals,
                        [n * eval_fwd] + [0] * 8)
    launches = [sum(s[i] for s in steps) for i in range(3)]
    log("mask_pretrain", iterations=result["iterations"], batch=TRAIN_BATCH,
        cubes_per_step=CUBE_BATCH, dtype="bf16",
        launches_serve_fwd_states_bwd=tuple(launches))
    med, device = report_fit("mask_pretrain", trainer, loader, result, ms,
                             peak, evals, (MASK_PREDICTED_DEVICE_MS,
                                           MASK_PREDICTED_PEAK_GB))
    del trainer, loader
    return launches, med, device, peak


def cc_mask_phase(torch, dev):
    """``[cc_mask]``: the contrastive trainer's mask variant on a
    full-width ``MambaUnetMask`` pair at 224², bf16, CC_MASK_ITERS steps
    of two-stream CTA batches, no eval: per step 98 state-saving forward
    and 98 backward bidir launches (4 model passes and model 1's 3 mix
    heads); peak GB and a profile's device ms per step. An out-of-memory
    error at bs24 fails the phase. Returns (launches, ...)."""
    from mamba_unet_torch.train import (
        ContrastiveConsistencyTrainer,
        TrainConfig,
    )

    batch = TRAIN_BATCH
    cfg = TrainConfig(base_lr=0.01, max_iterations=1000, batch_size=batch,
                      patch_size=(PATCH, PATCH), num_classes=4,
                      eval_every=10**6, log_every=1, seed=1337, bf16=True)
    trainer = ContrastiveConsistencyTrainer(
        mask_model(torch, 0.2, 1337), cfg,
        model2=mask_model(torch, 0.2, 1338), labeled_bs=batch // 3,
        mask_recovery=True, mask_cube_size=CUBE_SIZE, device=dev)
    val, loader, cta, tf = cta_loader(torch, dev, batch, batch // 3)
    result, steps, ms, peak = counted_fit(
        torch, trainer, loader, val, CC_MASK_ITERS, "cc_mask", cta=cta,
        cta_transform=tf)
    per_step = 7 * SS2D_PER_FORWARD
    check_step_launches("cc_mask", steps, [0, per_step, per_step] + [0] * 6)
    launches = [sum(s[i] for s in steps) for i in range(3)]
    log("cc_mask", iterations=result["iterations"], batch=batch,
        dtype="bf16",
        launches_serve_fwd_states_bwd=tuple(launches))
    med, device = report_fit("cc_mask", trainer, loader, result, ms, peak,
                             (), (CC_MASK_PREDICTED_DEVICE_MS,
                                  CC_MASK_PREDICTED_PEAK_GB), batch=batch)
    del trainer, loader
    return launches, med, device, peak


def card_vs_cpu_grads(phase, grads, losses, zeros=(), to_model_max=False,
                      tol=MODEL_GRAD_TOL, loss_tol=LOSS_TOL):
    """Raise unless every loss on the card is within ``loss_tol`` of the
    CPU's and every gradient within ``tol`` of its own max abs (with
    ``to_model_max``, of its model's largest gradient: the gradient name's
    part before the first dot names the model); the gradients in
    ``zeros``, exact zeros computed as rounding noise, below ZERO_GRAD_REL
    of their model's largest gradient on both sides. Prints the worst."""
    from mamba_unet_torch.utils.compare import ZERO_GRAD_REL

    model_max = {}
    for k, g in grads["cpu"].items():
        m = k.split(".")[0]
        model_max[m] = max(model_max.get(m, 0.0), g.abs().max().item())
    worst, worst_key, own = 0.0, None, (0.0, None)
    for k, want in grads["cpu"].items():
        top = model_max[k.split(".")[0]]
        if k in zeros:
            got = max(want.abs().max().item(),
                      grads["gpu"][k].abs().max().item())
            if got > ZERO_GRAD_REL * top:
                raise AssertionError(f"[{phase}] {k}: the gradient of a bias "
                                     f"that feeds a BatchNorm is {got}")
            continue
        err = (grads["gpu"][k] - want).abs().max().item()
        own_rel = err / max(want.abs().max().item(), 1e-30)
        rel = err / max(top, 1e-30) if to_model_max else own_rel
        if own_rel > own[0]:
            own = (own_rel, k)
        if not math.isfinite(rel) or rel > worst:
            worst, worst_key = rel, k
    loss_err = max(abs(losses["gpu"][k] - v) / max(abs(v), 1e-30)
                   for k, v in losses["cpu"].items())
    log(phase, params=len(grads["cpu"]), zero_grads=len(zeros),
        losses_gpu=" ".join(f"{k}={v:.6f}" for k, v in losses["gpu"].items()),
        loss_rel_err=f"{loss_err:.2e}", loss_tol=loss_tol,
        worst_grad_rel_err=f"{worst:.2e}", worst_param=worst_key,
        relative_to="model_max_grad" if to_model_max else "own_max",
        worst_own_rel_err=f"{own[0]:.2e}", worst_own_param=own[1], tol=tol)
    if not (worst <= tol and loss_err <= loss_tol):
        raise AssertionError(f"[{phase}] the card disagrees with the CPU: "
                             f"worst gradient {worst} at {worst_key}, loss "
                             f"rel err {loss_err}")


def cc_parity_phase(torch, dev):
    """``[cc_parity]``: one contrastive step of two full-width ``ViM_seg``
    with their projectors, batch CC_PARITY_BATCH (1 labeled) at
    CC_PARITY_PATCH² on phantom CTA views, fp32 (TF32 off by the caller), drop-path 0: the
    five losses and every gradient (both models, projectors 3 and 4) on
    the card against a CPU copy, at ``[cross_teaching_parity]``'s
    tolerance (the projectors' conv biases that feed a BatchNorm, exact
    zeros, below ZERO_GRAD_REL of their projector's largest gradient);
    56 + 56 bidir training launches. Then one
    ``MaskPretrainTrainer`` step of full-width ``MambaUnetMask`` the same
    way (:func:`mask_step_parity`), at batch MASK_PARITY_BATCH on
    MASK_PARITY_PATCH² images, from weights whose position
    embedding is not 0 (its BatchNorm bias at 1: at init the clean pass
    multiplies the image by 0 and its LayerNorms' zero variances scale the
    gradients by 1/sqrt(eps) each, so the card and the CPU would compare
    rounding): losses, and gradients within MODEL_GRAD_TOL of the
    model's largest (the mix head's tiny decoder gradients, ~1e-7, carry
    the rounding of the large ones, and the Dense biases that feed its
    BatchNorms are exact zeros); 50 + 50 launches."""
    from mamba_unet_torch.models.small_nets import Projectors
    from mamba_unet_torch.train import (
        ContrastiveConsistencyTrainer,
        TrainConfig,
    )
    from mamba_unet_torch.utils.compare import batchnorm_fed_biases

    _, loader, _, _ = cta_loader(torch, "cpu", CC_PARITY_BATCH, 1,
                                 patch=CC_PARITY_PATCH)
    batch = next(iter(loader))
    kernels = all_scan_kernels()
    n = SS2D_PER_FORWARD
    grads, losses, secs = {}, {}, {}
    for tag, d in (("gpu", dev), ("cpu", "cpu")):
        cfg = TrainConfig(base_lr=0.01, max_iterations=1000,
                          batch_size=CC_PARITY_BATCH,
                          patch_size=(CC_PARITY_PATCH, CC_PARITY_PATCH),
                          num_classes=4, seed=1337)
        m1, m2 = vim_pair(torch, 0.0, (0, 1))
        trainer = ContrastiveConsistencyTrainer(m1, cfg, model2=m2,
                                                labeled_bs=1, device=d)
        before = launch_counts(kernels)
        t0 = time.perf_counter()
        logs = trainer.train_step(batch)
        secs[tag] = time.perf_counter() - t0
        losses[tag] = {k: float(v) for k, v in logs.items()
                       if k.startswith("loss")}
        grads[tag] = {f"{name}.{k}": p.grad.cpu() for name, m in (
            ("m1", trainer.model), ("m2", trainer.model2),
            ("p3", trainer.p3), ("p4", trainer.p4))
            for k, p in m.named_parameters()}
        if tag == "gpu":
            launched = [a - b for a, b in zip(launch_counts(kernels),
                                              before)]
            if launched != [0, 4 * n, 4 * n] + [0] * 6:
                raise AssertionError(f"one contrastive step launched "
                                     f"{launched}")
        del trainer, m1, m2
    log("cc_parity", step="contrastive_consistency", batch=CC_PARITY_BATCH,
        gpu_s=f"{secs['gpu']:.2f}", cpu_s=f"{secs['cpu']:.2f}")
    zeros = {f"{p}.{k}" for p in ("p3", "p4")
             for k in batchnorm_fed_biases(Projectors(4, 8))}
    card_vs_cpu_grads("cc_parity", grads, losses, zeros)

    mask_step_parity(torch, dev)


def mask_step_parity(torch, dev):
    """The second half of ``[cc_parity]``: one ``MaskPretrainTrainer`` step
    card vs CPU (see :func:`cc_parity_phase`)."""
    from mamba_unet_torch.train import MaskPretrainTrainer, TrainConfig

    kernels = all_scan_kernels()
    secs = {}
    size = MASK_PARITY_PATCH
    gen = torch.Generator().manual_seed(5)
    image = torch.rand(MASK_PARITY_BATCH, size, size, 1, generator=gen)
    cubes = (size // CUBE_SIZE) ** 2
    # the same shuffle ids and visibility mask on both sides (the card's
    # generator draws another stream)
    draws = (torch.rand(MASK_PARITY_BATCH, cubes, generator=gen).argsort(1),
             (torch.rand(MASK_PARITY_BATCH, cubes, generator=gen)
              > 0.25).float())
    grads, losses = {}, {}
    for tag, d in (("gpu", dev), ("cpu", "cpu")):
        cfg = TrainConfig(base_lr=0.01, max_iterations=1000,
                          batch_size=MASK_PARITY_BATCH,
                          patch_size=(size, size), num_classes=4, seed=1337)
        model = mask_model(torch, 0.0, patch=size)
        with torch.no_grad():
            model.pos_embed_layer.bn.bias.fill_(1.0)
        trainer = MaskPretrainTrainer(model, cfg, cube_size=CUBE_SIZE,
                                      device=d)
        trainer._draws = lambda x: tuple(t.to(x.device) for t in draws)
        before = launch_counts(kernels)
        t0 = time.perf_counter()
        logs = trainer.train_step({"image": image})
        secs[tag] = time.perf_counter() - t0
        losses[tag] = {k: float(v) for k, v in logs.items()
                       if k.startswith("loss")}
        grads[tag] = {f"mask.{k}": p.grad.cpu()
                      for k, p in trainer.model.named_parameters()}
        if tag == "gpu":
            launched = [a - b for a, b in zip(launch_counts(kernels),
                                              before)]
            if launched != [0, MASK_PER_STEP, MASK_PER_STEP] + [0] * 6:
                raise AssertionError(f"one mask-pretraining step launched "
                                     f"{launched}")
        del trainer, model
    log("cc_parity", step="mask_pretrain", batch=MASK_PARITY_BATCH,
        patch=size, gpu_s=f"{secs['gpu']:.2f}", cpu_s=f"{secs['cpu']:.2f}")
    card_vs_cpu_grads("cc_parity", grads, losses, to_model_max=True)


def cc_entry_points_phase(torch, np, dev):
    """``[entry_points]``, third part: ``cli.train --synthetic --method
    contrastive_consistency --model ViM_seg`` (both models warm-started by
    ``--pretrained_ckpt`` from a seeded checkpoint with a drawn patch-
    embedding bias, :data:`PATCH_BIAS_STD`; evaluated after each of its 2
    steps, so that both have a best checkpoint) and ``--method
    mask_pretrain --model MambaUnetMask`` (from the init: its losses may
    go NaN from step 2, :data:`PATCH_BIAS_STD`; launches and serving do
    not depend on it), their launches checked; then
    ``cli.test`` serves ``best`` and ``best2`` of the first and the newest
    checkpoint of the second (``--model MambaUnetMask``)."""
    import tempfile

    from mamba_unet_torch.cli import test as test_cli
    from mamba_unet_torch.cli import train as train_cli
    from mamba_unet_torch.data.synthetic import phantom_acdc

    spec = [str(v) for v in ENTRY_SPEC]
    kernels = all_scan_kernels()
    n, iters = SS2D_PER_FORWARD, 2
    runs = (("contrastive_consistency",
             ["--method", "contrastive_consistency", "--model", "ViM_seg",
              "--eval_every", "1", "--pretrained_ckpt", "WARM"],
             [iters * 2 * n, iters * 4 * n, iters * 4 * n]),
            ("mask_pretrain",
             ["--method", "mask_pretrain", "--model", "MambaUnetMask",
              "--eval_every", str(iters)],
             [n, iters * MASK_PER_STEP, iters * MASK_PER_STEP]))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        # a seeded whole-network checkpoint with a drawn patch-embedding
        # bias, which --pretrained_ckpt loads into both models of the pair
        warm = vim_pair(torch, 0.2, (7,))[0].mamba_unet.state_dict()
        torch.save({f"mamba_unet.{k}": v for k, v in warm.items()},
                   f"{tmp}/warm.pth")
        for tag, extra, want in runs:
            extra = [f"{tmp}/warm.pth" if a == "WARM" else a for a in extra]
            before = launch_counts(kernels)
            t0 = time.perf_counter()
            train_cli.main([
                "--synthetic", "--synthetic_spec", *spec, "--bf16",
                "--patch_size", str(PATCH), str(PATCH), "--batch_size",
                str(ENTRY_BATCH), "--labeled_bs", str(ENTRY_BATCH // 2),
                "--max_iterations", str(iters), "--ckpt_every", str(iters),
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
        for model, snap, ckpt in (
                ("ViM_seg", "contrastive_consistency", "best"),
                ("ViM_seg", "contrastive_consistency", "best2"),
                ("MambaUnetMask", "mask_pretrain", None)):
            before = launch_counts(kernels)
            t0 = time.perf_counter()
            out = test_cli.run_inference(test_cli.build_parser().parse_args([
                "--model", model, "--patch_size", str(PATCH), str(PATCH),
                "--checkpoint", f"{tmp}/{snap}", "--device", "cuda",
                *(["--ckpt_name", ckpt] if ckpt else [])]), dataset=cases)
            launched = [a - b for a, b in zip(launch_counts(kernels),
                                              before)]
            log("entry_points", cli="test", model=model,
                ckpt_name=ckpt or "newest",
                seconds=f"{time.perf_counter() - t0:.1f}", volumes=len(cases),
                mean_dice=f"{out['mean'][0]:.4f}",
                scan_launches=sum(launched))
            if (launched != [n * forwards] + [0] * 8
                    or not np.isfinite(out["per_case"]).all()):
                raise AssertionError(f"cli.test --model {model}: launches "
                                     f"{launched}, metrics {out['mean']}")


# --- MagicNet -----------------------------------------------------------------

def magicnet_phase(torch, dev, recovery):
    """``[magicnet_mamba]`` / ``[magicnet_mask]``: ``MagicNetTrainer.fit``
    of full-width ``MambaUnetMask`` (its patch embedding's bias drawn) on
    two-stream phantom batches, bs24 with 8 labeled @ 224², bf16, without
    and with ``--mask_recovery``, MAGIC_ITERS steps: the launches of each
    step (MAGIC_PER_STEP, MAGIC_MASK_PER_STEP), finite and falling losses,
    the class distribution refreshed at step 20 (the histogram of 20 steps'
    pseudo-labels, every unlabeled pixel counted), the EMA moved; step
    numbers as :func:`report_fit`. An out-of-memory error at bs24 fails
    the phase. Returns (launches, ...)."""
    from mamba_unet_torch.train import MagicNetTrainer, TrainConfig

    phase = "magicnet_mask" if recovery else "magicnet_mamba"
    batch, labeled = TRAIN_BATCH, TRAIN_BATCH // 3
    cfg = TrainConfig(base_lr=0.01, max_iterations=1000, batch_size=batch,
                      patch_size=(PATCH, PATCH), num_classes=4,
                      eval_every=10**6, log_every=1, seed=1337, bf16=True)
    trainer = MagicNetTrainer(mask_model(torch, 0.2), cfg, labeled_bs=labeled,
                              cube_size=CUBE_SIZE, mask_recovery=recovery,
                              device=dev)
    val, loader = phantom_loader(torch, dev, batch, labeled=labeled)
    ema0 = {k: v.clone() for k, v in trainer.ema.items()}
    result, steps, ms, peak = counted_fit(torch, trainer, loader, val,
                                          MAGIC_ITERS, phase)
    per_step = MAGIC_MASK_PER_STEP if recovery else MAGIC_PER_STEP
    check_step_launches(phase, steps, list(per_step) + [0] * 6)
    launches = [sum(s[i] for s in steps) for i in range(3)]
    dist = trainer.dist_logger.get_class_dist()
    want = 20 * (batch - labeled) * PATCH * PATCH
    ema_moved = sum(not torch.equal(v, trainer.ema[k])
                    for k, v in ema0.items())
    losses = [h["loss"] for h in result["history"] if "loss" in h]
    log(phase, iterations=result["iterations"], batch=batch,
        labeled=labeled, dtype="bf16",
        launches_serve_fwd_states_bwd=tuple(launches),
        class_dist=" ".join(f"{v:.0f}" for v in dist),
        class_dist_pixels=f"{dist.sum():.0f}", expected_pixels=want,
        ema_moved=f"{ema_moved}/{len(ema0)}")
    if dist.sum() != want:
        raise AssertionError(f"[{phase}] the class distribution after "
                             f"step 20 counts {dist.sum()} pixels, expected "
                             f"{want}")
    # the blend weights of that histogram (millions of pixels per class):
    # finite, in [0, 1], max 1
    blend = trainer._blend_weight(dist, torch.arange(4, device=dev))[..., 0]
    log(phase, blend_weight=" ".join(f"{v:.6g}" for v in blend.tolist()))
    if not (bool(torch.isfinite(blend).all()) and float(blend.min()) >= 0
            and float(blend.max()) == 1.0):
        raise AssertionError(f"[{phase}] blend weights {blend.tolist()} of "
                             f"the class distribution {dist}")
    if not sum(losses[-3:]) < sum(losses[:3]) or ema_moved < len(ema0) // 2:
        raise AssertionError(f"[{phase}] losses {losses}, EMA moved "
                             f"{ema_moved}/{len(ema0)}")
    predicted = ((MAGIC_MASK_PREDICTED_DEVICE_MS, MAGIC_MASK_PREDICTED_PEAK_GB)
                 if recovery else (MAGIC_PREDICTED_DEVICE_MS,
                                   MAGIC_PREDICTED_PEAK_GB))
    med, device = report_fit(phase, trainer, loader, result, ms, peak, (),
                             predicted, batch=batch)
    del trainer, loader
    return launches, med, device, peak


def btcv_loaders(torch, dev, seed=1337):
    """(train Loader of two-stream MAGIC3D_BATCH batches of 96³ random
    crops of MAGIC3D_TRAIN_VOLUMES phantoms, the MAGIC3D_VAL³ validation
    phantom as a dataset)."""
    from mamba_unet_torch.data.btcv import (
        Compose3D,
        RandomCrop3D,
        VolumeTrainDataset,
    )
    from mamba_unet_torch.data.loader import Loader
    from mamba_unet_torch.data.sampler import TwoStreamBatchSampler
    from mamba_unet_torch.data.synthetic import phantom_btcv

    train = phantom_btcv(MAGIC3D_TRAIN_VOLUMES, 0, MAGIC3D_PATCH,
                         MAGIC3D_CLASSES)["train"]
    val = phantom_btcv(0, 1, MAGIC3D_VAL, MAGIC3D_CLASSES, seed=1)["val"]
    ds = VolumeTrainDataset.from_samples(train, transform=Compose3D(
        [RandomCrop3D((MAGIC3D_PATCH,) * 3, seed=seed)]))
    n_lab = max(2, len(ds) // 3)
    sampler = TwoStreamBatchSampler(
        range(n_lab), range(n_lab, len(ds)), MAGIC3D_BATCH,
        MAGIC3D_BATCH - MAGIC3D_LABELED, seed=seed)
    return (Loader(ds, sampler, device=dev),
            VolumeTrainDataset.from_samples(val))


def magicnet_3d_phase(torch, dev):
    """``[magicnet_3d]``: ``MagicNetTrainer.fit`` of ``magicnet`` at the
    reference's BTCV protocol (MAGIC3D_*) on phantom volumes, fp32 with
    PyTorch's TF32 defaults, MAGIC3D_ITERS steps: no scan launch, finite
    losses, weights moved; step ms, a profile's device ms per step, peak
    GB; then one sliding-window ``validation_all_case`` of the
    MAGIC3D_VAL³ case (8 windows at stride 16), its seconds and its (1,
    13, 4) array.
    Returns (median step ms, device ms, peak GB, validation s)."""
    import numpy as np

    from mamba_unet_torch.models import net_factory
    from mamba_unet_torch.train import MagicNetTrainer, TrainConfig

    cfg = TrainConfig(base_lr=0.01, max_iterations=1000,
                      batch_size=MAGIC3D_BATCH,
                      patch_size=(MAGIC3D_PATCH,) * 3,
                      num_classes=MAGIC3D_CLASSES, eval_every=10**6,
                      log_every=1, seed=1337)
    model = net_factory("magicnet", num_classes=MAGIC3D_CLASSES,
                        cube_size=MAGIC3D_CUBE, patch_size=MAGIC3D_PATCH,
                        generator=torch.Generator().manual_seed(1337))
    trainer = MagicNetTrainer(model, cfg, labeled_bs=MAGIC3D_LABELED,
                              cube_size=MAGIC3D_CUBE, device=dev)
    t0 = time.perf_counter()
    loader, val = btcv_loaders(torch, dev)
    data_s = time.perf_counter() - t0
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    result, steps, ms, peak = counted_fit(torch, trainer, loader, None,
                                          MAGIC3D_ITERS, "magicnet_3d")
    check_step_launches("magicnet_3d", steps, [0] * 9)
    after = trainer.model.state_dict()
    moved = sum(not torch.equal(v, after[k]) for k, v in before.items())
    log("magicnet_3d", iterations=result["iterations"],
        batch=MAGIC3D_BATCH, labeled=MAGIC3D_LABELED,
        patch=MAGIC3D_PATCH, cube=MAGIC3D_CUBE, classes=MAGIC3D_CLASSES,
        dtype="fp32", params_moved=f"{moved}/{len(before)}",
        phantom_seconds=f"{data_s:.1f}", scan_launches=0)
    if moved < 0.9 * len(before):
        raise AssertionError(f"[magicnet_3d] {moved}/{len(before)} tensors "
                             f"moved")
    med, device = report_fit("magicnet_3d", trainer, loader, result, ms,
                             peak, (), (MAGIC3D_PREDICTED_DEVICE_MS,
                                        MAGIC3D_PREDICTED_PEAK_GB))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arr = trainer.validate_3d(val)
    val_s = time.perf_counter() - t0
    windows = (math.ceil((MAGIC3D_VAL - MAGIC3D_PATCH)
                         / max(MAGIC3D_CUBE // 2, 16)) + 1) ** 3
    log("magicnet_3d", validation_all_case_s=f"{val_s:.2f}", windows=windows,
        metric_shape=tuple(arr.shape),
        mean_dice=f"{arr[:, :, 0].mean():.4f}")
    if arr.shape != (1, MAGIC3D_CLASSES - 1, 4) or not np.isfinite(
            arr).all():
        raise AssertionError(f"[magicnet_3d] metric array {arr.shape}")
    del trainer, loader
    return med, device, peak, val_s


def magic_parity_case(torch, dev, case):
    """(launches, losses, class histogram, gradients by name) of one
    MagicNet step of ``case`` ("mask_2d" in fp32, "magicnet_3d" in fp64)
    on ``dev``, with draws made on the CPU (:data:`MAGIC_PARITY_2D`,
    :data:`MAGIC_PARITY_3D`)."""
    from mamba_unet_torch.models import net_factory
    from mamba_unet_torch.models.mamba_mask import MambaUnetMask
    from mamba_unet_torch.objectives.cube import (
        cube_shuffle_indices,
        random_permutations,
    )
    from mamba_unet_torch.train import MagicNetTrainer, TrainConfig

    if case == "mask_2d":
        batch, labeled, size = MAGIC_PARITY_2D
        shape, cube, recovery = (batch, size, size, 1), CUBE_SIZE, True
        model = MambaUnetMask(num_classes=4, img_size=size,
                              cube_size=cube, depths=(1, 1, 1, 1),
                              drop_path_rate=0.0,
                              generator=torch.Generator().manual_seed(3))
        draw_patch_bias(torch, model.encoder.patch_embed, 103)
        with torch.no_grad():  # a position embedding that is not 0
            model.pos_embed_layer.bn.bias.fill_(1.0)
    else:
        batch, labeled, size, cube = MAGIC_PARITY_3D
        shape, recovery = (batch, size, size, size, 1), False
        model = net_factory("magicnet", num_classes=4, cube_size=cube,
                            patch_size=size,
                            generator=torch.Generator().manual_seed(3))
    dtype = torch.float32 if case == "mask_2d" else torch.float64
    model.to(dtype)
    g = torch.Generator().manual_seed(4)
    image = torch.rand(shape, generator=g).to(dtype)
    label = torch.randint(0, 4, shape[:-1], generator=g)
    nb = size // cube
    part, rec = cube_shuffle_indices(g, batch, nb, len(shape) - 2)
    draws = {"part": part, "rec": rec,
             "noise": (0.1 * torch.randn(image[labeled:].shape, generator=g)
                       ).clamp(-0.2, 0.2)}
    if recovery:
        draws["perms"] = random_permutations(g, batch, nb * nb)
        draws["vis"] = (torch.rand(batch, nb * nb, generator=g)
                        > 0.25).float()
    cfg = TrainConfig(base_lr=0.01, max_iterations=1000, batch_size=batch,
                      patch_size=shape[1:-1], num_classes=4, seed=1337)
    trainer = MagicNetTrainer(model, cfg, labeled_bs=labeled,
                              cube_size=cube, mask_recovery=recovery,
                              device=dev)
    trainer._draws = lambda x: {k: v.to(x.device) for k, v in draws.items()}
    kernels = all_scan_kernels()
    before = launch_counts(kernels)
    logs = trainer.train_step({"image": image, "label": label})
    launched = [a - b for a, b in zip(launch_counts(kernels), before)]
    return (launched, {k: float(v) for k, v in logs.items()
                       if k.startswith("loss")}, logs["class_hist"].cpu(),
            {f"{case}.{k}": p.grad.cpu()
             for k, p in trainer.model.named_parameters()})


def magicnet_parity_phase(torch, dev):
    """``[magicnet_parity]``: one MagicNet step card vs CPU, the same
    draws: the reduced MambaUnetMask with --mask_recovery in fp32 with TF32
    off (the caller; 7 + 42 + 42 bidir launches), its losses within
    LOSS_TOL (the consistency Dice within MAGIC_CONS_TOL), the class
    histograms within MAGIC_HIST_TOL of the pixels, every gradient within
    MODEL_GRAD_TOL of its model's largest (``[cc_parity]``'s rule); the
    reduced 3-D magicnet in fp64 (no launch), its losses, histogram and
    every gradient against the model's largest within MAGIC3D_FP64_TOL."""
    n = 4 + 3  # depths (1, 1, 1, 1): 4 encoder and 3 decoder blocks
    for case, want in (("mask_2d", [n, 6 * n, 6 * n] + [0] * 6),
                       ("magicnet_3d", [0] * 9)):
        out, secs = {}, {}
        for tag, d in (("gpu", dev), ("cpu", "cpu")):
            t0 = time.perf_counter()
            out[tag] = magic_parity_case(torch, torch.device(d), case)
            secs[tag] = time.perf_counter() - t0
        hist_moved = int((out["gpu"][2] - out["cpu"][2]).abs().sum())
        pixels = int(out["cpu"][2].sum())
        log("magicnet_parity", case=case, launches=tuple(out["gpu"][0][:3]),
            gpu_s=f"{secs['gpu']:.2f}", cpu_s=f"{secs['cpu']:.2f}",
            class_hist=" ".join(str(int(v)) for v in out["gpu"][2]),
            hist_moved=hist_moved, pixels=pixels)
        if out["gpu"][0] != want:
            raise AssertionError(f"[magicnet_parity] {case} launched "
                                 f"{out['gpu'][0]}, expected {want}")
        losses = {t: o[1] for t, o in out.items()}
        grads = {t: o[3] for t, o in out.items()}
        if case == "magicnet_3d":
            if hist_moved:
                raise AssertionError(f"[magicnet_parity] {case}: class "
                                     f"histograms {out['gpu'][2]} and "
                                     f"{out['cpu'][2]}")
            card_vs_cpu_grads("magicnet_parity", grads, losses,
                              to_model_max=True, tol=MAGIC3D_FP64_TOL,
                              loss_tol=MAGIC3D_FP64_TOL)
            continue
        cons = {t: v.pop("loss_cons") for t, v in losses.items()}
        cons_err = abs(cons["gpu"] - cons["cpu"]) / abs(cons["cpu"])
        log("magicnet_parity", case=case, loss_cons_rel_err=f"{cons_err:.2e}",
            cons_tol=MAGIC_CONS_TOL)
        if hist_moved > MAGIC_HIST_TOL * pixels or cons_err > MAGIC_CONS_TOL:
            raise AssertionError(f"[magicnet_parity] {case}: class "
                                 f"histograms {out['gpu'][2]} and "
                                 f"{out['cpu'][2]}, consistency Dice "
                                 f"{cons}")
        card_vs_cpu_grads("magicnet_parity", grads, losses, to_model_max=True)


# --- the Mamba-LM remainders: bf16 scoring, exported generation -------------

def lm_bf16_phase(torch, dev, model):
    """``[lm_bf16]``: mamba-130m (seeded weights, the card's fp32 ``model``)
    with compute dtype bf16 (weights fp32, the grouped kernel on bf16
    inputs with its fp32 state): one scoring forward at LM_BF16_SHAPE
    against fp32 on the card (logits within LM_BF16_REL_TOL of the fp32
    max, greedy-token agreement), both timed with CUDA events and
    profiled, LM_DEPTH launches per forward; then a greedy ``generate`` of
    LM_BF16_NEW_TOKENS tokens after LM_PROMPTS prompts (one prefill:
    LM_DEPTH launches; the decode steps in bf16 too). Returns the
    launches."""
    from mamba_unet_torch.models.mamba_lm import MambaLMHeadModel, generate
    from mamba_unet_torch.ops.selective_scan_grouped import (
        selective_scan_grouped,
    )

    half = MambaLMHeadModel(LM_VOCAB, device=dev, dtype=torch.bfloat16)
    half.load_state_dict(model.state_dict())
    half.eval()
    ids = torch.randint(0, LM_VOCAB, LM_BF16_SHAPE,
                        generator=torch.Generator().manual_seed(6)).to(dev)
    selective_scan_grouped.launches = 0
    with torch.inference_mode():
        got = half(ids)
        launched = selective_scan_grouped.launches
        want = model(ids)
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        times = {}
        for tag, m in (("fp32", model), ("bf16", half)):
            times[tag], _ = cuda_ms(torch, lambda m=m: m(ids), 5)
        device = profile_calls(torch, "lm_bf16_scoring", [lambda: half(ids)],
                               top=6)
    prompts = ids[:LM_PROMPTS, :LM_PROMPT_LEN]
    before = selective_scan_grouped.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = generate(half, prompts, max_new_tokens=LM_BF16_NEW_TOKENS)
    torch.cuda.synchronize()
    gen_ms = 1e3 * (time.perf_counter() - t0)
    gen_launches = selective_scan_grouped.launches - before
    log("lm_bf16", path="generate", prompts=prompts.shape[0],
        new_tokens=LM_BF16_NEW_TOKENS, launches=gen_launches,
        expected=LM_DEPTH, generate_ms=f"{gen_ms:.1f}",
        tokens_shape=tuple(tokens.shape))
    if (gen_launches != LM_DEPTH or tokens.shape != (
            prompts.shape[0], prompts.shape[1] + LM_BF16_NEW_TOKENS)
            or not bool(((tokens >= 0) & (tokens < half.padded_vocab)).all())):
        raise AssertionError(f"[lm_bf16] generate: {gen_launches} launches, "
                             f"tokens {tuple(tokens.shape)}")
    log("lm_bf16", shape=LM_BF16_SHAPE, launches=launched,
        expected=LM_DEPTH, max_abs_diff=f"{err:.3e}",
        logit_max=f"{top:.3f}", tol=f"{LM_BF16_REL_TOL * top:.3e}",
        greedy_agree=f"{agree:.4f}", bf16_ms=f"{times['bf16']:.2f}",
        fp32_ms=f"{times['fp32']:.2f}",
        bf16_device_ms=f"{device:.2f}",
        fp32_device_ms_before=LM_FP32_SCORING_MS)
    if launched != LM_DEPTH or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"[lm_bf16] {launched} launches")
    if err > LM_BF16_REL_TOL * top or agree < 0.9:
        raise AssertionError(f"[lm_bf16] bf16 logits stray from fp32: "
                             f"{err} (max {top}), greedy agreement {agree}")
    del half
    return launched + gen_launches


def lm_export_phase(torch, dev):
    """``[lm_export]``: ``export_lm_generate`` of a mamba-130m-width model
    cut to LM_EXPORT_DEPTH layers (seeded weights, fp32, on the card) for
    LM_EXPORT_BATCH prompts of LM_EXPORT_PROMPT tokens and
    LM_EXPORT_TOKENS greedy new tokens (the export's host seconds); the
    exported program's tokens equal eager ``generate``'s; ms per token of
    each, the prefill's LM_EXPORT_DEPTH grouped launches per call. Returns
    the launches of the timed exported call."""
    from mamba_unet_torch.models.mamba_lm import generate
    from mamba_unet_torch.ops.selective_scan_grouped import (
        selective_scan_grouped,
    )
    from mamba_unet_torch.utils.export import export_lm_generate

    _, model = seeded_lm(torch, dev, LM_EXPORT_DEPTH)
    model.eval()
    prompts = torch.randint(0, LM_VOCAB, (LM_EXPORT_BATCH, LM_EXPORT_PROMPT),
                            generator=torch.Generator().manual_seed(7)
                            ).to(dev)
    seed = torch.tensor(0, device=dev)
    t0 = time.perf_counter()
    exported = export_lm_generate(model, LM_EXPORT_PROMPT, LM_EXPORT_TOKENS,
                                  batch=LM_EXPORT_BATCH)
    export_s = time.perf_counter() - t0
    loaded = exported.module()
    with torch.no_grad():
        loaded(prompts, seed)  # first call
        selective_scan_grouped.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = loaded(prompts, seed)
        torch.cuda.synchronize()
        exp_ms = 1e3 * (time.perf_counter() - t0)
        launched = selective_scan_grouped.launches
    generate(model, prompts, max_new_tokens=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = generate(model, prompts, max_new_tokens=LM_EXPORT_TOKENS)
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0)
    log("lm_export", batch=LM_EXPORT_BATCH, prompt_len=LM_EXPORT_PROMPT,
        new_tokens=LM_EXPORT_TOKENS, export_s=f"{export_s:.1f}",
        depth=LM_EXPORT_DEPTH, launches=launched, expected=LM_EXPORT_DEPTH,
        tokens_equal=bool(torch.equal(got, want)),
        exported_ms_per_token=f"{exp_ms / LM_EXPORT_TOKENS:.2f}",
        eager_ms_per_token=f"{eager_ms / LM_EXPORT_TOKENS:.2f}")
    if launched != LM_EXPORT_DEPTH or not torch.equal(got, want):
        raise AssertionError(f"[lm_export] {launched} launches, tokens "
                             f"equal {torch.equal(got, want)}")
    return launched


def magic_entry_points_phase(torch, np, dev):
    """``[entry_points]``, fourth part: ``cli.train --dataset btcv --method
    magicnet --model magicnet --synthetic`` at the reference's 96³ protocol
    (2 steps, an eval, ``metric_final.npy`` of (1, 13, 4)) and ``--method
    magicnet --model MambaUnetMask --mask_recovery --synthetic`` at
    ENTRY_SPEC (2 steps, evaluated after the second), their launches
    checked, each writing a periodic checkpoint (with the EMA and the
    class distribution)."""
    import tempfile

    from mamba_unet_torch.cli import train as train_cli

    spec = [str(v) for v in ENTRY_SPEC]
    kernels = all_scan_kernels()
    iters = 2
    n = SS2D_PER_FORWARD
    val_slices = ENTRY_SPEC[1] * ENTRY_SPEC[2]
    eval_fwd = math.ceil(val_slices / 16)
    runs = (("btcv", [
        "--dataset", "btcv", "--method", "magicnet", "--model", "magicnet",
        "--synthetic", "--patch_size", *[str(MAGIC3D_PATCH)] * 3,
        "--num_classes", str(MAGIC3D_CLASSES), "--batch_size",
        str(MAGIC3D_BATCH), "--labeled_bs", str(MAGIC3D_LABELED),
        "--cube_size", str(MAGIC3D_CUBE)], [0, 0, 0]),
        ("magicnet_mask", [
            "--method", "magicnet", "--model", "MambaUnetMask",
            "--mask_recovery", "--synthetic", "--synthetic_spec", *spec,
            "--bf16", "--patch_size", str(PATCH), str(PATCH),
            "--batch_size", str(ENTRY_BATCH), "--labeled_bs",
            str(ENTRY_BATCH // 2)],
         [iters * n + n * eval_fwd, iters * 6 * n, iters * 6 * n]))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for tag, extra, want in runs:
            before = launch_counts(kernels)
            t0 = time.perf_counter()
            train_cli.main([*extra, "--max_iterations", str(iters),
                            "--eval_every", str(iters), "--ckpt_every",
                            str(iters), "--snapshot_dir", f"{tmp}/{tag}",
                            "--device", "cuda"])
            launched = [a - b for a, b in zip(launch_counts(kernels),
                                              before)]
            saved = sorted(p.name for p in Path(tmp, tag).iterdir())
            fields = {}
            if tag == "btcv":
                arr = np.load(Path(tmp, tag, "metric_final.npy"))
                fields = dict(metric_final=tuple(arr.shape),
                              mean_dice=f"{arr[:, :, 0].mean():.4f}")
                if arr.shape != (1, MAGIC3D_CLASSES - 1, 4):
                    raise AssertionError(f"metric_final.npy {arr.shape}")
            log("entry_points", cli="train", run=tag,
                seconds=f"{time.perf_counter() - t0:.1f}",
                launches_serve_fwd_states_bwd=tuple(launched[:3]),
                saved=" ".join(saved), **fields)
            if launched != want + [0] * 6:
                raise AssertionError(f"{tag}: launched {launched}, expected "
                                     f"{want}")


@contextlib.contextmanager
def captured_fit(torch, cls, iters, phase):
    """While open, the next ``cls.fit`` (a CLI's trainer) runs through
    :func:`counted_fit` over ``iters`` batches, logging every step; yields
    a dict that then holds the trainer, its loader and val set and
    counted_fit's (result, steps, ms, peak)."""
    out = {}
    had = "fit" in cls.__dict__
    orig = cls.fit

    def fit(self, loader, val=None, **kw):
        if had:
            cls.fit = orig
        else:
            del cls.fit
        self.config.log_every = 1
        result, steps, ms, peak = counted_fit(torch, self, loader, val,
                                              iters, phase, **kw)
        out.update(trainer=self, loader=loader, val=val, result=result,
                   steps=steps, ms=ms, peak=peak)
        return result

    cls.fit = fit
    try:
        yield out
    finally:
        if cls.__dict__.get("fit") is fit:
            if had:
                cls.fit = orig
            else:
                del cls.fit


def cli_fit_phase(torch, phase, trainer_cls, argv, iters):
    """Run ``cli.train`` with ``argv`` for ``iters`` steps (evaluated after
    the last), its fit counted (:func:`captured_fit`); returns the capture
    and the CLI's seconds."""
    from mamba_unet_torch.cli import train as train_cli

    t0 = time.perf_counter()
    with captured_fit(torch, trainer_cls, iters, phase) as cap:
        train_cli.main([*argv, "--synthetic", "--bf16", "--device", "cuda",
                        "--patch_size", str(PATCH), str(PATCH),
                        "--batch_size", str(TRAIN_BATCH), "--max_iterations",
                        str(iters), "--eval_every", str(iters),
                        "--ckpt_every", str(iters)])
    if "steps" not in cap:
        raise AssertionError(f"[{phase}] the CLI ran no {trainer_cls.__name__}"
                             f" fit")
    return cap, time.perf_counter() - t0


def val_forwards(batch=16):
    """Serving forwards of one evaluation of the CLI's default phantom
    split (8 8 2 0 PATCH: 2 val volumes of 8 slices) at ``batch``."""
    return 2 * math.ceil(8 / batch)


def reestimated_bn_dice(torch, trainer, loader, val, batches):
    """The validation Dice (``trainer.evaluate``) of a copy of
    ``trainer.model`` whose BatchNorm running statistics are the plain
    mean of the batch statistics over ``batches`` training batches of
    ``loader`` (train-mode forwards as the step runs them, no grad), in
    place of the momentum-0.99 averages the steps left."""
    import itertools

    model = copy.deepcopy(trainer.model)
    norms = [m for m in model.modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    for m in norms:
        m.reset_running_stats()
    model.train()
    epochs = itertools.chain.from_iterable(itertools.repeat(loader))
    with torch.no_grad():
        for k, batch in enumerate(itertools.islice(epochs, batches), 1):
            for m in norms:
                m.momentum = 1.0 / k  # the running mean of k batches
            with trainer._autocast():
                model(batch["image"].to(trainer.device).float())
    return trainer.evaluate(val, model=model)


def mad_pretrain_phase(torch, snap):
    """``[mad_pretrain]``: ``cli.train --method mad_pretrain --model unet``
    on phantom slices, bs24 @ 224², bf16, MAD_ITERS steps (corrupted
    near-one-hot labels in, the clean label the target) and the
    corrupted-label validation after the last, saved to ``snap``: no scan
    launch, finite falling losses; step ms, device ms per step (profiler),
    peak GB. The eval-mode denoiser predicts background only this early,
    so its validation Dice is 0 and it saves no ``best``: its warm starts
    and the test CLI load the newest periodic checkpoint, as the CLIs do
    without a best. The phase logs, as a witness of the cause (flax's
    BatchNorm momentum 0.99: the running statistics are still 0.99^20 =
    82 % their init), the Dice of a copy whose BatchNorm statistics are
    re-estimated over MAD_BN_BATCHES training batches
    (:func:`reestimated_bn_dice`)."""
    from mamba_unet_torch.train import MADPretrainTrainer

    cap, secs = cli_fit_phase(
        torch, "mad_pretrain", MADPretrainTrainer,
        ["--method", "mad_pretrain", "--model", "unet", "--snapshot_dir",
         str(snap)], MAD_ITERS)
    check_step_launches("mad_pretrain", cap["steps"], [0] * 9)
    losses = [h["loss"] for h in cap["result"]["history"] if "loss" in h]
    dice = [h["val_dice"] for h in cap["result"]["history"]
            if "val_dice" in h]
    saved = sorted(p.name for p in Path(snap).iterdir())
    bn_dice = reestimated_bn_dice(torch, cap["trainer"], cap["loader"],
                                  cap["val"], MAD_BN_BATCHES)
    log("mad_pretrain", model="unet", in_chans=4, iterations=MAD_ITERS,
        batch=TRAIN_BATCH, dtype="bf16", cli_seconds=f"{secs:.1f}",
        val_dice=" ".join(f"{d:.4f}" for d in dice), scan_launches=0,
        saved=" ".join(saved))
    log("mad_pretrain", witness="BatchNorm statistics re-estimated",
        batches=MAD_BN_BATCHES, val_dice_reestimated=f"{bn_dice:.4f}",
        val_dice_running_stats=f"{dice[-1]:.4f}" if dice else None)
    med, device = report_fit("mad_pretrain", cap["trainer"], cap["loader"],
                             cap["result"], cap["ms"], cap["peak"],
                             (MAD_ITERS,), MAD_PRE_PREDICTED)
    if (not sum(losses[-3:]) < sum(losses[:3]) or len(dice) != 1
            or f"state_{MAD_ITERS}" not in saved
            or not math.isfinite(bn_dice)):
        raise AssertionError(f"[mad_pretrain] losses {losses}, val Dice "
                             f"{dice}, saved {saved}, re-estimated "
                             f"{bn_dice}")
    return med, device, cap["peak"]


def mad_finetune_phase(torch, seg_snap, mad_snap, snap):
    """``[mad_finetune]``: ``cli.train --method mad_finetune --model
    ViM_seg --mad_model unet``, the segmenter warm-started from
    ``seg_snap`` (``[trainability]``'s ``ViM_seg``) and both denoisers
    from ``mad_snap`` (``[mad_pretrain]``'s newest best, else its newest
    periodic checkpoint), bs24 @ 224², bf16,
    MAD_ITERS steps and one stacked validation after the last: 14 #2b and
    14 #4 launches per step (the segmenter; the denoisers launch none), 14
    #1 per validation forward of the segmenter; step ms, device ms per step
    (profiler), peak GB. The phase fails unless the trainer's own
    best-Dice path saved the trio as best/best2/best3 after the stacked
    validation (a stacked Dice above 0), for ``[mad_test]`` to serve
    ``best3``. Returns (launches of #1, #2b, #4, ...)."""
    from mamba_unet_torch.train import MADFineTuneTrainer

    n = SS2D_PER_FORWARD
    cap, secs = cli_fit_phase(
        torch, "mad_finetune", MADFineTuneTrainer,
        ["--method", "mad_finetune", "--model", "ViM_seg", "--mad_model",
         "unet", "--seg_ckpt", str(seg_snap), "--mad_ckpt", str(mad_snap),
         "--snapshot_dir", str(snap)], MAD_ITERS)
    check_step_launches("mad_finetune", cap["steps"], [0, n, n] + [0] * 6,
                        (MAD_ITERS,), [n * val_forwards()] + [0] * 8)
    launches = [sum(s[i] for s in cap["steps"]) for i in range(3)]
    losses = [h["loss"] for h in cap["result"]["history"] if "loss" in h]
    dice = [h["val_dice"] for h in cap["result"]["history"]
            if "val_dice" in h]
    saved = sorted(p.name for p in Path(snap).iterdir())
    log("mad_finetune", models="ViM_seg+unet+unet", iterations=MAD_ITERS,
        batch=TRAIN_BATCH, dtype="bf16", cli_seconds=f"{secs:.1f}",
        launches_serve_fwd_states_bwd=tuple(launches),
        per_step=(0, n, n), per_eval_forward=(n, 0, 0),
        eval_forwards=val_forwards(),
        stacked_val_dice=" ".join(f"{d:.4f}" for d in dice),
        saved=" ".join(saved))
    med, device = report_fit("mad_finetune", cap["trainer"], cap["loader"],
                             cap["result"], cap["ms"], cap["peak"],
                             (MAD_ITERS,), MAD_FT_PREDICTED)
    want = {f"{name}_{MAD_ITERS}" for name in ("best", "best2", "best3")}
    if (not all(math.isfinite(v) for v in losses) or len(dice) != 1
            or not dice[0] > 0 or not want <= set(saved)):
        raise AssertionError(f"[mad_finetune] losses {losses}, stacked Dice "
                             f"{dice}, saved {saved}")
    return launches, med, device, cap["peak"]


def mad_test_phase(torch, ft_snap, mad_snap):
    """``[mad_test]``: ``cli.test`` of the fine-tuned ``ViM_seg`` (the
    ``best`` of ``ft_snap``) with a stacked ``unet`` denoiser, once the
    pretraining's (``mad_snap``: its best, else its newest periodic
    checkpoint, the CLI's default) and once the fine-tuned den
    (``--denoiser_ckpt_name best3``), on MAD_TEST_VOLUMES phantom volumes:
    both metric tables finite, 14 #1 launches per segmenter forward and
    none per denoiser forward. Returns the #1 launches."""
    import numpy as np

    from mamba_unet_torch.cli import test as test_cli
    from mamba_unet_torch.data.synthetic import phantom_volumes

    vols = phantom_volumes(MAD_TEST_VOLUMES, 10, *NATIVE, seed=3)
    forwards = sum(math.ceil(len(v["image"]) / test_cli.BATCH_SIZE)
                   for v in vols)
    kernels = all_scan_kernels()
    total = 0
    for tag, den in (("pretrained", ["--denoiser_checkpoint", str(mad_snap)]),
                     ("fine_tuned", ["--denoiser_checkpoint", str(ft_snap),
                                     "--denoiser_ckpt_name", "best3"])):
        args = test_cli.build_parser().parse_args(
            ["--model", "ViM_seg", "--patch_size", str(PATCH), str(PATCH),
             "--checkpoint", str(ft_snap), "--ckpt_name", "best",
             "--denoiser_model", "unet", *den])
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        out = test_cli.run_inference(args, dataset=vols)
        secs = time.perf_counter() - t0
        launched = launch_counts(kernels)
        total += launched[0]
        log("mad_test", denoiser=tag, volumes=len(vols), forwards=forwards,
            seconds=f"{secs:.1f}", launches_serve=launched[0],
            expected=SS2D_PER_FORWARD * forwards,
            mean_dice_hd95_asd=" ".join(f"{v:.4f}" for v in out["mean"]),
            denoised_mean_dice_hd95_asd=" ".join(
                f"{v:.4f}" for v in out["mean_denoised"]))
        if (launched != [SS2D_PER_FORWARD * forwards] + [0] * 8
                or out["per_case_denoised"].shape != (len(vols), 3, 3)
                or not np.isfinite(out["per_case_denoised"]).all()
                or not np.isfinite(out["per_case"]).all()):
            raise AssertionError(f"[mad_test] {tag}: launches {launched}, "
                                 f"tables {out['per_case'].shape}, "
                                 f"{out['per_case_denoised'].shape}")
    return total


def zoo_2d_phase(torch, dev):
    """``[zoo_2d]``: ``cli.train --method fully_supervised`` of ``enet``,
    ``efficient_unet`` and ``preUnet`` (JAX default widths) on phantom
    slices, bs24 @ 224², bf16, ZOO2D_ITERS steps with one eval after the
    last: no scan launch, finite losses; step ms, device ms per step, peak
    GB; then a bs24 forward of ``fc_discriminator`` on (softmax map,
    image) pairs: (24, 2) finite logits, its ms."""
    from mamba_unet_torch.models import net_factory
    from mamba_unet_torch.train import Trainer

    out = {}
    for name in ("enet", "efficient_unet", "preUnet"):
        cap, secs = cli_fit_phase(
            torch, "zoo_2d", Trainer,
            ["--method", "fully_supervised", "--model", name], ZOO2D_ITERS)
        check_step_launches("zoo_2d", cap["steps"], [0] * 9)
        losses = [h["loss"] for h in cap["result"]["history"]
                  if "loss" in h]
        log("zoo_2d", model=name, iterations=ZOO2D_ITERS, batch=TRAIN_BATCH,
            dtype="bf16", cli_seconds=f"{secs:.1f}", scan_launches=0)
        out[name] = report_fit("zoo_2d", cap["trainer"], cap["loader"],
                               cap["result"], cap["ms"], cap["peak"],
                               (ZOO2D_ITERS,), ("not predicted",) * 2,
                               model=name) + (cap["peak"],)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"[zoo_2d] {name}: losses {losses}")
        del cap
        torch.cuda.empty_cache()
    disc = net_factory("fc_discriminator", num_classes=4, device=dev,
                       generator=torch.Generator().manual_seed(5)).eval()
    g = torch.Generator().manual_seed(6)
    seg = torch.softmax(torch.randn(TRAIN_BATCH, PATCH, PATCH, 4,
                                    generator=g), -1).to(dev)
    img = torch.randn(TRAIN_BATCH, PATCH, PATCH, 1, generator=g).to(dev)
    with torch.no_grad():
        ms, logits = cuda_ms(torch, lambda: disc(seg, img), 10)
    log("zoo_2d", model="fc_discriminator", batch=TRAIN_BATCH,
        shape=tuple(logits.shape), forward_ms=f"{ms:.3f}")
    if logits.shape != (TRAIN_BATCH, 2) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"[zoo_2d] fc_discriminator {logits.shape}")
    return out


def zoo3d_models(torch, dev, size, seed=7):
    """The 3-D zoo at the JAX modules' default widths, (name, model,
    input shape), seeded, on ``dev``: a ``size``³ volume (96 or 32), and
    nnU-Net's anisotropic patch (depth pooled 4x, plane 64x). SwinUNETR
    tiles its windows without padding: window 6 at 96³, 4 at 32³ (7 tiles
    only 224k³)."""
    from mamba_unet_torch.models import net_factory

    nn_patch = (24, 192, 192) if size == 96 else (8, 64, 64)
    specs = (("unet_3D", {}, (size,) * 3),
             ("unet_3D_dv_semi", {}, (size,) * 3),
             ("voxresnet", {}, (size,) * 3),
             ("attention_unet", {}, (size,) * 3),
             ("nnUNet", {}, nn_patch),
             ("unetr", dict(img_size=size), (size,) * 3),
             ("SwinUNETR", dict(img_size=size,
                                window_size=6 if size == 96 else 4),
              (size,) * 3))
    for name, kw, shape in specs:
        yield name, net_factory(
            name, num_classes=ZOO3D_CLASSES, device=dev,
            generator=torch.Generator().manual_seed(seed), **kw), shape


def zoo_3d_phase(torch, dev):
    """``[zoo_3d]``: one training step (forward, CE + Dice, backward,
    poly-SGD) of each 3-D zoo model (:func:`zoo3d_models`) at batch 2 on a
    96³ crop (nnU-Net its patch), ZOO3D_CLASSES classes, fp32 with
    PyTorch's TF32 defaults (as ``[magicnet_3d]``): finite losses, no scan
    launch; device ms per step (profiler, 2 steps after the first) and
    peak GB of each."""
    from mamba_unet_torch.nn.layers import set_generator
    from mamba_unet_torch.objectives import supervised_ce_dice
    from mamba_unet_torch.train.optim import poly_sgd

    kernels = all_scan_kernels()
    out = {}
    for name, model, shape in zoo3d_models(torch, dev, 96):
        g = torch.Generator().manual_seed(8)
        x = torch.randn(ZOO3D_BATCH, *shape, 1, generator=g).to(dev)
        y = torch.randint(0, ZOO3D_CLASSES, (ZOO3D_BATCH, *shape),
                          generator=g).to(dev)
        model.train()
        set_generator(model, torch.Generator(dev).manual_seed(0))
        opt, sched = poly_sgd(model.parameters(), 0.01, 1000)
        losses = []

        def step():
            opt.zero_grad(set_to_none=True)
            logits = model(x)
            if isinstance(logits, (tuple, list)):
                logits = logits[0]
            loss = supervised_ce_dice(logits, y)
            loss.backward()
            opt.step()
            sched.step()
            losses.append(loss.detach())

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        step()
        device = profile_calls(torch, f"zoo3d_{name}", [step, step])
        peak = torch.cuda.max_memory_allocated() / 1e9
        launched = launch_counts(kernels)
        losses = [float(v) for v in losses]
        log("zoo_3d", model=name, batch=ZOO3D_BATCH, shape=shape,
            classes=ZOO3D_CLASSES, dtype="fp32",
            params=sum(p.numel() for p in model.parameters()),
            losses=" ".join(f"{v:.4f}" for v in losses),
            device_ms_per_step=f"{device:.2f}", peak_mem_gb=f"{peak:.2f}",
            scan_launches=sum(launched))
        if any(launched) or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"[zoo_3d] {name}: launches {launched}, "
                                 f"losses {losses}")
        out[name] = (device, peak)
        del model, opt, x, y
        torch.cuda.empty_cache()
    return out


def zoo3d_parity_phase(torch, dev):
    """``[zoo3d_parity]``: eval-mode logits of each 3-D zoo model at full
    width on a 32³ volume (nnU-Net an 8 x 64² patch), batch 1, fp32 (TF32
    off by the caller), card against a CPU copy, within LOGIT_TOL of the
    largest logit."""
    from mamba_unet_torch.utils.export import make_predict_fn

    for name, model, shape in zoo3d_models(torch, "cpu", 32):
        x = torch.randn(1, *shape, 1, generator=torch.Generator()
                        .manual_seed(9))
        gpu = copy.deepcopy(model).to(dev)
        with torch.no_grad():
            want = model.eval()(x)
            got = gpu.eval()(x.to(dev))
        want = want[0] if isinstance(want, tuple) else want
        got = (got[0] if isinstance(got, tuple) else got).cpu()
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        log("zoo3d_parity", model=name, shape=tuple(got.shape),
            max_abs_err=f"{err:.3e}", logit_max=f"{top:.3f}",
            tol=f"{LOGIT_TOL} x max(1, logit_max)")
        if not (err <= LOGIT_TOL * max(1.0, top)
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"[zoo3d_parity] {name}: card logits "
                                 f"{err} from the CPU's")
        del gpu, model


def segmamba_kernel_phase(torch, dev):
    """``[segmamba_kernel]``: the grouped kernels at SegMamba's shapes
    (batch 2, one group per direction, (L, d_inner) of SEGMAMBA_STAGES):
    the serving forward (#3), the state-saving forward (#3s) and the
    backward (#4u) against their plain versions, fp32 and bf16 (stage 1
    bf16 only), at stages 1-3 in full and at stage 0 on its first
    SEGMAMBA_L0_CHECK tokens (the plain loops at L = 110,592 would take
    minutes); then each timed at
    every stage's full shape (fp32, device ms per call) beside its bound
    (:func:`scan_bound`). Returns ({kernel: worst error}, {kernel: [(ms,
    bound ms, bound_by) per stage]})."""
    from mamba_unet_torch.ops.selective_scan_grouped import (
        selective_scan_grouped,
        selective_scan_grouped_ref,
    )

    from mamba_unet_torch.utils.compare import assert_close_to_max

    fwd_states, _, bwd, _, _ = training_kernels("grouped")
    worst = {"serve": 0.0, "fwd_states": 0.0, "bwd": 0.0}
    for i, (L, dg) in enumerate(SEGMAMBA_STAGES):
        L_check = min(L, SEGMAMBA_L0_CHECK) if i == 0 else L
        # stage 1's plain loops (13,824 steps) run in bf16, the dtype the
        # model runs under autocast, only
        for dtype in ((torch.bfloat16,) if i == 1
                      else (torch.float32, torch.bfloat16)):
            tag = str(dtype).split(".")[-1]
            args = grouped_args(torch, SEGMAMBA_BATCH, L_check, 1, dg, dtype,
                                dev, L + dg)
            err = assert_close_to_max(
                selective_scan_grouped(*args),
                selective_scan_grouped_ref(*args), KERNEL_TOL,
                f"segmamba #3 at stage {i} L={L_check} {tag}")
            log("segmamba_kernel", kernel="serve", stage=i, L=L_check, dg=dg,
                batch=SEGMAMBA_BATCH, dtype=tag, max_abs_err=f"{err:.3e}",
                tol=KERNEL_TOL, ok=True)
            worst["serve"] = max(worst["serve"], err)
            gy = torch.randn(args[0].shape, generator=torch.Generator()
                             .manual_seed(L)).to(dev, dtype)
            errs, _, _ = check_training_kernels(
                torch, args, gy, "segmamba_kernel", "grouped", stage=i,
                L=L_check, dg=dg, batch=SEGMAMBA_BATCH, dtype=tag)
            for kind, err in errs.items():
                worst[kind] = max(worst[kind], err)
            del args, gy
            torch.cuda.empty_cache()
    times = {"serve": [], "fwd_states": [], "bwd": []}
    for i, (L, dg) in enumerate(SEGMAMBA_STAGES):
        args = grouped_args(torch, SEGMAMBA_BATCH, L, 1, dg, torch.float32,
                            dev, 0)
        gy = torch.randn(args[0].shape, generator=torch.Generator()
                         .manual_seed(1)).to(dev)
        serve_ms, _ = device_ms(torch, lambda: selective_scan_grouped(*args),
                                5)
        fwd_ms, (y, cs) = device_ms(torch, lambda: fwd_states(*args), 5)
        bwd_ms, _ = device_ms(torch, lambda: bwd(*args, cs, gy), 5)
        fields = {}
        for kind, ms, bound_kind in (("serve", serve_ms, "grouped"),
                                     ("fwd_states", fwd_ms,
                                      "grouped_fwd_states"),
                                     ("bwd", bwd_ms, "grouped_bwd")):
            bound, by = scan_bound(bound_kind, SEGMAMBA_BATCH, L, dg, 4)
            times[kind].append((ms, bound, by))
            fields.update({f"{kind}_ms": f"{ms:.4f}",
                           f"{kind}_bound_ms": f"{bound:.4f}",
                           f"{kind}_bound_by": by,
                           f"{kind}_x_bound": f"{ms / bound:.1f}"})
        blocks = SEGMAMBA_BATCH * math.ceil(dg / 32)
        log("segmamba_kernel_time", stage=i, L=L, dg=dg,
            batch=SEGMAMBA_BATCH, dtype="float32", blocks=blocks,
            calls_per_forward=2 * SEGMAMBA_DEPTHS[i], **fields)
        del args, gy, y, cs
        torch.cuda.empty_cache()
    log("segmamba_kernel", **{f"worst_{k}": f"{v:.3e}"
                              for k, v in worst.items()})
    return worst, times


def segmamba_phase(torch, dev):
    """``[segmamba]``: full-width SegMamba (feat 48/96/192/384, depths
    2/2/2/2, d_state 16) on 96³ volumes at batch SEGMAMBA_BATCH under bf16
    autocast (fp32 scan state), ZOO3D_CLASSES classes: a no-grad forward
    (16 #3 launches: 8 bidirectional Mamba layers x 2 directions) and a
    training step (16 #3s and 16 #4u, no #3), no bidir or folded launch;
    device ms of each (profiler), peak GB. Returns the launches (#3, #3s,
    #4u)."""
    from mamba_unet_torch.models.segmamba import SegMamba
    from mamba_unet_torch.objectives import supervised_ce_dice
    from mamba_unet_torch.train.optim import poly_sgd

    per = 2 * sum(SEGMAMBA_DEPTHS)
    model = SegMamba(num_classes=ZOO3D_CLASSES, depths=SEGMAMBA_DEPTHS,
                     device=dev, generator=torch.Generator().manual_seed(11))
    g = torch.Generator().manual_seed(12)
    vol = (SEGMAMBA_VOLUME,) * 3
    x = torch.randn(SEGMAMBA_BATCH, *vol, 1, generator=g).to(dev)
    y = torch.randint(0, ZOO3D_CLASSES, (SEGMAMBA_BATCH, *vol),
                      generator=g).to(dev)
    kernels = all_scan_kernels()
    opt, sched = poly_sgd(model.parameters(), 0.01, 1000)

    def forward():
        with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
            return model.eval()(x)

    losses = []

    def step():
        model.train()
        opt.zero_grad(set_to_none=True)
        with torch.autocast("cuda", torch.bfloat16):
            loss = supervised_ce_dice(model(x), y)
        loss.backward()
        opt.step()
        sched.step()
        losses.append(loss.detach())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    logits = forward()
    torch.cuda.synchronize()
    fwd_launched = launch_counts(kernels)
    fwd_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    step()
    torch.cuda.synchronize()
    step_launched = launch_counts(kernels)
    step_peak = torch.cuda.max_memory_allocated() / 1e9
    fwd_device = profile_calls(torch, "segmamba_forward", [forward] * 2)
    step_device = profile_calls(torch, "segmamba_step", [step] * 2)
    losses = [float(v) for v in losses]
    log("segmamba", batch=SEGMAMBA_BATCH, volume=f"{SEGMAMBA_VOLUME}^3",
        dtype="bf16",
        classes=ZOO3D_CLASSES, mamba_layers=sum(SEGMAMBA_DEPTHS),
        logits=tuple(logits.shape),
        forward_launches_serve_fwd_states_bwd=tuple(fwd_launched[3:6]),
        step_launches_serve_fwd_states_bwd=tuple(step_launched[3:6]),
        other_launches=sum(fwd_launched[:3] + fwd_launched[6:]
                           + step_launched[:3] + step_launched[6:]),
        forward_device_ms=f"{fwd_device:.2f}",
        step_device_ms=f"{step_device:.2f}",
        forward_peak_gb=f"{fwd_peak:.2f}", step_peak_gb=f"{step_peak:.2f}",
        losses=" ".join(f"{v:.4f}" for v in losses),
        predicted_step_device_ms=SEGMAMBA_PREDICTED_STEP_MS)
    if (fwd_launched != [0, 0, 0, per, 0, 0, 0, 0, 0]
            or step_launched != [0, 0, 0, 0, per, per, 0, 0, 0]
            or logits.shape != (SEGMAMBA_BATCH, *vol, ZOO3D_CLASSES)
            or not bool(torch.isfinite(logits).all())
            or not all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"[segmamba] launches {fwd_launched} / "
                             f"{step_launched}, losses {losses}")
    del model, opt, x, y, logits
    torch.cuda.empty_cache()
    return per, per, per


def instance_norm_fed_biases(model) -> set:
    """The names of the biases of SegMamba's convolutions whose output an
    instance norm normalizes (every ``UnetrBasicBlock``'s ``Conv_0``,
    ``Conv_1``, ``Conv_2``): exact zeros of the gradient."""
    from mamba_unet_torch.models.segmamba import UnetrBasicBlock

    return {f"{prefix}.{name}.bias"
            for prefix, block in model.named_modules()
            if isinstance(block, UnetrBasicBlock)
            for name in ("Conv_0", "Conv_1", "Conv_2")
            if hasattr(block, name)}


def module_errors(want, got, zeros) -> dict:
    """Per top-level module of gradient dicts ``want`` and ``got``: the
    largest max abs difference among its leaves, each relative to the
    leaf's own max abs in ``want`` (the leaves in ``zeros``, and any of
    max 0, relative to the module's largest gradient)."""
    top = {}
    for k, w in want.items():
        m = k.split(".")[0]
        top[m] = max(top.get(m, 0.0), w.abs().max().item())
    errs = {}
    for k, w in want.items():
        m = k.split(".")[0]
        own = w.abs().max().item()
        scale = top[m] if k in zeros or own == 0.0 else own
        rel = (got[k] - w).abs().max().item() / max(scale, 1e-30)
        errs[m] = max(errs.get(m, 0.0), rel)
    return errs


def fp64_mamba_forward(self, hidden_states):
    """A plain fp64 forward of the port's ``Mamba`` in its own weights
    (bidirectional where it has the ``_b`` leaves), bound to an fp64 copy's
    layers by :func:`segmamba_parity_phase` as its reference: in_proj, the
    causal depthwise conv and SiLU, x_proj / dt_proj, the selective scan,
    the D skip, the SiLU gate, out_proj; no kernel and no cast to fp32.
    The scan runs FP64_SCAN_CHUNK steps at a time: within a chunk, state
    t = exp(s_t) * (state entering it) + sum over k <= t of exp(s_t - s_k)
    * Δ_k B_k u_k, with s the running sum of Δ A over the chunk."""
    import torch
    F = torch.nn.functional
    x, z = F.linear(hidden_states, self.in_proj.weight).chunk(2, dim=-1)
    T = FP64_SCAN_CHUNK
    causal = torch.ones(T, T, dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None, None]

    def direction(x, tag):
        conv = getattr(self, f"conv1d{tag}")
        xt = F.pad(x.transpose(1, 2), (conv.weight.shape[-1] - 1, 0))
        xc = F.silu(F.conv1d(xt, conv.weight, conv.bias,
                             groups=xt.shape[1])).transpose(1, 2)
        dt, Bm, Cm = F.linear(xc, getattr(self, f"x_proj{tag}").weight).split(
            [self.dt_rank, self.d_state, self.d_state], dim=-1)
        dt_proj = getattr(self, f"dt_proj{tag}")
        delta = F.softplus(F.linear(dt, dt_proj.weight) + dt_proj.bias)
        dA = delta[..., None] * -torch.exp(getattr(self, f"A{tag}_log"))
        dBu = (delta * xc)[..., None] * Bm[:, :, None, :]  # (B, L, D, N)
        state = dA.new_zeros(dA.shape[0], *dA.shape[2:])
        ys = []
        for c in range(0, xc.shape[1], T):
            s = dA[:, c:c + T].cumsum(1)
            n = s.shape[1]
            decay = torch.exp((s[:, :, None] - s[:, None]).masked_fill(
                ~causal[:, :n, :n], float("-inf")))  # (B, t, k, D, N)
            h = ((decay * dBu[:, None, c:c + T]).sum(2)
                 + torch.exp(s) * state[:, None])
            ys.append(torch.einsum("btdn,btn->btd", h, Cm[:, c:c + T]))
            state = h[:, -1]
        return torch.cat(ys, 1) + xc * getattr(self, f"D{tag}")

    y = direction(x, "")
    if self.bimamba_type == "v2":
        y = y + direction(x.flip(1), "_b").flip(1)
    return F.linear(y * F.silu(z), self.out_proj.weight)


def segmamba_parity_phase(torch, dev):
    """``[segmamba_parity]``: full-width SegMamba, one Mamba layer per
    stage (SEGMAMBA_PARITY_DEPTHS), on a 32³ volume (stage 0 L = 4,096),
    batch 1, TF32 off by the caller, the gradients of a fixed
    linear function of the logits. The fp32 step (the grouped kernels: 8
    #3s, 8 #4u) card vs CPU (the plain loops): logits within LOGIT_TOL of
    the largest, the loss within LOSS_TOL of the sum of its terms' sizes
    (sum |logit * w|: the random-sign sum cancels, and each side rounds
    it in its own order). Each Mamba layer alone, card
    vs CPU on the CPU step's own input and upstream gradient: every leaf's
    gradient and the input's within MODEL_GRAD_TOL of its own max. The
    step in fp64, its Mamba layers the plain :func:`fp64_mamba_forward`,
    card vs CPU: the loss (as above) and every gradient within
    SEGMAMBA_FP64_TOL of the largest. Printed beside them: how far each
    fp32 step's gradients lie from the CPU's fp64 ones, module by module
    (:func:`module_errors`)."""
    import types

    from mamba_unet_torch.models.segmamba import MambaLayer, SegMamba
    from mamba_unet_torch.nn.mamba1d import Mamba

    g = torch.Generator().manual_seed(13)
    vol = (SEGMAMBA_PARITY_VOLUME,) * 3
    x = torch.randn(1, *vol, 1, generator=g)
    w = torch.randn(1, *vol, ZOO3D_CLASSES, generator=g)
    cpu = SegMamba(num_classes=ZOO3D_CLASSES, depths=SEGMAMBA_PARITY_DEPTHS,
                   generator=torch.Generator().manual_seed(11))
    zeros = instance_norm_fed_biases(cpu)
    grads, losses, secs, outs, seen, launched = {}, {}, {}, {}, {}, {}
    kernels = all_scan_kernels()
    for tag, d, dtype in (("cpu", "cpu", torch.float32),
                          ("gpu", dev, torch.float32),
                          ("cpu64", "cpu", torch.float64),
                          ("gpu64", dev, torch.float64)):
        model = copy.deepcopy(cpu).to(d, dtype)
        hooks = []
        if dtype == torch.float64:
            for m in model.modules():
                if isinstance(m, Mamba):
                    m.forward = types.MethodType(fp64_mamba_forward, m)
        elif tag == "cpu":  # each Mamba layer's input and upstream grad
            def capture(inp, out, name):
                seen[name] = [inp[0].detach().clone(), None]
                out.register_hook(
                    lambda g_, name=name: seen[name].__setitem__(1, g_))
            hooks = [m.register_forward_hook(
                lambda mod, inp, out, name=n: capture(inp, out, name))
                for n, m in model.named_modules()
                if isinstance(m, MambaLayer)]
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        out = model.train()(x.to(d, dtype))
        loss = (out * w.to(d, dtype)).sum()
        loss.backward()
        secs[tag] = time.perf_counter() - t0
        launched[tag] = launch_counts(kernels)
        for h in hooks:
            h.remove()
        terms = (out.detach() * w.to(d, dtype)).abs().sum()
        losses[tag] = (float(loss.detach()), float(terms))
        outs[tag] = out.detach().cpu().double()
        grads[tag] = {k: p.grad.cpu().double()
                      for k, p in model.named_parameters()}
        del model, out, loss
    per = 2 * sum(SEGMAMBA_PARITY_DEPTHS)
    logit_max = outs["cpu"].abs().max().item()
    logits_err = (outs["gpu"] - outs["cpu"]).abs().max().item()
    loss_err = abs(losses["gpu"][0] - losses["cpu"][0]) / losses["cpu"][1]
    card = module_errors(grads["cpu64"], grads["gpu"], zeros)
    fp32 = module_errors(grads["cpu64"], grads["cpu"], zeros)
    worst = max(card, key=card.get)
    worst_mamba = max((m for m in card if "_mamba" in m), key=card.get)
    top64 = max(v.abs().max().item() for v in grads["cpu64"].values())
    err64, at64 = max(((grads["gpu64"][k] - v).abs().max().item() / top64, k)
                      for k, v in grads["cpu64"].items())
    loss64 = (abs(losses["gpu64"][0] - losses["cpu64"][0])
              / losses["cpu64"][1])

    # each Mamba layer alone, on the CPU step's input and upstream gradient
    layer_worst, layer_at = 0.0, None
    for name, (xin, gy) in seen.items():
        got = {}
        for tag, d in (("cpu", "cpu"), ("gpu", dev)):
            layer = copy.deepcopy(dict(cpu.named_modules())[name]).to(d)
            xi = xin.detach().to(d).requires_grad_(True)
            layer.train()(xi).backward(gy.to(d))
            got[tag] = {k: p.grad.cpu().double()
                        for k, p in layer.named_parameters()}
            got[tag]["input"] = xi.grad.cpu().double()
        for k, want in got["cpu"].items():
            rel = ((got["gpu"][k] - want).abs().max().item()
                   / max(want.abs().max().item(), 1e-30))
            if not math.isfinite(rel) or rel > layer_worst:
                layer_worst, layer_at = rel, f"{name}.{k}"
    log("segmamba_parity", volume=f"{SEGMAMBA_PARITY_VOLUME}^3",
        logits_max_abs_err=f"{logits_err:.3e}", logit_max=f"{logit_max:.3f}",
        loss_gpu=f"{losses['gpu'][0]:.6f}",
        loss_terms=f"{losses['cpu'][1]:.1f}", loss_rel_err=f"{loss_err:.2e}",
        launches_fwd_states_bwd=tuple(launched["gpu"][4:6]),
        **{f"{t}_s": f"{v:.2f}" for t, v in secs.items()})
    log("segmamba_parity", mamba_layers_alone=len(seen),
        worst_own_rel_err=f"{layer_worst:.2e}", worst_at=layer_at,
        tol=MODEL_GRAD_TOL)
    log("segmamba_parity", fp64_params=len(grads["cpu64"]),
        fp64_loss_rel_err=f"{loss64:.2e}",
        fp64_worst_grad_rel_err=f"{err64:.2e}", fp64_worst_param=at64,
        relative_to="model_max_grad", tol=SEGMAMBA_FP64_TOL)
    log("segmamba_parity", fp32_vs_fp64="module max of each leaf's error "
        "relative to its own max", modules=len(card),
        card_max=f"{card[worst]:.2e}", card_worst_module=worst,
        cpu_there=f"{fp32[worst]:.2e}", cpu_max=f"{max(fp32.values()):.2e}",
        card_worst_mamba_layer=worst_mamba,
        card_mamba=f"{card[worst_mamba]:.2e}",
        cpu_mamba=f"{fp32[worst_mamba]:.2e}")
    finite = all(bool(torch.isfinite(v).all()) for v in grads["gpu"].values())
    if (launched["gpu"] != [0, 0, 0, 0, per, per, 0, 0, 0]
            or any(launched["gpu64"])
            or logits_err > LOGIT_TOL * max(1.0, logit_max)
            or loss_err > LOSS_TOL or not finite
            or len(seen) != sum(SEGMAMBA_PARITY_DEPTHS)
            or not layer_worst <= MODEL_GRAD_TOL
            or not (err64 <= SEGMAMBA_FP64_TOL
                    and loss64 <= SEGMAMBA_FP64_TOL)):
        raise AssertionError(
            f"[segmamba_parity] launches {launched}, logits {logits_err}, "
            f"loss {loss_err}, finite {finite}, Mamba layers alone "
            f"{layer_worst} at {layer_at}, fp64 {err64} at {at64}, fp64 "
            f"loss {loss64}")


def mad_parity_phase(torch, dev):
    """``[mad_parity]``: one MAD fine-tuning step of full-width
    ``ViM_seg`` + two ``unet`` denoisers (dropout and drop-path 0), batch
    MAD_PARITY_BATCH on MAD_PARITY_PATCH², fp32 (TF32 off by the caller),
    card against a CPU copy: the losses within LOSS_TOL and every
    gradient within MODEL_GRAD_TOL of its model's largest (``unet``'s fp32
    gradients are ill-conditioned), the biases of ``unet``'s convolutions
    that feed a BatchNorm (exact zeros) below ZERO_GRAD_REL of their
    model's largest on both sides; 14 #2b and 14 #4 launches."""
    import numpy as np

    from mamba_unet_torch.data.mad_augment import MADFineTuneTransform
    from mamba_unet_torch.data.synthetic import phantom_acdc
    from mamba_unet_torch.models import net_factory
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.train import MADFineTuneTrainer, TrainConfig
    from mamba_unet_torch.utils.compare import batchnorm_fed_biases

    size = MAD_PARITY_PATCH
    cfg = TrainConfig(base_lr=0.01, max_iterations=1000,
                      batch_size=MAD_PARITY_BATCH, patch_size=(size, size),
                      num_classes=4, seed=1337)
    transform = MADFineTuneTransform((size, size), 4, seed=5)
    samples = [transform(s) for s in phantom_acdc(
        1, MAD_PARITY_BATCH, 0, 0, size + 32, seed=4)["train"]]
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
             for k in samples[0]}
    kernels = all_scan_kernels()
    grads, losses, zeros = {}, {}, set()
    for tag, d in (("cpu", "cpu"), ("gpu", dev)):
        seg = MambaUnet(num_classes=4, drop_path_rate=0.0,
                        generator=torch.Generator().manual_seed(1337))
        draw_patch_bias(torch, seg.mamba_unet.patch_embed, 1437)
        mad, den = (net_factory("unet", num_classes=4, in_chans=4,
                                dropout=(0.0,) * 5,
                                generator=torch.Generator().manual_seed(s))
                    for s in (1338, 1339))
        trainer = MADFineTuneTrainer(seg, cfg, mad_model=mad, den_model=den,
                                     device=d)
        for k in kernels:
            k.launches = 0
        logs = trainer.train_step(batch)
        launched = launch_counts(kernels)
        losses[tag] = {k: float(v) for k, v in logs.items()
                       if k.startswith("loss")}
        grads[tag] = {f"{name}.{k}": p.grad.cpu()
                      for name, (m, _, _) in zip(("seg", "mad", "den"),
                                                 trainer._members())
                      for k, p in m.named_parameters()}
        zeros = {f"{name}.{k}" for name, (m, _, _) in zip(
            ("seg", "mad", "den"), trainer._members())
            for k in batchnorm_fed_biases(m)}
        del trainer, seg, mad, den
    n = SS2D_PER_FORWARD
    log("mad_parity", batch=MAD_PARITY_BATCH, patch=size,
        launches_fwd_states_bwd=tuple(launched[1:3]))
    if launched != [0, n, n] + [0] * 6:
        raise AssertionError(f"[mad_parity] launched {launched}")
    card_vs_cpu_grads("mad_parity", grads, losses, zeros=zeros,
                      to_model_max=True)


# --- the parallelism slice: the grouped kernels' carry variants, the
# sequence-, channel- and pipeline-parallel paths and data parallelism on
# gloo ranks that share card 0, and the remaining utilities

# (name, batch, G, L, dg): mamba-130m's scoring shape and ViM stage 0
CARRY_SHAPES = (("lm", 8, 1, 1024, LM_DINNER), ("vim_stage0", TRAIN_BATCH, 4,
                                                3136, 192))
PAR_RANKS = 2          # gloo ranks on card 0 (NCCL refuses two on one card)
PAR_BATCH = 8          # full-width ViM_seg, fp32, [seq_parallel]/[tp_parallel]
PIPE_MICRO, PIPE_ROWS, PIPE_L = 4, 2, 128  # [pipeline]: 4 x (2 x 128)
DP_ITERS = 2           # [data_parallel] steps
# card vs one process: each tensor within this share of its own max
PAR_LOGIT_TOL, PAR_GRAD_TOL = 1e-4, MODEL_GRAD_TOL
# the bf16 data-parallel step: the ranks' matrix products see 12 rows where
# one process sees 24, so cuBLAS may round in another order. Each weight's
# distance from the one-process step's is held to a share of its leaf's
# largest update over the steps (w - w0), a share that the unscaled
# control (gradients summed over the ranks, not divided by their count:
# every update about doubled) must exceed
DP_BF16_LOSS_TOL, DP_BF16_UPDATE_TOL = 2e-3, 5e-2
DP_FP32_LOSS_TOL, DP_FP32_UPDATE_TOL = 1e-4, 5e-3
DP_UPDATE_FLOOR = 1e-3
UTILS_ITERS = 3        # [utils] train CLI steps
# [data_parallel_methods]: every multi-model trainer's DPM_ITERS steps on
# the PAR_RANKS ranks against its one-process steps, the models at the
# CLI's widths (drop path 0.2, patch embeddings' biases drawn, the mask
# models' position embeddings warm): cross-teaching at bs24 (8 labeled),
# the others at a global batch of DPM_BATCH (DPM_LABELED labeled), 224²
# (ViT_seg tiles only 224k), the 3-D MagicNet at MAGIC3D_PATCH³ with
# MAGIC3D_BATCH. In bf16 (the CLI's --bf16), a trainer is held to its
# one-process steps within a base limit plus DPM_SPREAD_SHARE x its
# spread: how far the one-process steps move from themselves, taken again
# in fp32 and DPM_ULP_TWINS times from start weights one ulp off (the
# reference process takes them all; parallel.checks.train's twins). The
# losses within DP_BF16_LOSS_TOL, each leaf within DPM_UPDATE_TOL of its
# update (floored as update_errors floors it), the host state within
# MAGIC_HIST_TOL of the pixels (MagicNet's histogram) or 1e-3 (CTAugment's
# rates). The fp32 twin covers the bf16 roundings: the ranks' weight
# gradients rounded over their rows where one process rounds them over
# the whole batch move a leaf whose gradient cancels (unet's first
# convolution before its BatchNorm) by up to a quarter of its update. The
# ulp twins cover the fp32 islands that amplify rounding: the BatchNorms
# over few rows of the mask and location heads, which moved MagicNet's
# mask variant on MambaUnetMask (the train CLI's 2-D model, run here with
# --mask_recovery) by 3.6x the limit that the fp32 twin alone sets. The
# plain 2-D MagicNet runs in fp64 on magicnet_2D, held to the base limits
# alone (DP_FP32_LOSS_TOL, DPM_UPDATE_TOL). A wrong gradient scale, a
# dropped row or a missed reduction moves the well-conditioned leaves by
# their whole update. The control leaves cross-teaching's model 2
# gradients unreduced and must fail the limit
DPM_ITERS, DPM_BATCH, DPM_LABELED = 2, 4, 2
DPM_UPDATE_TOL, DPM_SPREAD_SHARE, DPM_ULP_TWINS = 5e-2, 3.0, 4


def carry_args(torch, bsz, G, L, dg, dev, seed):
    """fp32 grouped_args, an incoming state, a last state's cotangent and
    y's: the bf16 case casts the same values."""
    args = grouped_args(torch, bsz, L, G, dg, torch.float32, dev, seed)
    g = torch.Generator().manual_seed(seed + 2)
    x0 = (0.5 * torch.randn(bsz, G * dg, 16, generator=g)).to(dev)
    g_last = torch.randn(bsz, G * dg, 16, generator=g).to(dev)
    gy = torch.randn(args[0].shape, generator=g).to(dev)
    return args, x0, g_last, gy


def scan_carry_kernel_phase(torch, dev):
    """``[scan_carry_kernel]``: #3, #3s and #4u with ``x_init``, the last
    state and ``g_last`` against their plain versions at CARRY_SHAPES, fp32
    and bf16, each plain version timed once; then each timed with and
    without the new arguments (fp32). Returns {kind: (max err, ms,
    plain ms, bound ms, bound_by)} of the carry variants at ViM stage 0,
    fp32."""
    from mamba_unet_torch.ops import selective_scan_grouped as g
    from mamba_unet_torch.utils.compare import assert_close_to_max

    names = g.ARG_NAMES + ("x_init",)
    errs = {"serve": 0.0, "fwd_states": 0.0, "bwd": 0.0}
    rows = {}
    for shape, bsz, G, L, dg in CARRY_SHAPES:
        fp32 = carry_args(torch, bsz, G, L, dg, dev, L + dg)
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[-1]
            args, x0, gl, gy = fp32
            args = [a.to(dtype) if i in (0, 1, 3, 4) else a
                    for i, a in enumerate(args)]
            gy = gy.to(dtype)
            at = f"{shape} {tag}"
            here = {k: 0.0 for k in errs}

            def close(kind, got, want, what, rel=GRAD_KERNEL_TOL):
                here[kind] = max(here[kind], assert_close_to_max(
                    got, want, rel, f"{what} at {at}"))
                errs[kind] = max(errs[kind], here[kind])

            with torch.no_grad():
                y, last = g.selective_scan_grouped(*args, True, True,
                                                   x_init=x0)
                plain = {"serve": timed_once(torch, lambda: g.
                                             selective_scan_grouped_ref(
                                                 *args, True, True, x0))}
                close("serve", y, plain["serve"][1][0], "y")
                close("serve", last, plain["serve"][1][1], "last")
                del y, last
                y, cs, last = g.selective_scan_grouped_fwd_states(
                    *args, True, x0, True)
                plain["fwd_states"] = timed_once(torch, lambda: g.
                                                 selective_scan_grouped_states_ref(
                                                     *args, True, x0, True))
                for what, got, want in zip(("y", "cs", "last"), (y, cs, last),
                                           plain["fwd_states"][1]):
                    close("fwd_states", got, want, what)
                grads = g.selective_scan_grouped_bwd(*args, cs, gy, True, x0,
                                                     gl)
                plain["bwd"] = timed_once(torch, lambda: g.
                                          selective_scan_grouped_bwd_ref(
                                              *args, gy, True, x0, gl))
                for name, got, want in zip(names, grads, plain["bwd"][1]):
                    close("bwd", got, want, "d" + name,
                          GRAD_SUM_TOL if name in SUMMED else GRAD_KERNEL_TOL)
                del grads
                plain = {k: v[0] for k, v in plain.items()}
                log("scan_carry_kernel", shape=shape, dtype=tag, batch=bsz,
                    G=G, L=L, dg=dg, ok=True,
                    **{f"max_err_{k}": f"{v:.3e}" for k, v in here.items()})
                if dtype != torch.float32:
                    continue
                calls = {
                    "serve": (lambda: g.selective_scan_grouped(
                        *args, True, True, x_init=x0),
                        lambda: g.selective_scan_grouped(*args, True)),
                    "fwd_states": (lambda: g.selective_scan_grouped_fwd_states(
                        *args, True, x0, True),
                        lambda: g.selective_scan_grouped_fwd_states(
                            *args, True)),
                    "bwd": (lambda: g.selective_scan_grouped_bwd(
                        *args, cs, gy, True, x0, gl),
                        lambda: g.selective_scan_grouped_bwd(
                            *args, cs, gy, True))}
                for kind, (with_carry, without) in calls.items():
                    ms_c, _ = device_ms(torch, with_carry, 20)
                    ms_0, _ = device_ms(torch, without, 20)
                    bkind = {"serve": "grouped", "fwd_states":
                             "grouped_fwd_states", "bwd": "grouped_bwd"}[kind]
                    bound, by = scan_bound(bkind, bsz, L, dg, 4, groups=G,
                                           carry=True)
                    log("scan_carry_kernel_time", shape=shape, kernel=kind,
                        batch=bsz, G=G, L=L, dg=dg, ms=f"{ms_c:.4f}",
                        ms_without=f"{ms_0:.4f}",
                        ratio=f"{ms_c / ms_0:.3f}",
                        plain_ms=f"{plain[kind]:.2f}",
                        bound_ms=f"{bound:.4f}", bound_by=by)
                    if shape == "vim_stage0":
                        rows[kind] = (ms_c, plain[kind], bound, by)
                del y, cs, last, args, gy
            torch.cuda.empty_cache()
        del fp32
    return {kind: (errs[kind], *rows[kind]) for kind in rows}


def _counts(launches):
    """A rank's launch counts, compactly: serving/state-saving/backward
    (and the carry variants' among them)."""
    names = ("selective_scan_grouped", "selective_scan_grouped_fwd_states",
             "selective_scan_grouped_bwd")
    return ("/".join(str(launches[n]) for n in names) + " (carry "
            + "/".join(str(launches[f"{n}.carry"]) for n in names) + ")")


def _close_to(what, got, want, rel):
    """``utils.compare.assert_close_to_max`` on fp32 numpy arrays (in
    numpy: the pipeline's gradients are mamba-130m's 130 M values): raise
    unless ``got`` is finite, has ``want``'s shape and |got - want| <= rel
    * max|want| elementwise; return the max abs error."""
    import numpy as np

    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} vs {want.shape}")
    err = np.abs(got - want)
    if not (np.isfinite(got).all()
            and (err <= rel * np.abs(want).max()).all()):
        raise AssertionError(f"{what}: max abs err {err.max():.3e}, ref max "
                             f"{np.abs(want).max():.3e}")
    return float(err.max())


def vim_builder(scan_impl, drop_path=0.0):
    return ("mamba_unet_torch.models.vssm", "MambaUnet",
            dict(num_classes=4, drop_path_rate=drop_path, scan_impl=scan_impl))


def lm_builder():
    return ("mamba_unet_torch.models.mamba_lm", "MambaLMHeadModel",
            dict(vocab_size=LM_VOCAB))


def parallel_inputs(np):
    """The seeded inputs of the multi-rank phases."""
    r = np.random.default_rng(15)
    x = r.random((PAR_BATCH, PATCH, PATCH, 1), np.float32)
    cot = r.normal(size=(PAR_BATCH, PATCH, PATCH, 4)).astype(np.float32)
    rows = PIPE_MICRO * PIPE_ROWS
    ids = r.integers(0, LM_VOCAB, (rows, PIPE_L))
    targets = r.integers(0, LM_VOCAB, (rows, PIPE_L))
    batches = [{"image": r.random((TRAIN_BATCH, PATCH, PATCH, 1), np.float32),
                "label": r.integers(0, 4, (TRAIN_BATCH, PATCH, PATCH))}
               for _ in range(DP_ITERS)]
    return x, cot, ids, targets, batches


def dp_config(bf16):
    return dict(base_lr=0.01, max_iterations=100, batch_size=TRAIN_BATCH,
                patch_size=(PATCH, PATCH), num_classes=4, eval_every=10 ** 6,
                log_every=1, seed=0, bf16=bf16)


UNET_BUILDER = ("mamba_unet_torch.models.unet", "UNet", dict(num_classes=4))
REGISTRY = "mamba_unet_torch.models.registry"


def dpm_cases(np):
    """[(name, job kwargs)] of ``[data_parallel_methods]``: each a bf16
    or fp64 (``dtype``) ``parallel.checks.train`` job, its seeded global
    batches included."""
    from mamba_unet_torch.models.registry import size_kwargs

    r = np.random.default_rng(16)

    def model(name, seed, classes=4, patch=PATCH, **kw):
        kw = dict(net_type=name, num_classes=classes, bias_seed=seed + 100,
                  **size_kwargs(name, patch, CUBE_SIZE), **kw)
        return ("mamba_unet_torch.parallel.checks", "warm_model", kw), None, \
            seed

    def batches(bsz, patch=PATCH, rank=2, classes=4, **extra):
        shape = (bsz,) + (patch,) * rank
        out = []
        for _ in range(DPM_ITERS):
            b = {"image": r.random(shape + (1,), np.float32),
                 "label": r.integers(0, classes, shape)}
            for key, kind in extra.items():
                b[key] = (r.random(shape + (1,), np.float32)
                          if kind == "image" else
                          r.integers(0, classes, shape) if kind == "label"
                          else np.eye(4, dtype=np.float32)[
                              r.integers(0, 4, shape)] * 0.8 + 0.05)
            out.append(b)
        return out

    def case(name, first, cls, members=None, bsz=DPM_BATCH, data=None,
             config=None, **kw):
        builder, weights, seed = first
        cfg = dict(dp_config("dtype" not in kw), batch_size=bsz,
                   **(config or {}))
        return (name, dict(
            builder=builder, weights=weights, seed=seed, config=cfg,
            batches=data or batches(bsz),
            method=(f"mamba_unet_torch.train.{cls[0]}", cls[1]),
            members=members or {}, **kw))

    semi = dict(labeled_bs=DPM_LABELED)
    dist3d = np.arange(MAGIC3D_CLASSES, 0, -1, dtype=np.float64)
    return [
        case("cross_teaching", model("ViM_seg", 31),
             ("methods", "CrossTeachingTrainer"), bsz=TRAIN_BATCH,
             members={"model2": model("unet", 32)},
             method_kw=dict(labeled_bs=SEMI_LABELED)),
        case("mean_teacher", model("ViM_seg", 33),
             ("methods", "MeanTeacherTrainer"),
             method_kw=dict(semi, warmup_iters=0)),
        case("uamt", model("unet", 34), ("methods", "UAMTTrainer"),
             method_kw=semi),
        case("weak_scribble", model("unet", 35),
             ("weak", "WeakScribbleTrainer"),
             members={"model2": model("ViT_seg", 36),
                      "model3": model("ViM_seg", 37)},
             data=batches(DPM_BATCH, classes=5)),
        case("contrastive_consistency", model("ViM_seg", 38),
             ("contrastive_cc", "ContrastiveConsistencyTrainer"),
             members={"model2": model("ViM_seg", 39)},
             data=batches(DPM_BATCH, image_weak="image",
                          image_strong="image", label_aug="label"),
             method_kw=semi),
        case("contrastive_mask_recovery", model("MambaUnetMask", 40),
             ("contrastive_cc", "ContrastiveConsistencyTrainer"),
             members={"model2": model("MambaUnetMask", 41)},
             data=batches(DPM_BATCH, image_weak="image",
                          image_strong="image", label_aug="label"),
             method_kw=dict(semi, mask_recovery=True,
                            mask_cube_size=CUBE_SIZE)),
        case("mask_pretrain", model("MambaUnetMask", 42),
             ("mask_pretrain", "MaskPretrainTrainer"),
             method_kw=dict(cube_size=CUBE_SIZE)),
        case("magicnet", model("magicnet_2D", 43),
             ("magicnet", "MagicNetTrainer"), class_dist=[4.0, 3, 2, 1],
             dtype="float64",
             method_kw=dict(semi, cube_size=CUBE_SIZE, blend_after=0)),
        case("magicnet_mask_recovery", model("MambaUnetMask", 44),
             ("magicnet", "MagicNetTrainer"), class_dist=[4.0, 3, 2, 1],
             method_kw=dict(semi, cube_size=CUBE_SIZE, blend_after=0,
                            mask_recovery=True)),
        case("magicnet_3d",
             (("mamba_unet_torch.models.registry", "net_factory",
               dict(net_type="magicnet", num_classes=MAGIC3D_CLASSES,
                    cube_size=MAGIC3D_CUBE, patch_size=MAGIC3D_PATCH)),
              None, 45),
             ("magicnet", "MagicNetTrainer"), bsz=MAGIC3D_BATCH,
             data=batches(MAGIC3D_BATCH, MAGIC3D_PATCH, 3,
                          MAGIC3D_CLASSES),
             config=dict(num_classes=MAGIC3D_CLASSES,
                         patch_size=(MAGIC3D_PATCH,) * 3),
             class_dist=dist3d,
             method_kw=dict(labeled_bs=MAGIC3D_LABELED,
                            cube_size=MAGIC3D_CUBE, blend_after=0)),
        case("mad_pretrain", model("unet", 46, in_chans=4),
             ("mad", "MADPretrainTrainer"),
             data=[dict(b, image=b.pop("mask_label"))
                   for b in batches(DPM_BATCH, mask_label="onehot")]),
        case("mad_finetune", model("ViM_seg", 47),
             ("mad", "MADFineTuneTrainer"),
             members={"mad_model": model("unet", 48, in_chans=4),
                      "den_model": model("unet", 49, in_chans=4)},
             data=batches(DPM_BATCH, mask_label="onehot")),
    ]


def start_parallel(np):
    """Start the ranks of ``[seq_parallel]``, ``[tp_parallel]``,
    ``[pipeline]``, ``[data_parallel]`` and ``[data_parallel_methods]``:
    one group of PAR_RANKS gloo ranks on card 0 runs every multi-rank job
    (``parallel.checks``), and one more process runs the one-process
    references of the same weights and inputs (the tm branch, the plain
    LM, the one-rank trainer steps), both started side by side. Returns
    (the ranks, the reference, the start time, the methods' cases);
    :func:`parallel_phases` collects them."""
    from mamba_unet_torch.parallel.checks import run_jobs
    from mamba_unet_torch.parallel.launch import Ranks

    x, cot, ids, targets, batches = parallel_inputs(np)
    dp = ((vim_builder("auto", 0.2), True, 23), (UNET_BUILDER, False, 24))
    cases = dpm_cases(np)
    jobs = [("model", dict(builder=vim_builder("seq_sharded"), x=x, cot=cot,
                           route="seq", seed=21, all_ranks=False)),
            ("model", dict(builder=vim_builder("tp_sharded"), x=x, cot=cot,
                           route="tp", seed=21, all_ranks=False)),
            ("pipeline", dict(builder=lm_builder(), ids=ids, targets=targets,
                              n_micro=PIPE_MICRO, seed=22, all_ranks=False)),
            *(("train", dict(builder=b, config=dp_config(bf16),
                             batches=batches, seed=seed))
              for b, bf16, seed in dp),
            *(("train", dict(builder=b, config=dp_config(bf16),
                             batches=batches, seed=seed, unscaled_grads=True))
              for b, bf16, seed in dp),
            *(("train", dict(kw, all_ranks=False)) for _, kw in cases),
            ("train", dict(cases[0][1], all_ranks=False,
                           unreduced=("model2",)))]
    reference = [("model", dict(builder=vim_builder("tm"), x=x, cot=cot,
                                route="one", seed=21)),
                 ("lm", dict(builder=lm_builder(), ids=ids, targets=targets,
                             seed=22)),
                 *(("train", dict(builder=b, config=dp_config(bf16),
                                  batches=batches, seed=seed, start=True))
                   for b, bf16, seed in dp),
                 # a bf16 trainer's steps again, in fp32 and from start
                 # weights one ulp off: their spread
                 *(("train", dict(kw, start=True,
                                  fp32_twin=kw["config"]["bf16"],
                                  ulp_twins=DPM_ULP_TWINS
                                  if kw["config"]["bf16"] else 0))
                   for _, kw in cases)]
    ranks = Ranks(PAR_RANKS, run_jobs, "cuda", jobs)
    return (ranks, Ranks(1, run_jobs, "cuda", reference),
            time.perf_counter(), cases)


def parallel_phases(np, started):
    """Collect the processes that :func:`start_parallel` started and hold
    each job against its one-process reference. Returns the carry
    variants' launches in the ranks' runs."""
    running, one, t0, cases = started
    waited = time.perf_counter()
    ranks = running.result(timeout=900)
    ranks_in = time.perf_counter()
    (want_model, want_lm, *rest), = one.result(timeout=900)
    want_dp, want_methods = rest[:2], rest[2:]
    now = time.perf_counter()
    # when the collection began, how long each group took to hand its
    # results over, and each process's seconds of jobs
    log("parallel", ranks=PAR_RANKS, backend="gloo", device="cuda:0",
        jobs=len(ranks[0]), seconds_since_start=f"{now - t0:.1f}",
        collected_after=f"{waited - t0:.1f}",
        collect_seconds=f"{ranks_in - waited:.1f}/{now - ranks_in:.1f}",
        job_seconds=[f"{sum(j['seconds'] for j in r):.1f}"
                     for r in [*ranks, [want_model, want_lm, *rest]]])
    first = ranks[0]
    carry = {k: sum(r[j][key].get(f"{k}.carry", 0) for r in ranks
                    for j, key in ((0, "serve_launches"), (0, "launches"),
                                   (1, "serve_launches"), (1, "launches"),
                                   (2, "launches")))
             for k in ("selective_scan_grouped",
                       "selective_scan_grouped_fwd_states",
                       "selective_scan_grouped_bwd")}

    # the sharded routes against the one-process tm branch
    for job, phase in ((0, "seq_parallel"), (1, "tp_parallel")):
        got = first[job]
        e_eval = _close_to(f"{phase} eval", got["eval"], want_model["eval"],
                           PAR_LOGIT_TOL)
        e_log = _close_to(f"{phase} logits", got["logits"],
                          want_model["logits"], PAR_LOGIT_TOL)
        e_grad = max(_close_to(f"{phase} d{k}", got["grads"][k], w,
                               PAR_GRAD_TOL)
                     for k, w in want_model["grads"].items())
        launches = [r[job]["launches"] for r in ranks]
        for r in ranks:
            if min(r[job]["launches"][k] for k in (
                    "selective_scan_grouped_fwd_states",
                    "selective_scan_grouped_bwd")) == 0 or r[job][
                    "serve_launches"]["selective_scan_grouped"] == 0:
                raise AssertionError(f"{phase}: a rank ran no grouped kernel")
        log(phase, ranks=PAR_RANKS, batch=PAR_BATCH, patch=PATCH,
            dtype="float32", eval_err=f"{e_eval:.3e}",
            logit_err=f"{e_log:.3e}", grad_err=f"{e_grad:.3e}",
            tol=f"{PAR_LOGIT_TOL}/{PAR_GRAD_TOL}", ok=True,
            serve_launches=[_counts(r[job]["serve_launches"]) for r in ranks],
            launches=[_counts(n) for n in launches])

    # the pipelined LM against the plain one
    got = first[2]
    e_log = _close_to("pipeline logits", got["logits"], want_lm["logits"],
                      PAR_LOGIT_TOL)
    e_grad = max(_close_to(f"pipeline d{k}", got["grads"][k], w,
                           PAR_GRAD_TOL)
                 for k, w in want_lm["grads"].items())
    loss = want_lm["loss"]
    if abs(got["loss"] - loss) > LOSS_TOL * abs(loss):
        raise AssertionError(f"pipeline loss {got['loss']} vs {loss}")
    log("pipeline", stages=PAR_RANKS, n_micro=PIPE_MICRO, rows=PIPE_ROWS,
        L=PIPE_L, d_model=768, n_layer=LM_DEPTH, logit_err=f"{e_log:.3e}",
        grad_err=f"{e_grad:.3e}", loss=f"{got['loss']:.6f}",
        loss_one_process=f"{loss:.6f}", ok=True,
        launches=[_counts(r[2]["launches"]) for r in ranks])

    # data parallelism against the one-rank steps, and the unscaled
    # control, which must fail the same limits
    for job, want, (model, bf16) in zip(
            (3, 4), want_dp, (("MambaUnet", True), ("UNet", False))):
        got, control = first[job], first[job + 2]
        loss_tol, u_tol = ((DP_BF16_LOSS_TOL, DP_BF16_UPDATE_TOL) if bf16
                           else (DP_FP32_LOSS_TOL, DP_FP32_UPDATE_TOL))
        loss_err = max(abs(a - b) / abs(b) for a, b in
                       zip(got["losses"], want["losses"]))
        u_err = update_errors(np, got["state"], want)
        c_loss = max(abs(a - b) / abs(b) for a, b in
                     zip(control["losses"], want["losses"]))
        c_err = update_errors(np, control["state"], want)
        same = all(np.array_equal(ranks[1][job]["state"][k],
                                  got["state"][k]) for k in got["state"])
        log("data_parallel", model=model, ranks=PAR_RANKS,
            rows_per_rank=TRAIN_BATCH // PAR_RANKS, steps=DP_ITERS,
            dtype="bf16" if bf16 else "float32", losses=got["losses"],
            one_process=want["losses"], loss_rel_err=f"{loss_err:.2e}",
            update_err=f"{u_err[0][0]:.3e}",
            worst_leaves=[(k, f"{e:.2e}") for e, _, _, k in u_err[:3]],
            tol=f"{loss_tol}/{u_tol}", replicas_equal=same,
            control_losses=control["losses"],
            control_loss_rel_err=f"{c_loss:.2e}",
            control_update_err=f"{c_err[0][0]:.3e}",
            control_least_leaf=f"{c_err[-1][0]:.2e}")
        if loss_err > loss_tol:
            raise AssertionError(f"data_parallel losses {got['losses']} vs "
                                 f"{want['losses']}")
        if not u_err[0][0] <= u_tol:
            raise AssertionError(f"data_parallel: {u_err[0][3]} is "
                                 f"{u_err[0][0]:.3e} of its update away")
        if not same:
            raise AssertionError("data_parallel: the ranks' weights differ")
        if c_err[0][0] <= u_tol:
            raise AssertionError("data_parallel: the unscaled control "
                                 "passes the weight check")
    data_parallel_methods(np, ranks, want_methods, cases, 7)
    return carry


def _within(np, got, want, base, spread=0.0):
    """(error, its limit) of ``got`` against ``want``: the largest
    distance, and ``base`` plus DPM_SPREAD_SHARE x ``spread``."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float(err.max()), base + DPM_SPREAD_SHARE * spread


def data_parallel_methods(np, ranks, wants, cases, first_job):
    """``[data_parallel_methods]``: each multi-model trainer's steps on
    the ranks (jobs from ``first_job`` on, the control last) against its
    one-process steps, a bf16 trainer's within a base limit plus its
    spread (``want["twin"]``, the one-process steps against their fp32
    and ulp twins), an fp64 trainer's within the base limits: the losses,
    each leaf (:func:`update_errors`), the host state (MagicNet's
    histogram, CTAugment's rates); rank 1's weights bitwise rank 0's (their
    digests), and each rank's scan launches. Every trainer is logged
    before a failure is raised."""
    kinds = ("selective_scan_bidir", "selective_scan_bidir_fwd_states",
             "selective_scan_bidir_bwd")
    failed = []
    for i, ((name, kw), want) in enumerate(zip(cases, wants)):
        job = first_job + i
        got = ranks[0][job]
        twin = want.get("twin")
        loss_err, loss_tol = _within(
            np, got["losses"], want["losses"],
            (DP_BF16_LOSS_TOL if twin else DP_FP32_LOSS_TOL)
            * max(abs(v) for v in want["losses"]),
            twin["loss_spread"] if twin else 0.0)
        errs = update_errors(np, got["state"], want, DPM_UPDATE_TOL,
                             twin and twin["spread"])
        ratio, err, update, leaf = errs[0]
        same = all(r[job]["digests"] == got["digests"] for r in ranks[1:])
        host_ok = set(got["host"]) == set(want["host"])
        for k, w in want["host"].items():
            base = (MAGIC_HIST_TOL * w.sum() if k == "hist"
                    else 1e-3 * max(np.abs(w).max(), 1.0))
            e, tol = _within(np, got["host"][k], w, base,
                             twin["host_spread"][k] if twin else 0.0)
            host_ok &= e <= tol
        launched = [r[job]["launches"] for r in ranks]
        log("data_parallel_methods", trainer=name, ranks=PAR_RANKS,
            batch=kw["config"]["batch_size"],
            labeled=kw.get("method_kw", {}).get("labeled_bs", "-"),
            dtype="bf16" if twin else "float64", losses=got["losses"],
            one_process=want["losses"],
            one_process_fp32=twin and twin["losses"],
            loss_err=f"{loss_err:.2e}", loss_tol=f"{loss_tol:.2e}",
            limit_ratio=f"{ratio:.3f}", limit_leaf=leaf,
            update_err=f"{err / update:.3e}",
            leaf_spread=f"{twin['spread'][leaf] / update:.3e}" if twin
            else "-",
            tol=f"{DPM_UPDATE_TOL} of the update"
                + (f" + {DPM_SPREAD_SHARE}x the spread (fp32 twin, "
                   f"{DPM_ULP_TWINS} ulp twins)" if twin else ""),
            replicas_equal=same, host_equal=host_ok,
            launches_per_rank=["/".join(str(n[k]) for k in kinds)
                               for n in launched],
            seconds_per_rank=[f"{r[job]['seconds']:.1f}" for r in ranks],
            one_process_seconds=f"{want['seconds']:.1f}")
        if loss_err > loss_tol:
            failed.append(f"{name}: losses {got['losses']} vs "
                          f"{want['losses']}")
        if ratio > 1.0:
            failed.append(f"{name}: {leaf} is {err:.3e} away, "
                          f"{ratio:.2f} of its limit")
        if not (same and host_ok):
            failed.append(f"{name}: the ranks' weights or host state "
                          f"differ")
        if want["launches"][kinds[1]] and min(n[kinds[1]]
                                              for n in launched) == 0:
            failed.append(f"{name}: a rank ran no scan kernel")
    control = ranks[0][first_job + len(cases)]
    c_err = update_errors(np, control["state"], wants[0], DPM_UPDATE_TOL,
                          wants[0]["twin"]["spread"])
    log("data_parallel_methods", trainer="cross_teaching",
        control="model 2's gradients unreduced",
        limit_ratio=f"{c_err[0][0]:.3f}", limit_leaf=c_err[0][3],
        fails=c_err[0][0] > 1.0)
    if c_err[0][0] <= 1.0:
        failed.append("the unreduced control passes the update check")
    if failed:
        raise AssertionError("data_parallel_methods: " + "; ".join(failed))


def update_errors(np, state, want, tol=1.0, spread=None):
    """[(ratio, error, update, leaf)], worst first: each floating leaf's
    largest distance from the one-process steps' weights (``error``)
    over its limit, ``tol`` x its largest update in those steps
    (``want``'s state minus its start) plus DPM_SPREAD_SHARE x its
    ``spread``. The update is floored at DP_UPDATE_FLOOR of the model's
    largest: a leaf whose gradient is rounding noise (a convolution's
    bias before a BatchNorm) moves by noise alone."""
    moved = want["moved"]
    floor = DP_UPDATE_FLOOR * max(moved.values())
    out = []
    for k, w in want["state"].items():
        err = float(np.abs(state[k] - w).max())
        update = max(moved[k], floor)
        limit = tol * update + DPM_SPREAD_SHARE * (spread or {}).get(k, 0.0)
        out.append((err / limit, err, update, k))
    return sorted(out, reverse=True)


def utils_phase(torch, np, dev):
    """``[utils]``: the train CLI with ``--cfg``/``--opts`` on phantoms, the
    native augmentation built with g++ (bitwise against the Python
    generator), ``model_flops``/``parameter_count`` of ViM_seg at bs24,
    224², a ``profile_trace`` and a fit with ``TrainConfig.tensorboard``."""
    import tempfile

    from mamba_unet_torch.cli import train as train_cli
    from mamba_unet_torch.data import native
    from mamba_unet_torch.data.augment import RandomGenerator
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.ops.selective_scan_bidir import (
        selective_scan_bidir_fwd_states,
    )
    from mamba_unet_torch.train.trainer import TrainConfig, Trainer
    from mamba_unet_torch.utils import experiment, profiling

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        launches = selective_scan_bidir_fwd_states.launches
        t0 = time.perf_counter()
        rc = train_cli.main([
            "--cfg", str(ROOT / "configs/vmamba_tiny.yaml"), "--opts",
            "MODEL.DROP_PATH_RATE", "0.1", "--synthetic", "--bf16",
            "--patch_size", str(PATCH), str(PATCH), "--batch_size", "8",
            "--max_iterations", str(UTILS_ITERS), "--eval_every", "100",
            "--synthetic_spec", "2", "8", "1", "0", str(PATCH),
            "--snapshot_dir", str(tmp / "cfg"), "--device", dev.type])
        n = selective_scan_bidir_fwd_states.launches - launches
        log("utils", cli="--cfg configs/vmamba_tiny.yaml --opts "
            "MODEL.DROP_PATH_RATE 0.1", rc=rc, steps=UTILS_ITERS,
            fwd_states_launches=n, seconds=f"{time.perf_counter() - t0:.1f}")
        if rc != 0 or n != UTILS_ITERS * SS2D_PER_FORWARD:
            raise AssertionError(f"--cfg run: rc {rc}, {n} launches")

        t0 = time.perf_counter()
        lib = native.build()
        gen = native.NativeRandomGenerator((PATCH, PATCH), seed=3)
        py = RandomGenerator((PATCH, PATCH), seed=3)
        r = np.random.default_rng(4)
        for _ in range(8):
            s = {"image": r.random(NATIVE, np.float32),
                 "label": r.integers(0, 4, NATIVE)}
            a, b = gen(s), py(s)
            if not all(np.array_equal(a[k], b[k]) for k in a):
                raise AssertionError("native augmentation differs from the "
                                     "Python generator")
        log("utils", native=lib.relative_to(ROOT), samples=8,
            bitwise_equal=True, seconds=f"{time.perf_counter() - t0:.2f}")

        model = MambaUnet(num_classes=4, generator=torch.Generator()
                          .manual_seed(0)).to(dev).eval()
        x = torch.zeros(TRAIN_BATCH, PATCH, PATCH, 1, device=dev)
        cost = profiling.model_flops(model, x)
        ms = profiling.time_fn(model, x, iters=3)
        log("utils", model="ViM_seg", batch=TRAIN_BATCH, patch=PATCH,
            params=profiling.parameter_count(model),
            forward_gflops=f"{cost['flops'] / 1e9:.1f}",
            scan_gflops=f"{cost['scan_flops'] / 1e9:.1f}",
            scan_share=f"{cost['scan_flops'] / cost['flops']:.3f}",
            forward_ms=f"{ms:.2f}")
        with profiling.profile_trace(str(tmp / "trace")):
            with torch.no_grad():
                model(x)
        table = (tmp / "trace/key_averages.txt").read_text()
        log("utils", profile_trace=(tmp / "trace/trace.json").is_file(),
            cuda_rows="selective_scan" in table)
        del model

        r = np.random.default_rng(5)
        batches = [{"image": torch.as_tensor(r.random((4, PATCH, PATCH, 1),
                                                      np.float32)),
                    "label": torch.as_tensor(r.integers(0, 4, (4, PATCH,
                                                               PATCH)))}
                   for _ in range(2)]
        cfg = TrainConfig(max_iterations=2, batch_size=4,
                          patch_size=(PATCH, PATCH), log_every=1,
                          snapshot_dir=str(tmp / "tb"), tensorboard=True)
        from mamba_unet_torch.models.unet import UNet

        Trainer(UNet(num_classes=4), cfg, device=dev).fit(batches)
        records = experiment.read_scalars(str(tmp / "tb/log"))
        events = [p.name for p in (tmp / "tb/log").iterdir()
                  if p.name.startswith("events")]
        log("utils", tensorboard_scalars=len(records),
            event_file=bool(events), steps=[rec["step"] for rec in records])
        if len(records) != 2:
            raise AssertionError(f"tensorboard scalars: {records}")


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
    # under AdamW
    torch.cuda.empty_cache()
    weak_launches, *_ = weak_scribble_phase(torch, dev)
    phase_done("weak_scribble")
    torch.cuda.empty_cache()
    import tempfile

    snaps = tempfile.TemporaryDirectory(dir=ROOT / "build")
    vim_snap, mad_snap, ft_snap = (Path(snaps.name, n)
                                   for n in ("vim", "mad", "ft"))
    trainability_phase(torch, dev, vim_snap)
    phase_done("trainability")

    # --- contrastive consistency and the mask model's pretraining: the
    # kernels at the location pass's cube shapes, the three fits, the CLIs
    torch.cuda.empty_cache()
    cube_errs = cc_kernel_shapes_phase(torch, dev)
    phase_done("cc_kernel_shapes")
    torch.cuda.empty_cache()
    cc_launches, *_ = contrastive_consistency_phase(torch, dev)
    torch.cuda.empty_cache()
    mask_launches, *_ = mask_pretrain_phase(torch, dev)
    torch.cuda.empty_cache()
    cc_mask_launches, *_ = cc_mask_phase(torch, dev)
    torch.cuda.empty_cache()
    phase_done("contrastive_consistency, mask_pretrain, cc_mask")
    cc_entry_points_phase(torch, np, dev)
    phase_done("entry_points: contrastive_consistency, mask_pretrain")

    # --- MagicNet: on MambaUnetMask without and with --mask_recovery, the
    # 3-D VNet on BTCV phantoms, the CLIs
    torch.cuda.empty_cache()
    magic_launches, *_ = magicnet_phase(torch, dev, False)
    torch.cuda.empty_cache()
    magic_mask_launches, *_ = magicnet_phase(torch, dev, True)
    torch.cuda.empty_cache()
    phase_done("magicnet_mamba, magicnet_mask")
    magicnet_3d_phase(torch, dev)
    torch.cuda.empty_cache()
    phase_done("magicnet_3d")
    magic_entry_points_phase(torch, np, dev)
    phase_done("entry_points: magicnet")

    # --- the Mamba-LM remainders: bf16 compute, exported generation
    _, lm_model = seeded_lm(torch, dev)
    lm_model.eval()
    lm_later = lm_bf16_phase(torch, dev, lm_model)
    phase_done("lm_bf16")
    del lm_model
    lm_later += lm_export_phase(torch, dev)
    torch.cuda.empty_cache()
    phase_done("lm_export")

    # --- MAD: the denoiser's pretraining, the stacked fine-tuning (warm-
    # started from [trainability]'s ViM_seg and the pretraining's best),
    # the stacked test CLI
    mad_pretrain_phase(torch, mad_snap)
    torch.cuda.empty_cache()
    phase_done("mad_pretrain")
    mad_launches, *_ = mad_finetune_phase(torch, vim_snap, mad_snap, ft_snap)
    torch.cuda.empty_cache()
    phase_done("mad_finetune")
    mad_test_launches = mad_test_phase(torch, ft_snap, mad_snap)
    snaps.cleanup()
    phase_done("mad_test")

    # --- the rest of the zoo: the 2-D models through the train CLI, the
    # 3-D ones a step each, SegMamba on the grouped kernels
    zoo_2d_phase(torch, dev)
    torch.cuda.empty_cache()
    phase_done("zoo_2d")
    zoo_3d_phase(torch, dev)
    phase_done("zoo_3d")
    seg_errs, _ = segmamba_kernel_phase(torch, dev)
    phase_done("segmamba_kernel")
    seg_launches = segmamba_phase(torch, dev)
    phase_done("segmamba")

    # --- the parallelism slice: the grouped kernels' carry variants, the
    # sharded scans, the pipeline and data parallelism on gloo ranks
    # sharing card 0, then the utilities
    torch.cuda.empty_cache()
    carry_kernels = scan_carry_kernel_phase(torch, dev)
    phase_done("scan_carry_kernel")
    utils_phase(torch, np, dev)
    torch.cuda.empty_cache()
    phase_done("utils")

    # the steps card vs CPU: last, as their CPU backwards would share the
    # host with a timed phase; they print no times, so the gloo ranks of
    # the parallel phases and their one-process reference run beside them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    started = start_parallel(np)
    weak_parity_phase(torch, dev)
    phase_done("weak_parity")
    cc_parity_phase(torch, dev)
    phase_done("cc_parity")
    magicnet_parity_phase(torch, dev)
    phase_done("magicnet_parity")
    mad_parity_phase(torch, dev)
    phase_done("mad_parity")
    zoo3d_parity_phase(torch, dev)
    phase_done("zoo3d_parity")
    segmamba_parity_phase(torch, dev)
    phase_done("segmamba_parity")
    carry_launches = parallel_phases(np, started)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    phase_done("seq_parallel, tp_parallel, pipeline, data_parallel, "
               "data_parallel_methods (collected)")

    serve_bound = sum(calls * scan_bound("fwd", SERVE_BATCH, L, dg, 4)[0]
                      for L, dg, calls in STAGES)
    pallas = "mamba_unet_tpu/ops/selective_scan_pallas.py"
    # the bidir kernels' launches: their main path's run plus the weak
    # trio's (model 3), the contrastive pair's, the mask pretraining's, the
    # mask variant's, MagicNet's without and with --mask_recovery, the MAD
    # fine-tuning's and the stacked test CLI's
    later = [sum(t) for t in zip(weak_launches, cc_launches, mask_launches,
                                 cc_mask_launches, magic_launches,
                                 magic_mask_launches, mad_launches,
                                 (mad_test_launches, 0, 0))]
    rows = [dict(name="selective_scan_bidir_fwd",
                 launches=launches + later[0],
                 max_abs_err=max_err, ms=ms_fwd, plain_ms=plain_ms_fwd,
                 bound_ms=serve_bound,
                 bound_by=scan_bound("fwd", SERVE_BATCH, 3136, 192, 4)[1],
                 source="mamba_unet_torch/csrc/selective_scan_bidir_fwd.cu",
                 replaces=("mamba_unet_tpu/ops/selective_scan_persistent.py"
                           f":130, {pallas}:229"))]
    for kernel, kind, n, src, where in (
            ("selective_scan_bidir_fwd_states", "fwd_states",
             train_fwd + later[1], "selective_scan_bidir_fwd.cu",
             f"{pallas}:238"),
            ("selective_scan_bidir_bwd", "bwd", train_bwd + later[2],
             "selective_scan_bidir_bwd.cu", f"{pallas}:318")):
        err, ms, plain, bound, by = train_kernels[kind]
        err = max(err, cube_errs[kind])
        rows.append(dict(name=kernel, launches=n, max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=bound, bound_by=by,
                         source=f"mamba_unet_torch/csrc/{src}",
                         replaces=where))
    ms, plain, bound, by = lm_times["scoring"]
    # the grouped kernels' launches: the LM's and the tm branch's runs
    # plus SegMamba's forward and training step
    rows.append(dict(name="selective_scan_fwd",
                     launches=lm_launches + lm_later + seg_launches[0],
                     max_abs_err=max(lm_err, seg_errs["serve"]),
                     ms=LM_DEPTH * ms,
                     plain_ms=LM_DEPTH * plain, bound_ms=LM_DEPTH * bound,
                     bound_by=by,
                     source="mamba_unet_torch/csrc/selective_scan_fwd.cu",
                     replaces=f"{pallas}:229 (unidirectional)"))
    for kernel, kind, n, src, where in (
            ("selective_scan_fwd_states", "fwd_states",
             tm_fwd + seg_launches[1], "selective_scan_fwd.cu",
             f"{pallas}:229 (unidirectional, save_cs: _scan_core_fwd :586)"),
            ("selective_scan_bwd", "bwd", tm_bwd + seg_launches[2],
             "selective_scan_bwd.cu",
             f"{pallas}:318 (unidirectional: _scan_core_bwd :701)")):
        err, ms, plain, bound, by = tm_kernels[kind]
        err = max(err, seg_errs[kind])
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
    # the carry variants, launched by the sequence- and channel-parallel
    # ranks and the pipeline's
    xla = "mamba_unet_tpu/ops/selective_scan.py:174 (selective_scan_xla's x_init)"
    for kernel, kind, counter, src, where in (
            ("selective_scan_fwd (x_init, last state)", "serve",
             "selective_scan_grouped", "selective_scan_fwd.cu",
             f"{pallas}:229 (unidirectional), {xla}"),
            ("selective_scan_fwd_states (x_init, last state)", "fwd_states",
             "selective_scan_grouped_fwd_states", "selective_scan_fwd.cu",
             f"{pallas}:229 (unidirectional, save_cs), {xla}"),
            ("selective_scan_bwd (g_last, dx_init)", "bwd",
             "selective_scan_grouped_bwd", "selective_scan_bwd.cu",
             f"{pallas}:318 (unidirectional), {xla}")):
        err, ms, plain, bound, by = carry_kernels[kind]
        if carry_launches[counter] == 0:
            raise AssertionError(f"{kernel}: no launch on the parallel paths")
        rows.append(dict(name=kernel, launches=carry_launches[counter],
                         max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=bound, bound_by=by,
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
