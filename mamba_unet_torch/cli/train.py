"""Training CLI for the PyTorch port.

Port of ``mamba_unet_tpu/cli/train.py`` for ``--method fully_supervised``,
``mean_teacher``, ``uamt``, ``cross_teaching`` (Semi-Mamba-UNet),
``weak_scribble`` (Weak-Mamba-UNet), ``contrastive_consistency``,
``mask_pretrain``, ``magicnet``, ``mad_pretrain`` and ``mad_finetune``:
every method of the JAX CLI. Its models are the registry's
(``models/registry.py``): on ACDC slices ``ViM_seg``/``mambaunet``, the
UNet family (``unet``, ``unet_ds``, ``unet_urpc``, ``unet_cct``,
``TLunet``), ``ViT_seg`` (Swin-UNet), ``MambaUnetMask``, ``vnet``,
``magicnet_2D``, ``magicnet_2D_mask``, ``enet``, ``efficient_unet`` and
``preUnet``; on BTCV volumes ``vnet_3D`` and ``magicnet``. With that CLI's
flags for these paths plus ``--device`` (default ``cuda``; it raises when
there is no card rather than run on the CPU). ``--model`` defaults to
``unet``, as there. The
semi-supervised methods draw two-stream batches: ``--batch_size -
--labeled_bs`` unlabeled slices after ``--labeled_bs`` labeled ones, the
labeled set being the first ``--labeled_slices`` slices, else a quarter of
a synthetic set, else the slices of ``--labeled_num`` ACDC patients.
``cross_teaching`` trains a second model, ``--model2`` (default:
``--model``), initialized from ``--seed + 1``. ``weak_scribble`` trains
``--model``, ``--model2`` (default ``ViT_seg``) and ``--model3`` (default
``ViM_seg``), initialized from ``--seed``, ``+ 1`` and ``+ 2``, on
shuffled batches whose label is the scribble (4 = unlabeled; rotation
fills the corners with it), validated on the dense labels;
``--weak_pce_only`` drops its pseudo-label Dice.
``contrastive_consistency`` trains ``--model`` and a second model
(``--model2``, default ``--model``, from ``--seed + 1``) with their
projectors on two-stream batches of CTAugment views (``CTAugment`` and
``CTATransform`` seeded with ``--seed``; the learned rates are written
to ``cta_state.json`` beside each periodic checkpoint and read back on
``--resume``). ``mask_pretrain`` pretrains a ``MambaUnetMask`` without
labels on shuffled batches (cubes of ``--cube_size``, ``--masked_rate``
of them masked). ``magicnet`` trains a MagicNet model (``magicnet_2D``,
``magicnet_2D_mask`` or ``MambaUnetMask`` on ACDC's two-stream slices;
``magicnet`` with ``--dataset btcv``) with its EMA teacher, cubes of
``--cube_size``; ``--mask_recovery`` adds the shuffle and mask recovery
losses and needs a model with the mix-out head (``MambaUnetMask``,
``magicnet_2D_mask``: another raises ``ValueError``, where the JAX CLI
fails with an ``AttributeError``). With any other method the flag raises
(the JAX CLI ignores it there; the contrastive trainer's mask variant is
reached through its Python API). ``mad_pretrain`` trains ``--model``
(built with ``--num_classes`` input channels) to denoise corrupted
near-one-hot labels (``MADPretrainTransform``, one-hot epsilon
``--image_noise``), validated on corrupted val labels; ``mad_finetune``
trains ``--model`` with two ``--mad_model`` denoisers (from ``--seed + 1``
and ``+ 2``) on ``MADFineTuneTransform`` batches, validated stacked, the
best trio saved as ``best``/``best2``/``best3`` (seg, mad, den);
``--seg_ckpt`` warm-starts the segmenter and ``--mad_ckpt`` both
denoisers from a snapshot directory of this port (its newest ``best``,
else its newest periodic checkpoint's model). ``--dataset btcv`` is the 3-D MagicNet
pipeline of the reference's BTCV script: ``--method magicnet --model
magicnet`` and three ``--patch_size`` ints (else it raises, as JAX
asserts), volumes from ``--root_path`` (``train.list``, ``val.list``,
``data/*.h5``) or, with ``--synthetic``, 12 + 1 in-memory organ phantoms
of side ``--patch_size[0]`` (``data.synthetic.phantom_btcv``, 14
classes), random crops to the patch, two-stream batches whose labeled set
is the first third of the volumes with ``--synthetic`` (at least 2), else
the first ``--labeled_num``; sliding-window validation every
``--eval_every`` and at the end on the saved ``best`` model, whose
(cases, classes - 1, 4) [dice, hd95, nsd, asd] array is written to
``--snapshot_dir``/``metric_final.npy``. ``scan_impl`` and ``drop_path``
reach only the models that take them; ``ViT_seg`` and ``MambaUnetMask``
are built for ``--patch_size``, the MagicNet models for ``--patch_size``
and ``--cube_size``. Every method
trains under ``--optimizer`` (the JAX CLI gives ``mask_pretrain`` its
default poly-SGD whatever the flag says).
``--synthetic`` trains on in-memory phantom slices
(``data.synthetic.phantom_acdc``; ``--synthetic_hard`` the hard phantom)
instead of writing an h5 set. ``--scan_impl`` picks SS2D's scan branch:
``auto``/``bidir`` (the bidirectional kernels), ``tm``/``pallas`` (the
time-major grouped ones), ``folded`` (the batch-folded ones, at every
batch) or ``xla`` (the JAX route's name for the tm branch's function;
the port runs it as the tm branch). ``--pretrained_ckpt`` warm-starts from
an upstream torch ``.pth`` (``utils.convert.load_upstream_state``, decoder
mirrored from the encoder) into ``ViM_seg`` or ``ViT_seg``: the first
model of a multi-model method, and the second of ``cross_teaching`` and
``contrastive_consistency`` when it takes the warm start too (the
reference's scripts load it into both networks; the JAX CLI into the
first only). ``--exp`` is accepted and stored for
command-line compatibility with the JAX CLI, which reads it nowhere else
either. Activation recomputation (``use_remat``) is a model option, as in
the JAX package, and has no flag. ``--cfg`` builds the first model from a
yaml config (``configs/*.yaml``, ``utils/config.py``) instead of
``--model``, with ``--opts KEY VALUE`` overrides (``--drop_path`` still
overrides the config's rate). Launched by ``torchrun`` with more than one
rank, the CLI joins a process group (``nccl``, one card per rank; ``gloo``
with ``--device cpu``) and every method runs data parallel over all
ranks: each step's global batch is split over them, each block of it
(the labeled and the unlabeled rows of a two-stream batch) evenly
(``train/trainer.py``; a block that does not split raises), and rank 0
validates and writes the checkpoints (the 3-D pipeline's final
validation too).

    python -m mamba_unet_torch.cli.train --model ViM_seg \\
        --root_path ../data/ACDC --patch_size 224 224 --batch_size 24 \\
        --bf16 --snapshot_dir snap
    python -m mamba_unet_torch.cli.train --model ViM_seg --scan_impl tm \\
        --bf16 --patch_size 224 224 --batch_size 24
    python -m mamba_unet_torch.cli.train --model ViM_seg \\
        --scan_impl folded --bf16 --patch_size 224 224 --batch_size 24
    python -m mamba_unet_torch.cli.train --model ViM_seg --synthetic \\
        --device cpu --patch_size 32 32 --batch_size 4 --max_iterations 4 \\
        --eval_every 2
    python -m mamba_unet_torch.cli.train --cfg configs/vmamba_tiny.yaml \\
        --opts MODEL.DROP_PATH_RATE 0.1 --synthetic --patch_size 224 224
    torchrun --nproc_per_node 2 -m mamba_unet_torch.cli.train --model unet \\
        --synthetic --device cpu --patch_size 32 32 --batch_size 4
    torchrun --nproc_per_node 2 -m mamba_unet_torch.cli.train \\
        --method cross_teaching --model ViM_seg --model2 unet --bf16 \\
        --patch_size 224 224 --batch_size 24 --labeled_bs 8
    python -m mamba_unet_torch.cli.train --method cross_teaching \\
        --model ViM_seg --model2 unet --bf16 --patch_size 224 224
    python -m mamba_unet_torch.cli.train --method weak_scribble \\
        --synthetic --bf16 --patch_size 224 224 --batch_size 24
    python -m mamba_unet_torch.cli.train --method contrastive_consistency \\
        --model ViM_seg --synthetic --bf16 --patch_size 224 224
    python -m mamba_unet_torch.cli.train --method mask_pretrain \\
        --model MambaUnetMask --synthetic --bf16 --patch_size 224 224
    python -m mamba_unet_torch.cli.train --method magicnet \\
        --model MambaUnetMask --mask_recovery --synthetic --bf16 \\
        --patch_size 224 224
    python -m mamba_unet_torch.cli.train --method mad_pretrain --model unet \\
        --synthetic --bf16 --patch_size 224 224 --snapshot_dir mad
    python -m mamba_unet_torch.cli.train --method mad_finetune \\
        --model ViM_seg --mad_model unet --seg_ckpt vim --mad_ckpt mad \\
        --synthetic --bf16 --patch_size 224 224 --snapshot_dir ft
    python -m mamba_unet_torch.cli.train --dataset btcv --method magicnet \\
        --model magicnet --synthetic --patch_size 96 96 96 \\
        --num_classes 14 --batch_size 4 --labeled_bs 2 --cube_size 32 \\
        --snapshot_dir snap
"""

from __future__ import annotations

import argparse
import logging
import sys

PORTED_METHODS = ("fully_supervised", "mean_teacher", "uamt",
                  "cross_teaching", "weak_scribble",
                  "contrastive_consistency", "mask_pretrain", "magicnet",
                  "mad_pretrain", "mad_finetune")
# the methods that train on two-stream (labeled, then unlabeled) batches
TWO_STREAM_METHODS = ("mean_teacher", "uamt", "cross_teaching",
                      "contrastive_consistency", "magicnet")
# the models that --pretrained_ckpt warm-starts (their network's root:
# mamba_unet, swin_unet)
WARM_START_MODELS = ("ViM_seg", "mambaunet", "ViT_seg")
MODELS = ("ViM_seg", "mambaunet", "unet", "unet_ds", "unet_urpc", "unet_cct",
          "TLunet", "ViT_seg", "MambaUnetMask", "vnet", "vnet_3D", "magicnet",
          "magicnet_2D", "magicnet_2D_mask", "enet", "efficient_unet",
          "preUnet")
# the models with the mix-out head that --mask_recovery trains
MIX_HEAD_MODELS = ("MambaUnetMask", "magicnet_2D_mask")
# the BTCV phantoms' classes (the JAX CLI's make_synthetic_btcv default)
BTCV_SYNTHETIC_CLASSES = 14


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Mamba-UNet training (PyTorch)")
    p.add_argument("--root_path", type=str, default="../data/ACDC")
    p.add_argument("--exp", type=str, default="ACDC/Fully_Supervised",
                   help="experiment name, accepted for command-line "
                        "compatibility with the JAX CLI (stored; nothing "
                        "reads it)")
    p.add_argument("--dataset", type=str, default="acdc",
                   choices=["acdc", "btcv"],
                   help="acdc = the 2-D slice pipeline; btcv = the 3-D "
                        "volume pipeline (--method magicnet)")
    p.add_argument("--model", type=str, default="unet", choices=MODELS)
    p.add_argument("--cfg", type=str, default=None,
                   help="yaml model config (configs/*.yaml): builds the "
                        "first model from it instead of --model")
    p.add_argument("--opts", nargs="*", default=None,
                   help="config overrides: KEY VALUE pairs")
    p.add_argument("--method", type=str, default="fully_supervised")
    p.add_argument("--max_iterations", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("--labeled_bs", type=int, default=8,
                   help="labeled slices per batch (semi-supervised methods)")
    p.add_argument("--labeled_num", type=int, default=140,
                   help="labeled ACDC patients (semi-supervised methods)")
    p.add_argument("--labeled_slices", type=int, default=None,
                   help="fully_supervised: train on the first N slices only "
                        "(the labeled-only baseline of the semi-supervised "
                        "tables); semi-supervised: the first N slices are "
                        "the labeled ones")
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=["sgd", "adamw"],
                   help="sgd = poly-SGD; adamw = warm-up AdamW for training "
                        "from scratch")
    p.add_argument("--weight_decay", type=float, default=None,
                   help="default: 1e-4 (sgd) / 0.05 (adamw)")
    p.add_argument("--model2", type=str, default=None, choices=MODELS,
                   help="the second model: cross_teaching's and "
                        "contrastive_consistency's (default: --model) and "
                        "weak_scribble's (default: ViT_seg)")
    p.add_argument("--model3", type=str, default=None, choices=MODELS,
                   help="weak_scribble's third model (default: ViM_seg)")
    p.add_argument("--weak_pce_only", action="store_true",
                   help="weak_scribble ablation: the scribble pCE alone, "
                        "no pseudo-label Dice")
    p.add_argument("--cube_size", type=int, default=32,
                   help="mask_pretrain's and magicnet's cube side "
                        "(MambaUnetMask: a multiple of 32; the VNets: of "
                        "16)")
    p.add_argument("--masked_rate", type=float, default=0.25,
                   help="mask_pretrain and magicnet --mask_recovery: the "
                        "share of cubes masked")
    p.add_argument("--mask_recovery", action="store_true",
                   help="magicnet: add the shuffle and mask recovery "
                        "losses (a model with forward_mix_pos_mask: "
                        "MambaUnetMask, magicnet_2D_mask)")
    p.add_argument("--patch_size", type=int, nargs="+", default=[256, 256],
                   help="2 ints (acdc) or 3 (btcv)")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--eval_every", type=int, default=200)
    p.add_argument("--consistency", type=float, default=0.1)
    p.add_argument("--consistency_rampup", type=float, default=200.0)
    p.add_argument("--snapshot_dir", type=str, default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest periodic checkpoint in "
                        "--snapshot_dir")
    p.add_argument("--ckpt_every", type=int, default=3000,
                   help="periodic (resumable) checkpoint cadence")
    p.add_argument("--grad_accum_steps", type=int, default=1,
                   help="microbatches per optimizer update")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 autocast compute (weights stay fp32)")
    p.add_argument("--scan_impl", type=str, default="auto",
                   choices=["auto", "bidir", "tm", "pallas", "xla", "folded"],
                   help="SS2D scan path (default auto = the bidirectional "
                        "kernels; tm/pallas = the time-major grouped ones; "
                        "folded = the batch-folded ones; xla = the tm "
                        "branch, as the JAX route computes its function)")
    p.add_argument("--drop_path", type=float, default=None,
                   help="stochastic depth rate of ViM_seg/ViT_seg (model "
                        "default 0.2)")
    p.add_argument("--pretrained_ckpt", type=str, default=None,
                   help="upstream torch .pth to warm-start ViM_seg or "
                        "ViT_seg from")
    p.add_argument("--mad_model", type=str, default="unet", choices=MODELS,
                   help="mad_finetune's denoiser (two of them are trained)")
    p.add_argument("--seg_ckpt", type=str, default=None,
                   help="mad_finetune: a snapshot directory to warm-start "
                        "the segmenter from (newest best, else newest "
                        "periodic checkpoint)")
    p.add_argument("--mad_ckpt", type=str, default=None,
                   help="mad_finetune: a snapshot directory to warm-start "
                        "both denoisers from (e.g. a mad_pretrain run's)")
    p.add_argument("--image_noise", type=float, default=1e-3,
                   help="the one-hot epsilon of MAD's label corruption")
    p.add_argument("--synthetic", action="store_true",
                   help="train on in-memory phantom slices")
    p.add_argument("--synthetic_hard", action="store_true",
                   help="the discriminating phantom (wobbly boundaries, "
                        "distractors, bias field, apical no-RV slices)")
    p.add_argument("--synthetic_spec", type=int, nargs=5, default=None,
                   metavar=("CASES", "SLICES", "VAL", "TEST", "SIZE"),
                   help="phantom scale: train cases, slices per case, val "
                        "volumes, test volumes, native slice size (default "
                        "8 8 2 0 <patch>)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def _make_optimizer(args):
    """--optimizer -> ``params -> (optimizer, scheduler)``."""
    from mamba_unet_torch.train.optim import poly_sgd, warmup_adamw

    if args.optimizer == "adamw":
        wd = 0.05 if args.weight_decay is None else args.weight_decay
        return lambda params: warmup_adamw(params, args.base_lr,
                                           args.max_iterations,
                                           weight_decay=wd)
    wd = 1e-4 if args.weight_decay is None else args.weight_decay
    return lambda params: poly_sgd(params, args.base_lr, args.max_iterations,
                                   weight_decay=wd)


def _model_kwargs(args, name: str, seed: int) -> dict:
    """net_factory keywords of model ``name``: ``scan_impl``, ``drop_path``
    and the sizes only where the model takes them."""
    import torch

    from mamba_unet_torch.models.registry import (
        DROP_PATH_MODELS,
        SCAN_MODELS,
        size_kwargs,
    )

    kw = {"num_classes": args.num_classes,
          "generator": torch.Generator().manual_seed(seed),
          **size_kwargs(name, args.patch_size[0], args.cube_size)}
    if name in SCAN_MODELS:
        kw["scan_impl"] = args.scan_impl
    if name in DROP_PATH_MODELS and args.drop_path is not None:
        kw["drop_path_rate"] = args.drop_path
    return kw


def _check_args(args) -> None:
    """Raise on a combination the pipelines do not run, before any data is
    loaded."""
    from mamba_unet_torch.models.registry import VOLUME_MODELS

    if args.method not in PORTED_METHODS:
        raise ValueError(
            f"unknown --method {args.method}; one of "
            f"{', '.join(PORTED_METHODS)}")
    if args.mask_recovery and args.method != "magicnet":
        raise NotImplementedError(
            f"--mask_recovery acts only with --method magicnet (the JAX CLI "
            f"ignores it with --method {args.method}); the contrastive "
            f"trainer's mask variant is reached through "
            f"ContrastiveConsistencyTrainer(mask_recovery=True)")
    if args.mask_recovery and args.model not in MIX_HEAD_MODELS:
        raise ValueError(
            f"--mask_recovery needs a model with the mix-out head "
            f"(forward_mix_pos_mask): {', '.join(MIX_HEAD_MODELS)}, not "
            f"{args.model}")
    if args.dataset == "btcv":
        if args.method != "magicnet" or len(args.patch_size) != 3:
            raise ValueError(
                "--dataset btcv drives the 3-D MagicNet pipeline: pass "
                "--method magicnet --model magicnet and three --patch_size "
                "ints")
    elif len(args.patch_size) != 2:
        raise ValueError(f"--dataset acdc trains on slices: two "
                         f"--patch_size ints, not {args.patch_size}")
    if (args.model in VOLUME_MODELS) != (args.dataset == "btcv"):
        raise ValueError(f"--model {args.model} does not fit --dataset "
                         f"{args.dataset}")


def _train_btcv(args, cfg, device) -> int:
    """The 3-D MagicNet pipeline (``--dataset btcv``)."""
    from mamba_unet_torch.data.btcv import (
        Compose3D,
        RandomCrop3D,
        VolumeTrainDataset,
    )
    from mamba_unet_torch.data.loader import Loader
    from mamba_unet_torch.data.sampler import TwoStreamBatchSampler
    from mamba_unet_torch.data.synthetic import phantom_btcv
    from mamba_unet_torch.models import net_factory
    from mamba_unet_torch.train import MagicNetTrainer

    transform = Compose3D([RandomCrop3D(cfg.patch_size, seed=args.seed)])
    if args.synthetic:
        splits = phantom_btcv(12, 1, args.patch_size[0],
                              BTCV_SYNTHETIC_CLASSES)
        train_ds = VolumeTrainDataset.from_samples(splits["train"],
                                                   transform=transform)
        val_ds = VolumeTrainDataset.from_samples(splits["val"])
        n_labeled = max(2, len(train_ds) // 3)
    else:
        train_ds = VolumeTrainDataset(args.root_path, "train.list",
                                      transform=transform)
        val_ds = VolumeTrainDataset(args.root_path, "val.list")
        n_labeled = min(args.labeled_num, len(train_ds) - 1)
    sampler = TwoStreamBatchSampler(
        range(n_labeled), range(n_labeled, len(train_ds)), cfg.batch_size,
        cfg.batch_size - args.labeled_bs, seed=args.seed)
    model = net_factory(args.model, **_model_kwargs(args, args.model,
                                                    args.seed))
    trainer = MagicNetTrainer(
        model, cfg, labeled_bs=args.labeled_bs, cube_size=args.cube_size,
        mask_recovery=args.mask_recovery, masked_rate=args.masked_rate,
        make_optimizer=_make_optimizer(args), device=device)
    result = trainer.fit(Loader(train_ds, sampler, device=device), val_ds)
    logging.info("done: %d iterations, best val dice %.4f",
                 result["iterations"], result["best_dice"])
    # the reference's end of run: the saved best model over the val
    # volumes, the metric array beside the snapshot (rank 0's)
    if trainer.is_main:
        trainer.final_validation(val_ds)
    return 0


def _mad_finetune_trainer(args, model, cfg, **kw):
    """``model`` and two ``--mad_model`` denoisers (``--num_classes`` input
    channels, from ``--seed + 1`` and ``+ 2``; no ``--scan_impl`` or
    ``--drop_path``, as the JAX CLI builds them), warm-started from
    ``--seg_ckpt`` and ``--mad_ckpt``."""
    from mamba_unet_torch.models import net_factory
    from mamba_unet_torch.models.registry import size_kwargs
    from mamba_unet_torch.train import MADFineTuneTrainer

    def denoiser(seed):
        import torch

        return net_factory(
            args.mad_model, num_classes=args.num_classes,
            in_chans=args.num_classes,
            generator=torch.Generator().manual_seed(seed),
            **size_kwargs(args.mad_model, args.patch_size[0],
                          args.cube_size))

    mad_model, den_model = denoiser(args.seed + 1), denoiser(args.seed + 2)
    if args.seg_ckpt:
        _warm_start(model, args.seg_ckpt)
    if args.mad_ckpt:
        _warm_start(mad_model, args.mad_ckpt)
        _warm_start(den_model, args.mad_ckpt)
    return MADFineTuneTrainer(model, cfg, mad_model=mad_model,
                              den_model=den_model, **kw)


def _warm_start(model, ckpt_dir: str) -> None:
    """Load the newest ``best`` checkpoint of the snapshot directory
    ``ckpt_dir`` into ``model``, else the model of its newest periodic
    checkpoint (:func:`utils.checkpoint._snapshot_state`), as the JAX CLI's
    ``_warm`` does; a warning when there is neither."""
    from mamba_unet_torch.utils.checkpoint import _snapshot_state

    try:
        model.load_state_dict(_snapshot_state(ckpt_dir, None, "cpu"))
    except FileNotFoundError:
        logging.warning("no checkpoint found in %s", ckpt_dir)
        return
    logging.info("warm-start from %s", ckpt_dir)


def _init_process_group(device: str):
    """Under ``torchrun`` (``WORLD_SIZE`` > 1): join the process group,
    ``nccl`` with one card per rank (``LOCAL_RANK``), ``gloo`` on the CPU;
    returns the rank's device. Otherwise ``device`` as given."""
    import os

    import torch
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl")
        return f"cuda:{local}"
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    return device


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S", stream=sys.stdout)
    _check_args(args)
    args.device = _init_process_group(args.device)
    try:
        return _main(args)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _main(args) -> int:
    if args.pretrained_ckpt and args.model not in WARM_START_MODELS:
        raise NotImplementedError(
            f"--pretrained_ckpt warm-starts {', '.join(WARM_START_MODELS)}; "
            f"the {args.model} warm start is not ported yet")
    from mamba_unet_torch.nn.ss2d import check_scan_impl

    check_scan_impl(args.scan_impl)  # before any data is loaded

    from mamba_unet_torch.data.acdc import (
        SliceDataset,
        VolumeDataset,
        patients_to_slices,
    )
    from mamba_unet_torch.data.augment import RandomGenerator
    from mamba_unet_torch.data.loader import Loader
    from mamba_unet_torch.data.sampler import (
        EpochShuffleSampler,
        TwoStreamBatchSampler,
    )
    from mamba_unet_torch.data.synthetic import phantom_acdc
    from mamba_unet_torch.models import net_factory
    from mamba_unet_torch.train import (
        ContrastiveConsistencyTrainer,
        MADPretrainTrainer,
        MagicNetTrainer,
        MaskPretrainTrainer,
        TrainConfig,
        Trainer,
        WeakScribbleTrainer,
        build_semi_method,
    )
    from mamba_unet_torch.utils.device import require_device

    device = require_device(args.device)
    weak = args.method == "weak_scribble"
    semi = args.method in TWO_STREAM_METHODS
    cfg = TrainConfig(
        base_lr=args.base_lr, max_iterations=args.max_iterations,
        batch_size=args.batch_size, patch_size=tuple(args.patch_size),
        num_classes=args.num_classes, eval_every=args.eval_every,
        seed=args.seed, snapshot_dir=args.snapshot_dir, resume=args.resume,
        ckpt_every=args.ckpt_every, grad_accum_steps=args.grad_accum_steps,
        bf16=args.bf16,
    )
    if args.dataset == "btcv":
        return _train_btcv(args, cfg, device)
    # weak_scribble trains on the scribbles, which rotation pads with the
    # ignore index; val keeps the dense labels
    sup_type = "scribble" if weak else "label"
    cta = None
    if args.method == "contrastive_consistency":
        from mamba_unet_torch.data.cta_transform import CTATransform
        from mamba_unet_torch.data.ctaugment import CTAugment

        cta = CTAugment(seed=args.seed)
        transform = CTATransform(cfg.patch_size, cta, seed=args.seed)
    elif args.method in ("mad_pretrain", "mad_finetune"):
        from mamba_unet_torch.data.mad_augment import (
            MADFineTuneTransform,
            MADPretrainTransform,
        )

        cls = (MADPretrainTransform if args.method == "mad_pretrain"
               else MADFineTuneTransform)
        transform = cls(cfg.patch_size, num_classes=args.num_classes,
                        error_val=args.image_noise, seed=args.seed)
    else:
        transform = RandomGenerator(cfg.patch_size, seed=args.seed,
                                    label_cval=args.num_classes if weak
                                    else 0)
    # the semi-supervised methods train on every slice; --labeled_slices
    # marks their labeled ones instead of cutting the set
    n_sup = (args.labeled_slices if args.method == "fully_supervised"
             else None)
    if args.synthetic:
        cases, slices, n_val, n_test, size = (
            args.synthetic_spec or [8, 8, 2, 0, args.patch_size[0]])
        splits = phantom_acdc(cases, slices, n_val, n_test, size,
                              hard=args.synthetic_hard, scribble=weak)
        train = splits["train"][:n_sup]
        train_ds = SliceDataset.from_samples(train, transform=transform,
                                             sup_type=sup_type)
        val_ds = splits["val"]
    else:
        train_ds = SliceDataset(args.root_path, num=n_sup,
                                transform=transform, sup_type=sup_type)
        val_ds = VolumeDataset(args.root_path, "val")

    model_kw = _model_kwargs(args, args.model, args.seed)
    if args.method == "mad_pretrain":
        # the denoiser eats near-one-hot label stacks
        model_kw["in_chans"] = args.num_classes
    if args.cfg:
        from mamba_unet_torch.utils.config import (
            build_model_from_config,
            get_config,
        )

        cfg_model = get_config(args.cfg, args.opts)
        model = build_model_from_config(
            cfg_model, num_classes=args.num_classes,
            img_size=args.patch_size[0], drop_path_rate=args.drop_path,
            generator=model_kw["generator"],
            **({"scan_impl": args.scan_impl}
               if cfg_model.MODEL.TYPE == "vssm" else {}))
    else:
        model = net_factory(args.model, **model_kw)
    make_optimizer = _make_optimizer(args)
    if semi:
        if args.labeled_slices is not None:
            n_labeled = max(2, args.labeled_slices)
        elif args.synthetic:
            n_labeled = max(2, len(train_ds) // 4)
        else:
            n_labeled = patients_to_slices("ACDC", args.labeled_num)
        n_labeled = min(n_labeled, len(train_ds) - 1)
        sampler = TwoStreamBatchSampler(
            range(n_labeled), range(n_labeled, len(train_ds)),
            cfg.batch_size, cfg.batch_size - args.labeled_bs, seed=args.seed)
        model2 = None
        if args.method in ("cross_teaching", "contrastive_consistency"):
            name2 = args.model2 or args.model
            model2 = net_factory(name2, **_model_kwargs(args, name2,
                                                        args.seed + 1))
        if args.method == "magicnet":
            trainer = MagicNetTrainer(
                model, cfg, labeled_bs=args.labeled_bs,
                cube_size=args.cube_size, mask_recovery=args.mask_recovery,
                masked_rate=args.masked_rate, make_optimizer=make_optimizer,
                device=device)
        elif args.method == "contrastive_consistency":
            trainer = ContrastiveConsistencyTrainer(
                model, cfg, model2=model2, labeled_bs=args.labeled_bs,
                make_optimizer=make_optimizer, device=device)
        else:
            trainer = build_semi_method(args, model, cfg, model2=model2,
                                        make_optimizer=make_optimizer,
                                        device=device)
    elif weak:
        sampler = EpochShuffleSampler(len(train_ds), cfg.batch_size,
                                      seed=args.seed)
        name2, name3 = args.model2 or "ViT_seg", args.model3 or "ViM_seg"
        trainer = WeakScribbleTrainer(
            model, cfg,
            model2=net_factory(name2, **_model_kwargs(args, name2,
                                                      args.seed + 1)),
            model3=net_factory(name3, **_model_kwargs(args, name3,
                                                      args.seed + 2)),
            pce_only=args.weak_pce_only, make_optimizer=make_optimizer,
            device=device)
    else:
        sampler = EpochShuffleSampler(len(train_ds), cfg.batch_size,
                                      seed=args.seed)
        kw = dict(make_optimizer=make_optimizer, device=device)
        if args.method == "mask_pretrain":
            trainer = MaskPretrainTrainer(
                model, cfg, cube_size=args.cube_size,
                masked_rate=args.masked_rate, **kw)
        elif args.method == "mad_pretrain":
            trainer = MADPretrainTrainer(model, cfg, transform=transform,
                                         **kw)
        elif args.method == "mad_finetune":
            trainer = _mad_finetune_trainer(args, model, cfg, **kw)
        else:
            trainer = Trainer(model, cfg, **kw)
    if args.pretrained_ckpt:
        from mamba_unet_torch.utils.convert import (
            load_torch_checkpoint,
            load_upstream_state,
        )

        sd = load_torch_checkpoint(args.pretrained_ckpt)
        targets = [("", trainer.model)]
        if (args.method in ("cross_teaching", "contrastive_consistency")
                and (args.model2 or args.model) in WARM_START_MODELS):
            targets.append((" model2", trainer.model2))
        for tag, net in targets:
            report = load_upstream_state(net, sd)
            logging.info(f"pretrained{tag}: loaded %d tensors, %d missing, "
                         f"%d shape-skipped", len(report["loaded"]),
                         len(report["missing"]),
                         len(report["shape_skipped"]))
    loader = Loader(train_ds, sampler, device=device)
    if cta is not None:
        result = trainer.fit(loader, val_ds, cta=cta, cta_transform=transform)
    else:
        result = trainer.fit(loader, val_ds)
    logging.info("done: %d iterations, best val dice %.4f",
                 result["iterations"], result["best_dice"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
