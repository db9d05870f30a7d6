"""Training CLI for the PyTorch port.

Port of ``mamba_unet_tpu/cli/train.py`` for ``--method fully_supervised``,
``mean_teacher``, ``uamt``, ``cross_teaching`` (Semi-Mamba-UNet) and
``weak_scribble`` (Weak-Mamba-UNet) and the models ``ViM_seg``/
``mambaunet``, the UNet family (``unet``, ``unet_ds``, ``unet_urpc``,
``unet_cct``, ``TLunet``) and ``ViT_seg`` (Swin-UNet), with that CLI's
flags for these paths plus ``--device`` (default ``cuda``; it raises when
there is no card rather than run on the CPU). ``--model`` defaults to
``unet``, as there. Other methods raise "not ported yet". The
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
``--weak_pce_only`` drops its pseudo-label Dice. ``scan_impl`` and
``drop_path`` reach only the models that take them.
``--synthetic`` trains on in-memory phantom slices
(``data.synthetic.phantom_acdc``; ``--synthetic_hard`` the hard phantom)
instead of writing an h5 set. ``--scan_impl`` picks SS2D's scan branch:
``auto``/``bidir`` (the bidirectional kernels), ``tm``/``pallas`` (the
time-major grouped ones), ``folded`` (the batch-folded ones, at every
batch) or ``xla`` (the JAX route's name for the tm branch's function;
the port runs it as the tm branch). ``--pretrained_ckpt`` warm-starts from
an upstream torch ``.pth`` (``utils.convert.load_upstream_state``, decoder
mirrored from the encoder) into ``ViM_seg`` or ``ViT_seg`` (the first
model of a multi-model method). ``--exp`` is accepted and stored for
command-line compatibility with the JAX CLI, which reads it nowhere else
either. Activation recomputation (``use_remat``) is a model option, as in
the JAX package, and has no flag.

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
    python -m mamba_unet_torch.cli.train --method cross_teaching \\
        --model ViM_seg --model2 unet --bf16 --patch_size 224 224
    python -m mamba_unet_torch.cli.train --method weak_scribble \\
        --synthetic --bf16 --patch_size 224 224 --batch_size 24
"""

from __future__ import annotations

import argparse
import logging
import sys

PORTED_METHODS = ("fully_supervised", "mean_teacher", "uamt",
                  "cross_teaching", "weak_scribble")
# the models that --pretrained_ckpt warm-starts (their network's root:
# mamba_unet, swin_unet)
WARM_START_MODELS = ("ViM_seg", "mambaunet", "ViT_seg")
MODELS = ("ViM_seg", "mambaunet", "unet", "unet_ds", "unet_urpc", "unet_cct",
          "TLunet", "ViT_seg")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Mamba-UNet training (PyTorch)")
    p.add_argument("--root_path", type=str, default="../data/ACDC")
    p.add_argument("--exp", type=str, default="ACDC/Fully_Supervised",
                   help="experiment name, accepted for command-line "
                        "compatibility with the JAX CLI (stored; nothing "
                        "reads it)")
    p.add_argument("--model", type=str, default="unet", choices=MODELS)
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
                   help="the second model: cross_teaching's (default: "
                        "--model) and weak_scribble's (default: ViT_seg)")
    p.add_argument("--model3", type=str, default=None, choices=MODELS,
                   help="weak_scribble's third model (default: ViM_seg)")
    p.add_argument("--weak_pce_only", action="store_true",
                   help="weak_scribble ablation: the scribble pCE alone, "
                        "no pseudo-label Dice")
    p.add_argument("--patch_size", type=int, nargs=2, default=[256, 256])
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
    """net_factory keywords of model ``name``: ``scan_impl`` and
    ``drop_path`` only where the model takes them."""
    import torch

    from mamba_unet_torch.models.registry import DROP_PATH_MODELS, SCAN_MODELS

    kw = {"num_classes": args.num_classes,
          "generator": torch.Generator().manual_seed(seed)}
    if name in SCAN_MODELS:
        kw["scan_impl"] = args.scan_impl
    if name in DROP_PATH_MODELS and args.drop_path is not None:
        kw["drop_path_rate"] = args.drop_path
    if name == "ViT_seg":
        kw["img_size"] = args.patch_size[0]
    return kw


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S", stream=sys.stdout)
    if args.method not in PORTED_METHODS:
        raise NotImplementedError(
            f"--method {args.method} is not ported yet; ported: "
            f"{', '.join(PORTED_METHODS)}")
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
        TrainConfig,
        Trainer,
        WeakScribbleTrainer,
        build_semi_method,
    )
    from mamba_unet_torch.utils.device import require_device

    device = require_device(args.device)
    weak = args.method == "weak_scribble"
    semi = args.method not in ("fully_supervised", "weak_scribble")
    cfg = TrainConfig(
        base_lr=args.base_lr, max_iterations=args.max_iterations,
        batch_size=args.batch_size, patch_size=tuple(args.patch_size),
        num_classes=args.num_classes, eval_every=args.eval_every,
        seed=args.seed, snapshot_dir=args.snapshot_dir, resume=args.resume,
        ckpt_every=args.ckpt_every, grad_accum_steps=args.grad_accum_steps,
        bf16=args.bf16,
    )
    # weak_scribble trains on the scribbles, which rotation pads with the
    # ignore index; val keeps the dense labels
    sup_type = "scribble" if weak else "label"
    transform = RandomGenerator(cfg.patch_size, seed=args.seed,
                                label_cval=args.num_classes if weak else 0)
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

    model = net_factory(args.model, **_model_kwargs(args, args.model,
                                                    args.seed))
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
        if args.method == "cross_teaching":
            name2 = args.model2 or args.model
            model2 = net_factory(name2, **_model_kwargs(args, name2,
                                                        args.seed + 1))
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
        trainer = Trainer(model, cfg, make_optimizer=make_optimizer,
                          device=device)
    if args.pretrained_ckpt:
        from mamba_unet_torch.utils.convert import (
            load_torch_checkpoint,
            load_upstream_state,
        )

        report = load_upstream_state(
            trainer.model, load_torch_checkpoint(args.pretrained_ckpt))
        logging.info("pretrained: loaded %d tensors, %d missing, %d "
                     "shape-skipped", len(report["loaded"]),
                     len(report["missing"]), len(report["shape_skipped"]))
    loader = Loader(train_ds, sampler, device=device)
    result = trainer.fit(loader, val_ds)
    logging.info("done: %d iterations, best val dice %.4f",
                 result["iterations"], result["best_dice"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
