"""Training CLI for the PyTorch port: fully-supervised Mamba-UNet.

Port of ``mamba_unet_tpu/cli/train.py`` for ``--method fully_supervised``
and the ``ViM_seg``/``mambaunet`` models, with that CLI's flags for this
path plus ``--device`` (default ``cuda``; it raises when there is no card
rather than run on the CPU). Other methods raise "not ported yet".
``--synthetic`` trains on in-memory phantom slices
(``data.synthetic.phantom_acdc``) instead of writing an h5 set.
``--scan_impl`` picks SS2D's scan branch: ``auto``/``bidir`` (the
bidirectional kernels), ``tm``/``pallas`` (the time-major grouped ones) or
``folded`` (the batch-folded ones, at every batch); ``xla`` is not ported
yet.

    python -m mamba_unet_torch.cli.train --root_path ../data/ACDC \\
        --patch_size 224 224 --batch_size 24 --bf16 --snapshot_dir snap
    python -m mamba_unet_torch.cli.train --model ViM_seg --scan_impl tm \\
        --bf16 --patch_size 224 224 --batch_size 24
    python -m mamba_unet_torch.cli.train --scan_impl folded --bf16 \\
        --patch_size 224 224 --batch_size 24
    python -m mamba_unet_torch.cli.train --synthetic --device cpu \\
        --patch_size 32 32 --batch_size 4 --max_iterations 4 --eval_every 2
"""

from __future__ import annotations

import argparse
import logging
import sys

PORTED_METHODS = ("fully_supervised",)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Mamba-UNet training (PyTorch)")
    p.add_argument("--root_path", type=str, default="../data/ACDC")
    p.add_argument("--model", type=str, default="ViM_seg",
                   choices=["ViM_seg", "mambaunet"])
    p.add_argument("--method", type=str, default="fully_supervised")
    p.add_argument("--max_iterations", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("--labeled_slices", type=int, default=None,
                   help="train on the first N slices only (the labeled-only "
                        "baseline of the semi-supervised tables)")
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=["sgd", "adamw"],
                   help="sgd = poly-SGD; adamw = warm-up AdamW for training "
                        "from scratch")
    p.add_argument("--weight_decay", type=float, default=None,
                   help="default: 1e-4 (sgd) / 0.05 (adamw)")
    p.add_argument("--patch_size", type=int, nargs=2, default=[256, 256])
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--eval_every", type=int, default=200)
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
                        "folded = the batch-folded ones; xla is not ported "
                        "yet)")
    p.add_argument("--drop_path", type=float, default=None,
                   help="stochastic depth rate (model default 0.2)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on in-memory phantom slices")
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S", stream=sys.stdout)
    if args.method not in PORTED_METHODS:
        raise NotImplementedError(
            f"--method {args.method} is not ported yet; ported: "
            f"{', '.join(PORTED_METHODS)}")
    from mamba_unet_torch.nn.ss2d import check_scan_impl

    check_scan_impl(args.scan_impl)  # before any data is loaded

    import torch

    from mamba_unet_torch.data.acdc import SliceDataset, VolumeDataset
    from mamba_unet_torch.data.augment import RandomGenerator
    from mamba_unet_torch.data.loader import Loader
    from mamba_unet_torch.data.sampler import EpochShuffleSampler
    from mamba_unet_torch.data.synthetic import phantom_acdc
    from mamba_unet_torch.models import net_factory
    from mamba_unet_torch.train import TrainConfig, Trainer
    from mamba_unet_torch.utils.device import require_device

    device = require_device(args.device)
    cfg = TrainConfig(
        base_lr=args.base_lr, max_iterations=args.max_iterations,
        batch_size=args.batch_size, patch_size=tuple(args.patch_size),
        num_classes=args.num_classes, eval_every=args.eval_every,
        seed=args.seed, snapshot_dir=args.snapshot_dir, resume=args.resume,
        ckpt_every=args.ckpt_every, grad_accum_steps=args.grad_accum_steps,
        bf16=args.bf16,
    )
    transform = RandomGenerator(cfg.patch_size, seed=args.seed)
    if args.synthetic:
        cases, slices, n_val, n_test, size = (
            args.synthetic_spec or [8, 8, 2, 0, args.patch_size[0]])
        splits = phantom_acdc(cases, slices, n_val, n_test, size)
        train = splits["train"][:args.labeled_slices]
        train_ds = SliceDataset.from_samples(train, transform=transform)
        val_ds = splits["val"]
    else:
        train_ds = SliceDataset(args.root_path, num=args.labeled_slices,
                                transform=transform)
        val_ds = VolumeDataset(args.root_path, "val")

    kwargs = {"num_classes": args.num_classes, "scan_impl": args.scan_impl,
              "generator": torch.Generator().manual_seed(args.seed)}
    if args.drop_path is not None:
        kwargs["drop_path_rate"] = args.drop_path
    model = net_factory(args.model, **kwargs)
    trainer = Trainer(model, cfg, make_optimizer=_make_optimizer(args),
                      device=device)
    loader = Loader(train_ds, EpochShuffleSampler(len(train_ds),
                                                  cfg.batch_size,
                                                  seed=args.seed),
                    device=device)
    result = trainer.fit(loader, val_ds)
    logging.info("done: %d iterations, best val dice %.4f",
                 result["iterations"], result["best_dice"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
