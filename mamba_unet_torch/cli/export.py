"""Export CLI: a trained snapshot to a ``torch.export`` serving artifact.

Port of ``mamba_unet_tpu/cli/export.py``::

    python -m mamba_unet_torch.cli.export --checkpoint snap/ --out vim.pt2
    python -m mamba_unet_torch.cli.export --checkpoint snap/ --bf16 \\
        --batch 24 --out vim_bf16_b24.pt2

``--model`` is any registered model (``ViM_seg`` by default, the UNet
family, ``ViT_seg``, the VNet family and the MagicNet models; the models
built for one size are built for ``--patch_size``, the MagicNet ones also
for ``--cube_size``; three ``--patch_size`` ints export a 3-D model's
(B, D, H, W, C) volumes). The artifact
(``utils.export.export_predict``) holds the graph and the weights, with a
symbolic batch unless ``--batch`` pins one. It runs on the
device it was exported on (``--device``, default ``cuda``, which raises
without a card) and is served with
``mamba_unet_torch.utils.export.load_exported(path).module()(images)``:
loading needs ``mamba_unet_torch.ops`` (the scan kernels' custom ops), not
the model code. The JAX CLI's ``--platforms`` has no counterpart.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(description="Export a snapshot for serving "
                                            "(PyTorch)")
    p.add_argument("--model", type=str, default="ViM_seg")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--patch_size", type=int, nargs="+", default=[224, 224],
                   help="2 ints, or 3 for a 3-D model")
    p.add_argument("--cube_size", type=int, default=32,
                   help="the cube side a MagicNet model was trained with")
    p.add_argument("--in_channels", type=int, default=1)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="state_dict file or training snapshot directory; "
                        "omit to export the seed-0 initialization "
                        "(structure smoke only)")
    p.add_argument("--ckpt_name", type=str, default=None,
                   help="checkpoint name prefix in a snapshot directory "
                        "(best/best2/best3; default 'best' falling back to "
                        "'state')")
    p.add_argument("--out", type=str, required=True,
                   help="output artifact path (.pt2)")
    p.add_argument("--batch", type=str, default="b",
                   help="batch dimension: an integer pins it, anything "
                        "else exports a symbolic batch (default)")
    p.add_argument("--bf16", action="store_true",
                   help="serve under bf16 autocast (weights stay fp32; the "
                        "input/output ABI stays fp32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout)
    import torch

    from mamba_unet_torch.models.registry import VOLUME_MODELS, size_kwargs
    from mamba_unet_torch.utils.checkpoint import load_model_snapshot
    from mamba_unet_torch.utils.device import require_device
    from mamba_unet_torch.utils.export import export_predict, save_exported

    if not args.checkpoint:
        logging.warning("no --checkpoint: exporting the seed-0 init")
    if len(args.patch_size) != (3 if args.model in VOLUME_MODELS else 2):
        raise ValueError(f"--patch_size {args.patch_size} does not fit the "
                         f"{'3' if args.model in VOLUME_MODELS else '2'}-D "
                         f"model {args.model}")
    model_kw = size_kwargs(args.model, args.patch_size[0], args.cube_size)
    model = load_model_snapshot(args.model, args.num_classes,
                                args.in_channels, args.checkpoint,
                                device=require_device(args.device),
                                ckpt_name=args.ckpt_name, **model_kw)
    batch = int(args.batch) if args.batch.isdigit() else args.batch
    exported = export_predict(
        model, args.patch_size, in_channels=args.in_channels, batch=batch,
        dtype=torch.bfloat16 if args.bf16 else None)
    path = save_exported(exported, args.out)
    (image,) = [node.meta["val"] for node in exported.graph.nodes
                if node.name in exported.graph_signature.user_inputs]
    logging.info("exported %s -> %s (%.1f MiB, device=%s, in %s %s, %s)",
                 args.model, path, os.path.getsize(path) / 2**20,
                 image.device, tuple(image.shape), image.dtype,
                 exported.range_constraints)
    return 0


if __name__ == "__main__":
    sys.exit(main())
