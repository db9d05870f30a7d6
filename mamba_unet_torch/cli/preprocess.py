"""Offline preprocessing CLI: raw ACDC nii.gz tree -> per-slice/volume h5.

Port of ``mamba_unet_tpu/cli/preprocess.py``. A host tool that needs
``h5py``; it runs on the CPU and touches no card:
    python -m mamba_unet_torch.cli.preprocess --raw_dir /data/ACDC_raw \
        --out_dir data/ACDC
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--raw_dir", type=str, required=True,
                   help="directory tree containing *frameXX.nii.gz + *_gt.nii.gz")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--splits", type=str, default="reference",
                   choices=["reference", "all"],
                   help="'reference': write the published train/val/test "
                        "patient split (reference data/ACDC/*.list); "
                        "'all': every case into train_slices/all_cases")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(message)s")

    from mamba_unet_torch.data.preprocess import convert_acdc

    convert_acdc(args.raw_dir, args.out_dir, splits=args.splits)
    logging.info("wrote %s", args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
