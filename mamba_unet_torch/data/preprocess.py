"""ACDC offline preprocessing: nii.gz volumes -> per-slice h5 + volume h5.

Port of ``mamba_unet_tpu/data/preprocess.py`` (the reference's
``acdc_data_processing.py``: min-max normalize the volume, emit gzip'd
per-slice h5 for training and whole-volume h5 for val/test), through the
port's NIfTI reader (``data/nifti.py``). A host tool: ``h5py`` is imported
where the h5 files are written, so importing this module needs no
``h5py``.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from mamba_unet_torch.data.nifti import read_nifti


def normalize_minmax(volume: np.ndarray) -> np.ndarray:
    v = volume.astype(np.float32)
    lo, hi = v.min(), v.max()
    return (v - lo) / max(hi - lo, 1e-8)


def convert_case(
    image_path: str,
    label_path: str,
    case_name: str,
    out_dir: str,
    write_slices: bool = True,
    scribble_path: Optional[str] = None,
) -> int:
    """Convert one (image, label[, scribble]) nii.gz set; returns slice count.

    ``scribble_path`` carries the ACDC-scribble annotation of Valvano et al.
    (WSL4MIS layout, ``*_scribble.nii.gz``: classes 0..3 sparse, 4 =
    unlabeled) into a ``scribble`` h5 dataset — the training key of
    ``--method weak_scribble`` (``SliceDataset(sup_type="scribble")``)."""
    import h5py

    image, _ = read_nifti(image_path)
    label, _ = read_nifti(label_path)
    image = normalize_minmax(image)
    label = np.asarray(label).astype(np.uint8)
    # nii is (X, Y, Z); the h5 layout is (Z, H, W) like the reference's
    image = np.transpose(image, (2, 0, 1))
    label = np.transpose(label, (2, 0, 1))
    scribble = None
    if scribble_path is not None:
        scribble, _ = read_nifti(scribble_path)
        scribble = np.transpose(np.asarray(scribble).astype(np.uint8),
                                (2, 0, 1))

    os.makedirs(os.path.join(out_dir, "data", "slices"), exist_ok=True)
    with h5py.File(os.path.join(out_dir, "data", f"{case_name}.h5"), "w") as f:
        f.create_dataset("image", data=image, compression="gzip")
        f.create_dataset("label", data=label, compression="gzip")
        if scribble is not None:
            f.create_dataset("scribble", data=scribble, compression="gzip")
    if write_slices:
        for i in range(image.shape[0]):
            p = os.path.join(out_dir, "data", "slices",
                             f"{case_name}_slice_{i}.h5")
            with h5py.File(p, "w") as f:
                f.create_dataset("image", data=image[i], compression="gzip")
                f.create_dataset("label", data=label[i], compression="gzip")
                if scribble is not None:
                    f.create_dataset("scribble", data=scribble[i],
                                     compression="gzip")
    return image.shape[0]


# The published ACDC patient split of the reference evaluation protocol
# (the reference's `data/ACDC/val.list` = 10 patients x 2 frames,
# `test.list` = 20 patients x 2 frames; all remaining 70 patients train).
# Dataset split definition, recorded here so that the reference's exact
# val/test protocol follows from the raw nii.gz tree alone.
REFERENCE_VAL_PATIENTS = frozenset(
    {2, 19, 28, 30, 39, 45, 78, 82, 85, 87})
REFERENCE_TEST_PATIENTS = frozenset(
    {1, 7, 8, 11, 13, 22, 24, 33, 52, 59, 64, 65, 66, 68, 75, 80, 81, 83,
     84, 93})


def _patient_number(case: str) -> Optional[int]:
    """'patient028_frame01' -> 28 (None if the name doesn't parse)."""
    base = case.split("_")[0]
    digits = "".join(ch for ch in base if ch.isdigit())
    return int(digits) if digits else None


def convert_acdc(raw_dir: str, out_dir: str,
                 splits: str = "reference") -> None:
    """Walk ACDC raw layout ({patient*/ *_frameXX.nii.gz + *_gt.nii.gz}).

    ``splits="reference"`` (default) additionally writes the reference
    protocol's ``train.list`` / ``val.list`` / ``test.list`` /
    ``train_slices.list`` using the published patient split (see
    ``REFERENCE_VAL_PATIENTS``); per-slice h5s are emitted only for train
    patients (the reference tree ships slices for the train split only).
    ``splits="all"`` keeps the old behavior: every case in
    ``train_slices.list`` + ``all_cases.list``.
    """
    images = sorted(
        p for p in glob.glob(os.path.join(raw_dir, "**", "*frame*.nii.gz"),
                             recursive=True)
        if "_gt" not in os.path.basename(p)
        and "_scribble" not in os.path.basename(p)
    )
    slice_ids, case_ids = [], []
    lists = {"train": [], "val": [], "test": []}
    for img in images:
        gt = img.replace(".nii.gz", "_gt.nii.gz")
        if not os.path.exists(gt):
            continue
        # ACDC-scribble (WSL4MIS) ships *_scribble.nii.gz next to *_gt
        scrib = img.replace(".nii.gz", "_scribble.nii.gz")
        case = os.path.basename(img).replace(".nii.gz", "")
        split = "train"
        if splits == "reference":
            pn = _patient_number(case)
            if pn in REFERENCE_VAL_PATIENTS:
                split = "val"
            elif pn in REFERENCE_TEST_PATIENTS:
                split = "test"
        n = convert_case(img, gt, case, out_dir,
                         write_slices=(split == "train"
                                       or splits != "reference"),
                         scribble_path=scrib if os.path.exists(scrib)
                         else None)
        case_ids.append(case)
        lists[split].append(case)
        if split == "train" or splits != "reference":
            slice_ids += [f"{case}_slice_{i}" for i in range(n)]
    with open(os.path.join(out_dir, "train_slices.list"), "w") as f:
        f.write("\n".join(slice_ids) + "\n")
    with open(os.path.join(out_dir, "all_cases.list"), "w") as f:
        f.write("\n".join(case_ids) + "\n")
    if splits == "reference":
        for name, ids in lists.items():
            with open(os.path.join(out_dir, f"{name}.list"), "w") as f:
                f.write("\n".join(ids) + ("\n" if ids else ""))
