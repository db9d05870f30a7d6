"""Test/inference CLI for the PyTorch port (a model, or a model and a
denoiser stacked on it).

Port of ``mamba_unet_tpu/cli/test.py``. Per test case: order-0 zoom of each
slice to the patch size, batched forward, argmax, order-0 zoom back, and
per-class (dice, hd95, asd) at native resolution; then the mean table.
``--write_pred_key`` writes the patch-size prediction back into the case h5;
``--save_nii_dir`` writes ``{case}_pred.nii.gz`` and ``{case}_gt.nii.gz``
(uint8 (H, W, S) at native resolution, spacing (1, 1, 10)).
``--checkpoint`` is a ``state_dict`` file or a training ``--snapshot_dir``,
whose newest ``--ckpt_name`` checkpoint loads (default ``best``, else the
newest periodic ``state``). :func:`run_inference` also takes volumes in
memory (dicts of ``case``, ``image``, ``label``) in place of the h5 split.
The per-volume body is :func:`infer_volume`, which ``chip_smoke.py`` drives
too; it is ``eval.inference.test_single_volume`` with the CLI's metrics.

    python -m mamba_unet_torch.cli.test --root_path ../data/ACDC \
        --checkpoint model.pth
    python -m mamba_unet_torch.cli.test --checkpoint snap/ --ckpt_name best \
        --save_nii_dir preds/

``--model`` is any registered 2-D model (``ViM_seg``, the UNet family,
``ViT_seg``, ``vnet`` and the MagicNet models; ``ViT_seg``,
``MambaUnetMask``, ``magicnet_2D`` and ``magicnet_2D_mask`` built for
``--patch_size``, the last three also for ``--cube_size``; a model with
several outputs is served its first). The 3-D models (``vnet_3D``,
``magicnet``) are validated by ``train.magicnet.MagicNetTrainer.
final_validation``, not here.

``--denoiser_model`` stacks a second model on the first, as the
reference's ``Inference_seg_ema_model``/``Inference_mad_model``: it eats
softmax(seg(x)) (``--num_classes`` input channels) and a second table of
metrics is reported for argmax(den(softmax(seg(x)))) beside the first. One
segmenter forward per batch feeds both. The denoiser loads from
``--denoiser_checkpoint`` (e.g. a ``mad_pretrain`` snapshot), its newest
``--denoiser_ckpt_name`` checkpoint (default ``best``, else ``state``;
``best3`` picks the fine-tuned den out of a ``mad_finetune`` snapshot,
whose trio is saved as best = seg, best2 = mad, best3 = den):
``--ckpt_name`` selects in the main snapshot only. ``--device`` defaults to
``cuda`` and raises without a card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Callable, Sequence

import numpy as np

from mamba_unet_torch.eval.inference import _zoom0, test_single_volume
from mamba_unet_torch.eval.metrics import dice_hd95_asd

BATCH_SIZE = 24  # slices per forward; a volume's tail batch is zero-padded


def build_parser():
    p = argparse.ArgumentParser(description="Mamba-UNet testing (PyTorch)")
    p.add_argument("--root_path", type=str, default="../data/ACDC")
    p.add_argument("--model", type=str, default="ViM_seg")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--patch_size", type=int, nargs=2, default=[224, 224])
    p.add_argument("--cube_size", type=int, default=32,
                   help="the cube side a MagicNet model was trained with")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="torch.save'd state_dict, or a training snapshot "
                        "directory; default: seed-0 weights")
    p.add_argument("--ckpt_name", type=str, default=None,
                   help="checkpoint name prefix in a snapshot directory "
                        "(best/best2/best3; default 'best' falling back to "
                        "'state')")
    p.add_argument("--split", type=str, default="test", choices=["val", "test"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--save_nii_dir", type=str, default=None,
                   help="write {case}_pred.nii.gz and {case}_gt.nii.gz here")
    p.add_argument("--write_pred_key", type=str, default=None,
                   help="write predictions back into the case h5 under this key")
    p.add_argument("--denoiser_model", type=str, default=None,
                   help="a denoiser stacked on the model: it eats "
                        "softmax(seg(x)); reports the raw and the denoised "
                        "metrics")
    p.add_argument("--denoiser_checkpoint", type=str, default=None,
                   help="the denoiser's state_dict file or snapshot "
                        "directory (e.g. a mad_pretrain run)")
    p.add_argument("--denoiser_ckpt_name", type=str, default=None,
                   help="checkpoint name prefix in the denoiser's snapshot "
                        "(default 'best' falling back to 'state'; best3 = "
                        "a mad_finetune run's den)")
    return p


def infer_volume(image: np.ndarray, label: np.ndarray,
                 predict_fn: Callable[[np.ndarray], np.ndarray],
                 num_classes: int, patch_size: Sequence[int]):
    """One (Z, H, W) volume -> (pred_small (Z, ps0, ps1), per-class
    (dice, hd95, asd) at native resolution), BATCH_SIZE slices per call of
    ``predict_fn``."""
    metrics, pred_small = test_single_volume(
        image, label, predict_fn, num_classes, patch_size, BATCH_SIZE,
        metric_fn=dice_hd95_asd, return_pred=True)
    return pred_small, metrics


def _native_metrics(pred_small: np.ndarray, label: np.ndarray,
                    num_classes: int):
    """Per-class (dice, hd95, asd) of a (Z, ps0, ps1) prediction zoomed back
    to the label's native slices."""
    native = label.shape[1:]
    pred = (np.stack([_zoom0(p, native) for p in pred_small])
            if pred_small.shape[1:] != native else pred_small)
    return [dice_hd95_asd(pred == c, label == c)
            for c in range(1, num_classes)]


class _Stacked:
    """A predict function of the segmenter that also runs the denoiser on
    the softmax of each batch's logits, on the device, and keeps its
    argmax: one segmenter forward feeds both tables."""

    def __init__(self, seg_fn: Callable, den_fn: Callable, device):
        self.seg_fn, self.den_fn, self.device = seg_fn, den_fn, device
        self.den_preds = []

    def __call__(self, x: np.ndarray) -> np.ndarray:
        import torch

        seg = self.seg_fn(torch.as_tensor(x, device=self.device))
        den = self.den_fn(torch.softmax(seg, dim=-1))
        self.den_preds.append(den.argmax(-1).cpu().numpy())
        return seg.cpu().numpy()

    def take(self, z: int) -> np.ndarray:
        """The denoised (z, ps0, ps1) argmax of the volume just served."""
        out = np.concatenate(self.den_preds)[:z]
        self.den_preds = []
        return out


def _log_table(arr: np.ndarray, tag: str = "") -> dict:
    mean_by_class = arr.mean(axis=0)
    overall = arr.mean(axis=(0, 1))
    for c in range(arr.shape[1]):
        logging.info("class %d%s: dice %.4f hd95 %.4f asd %.4f", c + 1, tag,
                     *mean_by_class[c])
    logging.info("MEAN%s: dice %.4f hd95 %.4f asd %.4f", tag, *overall)
    return {"mean_by_class": mean_by_class, "mean": overall}


def run_inference(args, dataset=None) -> dict:
    """Test ``args``' model on ``dataset`` (a sequence of volume dicts;
    default the ``--split`` of the h5 set under ``--root_path``)."""
    from mamba_unet_torch.data.acdc import VolumeDataset
    from mamba_unet_torch.data.nifti import write_nifti
    from mamba_unet_torch.models.registry import VOLUME_MODELS, size_kwargs
    from mamba_unet_torch.utils.checkpoint import load_model_snapshot
    from mamba_unet_torch.utils.device import require_device
    from mamba_unet_torch.utils.export import make_predict_fn

    if args.model in VOLUME_MODELS:
        raise ValueError(f"{args.model} is a 3-D model; this CLI serves 2-D "
                         f"slices")
    model_kw = size_kwargs(args.model, args.patch_size[0], args.cube_size)
    device = require_device(args.device)
    model = load_model_snapshot(args.model, args.num_classes, 1,
                                args.checkpoint, device=device,
                                ckpt_name=args.ckpt_name, **model_kw)
    predict = stacked = make_predict_fn(model)
    if args.denoiser_model:
        den = load_model_snapshot(
            args.denoiser_model, args.num_classes, args.num_classes,
            args.denoiser_checkpoint, device=device,
            ckpt_name=args.denoiser_ckpt_name,
            **size_kwargs(args.denoiser_model, args.patch_size[0],
                          args.cube_size))
        predict = stacked = _Stacked(predict, make_predict_fn(den), device)

    ds = (VolumeDataset(args.root_path, args.split) if dataset is None
          else dataset)
    per_case, per_case_den = [], []
    for i in range(len(ds)):
        case = ds[i]
        pred_small, metrics = infer_volume(
            case["image"], case["label"], predict, args.num_classes,
            args.patch_size)
        per_case.append(metrics)
        logging.info("%s: dice %s", case["case"],
                     [round(m[0], 4) for m in metrics])
        if args.denoiser_model:
            dm = _native_metrics(stacked.take(len(pred_small)),
                                 case["label"], args.num_classes)
            per_case_den.append(dm)
            logging.info("%s (denoised): dice %s", case["case"],
                         [round(m[0], 4) for m in dm])
        if args.save_nii_dir:
            os.makedirs(args.save_nii_dir, exist_ok=True)
            native = case["label"].shape[1:]
            pred = np.stack([_zoom0(p, native) for p in pred_small])
            for tag, vol in (("pred", pred), ("gt", case["label"])):
                write_nifti(os.path.join(args.save_nii_dir,
                                         f"{case['case']}_{tag}.nii.gz"),
                            vol.astype(np.uint8).transpose(1, 2, 0),
                            spacing=(1, 1, 10))
        if args.write_pred_key:
            import h5py

            path = os.path.join(args.root_path, "data", f"{case['case']}.h5")
            with h5py.File(path, "a") as f:
                if args.write_pred_key in f:
                    del f[args.write_pred_key]
                f.create_dataset(args.write_pred_key, data=pred_small)

    arr = np.asarray(per_case)  # (cases, classes-1, 3)
    out = {"per_case": arr, **_log_table(arr)}
    if per_case_den:
        darr = np.asarray(per_case_den)
        table = _log_table(darr, " (denoised)")
        out.update(per_case_denoised=darr,
                   mean_by_class_denoised=table["mean_by_class"],
                   mean_denoised=table["mean"])
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        datefmt="%H:%M:%S", stream=sys.stdout)
    run_inference(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
