"""The port's remaining utilities against the JAX package's: the config
system, the experiment helpers and the scalar logger, the profiling
helpers, the native host augmentation (bitwise against JAX's native and
the Python generators) and the ACDC preprocessing (h5 contents bitwise
against JAX's on a tiny NIfTI tree)."""

import logging
import os

import h5py
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mamba_unet_torch.cli import preprocess as t_pre_cli  # noqa: E402
from mamba_unet_torch.data import augment as t_aug  # noqa: E402
from mamba_unet_torch.data import native as t_native  # noqa: E402
from mamba_unet_torch.data.nifti import write_nifti  # noqa: E402
from mamba_unet_torch.models.vssm import MambaUnet as TMambaUnet  # noqa: E402
from mamba_unet_torch.train.trainer import TrainConfig, Trainer  # noqa: E402
from mamba_unet_torch.utils import config as t_cfg  # noqa: E402
from mamba_unet_torch.utils import experiment as t_exp  # noqa: E402
from mamba_unet_torch.utils import profiling as t_prof  # noqa: E402
from mamba_unet_tpu.data import native as j_native  # noqa: E402
from mamba_unet_tpu.data import preprocess as j_pre  # noqa: E402
from mamba_unet_tpu.utils import config as j_cfg  # noqa: E402
from mamba_unet_tpu.utils import experiment as j_exp  # noqa: E402
from mamba_unet_tpu.utils import profiling as j_prof  # noqa: E402

CONFIGS = ("configs/vmamba_tiny.yaml",
           "configs/swin_tiny_patch4_window7_224_lite.yaml")
OPTS = ["MODEL.DROP_PATH_RATE", "0.1", "MODEL.VSSM.DEPTHS", "[1, 2]",
        "MODEL.PRETRAIN_CKPT", "null", "DATA.IMG_SIZE", "32",
        "MODEL.SWIN.MLP_RATIO", "2.5", "MODEL.NAME", "tiny"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- config -------------------------------------------------------------------

@pytest.mark.parametrize("cfg_file", CONFIGS)
@pytest.mark.parametrize("opts", [None, OPTS])
def test_config_matches_jax(cfg_file, opts):
    """Defaults, each yaml config and typical --opts values (floats,
    flow lists, null, strings) give the JAX config tree."""
    assert t_cfg.get_config(cfg_file, opts) == j_cfg.get_config(cfg_file,
                                                                 opts)
    with pytest.raises(ValueError, match="KEY VALUE"):
        t_cfg.get_config(cfg_file, ["MODEL.NAME"])


def test_config_built_model_and_parameter_count_match_jax():
    """The config-built toy MambaUnet: the --drop_path override, and as
    many parameters as JAX's model from the same config
    (``parameter_count`` of both)."""
    opts = ["MODEL.VSSM.EMBED_DIM", "8", "MODEL.VSSM.DEPTHS", "[1, 1]"]
    cfg = t_cfg.get_config(CONFIGS[0], opts)
    model = t_cfg.build_model_from_config(cfg, num_classes=4, img_size=32,
                                          drop_path_rate=0.05)
    assert isinstance(model, TMambaUnet)
    rates = [m.rate for m in model.modules() if hasattr(m, "rate")]
    assert max(rates) == pytest.approx(0.05)
    jmodel = j_cfg.build_model_from_config(j_cfg.get_config(CONFIGS[0], opts),
                                           num_classes=4, img_size=32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jax.numpy.zeros((1, 32, 32, 1))))
    assert t_prof.parameter_count(model) == j_prof.parameter_count(
        shapes["params"])


# --- experiment -------------------------------------------------------------------

def test_experiment_helpers(tmp_path):
    """snapshot_path and label2color as JAX's; setup_experiment archives
    the port's package and logs to log.txt; the logger's scalars land in
    scalars.jsonl (and an event file, tensorboardX being installed
    here)."""
    assert t_exp.snapshot_path("ACDC/x", 7, "unet") == j_exp.snapshot_path(
        "ACDC/x", 7, "unet")
    assert t_exp.snapshot_path("e", None, "m", root="r") == os.path.join(
        "r", "e", "m")
    labels = np.random.default_rng(0).integers(-1, 20, (5, 6))
    np.testing.assert_array_equal(t_exp.label2color(labels),
                                  j_exp.label2color(labels))
    root = logging.getLogger()
    saved = root.handlers[:], root.level
    try:
        t_exp.setup_experiment(str(tmp_path / "snap"))
        logging.getLogger("t").info("hello")
    finally:
        for h in root.handlers:
            h.close()
        root.handlers[:], _ = saved
        root.setLevel(saved[1])
    assert (tmp_path / "snap/code/parallel/mesh.py").is_file()
    assert "hello" in (tmp_path / "snap/log.txt").read_text()
    tb = t_exp.TensorboardLogger(str(tmp_path / "tb"))
    tb.scalars(3, {"info/a": 1.5, "info/b": np.float32(2)})
    tb.close()
    assert t_exp.read_scalars(str(tmp_path / "tb")) == [
        {"step": 3, "info/a": 1.5, "info/b": 2.0}]
    assert any(p.name.startswith("events") for p in (tmp_path / "tb").iterdir())


def test_trainer_writes_scalars_with_tensorboard(tmp_path):
    r = np.random.default_rng(0)
    batches = [{"image": torch.as_tensor(r.random((2, 32, 32, 1), np.float32)),
                "label": torch.as_tensor(r.integers(0, 4, (2, 32, 32)))}
               for _ in range(2)]
    val = [{"image": r.random((2, 32, 32), np.float32),
            "label": r.integers(0, 4, (2, 32, 32))}]
    cfg = TrainConfig(max_iterations=2, batch_size=2, patch_size=(32, 32),
                      eval_every=2, log_every=1, snapshot_dir=str(tmp_path),
                      tensorboard=True)
    model = TMambaUnet(num_classes=4, depths=(1, 1), dims=(8, 16),
                       scan_impl="tm")
    Trainer(model, cfg, device="cpu").fit(batches, val)
    records = t_exp.read_scalars(str(tmp_path / "log"))
    assert [r["step"] for r in records] == [1, 2, 2]
    assert {"info/total_loss", "info/lr"} <= set(records[0])
    assert "info/val_mean_dice" in records[2]


# --- profiling -------------------------------------------------------------------

@pytest.mark.parametrize("args", [(2, 64, 8, 16), (24, 3136, 768, 16),
                                  (8, 1024, 1536, 16, False, True)])
def test_selective_scan_flops_match_jax(args):
    assert t_prof.selective_scan_flops(*args) == j_prof.selective_scan_flops(
        *args)


def test_model_flops_count_the_scans_and_time_fn_and_trace(tmp_path):
    """The FLOP count includes every scan op's formula: a toy tm-branch
    Mamba-UNet at 32² scans 4 directions of 2 * dim channels over each
    stage's tokens, in its encoder and decoder blocks."""
    model = TMambaUnet(num_classes=4, depths=(1, 1), dims=(8, 16),
                       scan_impl="tm").eval()
    x = torch.zeros(2, 32, 32, 1)
    cost = t_prof.model_flops(model, x)
    n_ss2d = sum(type(m).__name__ == "SS2D" for m in model.modules())
    want = sum(t_prof.selective_scan_flops(2, L, 4 * 2 * d, 16)
               for L, d in ((64, 8), (16, 16), (64, 8)))
    assert n_ss2d == 3 and cost["scan_flops"] == want
    assert cost["flops"] > cost["scan_flops"] and cost["bytes_accessed"] is None
    assert t_prof.time_fn(model, x, iters=2) > 0
    with t_prof.profile_trace(str(tmp_path)):
        model(x)
    assert (tmp_path / "trace.json").is_file()
    assert (tmp_path / "key_averages.txt").stat().st_size > 0


# --- native augmentation ---------------------------------------------------------

def test_native_ops_match_jax_native_bitwise():
    r = np.random.default_rng(3)
    img = r.random((19, 23), np.float32)
    lab = r.integers(0, 4, (19, 23))
    assert t_native.available() and j_native.available()
    for shape in ((32, 32), (7, 40)):
        np.testing.assert_array_equal(t_native.nn_zoom(img, shape),
                                      j_native.nn_zoom(img, shape))
        np.testing.assert_array_equal(t_native.nn_zoom(lab, shape),
                                      j_native.nn_zoom(lab, shape))
    for k in range(4):
        for axis in (0, 1):
            want = np.flip(np.rot90(img, k), axis)
            np.testing.assert_array_equal(t_native.rot90_flip(img, k, axis),
                                          want)
            np.testing.assert_array_equal(t_native.rot90_flip(lab, k, axis),
                                          j_native.rot90_flip(lab, k, axis))


def test_native_generator_matches_jax_native_and_python_generators():
    """Same seed: the same draws and bitwise the same arrays as JAX's
    native generator and the port's (and JAX's) Python one."""
    r = np.random.default_rng(5)
    samples = [{"image": r.random((20, 26), np.float32),
                "label": r.integers(0, 4, (20, 26))} for _ in range(12)]
    port = t_native.NativeRandomGenerator((16, 16), seed=9)
    jnat = j_native.NativeRandomGenerator((16, 16), seed=9)
    py = t_aug.RandomGenerator((16, 16), seed=9)
    for s in samples:
        a, b, c = port(s), jnat(s), py(s)
        for k in ("image", "label"):
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])


def test_native_build_raises_without_a_compiler(monkeypatch, tmp_path):
    """Where JAX's degrades to scipy, the port raises."""
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(t_native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        t_native.build()


# --- ACDC preprocessing -------------------------------------------------------------

def _raw_tree(root):
    """Two patients (one of the reference's test split, one train), one
    frame each, one with a scribble."""
    r = np.random.default_rng(8)
    for pid, scribble in ((1, False), (3, True)):
        d = root / f"patient{pid:03d}"
        d.mkdir(parents=True)
        base = d / f"patient{pid:03d}_frame01"
        write_nifti(f"{base}.nii.gz", r.normal(size=(6, 7, 3)).astype(
            np.float32) * 50 + 20)
        write_nifti(f"{base}_gt.nii.gz", r.integers(0, 4, (6, 7, 3)).astype(
            np.uint8))
        if scribble:
            write_nifti(f"{base}_scribble.nii.gz",
                        r.integers(0, 5, (6, 7, 3)).astype(np.uint8))


def _h5_tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".h5"):
                with h5py.File(path) as f:
                    out[rel] = {k: (f[k].dtype.str, f[k][()]) for k in f}
            else:
                out[rel] = open(path).read()
    return out


def test_preprocess_matches_jax_bitwise(tmp_path):
    raw = tmp_path / "raw"
    _raw_tree(raw)
    j_pre.convert_acdc(str(raw), str(tmp_path / "jax"))
    assert t_pre_cli.main(["--raw_dir", str(raw), "--out_dir",
                           str(tmp_path / "port")]) == 0
    want, got = _h5_tree(tmp_path / "jax"), _h5_tree(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(got) > 5
    for rel, w in want.items():
        if isinstance(w, dict):
            assert sorted(got[rel]) == sorted(w), rel
            for k, (dt, arr) in w.items():
                assert got[rel][k][0] == dt, (rel, k)
                np.testing.assert_array_equal(got[rel][k][1], arr)
        else:
            assert got[rel] == w, rel
