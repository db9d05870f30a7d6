"""The PyTorch port's VNet family and 3-D MagicNet pipeline (BTCV)
against the JAX package.

* The organ phantoms (``data.synthetic.phantom_btcv``) equal JAX's
  ``make_synthetic_btcv`` h5 contents bitwise, and the port's writer
  writes the same files; ``RandomCrop3D`` (with its padding),
  ``RandomRotFlip3D`` and ``Compose3D`` give JAX's arrays bitwise from the
  same seeds; ``VolumeTrainDataset`` reads h5 volumes and in-memory ones
  alike.
* ``gaussian_importance_map``, ``sliding_window_inference_3d`` (uniform
  and Gaussian weights, a volume smaller than the patch and larger),
  ``validation_all_case`` and the metrics ``assd``, ``nsd``,
  ``calculate_metric_percase_full`` against JAX on a toy predict
  function.
* flax's ``GroupNorm`` (epsilon 1e-6, fast variance) at ranks 2 and 3,
  instance norm and 16 groups, within 1e-5 (its statistics in fp32 under
  bf16 inputs too).
* The five registry names (``vnet``, ``vnet_3D``, ``magicnet``,
  ``magicnet_2D``, ``magicnet_2D_mask``) at n_filters 2-4, 32² / 32³,
  cubes of 16, from JAX's weights through ``params_from_jax``: every
  method in eval mode, ``vnet_3D`` in train mode too, within 1e-4 of each
  output's max abs: the fast variance's cancellation amplifies the two
  packages' fp32 rounding by about 2 per norm (4e-7 of the max after the
  first block, 3e-5 at the logits of the 2-D toy, measured). (The mask
  heads' train mode runs in ``tests/test_torch_magicnet.py``'s trainer
  test.)
* One ``MagicNetTrainer`` step on a toy 3-D ``magicnet`` (n_filters 2,
  32³, cubes of 16, batch 2) against the JAX trainer with its draws.
* The train CLI's ``--dataset btcv`` run ending in ``metric_final.npy``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as fnn

torch = pytest.importorskip("torch")

from mamba_unet_torch.cli import train as train_cli  # noqa: E402
from mamba_unet_torch.data import btcv as t_btcv  # noqa: E402
from mamba_unet_torch.data.synthetic import phantom_btcv  # noqa: E402
from mamba_unet_torch.eval import inference as t_inf  # noqa: E402
from mamba_unet_torch.eval import metrics as t_metrics  # noqa: E402
from mamba_unet_torch.eval.validate_3d import (  # noqa: E402
    validation_all_case,
)
from mamba_unet_torch.models import net_factory  # noqa: E402
from mamba_unet_torch.nn.layers import GroupNorm, set_generator  # noqa: E402
from mamba_unet_torch.utils.convert import params_from_jax  # noqa: E402
from mamba_unet_tpu.data import btcv as j_btcv  # noqa: E402
from mamba_unet_tpu.eval import inference as j_inf  # noqa: E402
from mamba_unet_tpu.eval import metrics as j_metrics  # noqa: E402
from mamba_unet_tpu.eval import validate_3d as j_val  # noqa: E402
from mamba_unet_tpu.models import net_factory as j_net_factory  # noqa: E402
from mamba_unet_tpu.parallel import make_mesh  # noqa: E402
from mamba_unet_tpu.train import TrainConfig as JTrainConfig  # noqa: E402
from mamba_unet_tpu.train import magicnet as j_magic  # noqa: E402
from tests import test_torch_magicnet as tm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_REL_TOL = 1e-4
_flat, _np, _near_max = tm._flat, tm._np, tm._near_max
# the 3-D trainer toy
MAGIC_3D = dict(num_classes=4, n_filters=2, cube_size=16, patch_size=32)
BATCH_3D, LABELED_3D, SIZE_3D, CUBE_3D = 2, 1, 32, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs (the suite runs several
    workers on a few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def fast_jax_compiles():
    """XLA's cheaper compile while this file runs."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


# --- data -------------------------------------------------------------------

def test_phantoms_and_h5_match_jax(tmp_path):
    """JAX's h5 volumes, the port's in-memory phantoms and the port's h5
    writer: the same arrays, read alike by both datasets."""
    import h5py

    root_j = j_btcv.make_synthetic_btcv(str(tmp_path / "jax"), n_train=2,
                                        n_val=1, size=24)
    splits = phantom_btcv(2, 1, 24)
    root_t = t_btcv.make_synthetic_btcv(str(tmp_path / "port"), n_train=2,
                                        n_val=1, size=24)
    for split in ("train", "val"):
        with open(os.path.join(root_j, f"{split}.list")) as f:
            ids = f.read().split()
        assert ids == [v["case"] for v in splits[split]]
        with open(os.path.join(root_t, f"{split}.list")) as f:
            assert f.read().split() == ids
        for cid, vol in zip(ids, splits[split]):
            for root in (root_j, root_t):
                with h5py.File(os.path.join(root, "data", f"{cid}.h5"),
                               "r") as f:
                    np.testing.assert_array_equal(f["image"][()],
                                                  vol["image"])
                    np.testing.assert_array_equal(f["label"][()],
                                                  vol["label"])
                    assert f["label"].dtype == np.uint8
    assert splits["train"][0]["label"].max() == 13
    want = j_btcv.VolumeTrainDataset(root_j, "train.list")
    for ds in (t_btcv.VolumeTrainDataset(root_j, "train.list"),
               t_btcv.VolumeTrainDataset.from_samples(splits["train"])):
        assert len(ds) == len(want)
        for i in range(len(ds)):
            got, exp = ds[i], want[i]
            assert got["image"].shape == (24, 24, 24, 1)
            for key in ("image", "label", "idx"):
                np.testing.assert_array_equal(got[key], exp[key])


def test_3d_transforms_match_jax():
    """The same seeds give JAX's crops (padded where the volume is smaller
    than the crop) and rotations/flips, over several draws."""
    rng = np.random.default_rng(0)
    for shape, out in (((20, 26, 30), (16, 16, 16)),
                       ((12, 20, 9), (16, 16, 16))):
        vols = [{"image": rng.normal(size=shape).astype(np.float32),
                 "label": rng.integers(0, 5, shape)} for _ in range(4)]
        pairs = [
            (t_btcv.Compose3D([t_btcv.RandomCrop3D(out, seed=3),
                               t_btcv.RandomRotFlip3D(seed=4)]),
             j_btcv.Compose3D([j_btcv.RandomCrop3D(out, seed=3),
                               j_btcv.RandomRotFlip3D(seed=4)])),
            (t_btcv.RandomCrop3D(out, seed=5),
             j_btcv.RandomCrop3D(out, seed=5)),
        ]
        for got_tf, want_tf in pairs:
            for vol in vols:
                got, want = got_tf(dict(vol)), want_tf(dict(vol))
                for key in ("image", "label"):
                    np.testing.assert_array_equal(got[key], want[key])


# --- sliding window, validation, metrics ------------------------------------

def _toy_predict(num_classes):
    """A deterministic (1, d, h, w, 1) -> (1, d, h, w, C) logit function of
    the window and its position-free content."""
    w = np.linspace(-2.0, 2.0, num_classes).astype(np.float32)

    def predict(x):
        x = np.asarray(x, np.float32)
        return np.sin(3.0 * x * w + w ** 2).astype(np.float32)

    return predict


@pytest.mark.parametrize("gaussian", [False, True])
def test_sliding_window_matches_jax(gaussian):
    np.testing.assert_array_equal(t_inf.gaussian_importance_map((8, 10, 6)),
                                  j_inf.gaussian_importance_map((8, 10, 6)))
    rng = np.random.default_rng(1)
    predict = _toy_predict(4)
    for shape in ((20, 17, 23), (6, 12, 9)):
        image = rng.random(shape).astype(np.float32)
        got = t_inf.sliding_window_inference_3d(image, predict, 4,
                                                (12, 12, 12), (5, 5, 5),
                                                gaussian)
        want = j_inf.sliding_window_inference_3d(image, predict, 4,
                                                 (12, 12, 12), (5, 5, 5),
                                                 gaussian)
        assert got.shape == shape
        np.testing.assert_array_equal(got, np.asarray(want))


def test_validation_and_metrics_match_jax():
    """validation_all_case on phantom volumes with the toy predictor; the
    metrics on overlapping and empty masks."""
    splits = phantom_btcv(0, 2, 20, num_classes=4)
    ds = t_btcv.VolumeTrainDataset.from_samples(splits["val"])
    predict = _toy_predict(4)
    got = validation_all_case(ds, predict, 4, (16, 16, 16), (8, 8, 8))
    want = j_val.validation_all_case(ds, predict, 4, (16, 16, 16), (8, 8, 8))
    assert got.shape == (2, 3, 4)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    rng = np.random.default_rng(2)
    a = rng.random((12, 14, 10)) > 0.6
    b = np.roll(a, 2, axis=1) | (rng.random(a.shape) > 0.9)
    for fn in ("assd", "nsd", "asd", "hd95"):
        assert getattr(t_metrics, fn)(a, b) == getattr(j_metrics, fn)(a, b)
    for pred, gt in ((a, b), (a, np.zeros_like(a)), (np.zeros_like(a), b)):
        assert (t_metrics.calculate_metric_percase_full(pred, gt)
                == j_metrics.calculate_metric_percase_full(pred, gt))
    assert t_metrics.nsd(a, b, 2.0, (1.0, 2.0, 0.5)) == j_metrics.nsd(
        a, b, 2.0, (1.0, 2.0, 0.5))


# --- GroupNorm, magic_dice ------------------------------------------------

@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("groups", [dict(num_groups=None, group_size=1),
                                    dict(num_groups=16)])
def test_group_norm_matches_flax(rank, groups):
    rng = np.random.default_rng(rank)
    c = 32
    shape = (2, *(6,) * rank, c)
    x = (3.0 * rng.normal(size=shape) + 1.5).astype(np.float32)
    layer = fnn.GroupNorm(**groups)
    v = layer.init(jax.random.key(0), x)
    scale = rng.normal(size=(c,)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    v = {"params": {"scale": scale, "bias": bias}}
    want = np.asarray(layer.apply(v, x))
    port = GroupNorm(c, num_groups=groups["num_groups"],
                     group_size=groups.get("group_size"))
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).movedim(-1, 1)
    got = port(xt).movedim(1, -1)
    np.testing.assert_allclose(_np(got), want, **TOL)
    # bf16 in: fp32 statistics, bf16 out
    with torch.autocast("cpu", torch.bfloat16):
        half = port(xt.bfloat16())
    assert half.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(half.float().movedim(1, -1)), want,
                               atol=0.05 * np.abs(want).max())
    with pytest.raises(ValueError):
        GroupNorm(c, num_groups=5)


# --- the models ---------------------------------------------------------------

MODELS = {
    "vnet": (dict(num_classes=3, n_filters=2), (2, 32, 32, 1)),
    "vnet_3D": (dict(num_classes=3, n_filters=2), (2, 32, 32, 32, 1)),
    "magicnet": (dict(num_classes=3, n_filters=2, cube_size=16,
                      patch_size=32), (2, 32, 32, 32, 1)),
    "magicnet_2D": (dict(num_classes=3, n_filters=4, cube_size=16,
                         patch_size=32), (2, 32, 32, 1)),
    "magicnet_2D_mask": (dict(num_classes=3, n_filters=4, cube_size=16,
                              patch_size=32), (2, 32, 32, 1)),
}


def _pair(name, **over):
    """(JAX model, its variables, the port model with them)."""
    kw, shape = MODELS[name]
    kw = {**kw, **over}
    jm = j_net_factory(name, **kw)
    magic = name.startswith("magic")
    v = jax.jit(lambda r, x: jm.init(
        r, x, **({"method": "init_all"} if magic else {})))(
        jax.random.key(1), jnp.zeros(shape))
    port = net_factory(name, **kw)
    stats = _flat(v["batch_stats"]) if "batch_stats" in v else None
    port.load_state_dict(params_from_jax(_flat(v["params"]),
                                         like=port.state_dict(),
                                         batch_stats=stats))
    return jm, v, port


@pytest.mark.parametrize("name", sorted(MODELS))
def test_vnet_family_eval_matches_jax(name):
    """Every method in eval mode from JAX's weights; a location head over
    one cube's flattened (channels-last) bottleneck."""
    jm, v, port = _pair(name)
    port.eval()
    shape = MODELS[name][1]
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    xt = torch.from_numpy(x)

    def apply(*args, method=None):
        return jax.jit(lambda vv, *a: jm.apply(vv, *a, method=method))(
            v, *args)

    with torch.no_grad():
        out = port(xt)
        want = apply(x)
        if not name.startswith("magic"):
            _near_max(out, want, MODEL_REL_TOL, "seg")
            return
        for a, b, tag in zip(out, want, ("seg", "emb")):
            _near_max(a, b, MODEL_REL_TOL, tag)
        feats = port.forward_encoder(xt)
        j_feats = apply(x, method="forward_encoder")
        for i, (a, b) in enumerate(zip(feats, j_feats)):
            _near_max(a, b, MODEL_REL_TOL, f"feat {i}")
        for a, b in zip(port.forward_decoder(
                [torch.from_numpy(np.asarray(f)) for f in j_feats]),
                apply(j_feats, method="forward_decoder")):
            _near_max(a, b, MODEL_REL_TOL, "decoder")
        emb = np.asarray(want[1])
        _near_max(port.forward_prediction_head(torch.from_numpy(emb)),
                  apply(emb, method="forward_prediction_head"),
                  MODEL_REL_TOL, "head")
        rank = len(shape) - 2
        cube = xt[(slice(None),) + (slice(0, 16),) * rank]
        flat = port.forward_encoder(cube)[-1].reshape(shape[0], -1)
        loc = port.forward_location(flat)
        assert loc.shape == (shape[0], 2 ** rank)
        _near_max(loc, apply(np.asarray(flat), method="forward_location"),
                  MODEL_REL_TOL, "location")
        if name == "magicnet_2D_mask":
            ids = np.stack([np.random.default_rng(i).permutation(4)
                            for i in range(2)]).astype(np.float32)
            _near_max(port.forward_mix_pos_mask(xt, torch.from_numpy(ids)),
                      apply(x, ids, method="forward_mix_pos_mask"),
                      MODEL_REL_TOL, "mix")


def test_vnet_3d_train_mode_matches_jax():
    """Train mode of ``vnet_3D``: batch-statistics BatchNorms (dropout off
    for the comparison) with the running statistics they leave; its
    dropout draws from the generator that is set, and needs one. (The
    mask heads' train mode runs in tests/test_torch_magicnet.py's trainer
    test.)"""
    jm, v, port = _pair("vnet_3D", has_dropout=False)
    port.train()
    shape = MODELS["vnet_3D"][1]
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)

    @jax.jit
    def train_apply(vv, a):
        return jm.apply(vv, a, deterministic=False, mutable=["batch_stats"])

    want, upd = train_apply(v, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _near_max(got, want, MODEL_REL_TOL, "train-mode output")
    stats = params_from_jax(_flat(v["params"]),
                            batch_stats=_flat(upd["batch_stats"]))
    for k, t in port.state_dict().items():
        if "running" in k:
            _near_max(t, stats[k], MODEL_REL_TOL, k)
    drop = net_factory("vnet_3D", num_classes=3, n_filters=2).train()
    with pytest.raises(RuntimeError, match="generator"):
        drop(torch.zeros(1, 32, 32, 32, 1))
    set_generator(drop, torch.Generator().manual_seed(0))
    a = drop(torch.ones(1, 32, 32, 32, 1))
    set_generator(drop, torch.Generator().manual_seed(0))
    assert torch.equal(a, drop(torch.ones(1, 32, 32, 32, 1)))


# --- the 3-D trainer -----------------------------------------------------------

def test_magicnet_3d_step_matches_the_jax_trainer():
    """One step on volumes: the loss terms within 1e-5, the class
    histogram exactly, every parameter within 1e-5 of its max abs (+1e-6)
    or 5 % of its update: the toy's gradients are ill-conditioned as the
    2-D one's (``tests/test_torch_magicnet.py::_assert_near_jax``, whose
    two JAX compilations part there by up to 6 % of the largest update)."""
    trainer_j = j_magic.MagicNetTrainer(
        j_net_factory("magicnet", **MAGIC_3D),
        JTrainConfig(base_lr=0.01, max_iterations=10, batch_size=BATCH_3D,
                     patch_size=(SIZE_3D,) * 3, num_classes=4,
                     eval_every=10**6, log_every=1, seed=tm.SEED),
        labeled_bs=LABELED_3D, cube_size=CUBE_3D,
        mesh=make_mesh(jax.devices()[:1]))
    params = tm._flat(trainer_j.state.params)
    stats = tm._flat(trainer_j.state.batch_stats)
    r = np.random.default_rng(21)
    batch = {"image": r.random((BATCH_3D, *(SIZE_3D,) * 3, 1), np.float32),
             "label": r.integers(0, 4, (BATCH_3D, *(SIZE_3D,) * 3))}
    want = tm._run_jax(trainer_j, [batch], np.zeros(4))[0]
    params1 = params_from_jax(tm._flat(trainer_j.state.params))
    model = net_factory("magicnet", **MAGIC_3D)
    model.load_state_dict(params_from_jax(params, like=model.state_dict(),
                                          batch_stats=stats))
    cfg = tm.TrainConfig(base_lr=0.01, max_iterations=10,
                         batch_size=BATCH_3D, patch_size=(SIZE_3D,) * 3,
                         num_classes=4, eval_every=10**6, log_every=1,
                         seed=tm.SEED)
    trainer = tm.TMagicNet(model, cfg, labeled_bs=LABELED_3D,
                          cube_size=CUBE_3D, device="cpu")
    logs = trainer.train_step({k: torch.from_numpy(v)
                               for k, v in batch.items()})
    for key in ("loss_total", "loss_sup", "loss_loc", "loss_cons",
                "cons_weight"):
        np.testing.assert_allclose(float(logs[key]), float(want[key]),
                                   **TOL, err_msg=key)
    np.testing.assert_array_equal(tm._np(logs["class_hist"]),
                                  want["class_hist"])
    start = params_from_jax(params)
    for k, w in params1.items():
        w = w.numpy()
        err = np.abs(tm._np(trainer.model.state_dict()[k]) - w).max()
        upd = np.abs(w - start[k].numpy()).max()
        assert err <= max(1e-5 * np.abs(w).max() + 1e-6, 0.05 * upd), (
            k, err, upd)


def test_btcv_cli_writes_metric_final(tmp_path):
    """``--dataset btcv --method magicnet --model magicnet --synthetic`` at
    a toy size: two steps, an eval, the final validation of the saved best
    model, ``metric_final.npy`` of (1 case, 13 classes, 4 metrics)."""
    snap = str(tmp_path / "snap")
    assert train_cli.main([
        "--dataset", "btcv", "--method", "magicnet", "--model", "magicnet",
        "--synthetic", "--patch_size", "32", "32", "32", "--num_classes",
        "14", "--batch_size", "2", "--labeled_bs", "1", "--cube_size", "16",
        "--max_iterations", "2", "--eval_every", "2", "--snapshot_dir", snap,
        "--device", "cpu"]) == 0
    arr = np.load(os.path.join(snap, "metric_final.npy"))
    assert arr.shape == (1, 13, 4) and np.isfinite(arr).all()
    assert any(name.startswith("best_") for name in os.listdir(snap))
