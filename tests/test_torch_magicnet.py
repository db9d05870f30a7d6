"""The PyTorch port's MagicNet trainer against the JAX package.

(flax's ``GroupNorm`` and the VNet family's modules against JAX are in
``tests/test_torch_btcv.py``.)
* ``magic_dice`` against JAX, with and without a weight map.
* The blend weight against JAX's formula where that is finite, and
  finite at million-count histograms, where JAX's overflows to NaN.
* Two ``MagicNetTrainer`` steps with ``--mask_recovery`` on a toy
  ``magicnet_2D_mask`` (``magicnet_2D`` with the mask heads) against the
  JAX trainer, JAX's draws handed in, with ``blend_after=0`` and a
  non-zero class distribution so that step 2 blends: the loss terms
  within 1e-5, the class histogram exactly, every parameter and the EMA
  within 1e-5 plus 3x the difference between two fp32 compilations of
  the JAX step (the ill-conditioned toy, see :func:`_assert_near_jax`),
  step 2 from JAX's state after step 1.
* One ``--mask_recovery`` step on the toy ``MambaUnetMask`` (depths 1,
  64², batch 8): finite terms, moved weights, untouched statistics (the
  same step against the JAX trainer, whose compile takes ~100 s, is
  ``tests/test_torch_magicnet_mask.py``).
* The class distribution through the periodic checkpoint and back, the
  20-step refresh, and the CLI's refusals.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.cli import train as train_cli  # noqa: E402
from mamba_unet_torch.models import net_factory  # noqa: E402
from mamba_unet_torch.models.mamba_mask import MambaUnetMask  # noqa: E402
from mamba_unet_torch.train import MagicNetTrainer, TrainConfig  # noqa: E402
from mamba_unet_torch.train.magicnet import (  # noqa: E402
    magic_dice,
    magic_dice_labels,
)
from mamba_unet_torch.utils.convert import params_from_jax  # noqa: E402
from mamba_unet_tpu.models import net_factory as j_net_factory  # noqa: E402
from mamba_unet_tpu.objectives import cube as j_cube  # noqa: E402
from mamba_unet_tpu.objectives import masked as j_masked  # noqa: E402
from mamba_unet_tpu.parallel import make_mesh  # noqa: E402
from mamba_unet_tpu.train import TrainConfig as JTrainConfig  # noqa: E402
from mamba_unet_tpu.train import magicnet as j_magic  # noqa: E402
from test_torch_train import _committed  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SEED = 0
# the 2-D trainer toy: magicnet_2D_mask, 3 filters, 32² slices in cubes of
# 16
MAGIC_2D = dict(num_classes=4, n_filters=3, cube_size=16, patch_size=32)
BATCH_2D, LABELED_2D, SIZE_2D, CUBE_2D = 4, 2, 32, 16
CLASS_DIST = np.array([30.0, 20.0, 10.0, 5.0])
# tests/test_torch_mask.py's toy MambaUnetMask
MASK_TOY = dict(num_classes=4, cube_size=32, patch_size=64,
                depths=(1, 1, 1, 1), dims=(4, 8, 16, 32), d_state=4,
                drop_path_rate=0.0)
MASK_BATCH, MASK_LABELED, MASK_SIZE, MASK_CUBE = 8, 4, 64, 32


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


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _near_max(got, want, rel, msg=""):
    """Within ``rel`` of ``want``'s max abs."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (msg, err, np.abs(want).max())


# --- magic_dice ----------------------------------------------------------------

def test_magic_dice_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(logits, -1))
    labels = rng.integers(0, 4, size=(3, 8, 8))
    weight = rng.random((3, 8, 8, 1)).astype(np.float32)
    for w in (None, weight):
        want = j_magic.magic_dice_labels(jnp.asarray(probs),
                                         jnp.asarray(labels),
                                         None if w is None else
                                         jnp.asarray(w))
        got = magic_dice_labels(torch.from_numpy(probs),
                                torch.from_numpy(labels),
                                None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(float(got), float(want), **TOL)
    onehot = np.eye(4, dtype=np.float32)[labels]
    assert float(magic_dice(torch.from_numpy(onehot),
                            torch.from_numpy(onehot))) < 1e-6


# --- the blend weight -----------------------------------------------------------

def _jax_blend(dist, t_dist=0.1):
    """JAX's weight formula (``mamba_unet_tpu/train/magicnet.py:202-204``),
    eagerly in ``jnp``."""
    d = jnp.asarray(dist, jnp.float32) ** (1.0 / t_dist)
    d = d / jnp.maximum(d.sum(), 1e-12)
    return np.asarray(d / jnp.maximum(d.max(), 1e-12))


def _port_blend(dist, t_dist=0.1):
    holder = type("Holder", (), {"t_dist": t_dist})()
    classes = torch.arange(len(dist))
    return MagicNetTrainer._blend_weight(holder, np.asarray(dist, np.float32),
                                         classes)[..., 0].numpy()


def test_blend_weight_equals_jax_where_finite_and_stays_finite():
    """At class counts up to 7,000 the weights equal JAX's within 1e-6
    relative (JAX's fp32 power is finite there); at the card's counts
    (3.0-6.9 M per class, where JAX's give NaN) they are finite, in [0, 1],
    with max 1 and ranked as the counts; an all-zero histogram gives 0."""
    rng = np.random.default_rng(5)
    for dist in ([7000.0, 3000.0, 1200.0, 80.0], [1.0, 2.0, 3.0, 4.0],
                 rng.integers(1, 7001, 4).astype(np.float32),
                 [0.0, 0.0, 5.0, 7000.0]):
        want = _jax_blend(dist)
        assert np.isfinite(want).all()
        np.testing.assert_allclose(_port_blend(dist), want, rtol=1e-6,
                                   atol=0)
    card = np.array([6.9e6, 3.0e6, 4.2e6, 5.5e6], np.float32)
    assert np.isnan(_jax_blend(card)).all()
    got = _port_blend(card)
    assert np.isfinite(got).all() and got.min() >= 0 and got.max() == 1.0
    np.testing.assert_array_equal(np.argsort(got), np.argsort(card))
    np.testing.assert_array_equal(_port_blend(np.zeros(4)), np.zeros(4))
    np.testing.assert_array_equal(_jax_blend(np.zeros(4)), np.zeros(4))


# --- the trainer against the JAX trainer --------------------------------------

def _cfg(cls, batch, size, **kw):
    return cls(base_lr=0.01, max_iterations=10, batch_size=batch,
               patch_size=(size, size), num_classes=4, eval_every=10**6,
               log_every=1, seed=SEED, **kw)


def _batches(n, batch, size, seed=11):
    r = np.random.default_rng(seed)
    return [{"image": r.random((batch, size, size, 1), np.float32),
             "label": r.integers(0, 4, (batch, size, size))}
            for _ in range(n)]


def _jax_draws(step, image, labeled, cube, recovery=False):
    """The JAX MagicNet step's draws for ``step``."""
    r_mix, r_noise, _, r_shuf, r_mask = jax.random.split(
        jax.random.fold_in(jax.random.key(SEED), step), 5)
    nb = image.shape[1] // cube
    part, rec = j_cube.cube_shuffle_indices(r_mix, image.shape[0], nb,
                                            image.ndim - 2)
    noise = jnp.clip(0.1 * jax.random.normal(r_noise, image[labeled:].shape),
                     -0.2, 0.2)
    d = {"part": part, "rec": rec, "noise": noise}
    if recovery:
        d["perms"] = j_masked.make_shuffled_input(r_shuf, jnp.asarray(image),
                                                  cube)[1]
        d["vis"] = j_masked.make_masked_input(r_mask, jnp.asarray(image),
                                              cube, 0.25)[1]
    return {k: torch.from_numpy(np.asarray(a)) for k, a in d.items()}


class TMagicNet(MagicNetTrainer):
    """The port's trainer with JAX's draws."""

    def _draws(self, image):
        return _jax_draws(self.step, image.numpy(), self.labeled_bs,
                          self.cube_size, self.mask_recovery)


def _run_jax(trainer, batches, class_dist):
    _committed(trainer)
    logs = []
    for batch in batches:
        trainer.state, out = trainer._step(trainer.state, {
            "image": jnp.asarray(batch["image"]),
            "label": jnp.asarray(batch["label"]),
            "class_dist": jnp.asarray(class_dist, jnp.float32)})
        logs.append({k: np.asarray(v) for k, v in out.items()})
    return logs


def _assert_near_jax(got_sd, want, spread, keys=None):
    """Every tensor (of ``keys``) within 1e-5 of its max abs (+1e-6) plus
    3x ``spread``: the largest difference between two fp32 compilations
    of the JAX step itself (XLA's optimizations off and on) after the same
    update, measured in this run. The toys' gradients are ill-conditioned:
    instance norms over 2x2 and 4x4 maps whose variance can near eps, and
    the mix heads' train-mode BatchNorms over the position embedding's
    equal rows; there the two JAX compilations part by up to 6 % of the
    model's largest update (13 % in the position embedding)."""
    for k, w in want.items():
        if keys is not None and k not in keys:
            continue
        w = w.numpy()
        err = np.abs(_np(got_sd[k]) - w).max()
        tol = 1e-5 * np.abs(w).max() + 1e-6 + 3 * spread[k]
        assert err <= tol, (k, err, spread[k], np.abs(w).max())


@pytest.fixture(scope="module")
def jax_magic_2d():
    """Two JAX MagicNet steps (with --mask_recovery) on the toy
    magicnet_2D_mask: (start params and stats, the logs of each step, the
    params and EMA after step 1, each tensor's difference after step 1
    from the same step compiled with XLA's optimizations on)."""
    trainer = j_magic.MagicNetTrainer(
        j_net_factory("magicnet_2D_mask", **MAGIC_2D),
        _cfg(JTrainConfig, BATCH_2D, SIZE_2D), labeled_bs=LABELED_2D,
        cube_size=CUBE_2D, blend_after=0, mask_recovery=True,
        mesh=make_mesh(jax.devices()[:1]))
    start_state = jax.tree.map(jnp.copy, trainer.state)
    start = (_flat(start_state.params), _flat(start_state.batch_stats))
    batches = _batches(2, BATCH_2D, SIZE_2D)
    logs = _run_jax(trainer, batches[:1], CLASS_DIST)
    after1 = {"params": _flat(trainer.state.params),
              "ema": _flat(trainer.state.ema_params)}
    logs += _run_jax(trainer, batches[1:], CLASS_DIST)
    jax.config.update("jax_disable_most_optimizations", False)
    try:
        trainer._step = jax.jit(trainer._train_step, donate_argnums=(0,))
        trainer.state = start_state
        _run_jax(trainer, batches[:1], CLASS_DIST)
    finally:
        jax.config.update("jax_disable_most_optimizations", True)
    spread = {}
    for tag, tree in (("params", trainer.state.params),
                      ("ema", trainer.state.ema_params)):
        other = _flat(tree)
        spread[tag] = {k: np.abs(v - other[k]).max()
                       for k, v in after1[tag].items()}
    return start, logs, after1, spread


def _port_trainer(cls, model, params, stats, batch, size, **kw):
    model.load_state_dict(params_from_jax(params, like=model.state_dict(),
                                          batch_stats=stats))
    return cls(model, _cfg(TrainConfig, batch, size), device="cpu", **kw)


def _torch_spread(flat_spread):
    """A spread keyed by flax path -> keyed by the port's name."""
    from mamba_unet_torch.utils.convert import torch_key

    return {torch_key(k): v for k, v in flat_spread.items()}


def test_two_magicnet_steps_match_the_jax_trainer(jax_magic_2d):
    """Step 1 (pseudo-labels from the teacher): the loss terms, the three
    recovery MSEs and the consistency weight within 1e-5, the class
    histogram exactly, every parameter and the EMA as
    :func:`_assert_near_jax` holds them. Step 2 (pseudo-labels from the
    blend) from JAX's weights and EMA after step 1: the loss terms within
    1e-5 and the histogram exactly. (From the port's own step-1 weights,
    step 2's losses move by ~1e-4 and the blend's argmax by a few pixels,
    as they do between the two JAX compilations.)"""
    (params, stats), want_logs, after1, spread = jax_magic_2d
    trainer = _port_trainer(TMagicNet, net_factory("magicnet_2D_mask",
                                                   **MAGIC_2D),
                            params, stats, BATCH_2D, SIZE_2D,
                            labeled_bs=LABELED_2D, cube_size=CUBE_2D,
                            blend_after=0, mask_recovery=True)
    trainer.dist_logger.class_dist = CLASS_DIST.copy()
    keys = ("loss_total", "loss_sup", "loss_loc", "loss_cons", "loss_recv",
            "cons_weight")
    batches = _batches(2, BATCH_2D, SIZE_2D)
    for i, (batch, want) in enumerate(zip(batches, want_logs)):
        logs = trainer.train_step({k: torch.from_numpy(v)
                                   for k, v in batch.items()})
        for key in keys:
            np.testing.assert_allclose(float(logs[key]), float(want[key]),
                                       **TOL, err_msg=f"step {i + 1} {key}")
        np.testing.assert_array_equal(_np(logs["class_hist"]),
                                      want["class_hist"])
        if i == 0:
            want_params = params_from_jax(after1["params"])
            want_ema = params_from_jax(after1["ema"])
            _assert_near_jax(trainer.model.state_dict(), want_params,
                             _torch_spread(spread["params"]))
            _assert_near_jax(trainer.ema, want_ema,
                             _torch_spread(spread["ema"]))
            # step 2 from JAX's state
            trainer.model.load_state_dict(want_params, strict=False)
            for k, t in trainer.ema.items():
                t.copy_(want_ema[k])
    assert trainer.step == 2


def test_class_dist_refresh_and_resume(tmp_path):
    """The histogram becomes the class distribution every 20 steps (read
    once); the periodic checkpoint carries it and the EMA back."""
    cfg = _cfg(TrainConfig, BATCH_2D, SIZE_2D, snapshot_dir=str(tmp_path),
               ckpt_every=1)
    model = net_factory("magicnet_2D", **MAGIC_2D)
    trainer = MagicNetTrainer(model, cfg, labeled_bs=LABELED_2D,
                              cube_size=CUBE_2D, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _batches(1, BATCH_2D, SIZE_2D)[0].items()}
    hist = trainer.train_step(batch)["class_hist"]
    assert int(hist.sum()) == (BATCH_2D - LABELED_2D) * SIZE_2D ** 2
    trainer.step = 19
    trainer.train_step(batch)
    trainer._after_step(batch, {})
    dist = trainer.dist_logger.get_class_dist()
    assert dist.sum() == 2 * (BATCH_2D - LABELED_2D) * SIZE_2D ** 2
    assert int(trainer._hist.sum()) == 0
    trainer._save_periodic(trainer.step)
    fresh = MagicNetTrainer(net_factory("magicnet_2D", **MAGIC_2D),
                            _cfg(TrainConfig, BATCH_2D, SIZE_2D,
                                 snapshot_dir=str(tmp_path), resume=True),
                            labeled_bs=LABELED_2D, cube_size=CUBE_2D,
                            device="cpu")
    assert fresh.try_resume() == 20
    np.testing.assert_array_equal(fresh.dist_logger.get_class_dist(), dist)
    for k, t in trainer.ema.items():
        assert torch.equal(fresh.ema[k], t), k


def test_mask_recovery_step_on_mamba_unet_mask():
    """One --mask_recovery step of the toy ``MambaUnetMask`` (depths 1,
    64², batch 8, drop path 0, position embedding warm): finite terms, a
    recovery term, the location over 4 cubes, every parameter moved (the
    ones no loss reaches by their decay) and the BatchNorm statistics
    untouched (every train-mode pass throws them away)."""
    model = MambaUnetMask(**MASK_TOY, generator=torch.Generator()
                          .manual_seed(0))
    with torch.no_grad():
        model.pos_embed_layer.bn.bias.fill_(1.0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = MagicNetTrainer(model, _cfg(TrainConfig, MASK_BATCH,
                                          MASK_SIZE),
                              labeled_bs=MASK_LABELED, cube_size=MASK_CUBE,
                              mask_recovery=True, device="cpu")
    batch = _batches(1, MASK_BATCH, MASK_SIZE, seed=12)[0]
    logs = trainer.train_step({k: torch.from_numpy(v)
                               for k, v in batch.items()})
    for key in ("loss_total", "loss_sup", "loss_loc", "loss_cons",
                "loss_recv"):
        assert np.isfinite(float(logs[key])), key
    assert float(logs["loss_recv"]) > 0
    assert int(logs["class_hist"].sum()) == (
        (MASK_BATCH - MASK_LABELED) * MASK_SIZE ** 2)
    after = trainer.model.state_dict()
    for k, v in before.items():
        if "running" in k or "num_batches" in k:
            assert torch.equal(after[k], v), k
        else:
            assert not torch.equal(after[k], v), k


def test_magicnet_cli_refusals():
    """--mask_recovery outside magicnet, on a model without the mix-out
    head (where JAX fails with an AttributeError), --dataset btcv without
    magicnet or three patch ints, and a 3-D model on ACDC raise before any
    data is read."""
    base = ["--synthetic", "--device", "cpu", "--max_iterations", "1"]
    cases = [
        (NotImplementedError, ["--method", "mean_teacher",
                               "--mask_recovery"]),
        (ValueError, ["--method", "magicnet", "--model", "magicnet_2D",
                      "--mask_recovery", "--patch_size", "32", "32"]),
        (ValueError, ["--dataset", "btcv", "--method", "mean_teacher",
                      "--model", "magicnet", "--patch_size", "32", "32",
                      "32"]),
        (ValueError, ["--dataset", "btcv", "--method", "magicnet",
                      "--model", "magicnet", "--patch_size", "32", "32"]),
        (ValueError, ["--method", "magicnet", "--model", "magicnet",
                      "--patch_size", "32", "32"]),
    ]
    for err, extra in cases:
        with pytest.raises(err):
            train_cli.main(base + extra)
    with pytest.raises(ValueError, match="forward_mix_pos_mask"):
        MagicNetTrainer(net_factory("magicnet_2D", **MAGIC_2D),
                        _cfg(TrainConfig, 4, 32), mask_recovery=True,
                        device="cpu")
    with pytest.raises(ValueError, match="forward_encoder"):
        MagicNetTrainer(net_factory("unet", num_classes=4),
                        _cfg(TrainConfig, 4, 32), device="cpu")


def test_magicnet_cli_trains_on_acdc(tmp_path):
    """``--method magicnet --model magicnet_2D_mask --mask_recovery`` on
    phantom slices: two two-stream steps and an eval."""
    snap = os.path.join(tmp_path, "snap")
    assert train_cli.main([
        "--method", "magicnet", "--model", "magicnet_2D_mask",
        "--mask_recovery", "--synthetic", "--synthetic_spec", "2", "4", "1",
        "0", "32", "--device", "cpu", "--patch_size", "32", "32",
        "--cube_size", "16", "--batch_size", "4", "--labeled_bs", "2",
        "--max_iterations", "2", "--eval_every", "2", "--snapshot_dir",
        snap]) == 0
