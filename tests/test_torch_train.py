"""The PyTorch port's training slice against the JAX package.

Losses, optimizers, data pipeline and the whole train step are fed the same
numpy inputs (and, for the model, the same weights through
``params_from_jax``) as their JAX counterparts. Tolerances: 1e-6 for the
losses and the host-side numpy copies' arithmetic (fp32 in another order),
1e-6 for 5 optimizer steps, and for the toy Mamba-UNet's two train steps
1e-5 on the losses and 1e-6 on the parameters (fp32 scans and matmuls in
another order; measured on this CPU: 3.6e-7 and 1.5e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.cli import test as test_cli  # noqa: E402
from mamba_unet_torch.cli import train as train_cli  # noqa: E402
from mamba_unet_torch.data import augment as t_aug  # noqa: E402
from mamba_unet_torch.data.acdc import SliceDataset  # noqa: E402
from mamba_unet_torch.data.loader import Loader  # noqa: E402
from mamba_unet_torch.data.sampler import EpochShuffleSampler  # noqa: E402
from mamba_unet_torch.data.synthetic import phantom_acdc  # noqa: E402
from mamba_unet_torch.models.vssm import MambaUnet as TMambaUnet  # noqa: E402
from mamba_unet_torch.objectives import losses as t_loss  # noqa: E402
from mamba_unet_torch.train import optim as t_optim  # noqa: E402
from mamba_unet_torch.train.trainer import (  # noqa: E402
    TrainConfig,
    Trainer,
    fully_supervised_loss,
)
from mamba_unet_torch.utils.checkpoint import load_model_snapshot  # noqa: E402
from mamba_unet_torch.utils.convert import params_from_jax  # noqa: E402
from mamba_unet_tpu import data as j_data  # noqa: E402
from mamba_unet_tpu.models.vssm import MambaUnet as JMambaUnet  # noqa: E402
from mamba_unet_tpu.objectives import losses as j_loss  # noqa: E402
from mamba_unet_tpu.parallel import make_mesh  # noqa: E402
from mamba_unet_tpu.train import TrainConfig as JTrainConfig  # noqa: E402
from mamba_unet_tpu.train import Trainer as JTrainer  # noqa: E402
from mamba_unet_tpu.train import optim as j_optim  # noqa: E402

TOY = dict(depths=(2, 2), dims=(16, 32))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on a few cores, and torch's default of one thread per core
    oversubscribed them (a 3 s test took minutes under that load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def fast_jax_compiles():
    """XLA's cheaper compile while this file runs: the JAX references are
    compile-bound."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def _committed(trainer):
    """``trainer`` with every JAX array it holds committed to its state's
    sharding, as its jitted step returns them: the step then compiles once
    for every step (a leaf of the initial state left uncommitted makes the
    second call another signature, and a second compile)."""
    for name, value in list(vars(trainer).items()):
        leaves = [a for a in jax.tree.leaves(value) if isinstance(a, jax.Array)]
        committed = [a for a in leaves if a.committed]
        if committed and len(committed) < len(leaves):
            sharding = committed[0].sharding
            setattr(trainer, name, jax.tree.map(
                lambda a: jax.device_put(a, sharding)
                if isinstance(a, jax.Array) else a, value))
    return trainer


# --- losses -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["ce", "ce_ignore", "dice", "ce_dice"])
def test_losses_and_logit_gradients_match_jax(rng, name):
    logits = (2 * rng.normal(size=(3, 9, 7, 4))).astype(np.float32)
    labels = rng.integers(0, 4, size=(3, 9, 7))
    if name == "ce_ignore":
        labels[rng.random(labels.shape) < 0.3] = 4  # the ignore index

    def j_fn(x):
        if name == "ce":
            return j_loss.cross_entropy_loss(x, jnp.asarray(labels))
        if name == "ce_ignore":
            return j_loss.cross_entropy_loss(x, jnp.asarray(labels),
                                             ignore_index=4)
        if name == "dice":
            return j_loss.dice_loss_from_labels(jax.nn.softmax(x, -1),
                                                jnp.asarray(labels))
        return j_loss.supervised_ce_dice(x, jnp.asarray(labels))

    def t_fn(x):
        lab = torch.from_numpy(labels)
        if name == "ce":
            return t_loss.cross_entropy_loss(x, lab)
        if name == "ce_ignore":
            return t_loss.cross_entropy_loss(x, lab, ignore_index=4)
        if name == "dice":
            return t_loss.dice_loss_from_labels(torch.softmax(x, -1), lab)
        return t_loss.supervised_ce_dice(x, lab)

    want, want_grad = jax.value_and_grad(j_fn)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = t_fn(x)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-6)


def test_weighted_dice_matches_jax(rng):
    probs = rng.random((2, 5, 5, 3)).astype(np.float32)
    onehot = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 5, 5))]
    w = [0.2, 1.0, 2.0]
    np.testing.assert_allclose(
        t_loss.dice_loss(torch.from_numpy(probs), torch.from_numpy(onehot),
                         w).item(),
        float(j_loss.dice_loss(jnp.asarray(probs), jnp.asarray(onehot), w)),
        rtol=1e-6)


# --- optimizers ---------------------------------------------------------------

@pytest.mark.parametrize("which", ["poly_sgd", "warmup_adamw"])
def test_optimizers_match_optax_over_5_steps(rng, which):
    shapes = {"w": (4, 3), "b": (3,), "A_logs": (2, 5)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    if which == "poly_sgd":
        tx = j_optim.poly_sgd(0.05, max_iters=8)
        make = lambda p: t_optim.poly_sgd(p, 0.05, max_iters=8)  # noqa: E731
    else:
        tx = j_optim.warmup_adamw(0.01, max_iters=8, warmup_iters=2)
        make = lambda p: t_optim.warmup_adamw(  # noqa: E731
            p, 0.01, max_iters=8, warmup_iters=2)

    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in init.items()}
    opt, sched = make(list(tparams.values()))
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_poly_lr_matches_jax():
    for k in (0, 1, 7, 99):
        assert t_optim.poly_lr(0.01, 100)(k) == pytest.approx(
            float(j_optim.poly_lr(0.01, 100)(k)), rel=1e-12)


# --- data ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def acdc_h5(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_port")
    return j_data.make_synthetic_acdc(str(root), n_train_cases=2,
                                      slices_per_case=4, n_val_cases=1,
                                      size=40, seed=3)


def test_slice_dataset_augment_and_sampler_match_jax(acdc_h5):
    """SliceDataset + RandomGenerator + EpochShuffleSampler: the same
    batches as the JAX pipeline for one seed, two epochs."""
    t_ds = SliceDataset(acdc_h5, num=7,
                        transform=t_aug.RandomGenerator((32, 32), seed=5))
    j_ds = j_data.SliceDataset(acdc_h5, num=7,
                               transform=j_data.RandomGenerator((32, 32),
                                                                seed=5))
    assert len(t_ds) == len(j_ds) == 7 and t_ds.ids == j_ds.ids
    t_s = EpochShuffleSampler(len(t_ds), 3, seed=2)
    j_s = j_data.EpochShuffleSampler(len(j_ds), 3, seed=2)
    assert len(t_s) == len(j_s) == 2
    for _ in range(2):
        for ti, ji in zip(t_s, j_s):
            assert ti == ji
            for i in ti:
                a, b = t_ds[i], j_ds[i]
                assert a["idx"] == b["idx"] == i
                np.testing.assert_array_equal(a["image"], b["image"])
                np.testing.assert_array_equal(a["label"], b["label"])
                assert a["image"].dtype == np.float32
                assert a["label"].dtype == np.int64


def test_augment_functions_match_jax(rng):
    img = rng.random((20, 24)).astype(np.float32)
    lab = rng.integers(0, 4, (20, 24))
    for seed in range(6):
        t_rng, j_rng = (np.random.default_rng(seed) for _ in range(2))
        for a, b in zip(t_aug.random_rot_flip(t_rng, img, lab),
                        j_data.random_rot_flip(j_rng, img, lab)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(t_aug.random_rotate(t_rng, img, lab, 4.0),
                        j_data.random_rotate(j_rng, img, lab, 4.0)):
            np.testing.assert_array_equal(a, b)


def test_phantom_acdc_holds_the_synthetic_h5_arrays(acdc_h5):
    """phantom_acdc draws what make_synthetic_acdc writes (same seed)."""
    splits = phantom_acdc(2, 4, 1, 0, 40, seed=3)
    ds = SliceDataset(acdc_h5)
    assert len(splits["train"]) == len(ds) == 8
    for i, s in enumerate(splits["train"]):
        np.testing.assert_array_equal(s["image"], ds[i]["image"])
        np.testing.assert_array_equal(s["label"], ds[i]["label"])
    vol = j_data.VolumeDataset(acdc_h5, "val")[0]
    np.testing.assert_array_equal(splits["val"][0]["image"], vol["image"])
    np.testing.assert_array_equal(splits["val"][0]["label"], vol["label"])
    mem = SliceDataset.from_samples(splits["train"])
    np.testing.assert_array_equal(mem[5]["image"], ds[5]["image"])


def test_loader_collates_compact_batches_on_the_device():
    samples = [{"image": np.full((4, 4, 1), i, np.float32),
                "label": np.full((4, 4), i % 4, np.int64)} for i in range(6)]
    ds = SliceDataset.from_samples(
        [{"image": s["image"][..., 0], "label": s["label"]} for s in samples],
        transform=lambda s: {"image": s["image"][..., None],
                             "label": s["label"]})
    batches = list(Loader(ds, [[0, 1], [2, 3, 4]], device="cpu", epochs=2))
    assert len(batches) == 4
    b = batches[1]
    assert b["image"].shape == (3, 4, 4, 1) and b["image"].dtype == torch.float32
    assert b["label"].dtype == torch.uint8 and b["idx"].tolist() == [2, 3, 4]
    np.testing.assert_array_equal(b["label"][:, 0, 0].numpy(), [2, 3, 0])

    def boom(_):
        raise KeyError("bad sample")

    with pytest.raises(KeyError):
        list(Loader(SliceDataset.from_samples(samples[:2], transform=boom),
                    [[0, 1]], device="cpu", epochs=1))


# --- the slice as a whole -----------------------------------------------------

def _batches(n, bsz=2, size=32, seed=11):
    r = np.random.default_rng(seed)
    return [{"image": r.random((bsz, size, size, 1), np.float32),
             "label": r.integers(0, 4, (bsz, size, size))}
            for _ in range(n)]


def _cfg(cls, **kw):
    return cls(base_lr=0.05, max_iterations=10, batch_size=2,
               patch_size=(32, 32), num_classes=4, eval_every=10**6,
               log_every=1, seed=0, **kw)


def _port_trainer(state_dict, **kw):
    model = TMambaUnet(num_classes=4, drop_path_rate=0.0, **TOY)
    model.load_state_dict(state_dict)
    return Trainer(model, _cfg(TrainConfig, **kw), device="cpu")


def _as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_two_steps():
    """The JAX Trainer (poly-SGD, fp32) on a one-device mesh: initial
    weights, two steps' losses, final weights. Its scan is JAX's plain
    sequential reference (``scan_impl="ref"``, the function of its Pallas
    kernel, which ``tests/test_torch_tm.py`` and ``test_torch_model.py``
    hold the port to), a third of the compile."""
    model = JMambaUnet(img_size=32, num_classes=4, drop_path_rate=0.0,
                       scan_impl="ref", **TOY)
    trainer = JTrainer(model, _cfg(JTrainConfig),
                       mesh=make_mesh(jax.devices()[:1]))
    init = _flat(trainer.state.params)
    result = _committed(trainer).fit(_batches(2))
    losses = [h["loss"] for h in result["history"]]
    return init, losses, _flat(trainer.state.params)


def test_two_train_steps_match_the_jax_trainer(jax_two_steps):
    init, want_losses, want_params = jax_two_steps
    like = TMambaUnet(num_classes=4, **TOY).state_dict()
    trainer = _port_trainer(params_from_jax(init, like=like))
    result = trainer.fit([_as_torch(b) for b in _batches(2)])
    assert result["iterations"] == 2 and trainer.step == 2
    losses = [h["loss"] for h in result["history"]]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-5)
    want = params_from_jax(want_params, like=like)
    got = trainer.model.state_dict()
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        moved += not torch.equal(w, params_from_jax(init, like=like)[k])
    assert moved > 0.9 * len(want)  # weight decay moves nearly all


def test_resume_continues_as_one_run(tmp_path):
    """2 steps + periodic checkpoint + resume + 2 steps == 4 steps."""
    start = TMambaUnet(num_classes=4, drop_path_rate=0.3, **TOY,
                       generator=torch.Generator().manual_seed(0)
                       ).state_dict()
    batches = [_as_torch(b) for b in _batches(4)]
    whole = _port_trainer(start)
    whole.fit(batches)
    snap = str(tmp_path / "snap")
    first = _port_trainer(start, snapshot_dir=snap, ckpt_every=2)
    assert first.fit(batches[:2])["iterations"] == 2
    second = _port_trainer(start, snapshot_dir=snap, ckpt_every=2,
                           resume=True)
    assert second.try_resume() == 2
    second = _port_trainer(start, snapshot_dir=snap, ckpt_every=2,
                           resume=True)
    result = second.fit(batches[2:])
    assert result["iterations"] == 4
    for k, v in whole.model.state_dict().items():
        torch.testing.assert_close(second.model.state_dict()[k], v,
                                   rtol=0, atol=0, msg=k)


def test_drop_path_draws_from_the_trainers_generator():
    """Same seed and step: same masks; the model's DropPaths hold the
    trainer's generator, and eval mode draws nothing."""
    start = TMambaUnet(num_classes=4, drop_path_rate=0.5, **TOY,
                       generator=torch.Generator().manual_seed(0)
                       ).state_dict()
    batch = _as_torch(_batches(1)[0])
    a, b = _port_trainer(start), _port_trainer(start)
    assert a.train_step(batch)["loss_total"] == b.train_step(batch)[
        "loss_total"]
    paths = [m for m in a.model.modules() if hasattr(m, "generator")]
    assert paths and all(m.generator is a.generator for m in paths)


def test_grad_accum_averages_microbatch_gradients():
    """k=2 microbatches of one sample each: the mean of their gradients
    (the Dice term is per microbatch, as in the JAX trainer)."""
    start = TMambaUnet(num_classes=4, drop_path_rate=0.0, **TOY,
                       generator=torch.Generator().manual_seed(1)
                       ).state_dict()
    batch = _as_torch(_batches(1)[0])
    acc = _port_trainer(start, grad_accum_steps=2)
    acc.train_step(batch)
    sums = {}
    for i in range(2):
        one = _port_trainer(start)
        one.optimizer.zero_grad()
        half = {k: v[i:i + 1] for k, v in batch.items()}
        loss, _ = fully_supervised_loss(
            one.model, {"image": half["image"],
                        "label": half["label"].long()})
        loss.backward()
        for k, p in one.model.named_parameters():
            sums[k] = sums.get(k, 0) + p.grad / 2
    ref = _port_trainer(start)
    for k, p in ref.model.named_parameters():
        p.grad = sums[k]
    ref.optimizer.step()
    for k, v in ref.model.state_dict().items():
        torch.testing.assert_close(acc.model.state_dict()[k], v, rtol=1e-5,
                                   atol=1e-6, msg=k)
    with pytest.raises(ValueError):
        _port_trainer(start, grad_accum_steps=3)


# --- the CLIs -----------------------------------------------------------------

def test_train_cli_synthetic_on_cpu(tmp_path):
    """A few iterations on phantom slices, one eval, best and periodic
    checkpoints; the best one loads into the test CLI's model."""
    snap = tmp_path / "snap"
    assert train_cli.main([
        "--model", "ViM_seg", "--synthetic", "--device", "cpu",
        "--patch_size", "32", "32",
        "--batch_size", "4", "--max_iterations", "4", "--eval_every", "4",
        "--ckpt_every", "2", "--synthetic_spec", "2", "4", "1", "0", "40",
        "--drop_path", "0.1", "--snapshot_dir", str(snap)]) == 0
    names = sorted(p.name for p in snap.iterdir())
    assert "state_2" in names and "state_4" in names
    assert "best_4" in names and "best_marks.json" in names
    model = load_model_snapshot("ViM_seg", 4, 1, str(snap / "best_4"),
                                device="cpu")
    assert not model.training
    with pytest.raises(ValueError):  # every method is ported: unknown
        train_cli.main(["--method", "no_such_method", "--device", "cpu"])


@pytest.mark.parametrize("cli", ["train", "test"])
def test_clis_raise_on_cuda_without_a_card(cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main = train_cli.main if cli == "train" else test_cli.main
    assert train_cli.build_parser().parse_args([]).device == "cuda"
    assert test_cli.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--synthetic"] if cli == "train" else [])
