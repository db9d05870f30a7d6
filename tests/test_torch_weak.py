"""The PyTorch port's Weak-Mamba-UNet (``--method weak_scribble``) against
the JAX package, with the ``ViT_seg`` warm start and the export of the
UNet family and Swin-UNet.

* Scribbles (``data/scribble.py``), the scribbled phantom splits and the
  scribble sample of ``SliceDataset`` + ``RandomGenerator(label_cval=4)``
  are bitwise equal to JAX's for the same seed.
* Two ``WeakScribbleTrainer`` steps of a toy UNet + toy Swin-UNet + toy
  Mamba-UNet at 32² run from the same weights and batches on both sides,
  dropout and drop-path at 0, the port's mix weights overridden to JAX's
  own Dirichlet draw for the step: losses, every parameter and the
  BatchNorm statistics within 1e-5 (fp32 in another summation order).
  The pCE-only step (three toy UNets): the pseudo-label Dice is exactly 0
  on both sides, the losses within 1e-5.
* Port-only: the mix weights come from the trainer's generator; a resumed
  trio run equals the uninterrupted one exactly; the train CLI with its
  default trio (toy-sized) writes ``best``/``best2``/``best3`` and
  ``cli.test --ckpt_name best3`` serves model 3.
* The ``ViT_seg`` warm start loads what JAX's ``convert_vssm`` loads on
  the ``swin_unet`` root, with the same values and report counts; the
  toy ``unet`` and ``ViT_seg`` export with a symbolic batch and serve
  eager's logits exactly.
"""

import functools

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.cli import export as export_cli  # noqa: E402
from mamba_unet_torch.cli import test as test_cli  # noqa: E402
from mamba_unet_torch.cli import train as train_cli  # noqa: E402
from mamba_unet_torch.data import scribble as t_scribble  # noqa: E402
from mamba_unet_torch.data import synthetic as t_syn  # noqa: E402
from mamba_unet_torch.data.acdc import SliceDataset  # noqa: E402
from mamba_unet_torch.data.augment import RandomGenerator  # noqa: E402
from mamba_unet_torch.models import swin_unet as t_swin_unet  # noqa: E402
from mamba_unet_torch.models import vssm as t_vssm  # noqa: E402
from mamba_unet_torch.models.unet import UNet as TUNet  # noqa: E402
from mamba_unet_torch.train.trainer import TrainConfig  # noqa: E402
from mamba_unet_torch.train.weak import WeakScribbleTrainer  # noqa: E402
from mamba_unet_torch.utils.checkpoint import (  # noqa: E402
    load_model_snapshot,
    save_checkpoint,
)
from mamba_unet_torch.utils.convert import (  # noqa: E402
    load_torch_checkpoint,
    load_upstream_state,
    params_from_jax,
)
from mamba_unet_torch.utils.export import (  # noqa: E402
    export_predict,
    load_exported,
    make_predict_fn,
    save_exported,
)
from mamba_unet_tpu.data import acdc as j_acdc  # noqa: E402
from mamba_unet_tpu.data import augment as j_augment  # noqa: E402
from mamba_unet_tpu.data import scribble as j_scribble  # noqa: E402
from mamba_unet_tpu.data import synthetic as j_syn  # noqa: E402
from mamba_unet_tpu.models.swin_unet import SwinUnet as JSwinUnet  # noqa: E402
from mamba_unet_tpu.models.unet import UNet as JUNet  # noqa: E402
from mamba_unet_tpu.models.vssm import MambaUnet as JMambaUnet  # noqa: E402
from mamba_unet_tpu.parallel import make_mesh  # noqa: E402
from mamba_unet_tpu.train import TrainConfig as JTrainConfig  # noqa: E402
from mamba_unet_tpu.train import weak as j_weak  # noqa: E402
from mamba_unet_tpu.utils import convert as j_convert  # noqa: E402

FT = (4, 8, 16, 32, 64)
NO_DROP = (0.0,) * 5
TOY_VIM = dict(depths=(1, 1), dims=(16, 32))
# window 4 at 32²: stage maps 8, 4, 2, 1 (stage 0 shifts its windows)
TOY_SWIN = dict(embed_dim=24, num_heads=(1, 2, 4, 8), window_size=4)
BATCH, SIZE, SEED = 4, 32, 0
TOL = dict(rtol=1e-5, atol=1e-5)


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
    """XLA's cheaper compile while this file runs: the JAX references are
    compiled once each and run a few times, so compile time is most of
    their cost."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _toy_models(monkeypatch):
    """``net_factory``'s ``ViM_seg`` and ``ViT_seg`` become the toys, so
    the CLIs build the default trio in seconds (full-width ``ViT_seg``
    tiles only 224k inputs into its 7x7 windows)."""
    monkeypatch.setattr(t_vssm, "MambaUnet",
                        functools.partial(t_vssm.MambaUnet, **TOY_VIM))
    monkeypatch.setattr(t_swin_unet, "SwinUnet",
                        functools.partial(t_swin_unet.SwinUnet, **TOY_SWIN))


# --- the data: scribbles, scribbled phantoms, the scribble sample -----------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scribbles_match_jax(seed):
    """The same walks from the same generator, on a phantom label and on a
    background-only one (no class is invented)."""
    _, label = t_syn._phantom(np.random.default_rng(seed), 48, 48)
    for mask in (label, np.zeros((20, 24), np.uint8)):
        got = t_scribble.scribbles_from_mask(mask, np.random.default_rng(seed))
        want = j_scribble.scribbles_from_mask(mask,
                                              np.random.default_rng(seed))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        ann = got != 4
        np.testing.assert_array_equal(got[ann], mask[ann])
        assert set(np.unique(got)) == set(np.unique(mask)) | {4}


@pytest.fixture(scope="module")
def jax_scribbled_set(tmp_path_factory):
    """JAX's scribbled h5 set: 2 cases x 3 slices, 2 val and 1 test
    volumes at 40², seed 3."""
    root = str(tmp_path_factory.mktemp("weak_acdc"))
    return j_syn.make_synthetic_acdc(root, 2, 3, 2, 1, size=40, seed=3,
                                     scribble=True)


def test_scribbled_phantom_matches_jax_h5(jax_scribbled_set):
    """The scribbles draw from the phantom's generator right after their
    slice, so they shift every later slice and the volumes: the port's
    splits equal the h5 set array for array."""
    root = jax_scribbled_set
    splits = t_syn.phantom_acdc(2, 3, 2, 1, 40, seed=3, scribble=True)
    ids = j_acdc._read_list(f"{root}/train_slices.list")
    assert len(ids) == len(splits["train"]) == 6
    for sid, got in zip(ids, splits["train"]):
        with h5py.File(f"{root}/data/slices/{sid}.h5") as f:
            for key in ("image", "label", "scribble"):
                np.testing.assert_array_equal(got[key], f[key][()],
                                              err_msg=f"{sid} {key}")
    for split in ("val", "test"):
        for got, want in zip(splits[split], j_acdc.VolumeDataset(root,
                                                                  split)):
            assert got["case"] == want["case"]
            np.testing.assert_array_equal(got["image"], want["image"])
            np.testing.assert_array_equal(got["label"], want["label"])
    plain = t_syn.phantom_acdc(2, 3, 2, 1, 40, seed=3)
    assert "scribble" not in plain["train"][0]
    assert not np.array_equal(plain["val"][0]["image"],
                              splits["val"][0]["image"])


def test_scribble_samples_match_jax(jax_scribbled_set):
    """``from_samples(sup_type="scribble")`` with ``RandomGenerator(
    label_cval=4)`` gives JAX's ``SliceDataset(sup_type="scribble")``
    samples for a seed: rotated corners hold the ignore index."""
    splits = t_syn.phantom_acdc(2, 3, 2, 1, 40, seed=3, scribble=True)
    got = SliceDataset.from_samples(
        splits["train"], sup_type="scribble",
        transform=RandomGenerator((32, 32), seed=7, label_cval=4))
    want = j_acdc.SliceDataset(
        jax_scribbled_set, sup_type="scribble",
        transform=j_augment.RandomGenerator((32, 32), seed=7, label_cval=4))
    for _ in range(3):  # epochs: the transform's generator runs on
        for i in range(len(want)):
            a, b = got[i], want[i]
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])
            assert a["label"].max() == 4
    assert SliceDataset.from_samples(splits["train"])[0]["label"].max() < 4


# --- the trainer against the JAX trainer -------------------------------------

def _batches(n, seed=11):
    """Images and scribble-like labels: 80 % of the pixels unlabeled."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = r.integers(0, 4, (BATCH, SIZE, SIZE))
        label[r.random(label.shape) < 0.8] = 4
        out.append({"image": r.random((BATCH, SIZE, SIZE, 1), np.float32),
                    "label": label})
    return out


def _as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _cfg(cls, **kw):
    return cls(base_lr=0.05, max_iterations=10, batch_size=BATCH,
               patch_size=(SIZE, SIZE), num_classes=4, eval_every=10**6,
               log_every=1, seed=SEED, **kw)


@functools.lru_cache(maxsize=None)
def _jax_mix(step):
    """The JAX step's mix weights: Dirichlet(1, 1, 1) on r_mix."""
    key = jax.random.split(jax.random.fold_in(jax.random.key(SEED), step),
                           4)[3]
    return np.asarray(jax.jit(lambda k: jax.random.dirichlet(
        k, jnp.ones((3,), jnp.float32)))(key))


class TWeak(WeakScribbleTrainer):
    def _mix_weights(self):
        return torch.from_numpy(_jax_mix(self.step))


def _jax_trio(models, n_steps, **kw):
    """(initial (params, batch_stats) per model, losses of ``n_steps`` fit
    steps, final (params, batch_stats) per model) of the JAX trainer."""
    trainer = j_weak.WeakScribbleTrainer(
        models[0], _cfg(JTrainConfig), model2=models[1], model3=models[2],
        mesh=make_mesh(jax.devices()[:1]), **kw)
    states = lambda t: [(_flat(s.params), _flat(s.batch_stats))  # noqa: E731
                        for s in (t.s1, t.s2, t.s3)]
    start = states(trainer.tri)
    result = trainer.fit(_batches(n_steps))
    return start, [h["loss"] for h in result["history"]], states(trainer.tri)


@pytest.fixture(scope="module")
def jax_weak():
    return _jax_trio(
        (JUNet(num_classes=4, ft_chns=FT, dropout=NO_DROP),
         JSwinUnet(img_size=SIZE, num_classes=4, drop_path_rate=0.0,
                   **TOY_SWIN),
         JMambaUnet(img_size=SIZE, num_classes=4, drop_path_rate=0.0,
                    **TOY_VIM)), 2)


def _port_models(start, toys):
    models = []
    for (params, stats), make in zip(start, toys):
        model = make()
        model.load_state_dict(params_from_jax(
            params, like=model.state_dict(), batch_stats=stats))
        models.append(model)
    return models


def _assert_state(model, params, stats, steps):
    want = params_from_jax(params, like=model.state_dict(),
                           batch_stats=stats, num_batches_tracked=steps)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), **TOL,
                                   err_msg=k)


TOYS = (lambda: TUNet(num_classes=4, ft_chns=FT, dropout=NO_DROP),
        lambda: t_swin_unet.SwinUnet(img_size=SIZE, num_classes=4,
                                     drop_path_rate=0.0, **TOY_SWIN),
        lambda: t_vssm.MambaUnet(num_classes=4, drop_path_rate=0.0,
                                 **TOY_VIM))


def test_two_weak_steps_match_the_jax_trainer(jax_weak):
    """UNet + Swin-UNet + Mamba-UNet, two steps: losses, every parameter
    and the UNet's BatchNorm statistics."""
    start, want_losses, want = jax_weak
    m1, m2, m3 = _port_models(start, TOYS)
    trainer = TWeak(m1, _cfg(TrainConfig), model2=m2, model3=m3,
                    device="cpu")
    result = trainer.fit([_as_torch(b) for b in _batches(2)])
    assert result["iterations"] == trainer.step == 2
    np.testing.assert_allclose([h["loss"] for h in result["history"]],
                               want_losses, **TOL)
    for model, (params, stats), (init, _) in zip(
            (trainer.model, trainer.model2, trainer.model3), want, start):
        _assert_state(model, params, stats, 2)
        moved = sum(not torch.equal(v, params_from_jax(init)[k])
                    for k, v in model.named_parameters())
        assert moved > 0.9 * len(init)


@pytest.fixture(scope="module")
def jax_pce_only():
    unets = tuple(JUNet(num_classes=4, ft_chns=FT, dropout=NO_DROP)
                  for _ in range(3))
    trainer = j_weak.WeakScribbleTrainer(
        unets[0], _cfg(JTrainConfig), model2=unets[1], model3=unets[2],
        mesh=make_mesh(jax.devices()[:1]), pce_only=True)
    start = [(_flat(s.params), _flat(s.batch_stats))
             for s in (trainer.tri.s1, trainer.tri.s2, trainer.tri.s3)]
    batch = _batches(1)[0]
    _, logs = trainer._tri_step(trainer.tri, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
    return start, {k: float(v) for k, v in logs.items()}


def test_pce_only_step_matches_jax(jax_pce_only):
    """The pCE-only ablation: the pseudo-label Dice is exactly 0 on both
    sides, and the step's losses agree."""
    start, want = jax_pce_only
    models = _port_models(start, (TOYS[0],) * 3)
    trainer = TWeak(models[0], _cfg(TrainConfig), model2=models[1],
                    model3=models[2], pce_only=True, device="cpu")
    logs = trainer.train_step(_as_torch(_batches(1)[0]))
    assert want["loss_pseudo_dice"] == 0.0
    assert float(logs["loss_pseudo_dice"]) == 0.0
    for key in ("loss_total", "loss_model1", "loss_model2", "loss_model3",
                "loss_pce"):
        np.testing.assert_allclose(float(logs[key]), want[key], **TOL,
                                   err_msg=key)
    np.testing.assert_allclose(float(logs["loss_total"]),
                               float(logs["loss_pce"]), rtol=0, atol=0)


# --- port-only: the mix weights, resume -------------------------------------

def _unet_trio(snap=None, **kw):
    """Three toy UNets with dropout, seeds 0-2, as a trainer."""
    cfg = _cfg(TrainConfig, snapshot_dir=snap, ckpt_every=2, **kw)
    m1, m2, m3 = (TUNet(num_classes=4, ft_chns=FT,
                        generator=torch.Generator().manual_seed(s))
                  for s in range(3))
    return WeakScribbleTrainer(m1, cfg, model2=m2, model3=m3, device="cpu")


def test_mix_weights_come_from_the_trainers_generator():
    """Dirichlet(1, 1, 1) on the simplex, a function of (seed, step) only:
    the global RNG neither feeds nor sees the draw."""
    a, b = _unet_trio(), _unet_trio()
    torch.manual_seed(0)
    first = a._mix_weights()
    state = torch.random.get_rng_state()
    torch.manual_seed(1)
    assert torch.equal(b._mix_weights(), first)
    torch.manual_seed(0)
    a._mix_weights()
    assert torch.equal(torch.random.get_rng_state(), state)
    assert (first > 0).all() and float(first.sum()) == pytest.approx(1.0)
    a.step = 1
    assert not torch.equal(a._mix_weights(), first)


def test_trio_resume_continues_as_one_run(tmp_path):
    """2 steps + periodic checkpoint + resume + 2 steps == 4 steps, all
    three models (with dropout: the generator's streams resume too)."""
    batches = [_as_torch(b) for b in _batches(4)]
    whole = _unet_trio()
    whole.fit(batches)
    snap = str(tmp_path / "snap")
    assert _unet_trio(snap).fit(batches[:2])["iterations"] == 2
    second = _unet_trio(snap, resume=True)
    assert second.fit(batches[2:])["iterations"] == 4
    for a, b in zip(whole._members(), second._members()):
        for k, v in a[0].state_dict().items():
            torch.testing.assert_close(b[0].state_dict()[k], v, rtol=0,
                                       atol=0, msg=k)
        assert a[2].state_dict() == b[2].state_dict()


def test_weak_scribble_through_the_train_and_test_clis(tmp_path,
                                                       monkeypatch):
    """The default trio (``unet``, ``ViT_seg``, ``ViM_seg``; the latter
    two toy-sized) on scribbled phantoms: ``best``/``best2``/``best3`` and
    the periodic checkpoint written, each best loading strictly into its
    model, and ``cli.test --ckpt_name best3`` serving model 3."""
    _toy_models(monkeypatch)
    snap = tmp_path / "snap"
    assert train_cli.main([
        "--method", "weak_scribble", "--synthetic", "--device", "cpu",
        "--patch_size", str(SIZE), str(SIZE), "--batch_size", "4",
        "--max_iterations", "2", "--eval_every", "2", "--ckpt_every", "2",
        "--synthetic_spec", "2", "4", "1", "1", "40", "--drop_path", "0.1",
        "--snapshot_dir", str(snap)]) == 0
    names = sorted(p.name for p in snap.iterdir())
    assert {"best_2", "best2_2", "best3_2", "state_2"} <= set(names), names
    args = train_cli.build_parser().parse_args(["--method", "weak_scribble"])
    assert (args.model, args.model2, args.model3) == ("unet", None, None)
    for name, ckpt, kw in (("unet", "best", {}),
                           ("ViT_seg", "best2", {"img_size": SIZE}),
                           ("ViM_seg", "best3", {})):
        model = load_model_snapshot(name, 4, 1, str(snap), device="cpu",
                                    ckpt_name=ckpt, **kw)
        assert not model.training
    cases = t_syn.phantom_acdc(2, 4, 1, 1, 40, scribble=True)["test"]
    out = test_cli.run_inference(test_cli.build_parser().parse_args([
        "--model", "ViM_seg", "--patch_size", str(SIZE), str(SIZE),
        "--device", "cpu", "--checkpoint", str(snap), "--ckpt_name",
        "best3"]), dataset=cases)
    assert out["per_case"].shape == (1, 3, 3)
    assert np.isfinite(out["per_case"]).all()


# --- the ViT_seg warm start, export of unet and ViT_seg ----------------------

def test_vit_seg_warm_start_matches_jax_convert_vssm(tmp_path):
    """An encoder-only Swin checkpoint (``{"model": sd}``, ``swin_unet.``
    prefix, one tensor of the wrong shape) into JAX (``convert_vssm`` on
    the ``swin_unet`` root, ``mirror_decoder=True``) and into the port:
    the same report counts and every parameter equal, the decoder stages
    holding their mirrored encoder stages."""
    source = t_swin_unet.SwinUnet(img_size=64, drop_path_rate=0.0,
                                  generator=torch.Generator().manual_seed(3),
                                  **TOY_SWIN)
    sd = {f"swin_unet.{k}": v for k, v in
          source.swin_unet.state_dict().items()
          if k.startswith(("layers.", "patch_embed."))}
    sd["swin_unet.patch_embed.proj.weight"] = torch.zeros(24, 3, 2, 2)
    path = str(tmp_path / "swin_encoder.pth")
    torch.save({"model": sd}, path)

    # JAX's parameter shapes (no compiled init) with seeded values, which
    # the tensors the checkpoint does not hold keep
    shapes = jax.eval_shape(
        JSwinUnet(img_size=64, drop_path_rate=0.0, **TOY_SWIN).init,
        jax.random.key(0), jnp.zeros((1, 64, 64, 1)))
    rng = np.random.default_rng(5)
    template = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)
    params, j_report = j_convert.convert_vssm(
        j_convert.load_torch_checkpoint(path),
        template["params"]["swin_unet"], mirror_decoder=True)
    port = t_swin_unet.SwinUnet(img_size=64, drop_path_rate=0.0, **TOY_SWIN)
    port.load_state_dict(params_from_jax(_flat(template["params"]),
                                         like=port.state_dict()))
    t_report = load_upstream_state(port, load_torch_checkpoint(path))
    for key in ("loaded", "missing", "shape_skipped"):
        assert len(t_report[key]) == len(j_report[key]), key
    assert sorted(t_report["loaded"]) == sorted(j_report["loaded"])
    assert t_report["shape_skipped"] == [
        ("patch_embed.proj.weight", (24, 3, 2, 2), (24, 3, 4, 4))]
    assert len(t_report["loaded"]) > 100 and t_report["missing"]
    want = params_from_jax(_flat({"swin_unet": params}))
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    for up, down in ((2, 1), (1, 2)):  # the mirrored encoder stages
        torch.testing.assert_close(
            port.swin_unet.layers_up[up].blocks[0].attn.qkv.weight,
            source.swin_unet.layers[down].blocks[0].attn.qkv.weight,
            rtol=0, atol=0)


def test_train_cli_warm_starts_vit_seg(tmp_path, monkeypatch, caplog):
    """``--model ViT_seg --pretrained_ckpt`` loads a whole Swin-UNet
    checkpoint: every tensor, none missing."""
    import logging

    _toy_models(monkeypatch)
    caplog.set_level(logging.INFO)
    source = t_swin_unet.SwinUnet(img_size=SIZE,
                                  generator=torch.Generator().manual_seed(4))
    torch.save({f"swin_unet.{k}": v for k, v in
                source.swin_unet.state_dict().items()}, tmp_path / "s.pth")
    assert train_cli.main([
        "--model", "ViT_seg", "--pretrained_ckpt", str(tmp_path / "s.pth"),
        "--synthetic", "--device", "cpu", "--patch_size", str(SIZE),
        str(SIZE), "--batch_size", "2", "--max_iterations", "1",
        "--eval_every", "100", "--synthetic_spec", "1", "2", "1", "0",
        "32"]) == 0
    n = len(source.state_dict())
    assert f"pretrained: loaded {n} tensors, 0 missing, 0 shape-skipped" in (
        caplog.text)
    with pytest.raises(NotImplementedError, match="warm start"):
        train_cli.main(["--model", "unet", "--pretrained_ckpt", "x.pth",
                        "--device", "cpu"])


def test_unet_export_round_trip_matches_eager(tmp_path):
    """The toy ``unet`` exported with a symbolic batch serves batches 2 and
    5 with eager's logits."""
    model = TUNet(num_classes=4, ft_chns=FT,
                  generator=torch.Generator().manual_seed(6))
    served = load_exported(save_exported(
        export_predict(model, (SIZE, SIZE)),
        str(tmp_path / "unet.pt2"))).module()
    eager = make_predict_fn(model)
    for bsz in (2, 5):
        x = torch.randn(bsz, SIZE, SIZE, 1,
                        generator=torch.Generator().manual_seed(bsz))
        got = served(x)
        assert got.dtype == torch.float32 and got.shape == (bsz, SIZE, SIZE,
                                                            4)
        torch.testing.assert_close(got, eager(x), rtol=0, atol=0)


def test_vit_seg_export_cli_round_trip_matches_eager(tmp_path, monkeypatch):
    """``cli.export --model ViT_seg`` (the toy, built for ``--patch_size``)
    on a snapshot: a symbolic-batch artifact whose window reshapes and
    index/mask buffers serve batches 2 and 3 with eager's logits."""
    _toy_models(monkeypatch)
    model = t_swin_unet.SwinUnet(img_size=SIZE,
                                 generator=torch.Generator().manual_seed(7))
    save_checkpoint(str(tmp_path / "snap"), 1, model.state_dict(), "best2")
    out = tmp_path / "vit.pt2"
    assert export_cli.main([
        "--model", "ViT_seg", "--checkpoint", str(tmp_path / "snap"),
        "--ckpt_name", "best2", "--patch_size", str(SIZE), str(SIZE),
        "--device", "cpu", "--out", str(out)]) == 0
    served = load_exported(str(out)).module()
    eager = make_predict_fn(model)
    for bsz in (2, 3):
        x = torch.randn(bsz, SIZE, SIZE, 1,
                        generator=torch.Generator().manual_seed(bsz))
        torch.testing.assert_close(served(x), eager(x), rtol=0, atol=0)
