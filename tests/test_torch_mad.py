"""The PyTorch port's MAD (``--method mad_pretrain`` / ``mad_finetune``,
the stacked test CLI) against the JAX package.

* The label corruption (``data/mad_augment.py``): the numpy Canny equals
  OpenCV's ``cv2.Canny`` pixel for pixel; the masks, the near-one-hot
  softmax and the transforms (``RandomGeneratorV2``, the pretraining and
  fine-tuning transforms, ``mask_label_only``, the fusion modes 1-7) are
  bitwise equal to JAX's for the same ``np.random.default_rng`` seed,
  over several epochs of draws.
* The validations (``test_single_volume_mad``,
  ``test_single_volume_stacked``) equal JAX's exactly with the same numpy
  predict functions.
* Two ``MADFineTuneTrainer`` steps of a toy UNet segmenter and two toy
  UNet denoisers against the JAX trainer from the same weights and
  batches (dropout 0), starting from seeded weights drawn as flax's
  initializers draw them: the summed losses within 1e-5, and every
  parameter and BatchNorm statistic of the three models within 1e-4 plus
  5x the spread the fp32 step shows, per tensor (the larger of JAX's
  under 1e-7 relative noise on its starting weights, two draws, and the
  port's between one and four threads). The segmenter, whose gradient the
  den loss reaches through the den UNet, parts from JAX by up to 2.9e-5
  (its encoder, measured on a CPU) where both sides' own spreads are
  ~3e-7: flax's BatchNorm variance is E[x²] - E[x]² and the port's
  BatchNorm2d two-pass (ROADMAP §3), at a toy bottleneck that normalizes
  16 values per channel; and from other weights the port's own first
  conv parts by 1.7e-3 between those thread counts. So the wiring is held
  where it is well-conditioned too: with every loss but one zeroed, the
  mad loss gives the segmenter no gradient and the den loss does.
* Port-only: a resumed trio run equals the uninterrupted one exactly; a
  new best saves the trio as ``best``/``best2``/``best3``; the train CLI
  runs ``mad_pretrain`` and ``mad_finetune`` with its warm starts, and
  the test CLI's denoised table equals ``test_single_volume_stacked``
  with the denoiser it loaded, ``--ckpt_name`` not leaking into the
  denoiser's load.
"""

import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.cli import test as test_cli  # noqa: E402
from mamba_unet_torch.cli import train as train_cli  # noqa: E402
from mamba_unet_torch.data import mad_augment as t_mad  # noqa: E402
from mamba_unet_torch.data import synthetic as t_syn  # noqa: E402
from mamba_unet_torch.eval import inference as t_inf  # noqa: E402
from mamba_unet_torch.models import unet as t_unet_mod  # noqa: E402
from mamba_unet_torch.models.unet import UNet as TUNet  # noqa: E402
from mamba_unet_torch.train import MADFineTuneTrainer, TrainConfig  # noqa: E402
from mamba_unet_torch.utils.checkpoint import (  # noqa: E402
    latest_step,
    load_model_snapshot,
)
from mamba_unet_torch.utils.convert import params_from_jax  # noqa: E402
from mamba_unet_torch.utils.export import make_predict_fn  # noqa: E402
from mamba_unet_tpu.data import mad_augment as j_mad  # noqa: E402
from mamba_unet_tpu.eval import inference as j_inf  # noqa: E402
from mamba_unet_tpu.models.unet import UNet as JUNet  # noqa: E402
from mamba_unet_tpu.parallel import make_mesh  # noqa: E402
from mamba_unet_tpu.train import TrainConfig as JTrainConfig  # noqa: E402
from mamba_unet_tpu.train import mad as j_train_mad  # noqa: E402
from mamba_unet_tpu.train import state as j_state  # noqa: E402
from mamba_unet_tpu.train import trainer as j_trainer  # noqa: E402
from test_torch_train import _committed  # noqa: E402

FT = (4, 8, 16, 32, 64)
NO_DROP = (0.0,) * 5
BATCH, SIZE, SEED, C = 4, 32, 0, 4
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
    """XLA's cheaper compile while this file runs: the JAX trainer is
    compiled once and run twice."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _samples(n=3, size=48, seed=2):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        image, label = t_syn._phantom(r, size, size + 8)
        out.append({"image": image, "label": label})
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --- the label corruption --------------------------------------------------------

def test_canny_equals_opencv():
    """Label-like maps (a few classes, blobs, zoomed) and noise."""
    r = np.random.default_rng(0)
    arrays = [r.integers(0, 4, (40, 36)), r.integers(0, 256, (31, 29)),
              np.kron(r.integers(0, 4, (12, 10)), np.ones((5, 5), int))]
    arrays += [s["label"] for s in _samples()]
    for a in arrays:
        a = a.astype(np.uint8)
        np.testing.assert_array_equal(t_mad.canny(a, 1, 2),
                                      cv2.Canny(a, 1, 2))


def test_masks_and_one_hot_match_jax():
    label = _samples(1)[0]["label"].astype(np.float32)
    for seed in range(6):
        got = t_mad.random_mask_corrupt(np.random.default_rng(seed), label)
        want = j_mad.random_mask_corrupt(np.random.default_rng(seed), label)
        np.testing.assert_array_equal(got, want)
        for val in (-1, 0):
            np.testing.assert_array_equal(
                t_mad.random_mask_edge(np.random.default_rng(seed), label,
                                       0.3, (2, 2), val),
                j_mad.random_mask_edge(np.random.default_rng(seed), label,
                                       0.3, (2, 2), val))
    np.testing.assert_array_equal(
        t_mad.np_softmax(t_mad.image2binary(label, 1e-3, C)),
        j_mad.np_softmax(j_mad.image2binary(label, 1e-3, C)))


@pytest.mark.parametrize("name", ["v2", "pretrain", "pretrain_plain",
                                  "finetune"] +
                         [f"fusion{m}" for m in range(1, 8)])
def test_transforms_match_jax(name):
    """Three epochs over three phantom slices, one generator each side."""
    make = {
        "v2": lambda m: m.RandomGeneratorV2((32, 32), seed=3),
        "pretrain": lambda m: m.MADPretrainTransform((32, 32), C, seed=3),
        "pretrain_plain": lambda m: m.MADPretrainTransform(
            (32, 32), C, geometric=False, seed=3),
        "finetune": lambda m: m.MADFineTuneTransform((32, 32), C, seed=3),
    }
    if name.startswith("fusion"):
        mode = int(name[len("fusion"):])
        got, want = (m.FusionTransform((32, 32), C, mode, seed=3)
                     for m in (t_mad, j_mad))
    else:
        got, want = make[name](t_mad), make[name](j_mad)
    for _ in range(3):
        for s in _samples():
            _assert_same(got(dict(s)), want(dict(s)))
    if name == "pretrain":
        label = _samples(1)[0]["label"][:32, :32]
        np.testing.assert_array_equal(got.mask_label_only(label),
                                      want.mask_label_only(label))


# --- the validations --------------------------------------------------------------

def _linear_fn(cin, seed):
    """A numpy (B, H, W, cin) -> (B, H, W, C) logits function."""
    r = np.random.default_rng(seed)
    w = r.normal(size=(cin, C)).astype(np.float32)
    b = r.normal(size=C).astype(np.float32)
    return lambda x: (np.asarray(x) @ w + b).astype(np.float32)


def test_validations_match_jax():
    vols = t_syn.phantom_acdc(1, 2, 2, 0, 40, seed=1)["val"]
    seg, den = _linear_fn(1, 0), _linear_fn(C, 1)
    for v in vols:
        got = t_inf.test_single_volume_mad(
            v["label"], den, C, t_mad.MADPretrainTransform(
                (32, 32), C, seed=4).mask_label_only, (32, 32), 3)
        want = j_inf.test_single_volume_mad(
            v["label"], den, C, j_mad.MADPretrainTransform(
                (32, 32), C, seed=4).mask_label_only, (32, 32), 3)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        got = t_inf.test_single_volume_stacked(v["image"], v["label"], seg,
                                               den, C, (32, 32), 3)
        want = j_inf.test_single_volume_stacked(v["image"], v["label"], seg,
                                                den, C, (32, 32), 3)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# --- the fine-tuning step against the JAX trainer ------------------------------

def _batches(n, seed=11):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        logits = r.normal(size=(BATCH, SIZE, SIZE, C)) * 3
        e = np.exp(logits - logits.max(-1, keepdims=True))
        out.append({
            "image": r.random((BATCH, SIZE, SIZE, 1), np.float32),
            "label": r.integers(0, C, (BATCH, SIZE, SIZE)),
            "mask_label": (e / e.sum(-1, keepdims=True)).astype(np.float32)})
    return out


def _as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _cfg(cls, **kw):
    return cls(**{**dict(base_lr=0.05, max_iterations=10, batch_size=BATCH,
                         patch_size=(SIZE, SIZE), num_classes=C,
                         eval_every=10**6, log_every=1, seed=SEED), **kw})


def _seeded_state(model, rng, x, tx, with_ema=False):
    """``create_train_state`` with seeded numpy variables in the model's
    shapes (``jax.eval_shape``: no init is compiled), drawn as flax's
    initializers draw them: kernels normal at std 1/sqrt(fan-in) cut at
    2 std, unit scales and running variances, zero biases and means."""
    r = np.random.default_rng(int(jax.random.randint(rng, (), 0, 2**30)))

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = np.clip(r.normal(size=shape), -2, 2) / 0.8796 / np.sqrt(
                np.prod(shape[:-1]))
        else:
            v = np.full(shape, float(name in ("scale", "var")))
        return jnp.asarray(v, jnp.float32)

    variables = jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(model.init, rng, x))
    return j_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(variables["params"]), tx=tx, ema_params=None)


@pytest.fixture(scope="module")
def jax_mad():
    """(initial (params, batch_stats) of seg, mad, den; the losses of two
    fit steps; the final ones; the spread). The three states start from
    :func:`_seeded_state` (three JAX init compiles cost ~10 s)."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (j_trainer, j_train_mad):
            mp.setattr(module, "create_train_state", _seeded_state)
        trainer = j_train_mad.MADFineTuneTrainer(
            JUNet(num_classes=C, ft_chns=FT, dropout=NO_DROP),
            JUNet(num_classes=C, in_chns=C, ft_chns=FT, dropout=NO_DROP),
            _cfg(JTrainConfig), mesh=make_mesh(jax.devices()[:1]))

    def states():
        ms = trainer.mad_state
        return [(_flat(s.params), _flat(s.batch_stats))
                for s in (ms.seg, ms.mad, ms.den)]

    start = states()
    _committed(trainer)  # one compile serves both steps
    first = jax.tree.map(jnp.copy, trainer.mad_state)
    result = trainer.fit(_batches(2))
    want = states()
    noise = np.random.default_rng(0)
    spread = {}
    for _ in range(2):
        noisy = jax.tree.map(jnp.copy, first)
        noisy = noisy.replace(**{
            name: getattr(noisy, name).replace(params=jax.tree.map(
                lambda a: jax.device_put(a * (1 + 1e-7 * noise.standard_normal(
                    a.shape)).astype(np.float32), a.sharding),
                getattr(noisy, name).params))
            for name in ("seg", "mad", "den")})
        for batch in _batches(2):
            noisy, _ = trainer._mad_step(noisy, {
                k: jax.device_put(v, trainer._bsh) for k, v in batch.items()})
        for i, name in enumerate(("seg", "mad", "den")):
            st = getattr(noisy, name)
            for tree, ref in ((st.params, want[i][0]),
                              (st.batch_stats, want[i][1])):
                for k, v in _flat(tree).items():
                    key = (i, k)
                    spread[key] = max(spread.get(key, 0.0),
                                      float(np.abs(v - ref[k]).max()))
    return start, [h["loss"] for h in result["history"]], want, spread


def _unet(cin=1, **kw):
    return TUNet(num_classes=C, in_chans=cin, ft_chns=FT, **kw)


def _port_trio(start, snap=None, **kw):
    models = []
    for (params, stats), cin in zip(start, (1, C, C)):
        model = _unet(cin, dropout=NO_DROP)
        model.load_state_dict(params_from_jax(
            params, like=model.state_dict(), batch_stats=stats))
        models.append(model)
    return MADFineTuneTrainer(models[0], _cfg(TrainConfig, **kw),
                              mad_model=models[1], den_model=models[2],
                              device="cpu")


def _port_fit(start, threads):
    """The port trio's states after two steps on ``threads`` threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        trainer = _port_trio(start)
        result = trainer.fit([_as_torch(b) for b in _batches(2)])
    finally:
        torch.set_num_threads(before)
    return trainer, result


def test_two_finetune_steps_match_the_jax_trainer(jax_mad):
    """seg + mad + den, two steps: the losses, and every parameter and
    BatchNorm statistic of the three models."""
    start, want_losses, want, spread = jax_mad
    trainer, result = _port_fit(start, 1)
    other, _ = _port_fit(start, 4)
    assert result["iterations"] == trainer.step == 2
    np.testing.assert_allclose([h["loss"] for h in result["history"]],
                               want_losses, **TOL)
    for i, ((model, _, _), (params, stats), (init, _)) in enumerate(zip(
            trainer._members(), want, start)):
        sd, sd4 = model.state_dict(), other._members()[i][0].state_dict()
        for path, value in {**params, **stats}.items():
            one = params_from_jax({path: value}) if path in params else (
                params_from_jax({}, batch_stats={path: value}))
            (k, ref), = ((k, v) for k, v in one.items()
                         if not k.endswith("num_batches_tracked"))
            err = float((sd[k] - ref).abs().max())
            own = max(spread[(i, path)], float((sd[k] - sd4[k]).abs().max()))
            assert err <= 5 * own + 1e-4, (i, k, err, own)
        moved = sum(not torch.equal(v, params_from_jax(init)[k])
                    for k, v in model.named_parameters())
        assert moved > 0.9 * len(init)


def test_the_den_loss_reaches_the_segmenter_and_the_mad_loss_does_not(
        monkeypatch):
    """The step's wiring, well-conditioned where the parameters after two
    steps are not: with every loss but one zeroed, the mad loss gives the
    segmenter no gradient (its input is detached), the den loss does, and
    the seg loss reaches neither denoiser."""
    import mamba_unet_torch.train.mad as t_train_mad

    real, real_zero = (t_train_mad.supervised_ce_dice,
                       t_train_mad.zero_unreached_grads)
    batch = _as_torch(_batches(1)[0])
    reached = {}
    for keep, name in enumerate(("seg", "mad", "den")):
        calls = []

        def one_loss(logits, label, group=None, keep=keep, calls=calls):
            calls.append(1)
            return real(logits, label, group) * float(len(calls) - 1 == keep)

        grads = {}

        def read_grads(*models, grads=grads):
            """The gradients as the backward left them (the step's call
            right after it)."""
            for member, model in zip(("seg", "mad", "den"), models):
                grads[member] = max(float(p.grad.abs().max())
                                    for p in model.parameters()
                                    if p.grad is not None)
            real_zero(*models)

        monkeypatch.setattr(t_train_mad, "supervised_ce_dice", one_loss)
        monkeypatch.setattr(t_train_mad, "zero_unreached_grads", read_grads)
        _seeded_trio().train_step(batch)
        reached[name] = {m for m, g in grads.items() if g > 0}
    assert reached == {"seg": {"seg"}, "mad": {"mad"},
                       "den": {"seg", "den"}}, reached


# --- port-only: resume, the trio's best, the CLIs --------------------------------

def _seeded_trio(snap=None, **kw):
    """Three toy UNets with dropout from seeds 0-2, as a trainer."""
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    seg, mad, den = (_unet(cin, generator=g)
                     for cin, g in zip((1, C, C), gens))
    return MADFineTuneTrainer(
        seg, _cfg(TrainConfig, snapshot_dir=snap, ckpt_every=2, **kw),
        mad_model=mad, den_model=den, device="cpu")


def test_trio_resume_continues_as_one_run(tmp_path):
    """2 steps + periodic checkpoint + resume + 2 steps == 4 steps, all
    three models, optimizers' schedules and dropout draws."""
    batches = [_as_torch(b) for b in _batches(4)]
    whole = _seeded_trio()
    whole.fit(batches)
    snap = str(tmp_path / "snap")
    assert _seeded_trio(snap).fit(batches[:2])["iterations"] == 2
    second = _seeded_trio(snap, resume=True)
    assert second.fit(batches[2:])["iterations"] == 4
    for a, b in zip(whole._members(), second._members()):
        for k, v in a[0].state_dict().items():
            torch.testing.assert_close(b[0].state_dict()[k], v, rtol=0,
                                       atol=0, msg=k)
        assert a[2].state_dict() == b[2].state_dict()


def test_a_new_best_saves_the_trio(tmp_path, monkeypatch):
    """One stacked evaluation, one mark; seg, mad, den saved at the same
    step as best, best2, best3."""
    snap = str(tmp_path / "snap")
    trainer = _seeded_trio(snap, eval_every=1)
    calls = []
    monkeypatch.setattr(trainer, "evaluate",
                        lambda val, model=None: calls.append(model) or 0.5)
    result = trainer.fit([_as_torch(b) for b in _batches(1)], val_dataset=[])
    assert calls == [trainer.model] and result["best_dice"] == 0.5
    for name, cin, (model, _, _) in zip(("best", "best2", "best3"),
                                        (1, C, C), trainer._members()):
        assert latest_step(snap, name) == 1
        loaded = load_model_snapshot("unet", C, cin, snap, device="cpu",
                                     ckpt_name=name, ft_chns=FT)
        for k, v in model.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), (name, k)


def _train(snap, *extra):
    return train_cli.main([
        "--synthetic", "--device", "cpu", "--model", "unet",
        "--patch_size", str(SIZE), str(SIZE), "--batch_size", "4",
        "--max_iterations", "2", "--eval_every", "2", "--ckpt_every", "2",
        "--synthetic_spec", "2", "4", "1", "1", "40",
        "--snapshot_dir", str(snap), *extra])


def test_mad_clis_pretrain_finetune_and_stacked_test(tmp_path, monkeypatch):
    """``mad_pretrain`` (a 4-channel denoiser, corrupted-label
    validation), a fully-supervised segmenter, ``mad_finetune`` warm-
    started from both, and the test CLI stacking a denoiser: its denoised
    table equals ``test_single_volume_stacked`` with the models it loaded,
    from the pretraining's snapshot and, with ``--denoiser_ckpt_name
    best3``, the fine-tuned den, ``--ckpt_name`` selecting in the main
    snapshot only."""
    # the CLIs' unet at the toy's widths
    monkeypatch.setattr(t_unet_mod, "UNet",
                        functools.partial(TUNet, ft_chns=FT))
    pre, seg, ft = tmp_path / "pre", tmp_path / "seg", tmp_path / "ft"
    assert _train(pre, "--method", "mad_pretrain") == 0
    assert _train(seg) == 0
    warm = []
    real_warm = train_cli._warm_start
    monkeypatch.setattr(train_cli, "_warm_start",
                        lambda m, d: warm.append(d) or real_warm(m, d))
    # a fixed stacked Dice, so that step 2 writes the trio's best
    monkeypatch.setattr(MADFineTuneTrainer, "evaluate",
                        lambda self, val, model=None: 0.25)
    assert _train(ft, "--method", "mad_finetune", "--mad_model", "unet",
                  "--seg_ckpt", str(seg), "--mad_ckpt", str(pre)) == 0
    assert warm == [str(seg), str(pre), str(pre)]
    assert {"best_2", "best2_2", "best3_2", "state_2"} <= {
        p.name for p in ft.iterdir()}
    tree = torch.load(ft / "state_2", weights_only=True)
    assert {"model", "model2", "model3", "optimizer3"} <= set(tree)

    cases = t_syn.phantom_acdc(2, 4, 1, 1, 40)["test"]
    for den_dir, den_name, seg_name in ((pre, None, None),
                                        (ft, "best3", "best")):
        args = test_cli.build_parser().parse_args(
            ["--model", "unet", "--patch_size", str(SIZE), str(SIZE),
             "--device", "cpu", "--checkpoint", str(ft if seg_name else seg),
             "--denoiser_model", "unet", "--denoiser_checkpoint",
             str(den_dir)]
            + (["--ckpt_name", seg_name] if seg_name else [])
            + (["--denoiser_ckpt_name", den_name] if den_name else []))
        out = test_cli.run_inference(args, dataset=cases)
        seg_model = load_model_snapshot("unet", C, 1, args.checkpoint,
                                        device="cpu", ckpt_name=seg_name)
        den_model = load_model_snapshot("unet", C, C, str(den_dir),
                                        device="cpu", ckpt_name=den_name)
        want = t_inf.test_single_volume_stacked(
            cases[0]["image"], cases[0]["label"], make_predict_fn(seg_model),
            make_predict_fn(den_model), C, (SIZE, SIZE), test_cli.BATCH_SIZE)
        assert out["per_case_denoised"].shape == (1, C - 1, 3)
        np.testing.assert_allclose(out["per_case_denoised"][0, :, 0],
                                   np.asarray(want)[:, 0], rtol=1e-6)
        np.testing.assert_allclose(out["per_case_denoised"][0, :, 1],
                                   np.asarray(want)[:, 1], rtol=1e-6)
