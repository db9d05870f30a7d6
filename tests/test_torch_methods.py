"""The PyTorch port's semi-supervised methods against the JAX package.

Ramps, consistency losses, the two-stream sampler, the labeled-subset table
and the EMA update are fed the same numpy inputs as their JAX counterparts;
then two steps of each trainer (mean teacher and UAMT on a toy UNet, with
BatchNorm; cross-teaching on two toy Mamba-UNets) run from the same
weights and batches on both sides, with dropout and drop-path at 0 and the
teacher noise the same fixed numpy arrays on both sides (each side's
``_teacher_inputs`` overridden here). Tolerances: 1e-6 for the ramps and
losses (fp32 in another order), 1e-5 for the trainers' losses and every
parameter, EMA parameter and BatchNorm statistic after two steps; port-only
checks (resume, gradient accumulation) are exact or within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.cli import train as train_cli  # noqa: E402
from mamba_unet_torch.data import acdc as t_acdc  # noqa: E402
from mamba_unet_torch.data.sampler import TwoStreamBatchSampler  # noqa: E402
from mamba_unet_torch.models.unet import UNet as TUNet  # noqa: E402
from mamba_unet_torch.models.vssm import MambaUnet as TMambaUnet  # noqa: E402
from mamba_unet_torch.objectives import losses as t_loss  # noqa: E402
from mamba_unet_torch.objectives import ramps as t_ramps  # noqa: E402
from mamba_unet_torch.train import methods as t_methods  # noqa: E402
from mamba_unet_torch.train.state import ema_update  # noqa: E402
from mamba_unet_torch.train.trainer import TrainConfig  # noqa: E402
from mamba_unet_torch.utils.checkpoint import load_model_snapshot  # noqa: E402
from mamba_unet_torch.utils.convert import params_from_jax  # noqa: E402
from mamba_unet_tpu.data import acdc as j_acdc  # noqa: E402
from mamba_unet_tpu.data import sampler as j_sampler  # noqa: E402
from mamba_unet_tpu.models.unet import UNet as JUNet  # noqa: E402
from mamba_unet_tpu.models.vssm import MambaUnet as JMambaUnet  # noqa: E402
from mamba_unet_tpu.objectives import losses as j_loss  # noqa: E402
from mamba_unet_tpu.objectives import ramps as j_ramps  # noqa: E402
from mamba_unet_tpu.parallel import make_mesh  # noqa: E402
from mamba_unet_tpu.train import TrainConfig as JTrainConfig  # noqa: E402
from mamba_unet_tpu.train import methods as j_methods  # noqa: E402
from mamba_unet_tpu.train import state as j_state  # noqa: E402
from test_torch_train import _committed  # noqa: E402

# the JAX models' scan: JAX's plain sequential reference (lax.scan), the
# same function as its default chunked XLA route on the CPU, whose trace and
# compile take about twice as long
JAX_SCAN = "ref"
FT = (4, 8, 16, 32, 64)
NO_DROP = (0.0,) * 5
TOY_VIM = dict(depths=(1, 1), dims=(16, 32))
BATCH, LABELED, SIZE, T = 4, 2, 32, 8
# the teacher noise of the unlabeled half: one view (mean teacher), T views
# (UAMT)
NOISES = (0.1 * np.random.default_rng(21).normal(
    size=(T, BATCH - LABELED, SIZE, SIZE, 1))).clip(-0.2, 0.2).astype(
        np.float32)
# a consistency weight of 0.1 * exp(-5) at steps 0-1 would hide the term
SEMI = dict(labeled_bs=LABELED, consistency=30.0)
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


# --- ramps, losses, sampler, table, EMA --------------------------------------

@pytest.mark.parametrize("fn,args", [
    ("sigmoid_rampup", [(c, 200.0) for c in (-3, 0, 1.5, 77, 200, 999)]
     + [(5, 0)]),
    ("linear_rampup", [(c, 40.0) for c in (-2, 0, 13.3, 40, 41)]),
    ("cosine_rampdown", [(c, 50.0) for c in (0, 12.5, 49.9, 50)])])
def test_ramps_match_jax(fn, args):
    for a in args:
        assert getattr(t_ramps, fn)(*a) == pytest.approx(
            getattr(j_ramps, fn)(*a), rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("name", [
    "softmax_mse_loss", "softmax_kl_loss", "symmetric_mse_loss",
    "entropy_loss", "entropy_loss_map", "constra_loss", "softmax_dice_loss",
    "dice_loss_pair"])
def test_consistency_losses_match_jax(rng, name):
    a = (2 * rng.normal(size=(3, 6, 5, 4))).astype(np.float32)
    b = (2 * rng.normal(size=(3, 6, 5, 4))).astype(np.float32)
    if name.startswith("entropy"):
        a = np.asarray(jax.nn.softmax(a, -1))
        args = (a,)
    elif name == "dice_loss_pair":
        args = (rng.random(a.shape).astype(np.float32),
                (rng.random(a.shape) > 0.5).astype(np.float32))
    else:
        args = (a, b)
    want = np.asarray(getattr(j_loss, name)(*map(jnp.asarray, args)))
    got = getattr(t_loss, name)(*(torch.from_numpy(np.array(a)) for a in args))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_two_stream_sampler_yields_jaxs_batches():
    args = (range(7), range(7, 30), 5, 3)
    got = TwoStreamBatchSampler(*args, seed=4)
    want = j_sampler.TwoStreamBatchSampler(*args, seed=4)
    assert len(got) == len(want) == 3
    for _ in range(3):  # epochs: the unlabeled stream runs on across them
        assert list(got) == list(want)


def test_patients_to_slices_is_jaxs_table():
    assert t_acdc._ACDC_PATIENTS_TO_SLICES == j_acdc._ACDC_PATIENTS_TO_SLICES
    for n in j_acdc._ACDC_PATIENTS_TO_SLICES:
        assert t_acdc.patients_to_slices("ACDC", n) == (
            j_acdc.patients_to_slices("ACDC", n))
    with pytest.raises(KeyError):
        t_acdc.patients_to_slices("BTCV", 3)


def test_ema_update_matches_jax_over_two_steps(rng):
    shapes = {"w": (4, 3), "b": (3,)}
    ema = {k: rng.normal(size=s).astype(np.float32)
           for k, s in shapes.items()}
    steps = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    want = {k: jnp.asarray(v) for k, v in ema.items()}
    got = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    alphas = []
    for step, params in enumerate(steps, start=1):
        want = j_state.ema_update(want, {k: jnp.asarray(v)
                                         for k, v in params.items()},
                                  jnp.asarray(step))
        alphas.append(ema_update(got, {k: torch.from_numpy(v)
                                       for k, v in params.items()}, step))
    assert alphas == [0.5, pytest.approx(2 / 3)]
    for k in shapes:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


# --- the trainers against the JAX trainers ------------------------------------

def _batches(n, seed=11):
    r = np.random.default_rng(seed)
    return [{"image": r.random((BATCH, SIZE, SIZE, 1), np.float32),
             "label": r.integers(0, 4, (BATCH, SIZE, SIZE))}
            for _ in range(n)]


def _cfg(cls, **kw):
    return cls(base_lr=0.05, max_iterations=10, batch_size=BATCH,
               patch_size=(SIZE, SIZE), num_classes=4, eval_every=10**6,
               log_every=1, seed=0, **kw)


class JMeanTeacher(j_methods.MeanTeacherTrainer):
    def _teacher_inputs(self, rng, unlabeled):
        return unlabeled + NOISES[0]


class JUAMT(j_methods.UAMTTrainer):
    """The step traces its teacher views in the order: the consistency
    target (the first MC pass's noise), then the T MC passes."""

    calls = 0

    def _teacher_inputs(self, rng, unlabeled):
        i = max(self.calls % (T + 1) - 1, 0)
        self.calls += 1
        return unlabeled + NOISES[i]


class TMeanTeacher(t_methods.MeanTeacherTrainer):
    offset = 0  # the unlabeled samples' index into NOISES' batch axis

    def _teacher_inputs(self, unlabeled):
        n = unlabeled.shape[0]
        return unlabeled + torch.from_numpy(
            NOISES[0, self.offset:self.offset + n])


class TUAMT(t_methods.UAMTTrainer):
    calls = 0

    def _teacher_inputs(self, unlabeled):
        i = self.calls % T
        self.calls += 1
        return unlabeled + torch.from_numpy(NOISES[i])


def _jax_run(trainer, n_steps=2):
    result = _committed(trainer).fit(_batches(n_steps))
    return [h["loss"] for h in result["history"]]


@pytest.fixture(scope="module")
def jax_mean_teacher():
    model = JUNet(num_classes=4, ft_chns=FT, dropout=NO_DROP)
    trainer = JMeanTeacher(model, _cfg(JTrainConfig), warmup_iters=0,
                           mesh=make_mesh(jax.devices()[:1]), **SEMI)
    start = (_flat(trainer.state.params), _flat(trainer.state.batch_stats))
    losses = _jax_run(trainer)
    s = trainer.state
    return start, losses, (_flat(s.params), _flat(s.batch_stats),
                           _flat(s.ema_params))


@pytest.fixture(scope="module")
def jax_uamt():
    model = JUNet(num_classes=4, ft_chns=FT, dropout=NO_DROP)
    trainer = JUAMT(model, _cfg(JTrainConfig),
                    mesh=make_mesh(jax.devices()[:1]), **SEMI)
    start = (_flat(trainer.state.params), _flat(trainer.state.batch_stats))
    losses = _jax_run(trainer)
    s = trainer.state
    return start, losses, (_flat(s.params), _flat(s.batch_stats),
                           _flat(s.ema_params))


def _unet(start, steps=0):
    model = TUNet(num_classes=4, ft_chns=FT, dropout=NO_DROP)
    model.load_state_dict(params_from_jax(
        start[0], like=model.state_dict(), batch_stats=start[1],
        num_batches_tracked=steps))
    return model


def _as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_state(model, params, stats, steps):
    want = params_from_jax(params, like=model.state_dict(),
                           batch_stats=stats, num_batches_tracked=steps)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("method", ["mean_teacher", "uamt"])
def test_two_ema_teacher_steps_match_the_jax_trainer(method, request):
    start, want_losses, (params, stats, ema) = request.getfixturevalue(
        f"jax_{method}")
    cls = TMeanTeacher if method == "mean_teacher" else TUAMT
    kw = {"warmup_iters": 0} if method == "mean_teacher" else {}
    trainer = cls(_unet(start), _cfg(TrainConfig), device="cpu", **SEMI,
                  **kw)
    result = trainer.fit([_as_torch(b) for b in _batches(2)])
    assert result["iterations"] == trainer.step == 2
    np.testing.assert_allclose([h["loss"] for h in result["history"]],
                               want_losses, **TOL)
    # BatchNorm: the student's two updates; the teacher's are thrown away
    _assert_state(trainer.model, params, stats, 2)
    want_ema = params_from_jax(ema)
    assert set(trainer.ema) == set(want_ema)
    for k, v in trainer.ema.items():
        np.testing.assert_allclose(v.numpy(), want_ema[k].numpy(), **TOL,
                                   err_msg=k)
    moved = sum(not torch.equal(v, params_from_jax(start[0])[k])
                for k, v in trainer.ema.items())
    assert moved == len(trainer.ema)


@pytest.fixture(scope="module")
def jax_cross_teaching():
    model = JMambaUnet(img_size=SIZE, num_classes=4, drop_path_rate=0.0,
                       scan_impl=JAX_SCAN, **TOY_VIM)
    trainer = j_methods.CrossTeachingTrainer(
        model, _cfg(JTrainConfig), mesh=make_mesh(jax.devices()[:1]), **SEMI)
    start = [_flat(s.params) for s in (trainer.cross.s1, trainer.cross.s2)]
    losses = _jax_run(trainer)
    return start, losses, [_flat(s.params) for s in (trainer.cross.s1,
                                                     trainer.cross.s2)]


def _vim(params):
    model = TMambaUnet(num_classes=4, drop_path_rate=0.0, **TOY_VIM)
    model.load_state_dict(params_from_jax(params, like=model.state_dict()))
    return model


def test_two_cross_teaching_steps_match_the_jax_trainer(jax_cross_teaching):
    start, want_losses, want = jax_cross_teaching
    trainer = t_methods.CrossTeachingTrainer(
        _vim(start[0]), _cfg(TrainConfig), model2=_vim(start[1]),
        device="cpu", **SEMI)
    result = trainer.fit([_as_torch(b) for b in _batches(2)])
    assert result["iterations"] == 2
    np.testing.assert_allclose([h["loss"] for h in result["history"]],
                               want_losses, **TOL)
    for model, params, init in zip((trainer.model, trainer.model2), want,
                                    start):
        _assert_state(model, params, None, 0)
        moved = sum(not torch.equal(v, params_from_jax(init)[k])
                    for k, v in model.state_dict().items())
        assert moved > 0.9 * len(params)


# --- port-only: resume, gradient accumulation, the CLI ------------------------

def _cross(start, snap=None, **kw):
    cfg = _cfg(TrainConfig, snapshot_dir=snap, ckpt_every=2, **kw)
    model, model2 = (TUNet(num_classes=4, ft_chns=FT) for _ in range(2))
    model.load_state_dict(start[0])
    model2.load_state_dict(start[1])
    return t_methods.CrossTeachingTrainer(model, cfg, model2=model2,
                                          device="cpu", **SEMI)


def test_cross_teaching_resume_continues_as_one_run(tmp_path):
    """2 steps + periodic checkpoint + resume + 2 steps == 4 steps, both
    models (with dropout: the generator's streams resume too)."""
    start = [TUNet(num_classes=4, ft_chns=FT,
                   generator=torch.Generator().manual_seed(s)).state_dict()
             for s in (0, 1)]
    batches = [_as_torch(b) for b in _batches(4)]
    whole = _cross(start)
    whole.fit(batches)
    snap = str(tmp_path / "snap")
    assert _cross(start, snap).fit(batches[:2])["iterations"] == 2
    second = _cross(start, snap, resume=True)
    assert second.fit(batches[2:])["iterations"] == 4
    for a, b in ((whole.model, second.model), (whole.model2, second.model2)):
        for k, v in a.state_dict().items():
            torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0,
                                       msg=k)


def _plain_sgd(params):
    opt = torch.optim.SGD(params, lr=0.1)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)


def test_mean_teacher_grad_accum_is_stratified():
    """k = 2: the update is the mean of k = 1 updates on the stratified
    microbatches (one labeled and one unlabeled sample each, the teacher
    noise sliced from the whole batch's), with per-microbatch Dice."""
    start = TUNet(num_classes=4, ft_chns=FT, dropout=NO_DROP,
                  generator=torch.Generator().manual_seed(3)).state_dict()
    batch = _as_torch(_batches(1)[0])

    def trainer(k, offset=0):
        """k = 2 on the batch, or k = 1 on one microbatch of it."""
        model = TUNet(num_classes=4, ft_chns=FT, dropout=NO_DROP)
        model.load_state_dict(start)
        cfg = _cfg(TrainConfig, grad_accum_steps=k)
        cfg.batch_size = BATCH if k == 2 else BATCH // 2
        t = TMeanTeacher(model, cfg, make_optimizer=_plain_sgd, device="cpu",
                         warmup_iters=0, consistency=30.0,
                         labeled_bs=LABELED if k == 2 else LABELED // 2)
        t.offset = offset
        return t

    acc = trainer(2)
    acc.train_step(batch)
    deltas = []
    for i in range(2):
        one = trainer(1, offset=i)
        one.train_step({k: torch.cat([v[i:i + 1], v[LABELED + i:
                                                    LABELED + i + 1]])
                        for k, v in batch.items()})
        deltas.append({k: v - start[k] for k, v in
                       one.model.named_parameters()})
    for k, v in acc.model.named_parameters():
        want = start[k] + (deltas[0][k] + deltas[1][k]) / 2
        torch.testing.assert_close(v.detach(), want.detach(), rtol=1e-5,
                                   atol=1e-6, msg=k)
    with pytest.raises(ValueError, match="stratified"):
        TMeanTeacher(TUNet(num_classes=4, ft_chns=FT),
                     _cfg(TrainConfig, grad_accum_steps=2), device="cpu",
                     labeled_bs=3)
    with pytest.raises(ValueError, match="grad_accum"):
        t_methods.UAMTTrainer(TUNet(num_classes=4, ft_chns=FT),
                              _cfg(TrainConfig, grad_accum_steps=2),
                              device="cpu", **SEMI)


@pytest.mark.parametrize("method,models", [
    ("mean_teacher", ["--model", "unet"]), ("uamt", ["--model", "unet"]),
    ("cross_teaching", ["--model", "ViM_seg", "--model2", "unet"])])
def test_semi_methods_through_the_train_cli(tmp_path, method, models):
    snap = tmp_path / "snap"
    assert train_cli.main([
        "--method", method, *models, "--synthetic", "--device", "cpu",
        "--patch_size", "32", "32", "--batch_size", "4", "--labeled_bs", "2",
        "--max_iterations", "2", "--eval_every", "2", "--ckpt_every", "2",
        "--synthetic_spec", "2", "4", "1", "0", "40", "--drop_path", "0.1",
        "--snapshot_dir", str(snap)]) == 0
    names = sorted(p.name for p in snap.iterdir())
    assert "state_2" in names and "best_2" in names
    model = load_model_snapshot(models[1], 4, 1, str(snap), device="cpu")
    assert not model.training
    if method == "cross_teaching":
        assert "best2_2" in names
        load_model_snapshot("unet", 4, 1, str(snap), device="cpu",
                            ckpt_name="best2")
