"""The PyTorch port's contrastive consistency (``--method
contrastive_consistency``) against the JAX package.

* The CTAugment copy bitwise: the policies a seed draws, ``cta_apply`` of
  every op at several levels (``cutout`` with the same generator), the
  ``CTATransform`` sample's 7 keys, ``update_rates`` and the
  ``cta_state.json`` round trip (the same file as JAX writes).
* The contrastive losses: ``con_loss`` (value 1e-6, gradient 1e-5 against
  ``jax.grad``), ``info_nce_loss``, ``MocoLoss`` over three calls with
  queue eviction, ``con_loss_queue``.
* The small nets (``Projectors``, ``Classifier``, ``JigsawClassifier``,
  ``PNet2D``) from JAX's weights and ``batch_stats``: eval- and train-mode
  outputs and the running statistics, 1e-5 (the jigsaw head's train-mode
  outputs 1e-4).
* Two ``ContrastiveConsistencyTrainer`` steps of a toy ``ViM_seg`` pair
  and of a toy ``unet`` pair (BatchNorm) against the JAX trainer, dropout
  and drop-path 0, consistency weights that make every term count: the
  five losses, every parameter of both models and both trained
  projectors, the EMA projectors and the models' running statistics
  (only the weak passes' kept), 1e-5.
* Port-only: a resumed run equals the uninterrupted one, CTAugment rates
  included; the train CLI writes ``best``/``best2``, the periodic
  checkpoint and ``cta_state.json``, and refuses ``--mask_recovery``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.cli import train as train_cli  # noqa: E402
from mamba_unet_torch.data import ctaugment as t_cta  # noqa: E402
from mamba_unet_torch.data.cta_transform import CTATransform  # noqa: E402
from mamba_unet_torch.models import small_nets as t_small  # noqa: E402
from mamba_unet_torch.models.unet import UNet as TUNet  # noqa: E402
from mamba_unet_torch.models.vssm import MambaUnet as TMambaUnet  # noqa: E402
from mamba_unet_torch.objectives import contrastive as t_con  # noqa: E402
from mamba_unet_torch.train import (  # noqa: E402
    ContrastiveConsistencyTrainer,
    TrainConfig,
)
from mamba_unet_torch.utils import checkpoint as t_ckpt  # noqa: E402
from mamba_unet_torch.utils.convert import params_from_jax  # noqa: E402
from mamba_unet_tpu.data import cta_transform as j_cta_transform  # noqa: E402
from mamba_unet_tpu.data import ctaugment as j_cta  # noqa: E402
from mamba_unet_tpu.models import small_nets as j_small  # noqa: E402
from mamba_unet_tpu.models.unet import UNet as JUNet  # noqa: E402
from mamba_unet_tpu.models.vssm import MambaUnet as JMambaUnet  # noqa: E402
from mamba_unet_tpu.objectives import contrastive as j_con  # noqa: E402
from mamba_unet_tpu.parallel import make_mesh  # noqa: E402
from mamba_unet_tpu.train import TrainConfig as JTrainConfig  # noqa: E402
from mamba_unet_tpu.train.contrastive_cc import (  # noqa: E402
    ContrastiveConsistencyTrainer as JCCTrainer,
)
from mamba_unet_tpu.utils import checkpoint as j_ckpt  # noqa: E402
from test_torch_train import _committed  # noqa: E402

# the JAX models' scan: JAX's plain sequential reference (lax.scan), the
# same function as its default chunked XLA route on the CPU, whose trace and
# compile take about twice as long
JAX_SCAN = "ref"
FT = (4, 8, 16, 32, 64)
NO_DROP = (0.0,) * 5
TOY_VIM = dict(depths=(1, 1), dims=(16, 32))
BATCH, LABELED, SIZE, SEED = 4, 2, 32, 0
# consistency1/2 at 40: w = 40 exp(-5) = 0.27 at steps 0-1, so the
# contrastive terms move the projectors visibly
CC = dict(labeled_bs=LABELED, consistency1=40.0, consistency2=40.0)
TOL = dict(rtol=1e-5, atol=1e-5)
LOSSES = ("loss_total", "loss_sup", "loss_unsup", "loss_contrast_l",
          "loss_contrast_u")


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
    compiled once each and run a few times."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _close(got, want, msg="", tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **tol, err_msg=msg)


# --- CTAugment, bitwise ------------------------------------------------------

def _ops_equal(a, b):
    assert [op for op, _ in a] == [op for op, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert list(x) == list(y)


@pytest.mark.parametrize("seed", [0, 3])
def test_cta_policies_and_rates_match_jax(seed):
    """The same op chains from the same seed (probe and learned, weak and
    strong), and the same rates after ``update_rates``."""
    got, want = t_cta.CTAugment(seed=seed), j_cta.CTAugment(seed=seed)
    assert list(t_cta.OPS) == list(j_cta.OPS)
    for probe in (True, False):
        for weak in (True, False):
            for _ in range(3):
                _ops_equal(got.policy(probe, weak), want.policy(probe, weak))
    for proximity in (0.9, 0.3):
        for weak in (True, False):
            pol, j_pol = got.policy(False, weak), want.policy(False, weak)
            _ops_equal(pol, j_pol)
            got.update_rates(pol, proximity)
            want.update_rates(j_pol, proximity)
    for k in t_cta.OPS:
        for a, b in zip(got.rates[k], want.rates[k]):
            np.testing.assert_array_equal(a, b)
    _ops_equal(got.policy(False, False), want.policy(False, False))
    assert got.stats() == want.stats()


def test_cta_apply_of_every_op_matches_jax():
    img = np.random.default_rng(1).random((40, 36)).astype(np.float32)
    for name, op in t_cta.OPS.items():
        for level in (0.0, 0.37, 0.99):
            args = [level] * len(op.bins)
            got = t_cta.cta_apply(t_cta.np_to_pil(img), [(name, args)],
                                  rng=np.random.default_rng(2))
            want = j_cta.cta_apply(j_cta.np_to_pil(img), [(name, args)],
                                   rng=np.random.default_rng(2))
            np.testing.assert_array_equal(t_cta.pil_to_np(got),
                                          j_cta.pil_to_np(want),
                                          err_msg=f"{name} {level}")
    idx, perm = t_cta.get_grid_shuffle_index(np.random.default_rng(4),
                                             (32, 32))
    j_idx, j_perm = j_cta.get_grid_shuffle_index(np.random.default_rng(4),
                                                 (32, 32))
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(perm, j_perm)
    np.testing.assert_array_equal(t_cta.grid_shuffle_image(img[:32, :32],
                                                           idx),
                                  j_cta.grid_shuffle_image(img[:32, :32],
                                                           j_idx))


def test_cta_transform_samples_match_jax():
    """Five samples in a row (the transform's generator runs on), a policy
    refresh between them: all 7 keys bitwise, with their dtypes."""
    tf = CTATransform((32, 32), t_cta.CTAugment(seed=5), seed=6)
    jtf = j_cta_transform.CTATransform((32, 32), j_cta.CTAugment(seed=5),
                                       seed=6)
    rng = np.random.default_rng(7)
    for i in range(5):
        sample = {"image": rng.random((48, 40)).astype(np.float32),
                  "label": rng.integers(0, 4, (48, 40))}
        got, want = tf(dict(sample)), jtf(dict(sample))
        assert sorted(got) == sorted(want) == sorted(
            ["image", "label", "image_weak", "image_strong", "label_aug",
             "jigsaw_image", "jigsaw_index"])
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if i == 2:
            tf.refresh_policies()
            jtf.refresh_policies()


def test_cta_state_file_round_trip_matches_jax(tmp_path):
    cta = t_cta.CTAugment(seed=1)
    jcta = j_cta.CTAugment(seed=1)
    for c in (cta, jcta):
        c.update_rates(c.policy(False, True), 0.4)
    t_ckpt.save_cta_state(str(tmp_path / "t"), cta)
    j_ckpt.save_cta_state(str(tmp_path / "j"), jcta)
    got = json.loads((tmp_path / "t" / "cta_state.json").read_text())
    want = json.loads((tmp_path / "j" / "cta_state.json").read_text())
    assert got == want
    back = t_cta.CTAugment(seed=9)
    assert t_ckpt.load_cta_state(str(tmp_path / "j"), back)
    assert not t_ckpt.load_cta_state(str(tmp_path / "none"), back)
    for k in t_cta.OPS:
        for a, b in zip(back.rates[k], cta.rates[k]):
            np.testing.assert_array_equal(a, b)
    assert not list(tmp_path.glob("*/*.tmp"))


# --- the contrastive losses -------------------------------------------------

def test_con_loss_and_its_gradient_match_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    want, (gq, gk) = jax.value_and_grad(j_con.con_loss, argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(k))
    tq = torch.from_numpy(q).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    got = t_con.con_loss(tq, tk)
    got.backward()
    _close(got, want, tol=dict(rtol=1e-6, atol=1e-6))
    _close(tq.grad, gq)
    assert tk.grad is None or not tk.grad.any()  # the keys take no gradient
    assert not np.asarray(gk).any()
    assert t_con.contrastive_loss_sup is t_con.con_loss


def test_info_nce_moco_and_queue_losses_match_jax():
    rng = np.random.default_rng(4)
    a, b = (rng.normal(size=(6, 8)).astype(np.float32) for _ in range(2))
    _close(t_con.info_nce_loss(torch.from_numpy(a), torch.from_numpy(b)),
           j_con.info_nce_loss(jnp.asarray(a), jnp.asarray(b)),
           tol=dict(rtol=1e-6, atol=1e-6))
    got, want = t_con.MocoLoss(max_entries=5), j_con.MocoLoss(max_entries=5)
    for idx in ([0, 1, 2], [2, 3, 4], [5, 6, 1]):  # a stale key, eviction
        q, k = (rng.normal(size=(3, 2, 2, 4)).astype(np.float32)
                for _ in range(2))
        _close(got(torch.from_numpy(q), torch.from_numpy(k), idx),
               want(jnp.asarray(q), jnp.asarray(k), idx),
               tol=dict(rtol=1e-6, atol=1e-6))
        assert list(got.queue) == list(want.queue)
    assert len(got.queue) == 5
    off = t_con.MocoLoss(use_queue=False)
    q, k = (rng.normal(size=(3, 4)).astype(np.float32) for _ in range(2))
    _close(off(torch.from_numpy(q), torch.from_numpy(k), [0, 1, 2]),
           j_con.MocoLoss(use_queue=False)(q, k, [0, 1, 2]),
           tol=dict(rtol=1e-6, atol=1e-6))
    assert not off.queue
    bank = rng.normal(size=(7, 2, 4)).astype(np.float32)
    q, kp = (rng.normal(size=(3, 2, 4)).astype(np.float32) for _ in range(2))
    _close(t_con.con_loss_queue(torch.from_numpy(q), torch.from_numpy(bank),
                                torch.from_numpy(kp)),
           j_con.con_loss_queue(q, bank, kp), tol=dict(rtol=1e-6, atol=1e-6))


# --- the small nets ----------------------------------------------------------

SMALL = (("projector", j_small.Projectors(input_nc=4, ndf=8),
          lambda: t_small.Projectors(4, 8), (2, 16, 16, 4)),
         ("classifier", j_small.Classifier(inp_dim=4, ndf=4),
          lambda: t_small.Classifier(4, 4), (2, 16, 16, 4)),
         ("Jigsaw_classifier", j_small.JigsawClassifier(inp_dim=4, ndf=2),
          lambda: t_small.JigsawClassifier(4, 2), (2, 224, 224, 4)),
         ("pnet", j_small.PNet2D(num_classes=4, num_filters=4),
          lambda: t_small.PNet2D(4, num_filters=4), (2, 24, 24, 1)))


@pytest.mark.parametrize("name,jmodel,make,shape", SMALL,
                         ids=[s[0] for s in SMALL])
def test_small_nets_match_jax(name, jmodel, make, shape):
    """Eval- and train-mode outputs (PNet's dropout aside: eval only) and
    the running statistics one train-mode forward leaves, from JAX's
    weights; the registry builds the model by its name."""
    from mamba_unet_torch.models import net_factory

    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    v = jax.jit(jmodel.init)(jax.random.key(1), jnp.zeros(shape))
    port = make()
    assert type(net_factory(name, **({"num_classes": 4, "num_filters": 4}
                                      if name == "pnet" else {}))) is type(
        port)
    port.load_state_dict(params_from_jax(
        _flat(v["params"]), like=port.state_dict(),
        batch_stats=_flat(v["batch_stats"])))
    with torch.no_grad():
        _close(port.eval()(torch.from_numpy(x)), jmodel.apply(v, x),
               "eval")
    if name == "pnet":
        return
    out, upd = jmodel.apply(v, x, deterministic=False,
                            mutable=["batch_stats"])
    # the jigsaw head's train-mode BatchNorms normalize 4-8 channels of a
    # few pooled elements each, where flax's variance (E[x²] - E[x]²) and
    # torch's two-pass one part by ~3e-5 of outputs up to 1.8
    tol = dict(rtol=1e-4, atol=1e-4) if name == "Jigsaw_classifier" else TOL
    with torch.no_grad():
        _close(port.train()(torch.from_numpy(x)), out, "train", tol)
    want = params_from_jax(_flat(v["params"]),
                           batch_stats=_flat(upd["batch_stats"]))
    for k, t in port.state_dict().items():
        if "running" in k:
            _close(t, want[k].numpy(), k)


# --- the trainer against the JAX trainer -------------------------------------

def _cfg(cls, **kw):
    return cls(base_lr=0.01, max_iterations=10, batch_size=BATCH,
               patch_size=(SIZE, SIZE), num_classes=4, eval_every=10**6,
               log_every=1, seed=SEED, **kw)


def _batches(n, seed=11):
    r = np.random.default_rng(seed)
    shape = (BATCH, SIZE, SIZE)
    return [{"image_weak": r.random((*shape, 1), np.float32),
             "image_strong": r.random((*shape, 1), np.float32),
             "label_aug": r.integers(0, 4, shape),
             "label": r.integers(0, 4, shape)} for _ in range(n)]


def _states(cc):
    return [(_flat(s.params), _flat(s.batch_stats))
            for s in (cc.s1, cc.s2, cc.p3, cc.p4)]


def _jax_cc(model):
    """(initial states of s1, s2, p3, p4; the losses of two steps; the
    states after them; the EMA projectors)."""
    trainer = _committed(JCCTrainer(model, _cfg(JTrainConfig),
                                    mesh=make_mesh(jax.devices()[:1]),
                                    **CC))
    start = _states(trainer.cc)
    logs = []
    for batch in _batches(2):
        trainer.cc, out = trainer._cc_step(
            trainer.cc, {k: jnp.asarray(v) for k, v in batch.items()})
        logs.append({k: float(v) for k, v in out.items()})
    return start, logs, _states(trainer.cc), (_flat(trainer.cc.p1_params),
                                              _flat(trainer.cc.p2_params))


@pytest.fixture(scope="module")
def jax_cc_vim():
    return _jax_cc(JMambaUnet(img_size=SIZE, num_classes=4,
                              drop_path_rate=0.0, scan_impl=JAX_SCAN,
                              **TOY_VIM))


@pytest.fixture(scope="module")
def jax_cc_unet():
    return _jax_cc(JUNet(num_classes=4, ft_chns=FT, dropout=NO_DROP))


def _port_trainer(start, make, **kw):
    nets = []
    for (params, stats), build in zip(
            start, (make, make, lambda: t_small.Projectors(4, 8),
                    lambda: t_small.Projectors(4, 8))):
        net = build()
        net.load_state_dict(params_from_jax(
            params, like=net.state_dict(), batch_stats=stats))
        nets.append(net)
    return ContrastiveConsistencyTrainer(
        nets[0], _cfg(TrainConfig, **kw), model2=nets[1],
        projectors=(nets[2], nets[3]), device="cpu", **CC)


def _assert_cc(trainer, want_logs, logs, after, emas):
    for got, want in zip(logs, want_logs):
        for key in LOSSES:
            np.testing.assert_allclose(float(got[key]), want[key], **TOL,
                                       err_msg=key)
    nets = (trainer.model, trainer.model2, trainer.p3, trainer.p4)
    for net, (params, stats) in zip(nets, after):
        want = params_from_jax(params, batch_stats=stats)
        for k, t in net.state_dict().items():
            if "num_batches" not in k:  # flax keeps no step count
                _close(t, want[k].numpy(), k)
    for ema, flat in zip((trainer.p1, trainer.p2), emas):
        want = params_from_jax(flat)
        assert sorted(ema) == sorted(want)
        for k, t in ema.items():
            _close(t, want[k].numpy(), k)


@pytest.mark.parametrize("pair", ["vim", "unet"])
def test_two_cc_steps_match_the_jax_trainer(pair, request):
    """Toy ViM_seg pair (LayerNorm only) and toy unet pair (BatchNorm:
    each model keeps its weak pass's statistics, the projectors none):
    the five losses, every parameter and statistic, the EMA projectors
    (after step 1 a copy of the trained ones: the EMA's a is 0 at step
    0)."""
    start, want_logs, after, emas = request.getfixturevalue(
        f"jax_cc_{pair}")
    make = ((lambda: TMambaUnet(num_classes=4, drop_path_rate=0.0,
                                **TOY_VIM)) if pair == "vim" else
            (lambda: TUNet(num_classes=4, ft_chns=FT, dropout=NO_DROP)))
    trainer = _port_trainer(start, make)
    logs = []
    for batch in _batches(2):
        logs.append(trainer.train_step({k: torch.from_numpy(v)
                                        for k, v in batch.items()}))
        if trainer.step == 1:
            for ema, proj in ((trainer.p1, trainer.p3),
                              (trainer.p2, trainer.p4)):
                for n, p in proj.named_parameters():
                    assert torch.equal(ema[n], p.detach()), n
    _assert_cc(trainer, want_logs, logs, after, emas)
    stats = [k for k in trainer.p3.state_dict() if "running" in k]
    for proj, (params, bs) in zip((trainer.p3, trainer.p4), start[2:]):
        init = params_from_jax(params, batch_stats=bs)
        for k in stats:  # the projectors never keep their statistics
            assert torch.equal(proj.state_dict()[k], init[k]), k


# --- port-only: resume, the CLI ----------------------------------------------

def _unet_cc(snap=None, **kw):
    cfg = _cfg(TrainConfig, snapshot_dir=snap, ckpt_every=2, **kw)
    m1, m2 = (TUNet(num_classes=4, ft_chns=FT,
                    generator=torch.Generator().manual_seed(s))
              for s in (0, 1))
    return ContrastiveConsistencyTrainer(m1, cfg, model2=m2, device="cpu",
                                         **CC)


class _Loader:
    """Fixed batches with an epoch length for the CTAugment schedule."""

    def __init__(self, batches, epoch=2):
        self.batches, self.epoch = batches, epoch

    def __len__(self):
        return self.epoch

    def __iter__(self):
        return iter(self.batches)


def test_cc_resume_continues_as_one_run(tmp_path):
    """2 steps + periodic checkpoint + resume + 2 steps == 4 steps: both
    models, projectors, EMA projectors and optimizers; the resumed run
    starts from the CTAugment rates of ``cta_state.json``."""
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in _batches(4)]

    def cta_pair():
        cta = t_cta.CTAugment(seed=2)
        return cta, CTATransform((SIZE, SIZE), cta, seed=3)

    whole = _unet_cc()
    whole.fit(_Loader(batches), *cta_pair())
    snap = str(tmp_path / "snap")
    cta_a, tf_a = cta_pair()
    assert _unet_cc(snap).fit(_Loader(batches[:2]), cta=cta_a,
                              cta_transform=tf_a)["iterations"] == 2
    assert (tmp_path / "snap" / "cta_state.json").is_file()
    second = _unet_cc(snap, resume=True)
    cta_b, tf_b = cta_pair()
    second.cta, second.cta_transform = cta_b, tf_b
    assert second.try_resume() == 2
    for k in t_cta.OPS:  # the rates learned in the first two steps
        for a, b in zip(cta_a.rates[k], cta_b.rates[k]):
            np.testing.assert_array_equal(a, b)
    assert second.fit(_Loader(batches[2:]), cta=cta_b,
                      cta_transform=tf_b)["iterations"] == 4
    for a, b in ((whole.model, second.model), (whole.model2, second.model2),
                 (whole.p3, second.p3), (whole.p4, second.p4)):
        for k, v in a.state_dict().items():
            torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0,
                                       msg=k)
    for ea, eb in ((whole.p1, second.p1), (whole.p2, second.p2)):
        for k, v in ea.items():
            torch.testing.assert_close(eb[k], v, rtol=0, atol=0, msg=k)


def test_contrastive_consistency_through_the_train_cli(tmp_path):
    """``--method contrastive_consistency --model unet`` on CTA-fed
    phantoms: ``best``/``best2`` written with their marks, the periodic
    checkpoint and ``cta_state.json`` beside it; ``--mask_recovery`` is
    refused."""
    snap = tmp_path / "snap"
    common = ["--synthetic", "--device", "cpu", "--patch_size", str(SIZE),
              str(SIZE), "--synthetic_spec", "2", "8", "1", "0", "40"]
    assert train_cli.main([
        "--method", "contrastive_consistency", "--model", "unet",
        "--batch_size", "4", "--labeled_bs", "2", "--max_iterations", "2",
        "--eval_every", "1", "--ckpt_every", "2", "--snapshot_dir",
        str(snap), *common]) == 0
    names = {p.name for p in snap.iterdir()}
    assert {"state_2", "cta_state.json"} <= names, names
    marks = json.loads((snap / "best_marks.json").read_text())
    for name in ("best", "best2"):
        assert any(n.startswith(f"{name}_") for n in names), names
        assert marks[name] > 0
    tree = t_ckpt.restore_checkpoint(str(snap), 2)
    assert {"model", "model2", "p3", "p4", "p1", "p2",
            "p3_optimizer"} <= set(tree)
    with pytest.raises(NotImplementedError, match="mask_recovery"):
        train_cli.main(["--method", "contrastive_consistency",
                        "--mask_recovery", *common])


def test_pretrained_ckpt_warm_starts_both_models_of_the_pair(tmp_path,
                                                             monkeypatch,
                                                             caplog):
    """``--pretrained_ckpt`` with a ``ViM_seg`` pair (toy-sized) loads the
    checkpoint into both models, as the reference's scripts do."""
    import functools
    import logging

    from mamba_unet_torch.models import vssm

    monkeypatch.setattr(vssm, "MambaUnet",
                        functools.partial(TMambaUnet, **TOY_VIM))
    caplog.set_level(logging.INFO)
    source = TMambaUnet(num_classes=4, generator=torch.Generator()
                        .manual_seed(4), **TOY_VIM)
    torch.save({f"mamba_unet.{k}": v for k, v in
                source.mamba_unet.state_dict().items()}, tmp_path / "w.pth")
    assert train_cli.main([
        "--method", "contrastive_consistency", "--model", "ViM_seg",
        "--pretrained_ckpt", str(tmp_path / "w.pth"), "--synthetic",
        "--device", "cpu", "--patch_size", str(SIZE), str(SIZE),
        "--batch_size", "4", "--labeled_bs", "2", "--max_iterations", "1",
        "--eval_every", "100", "--synthetic_spec", "2", "8", "1", "0",
        "40"]) == 0
    n = len(source.state_dict())
    for tag in ("", " model2"):
        assert (f"pretrained{tag}: loaded {n} tensors, 0 missing, 0 "
                f"shape-skipped") in caplog.text
