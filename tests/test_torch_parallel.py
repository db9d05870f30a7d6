"""The port's parallelism against the JAX package's.

The multi-rank paths run on CPU ``gloo`` ranks, spawned once per world
size for this module (``parallel.launch.run_ranks`` with the jobs of
``parallel.checks``, which import no JAX); the JAX side runs on the
virtual CPU devices of ``tests/conftest.py``. Inputs come from seeded
numpy, weights through ``params_from_jax``. Tolerances, as the JAX
package's own tests: the sequence-sharded scan 2e-4 (gradients 3e-3,
``tests/test_seq_scan.py``), the channel-sharded scan's 7 gradients 2e-3
(``tests/test_tp_scan.py``), a toy SS2D's output on each sharded route
2e-4 (the channel-sharded one also over a 2 x 2 (data, model) mesh,
``batch_axis``, on 4 ranks) and the pipelined LM's logits 2e-5; the data-parallel steps
1e-5 on the losses and weights against the port's one-process step (fp32
in another order), and against the JAX Trainer on a 2-device mesh 1e-5
on the losses and 1e-4 on the weights: JAX's own 2-device step differs
from its one-device step by 3.9e-5 on these weights (the port's
one-process step is 1.2e-7 from JAX's one-device one). JAX's dropout
draws other bits than the port's generator, so the data-parallel steps
are held to JAX with dropout off and to the port's one-process step with
dropout and drop-path on.
"""

import logging
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.models.unet import UNet as TUNet  # noqa: E402
from mamba_unet_torch.models.vssm import MambaUnet as TMambaUnet  # noqa: E402
from mamba_unet_torch.nn.ss2d import SS2D as TSS2D  # noqa: E402
from mamba_unet_torch.ops.selective_scan import selective_scan  # noqa: E402
from mamba_unet_torch.parallel import (  # noqa: E402
    make_mesh,
    shard_batch,
)
from mamba_unet_torch.parallel.checks import run_jobs  # noqa: E402
from mamba_unet_torch.parallel.launch import free_port, run_ranks  # noqa: E402,E501
from mamba_unet_torch.parallel.mesh import Mesh  # noqa: E402
from mamba_unet_torch.train.trainer import TrainConfig, Trainer  # noqa: E402
from mamba_unet_torch.utils.convert import params_from_jax  # noqa: E402
from mamba_unet_torch.utils.convert_lm import params_from_jax_lm  # noqa: E402
from mamba_unet_tpu.models.mamba_lm import MambaLMHeadModel as JLM  # noqa: E402,E501
from mamba_unet_tpu.models.unet import UNet as JUNet  # noqa: E402
from mamba_unet_tpu.nn.ss2d import SS2D as JSS2D  # noqa: E402
from mamba_unet_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from mamba_unet_tpu.parallel import pipeline_lm_apply as j_pipe_apply  # noqa: E402,E501
from mamba_unet_tpu.parallel import pipeline_lm_loss as j_pipe_loss  # noqa: E402,E501
from mamba_unet_tpu.parallel.seq_scan import (  # noqa: E402
    selective_scan_seq_sharded as j_seq,
    sequence_sharding as j_sequence_sharding,
)
from mamba_unet_tpu.parallel.tp_scan import (  # noqa: E402
    channel_sharding as j_channel_sharding,
    selective_scan_tp_sharded as j_tp,
)
from mamba_unet_tpu.train import TrainConfig as JTrainConfig  # noqa: E402
from mamba_unet_tpu.train import Trainer as JTrainer  # noqa: E402

from test_torch_train import _committed  # noqa: E402

SEQ_TOL = dict(rtol=2e-4, atol=2e-4)
SEQ_GRAD_TOL = dict(rtol=3e-3, atol=3e-3)
TP_GRAD_TOL = dict(rtol=2e-3, atol=2e-3)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias")
TOY_VIM = dict(depths=(1, 1), dims=(16, 32))
FT = (4, 8, 16, 32, 64)
NO_DROP = (0.0,) * 5
VOCAB, D_MODEL, N_LAYER, LM_B, LM_L, N_MICRO = 17, 16, 2, 4, 8, 2
SS2D_KW = dict(d_model=16, d_state=4)
DP_CFG = dict(base_lr=0.05, max_iterations=10, batch_size=4,
              patch_size=(32, 32), num_classes=4, eval_every=10 ** 6,
              log_every=1, seed=0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def fast_jax_compiles():
    """XLA's cheaper compile while this file runs (the JAX references are
    compile-bound)."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _scan_inputs(seed=0, bsz=2, d=8, L=32, n=4, G=2):
    r = np.random.default_rng(seed)
    f32 = np.float32
    return {"u": r.normal(size=(bsz, d, L)).astype(f32),
            "delta": (0.4 * r.normal(size=(bsz, d, L))).astype(f32),
            "A": (-np.exp(0.5 * r.normal(size=(d, n)))).astype(f32),
            "B": r.normal(size=(bsz, G, n, L)).astype(f32),
            "C": r.normal(size=(bsz, G, n, L)).astype(f32),
            "D": r.normal(size=(d,)).astype(f32),
            "delta_bias": (0.1 * r.normal(size=(d,))).astype(f32)}


def _batches(n, bsz=4, size=32, seed=11):
    r = np.random.default_rng(seed)
    return [{"image": r.random((bsz, size, size, 1), np.float32),
             "label": r.integers(0, 4, (bsz, size, size))} for _ in range(n)]


# --- the JAX side ---------------------------------------------------------------

def _jax_scan(route, n, inp, cot):
    """JAX's sharded scan on an n-device mesh: y and the 7 gradients of
    sum(y * cot)."""
    args = [jnp.asarray(inp[k]) for k in SCAN_NAMES]
    if route == "seq":
        mesh = j_make_mesh(devices=jax.devices()[:n], axes=("seq",))

        def f(u, delta, A, B, C, D, db):
            return j_seq(u, delta, A, B, C, D, None, db, True, mesh=mesh,
                         chunk=8)
    else:
        mesh = j_make_mesh(devices=jax.devices()[:n], axes=("model",))

        def f(u, delta, A, B, C, D, db):
            return j_tp(u, delta, A, B, C, D, None, db, True, mesh=mesh)
    y, vjp = jax.vjp(jax.jit(f), *args)
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _ss2d_jax(route, x, data=1):
    """JAX's toy SS2D on ``route`` over a 2-device mesh, or for
    "tp_sharded" with ``data`` > 1 over a (data, model) mesh of
    (data, 2), the batch split over ``data``: its flat params and
    output."""
    model = JSS2D(scan_impl=route, **SS2D_KW)
    variables = JSS2D(**SS2D_KW).init(jax.random.key(3), jnp.asarray(x))
    if route == "seq_sharded":
        ctx = j_sequence_sharding(j_make_mesh(jax.devices()[:2], ("seq",)))
    elif data > 1:
        ctx = j_channel_sharding(j_make_mesh(
            jax.devices()[:2 * data], ("data", "model"), (data, 2)),
            "model", batch_axis="data")
    else:
        ctx = j_channel_sharding(j_make_mesh(jax.devices()[:2], ("model",)))
    with ctx:
        logits = jax.jit(model.apply)(variables, jnp.asarray(x))
    return _flat(variables["params"]), np.asarray(logits)


@pytest.fixture(scope="module")
def scan_case():
    inp = _scan_inputs()
    cot = np.random.default_rng(1).normal(size=inp["u"].shape).astype(
        np.float32)
    return inp, cot


@pytest.fixture(scope="module")
def ss2d_case():
    r = np.random.default_rng(2)
    x = r.normal(size=(2, 8, 8, 16)).astype(np.float32)
    cot = r.normal(size=(2, 8, 8, 16)).astype(np.float32)
    jax_side = {route: _ss2d_jax(route, x)
                for route in ("seq_sharded", "tp_sharded")}
    jax_side["tp_sharded_2x2"] = _ss2d_jax("tp_sharded", x, data=2)
    params = jax_side["seq_sharded"][0]
    like = TSS2D(**SS2D_KW).state_dict()
    weights = {k: v.numpy() for k, v in
               params_from_jax(params, like=like).items()}
    # the port's one-process tm branch on the same weights: its gradients
    net = TSS2D(scan_impl="tm", **SS2D_KW)
    net.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    logits = net(torch.as_tensor(x))
    (logits * torch.as_tensor(cot)).sum().backward()
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    return x, cot, weights, jax_side, grads


@pytest.fixture(scope="module")
def lm_case():
    model = JLM(vocab_size=VOCAB, d_model=D_MODEL, n_layer=N_LAYER,
                scan_impl="ref")
    r = np.random.default_rng(4)
    ids = r.integers(0, VOCAB, (LM_B, LM_L)).astype(np.int32)
    targets = r.integers(0, VOCAB, (LM_B, LM_L)).astype(np.int32)
    variables = model.init(jax.random.key(0), jnp.asarray(ids))
    mesh = j_make_mesh(devices=jax.devices()[:2], axes=("pipe",))

    def loss_and_logits(v):
        # pipeline_lm_loss's mean next-token NLL of pipeline_lm_apply's
        # logits, with the logits kept: one compile for both
        logits = j_pipe_apply(model, v, jnp.asarray(ids), mesh,
                              n_micro=N_MICRO)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(targets)[..., None], -1)
        return jnp.mean(nll), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_and_logits, has_aux=True))(variables)
    # the same loss through pipeline_lm_loss itself (no gradient)
    np.testing.assert_allclose(float(jax.jit(lambda v: j_pipe_loss(
        model, v, jnp.asarray(ids), jnp.asarray(targets), mesh,
        n_micro=N_MICRO))(variables)), float(loss), rtol=1e-6)
    weights = {k: v.numpy() for k, v in params_from_jax_lm(
        _flat(variables["params"])).items()}
    want_grads = {k: v.numpy() for k, v in params_from_jax_lm(
        _flat(grads["params"])).items()}
    return ids, targets, weights, np.asarray(logits), float(loss), want_grads


@pytest.fixture(scope="module")
def unet_jax_steps():
    """The JAX Trainer's two unet steps (BatchNorm, dropout off) over a
    2-device data mesh."""
    model = JUNet(num_classes=4, ft_chns=FT, dropout=NO_DROP)
    trainer = JTrainer(model, JTrainConfig(**DP_CFG),
                       mesh=j_make_mesh(jax.devices()[:2]))
    start = (_flat(trainer.state.params), _flat(trainer.state.batch_stats))
    result = _committed(trainer).fit(_batches(2))
    s = trainer.state
    return (start, [h["loss"] for h in result["history"]],
            (_flat(s.params), _flat(s.batch_stats)))


def _unet_weights(params, stats, steps=0, dropout=NO_DROP):
    like = TUNet(num_classes=4, ft_chns=FT, dropout=dropout).state_dict()
    return params_from_jax(params, like=like, batch_stats=stats,
                           num_batches_tracked=steps)


# --- the ranks --------------------------------------------------------------------

UNET = ("mamba_unet_torch.models.unet", "UNet")
VIM = ("mamba_unet_torch.models.vssm", "MambaUnet")
LM = ("mamba_unet_torch.models.mamba_lm", "MambaLMHeadModel")
SS2D = ("mamba_unet_torch.nn.ss2d", "SS2D")


@pytest.fixture(scope="module")
def ranks2(scan_case, ss2d_case, lm_case, unet_jax_steps):
    """Every 2-rank job, in one spawned group."""
    inp, cot = scan_case
    x, vcot, vweights = ss2d_case[:3]
    ids, targets, lweights = lm_case[:3]
    start = unet_jax_steps[0]
    unet_w = {k: v.numpy() for k, v in _unet_weights(*start).items()}
    jobs = [
        ("scan", dict(route="seq", inputs=inp, cot=cot)),
        ("scan", dict(route="tp", inputs=inp, cot=cot)),
        ("model", dict(builder=(*SS2D, dict(SS2D_KW,
                                            scan_impl="seq_sharded")),
                       x=x, cot=vcot, route="seq", weights=vweights)),
        ("model", dict(builder=(*SS2D, dict(SS2D_KW, scan_impl="tp_sharded")),
                       x=x, cot=vcot, route="tp", weights=vweights)),
        ("pipeline", dict(builder=(*LM, dict(vocab_size=VOCAB,
                                             d_model=D_MODEL,
                                             n_layer=N_LAYER)),
                          ids=ids.astype(np.int64),
                          targets=targets.astype(np.int64),
                          n_micro=N_MICRO, weights=lweights)),
        ("pipeline", dict(builder=(*LM, dict(vocab_size=VOCAB,
                                             d_model=D_MODEL,
                                             n_layer=N_LAYER)),
                          ids=ids.astype(np.int64),
                          targets=targets.astype(np.int64),
                          n_micro=N_MICRO, weights=lweights, prestack=True)),
        ("train", dict(builder=(*UNET, dict(num_classes=4, ft_chns=FT,
                                            dropout=NO_DROP)),
                       config=DP_CFG, batches=_batches(2), weights=unet_w)),
        ("train", dict(builder=(*UNET, dict(num_classes=4, ft_chns=FT)),
                       config=DP_CFG, batches=_batches(2), seed=5)),
        ("train", dict(builder=(*VIM, dict(num_classes=4, drop_path_rate=0.3,
                                           scan_impl="tm", **TOY_VIM)),
                       config=DP_CFG, batches=_batches(2), seed=6)),
    ]
    return run_ranks(2, run_jobs, "cpu", jobs)


@pytest.fixture(scope="module")
def ranks4(scan_case, ss2d_case):
    """Every 4-rank job, in one spawned group."""
    inp, cot = scan_case
    x, vcot, vweights = ss2d_case[:3]
    return run_ranks(4, run_jobs, "cpu", [
        ("scan", dict(route="seq", inputs=inp, cot=cot)),
        ("model", dict(builder=(*SS2D, dict(SS2D_KW, scan_impl="tp_sharded")),
                       x=x, cot=vcot, route="tp", weights=vweights,
                       data_ranks=2)),
    ])


# --- the plain scan with a carry ---------------------------------------------

def test_plain_scan_with_x_init_matches_jax(scan_case):
    """``selective_scan_ref(x_init=...)`` against JAX's XLA scan from the
    same incoming state, y and last state; and its gradients (through the
    grouped op, whose CPU backward is the plain reverse-time loop with
    g_last and dx_init) against JAX's of y and the last state."""
    inp, cot = scan_case
    r = np.random.default_rng(7)
    x0 = r.normal(size=(2, 8, 4)).astype(np.float32)
    g_last = r.normal(size=(2, 8, 4)).astype(np.float32)
    from mamba_unet_tpu.ops.selective_scan import selective_scan_xla

    def jf(u, delta, A, B, C, D, db, x_init):
        return selective_scan_xla(u, delta, A, B, C, D, None, db, True,
                                  return_last_state=True, chunk=8,
                                  x_init=x_init)

    jargs = [jnp.asarray(inp[k]) for k in SCAN_NAMES] + [jnp.asarray(x0)]
    (jy, jlast), vjp = jax.vjp(jf, *jargs)
    jgrads = vjp((jnp.asarray(cot), jnp.asarray(g_last)))
    targs = {k: torch.tensor(inp[k], requires_grad=True) for k in SCAN_NAMES}
    tx0 = torch.tensor(x0, requires_grad=True)
    from mamba_unet_torch.ops.selective_scan import selective_scan_ref
    with torch.no_grad():
        y_ref, last_ref = selective_scan_ref(
            *[targs[k] for k in SCAN_NAMES[:5]], targs["D"], None,
            targs["delta_bias"], True, True, x_init=tx0)
    np.testing.assert_allclose(y_ref.numpy(), np.asarray(jy), **SEQ_TOL)
    np.testing.assert_allclose(last_ref.numpy(), np.asarray(jlast),
                               **SEQ_TOL)
    # the grouped op (time-major) with x_init and a differentiable last
    # state: the training path of the sharded scans
    y, last = selective_scan(*[targs[k] for k in SCAN_NAMES[:5]], targs["D"],
                             None, targs["delta_bias"], True, True,
                             x_init=tx0)
    ((y * torch.as_tensor(cot)).sum()
     + (last * torch.as_tensor(g_last)).sum()).backward()
    got = [targs[k].grad for k in SCAN_NAMES] + [tx0.grad]
    for name, g, w in zip(SCAN_NAMES + ("x_init",), got, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SEQ_GRAD_TOL,
                                   err_msg=name)


# --- the sharded scans ----------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_seq_sharded_scan_matches_jax(scan_case, ranks2, ranks4, world):
    inp, cot = scan_case
    want_y, want_grads = _jax_scan("seq", world, inp, cot)
    got = (ranks2 if world == 2 else ranks4)[0][0]
    np.testing.assert_allclose(got["y"], want_y, **SEQ_TOL)
    for name, w in zip(SCAN_NAMES, want_grads):
        np.testing.assert_allclose(got["grads"][name], w, **SEQ_GRAD_TOL,
                                   err_msg=name)


def test_tp_sharded_scan_all_seven_gradients_match_jax(scan_case, ranks2):
    inp, cot = scan_case
    want_y, want_grads = _jax_scan("tp", 2, inp, cot)
    got = ranks2[0][1]
    np.testing.assert_allclose(got["y"], want_y, **TP_GRAD_TOL)
    for name, w in zip(SCAN_NAMES, want_grads):
        np.testing.assert_allclose(got["grads"][name], w, **TP_GRAD_TOL,
                                   err_msg=name)


def test_every_rank_ends_with_the_same_gradients(ranks2):
    """JAX's global view: each rank holds the full gradients."""
    for job in range(5):
        a, b = ranks2[0][job], ranks2[1][job]
        for k in a["grads"]:
            np.testing.assert_array_equal(a["grads"][k], b["grads"][k])


@pytest.mark.parametrize("route,world,job", [
    ("seq_sharded", 2, 2), ("tp_sharded", 2, 3), ("tp_sharded_2x2", 4, 1)])
def test_ss2d_sharded_route_matches_jax(ss2d_case, ranks2, ranks4, route,
                                        world, job):
    """A toy SS2D on ``route``: its output against JAX's SS2D on the same
    route (2e-4), its gradients against the port's one-process tm branch
    on the same weights. ``tp_sharded_2x2``: the channels over ``model``
    and the batch over ``data`` (``batch_axis``) of a 2 x 2 mesh, against
    JAX's (data, model) mesh; every rank ends with the same gradients."""
    _, _, _, jax_side, grads = ss2d_case
    out = ranks2 if world == 2 else ranks4
    got = out[0][job]
    np.testing.assert_allclose(got["logits"], jax_side[route][1], **SEQ_TOL)
    for k, w in grads.items():
        np.testing.assert_allclose(got["grads"][k], w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
        for other in out[1:]:
            np.testing.assert_array_equal(other[job]["grads"][k],
                                          got["grads"][k], err_msg=k)


def test_sharded_route_outside_its_context_raises():
    net = TMambaUnet(num_classes=4, scan_impl="seq_sharded", **TOY_VIM)
    with pytest.raises(RuntimeError, match="sequence_sharding"):
        net(torch.zeros(1, 32, 32, 1))


# --- the pipeline -----------------------------------------------------------------

def test_pipeline_matches_jax(lm_case, ranks2):
    """Logits (2e-5) and loss against JAX's pipeline_lm_apply /
    pipeline_lm_loss on a 2-stage mesh; every parameter's gradient against
    JAX's (1e-4: fp32 sums over 4 layers in another order)."""
    _, _, _, want_logits, want_loss, want_grads = lm_case
    got = ranks2[0][4]
    np.testing.assert_allclose(got["logits"][..., :want_logits.shape[-1]],
                               want_logits, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["loss"], want_loss, rtol=2e-5)
    for k, w in want_grads.items():
        np.testing.assert_allclose(got["grads"][k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_prestacked_pipeline_matches_jax(lm_case, ranks2):
    """:func:`prestack_lm_params`' layout: each stage holds and trains
    only its own layers; logits and loss as JAX's pipeline, each stage's
    layer gradients those of its layers in JAX's, the embedding's and
    final norm's on every rank."""
    _, _, _, want_logits, want_loss, want_grads = lm_case
    per = N_LAYER // 2
    for rank, out in enumerate(ranks2):
        got = out[5]
        np.testing.assert_allclose(
            got["logits"][..., :want_logits.shape[-1]], want_logits,
            rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["loss"], want_loss, rtol=2e-5)
        for name, g in got["stage_grads"].items():
            assert g.shape[0] == per
            for k in range(per):
                layer = rank * per + k
                np.testing.assert_allclose(
                    g[k], want_grads[f"backbone.layers.{layer}.{name}"],
                    rtol=1e-4, atol=1e-5, err_msg=f"{layer}.{name}")
        for k in ("backbone.embedding.weight", "backbone.norm_f.weight"):
            np.testing.assert_allclose(got["grads"][k], want_grads[k],
                                       rtol=1e-4, atol=1e-5, err_msg=k)


# --- data parallelism -------------------------------------------------------------

def test_data_parallel_unet_steps_match_the_jax_trainer(unet_jax_steps,
                                                        ranks2):
    """2 ranks x 2 rows of a batch of 4: BatchNorm over the global batch,
    CE and Dice over it; losses and weights after 2 steps against the JAX
    Trainer on a 2-device data mesh."""
    _, want_losses, (params, stats) = unet_jax_steps
    got = ranks2[0][6]
    np.testing.assert_allclose(got["losses"], want_losses, **STEP_TOL)
    want = _unet_weights(params, stats, steps=2)
    for k, w in want.items():
        if w.is_floating_point():
            np.testing.assert_allclose(got["state"][k], w.numpy(),
                                       rtol=1e-5, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("job,builder,seed", [
    (7, (*UNET, dict(num_classes=4, ft_chns=FT)), 5),
    (8, (*VIM, dict(num_classes=4, drop_path_rate=0.3, scan_impl="tm",
                    **TOY_VIM)), 6)])
def test_data_parallel_step_with_random_masks_matches_one_process(
        ranks2, job, builder, seed):
    """Dropout (unet) and drop-path (toy Mamba-UNet) on: the masks are
    drawn for the global batch, so 2 ranks compute the one-process steps;
    and both ranks hold the same weights."""
    from mamba_unet_torch.parallel.checks import build_model

    trainer = Trainer(build_model(builder, seed=seed), TrainConfig(**DP_CFG),
                      device="cpu")
    losses = [float(trainer.train_step(
        {k: torch.as_tensor(v) for k, v in b.items()})["loss_total"])
        for b in _batches(2)]
    got = ranks2[0][job]
    np.testing.assert_allclose(got["losses"], losses, **STEP_TOL)
    for k, v in trainer.model.state_dict().items():
        if v.is_floating_point():
            np.testing.assert_allclose(got["state"][k], v.numpy(),
                                       **STEP_TOL, err_msg=k)
            np.testing.assert_array_equal(ranks2[1][job]["state"][k],
                                          got["state"][k])


def test_mesh_without_a_process_group_is_one_rank():
    mesh = make_mesh(("data", "model"))
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.group("data") is None and mesh.index("model") == 0
    batch = {"image": np.arange(8).reshape(4, 2), "label": [torch.ones(4)]}
    out = shard_batch(batch, mesh)
    np.testing.assert_array_equal(out["image"], batch["image"])
    half = Mesh(("data",), (2,), 1, {"data": None})
    np.testing.assert_array_equal(shard_batch(batch, half)["image"],
                                  batch["image"][2:])
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(("data",), (2,))


@pytest.mark.parametrize("method", [
    [], ["--method", "cross_teaching", "--labeled_bs", "2"]])
def test_train_cli_under_torchrun_matches_one_process(tmp_path, caplog,
                                                      method):
    """``torchrun`` with 2 CPU ranks, 2 steps at 32², fully supervised
    and cross-teaching (a labeled and an unlabeled row per rank): the
    global batch split over the ranks gives the one-process run's step-1
    loss and the Dice of its weights (each model's) after step 2."""
    from mamba_unet_torch.cli import train as train_cli

    argv = ["--model", "unet", "--synthetic", "--device", "cpu",
            "--patch_size", "32", "32", "--batch_size", "4",
            "--max_iterations", "2", "--eval_every", "2",
            "--synthetic_spec", "2", "4", "1", "0", "32", *method]
    keep = (" loss ", "val mean dice")

    def lines(messages):
        return sorted(re.sub(r" \(\S+ it/s\)", "", m) for m in messages
                      if any(k in m for k in keep))

    caplog.set_level(logging.INFO)
    assert train_cli.main(argv) == 0
    one = lines(caplog.messages)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.getcwd()] + sys.path), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "localhost", "--master_port",
         str(free_port()), "-m", "mamba_unet_torch.cli.train", *argv],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    two = lines(line.split(" ", 1)[1] for line in proc.stdout.splitlines())
    # step 1's loss is logged by both ranks; rank 0 validates each model
    assert len(one) == (3 if method else 2)
    assert two == sorted(one + [m for m in one if " loss " in m])
