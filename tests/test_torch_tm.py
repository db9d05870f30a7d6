"""The port's time-major training path against JAX: the grouped scan's
state-saving forward and backward, SS2D and Mamba-UNet with
``scan_impl="tm"``, the 1-D Mamba's gradients, and ``--scan_impl`` in the
train CLI.

Inputs are drawn with numpy from a seed and fed to both frameworks; JAX
weights are carried into the port by ``params_from_jax``/``_lm``. The JAX
side runs its Pallas kernels in interpret mode on the CPU. Tolerances,
each relative to the largest magnitude of the output it bounds:

* the plain grouped scan (y, the chunk-entry states and all seven
  gradients) against ``selective_scan_pallas_tm`` and its VJP: 1e-5 (the
  same fp32 recurrence, sums in another order); bf16 operands against JAX
  fp32 on their widened values: 2e-4 plus one bf16 rounding step of each
  value where the result is bf16 (both round an fp32 sum to bf16 once);
* SS2D and the toy Mamba-UNet, outputs and every parameter's gradient:
  1e-4 (fp32 matmuls, convolutions and the scan in another order); the
  port's tm branch against its bidir branch on the same weights: 1e-5;
* the 1-D Mamba and its block, output and every gradient: 1e-4.

The CUDA kernels themselves run only on a card: tests/test_torch_kernel.py
and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.cli import train as train_cli  # noqa: E402
from mamba_unet_torch.models.vssm import MambaUnet as TMambaUnet  # noqa: E402
from mamba_unet_torch.nn import ss2d as tss2d  # noqa: E402
from mamba_unet_torch.nn.mamba1d import Mamba, MambaBlock  # noqa: E402
from mamba_unet_torch.ops import selective_scan_grouped as sg  # noqa: E402
from mamba_unet_torch.ops.selective_scan import selective_scan  # noqa: E402
from mamba_unet_torch.utils.compare import BF16_STEP  # noqa: E402
from mamba_unet_torch.utils.convert import params_from_jax  # noqa: E402
from mamba_unet_torch.utils.convert_lm import params_from_jax_lm  # noqa: E402
from mamba_unet_tpu.models.vssm import MambaUnet as JMambaUnet  # noqa: E402
from mamba_unet_tpu.nn import mamba1d as jm  # noqa: E402
from mamba_unet_tpu.nn.ss2d import SS2D as JSS2D  # noqa: E402
from mamba_unet_tpu.ops.selective_scan import (  # noqa: E402
    selective_scan as j_scan,
)
from mamba_unet_tpu.ops.selective_scan_pallas import (  # noqa: E402
    _prep_params,
    _scan_fwd_impl,
    selective_scan_pallas_tm,
)

SCAN_REL, MODULE_REL, BRANCH_REL, BF16_REL = 1e-5, 1e-4, 1e-5, 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on a few cores, and torch's default of one thread per core
    oversubscribed them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_rel(got, want, rel, what, step=False):
    """|got - want| <= rel * max|want| elementwise (plus one bf16 rounding
    step of want with ``step``)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = rel * np.abs(want).max() + (BF16_STEP * np.abs(want) if step
                                         else 0.0)
    err = np.abs(got - want)
    assert np.isfinite(got).all() and (err <= bound).all(), (
        what, float(err.max()), float(np.abs(want).max()))


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _objective_weights(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# --- (a) the grouped scan: state-saving forward and backward -------------

def _scan_inputs(rng, bsz, G, L, dg, n=16):
    return dict(
        u=rng.normal(size=(bsz, G, L, dg)).astype(np.float32),
        delta=(0.5 * rng.normal(size=(bsz, G, L, dg))).astype(np.float32),
        A=-np.exp(0.5 * rng.normal(size=(G * dg, n))).astype(np.float32),
        B=rng.normal(size=(bsz, G, L, n)).astype(np.float32),
        C=rng.normal(size=(bsz, G, L, n)).astype(np.float32),
        D=rng.normal(size=(G * dg,)).astype(np.float32),
        delta_bias=(0.1 * rng.normal(size=(G * dg,))).astype(np.float32),
    )


@jax.jit
def _jax_vjp(args, gy):
    def scan(u, delta, A, B, C, D, delta_bias):
        return selective_scan_pallas_tm(
            u, delta, A, B, C, D=D, delta_bias=delta_bias,
            delta_softplus=True, chunk=16, interpret=True)

    y, vjp = jax.vjp(scan, *args)
    return y, vjp(gy)


def _jax_cs(inp):
    """The TPU forward kernel's chunk-entry states (save_cs=True), as the
    port lays them out: (B, G, nc, N, dg)."""
    bsz, G, L, dg = inp["u"].shape
    n = inp["A"].shape[1]
    A_t, Dsk, db = _prep_params(jnp.asarray(inp["A"]), jnp.asarray(inp["D"]),
                                jnp.asarray(inp["delta_bias"]), G, dg, n)
    _, cs = _scan_fwd_impl(jnp.asarray(inp["u"]), jnp.asarray(inp["delta"]),
                           A_t, jnp.asarray(inp["B"]), jnp.asarray(inp["C"]),
                           Dsk, db, True, 16, True)
    cs = np.asarray(cs)                             # (B, G, DT, nc, N, dgt)
    return cs.transpose(0, 1, 3, 4, 2, 5).reshape(bsz, G, cs.shape[3], n, dg)


@pytest.mark.parametrize("G", [1, 4])
def test_plain_training_scan_matches_pallas_tm(G):
    """y, cs and all seven gradients at L = 37 (a partial last 16-step
    chunk), dg = 20, N = 16, fp32."""
    rng = np.random.default_rng(G)
    inp = _scan_inputs(rng, 2, G, 37, 20)
    gy = rng.normal(size=inp["u"].shape).astype(np.float32)
    y_jax, want = _jax_vjp(tuple(jnp.asarray(inp[k]) for k in sg.ARG_NAMES),
                           jnp.asarray(gy))
    args = [t(inp[k]) for k in sg.ARG_NAMES]
    y, cs = sg.selective_scan_grouped_states_ref(*args)
    assert cs.shape == (2, G, 3, 16, 20) and cs.dtype == torch.float32
    assert_rel(y, y_jax, SCAN_REL, "y")
    assert_rel(cs, _jax_cs(inp), SCAN_REL, "cs")
    got = sg.selective_scan_grouped_bwd(*args, cs, t(gy))
    for name, g, w in zip(sg.ARG_NAMES, got, want):
        assert g.dtype == torch.float32, name
        assert_rel(g, w, SCAN_REL, "d" + name)


def test_plain_training_scan_bf16_against_jax_fp32():
    """bf16 u/delta/B/C (and cotangent) against JAX fp32 on their widened
    values: y and the four I/O-dtype gradients come back in bf16."""
    rng = np.random.default_rng(5)
    inp = _scan_inputs(rng, 2, 4, 37, 20)
    args = [t(inp[k]) for k in sg.ARG_NAMES]
    for i in (0, 1, 3, 4):
        args[i] = args[i].bfloat16()
    gy = t(rng.normal(size=inp["u"].shape).astype(np.float32)).bfloat16()
    y_jax, want = _jax_vjp(tuple(jnp.asarray(a.float().numpy())
                                 for a in args),
                           jnp.asarray(gy.float().numpy()))
    y, cs = sg.selective_scan_grouped_fwd_states(*args)
    assert y.dtype == torch.bfloat16
    assert_rel(y, y_jax, BF16_REL, "y", step=True)
    got = sg.selective_scan_grouped_bwd(*args, cs, gy)
    for name, g, w, a in zip(sg.ARG_NAMES, got, want, args):
        assert g.dtype == a.dtype, name
        assert_rel(g, w, BF16_REL, "d" + name, step=a.dtype == torch.bfloat16)


def test_autograd_function_on_cpu_runs_the_plain_versions():
    """Under grad, ``selective_scan_grouped`` is the autograd Function: the
    gradients of autograd through the plain forward, no launches counted;
    ``return_last_state`` is refused there and served without grad."""
    inp = _scan_inputs(np.random.default_rng(9), 2, 2, 21, 8)
    leaves = [t(inp[k]).requires_grad_() for k in sg.ARG_NAMES]
    counts = (sg.selective_scan_grouped.launches,
              sg.selective_scan_grouped_fwd_states.launches,
              sg.selective_scan_grouped_bwd.launches)
    y = sg.selective_scan_grouped(*leaves)
    assert y.grad_fn is not None
    gy = t(np.random.default_rng(10).normal(size=y.shape).astype(np.float32))
    got = torch.autograd.grad(y, leaves, gy)
    plain = [a.detach().clone().requires_grad_() for a in leaves]
    want = torch.autograd.grad(sg.selective_scan_grouped_ref(*plain), plain,
                               gy)
    for name, g, w in zip(sg.ARG_NAMES, got, want):
        torch.testing.assert_close(g, w, msg=name)
    assert counts == (sg.selective_scan_grouped.launches,
                      sg.selective_scan_grouped_fwd_states.launches,
                      sg.selective_scan_grouped_bwd.launches)
    with pytest.raises(ValueError, match="no_grad"):
        sg.selective_scan_grouped(*leaves, True, True)
    with torch.no_grad():
        y2, last = sg.selective_scan_grouped(*leaves, True, True)
    torch.testing.assert_close(y2, y.detach())
    assert last.shape == (2, 16, 16)
    with pytest.raises(ValueError, match="gy"):
        sg.selective_scan_grouped_bwd(*leaves, torch.zeros(2, 2, 2, 16, 8),
                                      gy.double())


def test_dispatcher_gradients_match_jax_xla():
    """The public (B, D, L) ``selective_scan`` (grouped B/C, D, z,
    delta_bias, softplus): output and all eight gradients against
    ``jax.grad`` of ``selective_scan(implementation="xla")``."""
    rng = np.random.default_rng(41)
    bsz, G, dg, L, n = 2, 2, 8, 21, 16
    shapes = dict(u=(bsz, G * dg, L), delta=(bsz, G * dg, L),
                  A=(G * dg, n), B=(bsz, G, n, L), C=(bsz, G, n, L),
                  D=(G * dg,), z=(bsz, G * dg, L), delta_bias=(G * dg,))
    arrs = [rng.normal(size=s).astype(np.float32) for s in shapes.values()]
    arrs[1] *= 0.5
    arrs[2] = -np.exp(0.5 * arrs[2])
    w = _objective_weights(shapes["u"], 42)
    args = list(map(jnp.asarray, arrs))
    want_out, want = _jax_value_and_grads(
        lambda *a: j_scan(*a, delta_softplus=True, implementation="xla"),
        args[0], args[1:], w, argnums=tuple(range(8)))
    leaves = [t(a).requires_grad_() for a in arrs]
    out = selective_scan(*leaves, delta_softplus=True)
    (out * t(w)).sum().backward()
    assert_rel(out, want_out, SCAN_REL, "out")
    for name, leaf, g in zip(shapes, leaves, want):
        assert_rel(leaf.grad, g, SCAN_REL, "d" + name)


# --- (b) SS2D and Mamba-UNet with scan_impl="tm" --------------------------

def _jax_value_and_grads(apply, params, args, w, argnums=0):
    """(output, gradients) of sum(apply(params, *args) * w), in one
    compiled program."""
    def loss(*a):
        out = apply(*a)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=argnums, has_aux=True))(params, *args)
    return np.asarray(out), grads


def _jax_and_port_grads(jmodule, init_module, tmodule, x, seed):
    """Output and gradients (of sum(out * w), w seeded) of the JAX module
    and of the port module holding its weights; the port's gradients are
    keyed by parameter name, JAX's converted to the same keys. The weights
    come from ``init_module``, the same module on the JAX package's CPU
    scan route: the parameters do not depend on the route, and its init
    compiles in a fraction of the Pallas interpret mode's time."""
    variables = jax.jit(init_module.init)(jax.random.key(0), jnp.asarray(x))
    tmodule.load_state_dict(params_from_jax(_flat(variables["params"]),
                                            like=tmodule.state_dict()))
    t_out = tmodule.train()(t(x))
    w = _objective_weights(t_out.shape, seed)
    (t_out * t(w)).sum().backward()
    out, grads = _jax_value_and_grads(
        lambda p, xx: jmodule.apply({"params": p}, xx), variables["params"],
        (jnp.asarray(x),), w)
    j_grads = params_from_jax(_flat(grads))
    t_grads = {k: p.grad for k, p in tmodule.named_parameters()}
    return (out, j_grads), (t_out, t_grads)


def test_ss2d_tm_output_and_gradients_match_jax():
    """``SS2D(scan_impl="tm")`` against JAX ``SS2D(scan_impl="tm")`` (the
    Pallas grouped kernel and its VJP): output and every parameter's
    gradient; then the port's bidir branch on the same weights."""
    x = np.random.default_rng(21).normal(size=(2, 5, 6, 16)).astype(
        np.float32)
    tmod = tss2d.SS2D(16, scan_impl="tm")
    (want, j_grads), (got, t_grads) = _jax_and_port_grads(
        JSS2D(d_model=16, scan_impl="tm"), JSS2D(d_model=16), tmod, x,
        seed=22)
    assert_rel(got, want, MODULE_REL, "ss2d out")
    assert set(t_grads) == set(j_grads)
    for k, g in t_grads.items():
        assert_rel(g, j_grads[k], MODULE_REL, k)
    bidir = tss2d.SS2D(16, scan_impl="bidir")
    bidir.load_state_dict(tmod.state_dict())
    out = bidir(t(x))
    (out * t(_objective_weights(out.shape, 22))).sum().backward()
    assert_rel(out, got.detach().numpy(), BRANCH_REL, "bidir out")
    for k, p in bidir.named_parameters():
        assert_rel(p.grad, t_grads[k].numpy(), BRANCH_REL, "bidir " + k)


def test_toy_mamba_unet_tm_logits_and_gradients_match_jax(monkeypatch):
    """The toy Mamba-UNet (32², dims 16/32, depths 1/1: three SS2D, all on
    the tm branch) against JAX ``MambaUnet(scan_impl="tm")``: logits and
    every parameter's gradient, with no bidir scan; then the port's bidir
    branch on the same weights, with no grouped scan."""
    calls = []
    grouped, bidir = tss2d.selective_scan_grouped, tss2d.selective_scan_bidir
    monkeypatch.setattr(tss2d, "selective_scan_grouped",
                        lambda *a: calls.append(1) or grouped(*a))
    monkeypatch.setattr(tss2d, "selective_scan_bidir", None)
    x = np.random.default_rng(23).normal(size=(2, 32, 32, 1)).astype(
        np.float32)
    kw = dict(num_classes=4, depths=(1, 1), dims=(16, 32),
              drop_path_rate=0.0)
    tmodel = TMambaUnet(scan_impl="tm", **kw)
    (want, j_grads), (got, t_grads) = _jax_and_port_grads(
        JMambaUnet(img_size=32, scan_impl="tm", **kw),
        JMambaUnet(img_size=32, **kw), tmodel, x, seed=24)
    assert len(calls) == 3
    assert_rel(got, want, MODULE_REL, "logits")
    assert set(t_grads) == set(j_grads) and len(t_grads) > 30
    for k, g in t_grads.items():
        assert_rel(g, j_grads[k], MODULE_REL, k)

    monkeypatch.setattr(tss2d, "selective_scan_grouped", None)
    monkeypatch.setattr(tss2d, "selective_scan_bidir", bidir)
    other = TMambaUnet(scan_impl="bidir", **kw)
    other.load_state_dict(tmodel.state_dict())
    out = other.train()(t(x))
    (out * t(_objective_weights(out.shape, 24))).sum().backward()
    assert_rel(out, got.detach().numpy(), BRANCH_REL, "bidir logits")
    for k, p in other.named_parameters():
        assert_rel(p.grad, t_grads[k].numpy(), BRANCH_REL, "bidir " + k)


# --- (c) the 1-D Mamba and its block --------------------------------------

@pytest.mark.parametrize("block,bimamba", [(False, "none"), (True, "v2")])
def test_mamba_gradients_match_jax(block, bimamba):
    """Output, input gradient and every parameter's gradient of ``Mamba``
    (unidirectional) and of ``MambaBlock`` around a bimamba-v2 ``Mamba``
    (the scan's autograd Function on CPU tensors, both directions) against
    ``jax.grad`` of the JAX modules."""
    width = 16
    x = np.random.default_rng(31).normal(size=(2, 19, width)).astype(
        np.float32)
    if block:
        jmod = jm.MambaBlock(d_model=width, bimamba_type=bimamba)
        tmod = MambaBlock(width, bimamba_type=bimamba)
    else:
        jmod = jm.Mamba(d_model=width, bimamba_type=bimamba)
        tmod = Mamba(width, bimamba_type=bimamba)
    variables = jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(x))
    tmod.load_state_dict(params_from_jax_lm(_flat(variables["params"])),
                         strict=True)
    w = _objective_weights(x.shape, 32)
    want_out, (g_params, g_x) = _jax_value_and_grads(
        lambda p, xx: jmod.apply({"params": p}, xx), variables["params"],
        (jnp.asarray(x),), w, argnums=(0, 1))
    j_grads = params_from_jax_lm(_flat(g_params))
    xt = t(x).requires_grad_()
    out = tmod(xt)
    (out * t(w)).sum().backward()
    assert_rel(out, want_out, MODULE_REL, "out")
    assert_rel(xt.grad, g_x, MODULE_REL, "dx")
    names = [k for k, _ in tmod.named_parameters()]
    assert set(names) == set(j_grads)
    for k, p in tmod.named_parameters():
        assert_rel(p.grad, j_grads[k].numpy(), MODULE_REL, k)


# --- (d) the train CLI -----------------------------------------------------

def test_train_cli_scan_impl_tm_on_cpu(monkeypatch):
    """``--scan_impl tm`` reaches every SS2D: two iterations on phantom
    slices at 32², through the grouped scan only."""
    calls = []
    real = tss2d.selective_scan_grouped
    monkeypatch.setattr(tss2d, "selective_scan_grouped",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tss2d, "selective_scan_bidir", None)
    assert train_cli.main([
        "--model", "ViM_seg", "--synthetic", "--device", "cpu",
        "--scan_impl", "tm",
        "--patch_size", "32", "32", "--batch_size", "2",
        "--max_iterations", "2", "--eval_every", "100",
        "--synthetic_spec", "1", "2", "1", "0", "32"]) == 0
    assert len(calls) == 2 * 14  # two steps, 14 SS2D per forward


@pytest.mark.parametrize("impl,error,reason", [
    ("hwbc_folded", NotImplementedError, "TPU-only"),
    ("no_such_route", ValueError, "unknown SS2D scan_impl"),
    ("seq_sharded", NotImplementedError, "parallelism item"),
    ("tp_sharded", NotImplementedError, "parallelism item")])
def test_unported_scan_impl_names_its_reason(impl, error, reason):
    """Each refused route of the JAX SS2D says why it is refused: the TPU
    layout, or the parallelism item it waits for; a value the JAX SS2D
    does not know is refused as such."""
    with pytest.raises(error, match=reason):
        tss2d.check_scan_impl(impl)


@pytest.mark.parametrize("impl", tss2d.PORTED_IMPLS)
def test_ported_scan_impl_passes(impl):
    """Every ported route passes the check, the xla route among them (it
    names the tm branch)."""
    assert impl not in tss2d.NOT_PORTED
    assert tss2d.check_scan_impl(impl) is None


@pytest.mark.parametrize("impl", ["hwbc_folded", "seq_sharded"])
def test_train_cli_unported_scan_impl_raises(impl):
    """The model refuses both; the CLI offers neither (its parser refuses
    them before any data is loaded) and offers the ported ``xla``."""
    with pytest.raises(SystemExit):
        train_cli.build_parser().parse_args(["--scan_impl", impl])
    assert train_cli.build_parser().parse_args(
        ["--scan_impl", "xla"]).scan_impl == "xla"
    with pytest.raises(NotImplementedError, match="not ported"):
        TMambaUnet(depths=(1,), dims=(8,), scan_impl=impl)
