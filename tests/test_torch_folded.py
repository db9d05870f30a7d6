"""The port's batch-folded scan route against JAX: the folded scan's plain
versions (forward, chunk-entry states, backward), SS2D and Mamba-UNet with
``scan_impl="folded"``, and ``--scan_impl folded`` in the train CLI.

Inputs are drawn with numpy from a seed and fed to both frameworks; JAX
weights are carried into the port by ``params_from_jax``. The JAX side runs
its Pallas kernels in interpret mode on the CPU. Tolerances, each relative
to the largest magnitude of the output it bounds:

* the plain folded scan (y, the chunk-entry states and all seven
  gradients) against ``selective_scan_folded_bidir`` /
  ``selective_scan_folded`` and their VJPs: 1e-5 (the same fp32
  recurrence, sums in another order); bf16 operands against JAX fp32 on
  their widened values: 2e-4 plus one bf16 rounding step of each value
  where the result is bf16 (both round an fp32 sum to bf16 once);
* SS2D and the toy Mamba-UNet, outputs and every parameter's gradient:
  1e-4 (fp32 matmuls, convolutions and the scan in another order); the
  port's folded branch against its bidir branch on the same weights: 1e-4
  (the folded branch's dt comes from one collapsed matrix, a different
  rounding).

The CUDA kernels themselves run only on a card: tests/test_torch_kernel.py
and chip_smoke.py.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.cli import train as train_cli  # noqa: E402
from mamba_unet_torch.models.vssm import MambaUnet as TMambaUnet  # noqa: E402
from mamba_unet_torch.nn import ss2d as tss2d  # noqa: E402
from mamba_unet_torch.ops import selective_scan_folded as sf  # noqa: E402
from mamba_unet_torch.ops.selective_scan import (  # noqa: E402
    selective_scan_ref,
)
from mamba_unet_torch.utils.compare import BF16_STEP  # noqa: E402
from mamba_unet_torch.utils.convert import params_from_jax  # noqa: E402
from mamba_unet_tpu.models.vssm import MambaUnet as JMambaUnet  # noqa: E402
from mamba_unet_tpu.nn.ss2d import SS2D as JSS2D  # noqa: E402
from mamba_unet_tpu.ops import selective_scan_folded as jsf  # noqa: E402

SCAN_REL, MODULE_REL, BF16_REL = 1e-5, 1e-4, 2e-4


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


def _objective_weights(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# --- (a)-(d) the folded scan's plain versions ------------------------------

BSZ, L, DG, N = 4, 40, 32, 16  # 128 lanes; L ragged against 16 and 32


def _scan_inputs(rng, bidir, G=4):
    streams = 2 if bidir else G
    BD = BSZ * DG
    return dict(
        u=rng.normal(size=(streams, L, BD)).astype(np.float32),
        delta=(0.5 * rng.normal(size=(G, L, BD))).astype(np.float32),
        A=-np.exp(0.5 * rng.normal(size=(G * DG, N))).astype(np.float32),
        B=rng.normal(size=(G, L, N, BSZ)).astype(np.float32),
        C=rng.normal(size=(G, L, N, BSZ)).astype(np.float32),
        D=rng.normal(size=(G * DG,)).astype(np.float32),
        delta_bias=(0.1 * rng.normal(size=(G * DG,))).astype(np.float32),
    )


def _jax_vjp(bidir):
    """The JAX entry and its VJP, jitted, Pallas in interpret mode."""
    entry = jsf.selective_scan_folded_bidir if bidir else \
        jsf.selective_scan_folded

    @jax.jit
    def run(args, gy):
        def scan(u, delta, A, B, C, D, delta_bias):
            return entry(u, delta, A, B, C, D=D, delta_bias=delta_bias,
                         delta_softplus=True, interpret=True)

        y, vjp = jax.vjp(scan, *args)
        return y, vjp(gy)

    return run


def _jax_cs(inp, bidir):
    """The TPU forward kernel's chunk-entry states (chunk 32, in scan order)
    as (G, ncJ, N, B * dg)."""
    G, _, BD = inp["delta"].shape
    A_f, Dsk, db = jsf._prep_params_folded(
        jnp.asarray(inp["A"]), jnp.asarray(inp["D"]),
        jnp.asarray(inp["delta_bias"]), G, DG, N, BSZ)
    _, cs = jsf._scan_fwd_folded(
        jnp.asarray(inp["u"]), jnp.asarray(inp["delta"]), A_f,
        jnp.asarray(inp["B"]), jnp.asarray(inp["C"]), Dsk, db, True, 128,
        True, DG, bidir=bidir)
    cs = np.asarray(cs)                            # (G, nLT, ncJ, N, LT)
    return cs.transpose(0, 2, 3, 1, 4).reshape(G, cs.shape[2], N, BD)


@pytest.mark.parametrize("bidir", [True, False])
def test_plain_folded_scan_matches_jax(bidir):
    """(a) ``selective_scan_folded_bidir`` and (b) the unidirectional
    ``selective_scan_folded`` (G = 2): y and all seven gradients of the
    plain versions, and of the public entry's autograd Function on CPU
    tensors (no launch counted), against JAX's entry and its VJP."""
    rng = np.random.default_rng(1 if bidir else 2)
    inp = _scan_inputs(rng, bidir, G=4 if bidir else 2)
    gy = rng.normal(size=inp["delta"].shape).astype(np.float32)
    y_jax, want = _jax_vjp(bidir)(
        tuple(jnp.asarray(inp[k]) for k in sf.ARG_NAMES), jnp.asarray(gy))
    args = [t(inp[k]) for k in sf.ARG_NAMES]
    y, cs = sf.selective_scan_folded_states_ref(*args, bidir=bidir)
    assert_rel(y, y_jax, SCAN_REL, "y")
    got = sf.selective_scan_folded_bwd(*args, cs, t(gy), bidir=bidir)
    for name, g, w in zip(sf.ARG_NAMES, got, want):
        assert g.dtype == torch.float32, name
        assert_rel(g, w, SCAN_REL, "d" + name)

    counts = [k.launches for k in (sf.selective_scan_folded_fwd,
                                   sf.selective_scan_folded_fwd_states,
                                   sf.selective_scan_folded_bwd)]
    leaves = [a.clone().requires_grad_() for a in args]
    entry = sf.selective_scan_folded_bidir if bidir else \
        sf.selective_scan_folded
    out = entry(*leaves)
    assert out.grad_fn is not None
    assert_rel(out, y_jax, SCAN_REL, "entry y")
    for name, g, w in zip(sf.ARG_NAMES,
                          torch.autograd.grad(out, leaves, t(gy)), want):
        assert_rel(g, w, SCAN_REL, "entry d" + name)
    with torch.no_grad():
        assert_rel(entry(*leaves), y_jax, SCAN_REL, "serving y")
    assert counts == [k.launches for k in (
        sf.selective_scan_folded_fwd, sf.selective_scan_folded_fwd_states,
        sf.selective_scan_folded_bwd)]


def test_plain_folded_states_match_sequential_and_jax_states():
    """(c) cs[g, c] is the state entering data chunk c in direction g's
    scan order: held against every state of the port's sequential loop on
    each direction's scan-ordered sequence, and every second one against
    JAX's ``cs`` (chunk 32)."""
    inp = _scan_inputs(np.random.default_rng(3), True)
    _, cs = sf.selective_scan_folded_states_ref(
        *(t(inp[k]) for k in sf.ARG_NAMES))
    nc = -(-L // 16)
    assert cs.shape == (4, nc, N, BSZ * DG) and cs.dtype == torch.float32
    for g in range(4):
        rev = g >= 2
        order = slice(None, None, -1) if rev else slice(None)

        def seq(a, width):  # (L, B * width) -> (B, width, L) in scan order
            return t(a[order]).reshape(L, BSZ, width).permute(1, 2, 0)

        rows = slice(g * DG, (g + 1) * DG)
        _, states = selective_scan_ref(
            seq(inp["u"][g % 2], DG), seq(inp["delta"][g], DG),
            t(inp["A"][rows]), t(inp["B"][g][order]).permute(2, 1, 0),
            t(inp["C"][g][order]).permute(2, 1, 0), t(inp["D"][rows]),
            delta_bias=t(inp["delta_bias"][rows]), delta_softplus=True,
            state_chunk=1)                          # (B, L, dg, N)
        for c in range(nc):
            p = max(L - 16 * c - 16, 0) if rev else 16 * c
            want = states[:, p].permute(2, 0, 1).reshape(N, BSZ * DG)
            assert_rel(cs[g, c], want.numpy(), SCAN_REL, f"cs[{g}, {c}]")
    cs_jax = _jax_cs(inp, True)
    ncj = cs_jax.shape[1]
    for g in range(4):
        for k in range(ncj):
            # JAX's scan chunk k: data chunk ncj-1-k of 32 going backwards,
            # entered after the data steps from 32 * (ncj - k) on
            c = 2 * (ncj - k) - 1 if g >= 2 else 2 * k
            got = cs[g, c] if c < nc else torch.zeros(N, BSZ * DG)
            assert_rel(got, cs_jax[g, k], SCAN_REL, f"JAX cs[{g}, {k}]")


def test_plain_folded_scan_bf16_against_jax_fp32():
    """(d) bf16 u/delta/B/C (and cotangent) against JAX fp32 on their
    widened values: y and the four I/O-dtype gradients come back in bf16,
    du summed over each pair of directions in fp32 and rounded once."""
    rng = np.random.default_rng(5)
    inp = _scan_inputs(rng, True)
    args = [t(inp[k]) for k in sf.ARG_NAMES]
    for i in (0, 1, 3, 4):
        args[i] = args[i].bfloat16()
    gy = t(rng.normal(size=inp["delta"].shape).astype(np.float32)).bfloat16()
    y_jax, want = _jax_vjp(True)(
        tuple(jnp.asarray(a.float().numpy()) for a in args),
        jnp.asarray(gy.float().numpy()))
    y, cs = sf.selective_scan_folded_fwd_states(*args)
    assert y.dtype == torch.bfloat16
    assert_rel(y, y_jax, BF16_REL, "y", step=True)
    got = sf.selective_scan_folded_bwd(*args, cs, gy)
    for name, g, w, a in zip(sf.ARG_NAMES, got, want, args):
        assert g.dtype == a.dtype, name
        assert_rel(g, w, BF16_REL, "d" + name, step=a.dtype == torch.bfloat16)


# --- (e)-(f) SS2D and Mamba-UNet with scan_impl="folded" -----------------

def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _jax_and_port_grads(jmodule, init_module, tmodule, x, seed):
    """Output and gradients (of sum(out * w), w seeded) of the JAX module
    and of the port module holding its weights, keyed by the port's
    parameter names. The weights come from ``init_module``, the same module
    on the JAX package's default route (the parameters do not depend on
    the route)."""
    variables = jax.jit(init_module.init)(jax.random.key(0), jnp.asarray(x))
    tmodule.load_state_dict(params_from_jax(_flat(variables["params"]),
                                            like=tmodule.state_dict()))
    t_out = tmodule.train()(t(x))
    w = _objective_weights(t_out.shape, seed)
    (t_out * t(w)).sum().backward()

    def loss(p, xx):
        out = jmodule.apply({"params": p}, xx)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], jnp.asarray(x))
    t_grads = {k: p.grad for k, p in tmodule.named_parameters()}
    return (np.asarray(out), params_from_jax(_flat(grads))), (t_out, t_grads)


@pytest.mark.parametrize("bsz", [8, 3])
def test_ss2d_folded_output_and_gradients_match_jax(bsz, monkeypatch):
    """(e) ``SS2D(scan_impl="folded")`` against JAX's: output and every
    parameter's gradient. At batch 8, B * d_inner = 384 lanes and JAX runs
    its folded kernel; at batch 3 (144 lanes, not a multiple of 128) JAX
    warns and takes its XLA route, while the port still runs the folded
    scan."""
    x = np.random.default_rng(21).normal(size=(bsz, 5, 6, 24)).astype(
        np.float32)
    calls = []
    real = tss2d.selective_scan_folded_bidir
    monkeypatch.setattr(tss2d, "selective_scan_folded_bidir",
                        lambda *a: calls.append(1) or real(*a))
    jax_route = (pytest.warns(UserWarning, match="not 128-aligned")
                 if bsz * 48 % 128 else contextlib.nullcontext())
    with jax_route:
        (want, j_grads), (got, t_grads) = _jax_and_port_grads(
            JSS2D(d_model=24, scan_impl="folded"), JSS2D(d_model=24),
            tss2d.SS2D(24, scan_impl="folded"), x, seed=22)
    assert len(calls) == 1
    assert_rel(got, want, MODULE_REL, "ss2d out")
    assert set(t_grads) == set(j_grads)
    for k, g in t_grads.items():
        assert_rel(g, j_grads[k], MODULE_REL, k)


def test_toy_mamba_unet_folded_logits_and_gradients_match_jax(monkeypatch):
    """(f) The toy Mamba-UNet (32², dims 8/16, depths 1/1, batch 8: three
    SS2D of 128, 256 and 128 lanes, all folded in JAX too) against JAX
    ``MambaUnet(scan_impl="folded")``: logits and every parameter's
    gradient, with no bidir or grouped scan; then the port's bidir branch on
    the same weights."""
    calls = []
    real, bidir = tss2d.selective_scan_folded_bidir, tss2d.selective_scan_bidir
    monkeypatch.setattr(tss2d, "selective_scan_folded_bidir",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tss2d, "selective_scan_bidir", None)
    monkeypatch.setattr(tss2d, "selective_scan_grouped", None)
    x = np.random.default_rng(23).normal(size=(8, 32, 32, 1)).astype(
        np.float32)
    kw = dict(num_classes=4, depths=(1, 1), dims=(8, 16),
              drop_path_rate=0.0)
    tmodel = TMambaUnet(scan_impl="folded", **kw)
    (want, j_grads), (got, t_grads) = _jax_and_port_grads(
        JMambaUnet(img_size=32, scan_impl="folded", **kw),
        JMambaUnet(img_size=32, **kw), tmodel, x, seed=24)
    assert len(calls) == 3
    assert_rel(got, want, MODULE_REL, "logits")
    assert set(t_grads) == set(j_grads) and len(t_grads) > 30
    for k, g in t_grads.items():
        assert_rel(g, j_grads[k], MODULE_REL, k)

    monkeypatch.setattr(tss2d, "selective_scan_bidir", bidir)
    other = TMambaUnet(scan_impl="bidir", **kw)
    other.load_state_dict(tmodel.state_dict())
    with torch.no_grad():
        assert_rel(other.train()(t(x)), got.detach().numpy(), MODULE_REL,
                   "bidir logits")


# --- (g) the train CLI -----------------------------------------------------

def test_train_cli_scan_impl_folded_on_cpu(monkeypatch):
    """``--scan_impl folded`` reaches every SS2D: two iterations on phantom
    slices at 32², through the folded scan only."""
    calls = []
    real = tss2d.selective_scan_folded_bidir
    monkeypatch.setattr(tss2d, "selective_scan_folded_bidir",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tss2d, "selective_scan_bidir", None)
    monkeypatch.setattr(tss2d, "selective_scan_grouped", None)
    assert train_cli.main([
        "--model", "ViM_seg", "--synthetic", "--device", "cpu",
        "--scan_impl", "folded",
        "--patch_size", "32", "32", "--batch_size", "2",
        "--max_iterations", "2", "--eval_every", "100",
        "--synthetic_spec", "1", "2", "1", "0", "32"]) == 0
    assert len(calls) == 2 * 14  # two steps, 14 SS2D per forward
