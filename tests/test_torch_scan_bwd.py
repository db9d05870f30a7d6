"""The port's training scan (state-saving forward + backward) against JAX.

Inputs are drawn with numpy from a seed and fed to both frameworks. The
port's plain backward is held against the gradients of
``selective_scan_pallas_bidir(merge_pairs=True)``, whose VJP is the TPU
backward kernel ``_bwd_kernel`` (Pallas interpret mode on the CPU), at the
2e-4 the JAX package holds its kernels to (fp32 sums in another order). Its
chunk-entry states are held against the TPU forward kernel's ``cs`` output
and against the sequential reference's state at each chunk entry. The CUDA
kernels themselves run only on a card: tests/test_torch_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mamba_unet_torch.ops.selective_scan_bidir import (  # noqa: E402
    ARG_NAMES,
    STATE_CHUNK,
    selective_scan_bidir,
    selective_scan_bidir_bwd,
    selective_scan_bidir_bwd_ref,
    selective_scan_bidir_fwd_states,
    selective_scan_bidir_ref,
    selective_scan_bidir_states_ref,
)
from mamba_unet_tpu.ops.selective_scan import (  # noqa: E402
    selective_scan_ref as j_ref,
)
from mamba_unet_tpu.ops.selective_scan_pallas import (  # noqa: E402
    _prep_params,
    _scan_fwd_impl,
    selective_scan_pallas_bidir,
)

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on a few cores, and torch's default of one thread per core
    oversubscribed them (a 3 s test took minutes under that load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(rng, bsz, L, dg, n):
    return dict(
        u2=rng.normal(size=(bsz, 2, L, dg)).astype(np.float32),
        delta4=(0.3 * rng.normal(size=(bsz, 4, L, dg))).astype(np.float32),
        A=-np.exp(0.5 * rng.normal(size=(4 * dg, n))).astype(np.float32),
        B4=rng.normal(size=(bsz, 4, L, n)).astype(np.float32),
        C4=rng.normal(size=(bsz, 4, L, n)).astype(np.float32),
        D=rng.normal(size=(4 * dg,)).astype(np.float32),
        delta_bias=(0.1 * rng.normal(size=(4 * dg,))).astype(np.float32),
    )


@jax.jit
def _jax_vjp(args, gy):
    def scan(u2, delta4, A, B4, C4, D, delta_bias):
        return selective_scan_pallas_bidir(
            u2, delta4, A, B4, C4, D=D, delta_bias=delta_bias,
            delta_softplus=True, chunk=16, interpret=True, merge_pairs=True)

    y, vjp = jax.vjp(scan, *args)
    return y, vjp(gy)


def _jax_grads(inp, gy):
    y, grads = _jax_vjp(tuple(jnp.asarray(inp[k]) for k in ARG_NAMES),
                        jnp.asarray(gy))
    return np.asarray(y), [np.asarray(g) for g in grads]


def _port(inp, dtype=torch.float32):
    args = [torch.from_numpy(inp[k]) for k in ARG_NAMES]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(dtype)
    return args


@pytest.mark.parametrize("L,n", [(33, 4), (40, 16)])
def test_plain_backward_matches_pallas_bwd_kernel(rng, L, n):
    """All seven gradients; L ragged against the 16-step chunk."""
    inp = _inputs(rng, 2, L, 8, n)
    gy = rng.normal(size=(2, 2, L, 8)).astype(np.float32)
    y_jax, want = _jax_grads(inp, gy)
    args = _port(inp)
    np.testing.assert_allclose(selective_scan_bidir_ref(*args).numpy(),
                               y_jax, **TOL)
    got = selective_scan_bidir_bwd_ref(*args, torch.from_numpy(gy))
    for name, g, w in zip(ARG_NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


def test_plain_backward_bf16_inputs_against_jax_fp32(rng):
    """bf16 operands (read exactly as their fp32 values) against JAX fp32 on
    those values: the gradients of u2/delta4/B4/C4 come back in bf16, so
    each may differ by one bf16 rounding step (at most 2^-7 of its value)
    beyond 2e-4 of the largest; dA/dD/ddelta_bias stay fp32 at 2e-4."""
    inp = _inputs(rng, 2, 40, 8, 16)
    args = _port(inp, torch.bfloat16)
    widened = {k: a.float().numpy() for k, a in zip(ARG_NAMES, args)}
    gy = rng.normal(size=(2, 2, 40, 8)).astype(np.float32)
    _, want = _jax_grads(widened, gy)
    got = selective_scan_bidir_bwd_ref(*args, torch.from_numpy(gy))
    for name, g, w, a in zip(ARG_NAMES, got, want, args):
        assert g.dtype == a.dtype, name
        err = np.abs(g.float().numpy() - w)
        bound = 2e-4 * np.abs(w).max() + 2e-4
        if a.dtype == torch.bfloat16:
            bound = bound + 2.0 ** -7 * np.abs(w)
        assert (err <= bound).all(), (name, err.max())


@pytest.mark.parametrize("L", [48, 40])
def test_chunk_entry_states_match_pallas_fwd_kernel(rng, L):
    """cs against ``_fwd_kernel``'s ``cs`` output (fp32 I/O, 16-step
    chunks): both fix the chunks in data time and index them in each
    direction's scan order, so they agree for L a multiple of 16 and for a
    ragged L (JAX pads the data's end, which a reversed direction scans
    first, from a zero state)."""
    dg, n = 8, 4
    inp = _inputs(rng, 2, L, dg, n)
    A_t, Dsk, db = _prep_params(jnp.asarray(inp["A"]), jnp.asarray(inp["D"]),
                                jnp.asarray(inp["delta_bias"]), 4, dg, n)
    _, cs_jax = _scan_fwd_impl(
        jnp.asarray(inp["u2"]), jnp.asarray(inp["delta4"]), A_t,
        jnp.asarray(inp["B4"]), jnp.asarray(inp["C4"]), Dsk, db, True, 16,
        True, bidir=True)
    cs_jax = np.asarray(cs_jax)                      # (B, 4, DT, nc, N, dgt)
    nc = -(-L // 16)
    assert cs_jax.shape[2] == 1 and cs_jax.shape[3] == nc
    _, cs = selective_scan_bidir_states_ref(*_port(inp))
    assert cs.shape == (2, 4, -(-L // STATE_CHUNK), dg, n)
    np.testing.assert_allclose(cs.numpy(), cs_jax[:, :, 0].swapaxes(-1, -2),
                               **TOL)


def test_chunk_entry_states_match_sequential_reference(rng):
    """cs[:, g, c] is the state with which direction g enters its c-th
    16-step data chunk: after its first c*16 scan steps for g < 2, after its
    first L - 16*(nc - c) for the reversed directions (which scan the
    flipped data and enter each data chunk at its last step); L ragged."""
    L, dg, n, bsz = 37, 8, 4, 2
    inp = _inputs(rng, bsz, L, dg, n)
    y, cs = selective_scan_bidir_states_ref(*_port(inp))
    np.testing.assert_allclose(
        y.numpy(), selective_scan_bidir_ref(*_port(inp)).numpy(), **TOL)
    for g in range(4):
        m, rev = g % 2, g >= 2
        u = inp["u2"][:, m]
        d, B, C = (inp[k][:, g] for k in ("delta4", "B4", "C4"))
        if rev:
            u, d, B, C = (x[:, ::-1] for x in (u, d, B, C))
        rows = slice(g * dg, (g + 1) * dg)
        np.testing.assert_array_equal(cs[:, g, 0].numpy(), 0.0)
        nc = cs.shape[2]
        for c in range(1, nc):
            k = c * STATE_CHUNK if g < 2 else L - (nc - c) * STATE_CHUNK
            _, last = j_ref(
                *(jnp.asarray(np.ascontiguousarray(x[:, :k].swapaxes(1, 2)))
                  for x in (u, d)),
                jnp.asarray(inp["A"][rows]),
                *(jnp.asarray(np.ascontiguousarray(x[:, :k].swapaxes(1, 2)))
                  for x in (B, C)),
                delta_bias=jnp.asarray(inp["delta_bias"][rows]),
                delta_softplus=True, return_last_state=True)
            np.testing.assert_allclose(cs[:, g, c].numpy(), np.asarray(last),
                                       err_msg=f"g={g} c={c}", **TOL)


def test_autograd_function_on_cpu_runs_the_plain_versions(rng):
    """The training path of ``selective_scan_bidir`` on CPU tensors: plain
    state-saving forward, plain backward, no launches counted, and the
    gradients of autograd through the plain forward."""
    inp = _inputs(rng, 2, 21, 8, 4)
    leaves = [t.requires_grad_() for t in _port(inp)]
    counts = (selective_scan_bidir.launches,
              selective_scan_bidir_fwd_states.launches,
              selective_scan_bidir_bwd.launches)
    out = selective_scan_bidir(*leaves)
    gy = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    got = torch.autograd.grad(out, leaves, gy)
    assert counts == (selective_scan_bidir.launches,
                      selective_scan_bidir_fwd_states.launches,
                      selective_scan_bidir_bwd.launches)
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    want = torch.autograd.grad(selective_scan_bidir_ref(*plain), plain, gy)
    torch.testing.assert_close(out, selective_scan_bidir_ref(*plain))
    for name, g, w in zip(ARG_NAMES, got, want):
        torch.testing.assert_close(g, w, msg=name)
    with torch.no_grad():  # no grad: the serving path, no saved states
        torch.testing.assert_close(selective_scan_bidir(*leaves), out)


@pytest.mark.parametrize("bad", ["cs_shape", "gy_dtype"])
def test_backward_wrapper_rejects_bad_operands(rng, bad):
    inp = _inputs(rng, 1, 20, 8, 4)
    args = _port(inp)
    _, cs = selective_scan_bidir_states_ref(*args)
    gy = torch.zeros(1, 2, 20, 8)
    if bad == "cs_shape":
        cs = cs[:, :, :1]
    else:
        gy = gy.double()
    with pytest.raises(ValueError):
        selective_scan_bidir_bwd(*args, cs, gy)


@pytest.mark.parametrize("case", ["fp32_within", "fp32_over", "bf16_step",
                                  "bf16_over", "nan", "dtype"])
def test_kernel_comparison_rule(case):
    """``assert_close_to_max``, the rule the card tests and chip_smoke.py
    hold the training kernels to: rel * max|want|, plus one bf16 rounding
    step of each value where the output is bf16."""
    from mamba_unet_torch.utils.compare import BF16_STEP, assert_close_to_max

    want = torch.tensor([8.0, -2.0, 0.5])
    got = want.clone()
    ok = case in ("fp32_within", "bf16_step")
    if case == "fp32_within":
        got[1] += 0.9e-4 * 8.0
    elif case == "fp32_over":
        got[1] += 1.1e-4 * 8.0
    elif case == "bf16_step":
        want, got = want.bfloat16(), (want + BF16_STEP * want).bfloat16()
    elif case == "bf16_over":
        want, got = want.bfloat16(), (want + 4 * BF16_STEP * want).bfloat16()
    elif case == "nan":
        got[2] = float("nan")
    else:
        got = got.double()
    if ok:
        err = assert_close_to_max(got, want, 1e-4, case)
        assert err == (got.float() - want.float()).abs().max().item()
    else:
        with pytest.raises(AssertionError, match=case):
            assert_close_to_max(got, want, 1e-4, case)
