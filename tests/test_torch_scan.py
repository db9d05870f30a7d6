"""The PyTorch port's selective scan and cross-scan against the JAX package.

Inputs are drawn with numpy from a seed and fed to both frameworks. The
port's plain bidirectional scan is held against the two TPU kernels it
replaces, run in Pallas interpret mode on the CPU, at the 2e-4 tolerance
the JAX package holds those kernels to (fp32 sums taken in another order).
The CUDA kernel itself runs only on a card: tests/test_torch_kernel.py.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mamba_unet_torch.ops import cross_scan as tcs  # noqa: E402
from mamba_unet_torch.ops.selective_scan import (  # noqa: E402
    selective_scan_ref as t_ref,
)
from mamba_unet_torch.ops.selective_scan_bidir import (  # noqa: E402
    selective_scan_bidir,
    selective_scan_bidir_ref,
)
from mamba_unet_tpu.ops.cross_scan import (  # noqa: E402
    cross_merge_tm as j_cross_merge_tm,
    cross_scan_tm as j_cross_scan_tm,
)
from mamba_unet_tpu.ops import selective_scan_persistent as ssper  # noqa: E402
from mamba_unet_tpu.ops.selective_scan import (  # noqa: E402
    selective_scan_ref as j_ref,
)
from mamba_unet_tpu.ops.selective_scan_pallas import (  # noqa: E402
    _prep_params,
    selective_scan_pallas_bidir,
)

TOL = dict(rtol=2e-4, atol=2e-4)


def _bidir_inputs(rng, bsz, L, dg, n):
    return dict(
        u2=rng.normal(size=(bsz, 2, L, dg)).astype(np.float32),
        delta4=(0.3 * rng.normal(size=(bsz, 4, L, dg))).astype(np.float32),
        A=-np.exp(0.5 * rng.normal(size=(4 * dg, n))).astype(np.float32),
        B4=rng.normal(size=(bsz, 4, L, n)).astype(np.float32),
        C4=rng.normal(size=(bsz, 4, L, n)).astype(np.float32),
        D=rng.normal(size=(4 * dg,)).astype(np.float32),
        delta_bias=(0.1 * rng.normal(size=(4 * dg,))).astype(np.float32),
    )


def _port_bidir(inp):
    args = [torch.from_numpy(inp[k]) for k in
            ("u2", "delta4", "A", "B4", "C4", "D", "delta_bias")]
    return selective_scan_bidir_ref(*args).numpy()


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("softplus,with_d", [(True, True), (False, False)])
def test_selective_scan_ref_matches_jax(rng, grouped, softplus, with_d):
    bsz, dim, L, n = 2, 8, 33, 4
    G = 2 if grouped else 1
    bc_shape = (bsz, G, n, L) if grouped else (bsz, n, L)
    u = rng.normal(size=(bsz, dim, L)).astype(np.float32)
    delta = (0.3 * rng.normal(size=(bsz, dim, L))).astype(np.float32)
    if not softplus:
        delta = np.abs(delta)
    A = -np.exp(rng.normal(size=(dim, n))).astype(np.float32)
    B = rng.normal(size=bc_shape).astype(np.float32)
    C = rng.normal(size=bc_shape).astype(np.float32)
    D = rng.normal(size=(dim,)).astype(np.float32) if with_d else None
    db = (0.1 * rng.normal(size=(dim,))).astype(np.float32) if with_d else None

    def t(x):
        return None if x is None else torch.from_numpy(x)

    def j(x):
        return None if x is None else jnp.asarray(x)

    got = t_ref(t(u), t(delta), t(A), t(B), t(C), D=t(D), delta_bias=t(db),
                delta_softplus=softplus)
    want = j_ref(j(u), j(delta), j(A), j(B), j(C), D=j(D), delta_bias=j(db),
                 delta_softplus=softplus)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("L,dg,Lc", [(64, 8, 16), (96, 16, 32), (40, 8, 8)])
def test_bidir_ref_matches_persistent_kernel(rng, L, dg, Lc):
    """Against ``_bidir_kernel`` (persistent_scan_bidir, interpret mode)."""
    n = 4
    inp = _bidir_inputs(rng, 2, L, dg, n)
    A_t, Dsk, dbk = _prep_params(jnp.asarray(inp["A"]), jnp.asarray(inp["D"]),
                                 jnp.asarray(inp["delta_bias"]), 4, dg, n)
    want = ssper.persistent_scan_bidir(
        jnp.asarray(inp["u2"]), jnp.asarray(inp["delta4"]), A_t,
        jnp.concatenate([jnp.asarray(inp["B4"]), jnp.asarray(inp["C4"])], -1),
        Dsk, dbk, n_real=n, softplus=True, btile=2, Lc=Lc, interpret=True)
    np.testing.assert_allclose(_port_bidir(inp), np.asarray(want), **TOL)


@pytest.mark.parametrize("L,dg", [(64, 8), (96, 16), (50, 8)])
def test_bidir_ref_matches_slab_kernel(rng, L, dg):
    """Against ``_fwd_kernel`` in bidir mode
    (selective_scan_pallas_bidir(merge_pairs=True), interpret mode)."""
    inp = _bidir_inputs(rng, 2, L, dg, 4)
    want = selective_scan_pallas_bidir(
        *(jnp.asarray(inp[k]) for k in ("u2", "delta4", "A", "B4", "C4")),
        D=jnp.asarray(inp["D"]), delta_bias=jnp.asarray(inp["delta_bias"]),
        delta_softplus=True, chunk=16, interpret=True, merge_pairs=True)
    np.testing.assert_allclose(_port_bidir(inp), np.asarray(want), **TOL)


def test_bidir_ref_bf16_inputs_read_as_fp32(rng):
    """bf16 operands are widened exactly: same result as their fp32 values."""
    inp = _bidir_inputs(rng, 1, 24, 8, 16)
    args = [torch.from_numpy(inp[k]) for k in
            ("u2", "delta4", "A", "B4", "C4", "D", "delta_bias")]
    bf = [a.bfloat16() if i in (0, 1, 3, 4) else a for i, a in enumerate(args)]
    widened = [a.float() for a in bf]
    got = selective_scan_bidir_ref(*bf)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, selective_scan_bidir_ref(*widened),
                               rtol=0, atol=0)


def test_wrapper_cpu_runs_plain_version_without_counting(rng):
    inp = _bidir_inputs(rng, 2, 16, 8, 4)
    args = [torch.from_numpy(inp[k]) for k in
            ("u2", "delta4", "A", "B4", "C4", "D", "delta_bias")]
    before = selective_scan_bidir.launches
    got = selective_scan_bidir(*args)
    assert selective_scan_bidir.launches == before
    torch.testing.assert_close(got, selective_scan_bidir_ref(*args))


@pytest.mark.parametrize("bad", ["shape", "dtype", "param_dtype"])
def test_wrapper_rejects_bad_operands(rng, bad):
    inp = _bidir_inputs(rng, 2, 16, 8, 4)
    args = [torch.from_numpy(inp[k]) for k in
            ("u2", "delta4", "A", "B4", "C4", "D", "delta_bias")]
    if bad == "shape":
        args[1] = args[1][:, :, :8]
    elif bad == "dtype":
        args[3] = args[3].bfloat16()
    else:
        args[5] = args[5].double()
    with pytest.raises((ValueError, TypeError)):
        selective_scan_bidir(*args)


def test_cross_scan_tm_and_merge_match_jax(rng):
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    xs = tcs.cross_scan_tm(torch.from_numpy(x))
    np.testing.assert_array_equal(xs.numpy(),
                                  np.asarray(j_cross_scan_tm(jnp.asarray(x))))
    ys = rng.normal(size=(2, 4, 35, 3)).astype(np.float32)
    got = tcs.cross_merge_tm(torch.from_numpy(ys), 5, 7)
    want = j_cross_merge_tm(jnp.asarray(ys), 5, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the bidir pair: merge_row_col(streams) == cross_merge_tm of [y, 0]
    y2 = torch.from_numpy(ys[:, :2])
    np.testing.assert_allclose(
        tcs.merge_row_col(y2, 5, 7).numpy(),
        np.asarray(j_cross_merge_tm(
            jnp.concatenate([ys[:, :2], np.zeros_like(ys[:, 2:])], 1), 5, 7)),
        rtol=1e-6, atol=1e-6)


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil, mamba_unet_torch\n"
        "for m in pkgutil.walk_packages(mamba_unet_torch.__path__, "
        "'mamba_unet_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'mamba_unet_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('mamba_unet_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
