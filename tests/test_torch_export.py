"""The port's serving artifact: the scan kernels' custom ops and the
``torch.export`` round trip, against the JAX package.

* Each of the nine kernel entry points is a ``torch.library.custom_op``
  (``torch.ops.mamba_unet.*``); ``torch.library.opcheck`` holds each one's
  schema, fake (shape-only) implementation and CPU implementation together
  at a toy shape.
* ``export_predict`` -> ``save_exported`` -> ``load_exported`` of a toy
  Mamba-UNet with a symbolic batch, served at batches 2 and 5, against
  JAX's ``make_predict_fn`` on the same weights: fp32 at 5e-4, the bound
  the toy-model parity test holds (``tests/test_torch_model.py``); bf16
  serving against JAX fp32 at 5e-2 of the logits' largest magnitude (bf16
  rounds every matmul and convolution input to 8 mantissa bits through
  three blocks; the JAX bf16 path keeps bf16 scan states, so it is no fp32
  reference).
* ``cli.export --device cpu`` on a toy snapshot writes an artifact that
  reloads and serves.

The CUDA kernels themselves run only on a card: tests/test_torch_kernel.py
and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mamba_unet_torch.cli import export as export_cli  # noqa: E402
from mamba_unet_torch.models import vssm as tvssm  # noqa: E402
from mamba_unet_torch.ops import selective_scan_bidir as sb  # noqa: E402
from mamba_unet_torch.ops import selective_scan_folded as sf  # noqa: E402
from mamba_unet_torch.ops import selective_scan_grouped as sg  # noqa: E402
from mamba_unet_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from mamba_unet_torch.utils.export import (  # noqa: E402
    export_predict,
    load_exported,
    make_predict_fn,
    save_exported,
)
from mamba_unet_tpu.models.vssm import MambaUnet as JMambaUnet  # noqa: E402
from mamba_unet_tpu.utils import convert as jconvert  # noqa: E402
from mamba_unet_tpu.utils import export as jexport  # noqa: E402

FP32_TOL, BF16_REL = 5e-4, 5e-2
TOY = dict(num_classes=4, depths=(1, 1), dims=(16, 32))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on a few cores, and torch's default of one thread per core
    oversubscribed them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _operands(kind, bsz=2, L=7, dg=4, n=16, seed=0):
    """Toy operands of the ``kind`` scan (bidir, grouped, folded, folded
    unidirectional), at the magnitudes of the initialized model."""
    g = torch.Generator().manual_seed(seed)
    G = 4
    S = 2 if kind in ("bidir", "folded") else G

    def r(*shape):
        return torch.randn(*shape, generator=g)

    params = [-torch.exp(0.5 * r(G * dg, n)), r(G * dg), 0.1 * r(G * dg)]
    if kind in ("bidir", "grouped"):
        u, delta = r(bsz, S, L, dg), 0.5 * r(bsz, G, L, dg)
        B, C = r(bsz, G, L, n), r(bsz, G, L, n)
    else:
        u, delta = r(S, L, bsz * dg), 0.5 * r(G, L, bsz * dg)
        B, C = r(G, L, n, bsz), r(G, L, n, bsz)
    return [u, delta, params[0], B, C, *params[1:]]


def _op_cases():
    """(op, its arguments) for the nine custom ops, and the grouped ones
    also with their optional incoming state, last state and its
    cotangent (``*_carry``)."""
    cases = {}
    args = _operands("bidir")
    y, cs = sb.selective_scan_bidir_fwd_states(*args)
    cases["bidir_serve"] = (sb._serve_op, args)
    cases["bidir_fwd_states"] = (sb._fwd_states_op, args)
    cases["bidir_bwd"] = (sb._bwd_op, (*args, cs, torch.randn(y.shape)))
    args = _operands("grouped")
    y, cs = sg.selective_scan_grouped_fwd_states(*args)
    cases["grouped_serve"] = (sg._serve_op, (*args, True, True))
    cases["grouped_fwd_states"] = (sg._fwd_states_op, (*args, True))
    cases["grouped_bwd"] = (sg._bwd_op, (*args, cs, torch.randn(y.shape),
                                         True))
    x0, g_last = (torch.randn(y.shape[0], args[2].shape[0], 16)
                  for _ in range(2))
    _, cs0 = sg.selective_scan_grouped_fwd_states(*args, True, x0)
    cases["grouped_serve_carry"] = (sg._serve_op, (*args, True, True, x0))
    cases["grouped_fwd_states_carry"] = (sg._fwd_states_op,
                                         (*args, True, x0, True))
    cases["grouped_bwd_carry"] = (sg._bwd_op, (*args, cs0,
                                               torch.randn(y.shape), True,
                                               x0, g_last))
    args = _operands("folded")
    y, cs = sf.selective_scan_folded_fwd_states(*args)
    cases["folded_serve"] = (sf._serve_op, (*args, True, True))
    cases["folded_fwd_states"] = (sf._fwd_states_op, (*args, True, True))
    args_u = _operands("folded_uni")
    y_u, cs_u = sf.selective_scan_folded_fwd_states(*args_u, bidir=False)
    cases["folded_bwd"] = (sf._bwd_op, (*args_u, cs_u, torch.randn(y_u.shape),
                                        True, False))
    return cases


OP_NAMES = ("bidir_serve", "bidir_fwd_states", "bidir_bwd", "grouped_serve",
            "grouped_fwd_states", "grouped_bwd", "folded_serve",
            "folded_fwd_states", "folded_bwd", "grouped_serve_carry",
            "grouped_fwd_states_carry", "grouped_bwd_carry")


@pytest.fixture(scope="module")
def op_cases():
    return _op_cases()


@pytest.mark.parametrize("name", OP_NAMES)
def test_custom_op_passes_opcheck(op_cases, name):
    """Schema, fake implementation and CPU implementation agree, and the
    op is reachable under ``torch.ops.mamba_unet``."""
    op, args = op_cases[name]
    torch.library.opcheck(op, args)
    namespace, opname = op._qualname.split("::")
    assert namespace == "mamba_unet"
    assert getattr(torch.ops.mamba_unet, opname) is not None


@pytest.fixture(scope="module")
def toy():
    """The toy JAX Mamba-UNet, its fp32 logits at batch 5 (JAX's
    ``make_predict_fn``; a sample's logits do not depend on the batch, so
    batch 2 is the first two), and the port model holding its weights.
    JAX's weights are the seeded port model's, through JAX's own converter
    of torch checkpoints (``convert_vssm``, every parameter loaded), which
    needs the parameter shapes only: no compiled ``init``."""
    x = np.random.default_rng(7).normal(size=(5, 32, 32, 1)).astype(
        np.float32)
    jmodel = JMambaUnet(img_size=32, scan_impl="bidir", **TOY)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 1)))["params"]["vssm"]
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    tmodel = tvssm.MambaUnet(generator=torch.Generator().manual_seed(0),
                             **TOY)
    params, report = jconvert.convert_vssm(
        {k: v.numpy() for k, v in tmodel.mamba_unet.state_dict().items()},
        template)
    assert not report["missing"] and not report["shape_skipped"]
    want = np.asarray(jax.jit(jexport.make_predict_fn(
        jmodel, {"params": {"vssm": params}}))(jnp.asarray(x)))
    return x, want, tmodel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_round_trip_matches_jax(toy, tmp_path, dtype):
    """One artifact with a symbolic batch serves batches 2 and 5: fp32
    against JAX's predict function and the eager one exactly, bf16 against
    JAX fp32 at bf16 tolerance."""
    x, want, tmodel = toy
    dt = None if dtype == "float32" else torch.bfloat16
    path = save_exported(export_predict(tmodel, (32, 32), dtype=dt),
                         str(tmp_path / "toy.pt2"))
    served = load_exported(path).module()
    eager = make_predict_fn(tmodel, dt)
    for bsz in (2, 5):
        got = served(torch.from_numpy(x[:bsz]))
        assert got.dtype == torch.float32 and got.shape == (bsz, 32, 32, 4)
        torch.testing.assert_close(got, eager(torch.from_numpy(x[:bsz])),
                                   rtol=0, atol=0)
        if dt is None:
            np.testing.assert_allclose(got.numpy(), want[:bsz],
                                       rtol=FP32_TOL, atol=FP32_TOL)
        else:
            err = np.abs(got.numpy() - want[:bsz]).max()
            assert err <= BF16_REL * np.abs(want).max(), err


def test_export_cli_on_cpu_writes_a_reloadable_artifact(tmp_path,
                                                        monkeypatch):
    """``cli.export --device cpu`` on a toy snapshot directory: the
    artifact exists, reloads and serves the snapshot's logits."""
    monkeypatch.setattr(tvssm, "MambaUnet",
                        functools.partial(tvssm.MambaUnet, depths=(1, 1),
                                          dims=(16, 32)))
    model = tvssm.MambaUnet(generator=torch.Generator().manual_seed(4))
    save_checkpoint(str(tmp_path / "snap"), 3, model.state_dict(), "best")
    out = tmp_path / "vim.pt2"
    assert export_cli.main(["--checkpoint", str(tmp_path / "snap"),
                            "--patch_size", "32", "32", "--device", "cpu",
                            "--batch", "3", "--out", str(out)]) == 0
    x = torch.randn(3, 32, 32, 1)
    got = load_exported(str(out)).module()(x)
    torch.testing.assert_close(got, make_predict_fn(model)(x), rtol=0,
                               atol=0)
