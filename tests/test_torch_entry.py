"""The port's remaining main-path entry points against the JAX package:
SS2D's ``xla`` route (the tm branch in the port), activation
recomputation (``use_remat``), the upstream ``.pth`` warm start, and the
CLI flags ``--save_nii_dir``, ``--ckpt_name``, ``--synthetic_hard``,
``--pretrained_ckpt``, ``--exp`` (with their NIfTI writer, hard phantom and
snapshot lookup).

Inputs are drawn with numpy from a seed and fed to both frameworks; JAX
weights are carried into the port by ``params_from_jax``. Tolerances, each
relative to the largest magnitude of the output it bounds: SS2D and the toy
Mamba-UNet, outputs and every parameter's gradient, 1e-4 (fp32 matmuls,
convolutions and the scan in another order), as in the other port tests;
the remat and non-remat gradients of the port, one program recomputed, at
1e-6.

The CUDA kernels themselves run only on a card: tests/test_torch_kernel.py
and chip_smoke.py.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.cli import test as test_cli  # noqa: E402
from mamba_unet_torch.cli import train as train_cli  # noqa: E402
from mamba_unet_torch.data import nifti as tnifti  # noqa: E402
from mamba_unet_torch.data import synthetic as tsyn  # noqa: E402
from mamba_unet_torch.models import net_factory  # noqa: E402
from mamba_unet_torch.models import vssm as tvssm  # noqa: E402
from mamba_unet_torch.nn.layers import set_generator  # noqa: E402
from mamba_unet_torch.nn.vss import VSSLayer  # noqa: E402
from mamba_unet_torch.utils import checkpoint as tckpt  # noqa: E402
from mamba_unet_torch.utils.convert import (  # noqa: E402
    load_torch_checkpoint,
    load_upstream_state,
    params_from_jax,
)
from mamba_unet_tpu.data import nifti as jnifti  # noqa: E402
from mamba_unet_tpu.data import synthetic as jsyn  # noqa: E402
from mamba_unet_tpu.models.vssm import MambaUnet as JMambaUnet  # noqa: E402
from mamba_unet_tpu.nn.vss import VSSLayer as JVSSLayer  # noqa: E402
from mamba_unet_tpu.utils import convert as jconvert  # noqa: E402

MODULE_REL, REMAT_REL = 1e-4, 1e-6
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


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def assert_rel(got, want, rel, what):
    """|got - want| <= rel * max|want| elementwise."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    assert np.isfinite(got).all() and (
        err <= rel * np.abs(want).max()).all(), (
        what, float(err.max()), float(np.abs(want).max()))


@pytest.fixture(scope="module")
def jax_stage():
    """One VSS stage of the JAX package on SS2D's xla route with
    ``use_remat=True`` (``nn.remat`` per block), drop_path 0: its input,
    the seeded cotangent ``w``, its weights, and the output and every
    parameter's gradient of sum(out * w), keyed by the port's names. One
    compile serves the port's stage with and without remat (remat changes
    no value)."""
    x = np.random.default_rng(23).normal(size=(2, 5, 6, 16)).astype(
        np.float32)
    jmodule = JVSSLayer(dim=16, depth=1, scan_impl="xla", use_remat=True)
    variables = jax.jit(jmodule.init)(jax.random.key(0), jnp.asarray(x))
    w = np.random.default_rng(24).normal(size=x.shape).astype(np.float32)

    def loss(p, xx):
        out = jmodule.apply({"params": p}, xx)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], jnp.asarray(x))
    return (x, w, _flat(variables["params"]), np.asarray(out),
            params_from_jax(_flat(grads)))


def _toy_factory(monkeypatch):
    """Make ``net_factory("ViM_seg")`` build the toy Mamba-UNet, so the
    CLIs (which build the registry's models) run in seconds."""
    monkeypatch.setattr(tvssm, "MambaUnet",
                        functools.partial(tvssm.MambaUnet, depths=(1, 1),
                                          dims=(16, 32)))


# --- SS2D's xla route and use_remat ----------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_xla_route_and_remat_match_jax(jax_stage, remat):
    """A VSS stage of the port on SS2D's xla route (run as the tm branch;
    on CPU tensors the grouped scan runs its plain loop), without and with
    ``use_remat``, against the JAX stage on its xla route with
    ``use_remat``: output and every parameter's gradient, SS2D's among
    them."""
    x, w, params, want, j_grads = jax_stage
    stage = VSSLayer(16, 1, scan_impl="xla", use_remat=remat)
    assert stage.blocks[0].self_attention.scan_impl == "xla"
    stage.load_state_dict(params_from_jax(params, like=stage.state_dict()))
    got = stage.train()(t(x))
    (got * t(w)).sum().backward()
    assert_rel(got, want, MODULE_REL, "out")
    t_grads = {k: p.grad for k, p in stage.named_parameters()}
    assert set(t_grads) == set(j_grads) and len(t_grads) > 8
    assert any(".self_attention.x_proj_weight" in k for k in t_grads)
    for k, g in t_grads.items():
        assert_rel(g, j_grads[k], MODULE_REL, k)


def test_remat_gradients_equal_without_remat():
    """drop_path 0.5 and one generator seed: the step with ``use_remat``
    (its forward recomputed in the backward) gives the loss and gradients
    of the step without. The recomputation must drop the blocks the first
    forward dropped: its DropPath mask is drawn once."""
    x = t(np.random.default_rng(25).normal(size=(4, 32, 32, 1)).astype(
        np.float32))
    got = {}
    for remat in (False, True):
        model = tvssm.MambaUnet(drop_path_rate=0.5, use_remat=remat,
                                generator=torch.Generator().manual_seed(0),
                                **TOY).train()
        set_generator(model, torch.Generator().manual_seed(1))
        loss = (model(x) ** 2).mean()
        loss.backward()
        got[remat] = (loss, {k: p.grad for k, p in model.named_parameters()})
    (loss, grads), (loss_r, grads_r) = got[False], got[True]
    torch.testing.assert_close(loss_r, loss, rtol=REMAT_REL, atol=0)
    for k, g in grads.items():
        assert_rel(grads_r[k], g.numpy(), REMAT_REL, k)
    assert net_factory("ViM_seg", use_remat=True, **TOY).mamba_unet.layers[
        0].blocks[0].use_remat


# --- the upstream warm start ------------------------------------------------

def test_warm_start_matches_jax_convert_vssm(tmp_path):
    """One ``.pth`` (an encoder-only checkpoint: ``{"model": sd}`` with the
    ``mamba_unet.`` prefix and one tensor of the wrong shape) loaded into
    JAX (``load_torch_checkpoint`` + ``convert_vssm(mirror_decoder=True)``)
    and into the port (``load_upstream_state``): the same weights and the
    same report counts. Four stages, as the mirror maps ``layers.i`` onto
    ``layers_up.(3 - i)``; nothing runs a forward."""
    toy4 = dict(num_classes=4, depths=(1, 1, 1, 1), dims=(8, 16, 32, 64))
    source = tvssm.MambaUnet(generator=torch.Generator().manual_seed(3),
                             **toy4)
    sd = {f"mamba_unet.{k}": v for k, v in
          source.mamba_unet.state_dict().items()
          if k.startswith(("layers.", "patch_embed."))}
    sd["mamba_unet.patch_embed.proj.weight"] = torch.zeros(8, 3, 2, 2)
    path = str(tmp_path / "encoder.pth")
    torch.save({"model": sd}, path)

    # the template: JAX's parameter shapes (no compiled init), seeded
    # values, which the tensors the checkpoint does not hold keep
    shapes = jax.eval_shape(JMambaUnet(img_size=32, **toy4).init,
                            jax.random.key(0), jnp.zeros((1, 32, 32, 1)))
    rng = np.random.default_rng(5)
    template = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)
    params, j_report = jconvert.convert_vssm(
        jconvert.load_torch_checkpoint(path), template["params"]["vssm"],
        mirror_decoder=True)
    port = tvssm.MambaUnet(**toy4)  # the template: the unloaded keep it
    port.load_state_dict(params_from_jax(_flat(template["params"]),
                                         like=port.state_dict()))
    t_report = load_upstream_state(port, load_torch_checkpoint(path))
    for key in ("loaded", "missing", "shape_skipped"):
        assert len(t_report[key]) == len(j_report[key]), key
    assert t_report["shape_skipped"] == [
        ("patch_embed.proj.weight", (8, 3, 2, 2), (8, 3, 4, 4))]
    assert len(t_report["loaded"]) > 20 and t_report["missing"]
    want = params_from_jax(_flat({"vssm": params}))
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    for up, down in ((3, 0), (2, 1), (1, 2)):  # the mirrored encoder
        torch.testing.assert_close(
            port.mamba_unet.layers_up[up].blocks[0].self_attention
            .x_proj_weight,
            source.mamba_unet.layers[down].blocks[0].self_attention
            .x_proj_weight, rtol=0, atol=0)


# --- the CLI flags -----------------------------------------------------------

def test_write_nifti_matches_jax(tmp_path):
    """The port's NIfTI copy writes what JAX's writes, and reads it back."""
    vol = np.random.default_rng(4).integers(0, 4, (6, 5, 3)).astype(np.uint8)
    for mod, name in ((tnifti, "port.nii.gz"), (jnifti, "jax.nii.gz")):
        mod.write_nifti(str(tmp_path / name), vol, spacing=(1, 1, 10))
    got, spacing = tnifti.read_nifti(str(tmp_path / "port.nii.gz"))
    want, j_spacing = jnifti.read_nifti(str(tmp_path / "jax.nii.gz"))
    np.testing.assert_array_equal(got, vol)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(spacing, j_spacing)
    assert tuple(spacing) == (1, 1, 10)


@pytest.mark.parametrize("apical", [False, True])
def test_hard_phantom_matches_jax(apical):
    """``_phantom_hard`` draws JAX's arrays from the same seed."""
    got = tsyn._phantom_hard(np.random.default_rng(5), 48, 48, apical)
    want = jsyn._phantom_hard(np.random.default_rng(5), 48, apical)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_snapshot_lookup_by_ckpt_name(tmp_path):
    """A snapshot directory loads its newest ``{ckpt_name}_{step}``, by
    default the newest ``best``, else the ``"model"`` of the newest
    ``state``; an absent name raises."""
    states = [tvssm.MambaUnet(generator=torch.Generator().manual_seed(s),
                              **TOY).state_dict() for s in range(3)]
    tckpt.save_checkpoint(str(tmp_path), 5, {"model": states[0]})
    tckpt.save_checkpoint(str(tmp_path), 2, {"model": states[2]})
    tckpt.save_checkpoint(str(tmp_path), 4, states[1], name="best2")
    tckpt.save_checkpoint(str(tmp_path), 3, states[2], name="best2")

    def loaded(**kw):
        return tckpt._snapshot_state(str(tmp_path), device="cpu", **kw)

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in b)

    assert same(loaded(ckpt_name="best2"), states[1])
    assert same(loaded(ckpt_name=None), states[0])
    with pytest.raises(FileNotFoundError):
        loaded(ckpt_name="best3")
    tckpt.save_checkpoint(str(tmp_path), 1, states[2], name="best")
    assert same(loaded(ckpt_name=None), states[2])


def test_train_and_test_clis_new_flags_on_cpu(tmp_path, monkeypatch,
                                              caplog):
    """The train CLI with ``--synthetic_hard``, ``--pretrained_ckpt``,
    ``--exp`` and ``--scan_impl xla`` (the toy model), then the test CLI
    on its snapshot with ``--ckpt_name best`` and ``--save_nii_dir``: the
    NIfTI files hold each case's label and a prediction of its shape."""
    _toy_factory(monkeypatch)
    caplog.set_level(logging.INFO)
    source = tvssm.MambaUnet(generator=torch.Generator().manual_seed(3))
    torch.save({"model": {f"mamba_unet.{k}": v for k, v in
                          source.mamba_unet.state_dict().items()}},
               tmp_path / "pre.pth")
    spec = ["--synthetic_spec", "1", "2", "1", "1", "32"]
    assert train_cli.main([
        "--model", "ViM_seg", "--synthetic", "--synthetic_hard", "--device",
        "cpu", "--exp",
        "ACDC/Test", "--pretrained_ckpt", str(tmp_path / "pre.pth"),
        "--scan_impl", "xla", "--patch_size", "32", "32", "--batch_size",
        "2", "--max_iterations", "1", "--eval_every", "1", "--drop_path",
        "0", "--snapshot_dir", str(tmp_path / "snap"), *spec]) == 0
    n = len(source.state_dict())
    assert f"pretrained: loaded {n} tensors, 0 missing, 0 shape-skipped" in (
        caplog.text)
    assert train_cli.build_parser().parse_args(
        ["--exp", "ACDC/Test"]).exp == "ACDC/Test"
    assert tckpt.latest_step(str(tmp_path / "snap"), "best") == 1
    case = tsyn.phantom_acdc(1, 2, 1, 1, 32, hard=True)["test"][0]
    out = test_cli.run_inference(test_cli.build_parser().parse_args([
        "--patch_size", "32", "32", "--device", "cpu", "--checkpoint",
        str(tmp_path / "snap"), "--ckpt_name", "best", "--save_nii_dir",
        str(tmp_path / "nii")]), dataset=[case])
    assert out["per_case"].shape == (1, 3, 3)
    gt, spacing = tnifti.read_nifti(str(tmp_path / "nii" /
                                        f"{case['case']}_gt.nii.gz"))
    pred, _ = tnifti.read_nifti(str(tmp_path / "nii" /
                                    f"{case['case']}_pred.nii.gz"))
    np.testing.assert_array_equal(gt, case["label"].transpose(1, 2, 0))
    assert pred.shape == gt.shape == (32, 32, 2) and pred.dtype == np.uint8
    assert tuple(spacing) == (1, 1, 10) and pred.max() < 4
