"""The PyTorch port's Mamba-UNet serving slice against the JAX package.

The toy model's logits are held against JAX on both scan routes of a JAX
serving forward (slab ``_fwd_kernel`` and, under ``inference_scan()``, the
persistent ``_bidir_kernel``) at 5e-4, the JAX package's own bound between
those routes. The converter is checked at full width without compute, and
the test CLI runs end to end on a synthetic h5 set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.cli import test as tcli  # noqa: E402
from mamba_unet_torch.models import net_factory  # noqa: E402
from mamba_unet_torch.models.vssm import MambaUnet as TMambaUnet  # noqa: E402
from mamba_unet_torch.utils.checkpoint import load_model_snapshot  # noqa: E402
from mamba_unet_torch.utils.convert import (  # noqa: E402
    params_from_jax,
    to_torch_layout,
    torch_key,
)
from mamba_unet_torch.utils.export import make_predict_fn  # noqa: E402
from mamba_unet_tpu.models.vssm import MambaUnet as JMambaUnet  # noqa: E402
from mamba_unet_tpu.ops import selective_scan_persistent as ssper  # noqa: E402
from mamba_unet_tpu.utils.convert import torch_key_for  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on a few cores, and torch's default of one thread per core
    oversubscribed them (a 3 s test took minutes under that load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def fast_jax_compiles():
    """XLA's cheaper compile while this file runs: the JAX references are
    compile-bound."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def toy():
    """The toy JAX model, its weights, an input, and the port model holding
    the same weights."""
    x = np.random.default_rng(7).normal(size=(2, 32, 32, 1)).astype(np.float32)
    jmodel = JMambaUnet(img_size=32, num_classes=4, depths=(2, 2),
                        dims=(16, 32), scan_impl="bidir")
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(x))
    tmodel = TMambaUnet(num_classes=4, depths=(2, 2), dims=(16, 32))
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(variables["params"], sep="/").items()}
    tmodel.load_state_dict(params_from_jax(flat, like=tmodel.state_dict()))
    return x, jmodel, variables, tmodel


@pytest.mark.parametrize("route", ["slab", "persistent"])
def test_toy_mamba_unet_logits_match_jax(toy, monkeypatch, route):
    x, jmodel, variables, tmodel = toy
    if route == "persistent":
        monkeypatch.setattr(ssper, "_MIN_L", 32)  # stage 0 (L=64) persistent
        with ssper.inference_scan():  # trace-time switch: trace inside it
            want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    else:
        want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    got = make_predict_fn(tmodel)(x)
    assert got.dtype == np.float32 and got.shape == (2, 32, 32, 4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=5e-4, atol=5e-4)


def test_converter_covers_full_width_model():
    """vmamba-tiny at 224²: every flax leaf maps to one port key of the same
    shape, no port key is left over, and the keys are the upstream torch
    keys that ``mamba_unet_tpu``'s ``torch_key_for`` names."""
    shapes = jax.eval_shape(JMambaUnet().init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 224, 224, 1),
                                                 jnp.float32))["params"]
    flat = flatten_dict(shapes, sep="/")
    port = TMambaUnet(device="meta").state_dict()
    seen = {}
    for path, leaf in flat.items():
        key = torch_key(path)
        assert key not in seen, (path, seen.get(key))
        seen[key] = path
        view = np.broadcast_to(np.float32(0), leaf.shape)  # no memory
        assert to_torch_layout(path, view).shape == tuple(port[key].shape), key
        upstream, _ = torch_key_for(tuple(path.split("/")[1:]))
        assert key == "mamba_unet." + upstream
    assert set(seen) == set(port)
    assert len(port) == len(flat) > 150
    with pytest.raises(KeyError):
        torch_key("vssm/layers_0/mystery/kernel")


def test_snapshot_roundtrip_and_registry(tmp_path):
    small = dict(depths=(2, 2), dims=(16, 32))
    a = net_factory("ViM_seg", num_classes=4,
                    generator=torch.Generator().manual_seed(0), **small)
    b = net_factory("mambaunet", num_classes=4,
                    generator=torch.Generator().manual_seed(0), **small)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)  # one seed, one init
    with pytest.raises(KeyError):
        net_factory("no_such_net")

    full = load_model_snapshot("ViM_seg", 4, 1, device="cpu")  # seed 0, full width
    assert not full.training
    path = tmp_path / "m.pth"
    saved = {k: v + 0.5 for k, v in full.state_dict().items()}
    torch.save(saved, path)
    loaded = load_model_snapshot("ViM_seg", 4, 1, str(path), device="cpu")
    for (ka, va), (kb, vb) in zip(saved.items(),
                                  loaded.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    torch.save(a.state_dict(), path)
    with pytest.raises(RuntimeError):  # a toy state_dict into the full net
        load_model_snapshot("ViM_seg", 4, 1, str(path), device="cpu")


def test_cli_runs_on_synthetic_h5(tmp_path):
    """``cli/test.py`` on two synthetic volumes, full-width dims, 32² patch."""
    from mamba_unet_tpu.data.synthetic import make_synthetic_acdc

    root = make_synthetic_acdc(str(tmp_path / "acdc"), n_train_cases=0,
                               slices_per_case=3, n_val_cases=0,
                               n_test_cases=2, size=40)
    args = tcli.build_parser().parse_args([
        "--root_path", root, "--patch_size", "32", "32",
        "--write_pred_key", "pred_port", "--device", "cpu"])
    out = tcli.run_inference(args)
    assert out["per_case"].shape == (2, 3, 3)
    assert np.isfinite(out["mean"]).all()
    import h5py

    with h5py.File(f"{root}/data/test_patient000.h5") as f:
        assert f["pred_port"].shape == (3, 32, 32)
    assert tcli.main(["--root_path", root, "--patch_size", "32", "32",
                      "--device", "cpu"]) == 0
