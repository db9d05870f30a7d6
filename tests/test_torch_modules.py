"""The PyTorch port's modules against their JAX counterparts.

Each module gets the JAX module's initialized weights through
``params_from_jax`` and the same numpy inputs. SS2D is compared on both
routes a JAX serving forward takes: the slab kernel (``scan_impl="bidir"``,
``_fwd_kernel`` in interpret mode) and the persistent kernel
(``inference_scan()``, ``_bidir_kernel``). Tolerances: 1e-5 where no scan
runs (fp32 matmuls in another order), 3e-4 for SS2D (the JAX package's own
bound between its two scan routes). Host-side numpy copies (metrics, volume
inference, phantom) must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.data.synthetic import _phantom as t_phantom  # noqa: E402
from mamba_unet_torch.eval import inference as t_inf  # noqa: E402
from mamba_unet_torch.eval import metrics as t_met  # noqa: E402
from mamba_unet_torch.nn import patch_ops as tpo  # noqa: E402
from mamba_unet_torch.nn.layers import DropPath  # noqa: E402
from mamba_unet_torch.nn.ss2d import SS2D as TSS2D  # noqa: E402
from mamba_unet_torch.nn.ss2d import a_log_init, dt_bias_init  # noqa: E402
from mamba_unet_torch.utils.convert import params_from_jax  # noqa: E402
from mamba_unet_tpu.data.synthetic import _phantom as j_phantom  # noqa: E402
from mamba_unet_tpu.eval import inference as j_inf  # noqa: E402
from mamba_unet_tpu.eval import metrics as j_met  # noqa: E402
from mamba_unet_tpu.nn import patch_ops as jpo  # noqa: E402
from mamba_unet_tpu.nn.ss2d import SS2D as JSS2D  # noqa: E402
from mamba_unet_tpu.ops import selective_scan_persistent as ssper  # noqa: E402


def _port_forward(jmodule, tmodule, x):
    """Init ``jmodule`` on ``x``, carry its weights into ``tmodule``; return
    (jax variables, port output as numpy)."""
    variables = jmodule.init(jax.random.key(0), jnp.asarray(x))
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(variables["params"], sep="/").items()}
    tmodule.load_state_dict(params_from_jax(flat, like=tmodule.state_dict()))
    with torch.no_grad():
        got = tmodule.eval()(torch.from_numpy(x)).numpy()
    return variables, got


@pytest.mark.parametrize("op", ["embed", "merge", "merge_odd", "expand",
                                "final_expand"])
def test_patch_ops_match_jax(rng, op):
    cases = {
        "embed": (jpo.PatchEmbed2D(patch_size=4, embed_dim=8),
                  tpo.PatchEmbed2D(4, 3, 8), (2, 16, 16, 3)),
        "merge": (jpo.PatchMerging2D(), tpo.PatchMerging2D(8), (2, 8, 6, 8)),
        "merge_odd": (jpo.PatchMerging2D(), tpo.PatchMerging2D(8),
                      (2, 7, 5, 8)),
        "expand": (jpo.PatchExpand2D(), tpo.PatchExpand2D(8), (2, 4, 3, 8)),
        "final_expand": (jpo.FinalPatchExpand2D(scale=4),
                         tpo.FinalPatchExpand2D(8, 4), (2, 3, 4, 8)),
    }
    jmod, tmod, shape = cases[op]
    x = rng.normal(size=shape).astype(np.float32)
    variables, got = _port_forward(jmod, tmod, x)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["slab", "persistent"])
def test_ss2d_matches_jax(rng, monkeypatch, route):
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    jmod = JSS2D(d_model=16, d_state=4, scan_impl="bidir")
    variables, got = _port_forward(jmod, TSS2D(16, d_state=4), x)
    if route == "persistent":
        monkeypatch.setattr(ssper, "_MIN_L", 32)  # route L=64 to _bidir_kernel
        with ssper.inference_scan():
            want = jmod.apply(variables, jnp.asarray(x))
    else:
        want = jmod.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=3e-4, atol=3e-4)


def test_ss2d_inits():
    g = torch.Generator().manual_seed(0)
    bias = dt_bias_init((4, 4096), g)
    dt = torch.nn.functional.softplus(bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    from mamba_unet_tpu.nn.ss2d import _a_log_init

    np.testing.assert_allclose(
        a_log_init(8, 16).numpy(),
        np.asarray(_a_log_init(8, 16)(None, (8, 16))), rtol=1e-6)
    m = TSS2D(32, generator=g)
    assert m.x_proj_weight.abs().max() <= 1 / np.sqrt(64)
    assert bool((m.Ds == 1).all())


def test_drop_path_identity_in_eval():
    dp = DropPath(0.5)
    x = torch.randn(64, 3, 3, 2)
    assert torch.equal(dp.eval()(x), x)
    y = dp.train()(x)
    kept = (y != 0).flatten(1).all(1)
    torch.testing.assert_close(y[kept], 2 * x[kept])
    assert 0 < int(kept.sum()) < 64


def test_metrics_copy_matches_jax(rng):
    for _ in range(3):
        a = rng.random((24, 20)) > 0.6
        b = rng.random((24, 20)) > 0.5
        for name in ("dice_binary", "hd95", "asd", "calculate_metric_percase"):
            assert getattr(t_met, name)(a, b) == getattr(j_met, name)(a, b)
        assert t_met.dice_hd95_asd(a, b) == (
            j_met.dice_binary(a, b), j_met.hd95(a, b), j_met.asd(a, b))
    empty = np.zeros((5, 5), bool)
    assert t_met.calculate_metric_percase(empty, b[:5, :5]) == (0.0, 0.0)
    assert t_met.dice_hd95_asd(b[:5, :5], empty) == (0.0, 0.0, 0.0)


def test_volume_inference_copy_matches_jax(rng):
    image, label = [], []
    for _ in range(5):
        im, lb = j_phantom(rng, 40)
        image.append(im)
        label.append(lb)
    image, label = np.stack(image), np.stack(label)

    def predict(x):  # deterministic stand-in net: intensity bands
        return np.stack([-abs(x[..., 0] - c) for c in (0.2, 0.5, 0.7, 1.1)],
                        axis=-1)

    for bs in (None, 2):
        got = t_inf.test_single_volume(image, label, predict, 4, (32, 32), bs)
        want = j_inf.test_single_volume(image, label, predict, 4, (32, 32), bs)
        assert got == want
        metrics, pred_small = t_inf.test_single_volume(
            image, label, predict, 4, (32, 32), bs, return_pred=True)
        assert metrics == want
        np.testing.assert_array_equal(
            pred_small, j_inf._predict_batched(
                np.stack([j_inf._zoom0(im, (32, 32)) for im in image]
                         ).astype(np.float32)[..., None], predict, bs))
    np.testing.assert_array_equal(t_inf._zoom0(image[0], (17, 23)),
                                  j_inf._zoom0(image[0], (17, 23)))


def test_phantom_copy_matches_jax():
    got = t_phantom(np.random.default_rng(3), 48, 48)
    want = j_phantom(np.random.default_rng(3), 48)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    image, label = t_phantom(np.random.default_rng(3), 64, 40)
    assert image.shape == label.shape == (64, 40)
    assert set(np.unique(label)) <= {0, 1, 2, 3} and (label == 3).any()
