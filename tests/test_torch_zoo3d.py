"""The PyTorch port's rest of the model zoo against the JAX package: ENet,
the discriminators, ``preUnet``, ``efficient_unet``, the 3-D UNets,
VoxResNet, the attention UNet, nnU-Net, UNETR, SwinUNETR and SegMamba.

Toy sizes (narrow widths, 16³-32³ volumes, 32²-64² slices). The same
seeded numpy input goes through the JAX model and the port model holding
its weights and BatchNorm statistics (``params_from_jax``), the variables
drawn from a seed in the JAX model's shapes (``jax.eval_shape``: no JAX
init is compiled). The JAX SwinUNETR's shift mask converts a jnp array
to numpy, which fails inside a trace, so its model with shifted windows
cannot be traced as it is: the test evaluates that function at trace
time (``jax.ensure_compile_time_eval``), and holds it and the relative
position index equal to the port's. Tolerances: eval-mode logits within
1e-5 of the largest logit plus 1e-5 (fp32 in another order: measured on a
CPU, UNETR's 12 blocks part from JAX by 5.4e-5 at logits up to 10.9, and
the port's fp32 is within 1.2e-5 of its own fp64 where JAX's is 4.9e-5
from it; nnU-Net's instance norms over the 1x2x2 maps of its deepest
stages 2.6e-5 at 6.3, fp64 7.6e-6 and 2.2e-5); running statistics within
1e-5 and train-mode logits, where a model has BatchNorm, within 3e-4
(atol; rtol 1e-5; ``tests/test_torch_zoo.py`` holds the 2-D UNets at
2e-4, and one of 131,072 logits of the deep-supervision 3-D UNet parted
by 2.2e-4 on a CPU), dropout off on both
sides (flax's ``Dropout`` patched to the identity for the JAX reference),
since batch statistics over a few values per channel amplify fp32
rounding (the 3-D UNets run 32³ volumes so that their centre's statistics
pool 16 values per channel).
ENet's unpooling, whose first-maximum one-hot breaks ties as JAX's does,
is held exactly on inputs full of ties. The toy SegMamba's logits (as
the others) and every parameter's gradient of a fixed linear function of
them within 1e-4 of the largest gradient (measured on a CPU: 1.0e-5 of
it; per tensor the biases before an instance norm, whose true gradient
is 0, hold only rounding noise on both sides). Every name of
the JAX registry builds in the port's ``net_factory``, and SegMamba
refuses a 4-D (slice) input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as fnn
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.models import net_factory  # noqa: E402
from mamba_unet_torch.models import enet as t_enet  # noqa: E402
from mamba_unet_torch.models import vnet as t_vnet  # noqa: E402
from mamba_unet_torch.models.registry import (  # noqa: E402
    SCAN_MODELS,
    VOLUME_MODELS,
    list_models,
)
from mamba_unet_torch.nn import layers as t_layers  # noqa: E402
from mamba_unet_torch.utils.convert import params_from_jax  # noqa: E402
from mamba_unet_tpu.models import enet as j_enet  # noqa: E402
from mamba_unet_tpu.models import list_models as j_list_models  # noqa: E402
from mamba_unet_tpu.models import net_factory as j_net_factory  # noqa: E402
from mamba_unet_tpu.models import swin_unetr as _j_swin_unetr  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-5, atol=3e-4)

# name -> (keywords of both models, JAX-only keywords, port-only keywords,
# input shapes, has BatchNorm)
CASES = {
    "enet": (dict(num_classes=4), {}, {}, [(2, 32, 32, 1)], True),
    "efficient_unet": (dict(num_classes=4, stage_features=(8, 12, 16, 24, 32),
                            stage_blocks=(1, 1, 1, 1, 1),
                            decoder_features=(32, 24, 16, 8)), {}, {},
                       [(2, 64, 64, 1)], True),
    "preUnet": (dict(num_classes=4, depths=(1, 1, 1)), {}, {},
                [(2, 32, 32, 1)], True),
    "fc_discriminator": (dict(num_classes=4, ndf=8), {}, {},
                         [(2, 32, 32, 4), (2, 32, 32, 1)], False),
    "fc3d_discriminator": (dict(num_classes=2, ndf=4), {}, {},
                           [(1, 16, 16, 16, 2), (1, 16, 16, 16, 1)], False),
    "unet_3D": (dict(num_classes=2, feature_scale=16), {}, {},
                [(2, 32, 32, 32, 1)], True),
    "unet_3D_dv_semi": (dict(num_classes=2, feature_scale=16), {}, {},
                        [(2, 32, 32, 32, 1)], True),
    "voxresnet": (dict(num_classes=2, feature_chns=8), {}, {},
                  [(2, 16, 16, 16, 1)], True),
    "attention_unet": (dict(num_classes=2, feature_scale=16), {}, {},
                       [(2, 16, 16, 16, 1)], True),
    "nnUNet": (dict(num_classes=4, base_features=4), {}, {},
               [(1, 4, 64, 64, 1)], False),
    "unetr": (dict(num_classes=3, img_size=32, patch_size=16, hidden=32,
                   mlp_dim=64, heads=4, n_layers=12, feature_size=4), {}, {},
              [(1, 32, 32, 32, 1)], False),
    "swinunetr": (dict(num_classes=2, feature_size=8, depths=(2, 2, 1, 1),
                       num_heads=(1, 2, 2, 4), window_size=4), {},
                  dict(img_size=32), [(1, 32, 32, 32, 1)], False),
}
SEGMAMBA = dict(num_classes=2, feat_size=(8, 16, 32, 64), hidden_size=8,
                d_state=4, depths=(1, 1, 1, 1))


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
    """XLA's cheaper compile while this file runs: each JAX reference is
    compiled once and run once."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _outs(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def _near(got, want):
    """Within 1e-5 of the largest |want| plus 1e-5."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= 1e-5 * scale + 1e-5, (err, scale)


def _variables(jm, xs, seed=0):
    """Seeded numpy variables of the JAX model's shapes: kernels at std
    1/sqrt(fan-in), small biases, tables and slopes, scales near 1,
    running means near 0 and variances in [0.5, 1.5)."""
    r = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), *xs)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name.endswith("kernel"):
            v = r.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * r.normal(size=shape)
        elif name == "var":
            v = 0.5 + r.random(shape)
        elif name == "alpha":
            v = 0.25 + 0.05 * r.normal(size=shape)
        else:  # bias, mean, rel_bias, pos_embed
            v = 0.1 * r.normal(size=shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _pair(name):
    both, j_only, t_only, shapes, has_bn = CASES[name]
    r = np.random.default_rng(3)
    xs = [r.normal(size=s).astype(np.float32) for s in shapes]
    jm = j_net_factory(name, **both, **j_only)
    variables = _variables(jm, [jnp.asarray(x) for x in xs])
    with pytest.MonkeyPatch.context() as mp:
        # the port's initial weights are replaced by JAX's below: skip the
        # truncated-normal draws (seconds for preUnet's 29 M on a CPU)
        for module in (t_layers, t_vnet):
            mp.setattr(module, "trunc_normal_", lambda p, *a, **k: p)
        tm = net_factory(name, **both, **t_only)
    tm.load_state_dict(params_from_jax(
        _flat(variables["params"]), like=tm.state_dict(),
        batch_stats=_flat(variables.get("batch_stats", {}))))
    return jm, variables, tm, xs, has_bn


@pytest.fixture
def traceable_jax_swin_unetr(monkeypatch):
    """The JAX SwinUNETR's shift mask evaluated at trace time."""
    mask = _j_swin_unetr._shift_mask_3d

    def at_trace_time(*args):
        with jax.ensure_compile_time_eval():
            return mask(*args)

    monkeypatch.setattr(_j_swin_unetr, "_shift_mask_3d", at_trace_time)


def test_swin_unetr_windows_match_jax():
    """The 3-D relative position index and the shift masks, exactly."""
    from mamba_unet_torch.models import swin_unetr as t_swin_unetr

    for ws in (2, 4, 7):
        np.testing.assert_array_equal(t_swin_unetr.rel_index_3d(ws),
                                      _j_swin_unetr._rel_index_3d(ws))
    for dims, ws, shift in (((8, 8, 8), 4, 2), ((16, 8, 12), 4, 2),
                            ((14, 14, 14), 7, 3)):
        np.testing.assert_array_equal(
            t_swin_unetr.shift_mask_3d(*dims, ws, shift),
            _j_swin_unetr._shift_mask_3d(*dims, ws, shift))
    assert t_swin_unetr.shift_mask_3d(8, 8, 8, 4, 0) is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_zoo_logits_match_jax(name, monkeypatch, traceable_jax_swin_unetr):
    """Eval-mode logits; with BatchNorm also train-mode logits and the
    running statistics after the pass."""
    jm, variables, tm, xs, has_bn = _pair(name)
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)

    def both(v, *xs):
        ev = jm.apply(v, *xs)
        if not has_bn:
            return ev, None, None
        tr, upd = jm.apply(v, *xs, deterministic=False,
                           mutable=["batch_stats"])
        return ev, tr, upd["batch_stats"]

    want_eval, want_train, want_stats = jax.jit(both)(
        variables, *[jnp.asarray(x) for x in xs])
    ts = [torch.from_numpy(x) for x in xs]
    with torch.no_grad():
        got = _outs(tm.eval()(*ts))
    for g, w in zip(got, _outs(want_eval), strict=True):
        assert g.dtype == torch.float32
        _near(g.numpy(), w)
    if not has_bn:
        return
    for m in tm.modules():
        if hasattr(m, "rate"):
            m.rate = 0.0
    with torch.no_grad():
        got = _outs(tm.train()(*ts))
    for g, w in zip(got, _outs(want_train), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TRAIN_TOL)
    sd = tm.state_dict()
    want_sd = params_from_jax(_flat(variables["params"]), like=sd,
                              batch_stats=_flat(want_stats),
                              num_batches_tracked=1)
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), want_sd[k].numpy(), **TOL,
                                   err_msg=k)


def test_enet_unpooling_breaks_ties_as_jax():
    """Windows full of ties (ReLU zeros, repeated values): the pooled
    values and the unpooled map equal JAX's exactly."""
    r = np.random.default_rng(0)
    x = np.maximum(r.integers(-2, 3, (2, 8, 8, 3)), 0).astype(np.float32)
    pooled, onehot = j_enet._maxpool_with_argmax(jnp.asarray(x))
    want = np.asarray(j_enet._max_unpool(pooled, onehot))
    tp, toh = t_enet.maxpool_with_argmax(torch.from_numpy(x).movedim(-1, 1))
    np.testing.assert_array_equal(tp.movedim(1, -1).numpy(),
                                  np.asarray(pooled))
    np.testing.assert_array_equal(toh.permute(0, 2, 3, 4, 1).numpy(),
                                  np.asarray(onehot))
    got = t_enet.max_unpool(tp, toh).movedim(1, -1).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.asarray(onehot).sum(3) == 1).all()


def test_segmamba_logits_and_gradients_match_jax():
    """The toy SegMamba (the JAX test's widths) on a 16³ volume: logits,
    and the gradient of sum(logits * w) for every parameter. JAX runs its
    plain reference scan (``scan_impl="ref"``, the cheapest to compile;
    the port's SegMamba has one route, the grouped scan)."""
    from mamba_unet_tpu.models.segmamba import SegMamba as JSegMamba

    r = np.random.default_rng(4)
    x = r.normal(size=(1, 16, 16, 16, 1)).astype(np.float32)
    w = r.normal(size=(1, 16, 16, 16, 2)).astype(np.float32)
    jm = JSegMamba(scan_impl="ref", **SEGMAMBA)
    variables = _variables(jm, [jnp.asarray(x)], seed=5)

    def loss(params, x, w):
        out = jm.apply({"params": params}, x)
        return (out * w).sum(), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], jnp.asarray(x), jnp.asarray(w))
    tm = net_factory("segmamba", **SEGMAMBA)
    tm.load_state_dict(params_from_jax(_flat(variables["params"]),
                                       like=tm.state_dict()))
    out = tm(torch.from_numpy(x))
    _near(out.detach().numpy(), want)
    (out * torch.from_numpy(w)).sum().backward()
    want_g = params_from_jax(_flat(grads), like=tm.state_dict())
    largest = max(float(v.abs().max()) for v in want_g.values())
    worst = max(float((p.grad - want_g[k]).abs().max())
                for k, p in tm.named_parameters())
    assert worst <= 1e-4 * largest, (worst, largest)


def test_registry_has_every_jax_name():
    """Every name of the JAX registry builds in the port's ``net_factory``
    (``SwinUNETR`` under both its names); the 3-D ones are marked so, and
    ``segmamba`` takes no ``scan_impl`` (its 1-D Mamba has one route)."""
    names = set(j_list_models())
    assert names <= set(list_models()), names - set(list_models())
    assert {"SwinUNETR", "swinunetr", "segmamba"} <= set(list_models())
    for name in ("unet_3D", "unet_3D_dv_semi", "voxresnet", "attention_unet",
                 "nnUNet", "unetr", "swinunetr", "segmamba"):
        assert name in VOLUME_MODELS
    assert "segmamba" not in SCAN_MODELS


def test_segmamba_refuses_a_slice_batch():
    """A (B, H, W, 1) slice batch raises, naming the 5-D shape expected
    (JAX's convs read its batch axis as depth); a ``scan_impl`` is refused,
    not ignored."""
    model = net_factory("segmamba", **SEGMAMBA)
    with pytest.raises(ValueError, match=r"\(B, D, H, W, C\)"):
        model(torch.zeros(3, 16, 16, 1))
    with pytest.raises(TypeError, match="scan_impl"):
        net_factory("segmamba", scan_impl="auto", **SEGMAMBA)
