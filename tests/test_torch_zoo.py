"""The PyTorch port's UNet family and Swin-UNet against the JAX package.

Toy sizes: the UNets with feature widths (4, 8, 16, 32, 64) at 32²,
Swin-UNet at img 64 with embed 24, heads (1, 2, 4, 8) and window 4 (stages
0-1 shift their windows, stages 2-3 cover their maps and do not). The same
seeded numpy input goes through the JAX model and the port model holding
its weights and BatchNorm statistics (``params_from_jax``). Tolerances:
logits in eval mode and running statistics within 1e-5 (rtol and atol:
fp32 convs and matmuls in another order); train-mode logits within 2e-4
(atol; rtol 1e-5): there BatchNorm normalizes with batch statistics, over
the 8 values per channel of the 2x2 bottleneck at batch 2, which amplifies
fp32 rounding (measured on a CPU, logits up to 3: 6.3e-6 for unet,
3.3e-5 for TLunet, whose second UNet stacks as many BatchNorms again; with
other weights 1.6e-5 and 7.5e-5); the window helpers, the
ConvTranspose layout and the nearest resize exactly, or within 1e-6 where
they compute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as fnn
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.models import net_factory  # noqa: E402
from mamba_unet_torch.models import swin_unet as t_swin_unet  # noqa: E402
from mamba_unet_torch.models import unet as t_unet  # noqa: E402
from mamba_unet_torch.nn import swin as t_swin  # noqa: E402
from mamba_unet_torch.nn.layers import set_generator  # noqa: E402
from mamba_unet_torch.utils.convert import (  # noqa: E402
    params_from_jax,
    to_torch_layout,
)
from mamba_unet_tpu.models import swin_unet as j_swin_unet  # noqa: E402
from mamba_unet_tpu.models import unet as j_unet  # noqa: E402
from mamba_unet_tpu.nn import swin as j_swin  # noqa: E402

FT = (4, 8, 16, 32, 64)
NO_DROP = (0.0,) * 5
TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-5, atol=2e-4)
UNETS = {"unet": ("UNet", "UNet"), "unet_ds": ("UNetDS", "UNetDS"),
         "unet_urpc": ("UNetURPC", "UNetURPC"),
         "unet_cct": ("UNetCCT", "UNetCCT"), "TLunet": ("TLUNet", "TLUNet")}
SWIN = dict(img_size=64, embed_dim=24, num_heads=(1, 2, 4, 8), window_size=4,
            drop_path_rate=0.0)


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
    """XLA's cheaper compile while this file runs: the JAX references are
    compiled once each and run a few times, so compile time is most of
    their cost."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _outs(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def _variables(jm, x, seed):
    """Seeded numpy variables of the JAX model's shapes (``eval_shape``: no
    JAX init is compiled): kernels at std 1/sqrt(fan-in), small biases and
    tables, scales near 1, running means near 0 and variances in [0.5,
    1.5)."""
    r = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), x)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = r.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * r.normal(size=shape)
        elif name == "var":
            v = 0.5 + r.random(shape)
        else:  # bias, mean, relative_position_bias_table
            v = 0.1 * r.normal(size=shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _unet_pair(name, seed=0):
    """(JAX model, its seeded variables, the port model holding them)."""
    jcls, tcls = UNETS[name]
    jm = getattr(j_unet, jcls)(num_classes=4, ft_chns=FT, dropout=NO_DROP)
    variables = _variables(jm, jnp.zeros((2, 32, 32, 1)), seed)
    tm = getattr(t_unet, tcls)(num_classes=4, ft_chns=FT, dropout=NO_DROP)
    tm.load_state_dict(params_from_jax(
        _flat(variables["params"]), like=tm.state_dict(),
        batch_stats=_flat(variables["batch_stats"])))
    return jm, variables, tm


def _image(seed=3, size=32):
    return np.random.default_rng(seed).normal(
        size=(2, size, size, 1)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(UNETS))
def test_unet_family_eval_logits_match_jax(name):
    jm, variables, tm = _unet_pair(name)
    x = _image()
    want = _outs(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _outs(tm.eval()(torch.from_numpy(x)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name", ["unet", "unet_ds", "TLunet"])
def test_unet_family_train_mode_logits_and_stats_match_jax(name):
    """Train mode, dropout 0: batch-statistics normalization and the
    running statistics flax keeps (biased variance, momentum 0.99)."""
    jm, variables, tm = _unet_pair(name, seed=1)
    x = _image(4)
    out, upd = jax.jit(lambda v, x: jm.apply(
        v, x, deterministic=False, mutable=["batch_stats"],
        rngs={"dropout": jax.random.key(0)}))(variables, jnp.asarray(x))
    got = _outs(tm.train()(torch.from_numpy(x)))
    for g, w in zip(got, _outs(out)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   **TRAIN_TOL)
    want = params_from_jax(_flat(variables["params"]),
                           batch_stats=_flat(upd["batch_stats"]),
                           num_batches_tracked=1)
    sd = tm.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                                 for m in tm.modules())
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), **TOL,
                                   err_msg=k)
    assert all(int(sd[k]) == 1 for k in sd if k.endswith("batches_tracked"))


def test_unet_keys_are_the_upstream_names():
    sd = net_factory("unet", num_classes=4).state_dict()
    for key in ("encoder.in_conv.conv_conv.0.weight",
                "encoder.in_conv.conv_conv.1.running_var",
                "encoder.in_conv.conv_conv.4.bias",
                "encoder.in_conv.conv_conv.5.num_batches_tracked",
                "encoder.down1.maxpool_conv.1.conv_conv.0.weight",
                "decoder.up1.up.weight", "decoder.up1.conv.conv_conv.0.weight",
                "decoder.out_conv.weight"):
        assert key in sd, key
    assert tuple(sd["decoder.up1.up.weight"].shape) == (256, 128, 2, 2)


def test_conv_transpose_kernel_is_flipped():
    """flax's ConvTranspose (transpose_kernel=False) is torch's
    ConvTranspose2d with the kernel flipped in both spatial axes; unflipped
    it differs."""
    x = np.random.default_rng(0).normal(size=(1, 3, 5, 2)).astype(np.float32)
    m = fnn.ConvTranspose(4, (2, 2), strides=(2, 2))
    variables = m.init(jax.random.key(1), x)
    kernel = np.asarray(variables["params"]["kernel"])
    want = np.asarray(m.apply(variables, x))
    bias = torch.from_numpy(np.array(variables["params"]["bias"]))

    def run(w):
        y = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(np.ascontiguousarray(w)), bias, stride=2)
        return y.permute(0, 2, 3, 1).numpy()

    w = to_torch_layout("decoder/up1/up/kernel", kernel)
    assert w.shape == (2, 4, 2, 2)
    np.testing.assert_allclose(run(w), want, rtol=1e-6, atol=1e-6)
    assert np.abs(run(kernel.transpose(2, 3, 0, 1)) - want).max() > 1e-2


@pytest.mark.parametrize("size", [28, 56, 112])
def test_decoder_ds_nearest_resize_matches_jax(size):
    """The aux heads' resize at the 224² model's factors (8, 4, 2)."""
    seg = np.random.default_rng(size).normal(
        size=(2, size, size, 4)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(seg), (2, 224, 224, 4), "nearest")
    got = torch.nn.functional.interpolate(
        torch.from_numpy(seg).permute(0, 3, 1, 2), size=(224, 224),
        mode="nearest-exact").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["unet_urpc", "unet_cct"])
def test_perturbed_heads_draw_from_the_generator(name):
    """URPC's and CCT's aux-head perturbations in training: shapes; the
    same seed gives the same outputs, another seed others; no generator
    raises; eval mode draws nothing."""
    model = net_factory(name, num_classes=4, ft_chns=FT, dropout=NO_DROP,
                        generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(_image())

    def run(seed):
        set_generator(model, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return model(x)

    a, b, c = run(5), run(5), run(6)
    assert len(a) == 4 and all(o.shape == (2, 32, 32, 4) for o in a)
    for oa, ob in zip(a, b):
        torch.testing.assert_close(oa, ob, rtol=0, atol=0)
    # the main head sees no perturbation; every aux head does
    torch.testing.assert_close(a[0], c[0], rtol=0, atol=0)
    assert all(not torch.equal(oa, oc) for oa, oc in zip(a[1:], c[1:]))
    set_generator(model, None)
    with pytest.raises(RuntimeError, match="generator"):
        model(x)
    with torch.no_grad():
        model.eval()(x)


# --- Swin-UNet -----------------------------------------------------------


@pytest.mark.parametrize("H,W,ws,shift", [(16, 16, 4, 2), (8, 12, 4, 2),
                                          (4, 4, 4, 0)])
def test_window_helpers_match_jax(H, W, ws, shift):
    x = np.random.default_rng(H + W).normal(
        size=(2, H, W, 3)).astype(np.float32)
    wins = t_swin.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(
        wins.numpy(), np.asarray(j_swin.window_partition(jnp.asarray(x), ws)))
    np.testing.assert_array_equal(
        t_swin.window_reverse(wins, ws, H, W).numpy(), x)
    np.testing.assert_array_equal(t_swin._relative_position_index(ws),
                                  j_swin._relative_position_index(ws))
    want = j_swin._shift_attn_mask(H, W, ws, shift)
    got = t_swin._shift_attn_mask(H, W, ws, shift)
    assert (got is None) == (want is None) == (shift == 0)
    if want is not None:
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def swin_pair():
    jm = j_swin_unet.SwinUnet(num_classes=4, **SWIN)
    variables = _variables(jm, jnp.zeros((2, 64, 64, 1)), 0)
    tm = t_swin_unet.SwinUnet(num_classes=4, **SWIN)
    tm.load_state_dict(params_from_jax(_flat(variables["params"]),
                                       like=tm.state_dict()))
    return jm, variables, tm


def test_swin_unet_logits_match_jax(swin_pair):
    jm, variables, tm = swin_pair
    x = _image(7, 64)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 64, 64, 4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # train mode at drop rates 0 computes the same function
    set_generator(tm, torch.Generator().manual_seed(0))
    with torch.no_grad():
        np.testing.assert_allclose(tm.train()(torch.from_numpy(x)).numpy(),
                                   want, **TOL)


def test_swin_blocks_window_shift_and_buffers(swin_pair):
    """Stages 0-1 shift (ws 4, shift 2), stages 2-3 cover their maps; the
    index and masks are not in the state_dict."""
    _, _, tm = swin_pair
    net = tm.swin_unet
    got = [(b.window_size, b.shift_size) for layer in net.layers
           for b in layer.blocks]
    assert got == [(4, 0), (4, 2), (4, 0), (4, 2), (4, 0), (4, 0), (2, 0),
                   (2, 0)]
    assert not any(k.endswith(("relative_position_index", "attn_mask"))
                   for k in tm.state_dict())
    table = net.layers[3].blocks[0].attn.relative_position_bias_table
    assert tuple(table.shape) == (9, 8)
    with pytest.raises(ValueError, match="image size"):
        tm.eval()(torch.zeros(1, 32, 32, 1))


def test_swin_attention_logits_stay_fp32_under_bf16_autocast(swin_pair):
    _, _, tm = swin_pair
    attn = tm.swin_unet.layers[0].blocks[1].attn
    seen = {}
    real_softmax = torch.softmax

    def spy(t, dim):
        seen["dtype"] = t.dtype
        return real_softmax(t, dim)

    x = torch.randn(16, 16, 24)
    mask = tm.swin_unet.layers[0].blocks[1].attn_mask
    torch.softmax = spy
    try:
        with torch.autocast("cpu", torch.bfloat16):
            out = attn(x, mask)
    finally:
        torch.softmax = real_softmax
    assert seen["dtype"] == torch.float32 and out.dtype == torch.bfloat16


def test_registry_builds_every_new_model():
    for name in ("unet", "unet_ds", "unet_urpc", "unet_cct", "TLunet",
                 "ViT_seg"):
        kw = dict(SWIN) if name == "ViT_seg" else {"ft_chns": FT}
        model = net_factory(name, num_classes=3, in_chans=1,
                            generator=torch.Generator().manual_seed(0), **kw)
        size = 64 if name == "ViT_seg" else 32
        with torch.no_grad():
            out = _outs(model.eval()(torch.zeros(1, size, size, 1)))
        assert out[0].shape == (1, size, size, 3)
