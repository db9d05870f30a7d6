"""The PyTorch port's mask model and mask pretraining against the JAX
package: the cube ops, the masked inputs, ``MambaUnetMask``,
``--method mask_pretrain`` and the contrastive trainer's mask variant.

* The cube ops (``objectives/cube.py``) at ranks 2 and 3 and the masked
  inputs (``objectives/masked.py``) given JAX's own permutations and
  visibility masks: exactly JAX's arrays.
* ``MambaUnetMask`` at toy width (depths 1, dims 4-32, d_state 4, 64²
  with 32² cubes) from JAX's ``init_all`` weights: every method in eval
  and in train mode, an input smaller than ``patch_size`` (the anti-
  aliased resize of the position embedding) and the BatchNorm statistics,
  within 1e-5; a position-id count of another size raises.
* Two ``MaskPretrainTrainer`` steps and one contrastive step of the mask
  variant (a ``MambaUnetMask`` pair) against the JAX trainers, drop-path
  0, each step handed JAX's draws: the losses, every parameter and the
  BatchNorm statistics within 1e-5.
* The train CLI's ``--method mask_pretrain --model MambaUnetMask`` and
  ``cli.test --model MambaUnetMask`` on its snapshot.
"""

import jax
import jax.numpy as jnp
import flax
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.cli import test as test_cli  # noqa: E402
from mamba_unet_torch.cli import train as train_cli  # noqa: E402
from mamba_unet_torch.data import synthetic as t_syn  # noqa: E402
from mamba_unet_torch.models.mamba_mask import MambaUnetMask  # noqa: E402
from mamba_unet_torch.objectives import cube as t_cube  # noqa: E402
from mamba_unet_torch.objectives import masked as t_masked  # noqa: E402
from mamba_unet_torch.train import (  # noqa: E402
    ContrastiveConsistencyTrainer,
    MaskPretrainTrainer,
    TrainConfig,
)
from mamba_unet_torch.utils.checkpoint import load_model_snapshot  # noqa: E402
from mamba_unet_torch.utils.convert import params_from_jax  # noqa: E402
from mamba_unet_tpu.models.mamba_mask import (  # noqa: E402
    MambaUnetMask as JMambaUnetMask,
)
from mamba_unet_tpu.objectives import cube as j_cube  # noqa: E402
from mamba_unet_tpu.objectives import masked as j_masked  # noqa: E402
from mamba_unet_tpu.parallel import make_mesh  # noqa: E402
from mamba_unet_tpu.train import TrainConfig as JTrainConfig  # noqa: E402
from mamba_unet_tpu.train.contrastive_cc import (  # noqa: E402
    ContrastiveConsistencyTrainer as JCCTrainer,
)
from mamba_unet_tpu.train.mask_pretrain import (  # noqa: E402
    MaskPretrainTrainer as JMaskPretrainTrainer,
)
from test_torch_train import _committed  # noqa: E402

# the JAX models' scan: JAX's plain sequential reference (lax.scan), the
# same function as its default chunked XLA route on the CPU, whose trace and
# compile take about twice as long
JAX_SCAN = "ref"
TOY = dict(num_classes=4, cube_size=32, patch_size=64, depths=(1, 1, 1, 1),
           dims=(4, 8, 16, 32), d_state=4, drop_path_rate=0.0)
# the contrastive mask variant's pair: no location head, so two stages
# suffice (half JAX's compile of the seven-pass step)
TOY_CC = dict(TOY, depths=(1, 1), dims=(16, 32))
BATCH, SIZE, CUBE, SEED = 2, 64, 32, 0
# the trainers' batch: the mix head's train-mode BatchNorm normalizes each
# feature over the batch, and over 2 samples a feature's variance is often
# of the order of eps, where the normalized value follows each rounding;
# and the clean pass's identity ids are equal rows, whose mean is exact in
# flax only for a power-of-two batch (at 6 its rounding, times
# 1/sqrt(eps), moves the clean embedding by 1e-3)
TRAIN_BATCH = 8
TOL = dict(rtol=1e-5, atol=1e-5)


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
    compiled once each and run a few times."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **TOL, err_msg=msg)


# --- the cube ops and the masked inputs -------------------------------------

@pytest.mark.parametrize("shape,nb", [((3, 8, 12, 2), 4),
                                      ((2, 6, 9, 6, 1), 3)])
def test_cube_ops_match_jax(shape, nb):
    """get_patch_list / unmix_patches / apply_cube_permutation /
    shuffle_within_sample at ranks 2 and 3, JAX's permutations injected."""
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    xt = torch.from_numpy(x)
    rank = len(shape) - 2
    cube = shape[1] // nb
    patches = t_cube.get_patch_list(xt, cube)
    want = j_cube.get_patch_list(jnp.asarray(x), cube)
    np.testing.assert_array_equal(patches.numpy(), np.asarray(want))
    np.testing.assert_array_equal(t_cube.unmix_patches(patches, nb).numpy(),
                                  x)
    perms = np.asarray(j_cube.shuffled_location_labels(
        jax.random.key(1), shape[0], nb ** rank))
    np.testing.assert_array_equal(
        t_cube.shuffle_within_sample(patches, torch.from_numpy(perms)).numpy(),
        np.asarray(j_cube.shuffle_within_sample(want, perms)))
    part, rec = j_cube.cube_shuffle_indices(jax.random.key(2), shape[0], nb,
                                            rank)
    shuffled = t_cube.apply_cube_permutation(
        xt, torch.from_numpy(np.asarray(part)), nb)
    np.testing.assert_array_equal(
        shuffled.numpy(),
        np.asarray(j_cube.apply_cube_permutation(jnp.asarray(x), part, nb)))
    back = t_cube.apply_cube_permutation(
        shuffled, torch.from_numpy(np.asarray(rec)), nb)
    np.testing.assert_array_equal(back.numpy(), x)
    # the port's own draws: a permutation and its inverse
    part2, rec2 = t_cube.cube_shuffle_indices(
        torch.Generator().manual_seed(0), shape[0], nb, rank)
    assert torch.equal(part2.sort(0).values,
                       torch.arange(shape[0]).view(-1, *[1] * rank)
                       .expand_as(part2))
    assert torch.equal(t_cube.apply_cube_permutation(
        t_cube.apply_cube_permutation(xt, part2, nb), rec2, nb), xt)


def test_organ_class_logger_matches_jax():
    got, want = t_cube.OrganClassLogger(5), j_cube.OrganClassLogger(5)
    for labels in ([0, 1, 1, 4], [[2, 2], [3, 0]]):
        got.append_class_list(torch.tensor(labels))
        want.append_class_list(np.asarray(labels))
    got.update_class_dist()
    want.update_class_dist()
    for norm in (False, True):
        np.testing.assert_array_equal(got.get_class_dist(norm),
                                      want.get_class_dist(norm))


def test_masked_inputs_match_jax_with_its_draws():
    """The shuffled and the masked image given JAX's shuffle ids and
    visibility mask; the port's own draws are permutations and a 0/1
    mask."""
    x = np.random.default_rng(3).normal(size=(3, 64, 64, 1)).astype(
        np.float32)
    j_shuf, perms = j_masked.make_shuffled_input(jax.random.key(4),
                                                 jnp.asarray(x), 16)
    j_mask, vis = j_masked.make_masked_input(jax.random.key(5),
                                             jnp.asarray(x), 16, 0.4)
    xt = torch.from_numpy(x)
    shuf, _ = t_masked.make_shuffled_input(
        xt, 16, perms=torch.from_numpy(np.asarray(perms)))
    masked, _ = t_masked.make_masked_input(
        xt, 16, 0.4, vis=torch.from_numpy(np.asarray(vis)))
    np.testing.assert_array_equal(shuf.numpy(), np.asarray(j_shuf))
    np.testing.assert_array_equal(masked.numpy(), np.asarray(j_mask))
    gen = torch.Generator().manual_seed(0)
    _, p = t_masked.make_shuffled_input(xt, 16, gen)
    assert torch.equal(p.sort(1).values, torch.arange(16).expand(3, -1))
    _, v = t_masked.make_masked_input(xt, 16, 0.4, generator=gen)
    assert set(v.unique().tolist()) <= {0.0, 1.0}
    a, b = np.random.default_rng(0).normal(size=(2, 3, 7)).astype(np.float32)
    _close(t_masked.recovery_mse(torch.from_numpy(a), torch.from_numpy(b)),
           j_masked.recovery_mse(a, b))


# --- the model ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mask_model():
    """(JAX model, its init_all variables, the port model with them)."""
    model = JMambaUnetMask(**TOY, scan_impl=JAX_SCAN)
    x = jnp.zeros((BATCH, SIZE, SIZE, 1))
    variables = jax.jit(lambda r, a: model.init(r, a, method="init_all"))(
        jax.random.key(3), x)
    port = MambaUnetMask(**TOY)
    port.load_state_dict(params_from_jax(
        _flat(variables["params"]), like=port.state_dict(),
        batch_stats=_flat(variables["batch_stats"])))
    return model, variables, port


def test_mamba_mask_methods_match_jax(jax_mask_model):
    """Every method in eval mode, from the same weights."""
    model, v, port = jax_mask_model
    port.eval()
    rng = np.random.default_rng(7)
    x = rng.normal(size=(BATCH, SIZE, SIZE, 1)).astype(np.float32)
    xt = torch.from_numpy(x)
    ids = np.stack([rng.permutation(4) for _ in range(BATCH)]).astype(
        np.float32)
    vis = np.array([[1, 0, 1, 1], [0, 1, 1, 1]], np.float32)

    def apply(*args, method=None):
        return jax.jit(lambda vv, *a: model.apply(vv, *a, method=method))(
            v, *args)

    with torch.no_grad():
        seg, emb = port(xt)
        j_seg, j_emb = apply(x, method="__call__")
        _close(seg, j_seg, "seg")
        _close(emb, j_emb, "emb")
        _close(port.forward_prediction_head(emb),
               apply(j_emb, method="forward_prediction_head"), "head")
        feats = port.forward_encoder(xt, torch.from_numpy(ids),
                                     torch.from_numpy(vis))
        j_feats = apply(x, ids, vis, method="forward_encoder")
        assert len(feats) == len(j_feats) == 5
        for i, (a, b) in enumerate(zip(feats, j_feats)):
            _close(a, b, f"feat {i}")
        # the decoder on JAX's features: fp32 noise of the encoder (6e-6
        # of a feature's 1.7) grows to 3e-5 of the logits' 4 through it
        for a, b in zip(port.forward_decoder([torch.from_numpy(np.asarray(f))
                                              for f in j_feats]),
                        apply(j_feats, method="forward_decoder")):
            _close(a, b, "decoder")
        cube = port.forward_encoder(xt[:, :CUBE, :CUBE])  # the resize
        j_cube_feats = apply(x[:, :CUBE, :CUBE], method="forward_encoder")
        _close(cube[-1], j_cube_feats[-1], "cube bottleneck")
        flat = cube[-1].reshape(BATCH, -1)
        loc = port.forward_location(flat)
        assert loc.shape == (BATCH, 4)
        _close(loc, apply(np.asarray(j_cube_feats[-1]).reshape(BATCH, -1),
                          method="forward_location"), "location")
        for pos, mask in ((None, None), (ids, None), (None, vis)):
            got = port.forward_mix_pos_mask(
                xt, *(None if a is None else torch.from_numpy(a)
                      for a in (pos, mask)))
            assert got.shape == (BATCH, 256)
            _close(got, apply(x, pos, mask, method="forward_mix_pos_mask"),
                   f"mix {pos is None} {mask is None}")


def test_mamba_mask_train_mode_and_size_checks(jax_mask_model):
    """Train-mode mix head and location head (batch-statistics BatchNorm)
    with the running statistics they leave; a 96² perturbed input's 9 ids
    into the 64² model raise."""
    model, v, port = jax_mask_model
    port = MambaUnetMask(**TOY)
    port.load_state_dict(params_from_jax(
        _flat(v["params"]), like=port.state_dict(),
        batch_stats=_flat(v["batch_stats"])))
    port.train()
    rng = np.random.default_rng(8)
    x = rng.normal(size=(BATCH, SIZE, SIZE, 1)).astype(np.float32)
    flat = rng.normal(size=(6, 32)).astype(np.float32)

    @jax.jit
    def train_apply(vv, a, f):
        out, upd = model.apply(vv, a, method="forward_mix_pos_mask",
                               deterministic=False, mutable=["batch_stats"])
        loc, upd2 = model.apply({**vv, "batch_stats": upd["batch_stats"]},
                                f, method="forward_location",
                                deterministic=False, mutable=["batch_stats"])
        return out, loc, upd2["batch_stats"]

    j_out, j_loc, j_stats = train_apply(v, x, flat)
    # at init the identity ids' embedding is 0: every sample's clean
    # global vector is the same, and normalizes to exactly 0 (_warm)
    assert not np.asarray(j_out).any()
    with torch.no_grad():
        _close(port.forward_mix_pos_mask(torch.from_numpy(x)), j_out, "mix")
        _close(port.forward_location(torch.from_numpy(flat)), j_loc, "loc")
    want = params_from_jax(_flat(v["params"]), batch_stats=_flat(j_stats))
    for k, t in port.state_dict().items():
        if "running" in k:
            _close(t, want[k].numpy(), k)
    with pytest.raises(ValueError, match="patch_size 64.*96"):
        port.forward_mix_pos_mask(torch.zeros(1, 96, 96, 1),
                                  torch.arange(9.0)[None])


# --- the trainers against the JAX trainers ----------------------------------

def _cfg(cls, **kw):
    return cls(base_lr=1e-3, max_iterations=10, batch_size=TRAIN_BATCH,
               patch_size=(SIZE, SIZE), num_classes=4, eval_every=10**6,
               log_every=1, seed=SEED, **kw)


def _images(n, seed=11):
    r = np.random.default_rng(seed)
    return [r.random((TRAIN_BATCH, SIZE, SIZE, 1), np.float32)
            for _ in range(n)]


def _jax_draws(step, image, rate=0.25):
    """The JAX mask-pretraining step's shuffle ids and visibility mask."""
    r_shuf, r_mask, _ = jax.random.split(
        jax.random.fold_in(jax.random.key(SEED), step), 3)
    _, perms = j_masked.make_shuffled_input(r_shuf, jnp.asarray(image), CUBE)
    _, vis = j_masked.make_masked_input(r_mask, jnp.asarray(image), CUBE,
                                        rate)
    return (torch.from_numpy(np.asarray(perms)),
            torch.from_numpy(np.asarray(vis)))


def _warm(params):
    """``params`` with the position embedding's BatchNorm bias at 1. At
    init both packages' position embedding is exactly 0 for the identity
    ids (equal rows normalize to 0, the Dense biases are 0), so the clean
    pass sees a zero image and its LayerNorms' zero variances scale the
    first update's gradients by 1/sqrt(eps) each (to ~1e11 at this toy
    width, in JAX as in the port): two steps from there compare rounding
    noise, not the steps. With the bias at 1 the embedding is a spatially
    varying map, as after any update."""
    params = flax.core.unfreeze(params)
    bn = params["pos_embed_layer"]["BatchNorm_0"]
    bn["bias"] = jnp.ones_like(bn["bias"])
    return params


class TMaskPretrain(MaskPretrainTrainer):
    def _draws(self, image):
        return _jax_draws(self.step, image.numpy(), self.masked_rate)


@pytest.fixture(scope="module")
def jax_mask_pretrain():
    """JAX's two steps from the warm start: (start, logs of each step, the
    state after step 1, the spread of step 2's losses when the weights
    after step 1 carry 1e-7 relative noise)."""
    trainer = JMaskPretrainTrainer(JMambaUnetMask(**TOY, scan_impl=JAX_SCAN),
                                   _cfg(JTrainConfig),
                                   cube_size=CUBE,
                                   mesh=make_mesh(jax.devices()[:1]))
    trainer.state = trainer.state.replace(params=_warm(trainer.state.params))
    _committed(trainer)  # the warm bias too: one compile serves every step
    start = (_flat(trainer.state.params), _flat(trainer.state.batch_stats))
    logs, after = [], None
    for image in _images(2):
        if after is None:
            first = None
        else:
            first = jax.tree.map(jnp.copy, trainer.state)
        trainer.state, out = trainer._step(trainer.state,
                                           {"image": jnp.asarray(image)})
        logs.append({k: float(v) for k, v in out.items()})
        if after is None:
            after = (_flat(trainer.state.params),
                     _flat(trainer.state.batch_stats))
    noise = np.random.default_rng(0)
    spread = {k: 0.0 for k in logs[1]}
    for _ in range(3):
        noisy = jax.tree.map(jnp.copy, first).replace(params=jax.tree.map(
            lambda a: a * (1 + 1e-7 * noise.standard_normal(a.shape)).astype(
                np.float32), first.params))
        _, out = trainer._step(noisy, {"image": jnp.asarray(_images(2)[1])})
        spread = {k: max(spread[k], abs(float(v) - logs[1][k]))
                  for k, v in out.items()}
    return start, logs, after, spread


def _assert_model(model, params, stats, keys=None):
    """Every tensor (of ``keys``) within 1e-5 of its own max abs (+1e-6):
    the mask models' first update moves some tensors by ~30 (the patch
    embedding's bias, with a LayerNorm after it), whose fp32 rounding
    then exceeds 1e-5 per element."""
    want = params_from_jax(params, batch_stats=stats)
    for k, v in model.state_dict().items():
        # flax keeps no BatchNorm step count
        if (keys is None or k in keys) and "num_batches" not in k:
            w = want[k].numpy()
            err = np.abs(v.detach().numpy() - w).max()
            assert err <= 1e-5 * np.abs(w).max() + 1e-6, (k, err)


def test_two_mask_pretrain_steps_match_the_jax_trainer(jax_mask_pretrain):
    """Step 1: the shuffled, masked and location losses within 1e-5, every
    parameter after the update (the prediction conv, which no loss
    reaches, decayed) and the clean head's BatchNorm statistics as
    :func:`_assert_model` holds them. Step 2 starts
    from weights that equal JAX's to ~1e-8, but its losses move by up to
    2e-4 in JAX itself under 1e-7 relative noise on those weights (the
    train-mode BatchNorms of the heads normalize features whose variance
    over the batch nears eps after one update): step 2's losses are held
    within 5x the largest spread of three such draws measured in this run,
    or 1e-5."""
    (params, stats), want_logs, (params1, stats1), spread = jax_mask_pretrain
    model = MambaUnetMask(**TOY)
    model.load_state_dict(params_from_jax(params, like=model.state_dict(),
                                          batch_stats=stats))
    out_conv = model.decoder.out_conv.weight.detach().clone()
    trainer = TMaskPretrain(model, _cfg(TrainConfig), cube_size=CUBE,
                            device="cpu")
    keys = ("loss_total", "loss_shuffled", "loss_mask", "loss_loc")
    images = _images(2)
    logs = trainer.train_step({"image": torch.from_numpy(images[0])})
    for key in keys:
        np.testing.assert_allclose(float(logs[key]), want_logs[0][key],
                                   **TOL, err_msg=key)
    # the pos-embed and mix-out BatchNorms ran in train mode; the location
    # head's statistics were thrown away
    _assert_model(trainer.model, params1, stats1)
    assert not torch.equal(trainer.model.decoder.out_conv.weight, out_conv)
    logs = trainer.train_step({"image": torch.from_numpy(images[1])})
    for key in keys:
        tol = max(5 * spread[key], 1e-5)
        assert abs(float(logs[key]) - want_logs[1][key]) <= tol, (
            key, float(logs[key]), want_logs[1][key], spread[key])
    assert trainer.step == 2


@pytest.fixture(scope="module")
def jax_cc_mask():
    """One contrastive step of the mask variant on a MambaUnetMask pair,
    with consistency weights that make every term count."""
    trainer = JCCTrainer(JMambaUnetMask(**TOY_CC, scan_impl=JAX_SCAN),
                         _cfg(JTrainConfig),
                         labeled_bs=4, mask_recovery=True,
                         mask_cube_size=CUBE, consistency1=40.0,
                         consistency2=40.0,
                         mesh=make_mesh(jax.devices()[:1]))
    cc = trainer.cc
    cc = cc.replace(s1=cc.s1.replace(params=_warm(cc.s1.params)),
                    s2=cc.s2.replace(params=_warm(cc.s2.params)))
    start = [(_flat(s.params), _flat(s.batch_stats))
             for s in (cc.s1, cc.s2, cc.p3, cc.p4)]
    batch = _cc_batch()
    cc, logs = trainer._cc_step(cc, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    r_s, r_m = jax.random.split(jax.random.split(
        jax.random.fold_in(jax.random.key(SEED), 0), 8)[4])
    weak = jnp.asarray(batch["image_weak"])
    draws = (np.asarray(j_masked.make_shuffled_input(r_s, weak, CUBE)[1]),
             np.asarray(j_masked.make_masked_input(r_m, weak, CUBE)[1]))
    return start, {k: float(v) for k, v in logs.items()}, [
        (_flat(s.params), _flat(s.batch_stats))
        for s in (cc.s1, cc.s2, cc.p3, cc.p4)], (
            _flat(cc.p1_params), _flat(cc.p2_params)), draws


def _cc_batch():
    r = np.random.default_rng(13)
    shape = (TRAIN_BATCH, SIZE, SIZE)
    return {"image_weak": r.random((*shape, 1), np.float32),
            "image_strong": r.random((*shape, 1), np.float32),
            "label_aug": r.integers(0, 4, shape),
            "label": r.integers(0, 4, shape)}


def test_cc_mask_variant_step_matches_the_jax_trainer(jax_cc_mask):
    """The five losses and the recovery term, both models' parameters (the
    heads JAX's model 2 lacks aside), the projectors and their EMA."""
    start, want, after, (p1, p2), draws = jax_cc_mask
    from mamba_unet_torch.models.small_nets import Projectors

    models = []
    for params, stats in start[:2]:
        m = MambaUnetMask(**TOY_CC)
        sd = m.state_dict()
        sd.update(params_from_jax(params, batch_stats=stats))
        m.load_state_dict(sd)
        models.append(m)
    projs = []
    for params, stats in start[2:]:
        p = Projectors(4, 8)
        p.load_state_dict(params_from_jax(params, like=p.state_dict(),
                                          batch_stats=stats))
        projs.append(p)
    trainer = ContrastiveConsistencyTrainer(
        models[0], _cfg(TrainConfig), model2=models[1], labeled_bs=4,
        mask_recovery=True, mask_cube_size=CUBE, consistency1=40.0,
        consistency2=40.0, projectors=tuple(projs), device="cpu")
    trainer._mask_draws = lambda image: tuple(torch.from_numpy(d)
                                              for d in draws)
    logs = trainer.train_step({k: torch.from_numpy(v)
                               for k, v in _cc_batch().items()})
    for key in ("loss_total", "loss_sup", "loss_unsup", "loss_contrast_l",
                "loss_contrast_u", "loss_mask_recovery"):
        np.testing.assert_allclose(float(logs[key]), want[key], **TOL,
                                   err_msg=key)
    for net, (params, stats) in zip((trainer.model, trainer.model2, *projs),
                                    after):
        keys = set(params_from_jax(params, batch_stats=stats))
        _assert_model(net, params, stats, keys)
    for ema, flat in ((trainer.p1, p1), (trainer.p2, p2)):
        want_ema = params_from_jax(flat)
        for k, t in ema.items():
            _close(t, want_ema[k].numpy(), k)


# --- the CLIs ----------------------------------------------------------------

def test_mask_pretrain_through_the_train_and_test_clis(tmp_path,
                                                       monkeypatch):
    """``--method mask_pretrain --model MambaUnetMask`` (toy-sized) on
    phantoms: the loss finite, ``best`` and the periodic checkpoint
    written; ``cli.test --model MambaUnetMask`` serves the snapshot's seg
    head; a model without the heads is refused."""
    import functools

    from mamba_unet_torch.models import mamba_mask

    toy = {k: v for k, v in TOY.items() if k not in ("num_classes",
                                                     "cube_size",
                                                     "patch_size")}
    monkeypatch.setattr(mamba_mask, "MambaUnetMask",
                        functools.partial(MambaUnetMask, **toy))
    snap = tmp_path / "snap"
    common = ["--synthetic", "--device", "cpu", "--patch_size", str(SIZE),
              str(SIZE), "--synthetic_spec", "2", "4", "1", "1", str(SIZE)]
    assert train_cli.main([
        "--method", "mask_pretrain", "--model", "MambaUnetMask",
        "--batch_size", "2", "--max_iterations", "2", "--eval_every", "2",
        "--ckpt_every", "2", "--snapshot_dir", str(snap), *common]) == 0
    names = {p.name for p in snap.iterdir()}
    assert "state_2" in names, names
    model = load_model_snapshot("MambaUnetMask", 4, 1, str(snap),
                                device="cpu", img_size=SIZE)
    assert model.pos_embed_layer.patch_size == SIZE
    cases = t_syn.phantom_acdc(2, 4, 1, 1, SIZE)["test"]
    out = test_cli.run_inference(test_cli.build_parser().parse_args([
        "--model", "MambaUnetMask", "--patch_size", str(SIZE), str(SIZE),
        "--device", "cpu", "--checkpoint", str(snap)]), dataset=cases)
    assert out["per_case"].shape == (1, 3, 3)
    assert np.isfinite(out["per_case"]).all()
    with pytest.raises(ValueError, match="mask heads"):
        train_cli.main(["--method", "mask_pretrain", "--model", "unet",
                        "--batch_size", "2", "--max_iterations", "1",
                        *common])
    with pytest.raises(NotImplementedError, match="magicnet"):
        train_cli.main(["--method", "mask_pretrain", "--mask_recovery",
                        "--model", "MambaUnetMask", *common])
