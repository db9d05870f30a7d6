"""The PyTorch port's MagicNet step on ``MambaUnetMask`` against the JAX
trainer.

One ``--mask_recovery`` step of ``MagicNetTrainer`` on
``tests/test_torch_mask.py``'s toy ``MambaUnetMask`` (depths 1, dims
4-32, 64² slices in 32² cubes, batch 8 with 4 labeled, drop path 0), its
position embedding warm as there and its patch embedding's bias drawn
(from the init's zero bias the masked cubes' blank patches are tokens of
exactly 0 through the LayerNorms, whose zero variance scales the first
update by 1/sqrt(eps), in JAX as in the port), JAX's draws handed in: the loss terms,
the consistency weight and the class histogram, every parameter, the
BatchNorm statistics and the EMA after the update, at
``tests/test_torch_mask.py``'s tolerance. The JAX step traces and
compiles for about 90 s, so it has this file to itself.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.models.mamba_mask import MambaUnetMask  # noqa: E402
from mamba_unet_torch.train import TrainConfig  # noqa: E402
from mamba_unet_torch.utils.convert import params_from_jax  # noqa: E402
from mamba_unet_tpu.models.mamba_mask import (  # noqa: E402
    MambaUnetMask as JMambaUnetMask,
)
from mamba_unet_tpu.parallel import make_mesh  # noqa: E402
from mamba_unet_tpu.train import TrainConfig as JTrainConfig  # noqa: E402
from mamba_unet_tpu.train import magicnet as j_magic  # noqa: E402
from test_torch_magicnet import (  # noqa: E402
    CLASS_DIST,
    MASK_BATCH,
    MASK_CUBE,
    MASK_LABELED,
    MASK_SIZE,
    MASK_TOY,
    TMagicNet,
    _batches,
    _cfg,
    _run_jax,
)

# the JAX models' scan: JAX's plain sequential reference (lax.scan), the
# same function as its default chunked XLA route on the CPU, whose trace and
# compile take about twice as long
JAX_SCAN = "ref"
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
    """XLA's cheaper compile while this file runs."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _assert_near(got_sd, want, keys=None):
    """Every tensor (of ``keys``) within 1e-5 of its own max abs (+1e-6),
    as ``tests/test_torch_mask.py`` holds the mask models' updates."""
    for k, w in want.items():
        if keys is not None and k not in keys:
            continue
        w = w.numpy()
        err = np.abs(got_sd[k].detach().numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-6, (k, err)


def test_mask_recovery_step_on_mamba_unet_mask_matches_the_jax_trainer():
    """The loss terms and the consistency weight within 1e-5, the class
    histogram exactly; the parameters, the statistics (every train-mode
    pass throws its own away) and the EMA as :func:`_assert_near`."""
    trainer = j_magic.MagicNetTrainer(
        JMambaUnetMask(**MASK_TOY, scan_impl=JAX_SCAN),
        _cfg(JTrainConfig, MASK_BATCH, MASK_SIZE), labeled_bs=MASK_LABELED,
        cube_size=MASK_CUBE, mask_recovery=True,
        mesh=make_mesh(jax.devices()[:1]))
    params = flax.core.unfreeze(trainer.state.params)
    bn = params["pos_embed_layer"]["BatchNorm_0"]
    bn["bias"] = jnp.ones_like(bn["bias"])
    proj = params["encoder"]["patch_embed"]["proj"]
    proj["bias"] = jnp.asarray(0.02 * np.random.default_rng(5).standard_normal(
        proj["bias"].shape, np.float32))
    trainer.state = trainer.state.replace(
        params=params, ema_params=jax.tree.map(jnp.copy, params))
    start = (_flat(trainer.state.params), _flat(trainer.state.batch_stats))
    batches = _batches(1, MASK_BATCH, MASK_SIZE, seed=12)
    (want,) = _run_jax(trainer, batches, CLASS_DIST)

    model = MambaUnetMask(**MASK_TOY)
    model.load_state_dict(params_from_jax(start[0], like=model.state_dict(),
                                          batch_stats=start[1]))
    port = TMagicNet(model, _cfg(TrainConfig, MASK_BATCH, MASK_SIZE),
                     labeled_bs=MASK_LABELED, cube_size=MASK_CUBE,
                     mask_recovery=True, device="cpu")
    port.dist_logger.class_dist = CLASS_DIST.copy()
    logs = port.train_step({k: torch.from_numpy(v)
                            for k, v in batches[0].items()})
    for key in ("loss_total", "loss_sup", "loss_loc", "loss_cons",
                "loss_recv", "cons_weight"):
        np.testing.assert_allclose(float(logs[key]), float(want[key]), **TOL,
                                   err_msg=key)
    np.testing.assert_array_equal(logs["class_hist"].numpy(),
                                  want["class_hist"])
    want_sd = params_from_jax(_flat(trainer.state.params),
                              batch_stats=_flat(trainer.state.batch_stats))
    # flax keeps no BatchNorm step count
    _assert_near(port.model.state_dict(), want_sd)
    _assert_near(port.ema, params_from_jax(_flat(trainer.state.ema_params)))
