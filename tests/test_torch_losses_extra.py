"""The port's scribble-supervision losses and the losses the JAX package
exports but no trainer calls, against the JAX package.

* Partial cross-entropy (``ignore_index``) and ``dice_loss_from_labels``
  on scribble targets, a class with no scribbled pixel and an unscribbled
  sample among them: values and gradients.
* ``vat_loss`` (value, and the gradient with respect to the model's
  weights, through the power iteration as ``jax.grad`` differentiates
  it), from the same first direction on both sides; ``weighted_bce_iou_
  loss``, ``loss_sup``, ``loss_diff`` (a value, no gradient) and
  ``focal_loss``; ``utils/sdf.py::compute_sdf``.

Tolerances: 1e-6 (relative and absolute) for values and gradients (fp32
in another summation order); 1e-5 for VAT, whose perturbation is
normalised twice and scaled by 6-10; the signed distance maps exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mamba_unet_torch.objectives import losses as t_loss  # noqa: E402
from mamba_unet_torch.utils.sdf import compute_sdf  # noqa: E402
from mamba_unet_tpu.objectives import losses as j_loss  # noqa: E402
from mamba_unet_tpu.utils import sdf as j_sdf  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _scribble_batch(rng):
    """Logits and scribble labels (4 = unlabeled): class 2 is scribbled
    nowhere, and the second sample nowhere at all."""
    logits = (2 * rng.normal(size=(3, 6, 7, 4))).astype(np.float32)
    label = rng.integers(0, 4, (3, 6, 7))
    label[label == 2] = 3
    label[rng.random(label.shape) < 0.7] = 4
    label[1] = 4
    return logits, label


def _value_and_grad(fn, logits, label):
    x = torch.from_numpy(logits).requires_grad_(True)
    out = fn(x, torch.from_numpy(label))
    out.backward()
    return out.item(), x.grad.numpy()


def test_partial_ce_matches_jax_on_scribbles(rng):
    logits, label = _scribble_batch(rng)
    want, want_g = jax.value_and_grad(
        lambda lo: j_loss.cross_entropy_loss(lo, label, ignore_index=4))(
            jnp.asarray(logits))
    got, got_g = _value_and_grad(
        lambda lo, lab: t_loss.cross_entropy_loss(lo, lab, ignore_index=4),
        logits, label)
    np.testing.assert_allclose(got, float(want), **TOL)
    np.testing.assert_allclose(got_g, np.asarray(want_g), **TOL)
    assert (got_g[label == 4] == 0).all() and np.abs(got_g).max() > 0
    # no scribbled pixel at all: 0, not a division by zero
    none = np.full_like(label, 4)
    assert t_loss.cross_entropy_loss(torch.from_numpy(logits),
                                     torch.from_numpy(none),
                                     ignore_index=4).item() == 0.0


def test_pseudo_label_dice_matches_jax(rng):
    """The Dice of a softmax against a dense pseudo-label in which class 2
    is absent."""
    logits, _ = _scribble_batch(rng)
    pseudo = rng.integers(0, 4, logits.shape[:-1])
    pseudo[pseudo == 2] = 0
    want, want_g = jax.value_and_grad(
        lambda lo: j_loss.dice_loss_from_labels(jax.nn.softmax(lo, -1),
                                                pseudo))(jnp.asarray(logits))
    got, got_g = _value_and_grad(
        lambda lo, lab: t_loss.dice_loss_from_labels(lo.softmax(-1), lab),
        logits, pseudo)
    np.testing.assert_allclose(got, float(want), **TOL)
    np.testing.assert_allclose(got_g, np.asarray(want_g), **TOL)


def test_vat_loss_matches_jax(rng):
    """A linear model (B, H, W, 1) -> (B, H, W, 4): the loss and its
    gradient with respect to the weights, from JAX's first direction."""
    w = rng.normal(size=(1, 4)).astype(np.float32)
    x = rng.normal(size=(2, 8, 8, 1)).astype(np.float32)
    key = jax.random.key(0)
    for ip in (1, 2):
        want, want_g = jax.value_and_grad(
            lambda ww: j_loss.vat_loss(lambda xx: xx @ ww, jnp.asarray(x),
                                       key, ip=ip))(jnp.asarray(w))
        d = np.asarray(jax.random.uniform(key, x.shape, jnp.float32)) - 0.5
        tw = torch.from_numpy(w).requires_grad_(True)
        got = t_loss.vat_loss(lambda xx: xx @ tw, torch.from_numpy(x),
                              ip=ip, d=torch.from_numpy(d))
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_g),
                                   rtol=1e-5, atol=1e-5)
        assert np.abs(tw.grad.numpy()).max() > 0
    # the first direction from a generator: the same draw, the same loss
    fwd = lambda xx: xx @ torch.from_numpy(w)  # noqa: E731
    a, b = (t_loss.vat_loss(fwd, torch.from_numpy(x),
                            generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert a.item() == b.item() and np.isfinite(a.item())


def test_weighted_losses_match_jax(rng):
    p1 = rng.uniform(0.05, 0.95, size=(2, 40, 48)).astype(np.float32)
    p2 = rng.uniform(0.05, 0.95, size=(2, 40, 48)).astype(np.float32)
    m1 = (rng.uniform(size=p1.shape) > 0.6).astype(np.float32)
    m2 = (rng.uniform(size=p1.shape) > 0.4).astype(np.float32)
    t = [torch.from_numpy(a) for a in (p1, p2, m1, m2)]
    cases = (
        ("weighted_bce_iou_loss", (p1, m1)),
        ("loss_sup", (p1, p2, m1, m2)),
        ("loss_diff", (p1, p2)),
    )
    for name, args in cases:
        want = getattr(j_loss, name)(*map(jnp.asarray, args))
        got = getattr(t_loss, name)(*(torch.from_numpy(a) for a in args))
        np.testing.assert_allclose(got.item(), float(want), **TOL,
                                   err_msg=name)
    want_g = jax.grad(lambda a: j_loss.weighted_bce_iou_loss(a, m1))(
        jnp.asarray(p1))
    x = t[0].clone().requires_grad_(True)
    t_loss.weighted_bce_iou_loss(x, t[2]).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), **TOL)
    x = t[0].clone().requires_grad_(True)
    assert not t_loss.loss_diff(x, t[1]).requires_grad


@pytest.mark.parametrize("gamma,alpha", [(2.0, None), (0.0, None),
                                         (1.5, (0.1, 0.2, 0.3, 0.4))])
def test_focal_loss_matches_jax(rng, gamma, alpha):
    logits = (2 * rng.normal(size=(2, 5, 6, 4))).astype(np.float32)
    label = rng.integers(0, 4, (2, 5, 6))
    want, want_g = jax.value_and_grad(
        lambda lo: j_loss.focal_loss(lo, jnp.asarray(label), gamma, alpha))(
            jnp.asarray(logits))
    got, got_g = _value_and_grad(
        lambda lo, lab: t_loss.focal_loss(lo, lab, gamma, alpha), logits,
        label)
    np.testing.assert_allclose(got, float(want), **TOL)
    np.testing.assert_allclose(got_g, np.asarray(want_g), **TOL)


def test_compute_sdf_matches_jax(rng):
    masks = (rng.random((3, 17, 19)) > 0.7).astype(np.uint8)
    masks[1] = 0  # an empty mask
    masks[2, 4:12, 5:14] = 1
    got, want = compute_sdf(masks), j_sdf.compute_sdf(masks)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert (got[1] == 0).all() and got[2].min() == -1.0
    vol = (rng.random((2, 6, 7, 8)) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(compute_sdf(vol), j_sdf.compute_sdf(vol))
