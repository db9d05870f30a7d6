"""Data parallelism of the port's multi-model trainers.

Every trainer of ``mamba_unet_torch.train`` runs 2 steps on 2 CPU
``gloo`` ranks, spawned once for this module (``parallel.launch.Ranks``
running the jobs of ``parallel.checks``, which import no JAX), each rank
handed the global batch and holding its part of each block: a global
batch of 4 with 2 labeled rows puts one labeled and one unlabeled row on
each rank. Each job is held against the same job in this process (one
rank): the losses and every floating leaf of every network and EMA copy
within ``STEP_TOL`` plus 3x the spread of the same one-process job run
with another thread count (fp32 sums in another order; the toys are
ill-conditioned in places), the host state (MagicNet's histogram,
CTAugment's rates) as close, and every rank's weights bitwise equal.
MagicNet's VNet cases run in fp64, where their toys' fp32 rounding would
move leaves by more than their update; the two whose scans take no fp64
are held to a share of each leaf's update: mask pretraining to a fixed
one (``UPDATE_TOL``), MagicNet on MambaUnetMask, the train CLI's 2-D
model, to 3x the share by which the one-process job moves from start
weights one ulp off (``ULP_TWINS``). Dropout
and drop-path are on where the toy has them, so the draws for the global
batch are held too. The cross-teaching
step is also held against JAX's ``CrossTeachingTrainer`` on a 2-device
data mesh (dropout off: JAX draws other bits), at the tolerances of
``tests/test_torch_parallel.py``'s data-parallel steps against JAX.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mamba_unet_torch.parallel.checks import (  # noqa: E402
    EMAS,
    MEMBERS,
    run_jobs,
    train,
)
from mamba_unet_torch.parallel.launch import Ranks  # noqa: E402
from mamba_unet_torch.parallel.mesh import Mesh  # noqa: E402
from mamba_unet_torch.train import methods as t_methods  # noqa: E402
from mamba_unet_torch.train.trainer import TrainConfig  # noqa: E402
from mamba_unet_tpu.models.unet import UNet as JUNet  # noqa: E402
from mamba_unet_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from mamba_unet_tpu.train import TrainConfig as JTrainConfig  # noqa: E402
from mamba_unet_tpu.train import methods as j_methods  # noqa: E402

from test_torch_parallel import _flat, _unet_weights  # noqa: E402
from test_torch_train import _committed  # noqa: E402

STEP_TOL = dict(rtol=1e-5, atol=1e-5)
FT = (4, 8, 16, 32, 64)
NO_DROP = (0.0,) * 5
TOY_VIM = dict(depths=(1, 1), dims=(16, 32))
# tests/test_torch_mask.py's toy MambaUnetMask, and its two-stage pair
MASK_TOY = dict(num_classes=4, cube_size=32, patch_size=64,
                depths=(1, 1, 1, 1), dims=(4, 8, 16, 32), d_state=4,
                drop_path_rate=0.1)
MASK_PAIR = dict(MASK_TOY, depths=(1, 1), dims=(16, 32))
CFG = dict(base_lr=0.05, max_iterations=10, batch_size=4,
           patch_size=(32, 32), num_classes=4, eval_every=10 ** 6,
           log_every=1, seed=0)
SEMI = dict(labeled_bs=2, consistency=30.0)
CLASS_DIST = np.array([30.0, 20.0, 10.0, 5.0])

TRAIN = "mamba_unet_torch.train"
REGISTRY = ("mamba_unet_torch.models.registry", "net_factory")


def unet(seed, **kw):
    return ((*REGISTRY, dict(net_type="unet", num_classes=4, ft_chns=FT,
                             **kw)), None, seed)


def vim(seed):
    return ((*REGISTRY, dict(net_type="ViM_seg", num_classes=4,
                             drop_path_rate=0.3, **TOY_VIM)), None, seed)


def reg(seed, name, **kw):
    return ((*REGISTRY, dict(net_type=name, **kw)), None, seed)


def warm(seed, name, **kw):
    """A mask model warm-started (``parallel.checks.warm_model``: its
    position embedding's BatchNorm bias at 1, its patch embedding's bias
    drawn)."""
    return (("mamba_unet_torch.parallel.checks", "warm_model",
             dict(net_type=name, bias_seed=seed + 100, **kw)), None, seed)


def _batches(n, bsz=4, size=32, seed=11, rank=2, classes=4, **extra):
    """``n`` global batches of ``image`` (B, size^rank, 1) and ``label``;
    ``extra`` {key: "image" | "label" | "onehot"} adds more of a kind."""
    r = np.random.default_rng(seed)
    shape = (bsz,) + (size,) * rank
    out = []
    for _ in range(n):
        b = {"image": r.random(shape + (1,), np.float32),
             "label": r.integers(0, classes, shape)}
        for key, kind in extra.items():
            b[key] = (r.random(shape + (1,), np.float32) if kind == "image"
                      else r.integers(0, classes, shape) if kind == "label"
                      else np.eye(4, dtype=np.float32)[
                          r.integers(0, 4, shape)] * 0.8 + 0.05)
        out.append(b)
    return out


def _case(first, cls, config=None, members=None, batches=None, **kw):
    builder, weights, seed = first
    return dict(builder=builder, weights=weights, seed=seed,
                config=dict(CFG, **(config or {})),
                batches=batches or _batches(2),
                method=(f"{TRAIN}.{cls[0]}", cls[1]),
                members=members or {}, **kw)


# name: the job's arguments; each runs 2 steps on 2 ranks and here
CASES = {
    "cross_teaching": _case(
        vim(1), ("methods", "CrossTeachingTrainer"),
        members={"model2": unet(2)}, method_kw=SEMI),
    "mean_teacher": _case(
        unet(3), ("methods", "MeanTeacherTrainer"),
        method_kw=dict(SEMI, warmup_iters=0)),
    # k = 2: each microbatch's blocks of 2 + 2 rows, one per rank each
    "mean_teacher_k2": _case(
        unet(3), ("methods", "MeanTeacherTrainer"),
        config=dict(batch_size=8, grad_accum_steps=2),
        batches=_batches(2, bsz=8),
        method_kw=dict(labeled_bs=4, consistency=30.0, warmup_iters=0)),
    "uamt": _case(unet(4), ("methods", "UAMTTrainer"), method_kw=SEMI),
    "weak_scribble": _case(
        unet(5), ("weak", "WeakScribbleTrainer"),
        members={"model2": vim(6), "model3": unet(7)},
        batches=_batches(2, classes=5)),
    "contrastive_consistency": _case(
        unet(8), ("contrastive_cc", "ContrastiveConsistencyTrainer"),
        members={"model2": unet(9)},
        batches=_batches(2, image_weak="image", image_strong="image",
                         label_aug="label"),
        method_kw=dict(labeled_bs=2, consistency1=40.0)),
    "contrastive_mask_recovery": _case(
        warm(10, "MambaUnetMask", **MASK_PAIR),
        ("contrastive_cc", "ContrastiveConsistencyTrainer"),
        config=dict(patch_size=(64, 64)),
        members={"model2": warm(11, "MambaUnetMask", **MASK_PAIR)},
        batches=_batches(2, size=64, image_weak="image",
                         image_strong="image", label_aug="label"),
        method_kw=dict(labeled_bs=2, consistency1=40.0, mask_recovery=True,
                       mask_cube_size=32)),
    "mask_pretrain": _case(
        warm(12, "MambaUnetMask", **MASK_TOY),
        ("mask_pretrain", "MaskPretrainTrainer"),
        config=dict(patch_size=(64, 64)), batches=_batches(2, size=64),
        method_kw=dict(cube_size=32)),
    "magicnet_2d": _case(
        reg(13, "magicnet_2D", num_classes=4, n_filters=3, cube_size=16,
            patch_size=32),
        ("magicnet", "MagicNetTrainer"), class_dist=CLASS_DIST,
        dtype="float64",
        method_kw=dict(labeled_bs=2, cube_size=16, blend_after=0)),
    "magicnet_mask_recovery": _case(
        warm(14, "magicnet_2D_mask", num_classes=4, n_filters=3,
             cube_size=16, patch_size=32),
        ("magicnet", "MagicNetTrainer"), class_dist=CLASS_DIST,
        dtype="float64",
        method_kw=dict(labeled_bs=2, cube_size=16, blend_after=0,
                       mask_recovery=True)),
    # the train CLI's 2-D MagicNet: MambaUnetMask, with mask recovery
    "magicnet_mamba_mask": _case(
        warm(20, "MambaUnetMask", **MASK_TOY),
        ("magicnet", "MagicNetTrainer"), class_dist=CLASS_DIST,
        config=dict(patch_size=(64, 64)), batches=_batches(2, size=64),
        method_kw=dict(labeled_bs=2, cube_size=32, blend_after=0,
                       mask_recovery=True)),
    "magicnet_3d": _case(
        reg(15, "magicnet", num_classes=4, n_filters=2, cube_size=16,
            patch_size=32),
        ("magicnet", "MagicNetTrainer"), class_dist=CLASS_DIST,
        dtype="float64",
        config=dict(patch_size=(32, 32, 32)), batches=_batches(2, rank=3),
        method_kw=dict(labeled_bs=2, cube_size=16, blend_after=0)),
    "mad_pretrain": _case(
        unet(16, in_chans=4), ("mad", "MADPretrainTrainer"),
        batches=[dict(b, image=b.pop("mask_label")) for b in
                 _batches(2, mask_label="onehot")]),
    "mad_finetune": _case(
        unet(17), ("mad", "MADFineTuneTrainer"),
        members={"mad_model": unet(18, in_chans=4),
                 "den_model": unet(19, in_chans=4)},
        batches=_batches(2, mask_label="onehot")),
}
# the one toy whose fp32 step is too ill-conditioned for STEP_TOL and has
# no fp64 route (the scan kernels take fp32 and bf16): the mask model's
# mix head normalizes over the 4 rows of the batch, whose features' variance
# can near eps (tests/test_torch_mask.py trains at batch 8 for it). On 2
# ranks its step-1 losses agree to 1e-6, its weights to 4.2e-4 of their
# update after step 1 and 0.8 % after step 2; its leaves are held to this
# share of their update (floored at 1e-3 of the largest), its losses to
# 1e-4
UPDATE_TOL = {"mask_pretrain": 5e-2}
# the toy held to its own drift instead of a thread count's: MagicNet's
# mask recovery on MambaUnetMask runs its three mix heads' BatchNorms over
# the 4 rows. Started from weights one ulp off (parallel.checks.train's
# ulp twins), the one-process job moves its losses by up to 6.1e-4 and
# its leaves by up to 6.5 % of their two-step update (4 twins), 2 ranks by
# 7.2e-4 and 9.6 %; another thread count moves almost none of it. Over
# this many twins: its losses are held within STEP_TOL plus 3x their
# largest distance, its leaves within 3x the largest share of its update
# by which a twin moved a leaf
ULP_TWINS = {"magicnet_mamba_mask": 4}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def fast_jax_compiles():
    """XLA's cheaper compile while this file runs (the JAX reference is
    compile-bound)."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _jax_cross_teaching():
    """JAX's CrossTeachingTrainer (two UNets, BatchNorm, dropout off) on
    a 2-device data mesh: its start weights, and a function that runs its
    two steps and returns (losses, weights of both models)."""
    model = JUNet(num_classes=4, ft_chns=FT, dropout=NO_DROP)
    trainer = j_methods.CrossTeachingTrainer(
        model, JTrainConfig(**CFG), mesh=j_make_mesh(jax.devices()[:2]),
        **SEMI)
    start = [(_flat(s.params), _flat(s.batch_stats))
             for s in (trainer.cross.s1, trainer.cross.s2)]

    def run():
        result = _committed(trainer).fit(_batches(2))
        return ([h["loss"] for h in result["history"]],
                [(_flat(s.params), _flat(s.batch_stats))
                 for s in (trainer.cross.s1, trainer.cross.s2)])

    return start, run


@pytest.fixture(scope="module")
def runs():
    """(the 2 ranks' results, this process's, JAX's cross-teaching run
    and the port's start weights for it), by case name; the ranks run
    while this process computes the references."""
    start, jax_run = _jax_cross_teaching()
    weights = [{k: v.numpy() for k, v in _unet_weights(*s).items()}
               for s in start]
    builder = (*REGISTRY, dict(net_type="unet", num_classes=4, ft_chns=FT,
                               dropout=NO_DROP))
    cases = dict(CASES, jax_cross_teaching=_case(
        (builder, weights[0], 0), ("methods", "CrossTeachingTrainer"),
        members={"model2": (builder, weights[1], 0)}, method_kw=SEMI))
    names = list(cases)
    ranks = Ranks(2, run_jobs, "cpu", [("train", cases[n]) for n in names])
    jax_side = jax_run()
    cpu = torch.device("cpu")
    one = {n: train(cpu, **cases[n], start=True,
                    ulp_twins=ULP_TWINS.get(n, 0)) for n in CASES}
    # the same jobs in another fp32 order: their spread
    torch.set_num_threads(2)
    try:
        other = {n: train(cpu, **cases[n]) for n in CASES
                 if n not in ULP_TWINS}
    finally:
        torch.set_num_threads(1)
    got = ranks.result(timeout=600)
    return ({n: [r[i] for r in got] for i, n in enumerate(names)}, one,
            other, jax_side)


def _spread(other, want):
    return float(np.abs(np.asarray(other) - np.asarray(want)).max())


def _assert_near(what, got, want, spread):
    """``got`` within STEP_TOL of ``want`` plus 3x the spread of the
    one-process job: its distance from the same job run with 2 intra-op
    threads, or from its ulp twins (``ULP_TWINS``). The toys' gradients
    are ill-conditioned in places (BatchNorm over 2 rows of 2x2 maps, the
    instance norms of the VNets, the mask heads; ROADMAP §3), and there a
    thread count moves a leaf by up to 42 % of its two-step update."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    tol = STEP_TOL["atol"] + STEP_TOL["rtol"] * np.abs(want) + 3 * spread
    assert (err <= tol).all(), (what, float(err.max()), spread)


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_one_process(runs, name):
    """Losses, every network's and EMA copy's floating state and the host
    state after 2 steps on 2 ranks against one process; both ranks'
    weights bitwise equal, and every network and EMA copy moved."""
    ranks, one, other, _ = runs
    got, want = ranks[name][0], one[name]
    twin = want.get("twin")
    if name in UPDATE_TOL:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    else:
        _assert_near("losses", got["losses"], want["losses"],
                     twin["loss_spread"] if twin else
                     _spread(other[name]["losses"], want["losses"]))
    assert set(got["state"]) == set(want["state"])
    nets, moved = set(), set()
    moves = want["moved"]
    floor = 1e-3 * max(moves.values())
    share = UPDATE_TOL.get(name)
    if twin is not None:  # 3x the largest share a twin moved a leaf by
        share = 3 * max(twin["spread"][k] / max(moves[k], floor)
                        for k in moves)
    for k, w in want["state"].items():
        if share is not None:
            err = np.abs(got["state"][k] - w).max()
            assert err <= share * max(moves[k], floor), (k, err, share)
        else:
            _assert_near(k, got["state"][k], w,
                         _spread(other[name]["state"][k], w))
        np.testing.assert_array_equal(ranks[name][1]["state"][k],
                                      got["state"][k], err_msg=k)
        net = k.split(".")[0] if k.startswith(MEMBERS + EMAS) else ""
        nets.add(net)
        if moves[k] > 0:
            moved.add(net)
    assert moved == nets
    assert set(got["host"]) == set(want["host"])
    for k, w in want["host"].items():
        np.testing.assert_array_equal(ranks[name][1]["host"][k],
                                      got["host"][k], err_msg=k)
        if k == "hist":  # near-tie argmaxes of the blend may flip
            assert np.abs(got["host"][k] - w).max() <= 1e-4 * w.sum()
        else:
            np.testing.assert_allclose(got["host"][k], w, rtol=1e-5,
                                       err_msg=k)


def test_cross_teaching_on_two_ranks_matches_the_jax_trainer(runs):
    """The port's 2 ranks against JAX's CrossTeachingTrainer on a 2-device
    data mesh from the same weights: losses 1e-5, both models' weights
    and BatchNorm statistics 1e-4 (JAX's own 2-device step differs from
    its one-device step by ~4e-5 on these weights)."""
    ranks, _, _, (want_losses, want) = runs
    got = ranks["jax_cross_teaching"][0]
    np.testing.assert_allclose(got["losses"], want_losses, **STEP_TOL)
    for prefix, (params, stats) in zip(("", "model2."), want):
        for k, w in _unet_weights(params, stats, steps=2).items():
            if w.is_floating_point():
                np.testing.assert_allclose(got["state"][prefix + k],
                                           w.numpy(), rtol=1e-5, atol=1e-4,
                                           err_msg=prefix + k)


@pytest.mark.parametrize("cls,kw,rows", [
    (t_methods.CrossTeachingTrainer, dict(labeled_bs=3), 3),
    (t_methods.MeanTeacherTrainer,
     dict(labeled_bs=2, config=dict(batch_size=8, grad_accum_steps=2)), 1)])
def test_a_block_that_does_not_split_over_the_ranks_raises(cls, kw, rows):
    """Before the first step: 3 labeled rows over 2 ranks; mean teacher's
    microbatch of 1 labeled row (k = 2) over 2 ranks."""
    two = Mesh(("data",), (2,), 0, {"data": None})
    cfg = TrainConfig(**dict(CFG, **kw.pop("config", {})))
    from mamba_unet_torch.models.unet import UNet

    members = ({"model2": UNet(num_classes=4, ft_chns=FT)}
               if cls is t_methods.CrossTeachingTrainer else {})
    with pytest.raises(ValueError,
                       match=f"a block of {rows} rows does not split over "
                             f"2 data ranks"):
        cls(UNet(num_classes=4, ft_chns=FT), cfg, device="cpu", mesh=two,
            **members, **kw)
