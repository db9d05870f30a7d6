"""The port's CUDA kernels on a card (marker ``cuda``; skipped without one).

This file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_kernel.py -m cuda

(``--noconftest`` because ``tests/conftest.py`` imports JAX.) Each kernel is
held against its plain PyTorch version on the same card: both read the same
values, only the fp32 summation order differs. The serving forward is held
at 1e-4. The training kernels are held at 1e-4 of the reference's max abs
for per-element outputs and 1e-3 for dA/dD/ddelta_bias, which sum over
batch and time; a bf16 gradient may also differ by one bf16 rounding step,
since both versions round an fp32 sum to bf16 (``utils/compare.py``, the
rule ``chip_smoke.py`` applies too). The unidirectional grouped forward
(y and the final state) is held to the same rule at 1e-4, and its training
pair (state-saving forward, backward) as the bidirectional one; so are the
batch-folded kernels (serving forward, state-saving forward, backward).
The grouped and folded cases include an odd dg, ragged L against the
forwards' 32-step chunks and 16-step state chunks, and views one element
into their buffer (no 16-byte alignment), which the kernels meet with
single-value copies.
"""

import pytest

torch = pytest.importorskip("torch")

from mamba_unet_torch.ops.selective_scan_bidir import (  # noqa: E402
    ARG_NAMES,
    selective_scan_bidir,
    selective_scan_bidir_bwd,
    selective_scan_bidir_bwd_ref,
    selective_scan_bidir_fwd_states,
    selective_scan_bidir_ref,
    selective_scan_bidir_states_ref,
)
from mamba_unet_torch.utils.compare import (  # noqa: E402
    ZERO_GRAD_REL,
    assert_close_to_max,
    batchnorm_fed_biases,
)

# (L, dg) of SS2D's scan at the four stages of the 224² model
STAGES = [(3136, 192), (784, 384), (196, 768), (49, 1536)]
SUMMED = ("A", "D", "delta_bias")  # gradients summed over batch and time


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _args(bsz, L, dg, n=16, seed=0):
    """A drawn per (channel, state) and D per channel, neither an integer,
    so that a kernel reading another channel's row, or a shortcut such as
    powers of exp(-delta) that integer A would allow, disagrees."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(bsz, 2, L, dg, generator=g),
            0.5 * torch.randn(bsz, 4, L, dg, generator=g),
            -torch.exp(0.5 * torch.randn(4 * dg, n, generator=g)),
            torch.randn(bsz, 4, L, n, generator=g),
            torch.randn(bsz, 4, L, n, generator=g),
            torch.randn(4 * dg, generator=g),
            torch.empty(4 * dg).uniform_(-6, -2, generator=g)]


# (batch, L, dg) beyond the stage shapes: dg not a multiple of the kernels'
# 16-channel tile, L not a multiple of their 16- and 32-step chunks (with an
# odd and an even chunk count, so that the pair merge meets both in a middle
# chunk and not), L = 1, and batch 1
EDGES = [(2, 50, 40), (2, 64, 64), (2, 7, 130), (1, 1, 40), (1, 97, 33),
         (1, 33, 70)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz,L,dg", EDGES)
def test_kernel_matches_plain_version(cuda, dtype, bsz, L, dg):
    """The serving kernel at the edge shapes."""
    args = [a.to(cuda) for a in _args(bsz, L, dg)]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(getattr(torch, dtype))
    before = selective_scan_bidir.launches
    got = selective_scan_bidir(*args)
    torch.cuda.synchronize()
    assert selective_scan_bidir.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (bsz, 2, L, dg)
    torch.testing.assert_close(got, selective_scan_bidir_ref(*args),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["noncontiguous", "mixed_devices", "d_state"])
def test_kernel_wrapper_raises_instead_of_falling_back(cuda, bad):
    n = 8 if bad == "d_state" else 16
    args = [a.to(cuda) for a in _args(1, 16, 32, n=n)]
    if bad == "noncontiguous":
        args[0] = args[0].transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "mixed_devices":
        args[5] = args[5].cpu()
    before = selective_scan_bidir.launches
    with pytest.raises(ValueError):
        selective_scan_bidir(*args)
    assert selective_scan_bidir.launches == before


@pytest.mark.cuda
def test_ss2d_on_card_matches_cpu(cuda):
    from mamba_unet_torch.nn.ss2d import SS2D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = SS2D(32, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 12, 10, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = m(x)
        before = selective_scan_bidir.launches
        got = m.to(cuda)(x.to(cuda)).cpu()
    assert selective_scan_bidir.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz,L,dg",
                         EDGES + [(2, L, dg) for L, dg in STAGES])
def test_training_kernels_match_plain_versions(cuda, dtype, bsz, L, dg):
    """The state-saving forward (y and cs) and the backward (all seven
    gradients), at the edge shapes and the four stage shapes."""
    args = [a.to(cuda) for a in _args(bsz, L, dg, seed=L + dg)]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(getattr(torch, dtype))
    before = (selective_scan_bidir_fwd_states.launches,
              selective_scan_bidir_bwd.launches)
    y, cs = selective_scan_bidir_fwd_states(*args)
    y_ref, cs_ref = selective_scan_bidir_states_ref(*args)
    assert_close_to_max(y, y_ref, 1e-4, "y")
    assert_close_to_max(cs, cs_ref, 1e-4, "cs")
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(3)
                     ).to(cuda)
    got = selective_scan_bidir_bwd(*args, cs, gy)
    torch.cuda.synchronize()
    assert (selective_scan_bidir_fwd_states.launches,
            selective_scan_bidir_bwd.launches) == (before[0] + 1,
                                                   before[1] + 1)
    want = selective_scan_bidir_bwd_ref(*args, gy)
    for name, g, w in zip(ARG_NAMES, got, want):
        assert_close_to_max(g, w, 1e-3 if name in SUMMED else 1e-4,
                            f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bidir_kernels_are_deterministic(cuda, dtype):
    """Two launches on the same inputs give bitwise equal outputs: the
    serving forward, the state-saving forward (y and cs) and the backward
    (all seven gradients). The kernels merge direction pairs and reduce
    partial sums in a fixed order, with no atomics."""
    args = [a.to(cuda) for a in _args(2, 97, 70, seed=11)]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(getattr(torch, dtype))
    gy = torch.randn(2, 2, 97, 70, generator=torch.Generator().manual_seed(4)
                     ).to(cuda)
    runs = []
    for _ in range(2):
        y, cs = selective_scan_bidir_fwd_states(*args)
        runs.append([selective_scan_bidir(*args), y, cs,
                     *selective_scan_bidir_bwd(*args, cs, gy)])
    for k, (a, b) in enumerate(zip(*runs)):
        assert torch.equal(a, b), k


@pytest.mark.cuda
def test_autograd_on_card_matches_cpu(cuda):
    """``loss.backward()`` through ``selective_scan_bidir``: the training
    kernels on the card against the plain versions on the CPU."""
    cpu_args = _args(2, 50, 40, seed=5)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [a.to(dev).clone().requires_grad_() for a in cpu_args]
        before = selective_scan_bidir.launches
        out = selective_scan_bidir(*leaves)
        (out * out.detach().sin()).sum().backward()
        assert selective_scan_bidir.launches == before  # not the serving one
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    for name, g, w in zip(ARG_NAMES, grads[str(cuda)], grads["cpu"]):
        assert_close_to_max(g, w, 1e-3 if name in SUMMED else 1e-4,
                            f"d{name}")


def _offset(args, k):
    """``args`` with u, delta, B and C moved ``k`` elements into a buffer of
    their own: contiguous views whose data pointers lose the 16-byte (and,
    for odd k in bf16, the 4-byte) alignment."""
    out = list(args)
    for i in (0, 1, 3, 4) if k else ():
        t = args[i]
        buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
        out[i] = buf[k:].view(t.shape)
        out[i].copy_(t)
    return out


def _grouped_args(bsz, G, L, dg, dtype, n=16, seed=0):
    """A and D differ in every channel (and A in every state), so that a
    kernel reading the wrong channel's or group's row disagrees."""
    g = torch.Generator().manual_seed(seed)
    args = [torch.randn(bsz, G, L, dg, generator=g),
            0.5 * torch.randn(bsz, G, L, dg, generator=g),
            -torch.exp(0.5 * torch.randn(G * dg, n, generator=g)),
            torch.randn(bsz, G, L, n, generator=g),
            torch.randn(bsz, G, L, n, generator=g),
            torch.randn(G * dg, generator=g),
            torch.empty(G * dg).uniform_(-6, -2, generator=g)]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(getattr(torch, dtype))
    return args


# (G, L, dg, offset) of the grouped serving kernel's checks at batch 2:
# ragged L and dg, G = 4 groups, the mamba-130m width, an odd dg (its last
# group one channel wide), L = 1, L = 17 and 33 (a partial 32-step chunk
# holding a full 16-step state chunk, and one step past a full chunk), and
# views one element into their buffer
GROUPED_SHAPES = [(1, 50, 40, 0), (1, 7, 130, 0), (4, 257, 192, 0),
                  (1, 1000, 1536, 0), (1, 1, 129, 0), (1, 17, 129, 0),
                  (2, 33, 64, 0), (2, 33, 64, 1), (1, 17, 130, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,L,dg,offset", GROUPED_SHAPES)
def test_grouped_kernel_matches_plain_version(cuda, dtype, G, L, dg, offset):
    """Kernel #3 and its final state against the plain version at
    GROUPED_SHAPES, bf16 too; the same rule as the training kernels."""
    from mamba_unet_torch.ops.selective_scan_grouped import (
        selective_scan_grouped,
        selective_scan_grouped_ref,
    )

    args = _offset([a.to(cuda) for a in _grouped_args(2, G, L, dg, dtype,
                                                      seed=L)], offset)
    before = selective_scan_grouped.launches
    y, last = selective_scan_grouped(*args, True, True)
    torch.cuda.synchronize()
    assert selective_scan_grouped.launches == before + 1
    y_ref, last_ref = selective_scan_grouped_ref(*args, True, True)
    assert_close_to_max(y, y_ref, 1e-4, "y")
    assert_close_to_max(last, last_ref, 1e-4, "last state")
    only_y = selective_scan_grouped(*args, True, False)
    assert torch.equal(only_y, y)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["noncontiguous", "mixed_devices", "d_state"])
def test_grouped_kernel_wrapper_raises_instead_of_falling_back(cuda, bad):
    from mamba_unet_torch.ops.selective_scan_grouped import (
        selective_scan_grouped,
    )

    n = 8 if bad == "d_state" else 16
    args = [a.to(cuda) for a in _grouped_args(1, 1, 16, 32, "float32", n=n)]
    if bad == "noncontiguous":
        args[0] = args[0].transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "mixed_devices":
        args[5] = args[5].cpu()
    before = selective_scan_grouped.launches
    with pytest.raises(ValueError):
        selective_scan_grouped(*args)
    assert selective_scan_grouped.launches == before


@pytest.mark.cuda
def test_mamba_lm_on_card_matches_cpu(cuda):
    """A toy LM's logits, prefill and decode step on the card against the
    same weights on the CPU: one kernel launch per layer in a forward and
    in a prefill, none in a decode step."""
    from mamba_unet_torch.models.mamba_lm import MambaLMHeadModel
    from mamba_unet_torch.ops.selective_scan_grouped import (
        selective_scan_grouped,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = MambaLMHeadModel(100, 32, 2,
                           generator=torch.Generator().manual_seed(0)).eval()
    card = MambaLMHeadModel(100, 32, 2, device=cuda).eval()
    card.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, 100, (2, 37),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        before = selective_scan_grouped.launches
        got = card(ids.to(cuda))
        assert selective_scan_grouped.launches == before + 2
        torch.testing.assert_close(got.cpu(), cpu(ids), rtol=1e-4, atol=1e-4)
        logits, caches = card.prefill(ids.to(cuda))
        want, want_caches = cpu.prefill(ids)
        assert selective_scan_grouped.launches == before + 4
        torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)
        for g, w in zip(caches, want_caches):
            for gs, ws in zip(g, w):
                torch.testing.assert_close(gs.cpu(), ws, rtol=1e-4,
                                           atol=1e-4)
        token = torch.tensor([5, 99])
        logits, _ = card.decode_step(token.to(cuda), caches)
        assert selective_scan_grouped.launches == before + 4
        torch.testing.assert_close(logits.cpu(),
                                   cpu.decode_step(token, want_caches)[0],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_selective_scan_dispatcher_on_card_matches_cpu(cuda):
    """The public (B, D, L) ``selective_scan`` with grouped B/C, z and the
    last state: the kernel on the card against the plain loop on the CPU
    (fp32: with bf16 the card rounds y before the z gate, as the JAX
    package's kernel path does, and the plain loop after it)."""
    from mamba_unet_torch.ops.selective_scan import selective_scan
    from mamba_unet_torch.ops.selective_scan_grouped import (
        selective_scan_grouped,
    )

    g = torch.Generator().manual_seed(7)
    bsz, G, dg, L, n = 2, 2, 40, 33, 16
    args = [torch.randn(bsz, G * dg, L, generator=g),
            0.5 * torch.randn(bsz, G * dg, L, generator=g),
            -torch.exp(0.5 * torch.randn(G * dg, n, generator=g)),
            torch.randn(bsz, G, n, L, generator=g),
            torch.randn(bsz, G, n, L, generator=g),
            torch.randn(G * dg, generator=g),
            torch.randn(bsz, G * dg, L, generator=g),
            torch.empty(G * dg).uniform_(-6, -2, generator=g)]
    want_y, want_last = selective_scan(*args, delta_softplus=True,
                                       return_last_state=True)
    before = selective_scan_grouped.launches
    y, last = selective_scan(*(a.to(cuda) for a in args),
                             delta_softplus=True, return_last_state=True)
    torch.cuda.synchronize()
    assert selective_scan_grouped.launches == before + 1
    assert_close_to_max(y.cpu(), want_y, 1e-4, "y")
    assert_close_to_max(last.cpu(), want_last, 1e-4, "last state")


# (G, L, dg, offset) of the grouped training kernels' checks at batch 2:
# the four SS2D stage shapes of the tm branch (G = 4), the mamba-130m width
# over a long L, a ragged L and dg with a partial last 16-step chunk, an odd
# dg (bf16 loaded by single values, the entry states by 4-byte copies),
# L = 1, 17 and 33 against the forward's 32-step chunks, and views one
# element into their buffer
TM_SHAPES = [(4, L, dg, 0) for L, dg in STAGES] + [
    (1, 1000, 1536, 0), (1, 7, 130, 0), (1, 7, 129, 0), (1, 1, 129, 0),
    (1, 17, 129, 0), (2, 33, 48, 0), (2, 33, 48, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,L,dg,offset", TM_SHAPES)
def test_grouped_training_kernels_match_plain_versions(cuda, dtype, G, L, dg,
                                                       offset):
    """The grouped state-saving forward (y and cs) and backward (all seven
    gradients) against their plain versions, batch 2, the rule of the
    bidirectional training kernels."""
    from mamba_unet_torch.ops import selective_scan_grouped as sg

    args = _offset([a.to(cuda) for a in _grouped_args(2, G, L, dg, dtype,
                                                      seed=L + dg)], offset)
    before = (sg.selective_scan_grouped_fwd_states.launches,
              sg.selective_scan_grouped_bwd.launches)
    y, cs = sg.selective_scan_grouped_fwd_states(*args)
    y_ref, cs_ref = sg.selective_scan_grouped_states_ref(*args)
    assert_close_to_max(y, y_ref, 1e-4, "y")
    assert_close_to_max(cs, cs_ref, 1e-4, "cs")
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(3)
                     ).to(cuda, y.dtype)
    got = sg.selective_scan_grouped_bwd(*args, cs, gy)
    torch.cuda.synchronize()
    assert (sg.selective_scan_grouped_fwd_states.launches,
            sg.selective_scan_grouped_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    want = sg.selective_scan_grouped_bwd_ref(*args, gy)
    for name, g, w in zip(sg.ARG_NAMES, got, want):
        assert_close_to_max(g, w, 1e-3 if name in SUMMED else 1e-4,
                            f"d{name}")


@pytest.mark.cuda
def test_mamba_gradients_on_card_match_cpu(cuda):
    """``loss.backward()`` through a small bimamba-v2 ``Mamba``: every
    parameter gets a gradient on the card (the scan side too: conv1d*,
    x_proj*, dt_proj*, A*_log, D*), equal to the CPU copy's; the scan runs
    the grouped training kernels, never the serving one. Each gradient is
    held at 1e-3 of its max: sums over batch and time through stock layers
    and the scan in another order."""
    from mamba_unet_torch.nn.mamba1d import Mamba
    from mamba_unet_torch.ops import selective_scan_grouped as sg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = Mamba(32, bimamba_type="v2",
                generator=torch.Generator().manual_seed(0))
    card = Mamba(32, bimamba_type="v2", device=cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 37, 32, generator=torch.Generator().manual_seed(1))
    before = (sg.selective_scan_grouped.launches,
              sg.selective_scan_grouped_fwd_states.launches,
              sg.selective_scan_grouped_bwd.launches)
    for m, dev in ((cpu, "cpu"), (card, cuda)):
        out = m(x.to(dev))
        (out * out.detach().sin()).sum().backward()
    torch.cuda.synchronize()
    assert (sg.selective_scan_grouped.launches,
            sg.selective_scan_grouped_fwd_states.launches,
            sg.selective_scan_grouped_bwd.launches) == (
        before[0], before[1] + 2, before[2] + 2)
    for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
        assert p.grad is not None, f"{name} got no gradient on the card"
        assert_close_to_max(p.grad.cpu(), q.grad, 1e-3, name)


@pytest.mark.cuda
def test_selective_scan_dispatcher_gradients_on_card_match_cpu(cuda):
    """``backward()`` through the public (B, D, L) ``selective_scan`` on the
    card (the grouped training kernels) against the plain loop's autograd
    on the CPU: all eight gradients."""
    from mamba_unet_torch.ops.selective_scan import selective_scan
    from mamba_unet_torch.ops import selective_scan_grouped as sg

    g = torch.Generator().manual_seed(8)
    bsz, G, dg, L, n = 2, 2, 40, 33, 16
    args = [torch.randn(bsz, G * dg, L, generator=g),
            0.5 * torch.randn(bsz, G * dg, L, generator=g),
            -torch.exp(0.5 * torch.randn(G * dg, n, generator=g)),
            torch.randn(bsz, G, n, L, generator=g),
            torch.randn(bsz, G, n, L, generator=g),
            torch.randn(G * dg, generator=g),
            torch.randn(bsz, G * dg, L, generator=g),
            torch.empty(G * dg).uniform_(-6, -2, generator=g)]
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [a.to(dev).clone().requires_grad_() for a in args]
        before = sg.selective_scan_grouped_bwd.launches
        out = selective_scan(*leaves, delta_softplus=True)
        (out * out.detach().sin()).sum().backward()
        launched = sg.selective_scan_grouped_bwd.launches - before
        assert launched == (0 if dev == "cpu" else 1)
        grads[str(dev)] = [leaf.grad.cpu() for leaf in leaves]
    for i, (got, want) in enumerate(zip(grads[str(cuda)], grads["cpu"])):
        assert_close_to_max(got, want, 1e-3, f"gradient {i}")


def _folded_args(bsz, L, dg, dtype, bidir, G=4, n=16, seed=0):
    """Operands of the folded scan; A and D differ in every channel (and A
    in every state), so that a kernel reading the wrong lane's row
    disagrees."""
    g = torch.Generator().manual_seed(seed)
    BD = bsz * dg
    args = [torch.randn(2 if bidir else G, L, BD, generator=g),
            0.5 * torch.randn(G, L, BD, generator=g),
            -torch.exp(0.5 * torch.randn(G * dg, n, generator=g)),
            torch.randn(G, L, n, bsz, generator=g),
            torch.randn(G, L, n, bsz, generator=g),
            torch.randn(G * dg, generator=g),
            torch.empty(G * dg).uniform_(-6, -2, generator=g)]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(getattr(torch, dtype))
    return args


# (batch, L, dg, bidir, offset) of the folded kernels' checks: the four
# SS2D stage shapes at batch 2, a ragged shape (390 lanes, L not a multiple
# of the 16-step chunk, the last channel tile of each batch 2 wide) both
# ways, an odd dg both ways (odd batches' lanes start at an odd offset, so
# bf16 cannot be copied by channel pairs), L = 1, 17 and 33 against the
# forward's 32-step chunks (the reversed directions start in a partial
# chunk), and views one element into their buffer
FOLDED_SHAPES = [(2, L, dg, True, 0) for L, dg in STAGES] + [
    (3, 7, 130, True, 0), (3, 7, 130, False, 0), (3, 7, 129, True, 0),
    (3, 7, 129, False, 0), (3, 1, 129, True, 0), (3, 17, 129, True, 0),
    (3, 33, 129, False, 0), (2, 33, 48, True, 0), (2, 33, 48, True, 1),
    (3, 17, 24, False, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz,L,dg,bidir,offset", FOLDED_SHAPES)
def test_folded_kernels_match_plain_versions(cuda, dtype, bsz, L, dg, bidir,
                                             offset):
    """The folded serving forward (y), state-saving forward (y and cs) and
    backward (all seven gradients) against their plain versions; the rule
    of the other training kernels."""
    from mamba_unet_torch.ops import selective_scan_folded as sf

    args = _offset([a.to(cuda) for a in _folded_args(
        bsz, L, dg, dtype, bidir, G=4 if bidir else 2, seed=L + dg)],
        offset)
    kernels = (sf.selective_scan_folded_fwd,
               sf.selective_scan_folded_fwd_states,
               sf.selective_scan_folded_bwd)
    before = [k.launches for k in kernels]
    y_serve = sf.selective_scan_folded_fwd(*args, bidir=bidir)
    y, cs = sf.selective_scan_folded_fwd_states(*args, bidir=bidir)
    y_ref, cs_ref = sf.selective_scan_folded_states_ref(*args, bidir=bidir)
    assert_close_to_max(y_serve, y_ref, 1e-4, "serving y")
    assert torch.equal(y_serve, y)
    assert_close_to_max(y, y_ref, 1e-4, "y")
    assert_close_to_max(cs, cs_ref, 1e-4, "cs")
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(3)
                     ).to(cuda, y.dtype)
    got = sf.selective_scan_folded_bwd(*args, cs, gy, bidir=bidir)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    want = sf.selective_scan_folded_bwd_ref(*args, gy, bidir=bidir)
    for name, g, w in zip(sf.ARG_NAMES, got, want):
        assert_close_to_max(g, w, 1e-3 if name in SUMMED else 1e-4,
                            f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["grouped", "folded", "folded_uni"])
def test_grouped_and_folded_kernels_are_deterministic(cuda, kind, dtype):
    """Two launches of each grouped or folded kernel (both ways) on the same
    inputs give bitwise equal outputs: the serving forward's y (and the
    grouped one's final state), the state-saving forward's y and cs, and
    the backward's gradients (the folded pair merges du and both reduce
    their partial sums in a fixed order, with no atomics)."""
    from functools import partial

    from mamba_unet_torch.ops import selective_scan_folded as sf
    from mamba_unet_torch.ops import selective_scan_grouped as sg

    if kind == "grouped":
        args = [a.to(cuda) for a in _grouped_args(2, 2, 97, 70, dtype,
                                                  seed=11)]
        serve = partial(sg.selective_scan_grouped, softplus=True,
                        return_last_state=True)
        fwd, bwd = (sg.selective_scan_grouped_fwd_states,
                    sg.selective_scan_grouped_bwd)
    else:
        bidir = kind == "folded"
        args = [a.to(cuda) for a in _folded_args(3, 97, 70, dtype, bidir,
                                                 G=4 if bidir else 2,
                                                 seed=11)]
        serve = partial(sf.selective_scan_folded_fwd, bidir=bidir)
        fwd = partial(sf.selective_scan_folded_fwd_states, bidir=bidir)
        bwd = partial(sf.selective_scan_folded_bwd, bidir=bidir)
    gy = torch.randn(args[1].shape, generator=torch.Generator().manual_seed(
        4)).to(cuda, args[0].dtype)
    runs = []
    for _ in range(2):
        served = serve(*args)
        y, cs = fwd(*args)
        runs.append([*(served if isinstance(served, tuple) else (served,)),
                     y, cs, *bwd(*args, cs, gy)])
    for k, (a, b) in enumerate(zip(*runs)):
        assert torch.equal(a, b), k


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["noncontiguous", "mixed_devices", "d_state"])
def test_folded_kernel_wrapper_raises_instead_of_falling_back(cuda, bad):
    from mamba_unet_torch.ops import selective_scan_folded as sf

    n = 8 if bad == "d_state" else 16
    args = [a.to(cuda) for a in _folded_args(2, 16, 32, "float32", True,
                                             n=n)]
    if bad == "noncontiguous":
        args[1] = args[1].transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "mixed_devices":
        args[5] = args[5].cpu()
    before = sf.selective_scan_folded_fwd.launches
    with pytest.raises(ValueError):
        sf.selective_scan_folded_fwd(*args)
    assert sf.selective_scan_folded_fwd.launches == before


@pytest.mark.cuda
def test_folded_mamba_unet_gradients_on_card_match_cpu(cuda):
    """``loss.backward()`` through a toy ``MambaUnet(scan_impl="folded")``
    at batch 3 (lanes not a multiple of 64 at any stage): every parameter's
    gradient on the card (the folded training kernels, 3 + 3 launches, no
    serving launch) against the CPU copy's, each at 1e-3 of its max."""
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.ops import selective_scan_folded as sf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(num_classes=4, depths=(1, 1), dims=(16, 32),
              drop_path_rate=0.0, scan_impl="folded")
    cpu = MambaUnet(generator=torch.Generator().manual_seed(0), **kw)
    card = MambaUnet(device=cuda, **kw)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(3, 32, 32, 1, generator=torch.Generator().manual_seed(1))
    kernels = (sf.selective_scan_folded_fwd,
               sf.selective_scan_folded_fwd_states,
               sf.selective_scan_folded_bwd)
    before = [k.launches for k in kernels]
    for m, dev in ((cpu, "cpu"), (card, cuda)):
        out = m.train()(x.to(dev))
        (out * out.detach().sin()).sum().backward()
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [before[0], before[1] + 3,
                                             before[2] + 3]
    for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
        assert p.grad is not None, f"{name} got no gradient on the card"
        assert_close_to_max(p.grad.cpu(), q.grad, 1e-3, name)


def _op_cases(dev):
    """(name, op, arguments) of the nine custom ops at toy shapes (batch 2,
    L = 37, dg = 20: a partial 16-step chunk and a ragged channel tile),
    fp32, on ``dev``; the cs and cotangent operands come from the plain
    versions, so both devices' backwards read the same ones."""
    from mamba_unet_torch.ops import selective_scan_folded as sf
    from mamba_unet_torch.ops import selective_scan_grouped as sg

    g = torch.Generator().manual_seed(9)
    bsz, L, dg, n = 2, 37, 20, 16

    def r(*shape):
        return torch.randn(*shape, generator=g)

    def params():
        return [-torch.exp(0.5 * r(4 * dg, n)), r(4 * dg), 0.1 * r(4 * dg)]

    A, D, db = params()
    bidir = [r(bsz, 2, L, dg), 0.5 * r(bsz, 4, L, dg), A, r(bsz, 4, L, n),
             r(bsz, 4, L, n), D, db]
    A, D, db = params()
    grouped = [r(bsz, 4, L, dg), 0.5 * r(bsz, 4, L, dg), A, r(bsz, 4, L, n),
               r(bsz, 4, L, n), D, db]
    A, D, db = params()
    folded = [r(2, L, bsz * dg), 0.5 * r(4, L, bsz * dg), A,
              r(4, L, n, bsz), r(4, L, n, bsz), D, db]
    _, cs_b = selective_scan_bidir_states_ref(*bidir)
    _, cs_g = sg.selective_scan_grouped_states_ref(*grouped)
    _, cs_f = sf.selective_scan_folded_states_ref(*folded)
    cases = [
        ("bidir_serve", "selective_scan_bidir", bidir),
        ("bidir_fwd_states", "selective_scan_bidir_fwd_states", bidir),
        ("bidir_bwd", "selective_scan_bidir_bwd",
         bidir + [cs_b, r(bsz, 2, L, dg)]),
        ("grouped_serve", "selective_scan_grouped", grouped + [True, True]),
        ("grouped_fwd_states", "selective_scan_grouped_fwd_states",
         grouped + [True]),
        ("grouped_bwd", "selective_scan_grouped_bwd",
         grouped + [cs_g, r(bsz, 4, L, dg), True]),
        ("folded_serve", "selective_scan_folded_fwd",
         folded + [True, True]),
        ("folded_fwd_states", "selective_scan_folded_fwd_states",
         folded + [True, True]),
        ("folded_bwd", "selective_scan_folded_bwd",
         folded + [cs_f, r(4, L, bsz * dg), True, True]),
    ]
    return [(name, getattr(torch.ops.mamba_unet, op),
             [a.to(dev) if torch.is_tensor(a) else a for a in args])
            for name, op, args in cases]


OP_CASES = ("bidir_serve", "bidir_fwd_states", "bidir_bwd", "grouped_serve",
            "grouped_fwd_states", "grouped_bwd", "folded_serve",
            "folded_fwd_states", "folded_bwd")


@pytest.mark.cuda
@pytest.mark.parametrize("case", OP_CASES)
def test_custom_op_cuda_matches_its_cpu_implementation(cuda, case):
    """Each ``torch.ops.mamba_unet`` op: its CUDA implementation (the
    kernel) against its CPU implementation (the plain version) on the same
    operands, each output at 1e-4 of its max (1e-3 for the sums dA, dD,
    ddelta_bias)."""
    (name, op, args), = [c for c in _op_cases("cpu") if c[0] == case]
    want = op(*args)
    got = op(*[a.to(cuda) if torch.is_tensor(a) else a for a in args])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        rel = 1e-3 if name.endswith("bwd") and i in (2, 5, 6) else 1e-4
        assert g.device.type == "cuda" and g.shape == w.shape
        assert_close_to_max(g.cpu(), w, rel, f"{name} output {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("scan_impl", ["auto", "tm", "folded"])
def test_exported_toy_model_on_card_matches_eager(cuda, tmp_path,
                                                  scan_impl):
    """``export_predict`` of a toy Mamba-UNet on the card (symbolic batch),
    saved and reloaded, serves batches 2 and 5 through its branch's serving
    kernel (3 launches per call) with the eager predict function's
    logits."""
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.ops import selective_scan_folded as sf
    from mamba_unet_torch.ops import selective_scan_grouped as sg
    from mamba_unet_torch.utils.export import (
        export_predict,
        load_exported,
        make_predict_fn,
        save_exported,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel = {"auto": selective_scan_bidir, "tm": sg.selective_scan_grouped,
              "folded": sf.selective_scan_folded_fwd}[scan_impl]
    model = MambaUnet(num_classes=4, depths=(1, 1), dims=(16, 32),
                      scan_impl=scan_impl, device=cuda)
    path = save_exported(export_predict(model, (32, 32)),
                         str(tmp_path / "toy.pt2"))
    served = load_exported(path).module()
    eager = make_predict_fn(model)
    for bsz in (2, 5):
        x = torch.randn(bsz, 32, 32, 1, device=cuda)
        before = kernel.launches
        got = served(x)
        torch.cuda.synchronize()
        assert kernel.launches == before + 3
        torch.testing.assert_close(got, eager(x), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("scan_impl", ["auto", "xla"])
def test_remat_gradients_on_card_equal_without_remat(cuda, scan_impl):
    """A toy Mamba-UNet on the card at drop_path 0.5, one generator seed:
    the step with ``use_remat`` gives the gradients of the step without, and
    launches the state-saving forward twice per block (the recomputation)
    and the backward once."""
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.nn.layers import set_generator
    from mamba_unet_torch.ops import selective_scan_grouped as sg

    fwd_states, bwd = {
        "auto": (selective_scan_bidir_fwd_states, selective_scan_bidir_bwd),
        "xla": (sg.selective_scan_grouped_fwd_states,
                sg.selective_scan_grouped_bwd)}[scan_impl]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.randn(4, 32, 32, 1, generator=torch.Generator().manual_seed(1))
    grads = {}
    for remat in (False, True):
        model = MambaUnet(num_classes=4, depths=(1, 1), dims=(16, 32),
                          drop_path_rate=0.5, scan_impl=scan_impl,
                          use_remat=remat,
                          generator=torch.Generator().manual_seed(0)).to(cuda)
        set_generator(model, torch.Generator(cuda).manual_seed(2))
        before = (fwd_states.launches, bwd.launches)
        (model.train()(x.to(cuda)) ** 2).mean().backward()
        torch.cuda.synchronize()
        assert (fwd_states.launches - before[0],
                bwd.launches - before[1]) == ((6 if remat else 3), 3)
        grads[remat] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    for k, g in grads[False].items():
        assert_close_to_max(grads[True][k], g, 1e-5, k)


def _toy_vim(cuda, seed):
    from mamba_unet_torch.models.vssm import MambaUnet

    return MambaUnet(num_classes=4, depths=(1, 1), dims=(16, 32),
                     drop_path_rate=0.0,
                     generator=torch.Generator().manual_seed(seed)).to(cuda)


def _semi_batch():
    g = torch.Generator().manual_seed(5)
    return {"image": torch.randn(4, 32, 32, 1, generator=g),
            "label": torch.randint(0, 4, (4, 32, 32), generator=g)}


def _semi_cfg():
    from mamba_unet_torch.train import TrainConfig

    return TrainConfig(base_lr=0.01, max_iterations=10, batch_size=4,
                       patch_size=(32, 32), num_classes=4, seed=0)


@pytest.mark.cuda
def test_cross_teaching_step_gradients_on_card_match_cpu(cuda):
    """One cross-teaching step of two toy Mamba-UNets, 2 labeled + 2
    unlabeled, fp32 with TF32 off: the loss and both models' gradients on
    the card against the CPU (1e-4 of each gradient's max); 3 + 3
    state-saving forward and 3 + 3 backward launches, no serving one."""
    from mamba_unet_torch.train import CrossTeachingTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for tag, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
        trainer = CrossTeachingTrainer(
            _toy_vim(dev, 0), _semi_cfg(), model2=_toy_vim(dev, 1),
            labeled_bs=2, consistency=30.0, device=dev)
        before = [k.launches for k in (selective_scan_bidir,
                                       selective_scan_bidir_fwd_states,
                                       selective_scan_bidir_bwd)]
        loss = float(trainer.train_step(_semi_batch())["loss_total"])
        launched = [k.launches - b for k, b in zip(
            (selective_scan_bidir, selective_scan_bidir_fwd_states,
             selective_scan_bidir_bwd), before)]
        out[tag] = (loss, launched, {
            f"{i}.{k}": p.grad.cpu() for i, m in
            ((1, trainer.model), (2, trainer.model2))
            for k, p in m.named_parameters()})
    assert out["card"][1] == [0, 6, 6]
    assert out["card"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for k, g in out["cpu"][2].items():
        assert_close_to_max(out["card"][2][k], g, 1e-4, k)


@pytest.mark.cuda
@pytest.mark.parametrize("method,passes", [("mean_teacher", 1),
                                           ("uamt", 9)])
def test_teacher_passes_launch_the_serving_kernel(cuda, method, passes):
    """An EMA-teacher step on a toy Mamba-UNet: each no-grad teacher pass
    (1 for mean teacher, 9 for UAMT) runs the serving kernel, 3 launches
    each; the student's forward and backward the training ones."""
    from mamba_unet_torch.train import MeanTeacherTrainer, UAMTTrainer

    cls = MeanTeacherTrainer if method == "mean_teacher" else UAMTTrainer
    trainer = cls(_toy_vim(cuda, 0), _semi_cfg(), labeled_bs=2,
                  warmup_iters=0, device=cuda)
    kernels = (selective_scan_bidir, selective_scan_bidir_fwd_states,
               selective_scan_bidir_bwd)
    before = [k.launches for k in kernels]
    logs = trainer.train_step(_semi_batch())
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [
        3 * passes, 3, 3]
    assert torch.isfinite(logs["loss_total"]) and trainer.step == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["unet", "ViT_seg"])
def test_zoo_logits_on_card_match_cpu(cuda, name):
    """Toy unet and ViT_seg: eval logits card vs CPU, fp32 with TF32 off,
    and no scan kernel launch."""
    from mamba_unet_torch.models import net_factory

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = ({"ft_chns": (4, 8, 16, 32, 64)} if name == "unet" else
          {"img_size": 64, "embed_dim": 24, "num_heads": (1, 2, 4, 8),
           "window_size": 4})
    size = 32 if name == "unet" else 64
    cpu = net_factory(name, num_classes=4,
                      generator=torch.Generator().manual_seed(0), **kw)
    card = net_factory(name, num_classes=4, device=cuda, **kw)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, size, size, 1,
                    generator=torch.Generator().manual_seed(1))
    before = selective_scan_bidir.launches
    with torch.no_grad():
        got = card.eval()(x.to(cuda)).cpu()
        want = cpu.eval()(x)
    assert selective_scan_bidir.launches == before
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _weak_trio(dev):
    """Toy unet + toy ViT_seg (window 4) + toy ViM_seg at 32², seeds 0-2,
    dropout and drop-path 0."""
    from mamba_unet_torch.models import net_factory

    return (net_factory("unet", num_classes=4, ft_chns=(4, 8, 16, 32, 64),
                        dropout=(0.0,) * 5,
                        generator=torch.Generator().manual_seed(0)),
            net_factory("ViT_seg", num_classes=4, img_size=32, embed_dim=24,
                        num_heads=(1, 2, 4, 8), window_size=4,
                        drop_path_rate=0.0,
                        generator=torch.Generator().manual_seed(1)),
            _toy_vim(dev, 2))


def _scribble_batch():
    batch = _semi_batch()
    g = torch.Generator().manual_seed(6)
    batch["label"][torch.rand(batch["label"].shape, generator=g) < 0.8] = 4
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("pce_only", [False, True])
def test_weak_step_gradients_on_card_match_cpu(cuda, pce_only):
    """One Weak-Mamba-UNet step of the toy trio on scribbles, fp32 with
    TF32 off, the same mix weights on both sides: the losses and the three
    models' gradients on the card against the CPU (1e-4 of each gradient's
    max; the exact zeros, the toy unet's convolution biases that feed a
    BatchNorm, below ZERO_GRAD_REL of the model's largest on both sides);
    the Mamba member launches 3 state-saving forward and 3 backward bidir
    kernels, no serving one; with ``pce_only`` the pseudo-label Dice is
    exactly 0."""
    from mamba_unet_torch.train import WeakScribbleTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mix = torch.tensor([0.2, 0.3, 0.5])
    out = {}
    for tag, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
        m1, m2, m3 = _weak_trio(dev)
        trainer = WeakScribbleTrainer(m1, _semi_cfg(), model2=m2, model3=m3,
                                      pce_only=pce_only, device=dev)
        trainer._mix_weights = lambda d=dev: mix.to(d)
        before = [k.launches for k in (selective_scan_bidir,
                                       selective_scan_bidir_fwd_states,
                                       selective_scan_bidir_bwd)]
        logs = trainer.train_step(_scribble_batch())
        launched = [k.launches - b for k, b in zip(
            (selective_scan_bidir, selective_scan_bidir_fwd_states,
             selective_scan_bidir_bwd), before)]
        out[tag] = ({k: float(logs[k]) for k in (
            "loss_total", "loss_model1", "loss_model2", "loss_model3",
            "loss_pce", "loss_pseudo_dice")}, launched, {
            f"{i}.{k}": p.grad.cpu() for i, (m, _, _) in
            enumerate(trainer._members(), start=1)
            for k, p in m.named_parameters()})
    assert out["card"][1] == [0, 3, 3]
    for k, v in out["cpu"][0].items():
        assert out["card"][0][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    if pce_only:
        assert out["card"][0]["loss_pseudo_dice"] == 0.0
    zeros = {f"1.{k}" for k in batchnorm_fed_biases(_weak_trio("cpu")[0])}
    assert len(zeros) == 18  # the toy unet's two per conv block, 9 blocks
    unet_max = max(g.abs().max().item() for k, g in out["cpu"][2].items()
                   if k.startswith("1."))
    for k, g in out["cpu"][2].items():
        if k in zeros:
            for side in ("card", "cpu"):
                assert (out[side][2][k].abs().max().item()
                        <= ZERO_GRAD_REL * unet_max), (side, k)
        else:
            assert_close_to_max(out["card"][2][k], g, 1e-4, k)


@pytest.mark.cuda
def test_weak_fit_evaluates_model3_through_the_serving_kernel(cuda,
                                                              tmp_path):
    """Two fit steps of the toy trio with an eval after each: the Mamba
    member's eval forward launches the serving kernel (3 per forward of
    the one 4-slice val volume), and the fit writes best, best2, best3
    wherever each model's val Dice rose above 0."""
    import numpy as np

    from mamba_unet_torch.train import WeakScribbleTrainer

    cfg = _semi_cfg()
    cfg.eval_every, cfg.snapshot_dir = 1, str(tmp_path)
    m1, m2, m3 = _weak_trio(cuda)
    trainer = WeakScribbleTrainer(m1, cfg, model2=m2, model3=m3, device=cuda)
    rng = np.random.default_rng(0)
    val = [{"image": rng.random((4, 32, 32), np.float32),
            "label": rng.integers(0, 4, (4, 32, 32)), "case": "v"}]
    before = selective_scan_bidir.launches
    result = trainer.fit([_scribble_batch()] * 2, val)
    assert selective_scan_bidir.launches - before == 2 * 3
    saved = {p.name for p in tmp_path.iterdir()}
    for i, name in enumerate(("best", "best2", "best3")):
        dice = [h["val_dice" + name[4:]] for h in result["history"]
                if "val_dice" in h]
        assert len(dice) == 2
        assert (f"{name}_1" in saved) == (dice[0] > 0), (name, dice, saved)
