"""The port's CUDA kernel on a card (marker ``cuda``; skipped without one).

This file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_kernel.py -m cuda

(``--noconftest`` because ``tests/conftest.py`` imports JAX.) The kernel is
held against its plain PyTorch version on the same card at 1e-4: both read
the same values, only the fp32 summation order differs.
"""

import pytest

torch = pytest.importorskip("torch")

from mamba_unet_torch.ops.selective_scan_bidir import (  # noqa: E402
    selective_scan_bidir,
    selective_scan_bidir_ref,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _args(bsz, L, dg, n=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(bsz, 2, L, dg, generator=g),
            0.5 * torch.randn(bsz, 4, L, dg, generator=g),
            -torch.arange(1, n + 1).float().repeat(4 * dg, 1),
            torch.randn(bsz, 4, L, n, generator=g),
            torch.randn(bsz, 4, L, n, generator=g),
            torch.ones(4 * dg),
            torch.empty(4 * dg).uniform_(-6, -2, generator=g)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,dg", [(50, 40), (64, 64), (7, 130)])
def test_kernel_matches_plain_version(cuda, dtype, L, dg):
    """Ragged channel tiles (dg not a multiple of 64) and L not a multiple
    of the 32-step chunk."""
    args = [a.to(cuda) for a in _args(2, L, dg)]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(getattr(torch, dtype))
    before = selective_scan_bidir.launches
    got = selective_scan_bidir(*args)
    torch.cuda.synchronize()
    assert selective_scan_bidir.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (2, 2, L, dg)
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
