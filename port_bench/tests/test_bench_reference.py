"""The plain reference against ``mamba_unet_torch`` at a tiny size, on the
same weights and inputs (the program's CPU path runs its kernels' plain
versions)."""

import json

import numpy as np
import torch

from port_bench.reference import data as ref_data
from port_bench.reference import vssm
from port_bench.reference.net import Net, init_weights, param_spec


def _config(tiny_root, name):
    return json.load(open(tiny_root / f"port_bench/configs/{name}.json"))


def _program(cfg, device=None):
    """The configuration's model as the drivers build it."""
    from mamba_unet_torch.models import net_factory

    prog = cfg["program"]
    return net_factory(prog["registry"], device=device,
                       **{k: cfg[key] for k, key in prog["kwargs"].items()})


def test_vssm_logits_match_the_program(tiny_root):
    cfg = _config(tiny_root, "tiny")
    model = _program(cfg)
    model.load_state_dict(init_weights(cfg, 5, "cpu"), strict=True)
    model.eval()
    x = torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
        got = vssm.forward(Net(init_weights(cfg, 5, "cpu"), cfg), x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_batches_match_the_programs_loader():
    from mamba_unet_torch.data.acdc import SliceDataset
    from mamba_unet_torch.data.augment import RandomGenerator
    from mamba_unet_torch.data.sampler import EpochShuffleSampler

    from port_bench.bench.inputs import phantom_slices

    seed, n, bs = 2 ** 31 + 99, 30, 4
    slices = phantom_slices(n, 40, 36, seed)
    ds = SliceDataset.from_samples(
        [{"image": slices["image"][i], "label": slices["label"][i]}
         for i in range(n)], transform=RandomGenerator((32, 32), seed=seed))
    sampler = EpochShuffleSampler(n, bs, seed=seed)
    ref = ref_data.epoch_batches(n, bs, seed)
    want = []
    for _ in range(2):  # two epochs
        for idxs in sampler:
            items = [ds[i] for i in idxs]
            want.append({k: np.stack([it[k] for it in items])
                         for k in ("image", "label")})
    got = ref_data.batches(slices, ref, ref_data.Transform((32, 32), seed),
                           len(want))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])


def test_full_size_layout_is_the_programs():
    """The reference's parameter layout at the configuration's widths is
    the program's state dict, name by name and shape by shape."""
    from port_bench.bench.cell import BENCH_DIR

    cfg = json.load(open(BENCH_DIR / "configs" / "mamba_unet.json"))
    model = _program(cfg, device="meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {name: tuple(shape) for name, shape, _, _ in param_spec(cfg)}
    assert got == want
