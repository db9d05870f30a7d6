"""The PyTorch port's 1-D Mamba stack and Mamba-LM serving against JAX.

Inputs are drawn with numpy from a seed and fed to both frameworks; JAX
weights are carried into the port by ``params_from_jax_lm``. Tolerances:

* the plain grouped scan against the Pallas ``_fwd_kernel`` (interpret
  mode) and the XLA scan: 2e-4, the JAX package's own bound for its
  kernels (fp32 sums in another order); bf16 inputs against JAX fp32:
  3e-2 relative to the output's max plus one bf16 rounding step;
* conv, decode update, modules and the toy LM: 1e-4 (a few fp32 matmuls
  and the scan, in another summation order);
* loglikelihoods: 1e-4 relative (sums of up to 8 log-probs).

The CUDA kernel itself runs only on a card: tests/test_torch_kernel.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

torch = pytest.importorskip("torch")

from mamba_unet_torch.eval.lm_eval import (  # noqa: E402
    LMEvaluator,
    make_harness_adapter,
)
from mamba_unet_torch.models import mamba_lm as tlm  # noqa: E402
from mamba_unet_torch.nn.mamba1d import Mamba, MambaBlock  # noqa: E402
from mamba_unet_torch.ops import causal_conv1d as tconv  # noqa: E402
from mamba_unet_torch.ops.selective_scan import (  # noqa: E402
    selective_scan,
    selective_scan_ref,
)
from mamba_unet_torch.ops.selective_scan_grouped import (  # noqa: E402
    selective_scan_grouped,
    selective_scan_grouped_ref,
)
from mamba_unet_torch.ops.state_update import (  # noqa: E402
    selective_state_update,
)
from mamba_unet_torch.utils.checkpoint import load_model_snapshot  # noqa: E402
from mamba_unet_torch.utils.compare import BF16_STEP  # noqa: E402
from mamba_unet_torch.utils.convert_lm import (  # noqa: E402
    load_hf_snapshot,
    params_from_jax_lm,
)
from mamba_unet_tpu.eval.lm_eval import LMEvaluator as JEvaluator  # noqa: E402
from mamba_unet_tpu.models import mamba_lm as jlm  # noqa: E402
from mamba_unet_tpu.nn import mamba1d as jm  # noqa: E402
from mamba_unet_tpu.ops.causal_conv1d import (  # noqa: E402
    causal_conv1d as j_conv,
    causal_conv1d_update as j_conv_update,
)
from mamba_unet_tpu.ops.selective_scan import (  # noqa: E402
    selective_scan as j_scan,
    selective_scan_ref as j_scan_ref,
    selective_scan_xla as j_scan_xla,
)
from mamba_unet_tpu.ops.selective_scan_pallas import (  # noqa: E402
    selective_scan_pallas,
)
from mamba_unet_tpu.ops.state_update import (  # noqa: E402
    selective_state_update as j_state_update,
)

SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=1e-4)
VOCAB, WIDTH, DEPTH = 61, 16, 2  # the toy LM (padded vocab 64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on a few cores, and torch's default of one thread per core
    oversubscribed them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def fast_jax_compiles():
    """XLA's cheaper compile while this file runs: the JAX references are
    compile-bound."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def t(a):
    return torch.from_numpy(np.asarray(a))


def _flat(variables):
    return {k: np.asarray(v)
            for k, v in flatten_dict(variables["params"], sep="/").items()}


def _scan_inputs(rng, bsz, G, dg, L, n=16):
    """(B, D, L) layout, grouped B/C (B, G, N, L), as the JAX package's."""
    D = G * dg
    return dict(
        u=rng.normal(size=(bsz, D, L)).astype(np.float32),
        delta=(0.5 * rng.normal(size=(bsz, D, L))).astype(np.float32),
        A=-np.exp(0.5 * rng.normal(size=(D, n))).astype(np.float32),
        B=rng.normal(size=(bsz, G, n, L)).astype(np.float32),
        C=rng.normal(size=(bsz, G, n, L)).astype(np.float32),
        D=rng.normal(size=(D,)).astype(np.float32),
        z=rng.normal(size=(bsz, D, L)).astype(np.float32),
        delta_bias=(0.1 * rng.normal(size=(D,))).astype(np.float32),
    )


def _grouped_port(inp, dtype=torch.float32, return_last_state=False):
    """The port's time-major grouped scan on the (B, D, L) inputs, gated by
    silu(z) as the Pallas wrapper gates it; back in (B, D, L)."""
    bsz, D, L = inp["u"].shape
    G = inp["B"].shape[1]

    def tm(a, w):
        return t(a).reshape(bsz, G, w, L).transpose(2, 3).contiguous()

    out = selective_scan_grouped_ref(
        tm(inp["u"], D // G).to(dtype), tm(inp["delta"], D // G).to(dtype),
        t(inp["A"]), t(inp["B"]).transpose(2, 3).contiguous().to(dtype),
        t(inp["C"]).transpose(2, 3).contiguous().to(dtype), t(inp["D"]),
        t(inp["delta_bias"]), True, return_last_state)
    y, last = out if return_last_state else (out, None)
    y = y.float().transpose(2, 3).reshape(bsz, D, L)
    y = y * torch.nn.functional.silu(t(inp["z"]))
    return (y, last) if return_last_state else y


@pytest.mark.parametrize("G,dg", [(1, 24), (4, 8)])
def test_grouped_scan_matches_pallas_kernel(G, dg):
    """The plain grouped scan and the CPU dispatcher against the TPU
    kernel (#3) in interpret mode, with z, D, delta_bias and softplus."""
    inp = _scan_inputs(np.random.default_rng(G), 2, G, dg, 37)
    want = np.asarray(selective_scan_pallas(
        *(jnp.asarray(inp[k]) for k in ("u", "delta", "A", "B", "C", "D",
                                         "z", "delta_bias")),
        delta_softplus=True, interpret=True))
    np.testing.assert_allclose(_grouped_port(inp).numpy(), want, **SCAN_TOL)
    got = selective_scan(*(t(inp[k]) for k in ("u", "delta", "A", "B", "C",
                                                "D", "z", "delta_bias")),
                         delta_softplus=True)
    np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)


def test_grouped_scan_bf16_matches_jax_fp32():
    """bf16 inputs (state and sums fp32, y rounded to bf16 once) against
    JAX fp32 on the same bf16-rounded values."""
    inp = _scan_inputs(np.random.default_rng(5), 2, 2, 16, 29)
    for k in ("u", "delta", "B", "C"):
        inp[k] = t(inp[k]).bfloat16().float().numpy()
    want = np.asarray(j_scan_ref(
        *(jnp.asarray(inp[k]) for k in ("u", "delta", "A", "B", "C", "D",
                                         "z", "delta_bias")),
        delta_softplus=True))
    got = _grouped_port(inp, torch.bfloat16).numpy()
    bound = 3e-2 * np.abs(want).max() + BF16_STEP * np.abs(want)
    assert (np.abs(got - want) <= bound).all()


def test_last_state_and_chunked_scan_match_jax_xla():
    """``return_last_state`` (plain grouped scan, dispatcher, reference
    loop) against ``selective_scan_xla``, whose chunks of 16 steps carry
    the state as one sequential loop does."""
    inp = _scan_inputs(np.random.default_rng(3), 2, 1, 24, 45)
    args = [inp[k] for k in ("u", "delta", "A", "B", "C", "D", "z",
                             "delta_bias")]
    want_y, want_last = j_scan(
        *map(jnp.asarray, args), delta_softplus=True, return_last_state=True,
        implementation="xla")
    y, last = _grouped_port(inp, return_last_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               **SCAN_TOL)
    y, last = selective_scan(*map(t, args), delta_softplus=True,
                             return_last_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               **SCAN_TOL)

    want_y, want_last = j_scan_xla(
        *map(jnp.asarray, args), delta_softplus=True, return_last_state=True,
        chunk=16)
    y, last = selective_scan_ref(*map(t, args), delta_softplus=True,
                                 return_last_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               **SCAN_TOL)


def test_grouped_scan_checks_its_operands():
    inp = _scan_inputs(np.random.default_rng(0), 1, 1, 8, 5)
    u = t(inp["u"]).transpose(1, 2)[:, None].contiguous()
    delta = t(inp["delta"]).transpose(1, 2)[:, None].contiguous()
    Bm = t(inp["B"]).transpose(2, 3).contiguous()
    args = [u, delta, t(inp["A"]), Bm, Bm, t(inp["D"]), t(inp["delta_bias"])]
    before = selective_scan_grouped.launches
    selective_scan_grouped(*args)  # CPU: the plain version, no launch
    assert selective_scan_grouped.launches == before
    with pytest.raises(ValueError):
        selective_scan_grouped(*args[:3], Bm[..., :8], *args[4:])
    with pytest.raises(TypeError):
        selective_scan_grouped(args[0], args[1].bfloat16(), *args[2:])


def test_causal_conv1d_and_decode_update_match_jax():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 6, 9)).astype(np.float32)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    for act in (None, "silu"):
        np.testing.assert_allclose(
            tconv.causal_conv1d(t(x), t(w), t(b), act).numpy(),
            np.asarray(j_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              act)), **TOL)
    state = rng.normal(size=(2, 6, 4)).astype(np.float32)
    got = tconv.causal_conv1d_update(t(x[..., 0]), t(state), t(w), t(b),
                                     "silu")
    want = j_conv_update(jnp.asarray(x[..., 0]),
                         jnp.asarray(state), jnp.asarray(w), jnp.asarray(b),
                         "silu")
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **TOL)
    with pytest.raises(ValueError):
        tconv.causal_conv1d(t(x), t(w), activation="relu")


def test_selective_state_update_matches_jax():
    rng = np.random.default_rng(12)
    bsz, D, n = 3, 10, 16
    arrs = [rng.normal(size=s).astype(np.float32) for s in (
        (bsz, D, n), (bsz, D), (bsz, D), (D, n), (bsz, n), (bsz, n), (D,),
        (bsz, D), (D,))]
    arrs[3] = -np.exp(arrs[3])
    got = selective_state_update(*map(t, arrs[:6]), D=t(arrs[6]),
                                 z=t(arrs[7]), delta_bias=t(arrs[8]),
                                 delta_softplus=True)
    want = j_state_update(*map(jnp.asarray, arrs[:6]),
                          D=jnp.asarray(arrs[6]), z=jnp.asarray(arrs[7]),
                          delta_bias=jnp.asarray(arrs[8]),
                          delta_softplus=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("kind", ["mamba", "mamba_v2", "block_rms",
                                  "block_ln"])
def test_mamba_modules_match_jax(kind):
    """Forward of each module, and for the unidirectional ones also the
    prefill (output and both caches) and one decode step."""
    x = np.random.default_rng(13).normal(size=(2, 11, WIDTH)).astype(
        np.float32)
    if kind.startswith("mamba"):
        bi = "v2" if kind == "mamba_v2" else "none"
        jmod = jm.Mamba(d_model=WIDTH, bimamba_type=bi)
        tmod = Mamba(WIDTH, bimamba_type=bi)
    else:
        rms = kind == "block_rms"
        jmod = jm.MambaBlock(d_model=WIDTH, rms_norm=rms)
        tmod = MambaBlock(WIDTH, rms_norm=rms)
    variables = jmod.init(jax.random.key(0), jnp.asarray(x))
    tmod.load_state_dict(params_from_jax_lm(_flat(variables)), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(
            tmod(t(x)).numpy(), np.asarray(jmod.apply(variables,
                                                      jnp.asarray(x))), **TOL)
        if kind == "mamba_v2":
            return
        if kind == "mamba":  # decode from empty caches == the forward
            caches, ys = tmod.init_cache(2), []
            for i in range(3):
                y, *caches = tmod.step(t(x[:, i:i + 1]), *caches)
                ys.append(y)
            np.testing.assert_allclose(torch.cat(ys, 1).numpy(),
                                       tmod(t(x[:, :3])).numpy(), **TOL)
        got = tmod.forward_with_cache(t(x))
        want = jmod.apply(variables, jnp.asarray(x),
                          method="forward_with_cache")
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        got = tmod.step(t(x[:, :1]), *got[1:])
        want = jmod.apply(variables, jnp.asarray(x[:, :1]), *want[1:],
                          method="step")
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.fixture(scope="module")
def toy_lm():
    """The toy JAX LM, its weights, and the port LM holding them."""
    jmodel = jlm.MambaLMHeadModel(vocab_size=VOCAB, d_model=WIDTH,
                                  n_layer=DEPTH)
    variables = jax.jit(jmodel.init)(jax.random.key(0),
                                     jnp.zeros((1, 8), jnp.int32))
    tmodel = tlm.MambaLMHeadModel(VOCAB, WIDTH, DEPTH).eval()
    tmodel.load_state_dict(params_from_jax_lm(_flat(variables)), strict=True)
    return jmodel, variables, tmodel


def test_toy_lm_logits_prefill_and_decode_match_jax(toy_lm):
    jmodel, variables, tmodel = toy_lm
    ids = np.random.default_rng(14).integers(0, VOCAB, (2, 13))
    with torch.no_grad():
        got = tmodel(t(ids))
        assert got.shape == (2, 13, 64) and got.dtype == torch.float32
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jmodel.apply(variables, jnp.asarray(ids))),
            **TOL)
        logits, caches = tmodel.prefill(t(ids))
        j_logits, j_caches = jmodel.apply(variables, jnp.asarray(ids),
                                          method="prefill")
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   **TOL)
        for g, w in zip(caches, j_caches):
            for gs, ws in zip(g, w):
                np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
        token = np.array([3, 60])
        logits, _ = tmodel.decode_step(t(token), caches)
        j_logits, _ = jmodel.apply(variables, jnp.asarray(token), j_caches,
                                   method="decode_step")
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   **TOL)


def test_greedy_generate_matches_jax(toy_lm):
    """Same tokens as the JAX program. At every step the port's logits are
    within TOL of JAX's and the top-2 gap exceeds twice TOL, so no near tie
    can flip a token."""
    jmodel, variables, tmodel = toy_lm
    ids = np.random.default_rng(15).integers(0, VOCAB, (2, 9))
    got = tlm.generate(tmodel, t(ids), max_new_tokens=8)
    want = np.asarray(jlm.generate(jmodel, variables, jnp.asarray(ids),
                                   max_new_tokens=8))
    with torch.no_grad():
        logits = tmodel(got[:, :-1])[:, 8:]  # the 8 predicting positions
    j_logits = jmodel.apply(variables, jnp.asarray(got[:, :-1].numpy()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits)[:, 8:],
                               **TOL)
    top2 = logits.topk(2, dim=-1).values
    tie = 2 * (TOL["atol"] + TOL["rtol"] * logits.abs().max().item())
    assert ((top2[..., 0] - top2[..., 1]) > tie).all()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("top_k,top_p,temperature",
                         [(5, 0.0, 1.0), (0, 0.7, 0.8), (8, 0.5, 1.3)])
def test_sampling_filters_match_jax(monkeypatch, top_k, top_p, temperature):
    """The logits the JAX sampler draws from (captured at its categorical
    draw) equal the port's filtered logits; the draws differ by design."""
    logits = np.random.default_rng(16).normal(size=(3, 40)).astype(np.float32)
    seen = {}

    def capture(key, masked, axis=-1):
        seen["logits"] = np.asarray(masked)
        return jnp.zeros(masked.shape[0], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jlm._sample_token(jax.random.key(0), jnp.asarray(logits), temperature,
                      top_k, top_p)
    got = tlm.filter_logits(t(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(seen["logits"]))
    keep = ~np.isinf(got)
    np.testing.assert_allclose(got[keep], seen["logits"][keep], rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    for _ in range(5):
        tok = tlm.sample_token(t(logits), temperature, top_k, top_p, g)
        assert keep[np.arange(3), tok.numpy()].all()


def test_lm_evaluator_matches_jax(toy_lm):
    """loglikelihood (across two length buckets and a ragged last batch),
    multiple_choice, lambada and generate_until against the JAX
    evaluator."""
    jmodel, variables, tmodel = toy_lm
    rng = np.random.default_rng(17)

    def seq(lo, hi):
        return rng.integers(0, VOCAB, int(rng.integers(lo, hi))).tolist()

    reqs = [(seq(3, 40), seq(1, 6)) for _ in range(5)]
    ev, jev = LMEvaluator(tmodel, batch_size=2), JEvaluator(jmodel, variables,
                                                             batch_size=2)
    got, want = ev.loglikelihood(reqs), jev.loglikelihood(reqs)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-4)
    assert [g[1] for g in got] == [w[1] for w in want]
    docs = [{"context": seq(4, 12), "choices": [seq(1, 4) for _ in range(3)],
             "gold": i % 3} for i in range(3)]
    assert ev.multiple_choice(docs) == jev.multiple_choice(docs)
    docs = [{"context": seq(5, 20), "target": seq(1, 3)} for _ in range(3)]
    got, want = ev.lambada(docs), jev.lambada(docs)
    assert got["acc"] == want["acc"]
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-4)
    reqs = [(seq(4, 9), {"max_gen_toks": 5, "until": [[7]]})]
    assert ev.generate_until(reqs) == jev.generate_until(reqs)


def test_harness_adapter_needs_lm_eval(toy_lm):
    try:
        import lm_eval  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            make_harness_adapter(toy_lm[2])
    else:
        assert make_harness_adapter(toy_lm[2]) is not None


def test_load_hf_snapshot(tmp_path, toy_lm):
    """A snapshot written here the way state-spaces publishes one: upstream
    keys, unpadded vocabulary, a tied ``lm_head.weight``."""
    _, _, tmodel = toy_lm
    sd = {k: v.clone() for k, v in tmodel.state_dict().items()}
    sd["backbone.embedding.weight"] = sd["backbone.embedding.weight"][:VOCAB]
    sd["lm_head.weight"] = sd["backbone.embedding.weight"]
    torch.save(sd, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps({
        "d_model": WIDTH, "n_layer": DEPTH, "vocab_size": VOCAB,
        "ssm_cfg": {}, "rms_norm": True, "residual_in_fp32": True,
        "fused_add_norm": True, "pad_vocab_size_multiple": 8}))
    model = load_hf_snapshot(str(tmp_path), device="cpu")
    assert not model.training
    emb = model.backbone.embedding.weight
    assert emb.shape == (64, WIDTH) and not emb[VOCAB:].any()
    ids = t(np.random.default_rng(18).integers(0, VOCAB, (1, 7)))
    with torch.no_grad():
        np.testing.assert_allclose(model(ids)[..., :VOCAB].numpy(),
                                   tmodel(ids)[..., :VOCAB].numpy(),
                                   rtol=1e-6, atol=1e-6)
    sd["lm_head.weight"] = sd["lm_head.weight"] + 1.0
    torch.save(sd, tmp_path / "pytorch_model.bin")
    with pytest.raises(ValueError):
        load_hf_snapshot(str(tmp_path), device="cpu")


@pytest.mark.parametrize("loader", ["model_snapshot", "hf_snapshot"])
def test_loaders_default_to_the_card(tmp_path, loader):
    """With no device given, both loaders ask for CUDA and raise without
    it, rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (tmp_path / "config.json").write_text(json.dumps(
        {"d_model": WIDTH, "n_layer": 1, "vocab_size": VOCAB}))
    with pytest.raises(RuntimeError, match="cuda"):
        if loader == "model_snapshot":
            load_model_snapshot("ViM_seg", 4, 1)
        else:
            load_hf_snapshot(str(tmp_path))


def test_bf16_lm_matches_jax_fp32(toy_lm, tmp_path):
    """The compute dtype bf16 (weights fp32): the logits within bf16
    tolerance of JAX's fp32 (JAX's bf16 scan keeps a bf16 state, so it is
    no reference for an fp32-state scan); prefill and greedy generation
    run; ``load_hf_snapshot(dtype=)`` builds the bf16 model."""
    jmodel, variables, tmodel = toy_lm
    half = tlm.MambaLMHeadModel(VOCAB, WIDTH, DEPTH,
                                dtype=torch.bfloat16).eval()
    half.load_state_dict(tmodel.state_dict())
    assert all(p.dtype == torch.float32 for p in half.parameters())
    ids = np.random.default_rng(19).integers(0, VOCAB, (2, 13))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(ids)))
    with torch.no_grad():
        got = half(t(ids))
        logits, caches = half.prefill(t(ids))
    assert got.dtype == torch.float32 and logits.dtype == torch.float32
    bound = 3e-2 * np.abs(want).max() + BF16_STEP * np.abs(want)
    assert (np.abs(got.numpy() - want) <= bound).all()
    assert (np.abs(logits.numpy() - want[:, -1]) <= bound[:, -1]).all()
    assert all(c.dtype == torch.float32 for cache in caches for c in cache)
    tokens = tlm.generate(half, t(ids), max_new_tokens=4)
    assert tokens.shape == (2, 17)
    sd = {k: v.clone() for k, v in tmodel.state_dict().items()}
    torch.save(sd, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps({
        "d_model": WIDTH, "n_layer": DEPTH, "vocab_size": 64}))
    loaded = load_hf_snapshot(str(tmp_path), device="cpu",
                              dtype=torch.bfloat16)
    assert loaded.dtype == torch.bfloat16
    with torch.no_grad():
        assert torch.equal(loaded(t(ids)), got)
    with pytest.raises(ValueError):
        tlm.MambaLMHeadModel(VOCAB, WIDTH, DEPTH, dtype=torch.float16)


def test_export_lm_generate_matches_jax(tmp_path):
    """JAX's own export test's toy (vocab 61, d_model 32, 2 layers, 6
    prompt tokens, 5 new): the artifact, saved and loaded, gives JAX's
    greedy tokens at batches 2 and 3 (and 1), the prompt echoed. A
    sampling artifact (top-k 0, temperature 0.8) gives the eager seeded
    module's tokens, and its seed changes them."""
    from mamba_unet_torch.utils.export import (
        export_lm_generate,
        load_exported,
        save_exported,
    )

    jmodel = jlm.MambaLMHeadModel(vocab_size=61, d_model=32, n_layer=2)
    variables = jax.jit(jmodel.init)(jax.random.key(0),
                                     jnp.zeros((1, 6), jnp.int32))
    model = tlm.MambaLMHeadModel(61, 32, 2).eval()
    model.load_state_dict(params_from_jax_lm(_flat(variables)), strict=True)
    path = save_exported(export_lm_generate(model, prompt_len=6,
                                            max_new_tokens=5),
                         str(tmp_path / "lm.pt2"))
    loaded = load_exported(path).module()
    for bsz in (1, 2, 3):
        prompts = np.arange(bsz * 6).reshape(bsz, 6) % 61
        with torch.no_grad():
            got = loaded(t(prompts), torch.tensor(7))
        want = jlm.generate(jmodel, variables, jnp.asarray(prompts),
                            max_new_tokens=5, rng=jax.random.key(7))
        assert got.shape == (bsz, 11)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got[:, :6].numpy(), prompts)
    sampling = dict(temperature=0.8, top_k=0)
    sampled = export_lm_generate(model, 6, 5, **sampling).module()
    prompts = t(np.arange(12).reshape(2, 6) % 61)
    eager = tlm.SeededGenerate(model, 5, **sampling)
    with torch.no_grad():
        for seed in (3, 4):
            seed = torch.tensor(seed)
            assert torch.equal(sampled(prompts, seed), eager(prompts, seed))
        assert not torch.equal(eager(prompts, torch.tensor(3)),
                               eager(prompts, torch.tensor(4)))
