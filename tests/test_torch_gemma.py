"""The port's Gemma modules against the JAX package's, on the CPU in fp32.

Inputs come from numpy with a seed; weights are the JAX model's
(``lm.init(PRNGKey(0))``) carried over by ``iseg_tpu_torch/convert.py``; the
``gemma_test`` preset (2 layers, hidden 64, 4 heads over 2 KV heads, head
dim 16, vocab 512). Tolerances: single layers 1e-6 max abs error (the same
fp32 arithmetic, a few operations deep); whole forwards 1e-5 of max |logit|
(two blocks of fp32 sums in another order).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.nlp.gemma import GemmaCausalLM as JaxLM
from iseg_tpu.nlp.gemma import config as jax_config
from iseg_tpu.nlp.gemma import model as jax_model
from iseg_tpu.ops import quant as jax_quant
from iseg_tpu_torch import convert
from iseg_tpu_torch.nlp.gemma import GemmaCausalLM, config, get_preset
from iseg_tpu_torch.nlp.gemma import model as gmodel
from iseg_tpu_torch.nn.initializers import initialize
from iseg_tpu_torch.ops.quant import QuantDense, QuantEmbed

torch.set_num_threads(1)

LAYER_ATOL = 1e-6
MODEL_RTOL = 1e-5  # of max |logit|


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_to_jax(got: torch.Tensor, want, rtol=MODEL_RTOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.fixture(scope="module")
def lms():
    jlm = JaxLM(jax_config.get_preset("gemma_test"))
    variables = jlm.init(jax.random.PRNGKey(0), batch=1, seq=8)
    lm = GemmaCausalLM(get_preset("gemma_test"), device="cpu")
    convert.load_flax(lm, _np_tree(variables))
    return jlm, variables, lm.eval()


# -- copies and single layers ------------------------------------------------


@pytest.mark.parametrize("name", sorted(jax_config.GEMMA_PRESETS))
def test_torch_gemma_preset_equals_original(name):
    assert sorted(config.GEMMA_PRESETS) == sorted(jax_config.GEMMA_PRESETS)
    ours, theirs = config.get_preset(name), jax_config.get_preset(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    with pytest.raises(KeyError):
        config.get_preset("nope")


def test_torch_gemma_rmsnorm():
    x = np.random.RandomState(0).randn(2, 5, 64).astype(np.float32) * 3.0
    scale = np.random.RandomState(1).randn(64).astype(np.float32) * 0.1
    want = jax_model.RMSNorm(epsilon=1e-6).apply({"params": {"scale": scale}}, jnp.asarray(x))
    norm = gmodel.RMSNorm(64, epsilon=1e-6, device="cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.tensor(scale))
    got = norm(torch.tensor(x))
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= LAYER_ATOL
    # bf16 in, bf16 out, fp32 inside
    assert norm(torch.tensor(x).bfloat16()).dtype == torch.bfloat16


def test_torch_gemma_rope():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    positions = rng.randint(0, 40, (2, 5)).astype(np.int32)
    want = jax_model.apply_rope_1d(jnp.asarray(x), jnp.asarray(positions), 10000.0)
    got = gmodel.apply_rope_1d(torch.tensor(x), torch.tensor(positions), 10000.0)
    # angles up to 40 rad in fp32: one ulp of the angle is 4e-6
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5
    small = jax_model.apply_rope_1d(jnp.asarray(x), jnp.asarray(positions % 4), 10000.0)
    got_small = gmodel.apply_rope_1d(torch.tensor(x), torch.tensor(positions % 4), 10000.0)
    assert np.abs(got_small.numpy() - np.asarray(small)).max() <= LAYER_ATOL


def test_torch_gemma_causal_mask():
    positions = np.array([[0, 1, 2], [4, 5, 6]], np.int32)
    for kv_len in (None, 8):
        want = np.asarray(jax_model.causal_mask(3, jnp.asarray(positions), kv_len=kv_len))
        got = gmodel.causal_mask(3, torch.tensor(positions), kv_len=kv_len)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("form", ["last_axis_to_heads", "two_axes_to_dim", "plain"])
def test_torch_gemma_quant_dense(form):
    rng = np.random.RandomState(0)
    if form == "last_axis_to_heads":
        x, contract, feats, axis = rng.randn(2, 3, 8), 8, (4, 5), -1
    elif form == "two_axes_to_dim":
        x, contract, feats, axis = rng.randn(2, 3, 4, 5), (4, 5), 8, (-2, -1)
    else:
        x, contract, feats, axis = rng.randn(2, 3, 8), 8, 6, -1
    x = x.astype(np.float32)
    jmod = jax_quant.QuantDense(feats, axis=axis)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jmod.apply(variables, jnp.asarray(x))
    # a kernel_scale that is not one must change nothing on the float path
    params = _np_tree(variables)["params"]
    params["kernel_scale"] = np.full_like(params["kernel_scale"], 3.0)
    mod = QuantDense(contract, feats, device="cpu")
    convert.load_flax(mod, {"params": params})
    got = mod(torch.tensor(x))
    assert got.shape == want.shape
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= LAYER_ATOL
    back = convert.to_flax(mod)["params"]
    np.testing.assert_array_equal(back["kernel"], params["kernel"])
    np.testing.assert_array_equal(back["kernel_scale"], params["kernel_scale"])
    with pytest.raises(ValueError, match="does not end in"):
        mod(torch.zeros(2, 3, 7))


def test_torch_gemma_quant_embed():
    rng = np.random.RandomState(0)
    jmod = jax_quant.QuantEmbed(32, 8)
    ids = rng.randint(0, 32, (2, 5)).astype(np.int32)
    hidden = rng.randn(2, 5, 8).astype(np.float32)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    mod = QuantEmbed(32, 8, device="cpu")
    convert.load_flax(mod, _np_tree(variables))
    want = jmod.apply(variables, jnp.asarray(ids))
    np.testing.assert_array_equal(mod(torch.tensor(ids)).detach().numpy(), np.asarray(want))
    want = jmod.apply(variables, jnp.asarray(hidden), method=jax_quant.QuantEmbed.attend)
    got = mod.attend(torch.tensor(hidden))
    assert got.dtype == torch.float32
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= LAYER_ATOL


def test_torch_gemma_quant_embed_bf16_table_readout():
    """A bf16 table is read out through one kept fp32 copy that follows the
    table: same numbers as the cast, made anew after the table changes, not
    used while a gradient is recorded."""
    rng = np.random.RandomState(0)
    mod = QuantEmbed(32, 8, param_dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        mod.embedding.copy_(torch.tensor(rng.randn(32, 8).astype(np.float32)))
    hidden = torch.tensor(rng.randn(3, 8).astype(np.float32))
    with torch.inference_mode():
        got = mod.attend(hidden)
        kept = mod._table_f32
        assert mod.attend(hidden) is not None and mod._table_f32 is kept
    want = hidden @ mod.embedding.detach().float().t()
    assert torch.equal(got, want)
    with torch.no_grad():
        mod.embedding.mul_(2.0)
        assert torch.equal(mod.attend(hidden), 2.0 * want)
    assert mod._table_f32 is not kept
    out = mod.attend(hidden)  # grad mode: recorded through the table
    out.sum().backward()
    assert mod.embedding.grad is not None


def test_torch_gemma_int8_weights_raise():
    """int8 weights set by hand (a QuantDense weight, a QuantEmbed table)
    and an int8 kernel loaded by ``load_flax`` compute the JAX package's
    values: the W8A8 product, the rows and the readout."""
    rng = np.random.RandomState(5)
    q = rng.randint(-127, 128, (4, 8)).astype(np.int8)  # [N, K], weight's layout
    x = rng.randn(2, 8).astype(np.float32)
    dense = QuantDense(8, 4, device="cpu")
    dense.weight = torch.nn.Parameter(torch.tensor(q), requires_grad=False)
    jdense = jax_quant.QuantDense(4)
    jvars = {"params": {"kernel": jnp.asarray(q.T), "kernel_scale": jnp.ones(4)}}
    want = np.asarray(jdense.apply(jvars, jnp.asarray(x)))
    np.testing.assert_array_equal(dense(torch.tensor(x)).numpy(), want)
    table = rng.randint(-127, 128, (16, 8)).astype(np.int8)
    embed = QuantEmbed(16, 8, device="cpu")
    embed.embedding = torch.nn.Parameter(torch.tensor(table), requires_grad=False)
    jembed = jax_quant.QuantEmbed(16, 8)
    jvars_e = {"params": {"embedding": jnp.asarray(table), "embedding_scale": jnp.ones(16)}}
    ids = np.array([3, 11])
    np.testing.assert_array_equal(embed(torch.tensor(ids)).numpy(),
                                  np.asarray(jembed.apply(jvars_e, jnp.asarray(ids))))
    np.testing.assert_array_equal(
        embed.attend(torch.tensor(x)).numpy(),
        np.asarray(jembed.apply(jvars_e, jnp.asarray(x), method=jax_quant.QuantEmbed.attend)))
    loaded = convert.load_flax(QuantDense(8, 4, device="cpu"), {"params": {
        "kernel": q.T, "kernel_scale": np.full(4, 0.5, np.float32)}})
    jvars["params"]["kernel_scale"] = jnp.full(4, 0.5)
    np.testing.assert_array_equal(loaded(torch.tensor(x)).numpy(),
                                  np.asarray(jdense.apply(jvars, jnp.asarray(x))))


# -- weights carried across ----------------------------------------------------


def test_torch_gemma_convert_round_trip(lms):
    _, variables, lm = lms
    flat_in = convert.flatten(_np_tree(variables)["params"])
    back = convert.to_flax(lm)
    assert back["batch_stats"] == {}
    flat_out = convert.flatten(back["params"])
    assert sorted(flat_in) == sorted(flat_out)
    for path, leaf in flat_in.items():
        np.testing.assert_array_equal(flat_out[path], leaf, err_msg=path)
    # the int8 scales ride along as buffers, not as parameters
    params = convert.param_tree(lm)
    assert "layer_0/attention/query/kernel" in params
    assert not any(path.endswith("_scale") for path in params)
    assert tuple(lm.backbone.layer_0.attention.query.weight.shape) == (64, 64)
    assert tuple(lm.backbone.layer_0.attention.attention_output.weight.shape) == (64, 64)


def test_torch_gemma_convert_raises_on_wrong_tree(lms):
    _, variables, _ = lms
    lm = GemmaCausalLM(get_preset("gemma_test"), device="cpu")
    tree = _np_tree(variables)
    missing = {"params": {k: v for k, v in tree["params"].items() if k != "layer_1"}}
    with pytest.raises(KeyError, match="layer_1"):
        convert.load_flax(lm, missing)
    extra = {"params": {**tree["params"], "layer_2": tree["params"]["layer_1"]}}
    with pytest.raises(KeyError, match="not consumed"):
        convert.load_flax(lm, extra)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    kernel = bad["params"]["layer_0"]["attention"]["query"]["kernel"]  # [D, heads, d]
    bad["params"]["layer_0"]["attention"]["query"]["kernel"] = kernel.transpose(1, 0, 2)
    with pytest.raises(ValueError, match="query/kernel"):
        convert.load_flax(lm, bad)


def test_torch_gemma_initializers_follow_flax(lms):
    """Standard deviations of a fresh port model against the flax init's,
    leaf by leaf (the draws differ; 4096 to 32768 values a leaf)."""
    _, variables, _ = lms
    lm = GemmaCausalLM(get_preset("gemma_test"), device="cpu")
    assert lm.init(torch.Generator().manual_seed(0)) is lm
    ours = convert.flatten(convert.to_flax(lm)["params"])
    theirs = convert.flatten(_np_tree(variables)["params"])
    for path, leaf in theirs.items():
        if path.endswith("scale"):  # norm scales zero, int8 scales one
            np.testing.assert_array_equal(ours[path], leaf, err_msg=path)
        else:
            assert abs(ours[path].std() / leaf.std() - 1.0) < 0.05, path
            assert abs(ours[path].mean()) < 0.1 * leaf.std(), path
    with pytest.raises(TypeError, match="no initialization rule"):
        class Odd(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.w = torch.nn.Parameter(torch.zeros(2))
        initialize(Odd(), torch.Generator().manual_seed(0))


# -- backbone ------------------------------------------------------------------


def test_torch_gemma_forward_and_logits(lms):
    jlm, variables, lm = lms
    ids = np.random.RandomState(0).randint(1, 500, (2, 6)).astype(np.int32)
    hidden = jlm.backbone.apply(variables, jnp.asarray(ids))
    got_hidden = lm.backbone(torch.tensor(ids))
    _close_to_jax(got_hidden, hidden)
    got = lm(torch.tensor(ids))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 6, 512)
    _close_to_jax(got, jlm(variables, jnp.asarray(ids)))


def test_torch_gemma_cached_forward_matches_uncached(lms):
    """Prefill of 4 tokens, then two single-token steps, against the JAX
    package's cached calls and against the port's own full forward."""
    jlm, variables, lm = lms
    ids = np.random.RandomState(0).randint(1, 500, (2, 6)).astype(np.int32)
    full = lm(torch.tensor(ids)).detach()

    jcaches = jlm.build_cache(2, 8)
    caches = lm.build_cache(2, 8)
    assert tuple(caches.shape) == tuple(jcaches.shape) == (2, 2, 2, 8, 2, 16)
    positions = np.broadcast_to(np.arange(4)[None], (2, 4))
    jlogits, jcaches = jlm.call_with_cache(variables, jnp.asarray(ids[:, :4]), jcaches, 0,
                                           jnp.asarray(positions))
    with torch.no_grad():
        logits, same = lm.call_with_cache(torch.tensor(ids[:, :4]), caches, 0,
                                          torch.tensor(positions))
    assert same is caches  # written in place
    _close_to_jax(logits, jlogits)
    assert (logits - full[:, :4]).abs().max() <= MODEL_RTOL * full.abs().max()
    for i in (4, 5):
        pos = np.full((2, 1), i)
        jlogits, jcaches = jlm.call_with_cache(variables, jnp.asarray(ids[:, i:i + 1]), jcaches,
                                               i, jnp.asarray(pos))
        with torch.no_grad():
            logits, _ = lm.call_with_cache(torch.tensor(ids[:, i:i + 1]), caches, i,
                                           torch.tensor(pos))
        _close_to_jax(logits, jlogits)
        assert (logits[:, 0] - full[:, i]).abs().max() <= MODEL_RTOL * full.abs().max()
    _close_to_jax(caches, jcaches)


def test_torch_gemma_context_decode_matches_monolithic(lms):
    """A single-token forward through the context-segment attention (a
    read-only prefix shared by two rows each, plus an active suffix) against
    the JAX package's, and against the port's monolithic cache forward."""
    jlm, variables, lm = lms
    b, p, t, split = 2, 6, 10, 4
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 100, (b, p)).astype(np.int32)
    positions = np.broadcast_to(np.arange(p)[None], (b, p))
    tok = np.array([[7], [9], [7], [11]], np.int32)  # two rows per prefix row
    pos = np.full((2 * b, 1), p)

    jcaches = jlm.build_cache(b, t)
    _, jcaches = jlm.call_with_cache(variables, jnp.asarray(ids), jcaches, 0,
                                     jnp.asarray(positions))
    jctx = jcaches[:, :, :, :split]
    jactive = jnp.repeat(jcaches[:, :, :, split:], 2, axis=0)
    jseg, jactive = jlm.call_with_cache(variables, jnp.asarray(tok), jactive, p,
                                        jnp.asarray(pos), context=((jctx, 0),),
                                        cache_offset=split)

    with torch.no_grad():
        caches = lm.build_cache(b, t)
        lm.call_with_cache(torch.tensor(ids), caches, 0, torch.tensor(positions))
        ctx = caches[:, :, :, :split]  # a view, as the beam search passes it
        active = caches[:, :, :, split:].repeat_interleave(2, dim=0).contiguous()
        mono_caches = caches.repeat_interleave(2, dim=0)
        mono, _ = lm.call_with_cache(torch.tensor(tok), mono_caches, p, torch.tensor(pos))
        seg, _ = lm.call_with_cache(torch.tensor(tok), active, p, torch.tensor(pos),
                                    context=((ctx, 0),), cache_offset=split)
    _close_to_jax(seg, jseg)
    _close_to_jax(active, jactive)
    assert (seg - mono).abs().max() <= MODEL_RTOL * mono.abs().max()
    with pytest.raises(ValueError, match="single-token"), torch.no_grad():
        lm.call_with_cache(torch.tensor(np.tile(tok, (1, 2))), active, p,
                           torch.tensor(np.tile(pos, (1, 2))), context=((ctx, 0),),
                           cache_offset=split)


def test_torch_gemma_dpa_branch_matches_einsum_branch(lms, monkeypatch):
    """The ``T >= DPA_MIN_SEQLEN`` branch (``F.scaled_dot_product_attention``
    with grouped K/V) against the grouped matrix products, with and without
    a cache, and against the JAX package."""
    jlm, variables, lm = lms
    ids = np.random.RandomState(1).randint(1, 500, (2, 6)).astype(np.int32)
    want = jlm(variables, jnp.asarray(ids))
    positions = torch.arange(6)[None].expand(2, 6)
    results = {}
    for name, threshold in (("einsum", 10 ** 9), ("dpa", 1)):
        monkeypatch.setattr(gmodel, "DPA_MIN_SEQLEN", threshold)
        with torch.no_grad():
            results[name] = lm(torch.tensor(ids))
            results[name + "_cached"], _ = lm.call_with_cache(
                torch.tensor(ids), lm.build_cache(2, 9), 0, positions)
    for got in results.values():
        _close_to_jax(got, want)
    assert not torch.equal(results["einsum"], results["dpa"])  # two code paths ran


def test_torch_gemma_cache_decode_without_positions_raises(lms):
    _, _, lm = lms
    with pytest.raises(ValueError, match="positions"):
        lm.backbone(torch.zeros((1, 1), dtype=torch.long), caches=lm.build_cache(1, 8),
                    cache_index=5)


def test_torch_gemma_score(lms):
    jlm, variables, lm = lms
    ids = np.array([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]], np.int32)
    want = np.asarray(jlm.score(variables, jnp.asarray(ids)))
    with torch.no_grad():
        got = lm.score(torch.tensor(ids)).numpy()
    assert got.shape == want.shape == (2, 4)
    assert np.abs(got - want).max() <= 1e-5
    assert (got <= 0).all()


def test_torch_gemma_bf16_model_runs_in_bf16():
    """bf16 parameters and cache on the CPU: bf16 hidden states, fp32 logits,
    and the same greedy tokens as the fp32 copy of the same weights at the
    first step (the logits differ by bf16 rounding, about 1e-2 of max)."""
    lm = GemmaCausalLM(get_preset("gemma_test"), dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16, device="cpu")
    lm.init(torch.Generator().manual_seed(0))
    assert lm.build_cache(1, 4).dtype == torch.bfloat16
    ids = torch.tensor(np.random.RandomState(0).randint(1, 500, (2, 6)))
    with torch.no_grad():
        hidden = lm.backbone(ids)
        logits = lm(ids)
    assert hidden.dtype == torch.bfloat16 and logits.dtype == torch.float32
    lm32 = GemmaCausalLM(get_preset("gemma_test"), device="cpu")
    lm32.load_state_dict(lm.state_dict())
    with torch.no_grad():
        want = lm32(ids)
    assert (logits - want).abs().max() <= 3e-2 * want.abs().max()


def test_torch_gemma_imports_no_jax():
    """The port's Gemma modules import torch and numpy only."""
    import pathlib
    import re

    root = pathlib.Path(convert.__file__).parent
    files = [*(root / "nlp").rglob("*.py"), root / "ops" / "quant.py",
             root / "ops" / "kernels" / "cache_gather.py"]
    assert len(files) >= 10
    for path in files:
        for line in path.read_text().splitlines():
            assert not re.match(r"\s*(import|from)\s+(jax|flax|optax|iseg_tpu)(\.|\s|$)", line), \
                f"{path}: {line}"


def test_torch_gemma_flax_tree_names(lms):
    """The module names are the flax tree's, so a checkpoint maps by path."""
    _, variables, lm = lms
    assert isinstance(variables["params"], (dict, fnn.FrozenDict))
    top = sorted(variables["params"])
    assert top == sorted(name for name, _ in lm.backbone.named_children())


@pytest.mark.parametrize("build", [
    lambda **kw: GemmaCausalLM(get_preset("gemma_test"), **kw),
    lambda **kw: gmodel.GemmaBackbone(get_preset("gemma_test"), **kw),
    lambda **kw: gmodel.RMSNorm(8, **kw),
    lambda **kw: QuantDense(8, 4, **kw),
    lambda **kw: QuantEmbed(16, 8, **kw),
], ids=["causal_lm", "backbone", "rms_norm", "quant_dense", "quant_embed"])
def test_torch_gemma_modules_default_to_the_card_and_never_drop_to_the_cpu(build):
    """No ``device`` means the card: without one the constructor raises, and
    the CPU is taken only when the caller names it."""
    if torch.cuda.is_available():
        assert all(p.device.type == "cuda" for p in build().parameters())
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert all(p.device.type == "cpu" for p in build(device="cpu").parameters())
