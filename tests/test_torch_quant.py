"""The port's int8 serving (``iseg_tpu_torch/ops/quant.py``, the int8 leaves
of ``convert.py``) against the JAX package's ``iseg_tpu/ops/quant.py``, on
the CPU.

Inputs and weights come from seeds (the ``gemma_test`` preset's tree, drawn
by the JAX init and converted leaf by leaf). Tolerances: the quantizers and
``dynamic_int8_dot`` bit for bit (the int32 sums are exact and the
elementwise steps are the same fp32 operations); the int8 layers 1e-6 of
max |out|; ``score`` 1e-5 of max |log-likelihood| (two blocks of fp32 sums
in another order); greedy and beam-4 tokens equal. Both LMs compute in fp32
(``dtype=float32``), so the weight-only trees dequantize to fp32, as the JAX
``GemmaCausalLM`` does for that dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.nlp.gemma import GemmaCausalLM as JaxLM
from iseg_tpu.nlp.gemma import config as jax_config
from iseg_tpu.nlp.gemma import samplers as jax_samplers
from iseg_tpu.ops import quant as jq
from iseg_tpu_torch import convert
from iseg_tpu_torch.nlp.gemma import BeamSampler, GemmaCausalLM, get_preset
from iseg_tpu_torch.nlp.gemma import quant as gemma_quant
from iseg_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

LAYER_RTOL = 1e-6  # of max |out|
SCORE_RTOL = 1e-5  # of max |log-likelihood|
SCHEMES = {"weight_only": (jq.quantize_tree, tq.quantize_tree),
           "w8a8": (jq.quantize_dense_tree, tq.quantize_dense_tree)}


def _is_q(leaf) -> bool:
    return isinstance(leaf, (jq.QTensor, tq.QTensor))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np(leaf) -> np.ndarray:
    """A leaf of either package as numpy (bf16 widened to fp32, exactly)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy() if leaf.is_floating_point() else leaf.numpy()
    leaf = np.asarray(leaf)
    return leaf.astype(np.float32) if leaf.dtype.name == "bfloat16" else leaf


def _dtype_name(leaf) -> str:
    return str(leaf.dtype).replace("torch.", "")


def _assert_trees_bitwise(jtree, ttree, float_dtypes=True):
    """Leaf by leaf, equal values; equal dtypes too (of the int8 leaves alone
    with ``float_dtypes=False``: ``to_flax`` widens float leaves to fp32)."""
    fj, ft = _flat(jtree), _flat(ttree)
    assert sorted(fj) == sorted(ft)
    for path, a in fj.items():
        b = ft[path]
        assert _is_q(a) == _is_q(b), path
        pairs = ((a.q, b.q), (a.scale, b.scale)) if _is_q(a) else ((a, b),)
        for x, y in pairs:
            if float_dtypes or _dtype_name(np.asarray(x)) == "int8":
                assert _dtype_name(np.asarray(x)) == _dtype_name(y), path
            np.testing.assert_array_equal(_np(x), _np(y), err_msg=path)


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.fixture(scope="module")
def gemma():
    jlm = JaxLM(jax_config.get_preset("gemma_test"), dtype=jnp.float32)
    variables = jax.jit(lambda: jlm.init(jax.random.PRNGKey(0), batch=1, seq=8))()
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return jlm, params


@pytest.fixture(scope="module")
def schemes(gemma):
    """Per scheme: the JAX quantized tree and the port's LM loaded with it."""
    jlm, params = gemma
    out = {}
    for name, (jfn, _) in SCHEMES.items():
        jtree = jfn(params)
        lm = GemmaCausalLM(get_preset("gemma_test"), dtype=torch.float32, device="cpu")
        convert.load_flax(lm, {"params": jax.tree_util.tree_map(np.asarray, jtree)})
        out[name] = (jtree, lm.eval())
    return out


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_torch_quant_trees_match_jax_bitwise(gemma, scheme):
    """int8 values, scales and the dtype of every other leaf, leaf by leaf."""
    _, params = gemma
    jfn, tfn = SCHEMES[scheme]
    jtree, ttree = jfn(params), tfn(_torch_tree(params))
    _assert_trees_bitwise(jtree, ttree)
    assert tq.is_quantized(ttree) == (scheme == "weight_only")


def test_torch_quant_dequantize_tree_matches_jax(gemma):
    _, params = gemma
    jd = jq.dequantize_tree(jq.quantize_tree(params))
    td = tq.dequantize_tree(tq.quantize_tree(_torch_tree(params)))
    _assert_trees_bitwise(jd, td)
    assert not tq.is_quantized(td)
    # the JAX package's alias
    assert gemma_quant.quantize_tree is tq.quantize_tree


@pytest.mark.parametrize("rows,case", [(8, "decode_batch"), (17, "plain"), (5, "zero_row"),
                                       (6, "bf16")])
def test_torch_quant_dynamic_int8_dot_bitwise(rows, case):
    rng = np.random.RandomState(rows)
    x = (rng.randn(rows, 64) * 3).astype(np.float32)
    if case == "zero_row":
        x[2] = 0.0
    w_q = rng.randint(-127, 128, (64, 40)).astype(np.int8)
    w_scale = (rng.rand(40) * 0.02 + 1e-3).astype(np.float32)
    xt = torch.tensor(x)
    xj = jnp.asarray(x)
    if case == "bf16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    got = tq.dynamic_int8_dot(xt, torch.tensor(w_q), torch.tensor(w_scale))
    want = np.asarray(jq.dynamic_int8_dot(xj, jnp.asarray(w_q), jnp.asarray(w_scale)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "zero_row":
        assert not got[2].any()


def _close(got: torch.Tensor, want, rtol=LAYER_RTOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("form", ["last_axis_to_heads", "two_axes_to_dim"])
def test_torch_quant_dense_int8_forward(scheme, form):
    rng = np.random.RandomState(1)
    if form == "last_axis_to_heads":
        x, contract, feats, axis = rng.randn(2, 3, 64), 64, (4, 32), -1
    else:
        x, contract, feats, axis = rng.randn(2, 3, 4, 32), (4, 32), 64, (-2, -1)
    x = x.astype(np.float32)
    jmod = jq.QuantDense(feats, axis=axis, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0),
                                                          jnp.asarray(x))["params"])
    jtree = SCHEMES[scheme][0](params)
    dense = jq.dequantize_tree(jtree, dtype=jnp.float32)
    want = jmod.apply({"params": dense}, jnp.asarray(x))
    mod = tq.QuantDense(contract, feats, dtype=torch.float32, device="cpu")
    convert.load_flax(mod, {"params": jax.tree_util.tree_map(np.asarray, jtree)})
    assert mod.weight.dtype == torch.int8 and not mod.weight.requires_grad
    assert (mod.weight_scale is not None) == (scheme == "weight_only")
    _close(mod(torch.tensor(x)), want)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_torch_quant_embed_int8_rows_and_readout(scheme):
    rng = np.random.RandomState(2)
    jmod = jq.QuantEmbed(300, 64, dtype=jnp.float32)
    ids = rng.randint(0, 300, (2, 5)).astype(np.int32)
    hidden = rng.randn(2, 5, 64).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0),
                                                          jnp.asarray(ids))["params"])
    jtree = {"params": jax.tree_util.tree_map(np.asarray,
                                              SCHEMES[scheme][0](params))}
    jvars = {"params": jq.dequantize_tree(jtree["params"], dtype=jnp.float32)}
    mod = tq.QuantEmbed(300, 64, dtype=torch.float32, device="cpu")
    convert.load_flax(mod, jtree)
    _close(mod(torch.tensor(ids)), jmod.apply(jvars, jnp.asarray(ids)))
    want = jmod.apply(jvars, jnp.asarray(hidden), method=jq.QuantEmbed.attend)
    got = mod.attend(torch.tensor(hidden))
    assert got.dtype == torch.float32
    _close(got, want)
    assert mod._table_f32 is None  # no fp32 copy of an int8 table is kept


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_torch_quant_convert_round_trip(schemes, scheme):
    """load_flax stores int8 in the modules; flax_tree / to_flax give the
    quantized tree back, leaf by leaf, in the JAX layouts."""
    jtree, lm = schemes[scheme]
    back = convert.to_flax(lm)["params"]
    _assert_trees_bitwise(jtree, back, float_dtypes=False)
    layer = lm.backbone.layer_0
    assert layer.attention.query.weight.dtype == torch.int8
    assert lm.backbone.token_embedding.embedding.dtype == torch.int8
    if scheme == "weight_only":
        # (D, H, Dh) kernel: the scale is Dh's; the [V, D] table: per column
        assert tuple(layer.attention.query.weight_scale.shape) == (16,)
        assert tuple(lm.backbone.token_embedding.weight_scale.shape) == (64,)
        # a kernel below min_size stays float (bf16 values)
        assert layer.attention.key.weight.dtype == torch.float32
    else:
        assert tuple(layer.attention.query.kernel_scale.shape) == (4, 16)
        assert tuple(lm.backbone.token_embedding.embedding_scale.shape) == (512,)
    kernel = _flat(convert.flax_tree(lm)["params"])["layer_0/attention/query/kernel"]
    q = kernel.q if scheme == "weight_only" else kernel
    assert isinstance(q, torch.Tensor) and q.dtype == torch.int8 and q.shape == (64, 4, 16)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_torch_quant_score_matches_jax(gemma, schemes, scheme):
    jlm, _ = gemma
    jtree, lm = schemes[scheme]
    ids = np.random.RandomState(4).randint(0, 512, (2, 12))
    want = np.asarray(jlm.score({"params": jtree}, jnp.asarray(ids)))
    with torch.no_grad():
        got = lm.score(torch.tensor(ids))
    _close(got, want, SCORE_RTOL)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("search", ["greedy", "beam4"])
def test_torch_quant_generate_tokens_equal_jax(gemma, schemes, scheme, search):
    jlm, _ = gemma
    jtree, lm = schemes[scheme]
    rng = np.random.RandomState(5)
    prompt = rng.randint(4, 512, (3, 6))
    lengths = np.array([6, 4, 5])
    jkw, tkw = {}, {}
    if search == "beam4":
        jkw["sampler"], tkw["sampler"] = jax_samplers.BeamSampler(4), BeamSampler(4)
    want = np.asarray(jlm.generate({"params": jtree}, jnp.asarray(prompt),
                                   jnp.asarray(lengths), max_length=16, **jkw))
    got = lm.generate(torch.tensor(prompt), torch.tensor(lengths), max_length=16, **tkw)
    np.testing.assert_array_equal(got.numpy(), want)
    # the weights stay int8 between the steps: no dense copy was kept
    assert all(p.dtype in (torch.int8, torch.float32) for p in lm.parameters())
    assert lm.backbone.token_embedding._table_f32 is None


def test_torch_quant_int8_refusals():
    """An int8 leaf only fits a QuantDense kernel or a QuantEmbed table, and
    a W8A8 layer has no dense weight."""
    from iseg_tpu_torch.nn.norm import RMSNorm

    with pytest.raises(TypeError, match="int8"):
        convert.load_flax(RMSNorm(4, device="cpu"), {"params": {"scale": np.zeros(4, np.int8)}})
    dense = tq.QuantDense(8, 16, device="cpu")
    convert.load_flax(dense, {"params": tq.quantize_dense_tree(
        {"kernel": torch.randn(8, 16), "kernel_scale": torch.ones(16)})})
    with pytest.raises(ValueError, match="W8A8"):
        dense.dense_weight()


@pytest.mark.parametrize("k,n", [(21, 13), (2730, 1001), (64, 64)])
def test_torch_quant_padded_int_mm_bitwise(monkeypatch, k, n):
    """``padded_int_mm`` (CUDA's padding, run on the CPU): the padded product
    equals ``x.int() @ w.int()``, with the layers' column-major weight too,
    and ``dynamic_int8_dot`` through it equals the JAX function bit for bit
    (EVA02-L's SwiGLU width 2730, a vocabulary of 1001, odd widths)."""
    rng = np.random.RandomState(k + n)
    x_q = torch.tensor(rng.randint(-127, 128, (8, k)).astype(np.int8))
    w_q = torch.tensor(rng.randint(-127, 128, (k, n)).astype(np.int8))
    want = x_q.int() @ w_q.int()
    for w in (w_q, w_q.t().contiguous().t()):
        got = tq.padded_int_mm(x_q, w)
        assert got.dtype == torch.int32 and tuple(got.shape) == (8, n)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    x = (rng.randn(8, k) * 3).astype(np.float32)
    w_scale = (rng.rand(n) * 0.02 + 1e-3).astype(np.float32)
    monkeypatch.setattr(tq, "int8_matmul", tq.padded_int_mm)
    got = tq.dynamic_int8_dot(torch.tensor(x), w_q, torch.tensor(w_scale))
    jwant = jq.dynamic_int8_dot(jnp.asarray(x), jnp.asarray(w_q.numpy()), jnp.asarray(w_scale))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


# widths that are no multiples of 8: every W8A8 product's K or N (the readout's
# N = 509) takes padded_int_mm's padding
ODD_WIDTHS = dict(vocab_size=509, num_layers=2, num_heads=3, num_kv_heads=1, hidden_dim=44,
                  intermediate_dim=90, head_dim=12)


def test_torch_quant_w8a8_odd_widths_greedy_tokens_equal_jax(monkeypatch):
    """A W8A8 greedy decode of a narrow custom ``GemmaConfig`` whose widths
    are no multiples of 8, every int8 product through ``padded_int_mm``: the
    tokens equal the JAX package's."""
    from iseg_tpu_torch.nlp.gemma import GemmaConfig

    jlm = JaxLM(jax_config.GemmaConfig(**ODD_WIDTHS), dtype=jnp.float32)
    variables = jax.jit(lambda: jlm.init(jax.random.PRNGKey(3), batch=1, seq=8))()
    jtree = jq.quantize_dense_tree(jax.tree_util.tree_map(np.asarray, variables["params"]))
    lm = GemmaCausalLM(GemmaConfig(**ODD_WIDTHS), dtype=torch.float32, device="cpu")
    convert.load_flax(lm, {"params": jax.tree_util.tree_map(np.asarray, jtree)})
    assert lm.backbone.layer_0.ffw_linear.weight.dtype == torch.int8
    padded = []

    def padded_int_mm(x_q, w_q):
        padded.append((x_q.shape[1] % 8 != 0) or (w_q.shape[1] % 8 != 0))
        return tq.padded_int_mm(x_q, w_q)

    monkeypatch.setattr(tq, "int8_matmul", padded_int_mm)
    rng = np.random.RandomState(6)
    prompt = rng.randint(4, 509, (3, 6))
    lengths = np.array([6, 4, 5])
    want = np.asarray(jlm.generate({"params": jtree}, jnp.asarray(prompt), jnp.asarray(lengths),
                                   max_length=14))
    got = lm.eval().generate(torch.tensor(prompt), torch.tensor(lengths), max_length=14)
    np.testing.assert_array_equal(got.numpy(), want)
    assert padded and all(padded)
