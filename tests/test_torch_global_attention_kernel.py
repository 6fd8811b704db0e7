"""The global-attention kernels' plain versions
(``iseg_tpu_torch/ops/kernels/global_attention.py``) and their route
(``iseg_tpu_torch/nn/attention.py`` ``attention_route`` -> ``"global"``)
against ``jax.nn.dot_product_attention`` and its VJP, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda_kernels.py``
holds them against these plain versions there); here the forward's
function with its rows' lse and the backward's three passes from lse (delta,
dk and dv by key tile, dq by query tile, in the kernels' order) are held
against JAX on seeded numpy inputs ``[2, T, 3, D]`` with T in {17, 65, 130}
(ragged against the 64-row tiles) and D in {32, 64}, without a bias and with
an ``[H, T, S]`` one (the bias form: JAX's bias ``[1, H, T, S]``, whose
gradient is the broadcast summed over B; the plain passes' dbias sums the
batch rows in the kernels' order). ``global_kernel_attention`` with MOAT's
relative bias is held against the JAX package's ``MOATAttention``.

Tolerances: fp32 to 1e-5 of max(1, max |JAX|) (the same function summed in
another order and by tiles); float64 to 1e-10 of it. In float64
``jax.nn.dot_product_attention`` takes its softmax in fp32, so the float64
comparisons swap in its arithmetic in the logits' type (``_attention_f64``),
as ``tests/test_torch_global_attention_route.py`` does.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.nn import attention as jattn
from iseg_tpu_torch.nn import attention as tattn
from iseg_tpu_torch.ops.kernels import global_attention as ga

torch.set_num_threads(1)

F32_TOL, F64_TOL = 1e-5, 1e-10
B, H = 2, 3
TOKENS = (17, 65, 130)
HEAD_DIMS = (32, 64)


def _attention_f64(query, key, value, bias=None, mask=None, scale=None):
    """``jax.nn.dot_product_attention``'s XLA path with its softmax in the
    logits' type (with a bias; the global kernels take no mask)."""
    assert mask is None
    scale = 1.0 / np.sqrt(query.shape[-1]) if scale is None else scale
    logits = jnp.einsum("BTNH,BSNH->BNTS", query, key) * scale
    if bias is not None:
        logits = logits + bias
    return jnp.einsum("BNTS,BSNH->BTNH", jax.nn.softmax(logits, axis=-1), value)


def _inputs(seed, t, d, s=None):
    rng = np.random.RandomState(seed)
    s = t if s is None else s
    q, k, v = (rng.randn(B, n, H, d).astype(np.float32) for n in (t, s, s))
    w = rng.randn(B, t, H, d).astype(np.float32)
    return q, k, v, w


def _jax_ref(q, k, v, w, f64):
    """JAX's out, its q, k, v gradients for the cotangent ``w``, and each
    row's lse in log2 units ``[B, H, T]``."""
    dtype = jnp.float64 if f64 else jnp.float32
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    out, vjp = jax.vjp(jattn.dot_product_attention, *args)
    grads = vjp(jnp.asarray(w, dtype))
    logits = jnp.einsum("BTNH,BSNH->BNTS", args[0], args[1]) / np.sqrt(q.shape[-1])
    lse = jax.nn.logsumexp(logits, axis=-1) * np.log2(np.e)
    return [np.asarray(x) for x in (out, *grads, lse)]


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _plain_passes(q, k, v, w, dtype):
    """The forward's function (out, lse) and the three-pass backward from
    lse, in PyTorch, as the kernels compute them."""
    tq, tk, tv, tw = (torch.tensor(a, dtype=dtype) for a in (q, k, v, w))
    out, lse = ga.global_attention_forward_reference(tq, tk, tv)
    dq, dk, dv = ga.global_attention_backward_reference(tq, tk, tv, out, lse, tw)
    return [x.numpy() for x in (out, dq, dk, dv, lse)]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("t", TOKENS)
def test_torch_global_attention_passes_match_jax_f32(t, d):
    q, k, v, w = _inputs(t + d, t, d)
    want = _jax_ref(q, k, v, w, f64=False)
    for name, a, b in zip(("out", "dq", "dk", "dv", "lse"), _plain_passes(q, k, v, w,
                                                                        torch.float32), want):
        _close(a, b, F32_TOL, name)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("t", TOKENS)
def test_torch_global_attention_passes_match_jax_f64(monkeypatch, t, d):
    monkeypatch.setattr(jax.nn, "dot_product_attention", _attention_f64)
    q, k, v, w = _inputs(2 * t + d, t, d)
    with jax.enable_x64(True):
        want = _jax_ref(q, k, v, w, f64=True)
    for name, a, b in zip(("out", "dq", "dk", "dv", "lse"), _plain_passes(q, k, v, w,
                                                                        torch.float64), want):
        _close(a, b, F64_TOL, name)


@pytest.mark.parametrize("t", TOKENS)
def test_torch_global_attention_function_and_autograd_match_jax_f64(monkeypatch, t):
    """``global_attention`` on CPU tensors (the plain function, autograd for
    its gradient) against JAX's forward and VJP."""
    monkeypatch.setattr(jax.nn, "dot_product_attention", _attention_f64)
    q, k, v, w = _inputs(3 * t, t, 64)
    with jax.enable_x64(True):
        want = _jax_ref(q, k, v, w, f64=True)
    ts = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (q, k, v)]
    out = ga.global_attention(*ts)
    out.backward(torch.tensor(w, dtype=torch.float64))
    for name, a, b in zip(("out", "dq", "dk", "dv"), [out.detach()] + [x.grad for x in ts],
                          want):
        _close(a.numpy(), b, F64_TOL, name)


@pytest.mark.parametrize("t, s", [(65, 17), (17, 130)])
def test_torch_global_attention_passes_with_other_key_count_f64(monkeypatch, t, s):
    """T != S (cross attention): the key and query tiles of the passes
    count separately."""
    monkeypatch.setattr(jax.nn, "dot_product_attention", _attention_f64)
    q, k, v, w = _inputs(t + 7 * s, t, 32, s)
    with jax.enable_x64(True):
        want = _jax_ref(q, k, v, w, f64=True)
    for name, a, b in zip(("out", "dq", "dk", "dv", "lse"), _plain_passes(q, k, v, w,
                                                                        torch.float64), want):
        _close(a, b, F64_TOL, name)


def _bias(seed, t, s):
    """A ``[1, H, T, S]`` bias, the same for every batch row."""
    return (np.random.RandomState(seed + 1000).randn(1, H, t, s) * 0.5).astype(np.float32)


def _jax_ref_bias(q, k, v, bias, w, f64):
    """JAX's out and its q, k, v and bias gradients for the cotangent ``w``
    (the bias's ``[H, T, S]``: the ``[1, H, T, S]`` broadcast summed over
    B), and each row's lse in log2 units ``[B, H, T]``."""
    dtype = jnp.float64 if f64 else jnp.float32
    args = [jnp.asarray(a, dtype) for a in (q, k, v, bias)]
    out, vjp = jax.vjp(lambda q, k, v, b: jax.nn.dot_product_attention(q, k, v, bias=b), *args)
    dq, dk, dv, dbias = vjp(jnp.asarray(w, dtype))
    logits = jnp.einsum("BTNH,BSNH->BNTS", args[0], args[1]) / np.sqrt(q.shape[-1]) + args[3]
    lse = jax.nn.logsumexp(logits, axis=-1) * np.log2(np.e)
    return [np.asarray(x) for x in (out, dq, dk, dv, dbias[0], lse)]


def _plain_bias_passes(q, k, v, bias, w, dtype):
    """The bias form's forward (out, lse) and its passes from lse with dbias
    summed over the batch rows, in PyTorch, as the kernels compute them."""
    tq, tk, tv, tw = (torch.tensor(a, dtype=dtype) for a in (q, k, v, w))
    tb = torch.tensor(bias[0], dtype=dtype)
    out, lse = ga.global_attention_forward_reference(tq, tk, tv, bias=tb)
    grads = ga.global_attention_backward_reference(tq, tk, tv, out, lse, tw, bias=tb,
                                                   bias_grad=True)
    return [x.numpy() for x in (out, *grads, lse)]


BIAS_NAMES = ("out", "dq", "dk", "dv", "dbias", "lse")


@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("t, s", [(65, 17), (17, 130), (130, 67)])
def test_torch_global_attention_f32_passes_with_other_key_count(t, s, with_bias):
    """The plain forward and backward fed float32 q, k and v (the fp32
    form's inputs), T != S both ways with tails past a 64-row tile, with and
    without an ``[H, T, S]`` bias, against ``jax.nn.dot_product_attention``
    and its VJP in fp32: the fp32 form's passes keep delta = rowsum(dout
    out) with a bias too."""
    q, k, v, w = _inputs(3 * t + 5 * s, t, 32, s)
    if with_bias:
        bias = _bias(t + 11 * s, t, s)
        got = _plain_bias_passes(q, k, v, bias, w, torch.float32)
        want, names = _jax_ref_bias(q, k, v, bias, w, f64=False), BIAS_NAMES
    else:
        got = _plain_passes(q, k, v, w, torch.float32)
        want, names = _jax_ref(q, k, v, w, f64=False), ("out", "dq", "dk", "dv", "lse")
    for name, a, b in zip(names, got, want):
        assert a.dtype == np.float32, name
        _close(a, b, F32_TOL, name)


@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("t", TOKENS)
def test_torch_global_attention_f32_function_and_autograd_match_jax(t, with_bias):
    """``global_attention`` on float32 CPU tensors (the plain function,
    autograd for its gradients, the bias's too) against JAX's forward and
    VJP in fp32."""
    q, k, v, w = _inputs(13 * t, t, 64)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    bias = _bias(17 * t, t, t) if with_bias else None
    tb = None if bias is None else torch.tensor(bias[0], requires_grad=True)
    out = ga.global_attention(*ts, bias=tb)
    out.backward(torch.tensor(w))
    got = [out.detach()] + [x.grad for x in ts] + ([tb.grad] if with_bias else [])
    want = (_jax_ref_bias(q, k, v, bias, w, f64=False) if with_bias
            else _jax_ref(q, k, v, w, f64=False))
    for name, a, b in zip(BIAS_NAMES, got, want):
        assert a.dtype == torch.float32, name
        _close(a.numpy(), b, F32_TOL, name)



@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("t", TOKENS)
def test_torch_global_attention_bias_passes_match_jax_f32(t, d):
    q, k, v, w = _inputs(5 * t + d, t, d)
    bias = _bias(t + d, t, t)
    want = _jax_ref_bias(q, k, v, bias, w, f64=False)
    for name, a, b in zip(BIAS_NAMES, _plain_bias_passes(q, k, v, bias, w, torch.float32), want):
        _close(a, b, F32_TOL, name)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("t, s", [(17, 17), (65, 65), (130, 130), (65, 17), (17, 130),
                                  (130, 67)])
def test_torch_global_attention_bias_passes_match_jax_f64(monkeypatch, t, s, d):
    """The bias form in float64, T = S and T != S both ways, tails past a
    64-row tile."""
    monkeypatch.setattr(jax.nn, "dot_product_attention", _attention_f64)
    q, k, v, w = _inputs(7 * t + s + d, t, d, s)
    bias = _bias(t + 3 * s, t, s)
    with jax.enable_x64(True):
        want = _jax_ref_bias(q, k, v, bias, w, f64=True)
    for name, a, b in zip(BIAS_NAMES, _plain_bias_passes(q, k, v, bias, w, torch.float64), want):
        _close(a, b, F64_TOL, name)


@pytest.mark.parametrize("bias_grad", [True, False], ids=["bias_grad", "bias_const"])
@pytest.mark.parametrize("t", TOKENS)
def test_torch_global_attention_bias_function_and_autograd_match_jax_f64(monkeypatch, t,
                                                                         bias_grad):
    """``global_attention`` with a bias on CPU tensors (the plain function,
    autograd for its gradients, the bias's where it records one) against
    JAX's forward and VJP."""
    monkeypatch.setattr(jax.nn, "dot_product_attention", _attention_f64)
    q, k, v, w = _inputs(11 * t, t, 32)
    bias = _bias(2 * t, t, t)
    with jax.enable_x64(True):
        want = _jax_ref_bias(q, k, v, bias, w, f64=True)
    ts = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (q, k, v)]
    tb = torch.tensor(bias[0], dtype=torch.float64, requires_grad=bias_grad)
    out = ga.global_attention(*ts, bias=tb)
    out.backward(torch.tensor(w, dtype=torch.float64))
    got = [out.detach()] + [x.grad for x in ts] + ([tb.grad] if bias_grad else [])
    assert bias_grad or tb.grad is None
    for name, a, b in zip(BIAS_NAMES, got, want):
        _close(a.numpy(), b, F64_TOL, name)


def test_torch_global_attention_dbias_sums_the_batch_rows_in_order():
    """The plain passes' dbias is the batch rows' logit gradients added in
    increasing order, tile by tile: ds_0 + ds_1 + ds_2 formed from the
    passes' own p and delta = rowsum(p dp), to float64 rounding; without
    ``bias_grad`` the passes return the three gradients alone."""
    t, d = 70, 32
    q, k, v, w = (torch.tensor(a, dtype=torch.float64) for a in _inputs(21, t, d))
    q, k, v, w = (torch.cat([x, x[:1] * 0.5]) for x in (q, k, v, w))  # B = 3
    bias = torch.tensor(_bias(22, t, t)[0], dtype=torch.float64)
    out, lse = ga.global_attention_forward_reference(q, k, v, bias=bias)
    *_, dbias = ga.global_attention_backward_reference(q, k, v, out, lse, w, bias=bias,
                                                       bias_grad=True)
    c = np.log2(np.e) / np.sqrt(d)
    logits2 = torch.einsum("bthd,bshd->bhts", q, k) * c + bias * np.log2(np.e)
    p = torch.exp2(logits2 - lse[..., None])
    dp = torch.einsum("bthd,bshd->bhts", w, v)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))  # the bias form's delta: rowsum(p dp)
    want = torch.zeros_like(bias)
    for row in ds:
        want = want + row
    torch.testing.assert_close(dbias, want, rtol=0, atol=1e-13)
    grads = ga.global_attention_backward_reference(q, k, v, out, lse, w, bias=bias)
    assert len(grads) == 3


def test_torch_moat_attention_on_the_global_kernel_route_matches_jax_f64(monkeypatch):
    """The port's ``MOATAttention`` with its relative-position bias (a 9 x 9
    window, 81 tokens: a tail past a 64-row tile)
    with ``attention_route`` forced to ``"global"``, so its biased call goes
    through ``global_kernel_attention`` (the plain function on the CPU) with
    the bias ``[1, H, S, S]`` taking its gradient, against the JAX package's
    ``MOATAttention`` in float64: the output, the input's gradient and the
    table's."""
    from iseg_tpu.backbones import moat as jmoat
    from iseg_tpu_torch.backbones import moat as tmoat
    from iseg_tpu_torch.convert import load_flax
    from torch_zoo_helpers import keep_float64

    keep_float64(monkeypatch, jmoat)
    dim, heads, window, p = 32, 4, (9, 9), 9
    rng = np.random.RandomState(31)
    x = rng.randn(2, window[0] * window[1], dim)
    w = rng.randn(*x.shape)
    with jax.enable_x64(True):
        jmod = jmoat.MOATAttention(dim, heads, window, pos_embedding_size=p,
                                   param_dtype=jnp.float64)
        variables = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0), x))
        variables["params"]["rel_pos_embed"] = rng.randn(heads, 2 * p - 1, 2 * p - 1)
        out, vjp = jax.vjp(lambda params, a: jmod.apply({"params": params}, a),
                           variables["params"], x)
        dparams, dx = vjp(w)
    tmod = load_flax(tmoat.MOATAttention(dim, heads, pos_embedding_size=p).double(), variables)
    assert tmod.rel_pos_embed.dtype == torch.float64
    seen = []

    def recorder(q, k, v, mask=None, bias=None, scale=None):
        seen.append((tuple(bias.shape), bias.requires_grad))
        return tattn.global_kernel_attention(q, k, v, mask, bias=bias, scale=scale)

    monkeypatch.setattr(tattn, "attention_route", lambda *a, **kw: "global")
    monkeypatch.setitem(tattn._ROUTES, "global", recorder)
    tx = torch.tensor(x, requires_grad=True)
    got = tmod(tx, window)
    got.backward(torch.tensor(w))
    assert seen == [((1, heads, 81, 81), True)]
    _close(got.detach().numpy(), out, F64_TOL, "out")
    _close(tx.grad.numpy(), dx, F64_TOL, "dx")
    _close(tmod.rel_pos_embed.grad.numpy(), dparams["rel_pos_embed"], F64_TOL, "d rel_pos_embed")


def test_torch_global_attention_strided_views_of_a_packed_projection():
    """q, k, v as views of a packed ``[B, T, 3, H, D]`` projection (ViT's
    ``qkv(x).view(b, n, 3, heads, d).unbind(2)``): the plain function and
    passes read them through their strides, the kernels' alignment rule
    takes them as they are, and the result is that of contiguous copies."""
    t, d = 65, 64
    rng = np.random.RandomState(11)
    packed = torch.tensor(rng.randn(B, t, 3, H, d).astype(np.float32))
    q, k, v = packed.unbind(2)
    assert not q.is_contiguous() and all(ga.aligned(x) for x in (q, k, v))
    assert all(ga.as_aligned(x) is x for x in (q, k, v))
    w = torch.tensor(rng.randn(B, t, H, d).astype(np.float32))
    out, lse = ga.global_attention_forward_reference(q, k, v)
    grads = ga.global_attention_backward_reference(q, k, v, out, lse, w)
    copies = [x.contiguous() for x in (q, k, v)]
    out_c, lse_c = ga.global_attention_forward_reference(*copies)
    grads_c = ga.global_attention_backward_reference(*copies, out_c, lse_c, w)
    for a, b in zip((out, lse, *grads), (out_c, lse_c, *grads_c)):
        assert torch.equal(a, b)
    want = _jax_ref(*(x.numpy() for x in (q, k, v, w)), f64=False)
    for name, a, b in zip(("out", "dq", "dk", "dv", "lse"), (out, *grads, lse), want):
        _close(a.numpy(), b, F32_TOL, name)


def test_torch_global_attention_alignment_rule():
    """What the kernels take as it is: a head dim of whole 16-byte pieces
    with stride 1, base and strides multiples of 16 bytes; ``as_aligned``
    copies anything else into a tensor that is."""
    x = torch.zeros(2, 5, 3, 64, dtype=torch.bfloat16)
    assert ga.aligned(x)
    odd = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    transposed = torch.zeros(2, 5, 64, 3, dtype=torch.bfloat16).transpose(2, 3)
    narrow = torch.zeros(2, 5, 3, 68, dtype=torch.bfloat16)[..., :64]  # 136-byte head stride
    for bad in (odd, transposed, narrow):
        assert not ga.aligned(bad)
        fixed = ga.as_aligned(bad)
        assert ga.aligned(fixed) and torch.equal(fixed, bad)


@pytest.mark.parametrize("bias_shape, want", [
    (None, True),
    ((1, 16, 1025, 1025), True),  # MOAT's relative_bias(...)[None]
    ((16, 1025, 1025), True),
    ((1, 1, 1025, 1025), True),
    ((1, 16, 1, 1025), True),
    ((8, 16, 1025, 1025), False),  # varies with the batch row
    ((2, 1, 16, 1025, 1025), False),
    ((1, 16, 1025, 1024), False),
    ((1, 3, 1025, 1025), False),
])
def test_torch_global_attention_takes_bias_shape(bias_shape, want):
    """The bias form takes an additive term that broadcasts to ``[1, H, T,
    S]``: one that does not vary with the batch row."""
    assert ga.takes(torch.bfloat16, 8, 16, 1025, 1025, 64, bias_shape) is want


@pytest.mark.parametrize("d, want", [(32, True), (64, True), (72, False), (128, False)])
def test_torch_global_attention_takes_f32_bias_up_to_d64(d, want):
    """The fp32 form takes a bias up to D = 64 (its dbias kernel's ring of
    four fp32 tiles fits a block there; MOAT's head dim is 32), and no bias
    at any D up to 128."""
    assert ga.takes(torch.float32, 2, 32, 1024, 1024, d, (1, 32, 1024, 1024)) is want
    assert ga.takes(torch.float32, 2, 32, 1024, 1024, d)


@pytest.mark.parametrize("case, want", [
    (dict(), True),
    (dict(dtype=torch.float32), True),  # the fp32 form
    (dict(dtype=torch.float32, d=32), True),
    (dict(dtype=torch.float32, d=128), True),
    (dict(dtype=torch.float32, d=20), False),
    (dict(dtype=torch.float32, d=136), False),
    (dict(dtype=torch.float16), False),
    (dict(d=24), True),
    (dict(d=128), True),
    (dict(d=20), False),
    (dict(d=136), False),
    (dict(b=4095, h=16), True),
    (dict(b=4096, h=16), False),
    (dict(t=0), False),
])
def test_torch_global_attention_takes(case, want):
    """bf16 and fp32 (the split-TF32 form) at head dims that are multiples
    of 8 up to 128; nothing else."""
    args = dict(dtype=torch.bfloat16, b=8, h=16, t=1025, s=1025, d=64) | case
    if "t" in case:
        args["s"] = case["t"]
    assert ga.takes(args["dtype"], args["b"], args["h"], args["t"], args["s"], args["d"]) is want


@pytest.mark.parametrize("name, count", [("global_attention_fwd", 16),
                                         ("global_attention_bwd", 22)])
def test_torch_global_attention_source_defines_the_bound_functions(name, count):
    """Each C entry point the wrapper binds (``build``: the pointers, the
    dtype code and the shape, ldb, scale, strides and stream) is defined in
    the CUDA source with that many arguments (the library is only compiled
    on the card, so a reshaped entry point would show there first)."""
    import re
    from pathlib import Path

    src = (Path(ga.__file__).resolve().parents[2] / "csrc" / ga.SOURCE).read_text()
    found = re.search(rf"\nint {name}\(([^)]*)\)", src)
    assert found and len(found.group(1).split(",")) == count
    assert "int dtype" in found.group(1)


def test_torch_global_attention_raises_off_cpu_and_cuda():
    q = torch.zeros(1, 4, 2, 32, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ga.global_attention(q, q, q)


def test_torch_global_kernel_attention_on_the_cpu_is_the_plain_version():
    """``global_kernel_attention``: the plain function on CPU tensors, in
    one type (bf16 under bf16 autocast, whatever RoPE left q in), with a
    bias ``[1, H, T, S]`` (or one that broadcasts to it) as JAX adds it; it
    takes no mask and no bias that varies with the batch row."""
    q, k, v, _ = _inputs(12, 17, 32)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    got = tattn.global_kernel_attention(tq, tk, tv)
    _close(got.numpy(), np.asarray(jattn.dot_product_attention(q, k, v)), F32_TOL, "out")
    bias = _bias(13, 17, 17)
    want = np.asarray(jax.nn.dot_product_attention(q, k, v, bias=bias))
    for tb in (torch.tensor(bias), torch.tensor(bias[0]), torch.tensor(bias[:, :1]).double()):
        want_b = want if tb.shape[-3] == H else np.asarray(
            jax.nn.dot_product_attention(q, k, v, bias=np.broadcast_to(bias[:, :1], bias.shape)))
        got = tattn.global_kernel_attention(tq, tk, tv, bias=tb)
        _close(got.numpy(), want_b, F32_TOL, "out with a bias")
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert tattn.global_kernel_attention(tq, tk, tv.bfloat16()).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="no mask"):
        tattn.global_kernel_attention(tq, tk, tv, torch.ones(B, 1, 17, 17, dtype=torch.bool))
    with pytest.raises(ValueError, match="does not vary with the batch row"):
        tattn.global_kernel_attention(tq, tk, tv, bias=torch.zeros(B, H, 17, 17))


# (q dtype, head dim, bias: None / "grad" / "const" ([1, H, T, T]) / "batch"
# ([B, H, T, T] with a gradient), mask, records a gradient, bf16 autocast,
# on the card) -> route
ROUTE_CASES = {
    "vit_bf16": ((torch.bfloat16, 64, None, False, True, False, True), "global"),
    "moat_bf16_d32": ((torch.bfloat16, 32, None, False, True, False, True), "global"),
    "eva_fp32_under_autocast": ((torch.float32, 64, None, False, True, True, True), "global"),
    "bf16_d24": ((torch.bfloat16, 24, None, False, True, False, True), "global"),
    "bf16_d128": ((torch.bfloat16, 128, None, False, True, False, True), "global"),
    "fp32": ((torch.float32, 64, None, False, True, False, True), "global"),
    "moat_bias": ((torch.bfloat16, 32, "grad", False, True, False, True), "global"),
    "bias_without_grad": ((torch.bfloat16, 64, "const", False, True, False, True), "global"),
    "moat_bias_under_autocast": ((torch.float32, 32, "grad", False, True, True, True), "global"),
    "batch_bias": ((torch.bfloat16, 32, "batch", False, True, False, True), "kernel"),
    "fp32_bias": ((torch.float32, 32, "grad", False, True, False, True), "global"),
    "fp32_mask": ((torch.float32, 64, None, True, True, False, True), "kernel"),
    "fp32_batch_bias": ((torch.float32, 32, "batch", False, True, False, True), "kernel"),
    "fp32_bias_d128": ((torch.float32, 128, "grad", False, True, False, True), "kernel"),
    "fp32_d20": ((torch.float32, 20, None, False, True, False, True), "kernel"),
    "mask_and_bias": ((torch.bfloat16, 32, "grad", True, True, False, True), "kernel"),
    "mask": ((torch.bfloat16, 64, None, True, True, False, True), "kernel"),
    "bf16_d20": ((torch.bfloat16, 20, None, False, True, False, True), "kernel"),
    "bf16_d256": ((torch.bfloat16, 256, None, False, True, False, True), "fixed"),
    "float16": ((torch.float16, 64, None, False, True, False, True), "fixed"),
    "no_grad": ((torch.bfloat16, 64, None, False, False, False, True), "sdpa"),
    "cpu": ((torch.bfloat16, 64, None, False, True, False, False), "plain"),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_torch_global_attention_route_by_form(case):
    """``attention_route`` and the function ``dot_product_attention`` calls
    for each form, with the card faked as
    ``tests/test_torch_global_attention_route.py`` fakes it (``is_cuda``
    mocked, the routes' functions replaced by recorders)."""
    (dtype, d, bias_kind, masked, grad, autocast, on_card), want = ROUTE_CASES[case]
    t = 9
    q, k, v = (torch.zeros(2, t, 4, d, dtype=dtype, requires_grad=grad) for _ in range(3))
    bias = None if bias_kind is None else torch.zeros(2 if bias_kind == "batch" else 1, 4, t, t,
                                                       requires_grad=bias_kind != "const")
    mask = torch.ones(2, 1, t, t, dtype=torch.bool) if masked else None
    called = []
    routes = {name: (lambda *a, name=name, **kw: called.append(name) or q)
              for name in tattn._ROUTES}
    with mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                           return_value=on_card), \
            mock.patch.dict(tattn._ROUTES, routes), \
            torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        route = tattn.attention_route(q, k, v, bias, mask)
        tattn.dot_product_attention(q, k, v, mask, bias=bias)
    assert route == want and called == [want]
