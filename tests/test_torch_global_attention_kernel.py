"""The global-attention kernels' plain versions
(``iseg_tpu_torch/ops/kernels/global_attention.py``) and their route
(``iseg_tpu_torch/nn/attention.py`` ``attention_route`` -> ``"global"``)
against ``jax.nn.dot_product_attention`` and its VJP, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda_kernels.py``
holds them against these plain versions there); here the forward's
function with its rows' lse and the backward's three passes from lse (delta,
dk and dv by key tile, dq by query tile, in the kernels' order) are held
against JAX on seeded numpy inputs ``[2, T, 3, D]`` with T in {17, 65, 130}
(ragged against the 64-row tiles) and D in {32, 64}.

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
    logits' type."""
    del bias, mask  # the global kernels take neither
    scale = 1.0 / np.sqrt(query.shape[-1]) if scale is None else scale
    logits = jnp.einsum("BTNH,BSNH->BNTS", query, key) * scale
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


@pytest.mark.parametrize("case, want", [
    (dict(), True),
    (dict(dtype=torch.float32), False),
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
    args = dict(dtype=torch.bfloat16, b=8, h=16, t=1025, s=1025, d=64) | case
    if "t" in case:
        args["s"] = case["t"]
    assert ga.takes(args["dtype"], args["b"], args["h"], args["t"], args["s"], args["d"]) is want


def test_torch_global_attention_raises_off_cpu_and_cuda():
    q = torch.zeros(1, 4, 2, 32, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ga.global_attention(q, q, q)


def test_torch_global_kernel_attention_on_the_cpu_is_the_plain_version():
    """``global_kernel_attention``: the plain function on CPU tensors, in
    one type (bf16 under bf16 autocast, whatever RoPE left q in); it takes
    no bias and no mask."""
    q, k, v, _ = _inputs(12, 17, 32)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    got = tattn.global_kernel_attention(tq, tk, tv)
    _close(got.numpy(), np.asarray(jattn.dot_product_attention(q, k, v)), F32_TOL, "out")
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert tattn.global_kernel_attention(tq, tk, tv.bfloat16()).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="no mask and no bias"):
        tattn.global_kernel_attention(tq, tk, tv, torch.ones(B, 1, 17, 17, dtype=torch.bool))
    with pytest.raises(ValueError, match="no mask and no bias"):
        tattn.global_kernel_attention(tq, tk, tv, bias=torch.zeros(1, H, 17, 17))


# (q dtype, head dim, bias: None / "grad" / "const", mask, records a
# gradient, bf16 autocast, on the card) -> route
ROUTE_CASES = {
    "vit_bf16": ((torch.bfloat16, 64, None, False, True, False, True), "global"),
    "moat_bf16_d32": ((torch.bfloat16, 32, None, False, True, False, True), "global"),
    "eva_fp32_under_autocast": ((torch.float32, 64, None, False, True, True, True), "global"),
    "bf16_d24": ((torch.bfloat16, 24, None, False, True, False, True), "global"),
    "bf16_d128": ((torch.bfloat16, 128, None, False, True, False, True), "global"),
    "fp32": ((torch.float32, 64, None, False, True, False, True), "kernel"),
    "moat_bias": ((torch.bfloat16, 32, "grad", False, True, False, True), "kernel"),
    "bias_without_grad": ((torch.bfloat16, 64, "const", False, True, False, True), "kernel"),
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
    bias = None if bias_kind is None else torch.zeros(1, 4, t, t,
                                                       requires_grad=bias_kind == "grad")
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
