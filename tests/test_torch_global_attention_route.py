"""Global attention's route through the window-attention kernels
(``iseg_tpu_torch/nn/attention.py`` ``kernel_attention`` and
``attention_route``, ``iseg_tpu_torch/ops/kernels/window_attention.py`` with
``bias=None`` / ``mask=None``) against ``iseg_tpu.nn.attention`` and
``jax.nn.dot_product_attention``, on the CPU.

On CPU tensors ``window_attention`` is its plain version, so these tests
hold the layout the card's kernels are given (one window per batch row, the
heads folded into the window or the head axis where a term varies by head
or a gradient-taking bias by batch row, T != S padded) against the JAX
functions on seeded numpy inputs: ``[2, 37, 4, 16]`` (T no multiple of 16).

Tolerances: fp32 forwards to 1e-6 of max |out| (fp32 sums in another
order); float64 forwards and the q, k, v (and bias) gradients of a weighted
sum of the output to 1e-10 of each one's max magnitude. In float64
``jax.nn.dot_product_attention`` takes its softmax in fp32, so the float64
comparisons swap in its arithmetic in the logits' type (``_attention_f64``),
as ``tests/test_torch_attention.py`` does.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.nn import attention as jattn
from iseg_tpu_torch.nn import attention as tattn
from iseg_tpu_torch.ops.kernels import window_attention as twa

torch.set_num_threads(1)

F32_TOL, F64_TOL = 1e-6, 1e-10
B, T, H, D = 2, 37, 4, 16


def _attention_f64(query, key, value, bias=None, mask=None, scale=None):
    """``jax.nn.dot_product_attention``'s XLA path with its softmax in the
    logits' type."""
    scale = 1.0 / np.sqrt(query.shape[-1]) if scale is None else scale
    logits = jnp.einsum("BTNH,BSNH->BNTS", query, key) * scale
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = jnp.where(mask, logits, -0.7 * jnp.finfo(logits.dtype).max)
    return jnp.einsum("BNTS,BSNH->BTNH", jax.nn.softmax(logits, axis=-1), value)


def _inputs(seed, t=T, s=T):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, n, H, D).astype(np.float32) for n in (t, s, s))
    w = rng.randn(B, t, H, D)
    return q, k, v, w


# (bias shape or None, bias takes a gradient, boolean mask shape or None, T, S)
CASES = {
    "no_bias_no_mask": (None, False, None, T, T),
    "moat_bias": ((1, H, T, T), True, None, T, T),
    "batch_mask": (None, False, (B, 1, T, T), T, T),
    "head_mask": (None, False, (B, H, T, T), T, T),
    "batch_bias_with_grad": ((B, H, T, T), True, None, T, T),
    "bias_no_grad_and_mask": ((B, 1, T, T), False, (1, H, T, T), T, T),
    "moat_bias_and_batch_mask": ((1, H, T, T), True, (B, 1, T, T), T, T),
    "more_keys": (None, False, (B, 1, 29, T), 29, T),
    "more_queries": ((1, H, T, 29), True, None, T, 29),
}


def _case(name, seed=0):
    bias_shape, bias_grad, mask_shape, t, s = CASES[name]
    q, k, v, w = _inputs(seed, t, s)
    rng = np.random.RandomState(seed + 100)
    bias = None if bias_shape is None else (rng.randn(*bias_shape) * 0.5).astype(np.float32)
    mask = None
    if mask_shape is not None:
        mask = rng.rand(*mask_shape) < 0.7
        mask[(0,) * (len(mask_shape) - 2) + (3,)] = False  # a fully masked row attends uniformly
    return q, k, v, w, bias, bias_grad, mask


def _jax_out(q, k, v, bias, mask, f64):
    args = [jnp.asarray(a, jnp.float64 if f64 else jnp.float32) for a in (q, k, v)]
    jb = None if bias is None else jnp.asarray(bias, args[0].dtype)
    jm = None if mask is None else jnp.asarray(mask)
    if f64:
        return _attention_f64(*args, bias=jb, mask=jm)
    if jb is None:
        return jattn.dot_product_attention(*args, jm)
    return jax.nn.dot_product_attention(*args, bias=jb, mask=jm)


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.abs(want).max() > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=what)


def test_torch_global_reference_without_bias_or_mask_matches_jax_f32():
    """``window_attention_reference`` with ``bias=None, mask=None`` on the
    ``[B, H, T, D]`` layout is JAX's global attention."""
    q, k, v, _ = _inputs(1)
    qh, kh, vh = (torch.tensor(a).permute(0, 2, 1, 3) for a in (q, k, v))
    got = twa.window_attention_reference(qh, kh, vh, None, None, 1.0 / np.sqrt(D))
    want = jax.jit(jattn.dot_product_attention)(q, k, v)
    _close(got.permute(0, 2, 1, 3).numpy(), want, F32_TOL, "out")


def test_torch_global_reference_without_bias_or_mask_matches_jax_f64(monkeypatch):
    monkeypatch.setattr(jax.nn, "dot_product_attention", _attention_f64)
    q, k, v, w = _inputs(2)
    with jax.enable_x64(True):
        args = [jnp.asarray(a, jnp.float64) for a in (q, k, v)]
        want = jattn.dot_product_attention(*args)
        j_grads = jax.grad(lambda *a: jnp.sum(jattn.dot_product_attention(*a) * w),
                           (0, 1, 2))(*args)
    ts = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (q, k, v)]
    out = twa.window_attention_reference(*(t.permute(0, 2, 1, 3) for t in ts), None, None,
                                         1.0 / np.sqrt(D)).permute(0, 2, 1, 3)
    _close(out.detach().numpy(), want, F64_TOL, "out")
    (out * torch.tensor(w)).sum().backward()
    for t, j, name in zip(ts, j_grads, "qkv"):
        _close(t.grad.numpy(), j, F64_TOL, f"d{name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_global_kernel_layout_matches_jax_f32(case):
    """``kernel_attention``'s layout (the card's kernels' inputs), fp32."""
    q, k, v, _, bias, _, mask = _case(case, 3)
    got = tattn.kernel_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                 None if mask is None else torch.tensor(mask),
                                 bias=None if bias is None else torch.tensor(bias))
    assert got.dtype == torch.float32
    _close(got.numpy(), _jax_out(q, k, v, bias, mask, False), F32_TOL, "out")


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_global_kernel_layout_matches_jax_f64_grads(case):
    """``kernel_attention``'s layout in float64: the forward and the q, k, v
    gradients, and the bias's where it takes one."""
    q, k, v, w, bias, bias_grad, mask = _case(case, 4)
    with jax.enable_x64(True):
        args = [jnp.asarray(a, jnp.float64) for a in (q, k, v)]
        jb = None if bias is None else jnp.asarray(bias, jnp.float64)
        jm = None if mask is None else jnp.asarray(mask)
        want = _attention_f64(*args, bias=jb, mask=jm)
        argnums = (0, 1, 2, 3) if bias_grad else (0, 1, 2)
        j_grads = jax.grad(lambda q, k, v, b: jnp.sum(_attention_f64(q, k, v, b, jm) * w),
                           argnums)(*args, jb)
    ts = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (q, k, v)]
    tb = None if bias is None else torch.tensor(bias, dtype=torch.float64,
                                                requires_grad=bias_grad)
    out = tattn.kernel_attention(*ts, None if mask is None else torch.tensor(mask), bias=tb)
    assert out.dtype == torch.float64
    _close(out.detach().numpy(), want, F64_TOL, "out")
    (out * torch.tensor(w)).sum().backward()
    for t, j, name in zip(ts + ([tb] if bias_grad else []), j_grads, ["q", "k", "v", "bias"]):
        _close(t.grad.numpy(), j, F64_TOL, f"d{name}")


@pytest.mark.parametrize("case", ["no_bias_no_mask", "moat_bias", "batch_mask", "head_mask",
                                  "batch_bias_with_grad"])
def test_torch_global_kernel_operands(case):
    """What the kernel is handed: no bias and no mask where the call has
    neither; MOAT's bias as the ``[H, N, N]`` bias; a per-batch mask as
    ``[B, N, N]``; a per-head mask with the heads folded into the windows
    (bnw = B H, one head); a gradient-taking per-batch bias with them folded
    into the heads (one window, B H heads)."""
    q, k, v, _, bias, bias_grad, mask = _case(case, 5)
    seen = []

    def record(qh, kh, vh, b, m, scale):
        seen.append((tuple(qh.shape), None if b is None else tuple(b.shape),
                     None if m is None else tuple(m.shape), b is not None and b.requires_grad))
        return twa.window_attention(qh, kh, vh, b, m, scale)

    tb = None if bias is None else torch.tensor(bias, requires_grad=bias_grad)
    with mock.patch.object(tattn, "window_attention", record):
        tattn.kernel_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                               None if mask is None else torch.tensor(mask), bias=tb)
    want = {"no_bias_no_mask": ((B, H, T, D), None, None, False),
            "moat_bias": ((B, H, T, D), (H, T, T), None, True),
            "batch_mask": ((B, H, T, D), None, (B, T, T), False),
            "head_mask": ((B * H, 1, T, D), None, (B * H, T, T), False),
            "batch_bias_with_grad": ((1, B * H, T, D), (B * H, T, T), None, True)}[case]
    assert seen == [want]


def test_torch_global_kernel_autocast_takes_one_dtype():
    """Under autocast q, k and v go in the autocast type (SDPA's), whatever
    RoPE left them in; the output is in it too."""
    q, k, v, _ = _inputs(6)
    seen = []

    def record(qh, kh, vh, b, m, scale):
        seen.append({qh.dtype, kh.dtype, vh.dtype})
        return twa.window_attention(qh, kh, vh, b, m, scale)

    with mock.patch.object(tattn, "window_attention", record), \
            torch.autocast("cpu", dtype=torch.bfloat16):
        out = tattn.kernel_attention(torch.tensor(q), torch.tensor(k),
                                     torch.tensor(v).bfloat16())
    assert seen == [{torch.bfloat16}] and out.dtype == torch.bfloat16


@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "card"])
@pytest.mark.parametrize("grad", ["none", "q", "bias", "no_grad_mode"])
def test_torch_global_attention_route(on_card, grad):
    """Card + a recorded gradient -> the global-attention kernels (fp32 at
    D = 16 with a ``[1, H, T, S]`` bias is theirs since their fp32 form);
    card and none -> SDPA; the CPU -> the plain version. ``is_cuda`` is
    mocked: the routes' functions are replaced by recorders, so nothing runs
    on a card."""
    q, k, v, _ = _inputs(7, t=5, s=5)
    qt, kt, vt = (torch.tensor(a) for a in (q, k, v))
    bias = torch.zeros(1, H, 5, 5, requires_grad=grad == "bias")
    if grad in ("q", "no_grad_mode"):
        qt.requires_grad_()
    called = []
    routes = {name: (lambda *a, name=name, **kw: called.append(name) or qt)
              for name in ("global", "kernel", "sdpa", "plain")}
    with mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                           return_value=on_card), \
            mock.patch.dict(tattn._ROUTES, routes), \
            torch.set_grad_enabled(grad != "no_grad_mode"):
        route = tattn.attention_route(qt, kt, vt, bias)
        tattn.dot_product_attention(qt, kt, vt, bias=bias)
    want = "plain" if not on_card else ("global" if grad in ("q", "bias") else "sdpa")
    assert route == want and called == [want]


def test_torch_global_kernel_route_without_bias_or_mask_is_streaming():
    """The route of a call without a bias and a mask that records a gradient
    on the card (``is_cuda`` mocked): bf16 and f32 with a head dim that is
    a multiple of 8 up to 128 take the global-attention kernels
    (``"global"``, at ViT-L's T = 1025 and EVA02-L's patch-dropped 769 too);
    any other head dim up to 128 the streaming window-attention kernels
    (``"kernel"``), which take every N at D <= 128 without a mask; nothing
    above."""
    for dtype in (torch.float32, torch.bfloat16):
        for n in (49, 144, 769, 1025, 4096):
            for d in (24, 32, 64, 128):
                assert twa.forward_route(dtype, n, d, False) == "stream"
                assert twa.backward_route(dtype, n, d, False) == "stream"
        assert twa.forward_route(dtype, 1025, 256, False) == "cuda_core"
    with mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                           return_value=True):
        for dtype in (torch.float32, torch.bfloat16):
            for n in (49, 769, 1025):
                for d in (20, 24, 32, 64, 128, 256):
                    q = torch.zeros(1, n, 2, d, dtype=dtype, requires_grad=True)
                    route = tattn.attention_route(q, q, q)
                    if d > 128:
                        assert route == "fixed"
                    elif d % 8 == 0:
                        assert route == "global"
                    else:
                        assert route == "kernel"


def test_torch_eva_block_bf16_within_twice_jax_bf16_noise():
    """One EVA02 block in bf16 against the JAX package's in bf16. The JAX
    block keeps its T x T logits in bf16 (``iseg_tpu/backbones/eva.py``'s
    ``preferred_element_type=logits_dtype``), the port takes them in fp32
    (its attention's ``promote_types(dtype, float32)``), and the two round
    the projections, the norms and the residual sums at other points. The
    port's bf16 output is held to twice the JAX bf16 block's own distance
    from the JAX fp32 block on the same weights (each relative to max |fp32
    out|): measured here 3.99e-3 against a JAX bf16 noise of 5.13e-3 (bound
    1.03e-2); the fp32 blocks agree to 3.9e-7."""
    from iseg_tpu.backbones import eva as jeva
    from iseg_tpu_torch.backbones import eva as teva
    from iseg_tpu_torch.convert import load_flax

    dim, heads, (gh, gw) = 64, 4, (4, 6)
    sin, cos = jeva.build_rope_2d(gh, gw, dim // heads)
    # the class token's identity rows, as the Eva models prepend them
    sin = np.concatenate([np.zeros((1, sin.shape[1]), np.float32), sin])
    cos = np.concatenate([np.ones((1, cos.shape[1]), np.float32), cos])
    x = np.random.RandomState(9).randn(2, 1 + gh * gw, dim).astype(np.float32)
    j32 = jeva.EvaBlock(dim, heads)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda a: j32.init(jax.random.PRNGKey(0), a, sin, cos))(x))
    want32 = np.asarray(jax.jit(lambda v, a: j32.apply(v, a, sin, cos))(variables, x))
    j16 = jeva.EvaBlock(dim, heads, dtype=jnp.bfloat16)
    want16 = np.asarray(jax.jit(lambda v, a: j16.apply(v, a, sin, cos))(variables, x)
                        .astype(jnp.float32))
    block = load_flax(teva.EvaBlock(dim, heads), variables).eval()
    args = (torch.tensor(x), torch.tensor(sin), torch.tensor(cos))
    with torch.no_grad():
        got32 = block(*args).numpy()
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got16 = block(*args).float().numpy()
    scale = np.abs(want32).max()
    jax_noise = np.abs(want16 - want32).max() / scale
    assert np.abs(got32 - want32).max() <= 1e-5 * scale
    assert 0 < np.abs(got16 - want16).max() / scale <= 2 * jax_noise


def test_torch_global_stand_in_for_a_single_operand():
    """The streaming kernels are built with both operands only: a mask
    alone gets a zero ``[H, N, N]`` bias standing in, a bias alone a zero
    ``[1, N, N]`` mask, neither both; both pass as they are."""
    q = torch.zeros(2, 3, 5, 8)
    bias, mask = torch.ones(3, 5, 5), torch.ones(2, 5, 5)

    def zero(t, shape):
        return t.shape == shape and t.dtype == torch.float32 and not t.any()

    b, m = twa._stand_in(q, None, mask)
    assert m is mask and zero(b, (3, 5, 5))
    b, m = twa._stand_in(q, bias, None)
    assert b is bias and zero(m, (1, 5, 5))
    b, m = twa._stand_in(q, None, None)
    assert zero(b, (3, 5, 5)) and zero(m, (1, 5, 5))
    assert twa._stand_in(q, bias, mask) == (bias, mask)


def test_torch_global_kernel_whole_masked_row_enters_as_zeros():
    """A row that the mask masks whole enters the kernel with a zero query
    and zero additive terms (logits 0: uniform, as the reference's -0.7 of
    the type's max gives), not a row of fills: the kernels scale the row's
    max by log2(e), which would take -0.7 of fp32's max to -inf. Every other
    masked logit keeps the fill."""
    q, k, v, _, bias, _, mask = _case("bias_no_grad_and_mask", 10)
    seen = []

    def record(qh, kh, vh, b, m, scale):
        seen.append((qh.detach().clone(), m.detach().clone()))
        return twa.window_attention(qh, kh, vh, b, m, scale)

    with mock.patch.object(tattn, "window_attention", record):
        tattn.kernel_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                               torch.tensor(mask), bias=torch.tensor(bias))
    (qh, km), = seen  # heads folded into the windows: [B H, 1, T, D], mask [B H, T, T]
    whole = ~np.broadcast_to(mask, (B, H, T, T)).any(-1).reshape(B * H, T)
    assert whole.any() and not whole.all()
    km = km.numpy()
    assert not qh.reshape(B * H, T, D).numpy()[whole].any()
    assert not km[whole].any()
    fill = -0.7 * np.finfo(np.float32).max
    keep = np.broadcast_to(mask, (B, H, T, T)).reshape(B * H, T, T)
    assert (km[~whole] <= fill * 0.99).sum() == (~keep[~whole]).sum()
    assert np.isfinite(km).all()


@pytest.mark.parametrize("shape", ["d136", "float64", "float16_autocast"])
def test_torch_global_attention_route_for_shapes_the_kernels_lack(shape):
    """On the card, a call that records a gradient at a shape the streaming
    kernels are not built for (a head dim above 128, float64, float16 under
    autocast) takes ``plain_attention`` (fixed-order products), never the
    kernels, which would raise. ``is_cuda`` is mocked, as above."""
    d = 136 if shape == "d136" else D
    dtype = torch.float64 if shape == "float64" else torch.float32
    qt, kt, vt = (torch.randn(B, 9, H, d, dtype=dtype) for _ in range(3))
    qt.requires_grad_()
    called = []
    routes = {name: (lambda *a, name=name, **kw: called.append(name) or qt)
              for name in ("kernel", "fixed", "sdpa", "plain")}
    autocast = torch.autocast("cpu", dtype=torch.float16, enabled=shape == "float16_autocast")
    with mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                           return_value=True), mock.patch.dict(tattn._ROUTES, routes), autocast:
        route = tattn.attention_route(qt, kt, vt)
        tattn.dot_product_attention(qt, kt, vt)
    assert route == "fixed" and called == ["fixed"]


@pytest.mark.parametrize("case", ["float64", "float16_autocast"])
def test_torch_plain_attention_in_one_type(case):
    """``plain_attention`` (the card's route at shapes the kernels lack) is
    the reference in one type: in float64 the reference exactly; under
    float16 autocast the reference on float16 inputs outside autocast
    (logits and softmax in fp32, the mask's fill kept finite, a row masked
    whole uniform), in float16, within 1e-3 of max |out| of the fp32 one."""
    q, k, v, _, bias, _, mask = _case("moat_bias_and_batch_mask", 11)
    tm, tb = torch.tensor(mask), torch.tensor(bias)
    if case == "float64":
        args = [torch.tensor(a, dtype=torch.float64) for a in (q, k, v)]
        got = tattn.plain_attention(*args, tm, bias=tb.double())
        want = tattn.dot_product_attention_reference(*args, tm, bias=tb.double())
        assert got.dtype == torch.float64 and torch.equal(got, want)
        return
    args = [torch.tensor(a) for a in (q, k, v)]
    with torch.autocast("cpu", dtype=torch.float16):
        got = tattn.plain_attention(*args, tm, bias=tb)
    want = tattn.dot_product_attention_reference(*args, tm, bias=tb).numpy()
    assert got.dtype == torch.float16 and torch.isfinite(got).all()
    _close(got.float().numpy(), want, 1e-3, "out")
