"""The port's window attention against ``iseg_tpu``'s.

The same numpy-seeded inputs (N=49, D=32, ``bnw=6, H=3``, ``nW`` 1 and 3)
go through the JAX Pallas kernel in interpret mode, the JAX plain
reference, and the port's ``window_attention`` on CPU tensors (its plain
version): the output and the gradients of q, k, v and bias. fp32, rtol and
atol 1e-5 against the JAX reference (the same arithmetic in another
summation order; values of order 1), and the Pallas kernel within the
tolerance of its own tests (2e-5 forward, 3e-4 gradients). The CUDA kernel
against the plain version is the ``cuda``-marked case, which skips without
a card (more of them in ``tests/test_torch_cuda_kernels.py``).

The tensor-core kernels' arithmetic cannot run here; what can is their
routing rules, and models of their rounding points: the bf16 backward's
held against float64, the bf16 forward's (p rounded to bf16 before p v,
everything else fp32) against the JAX Pallas kernel in interpret mode on
the same bf16 inputs, at Swin's N = 49 and 144, shifted and unshifted,
within the tolerance the card's check uses (1e-2 of max(1, max |JAX|)).
The fp32 kernels' split TF32 (each operand as hi + lo, hi = tf32(x) rounded
as ``cvt.rna`` rounds, lo = x - hi truncated to TF32; each product as lo hi
+ hi lo + hi hi in fp32) is modelled in numpy, forward and backward, and held against the JAX
Pallas kernel in interpret mode on fp32 inputs within the card's fp32
tolerance (1e-4 of max(1, max |JAX|)), beside a model of one TF32 product
(hi hi alone) that must fall at least 10x further away. The window-12 fp32
backward's order of work (the forward's output and each row's lse; each
query row's delta, p from lse, ds and dq; then each key's p^T from lse,
ds^T, dv, dk and the dbias sums) is written out in PyTorch and held against float64 autograd of the plain
version (1e-12) and, in fp32, against the JAX Pallas kernel (1e-4). So is the streaming kernels' (tiles of
48 or 64 keys, the online softmax, the zero-padded head dim, rows then keys, dbias summed in chunk order)
at N = 144 and 256; the route grid holds that no float32 or bfloat16 head dim up to 128 reaches the CUDA
cores.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.ops.pallas.window_attention import window_attention as j_window_attention
from iseg_tpu.ops.pallas.window_attention import (
    window_attention_reference as j_window_attention_reference,
)
from iseg_tpu_torch.ops.kernels import window_attention as twa

torch.set_num_threads(1)

N, D = 49, 32
SCALE = 1.0 / np.sqrt(D)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _inputs(bnw=6, h=3, nw=1, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(bnw, h, N, D).astype(np.float32) for _ in range(3))
    bias = (rng.randn(h, N, N) * 0.1).astype(np.float32)
    if nw == 1:
        mask = np.zeros((1, N, N), np.float32)
    else:
        mask = np.where(rng.rand(nw, N, N) > 0.7, -100.0, 0.0).astype(np.float32)
    dout = rng.randn(bnw, h, N, D).astype(np.float32)
    return q, k, v, bias, mask, dout


def _jax_out_and_grads(fn, q, k, v, bias, mask, dout):
    args = [jnp.asarray(a) for a in (q, k, v, bias)]
    out, vjp = jax.vjp(lambda q, k, v, b: fn(q, k, v, b, jnp.asarray(mask)), *args)
    return [np.asarray(a) for a in (out, *vjp(jnp.asarray(dout)))]


def _torch_out_and_grads(fn, q, k, v, bias, mask, dout, device="cpu"):
    q, k, v, bias = (torch.tensor(a, device=device, requires_grad=True)
                     for a in (q, k, v, bias))
    out = fn(q, k, v, bias, torch.tensor(mask, device=device), SCALE)
    grads = torch.autograd.grad(out, (q, k, v, bias), torch.tensor(dout, device=device))
    return [a.detach().cpu().numpy() for a in (out, *grads)]


NAMES = ("out", "dq", "dk", "dv", "dbias")


@pytest.mark.parametrize("nw", [1, 3])
def test_torch_window_attention_matches_jax_reference_and_pallas(nw):
    data = _inputs(nw=nw, seed=nw)
    ours = _torch_out_and_grads(twa.window_attention, *data)
    ref = _jax_out_and_grads(
        lambda q, k, v, b, m: j_window_attention_reference(q, k, v, b, m, SCALE), *data)
    pallas = _jax_out_and_grads(
        lambda q, k, v, b, m: j_window_attention(q, k, v, b, m, SCALE, True), *data)
    for name, o, r, p in zip(NAMES, ours, ref, pallas):
        assert o.shape == r.shape and o.dtype == np.float32
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5, err_msg=f"{name} vs reference")
        tol = 2e-5 if name == "out" else 3e-4
        np.testing.assert_allclose(o, p, rtol=tol, atol=tol, err_msg=f"{name} vs pallas")


def test_torch_window_attention_cpu_is_the_plain_version():
    data = _inputs(nw=3)
    twa.reset_launch_counts()
    ours = _torch_out_and_grads(twa.window_attention, *data)
    plain = _torch_out_and_grads(twa.window_attention_reference, *data)
    for o, p in zip(ours, plain):
        np.testing.assert_array_equal(o, p)
    assert not any(twa.LAUNCH_COUNTS.values())  # no kernel launch on the CPU


def test_torch_window_attention_mask_selected_per_window():
    """Window i gets mask i % nW: where all but the first key are masked,
    every output row is v's first row."""
    q, k, v, bias, _, _ = _inputs(bnw=4, h=1)
    mask = np.stack([np.zeros((N, N)),
                     np.broadcast_to(np.where(np.arange(N)[None] > 0, -1e9, 0.0), (N, N))])
    out = twa.window_attention(*(torch.tensor(a) for a in (q, k, v, bias)),
                               torch.tensor(mask.astype(np.float32)), 1.0).numpy()
    for w in (1, 3):
        np.testing.assert_allclose(out[w, 0], np.broadcast_to(v[w, 0, 0], (N, D)),
                                   rtol=1e-5, atol=1e-5)
    assert np.abs(out[0, 0] - v[0, 0, 0]).max() > 0.1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_torch_window_attention_reference_dtypes(dtype):
    q, k, v, bias, mask, _ = (torch.tensor(a) for a in _inputs(bnw=2, h=2, nw=2))
    want = twa.window_attention_reference(q, k, v, bias, mask, SCALE)
    got = twa.window_attention(q.to(dtype), k.to(dtype), v.to(dtype), bias, mask, SCALE)
    assert got.dtype == dtype
    # bf16 keeps 8 bits of q, k, v and of the result; float64 inputs are
    # computed in float64, not rounded to fp32
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-6
    np.testing.assert_allclose(got.double().numpy(), want.double().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [1, 3])
def test_torch_window_attention_cuda_kernel_matches_plain_version(cuda_device, nw):
    data = _inputs(nw=nw)
    twa.reset_launch_counts()
    got = _torch_out_and_grads(twa.window_attention, *data, device=cuda_device)
    # fp32 at N = 49, D = 32: the tensor cores in split TF32, both ways
    assert twa.LAUNCH_COUNTS == {**dict.fromkeys(twa.LAUNCH_COUNTS, 0), "fwd_tf32x3": 1,
                                 "bwd_tf32x3": 1}
    want = _torch_out_and_grads(twa.window_attention_reference, *data, device=cuda_device)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("dtype,n,d,route", [
    (torch.bfloat16, 49, 32, "mma"),  # Swin, window 7
    (torch.bfloat16, 144, 32, "mma"),  # Swin, window 12
    (torch.bfloat16, 1, 16, "mma"),
    (torch.bfloat16, 64, 128, "mma"),  # the widest tiles that fit at N <= 64
    (torch.bfloat16, 64, 144, "cuda_core"),  # D > 128: the CUDA cores
    (torch.bfloat16, 65, 32, "mma"),
    (torch.bfloat16, 144, 48, "stream"),  # two sets of N = 144 tiles do not fit
    (torch.bfloat16, 145, 32, "stream"),  # N > 144
    (torch.bfloat16, 49, 24, "stream"),  # D % 16 != 0
    (torch.bfloat16, 49, 8, "stream"),
    (torch.float32, 49, 32, "tf32x3"),  # Swin, window 7: split TF32 on the tensor cores
    (torch.float32, 144, 32, "tf32x3"),  # window 12: rows, then keys, from registers
    (torch.float64, 49, 32, "cuda_core"),
    (torch.float32, 64, 80, "tf32x3"),  # the widest fp32 head dim that fits at N <= 64
    (torch.float32, 64, 88, "stream"),
    (torch.float32, 1, 8, "tf32x3"),
    (torch.float32, 65, 32, "tf32x3"),  # the first N of the window-12 kernel
    (torch.float32, 145, 32, "stream"),  # N > 144
    (torch.float32, 49, 20, "stream"),  # D % 8 != 0
    (torch.float32, 144, 56, "tf32x3"),  # the widest head dim of the window-12 kernel
    (torch.float32, 144, 64, "stream"),  # just past it
    (torch.float32, 65, 56, "tf32x3"),
    (torch.float32, 65, 80, "stream"),  # the N <= 64 limit no longer holds above 64
    (torch.float32, 144, 36, "stream"),  # D % 8 != 0 at window 12
    (torch.float32, 256, 32, "stream"),  # window 16
    (torch.bfloat16, 144, 128, "stream"),
    (torch.float32, 144, 136, "cuda_core"),  # D > 128
])
def test_torch_window_attention_backward_route(dtype, n, d, route):
    assert twa.backward_route(dtype, n, d) == route


def _bf16_values(a):
    return torch.tensor(a).bfloat16().float()


def _mma_backward_model(q, k, v, bias, mask, dout, scale):
    """The tensor-core backward's arithmetic on the CPU: logits, p, dp and
    ds in fp32 from bf16 q, k, v, do; p rounded to bf16 only as the operand
    of dv, ds only as the operand of dq and dk (fp32 sums of exact
    products); dbias summed from the fp32 ds."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    s = s + bias[None] + mask[torch.arange(q.shape[0]) % mask.shape[0]][:, None]
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p16, dout)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds16, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds16, q) * scale
    rounded = [t.bfloat16().float() for t in (dq, dk, dv)]
    return (*rounded, ds.sum(0))


@pytest.mark.parametrize("nw", [1, 3])
def test_torch_window_attention_mma_rounding_points_within_bf16_tolerance(nw):
    """At N = 49, D = 32 the rounding points of the tensor-core backward
    keep dq, dk, dv within 1e-2 of max(1, max |exact|) of float64 autograd
    of the plain version, and dbias (from fp32 ds) within 1e-3: the
    tolerances the card's tests hold the kernel to."""
    q, k, v, bias, mask, dout = _inputs(bnw=12, h=3, nw=nw, seed=10 + nw)
    q, k, v, dout = (_bf16_values(a) for a in (q, k, v, dout))
    bias, mask = torch.tensor(bias), torch.tensor(mask)
    got = _mma_backward_model(q, k, v, bias, mask, dout, SCALE)
    leaves = [t.double().requires_grad_(True) for t in (q, k, v, bias)]
    out = twa.window_attention_reference(*leaves, mask.double(), SCALE)
    want = torch.autograd.grad(out, leaves, dout.double())
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        tol = (1e-3 if name == "dbias" else 1e-2) * max(1.0, float(w.abs().max()))
        err = float((g.double() - w).abs().max())
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("dtype,n,d,route", [
    (torch.bfloat16, 49, 32, "mma"),  # Swin, window 7
    (torch.bfloat16, 144, 32, "mma"),  # Swin, window 12
    (torch.bfloat16, 1, 16, "mma"),
    (torch.bfloat16, 64, 128, "mma"),  # the widest head dim
    (torch.bfloat16, 49, 144, "cuda_core"),  # too wide
    (torch.bfloat16, 145, 32, "stream"),  # N > 144
    (torch.bfloat16, 49, 24, "stream"),  # D % 16 != 0
    (torch.bfloat16, 49, 8, "stream"),
    (torch.bfloat16, 49, 0, "cuda_core"),
    (torch.float32, 49, 32, "tf32x3"),  # Swin, window 7: split TF32 on the tensor cores
    (torch.float32, 144, 32, "tf32x3"),  # window 12: the widest head dim that fits there
    (torch.float16, 49, 32, "cuda_core"),
    (torch.float64, 49, 32, "cuda_core"),
    (torch.float32, 64, 128, "tf32x3"),  # the widest fp32 head dim
    (torch.float32, 49, 136, "cuda_core"),  # too wide
    (torch.float32, 1, 8, "tf32x3"),
    (torch.float32, 145, 32, "stream"),  # N > 144
    (torch.float32, 49, 20, "stream"),  # D % 8 != 0
    (torch.float32, 144, 40, "tf32x3"),  # window 12, wide heads: q from device memory
    (torch.float32, 144, 64, "tf32x3"),
    (torch.float32, 100, 32, "tf32x3"),
    (torch.float32, 144, 128, "tf32x3"),  # the widest head dim at window 12
    (torch.float32, 144, 136, "cuda_core"),  # just past it
    (torch.float32, 65, 40, "tf32x3"),  # the first N of the wide forward
    (torch.float32, 144, 60, "stream"),  # D % 8 != 0 at window 12
    (torch.bfloat16, 144, 64, "mma"),  # the widest bf16 tiles that fit at N = 144
    (torch.bfloat16, 144, 80, "stream"),
    (torch.bfloat16, 144, 128, "stream"),  # the tensor-core tiles do not fit a block
    (torch.bfloat16, 256, 32, "stream"),  # window 16
])
def test_torch_window_attention_forward_route(dtype, n, d, route):
    assert twa.forward_route(dtype, n, d) == route


@pytest.mark.parametrize("dtype,n,d,keeps", [
    (torch.float32, 144, 32, True),  # window 12: the rows-then-keys backward reads out and lse
    (torch.float32, 65, 56, True),
    (torch.float32, 49, 32, False),  # window 7: the N <= 64 backward computes its softmax
    (torch.float32, 144, 64, True),  # the streaming backward reads them too
    (torch.bfloat16, 144, 32, False),
])
def test_torch_window_attention_keeps_lse_only_for_the_window12_f32_backward(dtype, n, d, keeps):
    assert twa.keeps_lse(dtype, n, d) == keeps


def test_torch_window_attention_source_defines_every_bound_function():
    """Every C function the wrapper binds (``build``) is defined in the CUDA
    source with the argument count it is bound with (the library is only
    compiled on the card, so a missing or reshaped entry point would show
    there first)."""
    import re
    from pathlib import Path

    src = (Path(twa.__file__).resolve().parents[2] / "csrc" / twa.SOURCE).read_text()
    names = {"window_attention_bwd_chunks": 2, "window_attention_fwd": 15,
             "window_attention_bwd": 20, "window_attention_fwd_mma": 16,
             "window_attention_bwd_mma": 20, "window_attention_fwd_tf32x3": 16,
             "window_attention_bwd_tf32x3": 22, "window_attention_fwd_stream": 18,
             "window_attention_bwd_stream": 24, "window_attention_fwd_stream_chunks": 5,
             "window_attention_bwd_stream_chunks": 5}
    names.update({f"window_attention_{w}_{r}_chunks": 4 for w in ("fwd", "bwd")
                  for r in ("mma", "tf32x3")})
    for name, count in names.items():
        found = re.search(rf"\nint {name}\(([^)]*)\)", src)
        assert found, name
        assert len(found.group(1).split(",")) == count, (name, found.group(1))


def _mma_forward_model(q, k, v, bias, mask, scale):
    """The tensor-core forward's arithmetic on the CPU: logits and softmax
    in fp32 from bf16 q, k, v; p rounded to bf16 as the operand of p v (fp32
    sums of exact products); the output rounded to bf16."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    s = s + bias[None] + mask[torch.arange(q.shape[0]) % mask.shape[0]][:, None]
    p16 = torch.softmax(s, dim=-1).bfloat16().float()
    return torch.einsum("bhqk,bhkd->bhqd", p16, v).bfloat16()


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("window", [7, 12], ids=["n49", "n144"])
def test_torch_window_attention_mma_forward_rounding_within_bf16_tolerance(window, shifted):
    """The tensor-core forward's one new rounding point (p to bf16 before
    p v) keeps the output within 1e-2 of max(1, max |JAX|) of the JAX Pallas
    kernel (interpret mode) on the same bf16 inputs: the tolerance the card
    holds the kernel to against its plain version."""
    from iseg_tpu_torch.backbones.swin import _shift_attn_mask

    n, d, h = window * window, 32, 2
    side = 2 * window  # four windows per image
    mask = (_shift_attn_mask(side, side, window, window // 2) if shifted
            else np.zeros((1, n, n), np.float32))
    rng = np.random.RandomState(window + int(shifted))
    bnw = 2 * mask.shape[0] if shifted else 4
    q, k, v = (_bf16_values(rng.randn(bnw, h, n, d).astype(np.float32)) for _ in range(3))
    bias = (rng.randn(h, n, n) * 0.1).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    got = _mma_forward_model(q, k, v, torch.tensor(bias), torch.tensor(mask), scale).float()
    want = j_window_attention(*(jnp.asarray(t.numpy(), jnp.bfloat16) for t in (q, k, v)),
                              jnp.asarray(bias), jnp.asarray(mask), scale, True)
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-2 * max(1.0, np.abs(want).max())
    err = float(np.abs(got.numpy() - want).max())
    assert err <= tol, f"{err:.3e} > {tol:.3e}"
    assert err > 0.0  # the rounding point is there: the two are not the same arithmetic


def _tf32(x):
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to
    nearest, ties away from zero, 10 stored mantissa bits (the low 13 bits
    of the fp32 pattern cleared)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_truncated(x):
    """float32 ``x`` truncated to TF32: the low 13 bits cleared."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def test_torch_window_attention_tf32_rounding_is_to_nearest_ties_away():
    ulp = 2.0 ** -10  # a TF32 ulp at 1.0
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23, 1 + 1.5 * ulp,
                  3 * 2.0 ** -130, 0.0], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3 * 2.0 ** -130, 0.0], np.float32)
    np.testing.assert_array_equal(_tf32(x), want)


def test_torch_window_attention_tf32_split_keeps_nan():
    """A NaN whose rounding carries into the sign bit (the GPU's own NaN,
    0x7FFFFFFF, and its negative) has a zero hi, but its lo, truncated, stays
    NaN, and so does every split product that takes it."""
    x = np.array([0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000], np.uint32).view(np.float32)
    hi = _tf32(x)
    assert not np.isnan(hi[:2]).any()
    assert np.isnan(_tf32_truncated(x - hi)).all()
    prod = _split_product("i,i->i", x, np.ones(3, np.float32))
    assert np.isnan(prod).all()


def _split_product(spec, a, b, correction=True):
    """``einsum(spec, a, b)`` as the split-TF32 kernels compute it: each
    operand split as ``hi = tf32(x)``, ``lo = x - hi`` truncated, and the product
    summed as ``lo hi + hi lo + hi hi`` in fp32 (each product of two TF32
    values is exact in fp32). ``correction=False`` keeps ``hi hi`` alone:
    one TF32 product."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = np.einsum(spec, a_hi, b_hi)
    if correction:
        a_lo, b_lo = _tf32_truncated(a - a_hi), _tf32_truncated(b - b_hi)
        out = np.einsum(spec, a_lo, b_hi) + np.einsum(spec, a_hi, b_lo) + out
    return out.astype(np.float32)


def _split_tf32_model(q, k, v, bias, mask, dout, scale, correction=True):
    """The split-TF32 forward and backward of window attention in numpy
    (fp32 everywhere else): out, dq, dk, dv, dbias."""
    mm = functools.partial(_split_product, correction=correction)
    scale = np.float32(scale)
    s = mm("bhqd,bhkd->bhqk", q, k) * scale
    s = s + bias[None] + mask[np.arange(q.shape[0]) % mask.shape[0]][:, None]
    e = np.exp(s - s.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    dp = mm("bhqd,bhkd->bhqk", dout, v)
    ds = p * (dp - (dp * p).sum(-1, keepdims=True))
    return (mm("bhqk,bhkd->bhqd", p, v), mm("bhqk,bhkd->bhqd", ds, k) * scale,
            mm("bhqk,bhqd->bhkd", ds, q) * scale, mm("bhqk,bhqd->bhkd", p, dout), ds.sum(0))


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("window", [7, 12], ids=["n49", "n144"])
def test_torch_window_attention_split_tf32_model_matches_pallas(window, shifted):
    """The split-TF32 arithmetic of the fp32 tensor-core kernels keeps out,
    dq, dk, dv and dbias within 1e-4 of max(1, max |JAX|) of the JAX Pallas
    kernel (interpret mode, fp32), and one TF32 product (hi hi alone) lies
    at least 10x further away on out and dq: the check would catch a kernel
    that dropped the correction products."""
    from iseg_tpu_torch.backbones.swin import _shift_attn_mask

    n, d, h = window * window, 32, 2
    side = 2 * window  # four windows per image
    mask = (_shift_attn_mask(side, side, window, window // 2) if shifted
            else np.zeros((1, n, n), np.float32))
    rng = np.random.RandomState(100 + window + int(shifted))
    bnw = 2 * mask.shape[0] if shifted else 4
    q, k, v, dout = (rng.randn(bnw, h, n, d).astype(np.float32) for _ in range(4))
    bias = (rng.randn(h, n, n) * 0.1).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    want = _jax_out_and_grads(
        lambda q, k, v, b, m: j_window_attention(q, k, v, b, m, scale, True),
        q, k, v, bias, mask, dout)
    split = _split_tf32_model(q, k, v, bias, mask, dout, scale)
    single = _split_tf32_model(q, k, v, bias, mask, dout, scale, correction=False)
    for name, got, w, one in zip(NAMES, split, want, single):
        assert got.dtype == np.float32, name
        err = float(np.abs(got - w).max())
        tol = 1e-4 * max(1.0, float(np.abs(w).max()))
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"
        if name in ("out", "dq"):
            err_one = float(np.abs(one - w).max())
            assert err_one >= 10 * err, f"{name}: hi hi alone {err_one:.3e}, split {err:.3e}"


LOG2E = 1.4426950408889634


def _rows_then_keys_backward(q, k, v, bias, mask, dout, scale):
    """The window-12 split-TF32 backward's order of work, in the input's
    dtype (exact products: the split TF32 is modelled above). The forward
    keeps out = p v and each row's lse, the log2-sum-exp2 of its logits in
    log2 units. Then per query row: delta = rowsum(do out); s = q k^T scale +
    bias + mask, p = exp2(s log2(e) - lse), dp = do v^T, ds = p (dp - delta),
    dq = ds k scale; then per key: s^T = k q^T scale + bias^T + mask^T, p^T =
    exp2(s^T log2(e) - lse), dp^T = v do^T, ds^T = p^T (dp^T - delta), dv =
    p^T do, dk = ds^T q scale; dbias = ds^T summed over the windows in order,
    transposed."""
    mask_b = mask[torch.arange(q.shape[0]) % mask.shape[0]][:, None]
    # forward: out and lse
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale + bias[None] + mask_b
    x = s * LOG2E
    top = x.amax(-1, keepdim=True)
    total = torch.exp2(x - top).sum(-1, keepdim=True)
    lse = top + torch.log2(total)  # [bnw, H, N, 1]
    out = torch.einsum("bhqk,bhkd->bhqd", torch.exp2(x - lse), v)
    # rows
    delta = (dout * out).sum(-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale + bias[None] + mask_b
    p = torch.exp2(s * LOG2E - lse)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout, v)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    # keys: [bnw, H, key, query]
    st = (torch.einsum("bhkd,bhqd->bhkq", k, q) * scale + bias[None].transpose(-1, -2)
          + mask_b.transpose(-1, -2))
    pt = torch.exp2(st * LOG2E - lse.transpose(-1, -2))
    dpt = torch.einsum("bhkd,bhqd->bhkq", v, dout)
    dst = pt * (dpt - delta.transpose(-1, -2))
    dv = torch.einsum("bhkq,bhqd->bhkd", pt, dout)
    dk = torch.einsum("bhkq,bhqd->bhkd", dst, q) * scale
    dbias = torch.zeros_like(bias)
    for w in range(q.shape[0]):
        dbias = dbias + dst[w].transpose(-1, -2)
    return dq, dk, dv, dbias


def _window12_inputs(shifted, seed, dtype=np.float32):
    from iseg_tpu_torch.backbones.swin import _shift_attn_mask

    window, d, h = 12, 32, 2
    n = window * window
    side = 2 * window  # four windows per image
    mask = (_shift_attn_mask(side, side, window, window // 2) if shifted
            else np.zeros((1, n, n), np.float32))
    rng = np.random.RandomState(300 + seed + int(shifted))
    bnw = 2 * mask.shape[0] if shifted else 4
    q, k, v, dout = (rng.randn(bnw, h, n, d).astype(dtype) for _ in range(4))
    bias = (rng.randn(h, n, n) * 0.1).astype(dtype)
    return q, k, v, bias, mask.astype(dtype), dout, 1.0 / np.sqrt(d)


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_torch_window_attention_rows_then_keys_backward_matches_autograd_f64(shifted):
    """In float64 the rows-then-keys order gives autograd's dq, dk, dv and
    dbias of the plain version within 1e-12 of max(1, max |autograd|): p
    recomputed from the forward's lse and delta = rowsum(do out) are the
    same function."""
    q, k, v, bias, mask, dout, scale = (torch.tensor(a) if isinstance(a, np.ndarray) else a
                                        for a in _window12_inputs(shifted, 0, np.float64))
    got = _rows_then_keys_backward(q, k, v, bias, mask, dout, scale)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    out = twa.window_attention_reference(*leaves, mask, scale)
    want = torch.autograd.grad(out, leaves, dout)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert g.dtype == torch.float64, name
        err = float((g - w).abs().max())
        tol = 1e-12 * max(1.0, float(w.abs().max()))
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_torch_window_attention_rows_then_keys_backward_matches_pallas(shifted):
    """In fp32 the rows-then-keys order keeps dq, dk, dv and dbias within
    1e-4 of max(1, max |JAX|) of the JAX Pallas kernel's gradients
    (interpret mode, fp32) at N = 144: the card's fp32 tolerance."""
    q, k, v, bias, mask, dout, scale = _window12_inputs(shifted, 1)
    want = _jax_out_and_grads(
        lambda q, k, v, b, m: j_window_attention(q, k, v, b, m, scale, True),
        q, k, v, bias, mask, dout)[1:]
    got = _rows_then_keys_backward(*(torch.tensor(a) for a in (q, k, v, bias, mask, dout)),
                                   np.float32(scale))
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert g.dtype == torch.float32, name
        err = float(np.abs(g.numpy() - w).max())
        tol = 1e-4 * max(1.0, float(np.abs(w).max()))
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


def _tile_rows(n):
    """The CUDA source's ``stream_tile_rows``: 48 or 64 rows a tile, whichever
    pads the window's last tile less (64 on a tie)."""
    return 48 if -n % 48 < -n % 64 else 64


def _streaming_steps(n, step):
    """The key ranges of the streaming forward's softmax steps: tiles of
    ``_tile_rows(n)`` keys, each walked ``step`` keys at a time."""
    rows = _tile_rows(n)
    return [slice(t0 + k0, min(n, t0 + k0 + step, t0 + rows))
            for t0 in range(0, n, rows) for k0 in range(0, rows, step) if t0 + k0 < n]


def _streaming_forward(q, k, v, bias, mask, scale, step):
    """The streaming forward's arithmetic (``wa_fwd_stream_kernel``), exact
    products: the head dim zero-padded to a multiple of 8, keys in tiles of
    48 or 64 walked ``step`` at a time (64 at D <= 64, 32 above) with an
    online softmax in log2 units (running max, the sum and the output
    rescaled by exp2 of the max's change), the output divided by the sum at
    the end, and each row's lse = max + log2(sum)."""
    bnw, h, n, d = q.shape
    pad = (-d) % 8
    q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    mask_b = mask[torch.arange(bnw) % mask.shape[0]][:, None]
    top = torch.full((bnw, h, n, 1), -torch.inf, dtype=q.dtype)
    total = torch.zeros((bnw, h, n, 1), dtype=q.dtype)
    acc = torch.zeros_like(q)
    for keys in _streaming_steps(n, step):
        s = (torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, keys]) * scale + bias[None][..., keys]
             + mask_b[..., keys])
        x = s * LOG2E
        new = torch.maximum(top, x.amax(-1, keepdim=True))
        corr = torch.exp2(top - new)
        p = torch.exp2(x - new)
        total = total * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, keys])
        top = new
    return (acc / total)[..., :d], top + torch.log2(total)


def _streaming_backward(q, k, v, bias, mask, dout, out, lse, scale, windows_per_chunk):
    """The streaming backward's order of work (``wa_bwd_stream_kernel``),
    exact products, the head dim zero-padded as the forward pads it: the
    query rows' delta = rowsum(do out), then per key tile (48 or 64 keys), p
    from the forward's lse, ds = p (dp - delta) and dq += ds k; then per
    query tile, p^T, ds^T, dv += p^T do and dk += ds^T q; dbias = ds^T summed
    over each chunk's windows in order, then over the chunks in order."""
    bnw, h, n, d = q.shape
    pad = (-d) % 8
    q, k, v, dout, out = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v, dout, out))
    mask_b = mask[torch.arange(bnw) % mask.shape[0]][:, None]
    delta = (dout * out).sum(-1, keepdim=True)
    dq = torch.zeros_like(q)
    rows = _tile_rows(n)
    for k0 in range(0, n, rows):
        keys = slice(k0, min(n, k0 + rows))
        s = (torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, keys]) * scale + bias[None][..., keys]
             + mask_b[..., keys])
        p = torch.exp2(s * LOG2E - lse)
        dp = torch.einsum("bhqd,bhkd->bhqk", dout, v[:, :, keys])
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", p * (dp - delta), k[:, :, keys])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    dst = torch.zeros((bnw, h, n, n), dtype=q.dtype)  # [window, head, key, query]
    bias_t, mask_t = bias[None].transpose(-1, -2), mask_b.transpose(-1, -2)
    for q0 in range(0, n, rows):
        queries = slice(q0, min(n, q0 + rows))
        st = (torch.einsum("bhkd,bhqd->bhkq", k, q[:, :, queries]) * scale
              + bias_t[..., queries] + mask_t[..., queries])
        pt = torch.exp2(st * LOG2E - lse[:, :, queries].transpose(-1, -2))
        dpt = torch.einsum("bhkd,bhqd->bhkq", v, dout[:, :, queries])
        dst[..., queries] = pt * (dpt - delta[:, :, queries].transpose(-1, -2))
        dv = dv + torch.einsum("bhkq,bhqd->bhkd", pt, dout[:, :, queries])
        dk = dk + torch.einsum("bhkq,bhqd->bhkd", dst[..., queries], q[:, :, queries])
    dbias = torch.zeros_like(bias)
    for c0 in range(0, bnw, windows_per_chunk):
        part = torch.zeros_like(bias)
        for w in range(c0, min(bnw, c0 + windows_per_chunk)):
            part = part + dst[w].transpose(-1, -2)
        dbias = dbias + part
    return dq[..., :d] * scale, dk[..., :d] * scale, dv[..., :d], dbias


def _streaming_inputs(window, d, shifted, seed, dtype):
    from iseg_tpu_torch.backbones.swin import _shift_attn_mask

    n, h = window * window, 2
    side = 2 * window  # four windows per image
    mask = (_shift_attn_mask(side, side, window, window // 2) if shifted
            else np.zeros((1, n, n), np.float32))
    rng = np.random.RandomState(500 + seed + 7 * window + d + int(shifted))
    bnw = 2 * mask.shape[0] if shifted else 3
    q, k, v, dout = (rng.randn(bnw, h, n, d).astype(dtype) for _ in range(4))
    bias = (rng.randn(h, n, n) * 0.1).astype(dtype)
    return q, k, v, bias, mask.astype(dtype), dout, 1.0 / np.sqrt(d)


STREAMING_SHAPES = [(12, 36), (12, 64), (16, 32)]  # (window, head dim): N 144, 144, 256


def _streaming_out_and_grads(q, k, v, bias, mask, dout, scale):
    step = 64 if q.shape[3] <= 64 else 32
    out, lse = _streaming_forward(q, k, v, bias, mask, scale, step)
    return (out, *_streaming_backward(q, k, v, bias, mask, dout, out, lse, scale, 2))


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("window,d", STREAMING_SHAPES, ids=["n144_d36", "n144_d64", "n256_d32"])
def test_torch_window_attention_streaming_kernels_match_autograd_f64(window, d, shifted):
    """In float64 the streaming kernels' order of work (key tiles, the online
    softmax, the zero-padded head dim, the lse, rows then keys, dbias summed
    in chunk order) gives the plain version's output and autograd's dq, dk,
    dv and dbias within 1e-12 of max(1, max |autograd|)."""
    torch.set_num_threads(1)
    data = [torch.tensor(a) if isinstance(a, np.ndarray) else a
            for a in _streaming_inputs(window, d, shifted, 0, np.float64)]
    q, k, v, bias, mask, dout, scale = data
    got = _streaming_out_and_grads(q, k, v, bias, mask, dout, scale)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    out = twa.window_attention_reference(*leaves, mask, scale)
    want = (out.detach(), *torch.autograd.grad(out, leaves, dout))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        err = float((g - w).abs().max())
        tol = 1e-12 * max(1.0, float(w.abs().max()))
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("window,d", STREAMING_SHAPES, ids=["n144_d36", "n144_d64", "n256_d32"])
def test_torch_window_attention_streaming_kernels_match_pallas(window, d, shifted):
    """In fp32 the streaming kernels' order of work keeps out, dq, dk, dv and
    dbias within 1e-4 of max(1, max |JAX|) of the JAX Pallas kernel
    (interpret mode, fp32): the card's fp32 tolerance."""
    torch.set_num_threads(1)
    q, k, v, bias, mask, dout, scale = _streaming_inputs(window, d, shifted, 1, np.float32)
    want = _jax_out_and_grads(
        lambda q, k, v, b, m: j_window_attention(q, k, v, b, m, scale, True),
        q, k, v, bias, mask, dout)
    got = _streaming_out_and_grads(*(torch.tensor(a) for a in (q, k, v, bias, mask, dout)),
                                   np.float32(scale))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        err = float(np.abs(g.numpy() - w).max())
        tol = 1e-4 * max(1.0, float(np.abs(w).max()))
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("n", [1, 49, 64, 65, 144, 145, 196, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_torch_window_attention_route_grid_has_no_cuda_core_shape(dtype, n):
    """No float32 or bfloat16 shape with D <= 128 routes to the CUDA-core
    kernels, and every backward that reads the forward's lse follows a
    forward that writes it (every route but the CUDA cores')."""
    torch.set_num_threads(1)
    for d in (8, 20, 24, 32, 36, 56, 60, 64, 80, 88, 128):
        fwd, bwd = twa.forward_route(dtype, n, d), twa.backward_route(dtype, n, d)
        assert "cuda_core" not in (fwd, bwd), (dtype, n, d, fwd, bwd)
        if twa.keeps_lse(dtype, n, d):  # the mma forward writes lse above N = 64 only
            assert fwd in ("tf32x3", "stream") or (fwd == "mma" and n > 64), (dtype, n, d, fwd)
        if bwd == "stream":
            assert twa.keeps_lse(dtype, n, d), (dtype, n, d)
        if fwd == "mma":
            assert twa._fwd_mma_fits(n, d), (n, d)
