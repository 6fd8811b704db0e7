"""Grouped dense-local deformable sampling (DCNv3's bounded-offset sampler).

Counterpart of ``iseg_tpu/ops/pallas/deform_local.py`` (the Pallas kernel,
one group) in the grouped form the model calls,
``iseg_tpu/ops/deform.py::dense_local_flat``, with that function's
signature::

    out[p, g*gc + j] = sum_o w_o[p, g] * x[p + o, g*gc + j]
    w_o[p, g] = sum_tap m[p, g, tap] * tri(d_y - o_y) * tri(d_x - o_x)
    d_y = tap_y + clamp(off_dy[p, g, tap], -r, r),  tri(t) = max(0, 1 - |t|)

``x [B, H, W, G*gc]`` (channel ``g*gc + j``), ``off_dy``, ``off_dx`` and
``modulation`` each ``[B, H, W, G*K*K]`` (index ``g*K*K + tap``, taps
y-major), ``o`` over the ``(2 (half + r) + 1)^2`` integer displacements,
zeros outside the map. Offsets beyond ``+-r`` are clamped, not dropped.
With ``groups=1`` this is the Pallas kernel's function.

On CUDA tensors the forward and the backward are the hand-written kernels
of ``iseg_tpu_torch/csrc/deform_local.cu`` (their note says what bounds
them on the H100); on CPU tensors the plain PyTorch versions below, the
displacement loops of ``_dense_local_flat_math`` and
``_dense_local_flat_bwd_math`` written out, compute the same function and
the same gradients. A CUDA tensor never falls back to the plain version: a
wrong device, dtype, shape or layout, or a failed launch, raises. All
three kernels work from tiles in shared memory: the forward and the map
gradients take their corner rows from x staged over a tile grown by the
corners' reach (the forward forms each tap's corner and weights once, then
sums the rows per pixel, group and channel vector), the input gradient is a
tiled gather that holds the displacement weights of its tile's pixels. A
reach ``(K - 1) / 2 + max_offset`` whose tiles would not fit a block even
for one pixel raises too, and so do more than 288 taps a group (K above 16)
or a group too wide for a one-pixel tile of x. DCN calibration pins radii
up to 6 (reach 7 at K = 3).

The backward is hand-written on both devices (the saved tensors are the
four inputs; the weights are recomputed) and follows the JAX VJP's
conventions, which autograd of the plain forward would not:

* ``d tri/dt = -sign(t)`` for ``|t| < 1``: 0 at ``t = 0`` and at
  ``|t| = 1``, so an integer displacement gets no offset gradient;
* the clamp passes the gradient in full wherever ``-r <= offset <= r``,
  inclusive, and nothing outside.

Types: ``x`` in float32 or bfloat16, each of the three maps in float32 or
bfloat16 on its own (float64 too on the CPU); everything is computed in
fp32 (float64 for float64 inputs); the output has ``x``'s dtype and each
gradient its input's. ``x`` may be strided in batch, height and width (a
spatial transpose is taken as a view) as long as its channels are
contiguous; the maps and the incoming gradient are contiguous. Every
output of both kernels is bitwise repeatable: all sums run in a fixed
order, without atomics.

Where no gradient is recorded (serving, ``torch.export``) the forward is
the operator ``iseg::dense_local_fwd`` (:func:`dense_local_fwd`); with a
gradient, the autograd Function of the two kernels.

``LAUNCH_COUNTS`` counts kernel launches (``"fwd"``, ``"bwd"``): one per
launch of each kernel, nowhere else.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LAUNCH_COUNTS = {"fwd": 0, "bwd": 0}

SOURCE = "deform_local.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DOES_NOT_FIT = -1


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


def build():
    """Compile (if needed) and load the CUDA library; returns the
    :class:`~iseg_tpu_torch.ops.kernels._build.Built` record."""
    from iseg_tpu_torch.ops.kernels import _build

    built = _build.load(SOURCE)
    lib = built.lib
    if not getattr(lib, "_iseg_bound", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        tail = [i32] * 11 + [i64] * 3 + [i32, ptr]
        lib.deform_local_fwd.argtypes = [ptr] * 5 + tail
        lib.deform_local_fwd.restype = i32
        lib.deform_local_bwd.argtypes = [ptr] * 9 + tail
        lib.deform_local_bwd.restype = i32
        lib._iseg_bound = True
    return built


def _check_inputs(x, off_dy, off_dx, modulation, groups, kernel_size, max_offset) -> None:
    """Shape and argument checks common to both devices."""
    if x.ndim != 4:
        raise ValueError(f"dense_local_flat: x {tuple(x.shape)} must be [B,H,W,C]")
    if groups < 1 or kernel_size < 1 or max_offset < 0:
        raise ValueError(f"dense_local_flat: groups {groups}, kernel_size {kernel_size}, "
                         f"max_offset {max_offset} out of range")
    b, h, w, c = x.shape
    if c % groups != 0:
        raise ValueError(f"dense_local_flat: channels {c} not divisible by groups {groups}")
    want = (b, h, w, groups * kernel_size * kernel_size)
    for name, t in (("off_dy", off_dy), ("off_dx", off_dx), ("modulation", modulation)):
        if tuple(t.shape) != want:
            raise ValueError(f"dense_local_flat: {name} {tuple(t.shape)} must be "
                             f"[B,H,W,G*K*K] = {want}")
        if t.device != x.device:
            raise ValueError(f"dense_local_flat: {name} on {t.device}, x on {x.device}")


def _check_cuda_inputs(x, off_dy, off_dx, modulation, g_out=None) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"deform_local kernel: x on {x.device}; it takes CUDA tensors")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"deform_local kernel takes float32 or bfloat16 x, got {x.dtype}")
    if x.shape[3] > 1 and x.stride(3) != 1:
        raise ValueError("deform_local kernel: x's channels must have stride 1, got strides "
                         f"{x.stride()}")
    for name, t in (("off_dy", off_dy), ("off_dx", off_dx), ("modulation", modulation)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"deform_local kernel takes float32 or bfloat16 {name}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"deform_local kernel takes a contiguous {name}")
    if g_out is not None:
        if g_out.device != x.device or g_out.dtype != x.dtype or g_out.shape != x.shape:
            raise ValueError(f"deform_local kernel: the incoming gradient {tuple(g_out.shape)} "
                             f"{g_out.dtype} on {g_out.device} must match x "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        if not g_out.is_contiguous():
            raise ValueError("deform_local kernel takes a contiguous incoming gradient")


def vector_width(x: torch.Tensor, groups: int, *others: torch.Tensor) -> int:
    """Channels a thread loads at once: the largest of 8, 4, 2, 1 that keeps
    a load within 16 bytes, divides the group's channels, and to which every
    row of ``x`` (through its strides) and of ``others`` (contiguous tensors
    of x's shape) is aligned."""
    gc = x.shape[3] // groups
    size = x.element_size()
    for v in (8, 4, 2):
        if (v * size <= 16 and gc % v == 0 and all(s % v == 0 for s in x.stride()[:3])
                and all(t.data_ptr() % (v * size) == 0 for t in (x, *others))):
            return v
    return 1


def _raise_on(err: int, what: str, x: torch.Tensor, groups: int) -> None:
    if err == _DOES_NOT_FIT:
        raise ValueError(f"deform_local {what} kernel: cannot launch x {tuple(x.shape)} "
                         f"{x.dtype} with {groups} groups")
    if err != 0:
        raise RuntimeError(f"deform_local {what} kernel launch failed: CUDA error {err}")


def _tail_args(x, off_dy, off_dx, modulation, groups, kernel_size, max_offset, vec):
    b, h, w, c = x.shape
    return [_DTYPE_CODES[x.dtype], _DTYPE_CODES[off_dy.dtype], _DTYPE_CODES[off_dx.dtype],
            _DTYPE_CODES[modulation.dtype], b, h, w, c, groups, kernel_size, max_offset,
            x.stride(0), x.stride(1), x.stride(2), vec,
            torch.cuda.current_stream(x.device).cuda_stream]


def _launch_fwd(x, off_dy, off_dx, modulation, groups, kernel_size, max_offset):
    _check_cuda_inputs(x, off_dy, off_dx, modulation)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    lib = build().lib
    vec = vector_width(x, groups, out)
    err = lib.deform_local_fwd(
        x.data_ptr(), off_dy.data_ptr(), off_dx.data_ptr(), modulation.data_ptr(),
        out.data_ptr(),
        *_tail_args(x, off_dy, off_dx, modulation, groups, kernel_size, max_offset, vec))
    _raise_on(err, "forward", x, groups)
    LAUNCH_COUNTS["fwd"] += 1
    return out


def _launch_bwd(x, off_dy, off_dx, modulation, g_out, groups, kernel_size, max_offset):
    """(d_x, d_off_dy, d_off_dx, d_modulation) of ``sum(out * g_out)``."""
    _check_cuda_inputs(x, off_dy, off_dx, modulation, g_out)
    d_x = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    d_dy, d_dx, d_m = (torch.empty_like(t) for t in (off_dy, off_dx, modulation))
    if x.numel() == 0:
        return d_x, d_dy, d_dx, d_m
    lib = build().lib
    vec = vector_width(x, groups, g_out, d_x)
    err = lib.deform_local_bwd(
        x.data_ptr(), off_dy.data_ptr(), off_dx.data_ptr(), modulation.data_ptr(),
        g_out.data_ptr(), d_x.data_ptr(), d_dy.data_ptr(), d_dx.data_ptr(), d_m.data_ptr(),
        *_tail_args(x, off_dy, off_dx, modulation, groups, kernel_size, max_offset, vec))
    _raise_on(err, "backward", x, groups)
    LAUNCH_COUNTS["bwd"] += 1
    return d_x, d_dy, d_dx, d_m


# ------------------------------------------------------------ plain versions

def shift_nhwc(arr: torch.Tensor, oy: int, ox: int) -> torch.Tensor:
    """``out[:, i, j] = arr[:, i - oy, j - ox]`` of an NHWC tensor, zeros
    where that falls outside."""
    h, w = arr.shape[1], arr.shape[2]
    padded = F.pad(arr, (0, 0, max(ox, 0), max(-ox, 0), max(oy, 0), max(-oy, 0)))
    ys, xs = max(-oy, 0), max(-ox, 0)
    return padded[:, ys:ys + h, xs:xs + w]


def _displacements(off_dy, off_dx, groups, kernel_size, max_offset, f):
    """Clamped offsets plus the y-major tap grid, each [B, H, W, G*K*K]."""
    k, r = kernel_size, max_offset
    tap = torch.arange(k, dtype=f, device=off_dy.device) - (k - 1) // 2
    tap_y = tap.repeat_interleave(k).repeat(groups)
    tap_x = tap.repeat(k).repeat(groups)
    dy = torch.clamp(off_dy.to(f), -r, r) + tap_y
    dx = torch.clamp(off_dx.to(f), -r, r) + tap_x
    return dy, dx


def _tri(u: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - u.abs(), min=0.0)


def _dtri(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u.abs() < 1.0, -torch.sign(u), torch.zeros_like(u))


def deform_dense_local_flat_reference(x, off_dy, off_dx, modulation, groups,
                                      kernel_size=3, max_offset=2):
    """Plain PyTorch version of the forward: the displacement loop of
    shifted multiply-adds, fp32 inside (float64 for float64 inputs), result
    in x's dtype."""
    b, h, w, c = x.shape
    g, kk = groups, kernel_size * kernel_size
    gc = c // g
    lim = (kernel_size - 1) // 2 + max_offset
    f = torch.promote_types(x.dtype, torch.float32)
    dy, dx = _displacements(off_dy, off_dx, g, kernel_size, max_offset, f)
    m = modulation.to(f)
    xf = x.to(f)
    out = torch.zeros((b, h, w, c), dtype=f, device=x.device)
    for oy in range(-lim, lim + 1):
        ty = _tri(dy - oy)
        for ox in range(-lim, lim + 1):
            t = m * ty * _tri(dx - ox)
            w_o = t.reshape(b, h, w, g, kk).sum(-1)  # [B,H,W,G]
            wexp = w_o.repeat_interleave(gc, dim=-1)  # [B,H,W,C]
            out = out + wexp * shift_nhwc(xf, -oy, -ox)
    return out.to(x.dtype)


def deform_dense_local_flat_backward_reference(x, off_dy, off_dx, modulation, g_out, groups,
                                               kernel_size=3, max_offset=2):
    """Plain PyTorch version of the backward: ``(d_x, d_off_dy, d_off_dx,
    d_modulation)`` of ``sum(out * g_out)`` by the same displacement loop,
    with the weights recomputed from the four inputs."""
    b, h, w, c = x.shape
    g, kk, r = groups, kernel_size * kernel_size, max_offset
    gc = c // g
    lim = (kernel_size - 1) // 2 + r
    f = torch.promote_types(x.dtype, torch.float32)
    ody, odx = off_dy.to(f), off_dx.to(f)
    dy, dx = _displacements(off_dy, off_dx, g, kernel_size, r, f)
    m = modulation.to(f)
    gf = g_out.to(f)
    xf = x.to(f)
    d_x = torch.zeros((b, h, w, c), dtype=f, device=x.device)
    d_dy, d_dx, d_m = torch.zeros_like(dy), torch.zeros_like(dx), torch.zeros_like(m)
    for oy in range(-lim, lim + 1):
        ty, dty = _tri(dy - oy), _dtri(dy - oy)
        for ox in range(-lim, lim + 1):
            tx, dtx = _tri(dx - ox), _dtri(dx - ox)
            w_o = (m * ty * tx).reshape(b, h, w, g, kk).sum(-1)
            wexp = w_o.repeat_interleave(gc, dim=-1)
            # d_x[q] += (wexp * g_out)[q - o]
            d_x = d_x + shift_nhwc(wexp * gf, oy, ox)
            # per-group channel sum of g_out * x[p + o], replicated to the taps
            s_g = (gf * shift_nhwc(xf, -oy, -ox)).reshape(b, h, w, g, gc).sum(-1)
            d_t = s_g.repeat_interleave(kk, dim=-1)
            d_m = d_m + d_t * ty * tx
            d_dy = d_dy + d_t * m * tx * dty
            d_dx = d_dx + d_t * m * ty * dtx
    # the clamp passes the gradient only inside its (inclusive) window
    d_dy = torch.where((ody >= -r) & (ody <= r), d_dy, torch.zeros_like(d_dy))
    d_dx = torch.where((odx >= -r) & (odx <= r), d_dx, torch.zeros_like(d_dx))
    return (d_x.to(x.dtype), d_dy.to(off_dy.dtype), d_dx.to(off_dx.dtype),
            d_m.to(modulation.dtype))


# ------------------------------------------------------------------ dispatch

def _forward(x, off_dy, off_dx, modulation, groups, kernel_size, max_offset):
    if x.device.type == "cpu":
        return deform_dense_local_flat_reference(x, off_dy, off_dx, modulation, groups,
                                                 kernel_size, max_offset)
    if x.device.type == "cuda":
        return _launch_fwd(x, off_dy, off_dx, modulation, groups, kernel_size, max_offset)
    raise ValueError(f"dense_local_flat: no kernel for device {x.device}")


def _backward(x, off_dy, off_dx, modulation, g_out, groups, kernel_size, max_offset):
    if x.device.type == "cpu":
        return deform_dense_local_flat_backward_reference(
            x, off_dy, off_dx, modulation, g_out, groups, kernel_size, max_offset)
    if x.device.type == "cuda":
        return _launch_bwd(x, off_dy, off_dx, modulation, g_out.contiguous(), groups,
                           kernel_size, max_offset)
    raise ValueError(f"dense_local_flat: no kernel for device {x.device}")


class _DenseLocalFlat(torch.autograd.Function):
    """Forward and hand-written backward; the saved tensors are the inputs."""

    @staticmethod
    def forward(ctx, x, off_dy, off_dx, modulation, groups, kernel_size, max_offset):
        ctx.save_for_backward(x, off_dy, off_dx, modulation)
        ctx.args = (groups, kernel_size, max_offset)
        return _forward(x, off_dy, off_dx, modulation, groups, kernel_size, max_offset)

    @staticmethod
    def backward(ctx, g_out):
        grads = _backward(*ctx.saved_tensors, g_out, *ctx.args)
        return (*grads, None, None, None)


@torch.library.custom_op("iseg::dense_local_fwd", mutates_args=())
def dense_local_fwd(x: torch.Tensor, off_dy: torch.Tensor, off_dx: torch.Tensor,
                    modulation: torch.Tensor, groups: int, kernel_size: int,
                    max_offset: int) -> torch.Tensor:
    """The inference forward as one operator, ``iseg::dense_local_fwd``:
    the kernel on CUDA tensors (its checks, which read the tensors'
    addresses, run here), the plain version on CPU tensors.
    :func:`deform_dense_local_flat` calls it where no gradient is recorded,
    so ``torch.export`` traces it as one node (by its fake below)."""
    return _forward(x, off_dy, off_dx, modulation, groups, kernel_size, max_offset)


@dense_local_fwd.register_fake
def _dense_local_fwd_fake(x, off_dy, off_dx, modulation, groups, kernel_size, max_offset):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def deform_dense_local_flat(x, off_dy, off_dx, modulation, groups, kernel_size=3,
                            max_offset=2):
    """Grouped dense-local sampling (see the module docstring).

    Args:
      x: ``[B, H, W, G*gc]``, group-major channels.
      off_dy, off_dx: ``[B, H, W, G*K*K]`` per-tap offsets, clamped to
        ``+-max_offset``.
      modulation: ``[B, H, W, G*K*K]`` per-tap weights.
    Returns ``[B, H, W, G*gc]`` in x's dtype. Stride and dilation 1 only.
    """
    groups, kernel_size, max_offset = int(groups), int(kernel_size), int(max_offset)
    _check_inputs(x, off_dy, off_dx, modulation, groups, kernel_size, max_offset)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dense_local_flat: no kernel for device {x.device}")
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, off_dy, off_dx, modulation))):
        return dense_local_fwd(x, off_dy, off_dx, modulation, groups, kernel_size, max_offset)
    return _DenseLocalFlat.apply(x, off_dy, off_dx, modulation, groups, kernel_size,
                                 max_offset)
