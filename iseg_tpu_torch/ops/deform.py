"""Deformable-convolution sampling (counterpart of ``iseg_tpu/ops/deform.py``).

Plain functions on NHWC tensors, with the JAX package's layouts and
quirks. The gathers are index gathers in plain PyTorch, as they were XLA
gathers there; the bounded-offset grouped sampler :func:`dense_local_flat`
is the one function behind which a kernel sits
(:mod:`iseg_tpu_torch.ops.kernels.deform_local`: hand-written CUDA kernels
on the card, their plain versions on the CPU).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from iseg_tpu_torch.ops.kernels.deform_local import deform_dense_local_flat, shift_nhwc


def bilinear_gather(x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``x`` [N, H, W, C] at float ``coords`` [N, P, 2] (y, x order,
    pixel units). Out-of-bounds samples contribute zero. Returns [N, P, C]."""
    n, h, w, c = x.shape
    y = coords[..., 0].to(torch.float32)
    xf = coords[..., 1].to(torch.float32)
    y0, x0 = torch.floor(y), torch.floor(xf)
    ty, tx = y - y0, xf - x0
    flat = x.reshape(n, h * w, c)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).to(torch.long)
        xc = xi.clamp(0, w - 1).to(torch.long)
        idx = (yc * w + xc)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx) * valid[..., None].to(x.dtype)

    w00 = ((1 - ty) * (1 - tx))[..., None].to(x.dtype)
    w01 = ((1 - ty) * tx)[..., None].to(x.dtype)
    w10 = (ty * (1 - tx))[..., None].to(x.dtype)
    w11 = (ty * tx)[..., None].to(x.dtype)
    return (gather(y0, x0) * w00 + gather(y0, x0 + 1) * w01
            + gather(y0 + 1, x0) * w10 + gather(y0 + 1, x0 + 1) * w11)


def deform_im2col(x: torch.Tensor, offsets: torch.Tensor, kernel_size: int = 3,
                  stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """Gather the K*K deformed taps for every output position.

    Args:
      x: [N, H, W, C] input.
      offsets: [N, Ho, Wo, K*K, 2] (dy, dx) learned offsets, taps y-major,
        tap centres at integer pixels.
    Returns [N, Ho, Wo, K*K, C] sampled taps (im2col layout).
    """
    n, h, w, c = x.shape
    k = kernel_size
    ho = (h - 1) // stride + 1
    wo = (w - 1) // stride + 1
    f32 = dict(dtype=torch.float32, device=x.device)
    ys = torch.arange(ho, **f32) * stride
    xs = torch.arange(wo, **f32) * stride
    tap = (torch.arange(k, **f32) - (k - 1) / 2.0) * dilation
    tap_y = tap.repeat_interleave(k)
    tap_x = tap.repeat(k)
    base_y = ys[None, :, None, None] + tap_y
    base_x = xs[None, None, :, None] + tap_x
    coords = torch.stack([base_y + offsets[..., 0].to(torch.float32),
                          base_x + offsets[..., 1].to(torch.float32)], dim=-1)
    sampled = bilinear_gather(x, coords.reshape(n, ho * wo * k * k, 2))
    return sampled.reshape(n, ho, wo, k * k, c)


def dcnv3_sample_ref(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
                     kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                     offset_scale: float = 1.0) -> torch.Tensor:
    """Reference-exact DCNv3 sampling, vectorized over all taps.

    Its quirks are load-bearing (published checkpoints were trained with
    them) and kept: the input is SAME-padded by ``dilation*(k-1)//2`` and
    every coordinate normalized by the PADDED dims; reference points are in
    (y, x) order but the tap grid and offset pairs in (x, y) order, so
    pair[0] mixes the row reference with column tap offsets; normalized
    coordinates map to pixels with a ``(dim-2)`` scale; and the four corner
    indices are clipped BEFORE the interpolation deltas are taken.

    Args:
      x: [B, H, W, C] grouped values (groups folded into B).
      offsets: [B, Ho, Wo, P, 2] raw offset-head outputs (pair layout as
        stored, taps x-major).
      mask: [B, Ho, Wo, P] softmaxed modulation.
    Returns [B, Ho, Wo, C].
    """
    b, h, w, c = x.shape
    k = kernel_size
    p_total = k * k
    pad = (dilation * (k - 1)) // 2
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    hp, wp = h + 2 * pad, w + 2 * pad
    ho = (hp - (dilation * (k - 1) + 1)) // stride + 1
    wo = (wp - (dilation * (k - 1) + 1)) // stride + 1

    f32 = dict(dtype=torch.float32, device=x.device)
    start = pad + 0.5
    ref0 = (start + torch.arange(ho, **f32) * stride) / hp  # rows / Hp
    ref1 = (start + torch.arange(wo, **f32) * stride) / wp  # cols / Wp
    taps = -pad + torch.arange(k, **f32) * dilation
    dx_p = taps.repeat_interleave(k) / wp  # [P], x-major
    dy_p = taps.repeat(k) / hp

    off0 = offsets[..., 0].to(torch.float32)
    off1 = offsets[..., 1].to(torch.float32)
    loc0 = ref0[None, :, None, None] + dx_p * offset_scale + off0 * offset_scale / wp
    loc1 = ref1[None, None, :, None] + dy_p * offset_scale + off1 * offset_scale / hp
    x_pix = loc0 * (wp - 2)
    y_pix = loc1 * (hp - 2)

    x0 = torch.floor(x_pix).to(torch.long)
    y0 = torch.floor(y_pix).to(torch.long)
    x0i, x1i = x0.clamp(0, wp - 1), (x0 + 1).clamp(0, wp - 1)
    y0i, y1i = y0.clamp(0, hp - 1), (y0 + 1).clamp(0, hp - 1)
    # deltas from the CLIPPED corners
    dx0 = x_pix - x0i.to(torch.float32)
    dx1 = x1i.to(torch.float32) - x_pix
    dy0 = y_pix - y0i.to(torch.float32)
    dy1 = y1i.to(torch.float32) - y_pix

    flat = xp.reshape(b, hp * wp, c)
    m = mask.to(torch.float32)

    def corner(yi, xi, wgt):
        idx = (yi * wp + xi).reshape(b, -1)[..., None].expand(-1, -1, c)
        vals = torch.gather(flat, 1, idx).reshape(b, ho, wo, p_total, c)
        return vals * (wgt * m)[..., None].to(x.dtype)

    out = (corner(y0i, x0i, dx1 * dy1) + corner(y1i, x0i, dx1 * dy0)
           + corner(y0i, x1i, dx0 * dy1) + corner(y1i, x1i, dx0 * dy0))
    return out.sum(dim=3)


@functools.lru_cache(maxsize=64)
def _ref_base(size: int, kernel_size: int, offset_scale: float, groups: int,
              device: torch.device):
    """The part of the effective offsets that depends on the position and
    the tap only: ``(base_y, base_x, gain)``, each base ``[size, G*P]``, with
    ``eff = base + gain * raw offset``. Cached per geometry and device."""
    k = kernel_size
    pad = (k - 1) // 2
    hp = size + 2 * pad
    taps = torch.arange(k, dtype=torch.float64) - pad
    # dense-local taps are y-major; the reference's are x-major (p = a*k + b,
    # dx = taps[a]) and its pair[0] tracks the ROW index, so the reference's
    # dx grid is the dense-local tap_y grid and its dy grid the tap_x grid
    tap_y = taps.repeat_interleave(k).repeat(groups)
    tap_x = taps.repeat(k).repeat(groups)
    i = torch.arange(size, dtype=torch.float64)[:, None]
    sq = (hp - 2.0) / hp  # the (dim-2) pixel scale over the padded dim
    centre = (pad + 0.5 + i) * sq - pad - i  # half-pixel base and squeeze, minus the pixel
    gain = offset_scale * sq
    base_y = (centre + tap_y * (gain - 1.0)).to(dtype=torch.float32, device=device)
    base_x = (centre + tap_x * (gain - 1.0)).to(dtype=torch.float32, device=device)
    return base_y, base_x, gain


def _ref_effective(off, h, w, kernel_size, offset_scale, groups):
    """Effective (dy, dx) on the transposed plane for raw offsets
    ``[B, Ho, Wo, G*P, 2]`` (see :func:`dcnv3_ref_effective_offsets`)."""
    if h != w:
        raise ValueError(f"dense-local reference semantics needs a square map, got {h}x{w}")
    base_y, base_x, gain = _ref_base(h, kernel_size, float(offset_scale), groups, off.device)
    off = off.to(torch.float32)
    # the reference's x (pair[0]) tracks the row of the output pixel, its y the column
    eff_dy = torch.add(base_y[None, :, None, :], off[..., 0], alpha=gain)
    eff_dx = torch.add(base_x[None, None, :, :], off[..., 1], alpha=gain)
    return eff_dy, eff_dx


def dcnv3_ref_effective_offsets(offsets: torch.Tensor, h: int, w: int, kernel_size: int = 3,
                                offset_scale: float = 1.0) -> torch.Tensor:
    """Re-express :func:`dcnv3_sample_ref` as LOCAL effective offsets on the
    TRANSPOSED value plane: ``dense_local(transpose(x), eff, mask)`` equals
    the reference sampling wherever every effective offset stays within the
    dense-local clamp. The reference's mixed pair order makes out[i, j]
    sample around pixel (row=j, col=i), and its half-pixel base and
    ``(dim-2)`` scaling are small position-dependent shifts; on a square
    map both reduce to bounded per-position offsets. Square stride-1
    dilation-1 maps only.

    Args:
      offsets: [B, Ho, Wo, P, 2] raw offset-head outputs.
    Returns [B, Ho, Wo, P, 2] (dy, dx), float32.
    """
    return torch.stack(_ref_effective(offsets, h, w, kernel_size, offset_scale, groups=1),
                       dim=-1)


def dcnv3_ref_effective_offsets_grouped(offsets: torch.Tensor, h: int, w: int,
                                        kernel_size: int = 3, offset_scale: float = 1.0):
    """Grouped-flat variant for :func:`dense_local_flat`: offsets
    [B, Ho, Wo, G, P, 2] -> (eff_dy, eff_dx), each float32 [B, Ho, Wo, G*P]
    (index ``g*P + tap``)."""
    b, ho, wo, g, p = offsets.shape[:5]
    return _ref_effective(offsets.reshape(b, ho, wo, g * p, 2), h, w, kernel_size,
                          offset_scale, groups=g)


def dense_local_flat(x, off_dy, off_dx, modulation, groups, kernel_size=3, max_offset=2):
    """Grouped dense-local sampling for bounded offsets: ``x``
    [B, H, W, G*gc] (channel ``g*gc + j``), ``off_dy``/``off_dx``/
    ``modulation`` [B, H, W, G*K*K] (index ``g*K*K + tap``, taps y-major),
    offsets clamped to ``+-max_offset``. Equal to the centred gather
    sampling wherever every offset stays inside the clamp. Stride and
    dilation 1 only. Runs the CUDA kernels on CUDA tensors and their plain
    versions on CPU tensors; the backward is hand-written on both (see
    :mod:`iseg_tpu_torch.ops.kernels.deform_local`)."""
    return deform_dense_local_flat(x, off_dy, off_dx, modulation, groups, kernel_size,
                                   max_offset)


def deform_dense_local(x: torch.Tensor, offsets: torch.Tensor, modulation: torch.Tensor,
                       kernel_size: int = 3, max_offset: int = 2) -> torch.Tensor:
    """One-group dense-local sampling: ``x`` [B, H, W, C], ``offsets``
    [B, H, W, K*K, 2] (dy, dx), ``modulation`` [B, H, W, K*K]. It is
    :func:`dense_local_flat` with ``groups=1``."""
    return dense_local_flat(x, offsets[..., 0].contiguous(), offsets[..., 1].contiguous(),
                            modulation.contiguous(), 1, kernel_size, max_offset)


def deform_dense_local_grouped(x: torch.Tensor, offsets: torch.Tensor,
                               modulation: torch.Tensor, kernel_size: int = 3,
                               max_offset: int = 2) -> torch.Tensor:
    """:func:`dense_local_flat` for module-layout tensors: ``offsets``
    [B, H, W, G, K*K, 2] (dy, dx), ``modulation`` [B, H, W, G, K*K]."""
    b, h, w, _ = x.shape
    g, kk = offsets.shape[3], offsets.shape[4]
    off_dy = offsets[..., 0].reshape(b, h, w, g * kk)
    off_dx = offsets[..., 1].reshape(b, h, w, g * kk)
    return dense_local_flat(x, off_dy, off_dx, modulation.reshape(b, h, w, g * kk), g,
                            kernel_size, max_offset)


def deform_dense_local_taps(x: torch.Tensor, offsets: torch.Tensor, kernel_size: int = 3,
                            max_offset: int = 2) -> torch.Tensor:
    """Bounded-offset variant of :func:`deform_im2col`: the per-tap samples
    [B, H, W, K*K, C] as sums of shifted dense reads (for DCNv2's per-tap
    weight matrices), offsets clamped to ``+-max_offset``. Equal to the
    gather path wherever every offset stays inside the clamp. Stride and
    dilation 1 only. Plain PyTorch, differentiated by autograd."""
    b, h, w, c = x.shape
    k = kernel_size
    r = max_offset
    half = (k - 1) // 2
    lim = half + r
    off = torch.clamp(offsets.to(torch.float32), -r, r)
    tap = torch.arange(k, dtype=torch.float32, device=x.device) - half
    dy = off[..., 0] + tap.repeat_interleave(k)  # [B,H,W,KK]
    dx = off[..., 1] + tap.repeat(k)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    xf = x.to(torch.float32)
    out = torch.zeros((b, h, w, k * k, c), dtype=torch.float32, device=x.device)
    for oy in range(-lim, lim + 1):
        ty = torch.maximum(zero, 1.0 - (dy - oy).abs())
        for ox in range(-lim, lim + 1):
            tx = torch.maximum(zero, 1.0 - (dx - ox).abs())
            shifted = shift_nhwc(xf, -oy, -ox)  # x[p + o], zeros outside the map
            out = out + (ty * tx)[..., None] * shifted[:, :, :, None, :]
    return out.to(x.dtype)
