"""The port's fused upsample + CE (``iseg_tpu_torch.ops.kernels.upsample_ce``)
against the JAX package's Pallas kernel (interpret mode on the CPU) and its
unfused reference. The CUDA kernel against the plain version is in
``test_torch_cuda_kernels.py``.

Tolerances: fp32 losses agree to rtol 1e-5 and gradients to rtol 1e-4 /
atol 1e-6 (the interpolation weights are formed in float32 here and in
float64 numpy matrices on the JAX side, and the sums run in another order).
bf16 inputs are upcast to fp32 by both sides before any arithmetic, so they
hold the fp32 tolerance.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.ops.pallas import upsample_ce as jax_uce
from iseg_tpu_torch.ops.kernels import upsample_ce as uce

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _data(n=2, h=4, w=4, c=5, hh=16, ww=16, seed=0, ignore_frac=0.2, ignore_label=255):
    rng = np.random.RandomState(seed)
    src = rng.randn(n, h, w, c).astype(np.float32)
    labels = rng.randint(0, c, (n, hh, ww))
    labels = np.where(rng.rand(n, hh, ww) < ignore_frac, ignore_label, labels)
    return src, labels.astype(np.int32)


def _torch_loss_and_grad(fn, src, labels, dtype=torch.float32, **kw):
    s = torch.tensor(src, dtype=dtype, requires_grad=True)
    loss = fn(s, torch.tensor(labels), **kw)
    (g,) = torch.autograd.grad(loss, s)
    return float(loss.detach()), g.float().numpy()


def _jax_loss_and_grad(fn, src, labels, dtype=jnp.float32, **kw):
    loss, g = jax.value_and_grad(lambda s: fn(s, jnp.asarray(labels), **kw))(
        jnp.asarray(src, dtype))
    return float(loss), np.asarray(g.astype(jnp.float32))


CASES = {
    "square_2x4x4x5_to_16": dict(n=2, h=4, w=4, c=5, hh=16, ww=16),
    "non_square_ratio_1x4x8x5_to_12x24": dict(n=1, h=4, w=8, c=5, hh=12, ww=24),
    "downsample_1x6x6x3_to_4x4": dict(n=1, h=6, w=6, c=3, hh=4, ww=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_fused_loss_and_grad_match_jax_kernel(case):
    src, labels = _data(**CASES[case])
    t_loss, t_grad = _torch_loss_and_grad(uce.upsample_cross_entropy, src, labels)
    j_loss, j_grad = _jax_loss_and_grad(jax_uce.upsample_cross_entropy, src, labels,
                                        interpret=True)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_grad, j_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_reference_matches_jax_reference(case):
    src, labels = _data(**CASES[case])
    t_loss, t_grad = _torch_loss_and_grad(uce.upsample_cross_entropy_reference, src, labels)
    j_loss, j_grad = _jax_loss_and_grad(jax_uce.upsample_cross_entropy_reference, src, labels)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_grad, j_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_torch_fused_matches_own_reference():
    src, labels = _data()
    f_loss, f_grad = _torch_loss_and_grad(uce.upsample_cross_entropy, src, labels)
    r_loss, r_grad = _torch_loss_and_grad(uce.upsample_cross_entropy_reference, src, labels)
    np.testing.assert_allclose(f_loss, r_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(f_grad, r_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_torch_fused_all_ignored_gives_zero_loss_and_grad():
    src, _ = _data()
    labels = np.full((2, 16, 16), 255, np.int32)
    loss, grad = _torch_loss_and_grad(uce.upsample_cross_entropy, src, labels)
    assert loss == 0.0
    np.testing.assert_array_equal(grad, 0.0)


def test_torch_fused_squeezes_trailing_label_dim():
    src, labels = _data()
    t_loss, t_grad = _torch_loss_and_grad(uce.upsample_cross_entropy, src, labels[..., None])
    j_loss, j_grad = _jax_loss_and_grad(jax_uce.upsample_cross_entropy, src,
                                        labels[..., None], interpret=True)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_grad, j_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_torch_fused_bf16_input_matches_jax_kernel():
    src, labels = _data()
    src = np.asarray(jnp.asarray(src, jnp.bfloat16).astype(jnp.float32))  # bf16-exact
    t_loss, t_grad = _torch_loss_and_grad(uce.upsample_cross_entropy, src, labels,
                                          dtype=torch.bfloat16)
    j_loss, j_grad = _jax_loss_and_grad(jax_uce.upsample_cross_entropy, src, labels,
                                        dtype=jnp.bfloat16, interpret=True)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    # both gradients are rounded to bf16 (8 mantissa bits) at the end
    np.testing.assert_allclose(t_grad, j_grad, rtol=1e-2, atol=1e-6)


@pytest.mark.parametrize("ignore_label", [255, 0])
def test_torch_fused_odd_labels_keep_kernel_semantics(ignore_label):
    """A label >= C that is not ignored has CE = lse; ignore_label=0 does
    not shift the classes. Both as the TPU kernel does."""
    src, labels = _data(c=5, ignore_label=ignore_label)
    labels[:, :2, :] = 7  # out of range, not ignored
    t_loss, t_grad = _torch_loss_and_grad(uce.upsample_cross_entropy, src, labels,
                                          ignore_label=ignore_label)
    j_loss, j_grad = _jax_loss_and_grad(jax_uce.upsample_cross_entropy, src, labels,
                                        ignore_label=ignore_label, interpret=True)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_grad, j_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_torch_fused_cpu_path_launches_no_kernel():
    src, labels = _data()
    uce.reset_launch_counts()
    _torch_loss_and_grad(uce.upsample_cross_entropy, src, labels)
    assert uce.LAUNCH_COUNTS == {"fwd": 0, "bwd": 0}


def test_torch_fused_rejects_mismatched_target_hw():
    src, labels = _data()
    with pytest.raises(ValueError):
        uce.upsample_cross_entropy(torch.tensor(src), torch.tensor(labels), target_hw=(8, 8))


@pytest.mark.parametrize("ignore_label", [255, 0])
@pytest.mark.parametrize("c", [65, 150])
def test_torch_fused_many_classes_takes_unfused_path_as_jax(c, ignore_label):
    """Above 64 classes both packages return the unfused resize + CE, with
    its label rules (ignore_label=0 shifts the classes there), labels >= C
    included."""
    src, labels = _data(n=1, h=4, w=6, c=c, hh=8, ww=12, ignore_label=ignore_label)
    labels[:, :2, :] = c + 3  # out of range, not ignored
    uce.reset_launch_counts()
    t_loss, t_grad = _torch_loss_and_grad(uce.upsample_cross_entropy, src, labels,
                                          ignore_label=ignore_label)
    assert uce.LAUNCH_COUNTS == {"fwd": 0, "bwd": 0}
    j_loss, j_grad = _jax_loss_and_grad(jax_uce.upsample_cross_entropy, src, labels,
                                        ignore_label=ignore_label, interpret=True)
    # the same unfused function on both sides: the gradient holds the loss's
    # 1e-5 too (atol for entries that are rounding noise around 0)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_grad, j_grad, rtol=LOSS_RTOL, atol=GRAD_ATOL)
    r_loss, _ = _torch_loss_and_grad(uce.upsample_cross_entropy_reference, src, labels,
                                     ignore_label=ignore_label)
    assert t_loss == r_loss


# ------------------------------------------------ the CUDA backward's algorithm
#
# The CUDA backward (``bwd_kernel`` of ``csrc/upsample_ce.cu``) is a
# band-tiled separable gather that cannot run here. Its index arithmetic can:
# the numpy emulation below follows it block by block and is held against
# ``jax.grad`` of the JAX package's fused loss (its Pallas kernels in
# interpret mode) at the gradient tolerance above, rtol 1e-4 / atol 1e-6
# (the emulation sums in fp32 in the kernel's order, JAX through float64
# interpolation matrices in fp32 products).

F32 = np.float32
BWD_THREADS, MAX_BAND, MAX_ROWS = 256, 8, 16
BWD_SMEM_BUDGET, BWD_SMEM_MAX, SM_SMEM = 57344, 232448, 233472
LOG2E = F32(1.4426950408889634)


def _taps(dst, scale, src_len):
    """``taps`` of the CUDA source, in float32: the two clamped source
    indices and the fraction of output index ``dst``."""
    pos = (F32(dst) + F32(0.5)) * F32(scale) - F32(0.5)
    lo = np.floor(pos)
    frac = F32(pos - lo)
    lo = int(lo)
    return min(max(lo, 0), src_len - 1), min(max(lo + 1, 0), src_len - 1), frac


def _first_tap_at_least(target, hi, scale, src_len, dst_len):
    lo, up = 0, dst_len
    while lo < up:
        mid = (lo + up) // 2
        if _taps(mid, scale, src_len)[1 if hi else 0] >= target:
            up = mid
        else:
            lo = mid + 1
    return lo


def _bwd_tiling(n, h, w, c, big_w, sms=132):
    """``bwd_tiling`` of the CUDA source: (band, tj, tiles_x, rows, nx_cap,
    kx_cap) of the least estimated cost."""
    cb = next(b for b in (16, 24, 32, 64) if c <= b)
    pst = cb + 1
    per_col = big_w / w
    kx_cap = int(2 * per_col) + 3
    for budget in (BWD_SMEM_BUDGET, BWD_SMEM_MAX):
        best = None
        for cap in range(min(w, max(1, BWD_THREADS // c)), 0, -1):
            tiles_x = -(-w // cap)
            tj = -(-w // tiles_x)
            if tj != cap:
                continue
            nx_cap = min(big_w, int((tj + 1) * per_col) + 3)
            fixed = (4 * nx_cap + 2 * tj + tj * kx_cap) * 4
            per_row = ((tj + 2) * cb + nx_cap * pst + tj * c) * 4
            if fixed + per_row > budget:
                continue
            rows = min(MAX_ROWS, (budget - fixed) // per_row)
            smem = fixed + rows * per_row
            per_sm = max(1, min(2048 // BWD_THREADS, SM_SMEM // (smem + 1024)))
            for band in (8, 4, 2, 1):
                blocks = n * -(-h // band) * tiles_x
                waves = math.ceil(blocks / (sms * per_sm)) / (blocks / (sms * per_sm))
                cost = (band + 1.0) / band * (tj + 1.0) / tj * waves
                if best is None or cost < best[0]:
                    best = (cost, (band, tj, tiles_x, rows, nx_cap, kx_cap))
        if best is not None:
            return best[1]
    raise ValueError("does not fit")


def _band_tiled_bwd_emulation(src, labels, g, ignore_label, band, tj, rows, nx_cap, kx_cap):
    """dsrc as ``bwd_kernel`` computes it: per block (image, band of source
    rows, tile of source columns) the output rows and columns that touch it
    from the clamped taps, and each source column's weights Rw[x, j] over
    the output columns that reach it; per pass of ``rows`` output rows the
    vertical mix over the tile's columns and one more on each side (in log2
    units), one softmax per output pixel (exp2), each (row, column, class)'s
    sum over its output columns in x order, and the band rows' accumulators
    in y order. Every element of dsrc is written once: NaN marks the
    unwritten."""
    n_, h, w, c = src.shape
    big_h, big_w = labels.shape[1:]
    sh, sw = F32(h) / F32(big_h), F32(w) / F32(big_w)
    dsrc = np.full(src.shape, np.nan, F32)
    vw = tj + 2
    for n in range(n_):
        for ib in range(0, h, band):
            ie = min(h, ib + band)
            for jb in range(0, w, tj):
                je = min(w, jb + tj)
                ylo = _first_tap_at_least(ib, True, sh, h, big_h)
                yhi = _first_tap_at_least(ie, False, sh, h, big_h)
                xlo = _first_tap_at_least(jb, True, sw, w, big_w)
                nx = _first_tap_at_least(je, False, sw, w, big_w) - xlo
                assert nx <= nx_cap, (nx, nx_cap)
                xt = [_taps(xlo + e, sw, w) for e in range(nx)]
                tx0 = np.array([t[0] - jb + 1 for t in xt], int)
                tx1 = np.array([t[1] - jb + 1 for t in xt], int)
                tfx = np.array([t[2] for t in xt], F32)
                xs = [_first_tap_at_least(jb + j, True, sw, w, big_w) - xlo
                      for j in range(je - jb)]
                xn = [_first_tap_at_least(jb + j + 1, False, sw, w, big_w) - xlo - xs[j]
                      for j in range(je - jb)]
                assert max(xn) <= kx_cap, (xn, kx_cap)
                wcol = [np.array([(F32(1) - tfx[xi] if tx0[xi] == j + 1 else F32(0))
                                  + (tfx[xi] if tx1[xi] == j + 1 else F32(0))
                                  for xi in range(xs[j], xs[j] + xn[j])], F32)
                        for j in range(je - jb)]
                acc = np.zeros((band, je - jb, c), F32)
                for y0 in range(ylo, yhi, rows):
                    for y in range(y0, min(y0 + rows, yhi)):
                        a0, a1, fy = _taps(y, sh, h)
                        vrow = np.zeros((vw, c), F32)  # columns jb - 1 .. jb + tj
                        cols = np.arange(jb - 1, jb - 1 + vw)
                        live = (cols >= 0) & (cols < w)
                        vrow[live] = ((F32(1) - fy) * src[n, a0, cols[live]]
                                      + fy * src[n, a1, cols[live]]) * LOG2E
                        lab = labels[n, y, xlo:xlo + nx]
                        logit = ((F32(1) - tfx)[:, None] * vrow[tx0]
                                 + tfx[:, None] * vrow[tx1])
                        e = np.exp2(logit - logit.max(axis=1, keepdims=True))
                        p = e * (F32(g) / e.sum(axis=1, keepdims=True))
                        p[np.arange(nx), np.clip(lab, 0, c - 1)] -= np.where(
                            (lab >= 0) & (lab < c), F32(g), F32(0))
                        p[lab == ignore_label] = 0.0
                        for j in range(je - jb):
                            s = np.zeros(c, F32)
                            for k in range(xn[j]):
                                s = s + wcol[j][k] * p[xs[j] + k]
                            for b in range(ie - ib):
                                wy = ((F32(1) - fy if a0 == ib + b else F32(0))
                                      + (fy if a1 == ib + b else F32(0)))
                                acc[b, j] = acc[b, j] + wy * s
                block = dsrc[n, ib:ie, jb:je]
                assert np.isnan(block).all(), "written twice"
                dsrc[n, ib:ie, jb:je] = acc[:ie - ib]
    assert not np.isnan(dsrc).any(), "an element of dsrc was never written"
    return dsrc


BWD_CASES = {
    # (n, h, w, C, H, W, ignore_label, what else)
    "scale4_c21": (2, 5, 6, 21, 20, 24, 255, None),
    "scale16_c19": (1, 3, 4, 19, 48, 64, 255, None),
    "scale32_c21": (1, 2, 3, 21, 64, 96, 255, None),
    "non_integer_33x47_to_512x700": (1, 33, 47, 3, 512, 700, 255, None),
    "h1_c64": (2, 1, 5, 64, 8, 40, 255, None),
    "c1": (1, 3, 5, 1, 12, 20, 255, None),
    "downsample_16x16_to_10": (1, 16, 16, 7, 10, 10, 255, None),
    "ignore_label_0_labels_beyond_c": (1, 4, 4, 5, 16, 16, 0, "beyond"),
    "all_ignored": (1, 3, 4, 6, 12, 16, 255, "all_ignored"),
}


@functools.lru_cache(maxsize=None)
def _jax_bwd_case(case):
    n, h, w, c, big_h, big_w, ignore_label, what = BWD_CASES[case]
    src, labels = _data(n=n, h=h, w=w, c=c, hh=big_h, ww=big_w, seed=3,
                        ignore_label=ignore_label)
    if what == "beyond":
        labels[:, :3] = c + 2  # out of range, not ignored: no true class
    if what == "all_ignored":
        labels[:] = ignore_label
    _, want = _jax_loss_and_grad(jax_uce.upsample_cross_entropy, src, labels,
                                 ignore_label=ignore_label, interpret=True)
    return src, labels, want


@pytest.mark.parametrize("tiling", ["host", "ragged"])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_torch_band_tiled_bwd_algorithm_matches_jax_grad(case, tiling):
    """The band-tiled backward of the CUDA loss, emulated, against
    ``jax.grad`` of the JAX package's fused loss: with the tiling the CUDA
    host code picks for the shape, and with small bands, column tiles and
    passes that leave every last one ragged."""
    n, h, w, c, big_h, big_w, ignore_label, what = BWD_CASES[case]
    src, labels, want = _jax_bwd_case(case)
    band, tj, _, rows, nx_cap, kx_cap = _bwd_tiling(n, h, w, c, big_w)
    if tiling == "ragged":
        band, tj, rows = min(band, 3), min(tj, 2), 3
        nx_cap = min(big_w, int((tj + 1) * (big_w / w)) + 3)
    valid = float((labels != ignore_label).sum())
    got = _band_tiled_bwd_emulation(src, labels, F32(1.0) / F32(max(valid, 1.0)),
                                    ignore_label, band, tj, rows, nx_cap, kx_cap)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if what == "all_ignored":
        np.testing.assert_array_equal(got, 0.0)


def test_torch_bwd_tiling_at_the_main_path_shapes():
    """The host's tiling at the three paths' shapes on an H100 (132 SMs):
    bands and tiles that keep the recomputed softmaxes under 1.5x, column
    tiles whose (column, class) owners fit one block, and a grid of whole
    waves or more than two."""
    want = {(16, 32, 21): (4, 8), (8, 128, 19): (8, 11), (8, 16, 19): (2, 2)}
    for (n, h, c), (band_want, tj_want) in want.items():
        band, tj, tiles_x, rows, nx_cap, kx_cap = _bwd_tiling(n, h, h, c, 512)
        assert (band, tj) == (band_want, tj_want)
        assert tj * c <= BWD_THREADS and tiles_x * tj >= h and rows >= 1
        assert nx_cap >= (tj + 1) * (512 // h) and kx_cap >= 2 * (512 // h)


@pytest.mark.parametrize("n,h,w,c,big_h,big_w", [
    (8, 128, 256, 19, 512, 1024), (16, 32, 32, 21, 512, 512), (2, 128, 128, 19, 512, 512),
    (2, 64, 64, 19, 512, 512), (2, 32, 32, 19, 512, 512), (2, 16, 16, 19, 512, 512),
], ids=["convnext_fapn", "xception", "fpn_b2", "nasfpn_b2", "mixer_b2", "moat_b2"])
def test_torch_kernel_tilings_fit_the_zoo_shapes(n, h, w, c, big_h, big_w):
    """The backbone zoo's loss shapes (ConvNeXt-L + FaPN's non-square
    [8,128,256,19] -> [8,512,1024] first) find a tiling in both kernels'
    host rules, so no shape of those paths raises "the shape's tiles do not
    fit a block"; the backward's column tiles still cover the source and
    its (column, class) owners fit one block."""
    band, tj, tiles_x, rows, nx_cap, kx_cap = _bwd_tiling(n, h, w, c, big_w)
    assert tj * c <= BWD_THREADS and tiles_x * tj >= w and rows >= 1 and band >= 1
    assert nx_cap >= (tj + 1) * (big_w // w) and kx_cap >= 2 * (big_w // w)
    fband, tw, ftiles_x, bands, frows, ncap, smem = _fwd_tiling(n, h, w, c, big_h, big_w,
                                                                132 * 4)
    assert ftiles_x * tw >= big_w and bands * fband >= n * big_h and frows >= 1
    assert smem <= FWD_SMEM_MAX


# ------------------------------------------------ the CUDA forward's algorithm
#
# The CUDA forward (``fwd_kernel`` of ``csrc/upsample_ce.cu``) is a
# row-premixed pass that cannot run here. The numpy emulation below follows
# it block by block (bands of rows of the whole batch, column tiles, passes
# of rows, the log2-unit vertical mix padded to the class bucket) and is held
# against the JAX package's fused loss (its Pallas kernel in interpret mode)
# at LOSS_RTOL, 1e-5.

FWD_THREADS, FWD_MAX_ROWS, FWD_MAX_BLOCKS = 256, 8, 4096
FWD_SMEM_MAX = BWD_SMEM_MAX - 1024
NO_CLASS = F32(-1e30)
LN2 = F32(0.6931471805599453)


def _fwd_tiling(n, h, w, c, big_h, big_w, slots):
    """``fwd_tiling`` of the CUDA source: (band, tw, tiles_x, bands, rows,
    ncap, shared bytes) for ``slots`` blocks at once on the card."""
    cb = next(b for b in (16, 24, 32, 64) if c <= b)
    per_col = w / big_w
    for budget in (BWD_SMEM_BUDGET, FWD_SMEM_MAX):
        tw = min(big_w, 2048)
        while True:
            ncap = min(w, int((tw - 1) * per_col) + 5)
            per_row = ncap * cb * 4
            if per_row <= budget:
                tiles_x = -(-big_w // tw)
                rows_total = n * big_h
                want = max(1, slots // tiles_x)
                band = -(-rows_total // want)
                while -(-rows_total // band) * tiles_x > FWD_MAX_BLOCKS:
                    band *= 2
                band = min(band, rows_total)
                rows = min(FWD_MAX_ROWS, band, budget // per_row)
                return band, tw, tiles_x, -(-rows_total // band), rows, ncap, rows * per_row
            if tw == 1:
                break
            tw = (tw + 1) // 2
    raise ValueError("does not fit")


def _row_premixed_fwd_emulation(src, labels, ignore_label, band, tw, rows, ncap):
    """(sum of CE over valid pixels, valid count) as ``fwd_kernel`` and
    ``reduce_kernel`` compute them: per block (a band of rows of the N * H
    rows of the batch, a tile of output columns) the source columns the
    tile's taps touch; per pass of ``rows`` rows each row's two source rows
    mixed in log2 units into vrow, the classes from C to the bucket padded
    with -1e30; per pixel the two-tap mix in x, its max, the sum of
    exp2(l - max) over the bucket, the true logit mixed again from vrow
    only for a label in [0, C), CE = (log2 s + max - true) ln 2; fp32 block partials, summed in
    float64."""
    n_, h, w, c = src.shape
    big_h, big_w = labels.shape[1:]
    cb = next(b for b in (16, 24, 32, 64) if c <= b)
    sh, sw = F32(h) / F32(big_h), F32(w) / F32(big_w)
    rows_total = n_ * big_h
    partials = []
    for rb in range(0, rows_total, band):
        for xb in range(0, big_w, tw):
            nx = min(big_w, xb + tw) - xb
            c_lo, c_hi = _taps(xb, sw, w)[0], _taps(xb + nx - 1, sw, w)[1]
            assert c_hi - c_lo + 1 <= ncap, (c_hi - c_lo + 1, ncap)
            ce, valid = F32(0), F32(0)
            for r0 in range(rb, min(rows_total, rb + band), rows):
                for row in range(r0, min(r0 + rows, rb + band, rows_total)):
                    n, y = divmod(row, big_h)
                    a0, a1, fy = _taps(y, sh, h)
                    vrow = np.full((c_hi - c_lo + 1, cb), NO_CLASS, F32)
                    cols = slice(c_lo, c_hi + 1)
                    vrow[:, :c] = ((F32(1) - fy) * src[n, a0, cols] + fy * src[n, a1, cols]) * LOG2E
                    for xi in range(nx):
                        label = labels[n, y, xb + xi]
                        if label == ignore_label:
                            continue
                        x0, x1, fx = _taps(xb + xi, sw, w)
                        lg = (F32(1) - fx) * vrow[x0 - c_lo] + fx * vrow[x1 - c_lo]
                        m = lg.max()
                        s = np.exp2(lg - m).sum(dtype=F32)
                        true = ((F32(1) - fx) * vrow[x0 - c_lo, label] + fx * vrow[x1 - c_lo, label]
                                if 0 <= label < c else F32(0))
                        ce = ce + (np.log2(s) + m - true) * LN2
                        valid = valid + F32(1)
            partials.append((ce, valid))
    assert len(partials) <= FWD_MAX_BLOCKS
    return sum(float(p[0]) for p in partials), sum(float(p[1]) for p in partials)


FWD_CASES = {
    # (n, h, w, C, H, W, ignore_label, what else)
    "scale4_c21": (2, 5, 6, 21, 20, 24, 255, None),
    "scale16_c19_labels_in_bucket": (1, 3, 4, 19, 48, 64, 255, "bucket"),
    "c5_bucket16_labels_in_bucket": (2, 4, 4, 5, 16, 16, 255, "bucket"),
    "c33_bucket64": (1, 3, 3, 33, 12, 12, 255, "bucket"),
    "non_integer_7x9_to_50x70": (1, 7, 9, 3, 50, 70, 255, None),
    "downsample_16x16_to_10": (1, 16, 16, 7, 10, 10, 255, None),
    "ignore_label_0_labels_beyond_c": (1, 4, 4, 5, 16, 16, 0, "beyond"),
    "all_ignored": (1, 3, 4, 6, 12, 16, 255, "all_ignored"),
}


@functools.lru_cache(maxsize=None)
def _jax_fwd_case(case):
    n, h, w, c, big_h, big_w, ignore_label, what = FWD_CASES[case]
    src, labels = _data(n=n, h=h, w=w, c=c, hh=big_h, ww=big_w, seed=11,
                        ignore_label=ignore_label)
    bucket = next(b for b in (16, 24, 32, 64) if c <= b)
    if what == "bucket":  # labels in [C, bucket), not ignored: no true class
        labels[:, 1] = c + np.arange(big_w) % (bucket - c)
    if what == "beyond":
        labels[:, :3] = c + 2
    if what == "all_ignored":
        labels[:] = ignore_label
    want, _ = _jax_loss_and_grad(jax_uce.upsample_cross_entropy, src, labels,
                                 ignore_label=ignore_label, interpret=True)
    return src, labels, want


@pytest.mark.parametrize("tiling", ["host", "ragged"])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_torch_row_premixed_fwd_algorithm_matches_jax_loss(case, tiling):
    """The row-premixed forward of the CUDA loss, emulated, against the JAX
    package's fused loss: with the tiling the CUDA host code picks for the
    shape on an H100 (132 SMs, 4 blocks each), and with small bands, column
    tiles and passes that leave every last one ragged and run bands on
    across images."""
    n, h, w, c, big_h, big_w, ignore_label, what = FWD_CASES[case]
    src, labels, want = _jax_fwd_case(case)
    band, tw, _, _, rows, ncap, _ = _fwd_tiling(n, h, w, c, big_h, big_w, 132 * 4)
    if tiling == "ragged":
        band, tw, rows = 7, 5, 3
        ncap = min(w, int((tw - 1) * (w / big_w)) + 5)
    ce, valid = _row_premixed_fwd_emulation(src, labels, ignore_label, band, tw, rows, ncap)
    assert valid == float((labels != ignore_label).sum())
    np.testing.assert_allclose(ce / max(valid, 1.0), want, rtol=LOSS_RTOL)
    if what == "all_ignored":
        assert (ce, valid) == (0.0, 0.0)


def test_torch_fwd_tiling_at_the_main_path_shapes():
    """The forward's tiling at the three paths' shapes on an H100 (132 SMs;
    four blocks each of the 24-class kernel's 58 registers and 256 threads):
    whole 512-column rows, one wave of 512 blocks, each mixing whole passes
    of rows into at most 48 KB."""
    want = {(16, 32, 21): (16, 32, 8), (8, 128, 19): (8, 128, 4), (8, 16, 19): (8, 16, 8)}
    for (n, h, c), (band_want, ncap_want, rows_want) in want.items():
        band, tw, tiles_x, bands, rows, ncap, smem = _fwd_tiling(n, h, h, c, 512, 512, 132 * 4)
        assert (band, ncap, rows) == (band_want, ncap_want, rows_want)
        assert (tw, tiles_x, bands) == (512, 1, 512) and smem <= 49152
