"""Dense-local deformable sampling of the port against ``iseg_tpu``.

On the CPU ``iseg_tpu_torch.ops.deform.dense_local_flat`` runs the plain
versions of the CUDA kernels (forward and hand-written backward). They are
held against the JAX package's ``dense_local_flat`` (forward and its custom
VJP), against the one-group ``deform_dense_local`` and against the Pallas
kernel itself in interpret mode, in fp32 at atol 1e-5 (both sides run the
same displacement loop; sums differ only in order). Offsets are drawn in
+-3 for a clamp of +-2, with rows of exact zeros (the hat's kink), exact
+-r, exact integers and values beyond +-r, where the gradient conventions
of the hand-written VJP show. The JAX side is jitted: the unrolled
displacement loop compiles slowly on the CPU, so shapes are tiny and few.

The CUDA backward's ``d_x`` kernel is a tiled gather through shared memory
that cannot run here. Its algorithm can: a numpy emulation of it (tiles of
the map with their halos, each halo pixel's displacement weights summed
tap by tap into its row, then a fixed-order gather per input pixel, slab by
slab of channels) is held against ``jax.vjp`` of ``dense_local_flat`` at
1e-5 in fp32, at map sides that are no multiple of the tile. So is an
emulation of the map-gradient kernel: x staged over a tile grown by the
corners' reach (one more row and column on the high side, zeros outside the
map), each (pixel, group, tap) entry's corner dot products taken from it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.ops import deform as jdeform
from iseg_tpu.ops.pallas import deform_local as jpallas
from iseg_tpu_torch.ops import deform as tdeform
from iseg_tpu_torch.ops.kernels import deform_local as dl

torch.set_num_threads(1)

ATOL = 1e-5


def _inputs(b, h, w, groups, gc, k, r, seed=0):
    rng = np.random.RandomState(seed)
    kk = k * k
    x = rng.randn(b, h, w, groups * gc).astype(np.float32)
    off_dy = rng.uniform(-(r + 1), r + 1, (b, h, w, groups * kk)).astype(np.float32)
    off_dx = rng.uniform(-(r + 1), r + 1, (b, h, w, groups * kk)).astype(np.float32)
    off_dy[:, 0], off_dx[:, 0] = 0.0, 0.0  # the kink of the hat
    off_dy[:, 1], off_dx[:, 1] = r, -r  # exactly at the clamp
    off_dy[:, 2] = np.round(off_dy[:, 2])  # integers, some beyond the clamp
    off_dx[:, 3] = r + 0.5  # beyond the clamp
    mod = rng.rand(b, h, w, groups * kk).astype(np.float32)
    g_out = rng.randn(b, h, w, groups * gc).astype(np.float32)
    return x, off_dy, off_dx, mod, g_out


def _jax_out_and_grads(groups, k, r):
    @jax.jit
    def run(x, off_dy, off_dx, mod, g_out):
        out, vjp = jax.vjp(lambda *a: jdeform.dense_local_flat(*a, groups, k, r),
                           x, off_dy, off_dx, mod)
        return (out, *vjp(g_out))

    return run


def _torch_out_and_grads(x, off_dy, off_dx, mod, g_out, groups, k, r):
    ins = [torch.tensor(a, requires_grad=True) for a in (x, off_dy, off_dx, mod)]
    out = tdeform.dense_local_flat(*ins, groups, k, r)
    grads = torch.autograd.grad(out, ins, torch.tensor(g_out))
    return [t.detach().numpy() for t in (out, *grads)]


CASES = {
    # (B, H, W, groups, channels per group, K, r)
    "g1": (1, 6, 5, 1, 4, 3, 2),
    "g2": (2, 5, 6, 2, 3, 3, 2),
    "g4": (1, 6, 6, 4, 2, 3, 2),
    "g2_r1": (1, 5, 5, 2, 4, 3, 1),
}
NAMES = ("out", "d_x", "d_off_dy", "d_off_dx", "d_modulation")


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_dense_local_flat_forward_and_gradients_match_jax(case):
    b, h, w, groups, gc, k, r = CASES[case]
    data = _inputs(b, h, w, groups, gc, k, r)
    want = _jax_out_and_grads(groups, k, r)(*data)
    dl.reset_launch_counts()
    got = _torch_out_and_grads(*data, groups, k, r)
    assert dl.LAUNCH_COUNTS == {"fwd": 0, "bwd": 0}  # CPU tensors take the plain versions
    for name, a, b_ in zip(NAMES, got, want):
        np.testing.assert_allclose(a, np.asarray(b_), atol=ATOL, rtol=0, err_msg=name)
    # the conventions themselves: no offset gradient at an integer
    # displacement (rows 0, 1, 2) nor beyond the clamp (row 3 of dx)
    for row in (0, 1, 2):
        assert np.abs(got[2][:, row]).max() == 0.0
    assert np.abs(got[3][:, 0]).max() == 0.0 and np.abs(got[3][:, 3]).max() == 0.0
    assert np.abs(got[2][:, 4:]).max() > 0.0 and np.abs(got[3][:, 4:]).max() > 0.0


def test_torch_dense_local_gradient_passes_at_the_clamp_edge():
    """At exactly +-r the clamp passes the gradient in full (autograd of a
    clamp could halve it); a fractional partner axis makes that visible."""
    b, h, w, groups, gc, k, r = CASES["g2"]
    x, off_dy, off_dx, mod, g_out = _inputs(b, h, w, groups, gc, k, r, seed=1)
    off_dy[:, 1] = r - 0.25  # fractional: d_off_dy lives
    off_dx[:, 1] = -r  # at the edge: integer displacement, gradient 0 by the kink
    off_dy[:, 2] = r + 1e-3  # just outside: clamped to an integer, no gradient
    want = _jax_out_and_grads(groups, k, r)(x, off_dy, off_dx, mod, g_out)
    got = _torch_out_and_grads(x, off_dy, off_dx, mod, g_out, groups, k, r)
    for name, a, b_ in zip(NAMES, got, want):
        np.testing.assert_allclose(a, np.asarray(b_), atol=ATOL, rtol=0, err_msg=name)
    assert np.abs(got[2][:, 1]).max() > 0.0
    assert np.abs(got[2][:, 2]).max() == 0.0


def test_torch_deform_dense_local_matches_jax_and_the_pallas_kernel():
    b, h, w, _, c, k, r = 2, 8, 8, 1, 4, 3, 2
    rng = np.random.RandomState(0)
    x = rng.rand(b, h, w, c).astype(np.float32)
    off = rng.uniform(-3, 3, (b, h, w, k * k, 2)).astype(np.float32)
    mod = rng.rand(b, h, w, k * k).astype(np.float32)
    got = tdeform.deform_dense_local(torch.tensor(x), torch.tensor(off), torch.tensor(mod),
                                     kernel_size=k, max_offset=r).numpy()
    want = jax.jit(lambda *a: jdeform.deform_dense_local(*a, kernel_size=k, max_offset=r))(
        x, off, mod)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    pallas = jpallas._dense_local_pallas_impl(jnp.asarray(x), jnp.asarray(off),
                                              jnp.asarray(mod), k, r, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL, rtol=0)
    # the plain version called directly, and the grouped module-layout entry
    flat = (torch.tensor(off[..., 0]), torch.tensor(off[..., 1]), torch.tensor(mod))
    plain = dl.deform_dense_local_flat_reference(torch.tensor(x), *flat, 1, k, r).numpy()
    np.testing.assert_array_equal(plain, got)
    grouped = tdeform.deform_dense_local_grouped(
        torch.tensor(x), torch.tensor(off[:, :, :, None]), torch.tensor(mod[:, :, :, None]),
        kernel_size=k, max_offset=r).numpy()
    np.testing.assert_array_equal(grouped, got)


def test_torch_dense_local_zero_offsets_is_modulated_box_sum():
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.randn(2, 6, 7, 6).astype(np.float32))
    m = torch.tensor(rng.rand(2, 6, 7, 2 * 9).astype(np.float32))
    zeros = torch.zeros_like(m)
    out = tdeform.dense_local_flat(x, zeros, zeros, m, 2, 3, 2)
    # tap (ty, tx) reads x[p + (ty - 1, tx - 1)] with weight m[g, ty*3 + tx]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    want = torch.zeros_like(x)
    for ty in range(3):
        for tx in range(3):
            wgt = m.reshape(2, 6, 7, 2, 9)[..., ty * 3 + tx].repeat_interleave(3, dim=-1)
            want += wgt * xp[:, ty:ty + 6, tx:tx + 7]
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_torch_dense_local_clamps_instead_of_dropping():
    """Offsets beyond +-r sample at +-r: the result equals that of the
    clamped offsets, and differs from the unclamped gather."""
    b, h, w, groups, gc, k, r = CASES["g2"]
    x, off_dy, off_dx, mod, _ = (torch.tensor(a) for a in _inputs(b, h, w, groups, gc, k, r))
    out = tdeform.dense_local_flat(x, off_dy, off_dx, mod, groups, k, r)
    clamped = tdeform.dense_local_flat(x, off_dy.clamp(-r, r), off_dx.clamp(-r, r), mod,
                                       groups, k, r)
    np.testing.assert_array_equal(out.numpy(), clamped.numpy())
    wide = tdeform.dense_local_flat(x, off_dy, off_dx, mod, groups, k, r + 1)
    assert float((wide - out).abs().max()) > 1e-3


def test_torch_dense_local_types_and_float64():
    b, h, w, groups, gc, k, r = CASES["g2"]
    data = _inputs(b, h, w, groups, gc, k, r)
    want = _torch_out_and_grads(*data, groups, k, r)
    ins = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in data[:4]]
    out = tdeform.dense_local_flat(*ins, groups, k, r)
    grads = torch.autograd.grad(out, ins, torch.tensor(data[4], dtype=torch.float64))
    for name, a, b_ in zip(NAMES, (out, *grads), want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.detach().numpy(), b_, atol=ATOL, rtol=0, err_msg=name)
    # the autocast mix: bf16 values and modulation, fp32 offsets; each
    # gradient comes back in its input's dtype
    dtypes = (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16)
    ins = [torch.tensor(a).to(d).requires_grad_(True) for a, d in zip(data[:4], dtypes)]
    out = tdeform.dense_local_flat(*ins, groups, k, r)
    grads = torch.autograd.grad(out, ins, torch.tensor(data[4]).bfloat16())
    assert out.dtype == torch.bfloat16
    assert tuple(g.dtype for g in grads) == dtypes
    np.testing.assert_allclose(out.detach().float().numpy(), want[0], atol=0.1, rtol=0.05)


def test_torch_dense_local_rejects_wrong_inputs():
    b, h, w, groups, gc, k, r = CASES["g2"]
    x, off_dy, off_dx, mod, _ = (torch.tensor(a) for a in _inputs(b, h, w, groups, gc, k, r))
    with pytest.raises(ValueError, match="divisible"):
        tdeform.dense_local_flat(x, off_dy, off_dx, mod, 4, k, r)
    with pytest.raises(ValueError, match="off_dx"):
        tdeform.dense_local_flat(x, off_dy, off_dx[..., :-1], mod, groups, k, r)
    with pytest.raises(ValueError, match=r"\[B,H,W,C\]"):
        tdeform.dense_local_flat(x[0], off_dy, off_dx, mod, groups, k, r)
    with pytest.raises(ValueError, match="no kernel for device"):
        meta = [t.to("meta") for t in (x, off_dy, off_dx, mod)]
        tdeform.dense_local_flat(*meta, groups, k, r)
    # the CUDA launchers refuse what the kernels cannot address, before any build
    with pytest.raises(ValueError, match="CUDA"):
        dl._launch_fwd(x, off_dy, off_dx, mod, groups, k, r)


def test_torch_dense_local_vector_width():
    """The widest 16-byte vector that divides the group's channels and
    keeps every row aligned."""
    x = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16)
    assert dl.vector_width(x, 4) == 8  # 16 bf16 channels per group
    assert dl.vector_width(x.float(), 4) == 4  # 16 bytes of float32
    assert dl.vector_width(x, 16) == 4
    assert dl.vector_width(x[..., :6], 2) == 1  # 3 channels per group
    assert dl.vector_width(x[..., :60], 5) == 4  # row stride 64, 12 per group
    assert dl.vector_width(x.transpose(1, 2), 4) == 8  # a spatial transpose view
    assert dl.vector_width(x[..., 2:34], 2) == 2  # rows start 4 bytes into a vector


def _tiled_dx_emulation(off_dy, off_dx, mod, g_out, groups, k, r, th, tw, slab):
    """d_x as the CUDA kernel ``dl_bwd_x_kernel`` computes it, block by
    block, with its index arithmetic: a block owns a th x tw tile of one
    image and one group; halo pixel hp of the tile grown by lim = half + r
    sits at (y0 - lim + hp // halo_w, x0 - lim + hp % halo_w); its weights
    wsum[o, hp] are summed over taps in order, corner by corner (zero for a
    pixel outside the map, as its gradient); then, per slab of channels,
    each input pixel sums wsum[o, q - o] * g_out[q - o] over o, y-major.
    Every element of d_x is written once: NaN marks the unwritten."""
    b_, h, w, c = g_out.shape
    gc, kk, half = c // groups, k * k, (k - 1) // 2
    lim = half + r
    span = 2 * lim + 1
    halo_w = tw + 2 * lim
    halo = (th + 2 * lim) * halo_w
    tiles_x, tiles_y = -(-w // tw), -(-h // th)
    f32 = np.float32
    tap = np.arange(kk)
    tap_y, tap_x = (tap // k - half).astype(f32), (tap % k - half).astype(f32)
    d_x = np.full(g_out.shape, np.nan, f32)
    hp = np.arange(halo)
    for b in range(b_):
        for grp in range(groups):
            maps = [m[b, :, :, grp * kk:(grp + 1) * kk] for m in (off_dy, off_dx, mod)]
            for tile in range(tiles_x * tiles_y):
                y0, x0 = (tile // tiles_x) * th, (tile % tiles_x) * tw
                py, px = y0 - lim + hp // halo_w, x0 - lim + hp % halo_w
                inside = (py >= 0) & (py < h) & (px >= 0) & (px < w)
                src, sy, sx = hp[inside], py[inside], px[inside]
                wsum = np.zeros((span * span, halo), f32)
                for t in range(kk):  # phase 1: tap by tap, corner by corner
                    dy = np.clip(maps[0][sy, sx, t], -r, r).astype(f32) + tap_y[t]
                    dx = np.clip(maps[1][sy, sx, t], -r, r).astype(f32) + tap_x[t]
                    fy, fx = np.floor(dy), np.floor(dx)
                    wy = (f32(1) - (dy - fy), dy - fy)
                    wx = (f32(1) - (dx - fx), dx - fx)
                    m = maps[2][sy, sx, t]
                    for cy in range(2):
                        for cx in range(2):
                            live = (wy[cy] != 0) & (wx[cx] != 0)
                            o = ((fy.astype(int) + cy + lim) * span
                                 + fx.astype(int) + cx + lim)[live]
                            cell = (o, src[live])
                            wsum[cell] = wsum[cell] + (m * wy[cy])[live] * wx[cx][live]
                ty, tx = np.divmod(np.arange(th * tw), tw)
                qy, qx = y0 + ty, x0 + tx
                real = (qy < h) & (qx < w)
                qy, qx = qy[real], qx[real]
                hp0 = (ty[real] + 2 * lim) * halo_w + tx[real] + 2 * lim
                for c0 in range(0, gc, slab):  # phase 2, slab by slab
                    chans = slice(grp * gc + c0, grp * gc + c0 + slab)
                    gs = np.zeros((halo, slab), f32)
                    gs[src] = g_out[b, sy, sx, chans]
                    acc = np.zeros((len(hp0), slab), f32)
                    for oi in range(span):
                        for oj in range(span):
                            at = hp0 - oi * halo_w - oj
                            acc = acc + wsum[oi * span + oj, at][:, None] * gs[at]
                    assert np.isnan(d_x[b, qy, qx, chans]).all(), "written twice"
                    d_x[b, qy, qx, chans] = acc
    assert not np.isnan(d_x).any(), "an element of d_x was never written"
    return d_x


@functools.lru_cache(maxsize=None)
def _jax_dx_13x21(groups):
    data = _inputs(1, 13, 21, groups, 16, 3, 2, seed=5 + groups)
    return data, np.asarray(_jax_out_and_grads(groups, 3, 2)(*data)[1])


@pytest.mark.parametrize("tile", [(16, 16, 16), (8, 16, 8), (4, 4, 16)],
                         ids=["16x16_slab16", "8x16_slab8", "4x4_slab16"])
@pytest.mark.parametrize("groups", [1, 4])
def test_torch_tiled_dx_algorithm_matches_jax_vjp(groups, tile):
    """The tiled d_x algorithm of the CUDA backward, on a 13 x 21 map (no
    multiple of any tile), 16 channels per group, offsets at 0, at +-r, at
    integers and beyond r: equal to the JAX VJP's d_x within 1e-5."""
    th, tw, slab = tile
    (x, off_dy, off_dx, mod, g_out), want = _jax_dx_13x21(groups)
    got = _tiled_dx_emulation(off_dy, off_dx, mod, g_out, groups, 3, 2, th, tw, slab)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _halo_maps_emulation(x, off_dy, off_dx, mod, g_out, groups, k, r, th, tw, gb):
    """d_off_dy, d_off_dx, d_modulation as the CUDA kernel
    ``dl_bwd_maps_kernel`` computes them, block by block, with its index
    arithmetic: a block owns a th x tw tile of one image and gb groups; it
    stages x over the tile grown by lim = half + r on every side and one more
    row and column on the high side (zeros outside the map: an unstaged
    corner would be read as NaN here), the tile's g_out and its maps; then
    each (pixel, group, tap) entry takes its 2 x 2 corner dot products from
    the staged halo, at halo row ty + lim + floor(d_y) (+1) and column
    tx + lim + floor(d_x) (+1). Every map entry is written once: NaN marks
    the unwritten."""
    b_, h, w, c = x.shape
    gc, kk, half = c // groups, k * k, (k - 1) // 2
    lim = half + r
    halo_h, halo_w = th + 2 * lim + 1, tw + 2 * lim + 1
    run = gb * kk
    f32 = np.float32
    outs = [np.full(off_dy.shape, np.nan, f32) for _ in range(3)]
    for b in range(b_):
        for g0 in range(0, groups, gb):
            chans = slice(g0 * gc, (g0 + gb) * gc)
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    xs = np.full((halo_h, halo_w, gb * gc), np.nan, f32)
                    hy, hx = np.meshgrid(np.arange(halo_h), np.arange(halo_w), indexing="ij")
                    py, px = y0 - lim + hy, x0 - lim + hx
                    inside = (py >= 0) & (py < h) & (px >= 0) & (px < w)
                    xs[inside] = x[b, py[inside], px[inside], chans]
                    xs[~inside] = 0.0
                    e = np.arange(th * tw * run)
                    p, kr = np.divmod(e, run)
                    ty, tx = np.divmod(p, tw)
                    gl, tap = np.divmod(kr, kk)
                    qy, qx = y0 + ty, x0 + tx
                    live = (qy < h) & (qx < w)
                    p, kr, ty, tx, gl, tap, qy, qx = (a[live] for a in
                                                      (p, kr, ty, tx, gl, tap, qy, qx))
                    at = (b, qy, qx, g0 * kk + kr)
                    oy, ox, m = (a[at] for a in (off_dy, off_dx, mod))
                    dy = np.clip(oy, -r, r).astype(f32) + (tap // k - half).astype(f32)
                    dx = np.clip(ox, -r, r).astype(f32) + (tap % k - half).astype(f32)
                    fy, fx = np.floor(dy), np.floor(dx)
                    wy, wx = (f32(1) - (dy - fy), dy - fy), (f32(1) - (dx - fx), dx - fx)
                    iy, ix = fy.astype(int) + ty + lim, fx.astype(int) + tx + lim
                    assert iy.min() >= 0 and iy.max() + 1 < halo_h
                    assert ix.min() >= 0 and ix.max() + 1 < halo_w
                    gv = g_out[b, qy, qx][np.arange(len(gl))[:, None],
                                          g0 * gc + gl[:, None] * gc + np.arange(gc)]
                    s = [[None, None], [None, None]]
                    for cy in range(2):
                        for cx in range(2):
                            xv = xs[iy + cy, ix + cx][np.arange(len(gl))[:, None],
                                                      gl[:, None] * gc + np.arange(gc)]
                            s[cy][cx] = (gv * xv).sum(axis=1, dtype=f32)
                    ky, kx = (wy[1] > 0).astype(f32), (wx[1] > 0).astype(f32)
                    row0 = wx[0] * s[0][0] + wx[1] * s[0][1]
                    row1 = wx[0] * s[1][0] + wx[1] * s[1][1]
                    col0 = wy[0] * s[0][0] + wy[1] * s[1][0]
                    col1 = wy[0] * s[0][1] + wy[1] * s[1][1]
                    for out, val in zip(outs, (
                            np.where((oy >= -r) & (oy <= r), m * ky * (row1 - row0), 0.0),
                            np.where((ox >= -r) & (ox <= r), m * kx * (col1 - col0), 0.0),
                            wy[0] * row0 + wy[1] * row1)):
                        assert np.isnan(out[at]).all(), "written twice"
                        out[at] = val
    for out in outs:
        assert not np.isnan(out).any(), "a map entry was never written"
    return outs


def _maps_tiling(groups, gc, elem_bytes, k=3, r=2, fwd=False, max_threads=288):
    """``halo_tiling`` of the CUDA source, for the maps kernel (three blocks
    a SM: 76,800 bytes of shared memory, at most 8 tile rows a thread) or
    with ``fwd`` for the forward (four blocks a SM: 57,344 bytes, at most 4
    rows a thread, unpadded rows, a 16-byte tap record per entry instead of
    a g_out row): (th, tw, gb, threads, shared bytes)."""
    budget, max_rows = (57344, 4) if fwd else (76800, 8)
    lim = (k - 1) // 2 + r
    gb = max([1] + [d for d in range(1, groups + 1)
                    if groups % d == 0 and d * gc * elem_bytes <= 128])
    row = -(-gb * gc * elem_bytes // 16) * 16
    row += 16 if (row // 16) % 2 == 0 and not fwd else 0  # the forward's rows are unpadded
    run = gb * k * k
    for th, tw in ((8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1)):
        if run * tw > max_threads:
            continue
        dty = max(d for d in range(1, th + 1) if th % d == 0 and run * tw * d <= max_threads)
        smem = (th + 2 * lim + 1) * (tw + 2 * lim + 1) * row + th * tw * (run * 16 if fwd else row)
        if smem <= budget and -(-th // dty) <= max_rows:
            return th, tw, gb, run * tw * dty, smem
    raise ValueError("does not fit")


@functools.lru_cache(maxsize=None)
def _jax_maps_13x21(groups):
    data = _inputs(1, 13, 21, groups, 64 // groups if groups < 16 else 4, 3, 2, seed=7 + groups)
    return data, [np.asarray(a) for a in _jax_out_and_grads(groups, 3, 2)(*data)[2:]]


@pytest.mark.parametrize("tile", [(8, 8, "host"), (8, 16, 1), (3, 5, 1), (4, 4, "all")],
                         ids=["8x8_host_groups", "8x16_one_group", "3x5_one_group",
                              "4x4_all_groups"])
@pytest.mark.parametrize("groups", [1, 4, 16])
def test_torch_halo_maps_algorithm_matches_jax_vjp(groups, tile):
    """The halo-tiled map gradients of the CUDA backward, on a 13 x 21 map
    (no multiple of any tile), with offsets at 0, at +-r (a total
    displacement of exactly half + r, whose +1 corner lies on the halo's
    extra row and column), at integers and beyond r: equal to the JAX VJP's
    d_off_dy, d_off_dx and d_modulation within 1e-5."""
    th, tw, gb = tile
    (x, off_dy, off_dx, mod, g_out), want = _jax_maps_13x21(groups)
    gc = x.shape[3] // groups
    gb = {"host": _maps_tiling(groups, gc, 4)[2], "all": groups}.get(gb, gb)
    got = _halo_maps_emulation(x, off_dy, off_dx, mod, g_out, groups, 3, 2, th, tw, gb)
    for name, a, b in zip(("d_off_dy", "d_off_dx", "d_modulation"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=name)


def test_torch_maps_tiling_at_intern_t_stages():
    """The maps kernel's tile at InternImage-T's group width (16 channels):
    8 x 8 pixels of 4 bf16 or 2 fp32 groups, 288 threads, 41,616 bytes of
    shared memory: within the three blocks per SM of its launch bound."""
    for groups in (4, 8, 16, 32):
        assert _maps_tiling(groups, 16, 2) == (8, 8, 4, 288, 41616)
        assert _maps_tiling(groups, 16, 4) == (8, 8, 2, 288, 41616)


def _halo_fwd_emulation(x_flat, strides, shape, off_dy, off_dx, mod, groups, k, r, th, tw, gb):
    """out as the CUDA kernel ``dl_fwd_kernel`` computes it, block by block,
    with its index arithmetic: a block owns a th x tw tile of one image and
    gb groups; it stages x, read from the flat buffer through its element
    strides (b, h, w), over the tile grown by lim = half + r on every side and
    one more row and column on the high side (zeros outside the map: an
    unstaged element would be read as NaN here); every (pixel, group, tap)
    entry of the tile gets its record once: m * wy0, m * wy1, wx1 and its
    lower corner's halo row and column; then each (pixel, group) sums its
    corner rows, taps in order and corners y-major, with w = (m * wy) * wx.
    Every element of out is written once: NaN marks the unwritten."""
    b_, h, w, c = shape
    xs_b, xs_h, xs_w = strides
    gc, kk, half = c // groups, k * k, (k - 1) // 2
    lim = half + r
    halo_h, halo_w = th + 2 * lim + 1, tw + 2 * lim + 1
    run = gb * kk
    f32 = np.float32
    out = np.full(shape, np.nan, f32)
    for b in range(b_):
        for g0 in range(0, groups, gb):
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    xs = np.full((halo_h, halo_w, gb * gc), np.nan, f32)
                    for hy in range(halo_h):
                        for hx in range(halo_w):
                            py, px = y0 - lim + hy, x0 - lim + hx
                            if 0 <= py < h and 0 <= px < w:
                                at = b * xs_b + py * xs_h + px * xs_w + g0 * gc
                                xs[hy, hx] = x_flat[at:at + gb * gc]
                            else:
                                xs[hy, hx] = 0.0
                    e = np.arange(th * tw * run)  # the tile's entries, pixel-major
                    p, kr = np.divmod(e, run)
                    ty, tx = np.divmod(p, tw)
                    gl, tap = np.divmod(kr, kk)
                    qy, qx = y0 + ty, x0 + tx
                    live = (qy < h) & (qx < w)
                    ty, tx, gl, tap, qy, qx, kr = (a[live] for a in (ty, tx, gl, tap, qy, qx, kr))
                    oy, ox, m = (a[b, qy, qx, g0 * kk + kr] for a in (off_dy, off_dx, mod))
                    dy = np.clip(oy, -r, r).astype(f32) + (tap // k - half).astype(f32)
                    dx = np.clip(ox, -r, r).astype(f32) + (tap % k - half).astype(f32)
                    fy, fx = np.floor(dy), np.floor(dx)
                    wy1, wx1 = dy - fy, dx - fx
                    rec_y = (m * (f32(1) - wy1), m * wy1)
                    rec_x = (f32(1) - wx1, wx1)
                    iy, ix = fy.astype(int) + ty + lim, fx.astype(int) + tx + lim
                    assert iy.min() >= 0 and iy.max() + 1 < halo_h
                    assert ix.min() >= 0 and ix.max() + 1 < halo_w
                    chans = gl[:, None] * gc + np.arange(gc)
                    for pix in np.unique(ty * tw + tx):
                        for g in range(gb):
                            mine = np.nonzero((ty * tw + tx == pix) & (gl == g))[0]
                            assert list(tap[mine]) == list(range(kk))
                            acc = np.zeros(gc, f32)
                            for i in mine:  # taps in order
                                for cy in range(2):
                                    for cx in range(2):
                                        wgt = rec_y[cy][i] * rec_x[cx][i]
                                        acc = acc + wgt * xs[iy[i] + cy, ix[i] + cx, chans[i]]
                            i = mine[0]
                            at = (b, qy[i], qx[i], slice((g0 + g) * gc, (g0 + g + 1) * gc))
                            assert np.isnan(out[at]).all(), "written twice"
                            out[at] = acc
    assert not np.isnan(out).any(), "an element of out was never written"
    return out


@functools.lru_cache(maxsize=None)
def _jax_fwd_13x21(groups):
    data = _inputs(1, 13, 21, groups, 64 // groups if groups < 16 else 4, 3, 2, seed=9 + groups)
    run = jax.jit(lambda *a: jdeform.dense_local_flat(*a, groups, 3, 2))
    return data, np.asarray(run(*data[:4]))


@pytest.mark.parametrize("layout", ["contiguous", "transposed_view"])
@pytest.mark.parametrize("tile", [(8, 8, "host"), (3, 5, 1), (4, 4, "all")],
                         ids=["8x8_host_groups", "3x5_one_group", "4x4_all_groups"])
@pytest.mark.parametrize("groups", [1, 4, 16])
def test_torch_halo_forward_algorithm_matches_jax(groups, tile, layout):
    """The halo-tiled forward of the CUDA kernel, on a 13 x 21 map (no
    multiple of any tile), with offsets at 0, at +-r (a total displacement
    of exactly half + r, whose +1 corner lies on the halo's extra row and
    column), at integers and beyond r, x read through the strides of a
    contiguous array or of a spatial transpose view: equal to the JAX
    package's dense_local_flat within 1e-5."""
    th, tw, gb = tile
    (x, off_dy, off_dx, mod, _), want = _jax_fwd_13x21(groups)
    b, h, w, c = x.shape
    gb = {"host": _maps_tiling(groups, c // groups, 4, fwd=True)[2], "all": groups}.get(gb, gb)
    if layout == "contiguous":
        flat, strides = x.ravel(), (h * w * c, w * c, c)
    else:  # the [B, W, H, C] buffer of which x is the transpose view
        flat, strides = np.ascontiguousarray(x.transpose(0, 2, 1, 3)).ravel(), (h * w * c, c, h * c)
    got = _halo_fwd_emulation(flat, strides, x.shape, off_dy, off_dx, mod, groups, 3, 2,
                              th, tw, gb)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_torch_forward_tiling_at_intern_t_stages():
    """The forward's tile at InternImage-T's four stages (16 channels a
    group): 4 x 8 pixels of 4 bf16 groups (39,552 bytes of shared memory) or
    8 x 8 pixels of 2 fp32 groups (47,232 bytes), 288 threads of at most 4
    map entries each: four blocks per SM, as its launch bound asks."""
    for groups in (4, 8, 16, 32):
        assert _maps_tiling(groups, 16, 2, fwd=True) == (4, 8, 4, 288, 39552)
        assert _maps_tiling(groups, 16, 4, fwd=True) == (8, 8, 2, 288, 47232)
