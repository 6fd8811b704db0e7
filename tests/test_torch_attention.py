"""The port's attention layers (``iseg_tpu_torch/nn/attention.py``) against
``iseg_tpu.nn.attention``, with the same weights (carried by
``iseg_tpu_torch.convert``) and inputs made from numpy seeds, on the CPU.

* ``flatten_hw``, ``get_attention`` and ``dot_product_attention`` (with a
  boolean mask, a fully masked row and ``guard_numerics``);
* ``F.scaled_dot_product_attention`` as the card calls it
  (``sdpa_attention``) against the plain version;
* ``MultiHeadSelfAttention2D`` (with a mask), ``MultiHeadAxialAttention2D``,
  ``SelfAttention2D`` and ``DeformableMultiHeadAttention2D`` (with offsets
  that move the samples off the grid and out of the map), each with the
  ``to_flax`` round trip.

Tolerances: fp32 forwards to 1e-5 of max(1, max |ref|); float64 gradients
of a weighted sum of the output (every parameter and the input) to 1e-9 of
each gradient's largest magnitude. The JAX package casts to fp32 where the
port casts to ``promote_types(dtype, float32)``: its softmax of
``jax.nn.dot_product_attention`` and its fp32 casts in
``iseg_tpu/nn/attention.py`` round float64 input. The float64 comparisons
therefore swap in the same arithmetic in float64 (``keep_float64``: the
module's ``jnp.float32`` means float64, and ``jax.nn.dot_product_attention``
takes its softmax in the logits' type); the fp32 ones run the JAX package
unchanged. The sampling coordinates of ``bilinear_gather`` are fp32 on both
sides in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.nn import attention as jattn
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax
from iseg_tpu_torch.nn import attention as tattn

torch.set_num_threads(1)

F32_TOL, F64_TOL = 1e-5, 1e-9
COORD_TOL = 1e-6  # float64 gradients through fp32 sampling coordinates (a few fp32 ulps)


class KeepFloat64:
    """``jnp`` as a module of the JAX package sees it, with ``float32``
    meaning float64, so that module's fp32 casts keep float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def attention_f64(query, key, value, mask=None):
    """``jax.nn.dot_product_attention``'s XLA path with its softmax in the
    logits' type."""
    logits = jnp.einsum("BTNH,BSNH->BNTS", query, key) / np.sqrt(query.shape[-1])
    if mask is not None:
        logits = jnp.where(mask, logits, -0.7 * jnp.finfo(logits.dtype).max)
    return jnp.einsum("BNTS,BSNH->BTNH", jax.nn.softmax(logits, axis=-1), value)


def keep_float64(monkeypatch):
    """The float64 swap of ``iseg_tpu.nn.attention`` (undone after the test)."""
    monkeypatch.setattr(jattn, "jnp", KeepFloat64())
    monkeypatch.setattr(jax.nn, "dot_product_attention", attention_f64)


def close_f32(t, j, what=""):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=0, atol=F32_TOL * max(1.0, np.abs(j).max()),
                               err_msg=what)


def close_f64(t, j, what=""):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    assert np.abs(j).max() > 0, what
    np.testing.assert_allclose(t, j, rtol=0, atol=F64_TOL * np.abs(j).max(), err_msg=what)


def flax_layout(g: torch.Tensor) -> np.ndarray:
    """A gradient in its parameter's flax layout (conv OIHW -> HWIO, linear
    [out, in] -> [in, out])."""
    if g.ndim == 4:
        g = g.permute(2, 3, 1, 0)
    elif g.ndim == 2:
        g = g.t()
    return g.detach().numpy()


def check_module(jmod, tmod, inputs, weight_seed=5, **kwargs):
    """Load ``jmod``'s weights (drawn at random) into ``tmod`` and hold the
    fp32 forwards of ``inputs`` (numpy) together. ``kwargs`` go to both
    calls (numpy arrays as tensors). Returns the weights and the port's
    kwargs."""
    j_in = [jnp.asarray(a) for a in inputs]
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, **kwargs))(*j_in))
    variables = randomize(variables, weight_seed)
    load_flax(tmod, variables)
    j_out = jax.jit(lambda v, *a: jmod.apply(v, *a, **kwargs))(variables, *j_in)
    t_kwargs = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
    with torch.no_grad():
        t_out = tmod(*[torch.tensor(a) for a in inputs], **t_kwargs)
    close_f32(t_out.numpy(), j_out, "fp32 forward")
    return variables, t_kwargs


def check_grads_f64(jmod, tmod, variables, x, t_kwargs=None, tols=None, **kwargs):
    """float64 gradients of ``sum(out * w)`` (``w`` random) in both
    packages, with respect to every parameter and ``x`` ("input"), each to
    ``F64_TOL`` of its largest magnitude, or to ``tols[name]`` (where a
    name ends with it) of the largest gradient of all: a tolerance given
    with its reason where fp32 arithmetic inside both packages or a
    gradient that is 0 but for rounding (``0.0``: then both must lie within
    1e-12 of the largest) sets the floor."""
    tols = tols or {}
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        x64 = jnp.asarray(x, jnp.float64)
        w = np.random.RandomState(9).randn(*jax.eval_shape(
            lambda v, a: jmod.apply(v, a, **kwargs), v64, x64).shape)

        def loss(v, a):
            return jnp.sum(jmod.apply(v, a, **kwargs) * w)

        j_gp, j_gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v64, x64)
        j_grads = flatten(jax.tree_util.tree_map(np.asarray, j_gp["params"]))
        j_grads["input"] = np.asarray(j_gx)
    tmod.double()
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    (tmod(xt, **(t_kwargs or {})) * torch.tensor(w)).sum().backward()
    params = param_tree(tmod)
    assert sorted(params) == sorted(j_grads.keys() - {"input"})
    t_grads = {path: flax_layout(p.grad) for path, p in params.items()}
    t_grads["input"] = xt.grad.numpy()
    largest = max(np.abs(g).max() for g in j_grads.values())
    for name, j in j_grads.items():
        tol = next((v for k, v in tols.items() if name.endswith(k)), None)
        if tol is None:
            close_f64(t_grads[name], j, f"d {name}")
        else:
            np.testing.assert_allclose(t_grads[name], j, rtol=0,
                                       atol=max(tol, 1e-12) * largest, err_msg=f"d {name}")


def randomize(variables, seed):
    """Every parameter drawn at random (zero-initialized ones too), so
    every path of the module carries signal."""
    rng = np.random.RandomState(seed)
    return {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(0.3 * rng.randn(*a.shape), np.float32), variables["params"])}


def round_trip(tmod, variables):
    mine, theirs = flatten(to_flax(tmod)["params"]), flatten(variables["params"])
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-7, err_msg=k)


def test_torch_flatten_hw_matches_jax():
    x = np.random.RandomState(0).randn(2, 3, 5, 4).astype(np.float32)
    np.testing.assert_array_equal(tattn.flatten_hw(torch.tensor(x)).numpy(),
                                  np.asarray(jattn.flatten_hw(jnp.asarray(x))))


@pytest.mark.parametrize("apply_scale", [False, True])
@pytest.mark.parametrize("numeric_stable", [False, True])
def test_torch_get_attention_matches_jax(apply_scale, numeric_stable, monkeypatch):
    rng = np.random.RandomState(1)
    q, k = rng.randn(2, 7, 8), rng.randn(2, 5, 8)
    q32, k32 = q.astype(np.float32), k.astype(np.float32)
    close_f32(tattn.get_attention(torch.tensor(q32), torch.tensor(k32), apply_scale,
                                  numeric_stable).numpy(),
              jattn.get_attention(jnp.asarray(q32), jnp.asarray(k32), apply_scale,
                                  numeric_stable))
    keep_float64(monkeypatch)
    with jax.enable_x64(True):
        j = jattn.get_attention(jnp.asarray(q), jnp.asarray(k), apply_scale, numeric_stable)
        wq, wk = jax.grad(lambda a, b: jnp.sum(
            jattn.get_attention(a, b, apply_scale, numeric_stable) ** 2), (0, 1))(
                jnp.asarray(q), jnp.asarray(k))
    tq = torch.tensor(q, requires_grad=True)
    tk = torch.tensor(k, requires_grad=True)
    t = tattn.get_attention(tq, tk, apply_scale, numeric_stable)
    (t ** 2).sum().backward()
    close_f64(t.detach().numpy(), j)
    close_f64(tq.grad.numpy(), wq)
    close_f64(tk.grad.numpy(), wk)


def _qkv_mask(seed=2, b=2, t=6, s=6, h=3, d=8):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, n, h, d).astype(np.float32) for n in (t, s, s))
    mask = rng.rand(b, h, t, s) < 0.7
    mask[0, 1, 2] = False  # a fully masked row attends uniformly
    return q, k, v, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("guard", [False, True])
def test_torch_dot_product_attention_matches_jax(masked, guard):
    q, k, v, mask = _qkv_mask()
    mask = mask if masked else None
    j = jax.jit(lambda q, k, v, m: jattn.dot_product_attention(q, k, v, m, guard))(
        q, k, v, None if mask is None else jnp.asarray(mask))
    t = tattn.dot_product_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                    None if mask is None else torch.tensor(mask), guard)
    close_f32(t.numpy(), j)


def test_torch_dot_product_attention_float64_grads_match_jax(monkeypatch):
    keep_float64(monkeypatch)
    q, k, v, mask = _qkv_mask(3)
    w = np.random.RandomState(4).randn(*q.shape)
    with jax.enable_x64(True):
        args = [jnp.asarray(a, jnp.float64) for a in (q, k, v)]
        j_grads = jax.grad(lambda q, k, v: jnp.sum(jattn.dot_product_attention(
            q, k, v, jnp.asarray(mask)) * w), (0, 1, 2))(*args)
    ts = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (q, k, v)]
    (tattn.dot_product_attention(*ts, torch.tensor(mask)) * torch.tensor(w)).sum().backward()
    for t, j, name in zip(ts, j_grads, "qkv"):
        close_f64(t.grad.numpy(), j, f"d{name}")


@pytest.mark.parametrize("masked", [False, True])
def test_torch_sdpa_call_matches_the_plain_version(masked):
    """The card's call, ``F.scaled_dot_product_attention`` with the layout
    and the mask converted, run here on CPU tensors."""
    q, k, v, mask = _qkv_mask(5, t=9, s=7)
    mask = torch.tensor(mask) if masked else None
    args = [torch.tensor(a) for a in (q, k, v)]
    close_f32(tattn.sdpa_attention(*args, mask).numpy(),
              tattn.dot_product_attention_reference(*args, mask).numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_torch_mhsa_matches_jax(masked, monkeypatch):
    x = np.random.RandomState(6).randn(2, 3, 4, 16).astype(np.float32)
    kwargs = {"mask": np.random.RandomState(7).rand(2, 1, 12, 12) < 0.8} if masked else {}
    jm = jattn.MultiHeadSelfAttention2D(num_heads=4, filters=24, out_filters=8)
    tm = tattn.MultiHeadSelfAttention2D(16, num_heads=4, filters=24, out_filters=8)
    variables, t_kwargs = check_module(jm, tm, [x], **kwargs)
    round_trip(tm, variables)
    keep_float64(monkeypatch)
    check_grads_f64(jm, tm, variables, x, t_kwargs, **kwargs)


def test_torch_axial_attention_matches_jax(monkeypatch):
    x = np.random.RandomState(8).randn(2, 5, 3, 12).astype(np.float32)
    jm = jattn.MultiHeadAxialAttention2D(num_heads=3, filters=6)
    tm = tattn.MultiHeadAxialAttention2D(12, num_heads=3, filters=6)
    variables, _ = check_module(jm, tm, [x])
    round_trip(tm, variables)
    keep_float64(monkeypatch)
    check_grads_f64(jm, tm, variables, x)


def test_torch_self_attention_2d_matches_jax(monkeypatch):
    x = np.random.RandomState(10).randn(2, 4, 5, 16).astype(np.float32)
    jm = jattn.SelfAttention2D()
    tm = tattn.SelfAttention2D(16)
    variables, _ = check_module(jm, tm, [x])
    assert flatten(variables["params"])["gamma"].shape == ()
    round_trip(tm, variables)
    keep_float64(monkeypatch)
    # softmax over the keys ignores a shift of every logit of a query by
    # the same value, so the key bias has no gradient
    check_grads_f64(jm, tm, variables, x, tols={"k/bias": 0.0})


def test_torch_deformable_attention_matches_jax(monkeypatch):
    """Random offset and weight layers: the samples leave the grid points
    and, near the border, the map. ``bilinear_gather`` computes its
    coordinates and corner weights in fp32 in both packages, so the
    gradients that reach the offsets pass through fp32 arithmetic: those of
    the offset layer and of the input are held to ``COORD_TOL`` of the
    largest gradient."""
    x = np.random.RandomState(11).randn(2, 6, 5, 8).astype(np.float32)
    jm = jattn.DeformableMultiHeadAttention2D(num_heads=2, num_points=3, offset_scale=2.0)
    tm = tattn.DeformableMultiHeadAttention2D(8, num_heads=2, num_points=3, offset_scale=2.0)
    variables, _ = check_module(jm, tm, [x])
    round_trip(tm, variables)
    keep_float64(monkeypatch)
    check_grads_f64(jm, tm, variables, x,
                    tols={"offsets/kernel": COORD_TOL, "offsets/bias": COORD_TOL,
                          "input": COORD_TOL})


def test_torch_attention_modules_initialize_like_flax():
    from iseg_tpu_torch.nn.initializers import initialize

    gen = torch.Generator().manual_seed(0)
    deform = initialize(tattn.DeformableMultiHeadAttention2D(8, num_heads=2), gen)
    assert not deform.offsets.weight.any() and not deform.weights.weight.any()
    assert deform.value.weight.std() > 0
    sa = tattn.SelfAttention2D(16)
    sa.gamma.data.fill_(1.0)
    initialize(sa, gen)
    assert float(sa.gamma.detach()) == 0.0
    x = torch.randn(1, 3, 3, 16, generator=gen)
    assert torch.equal(sa(x), x)  # the gate starts closed
    with pytest.raises(ValueError, match="divisible"):
        tattn.MultiHeadSelfAttention2D(16, num_heads=3)
