"""Shared helpers of the backbone-zoo and head tests of the port
(``tests/test_torch_{zoo_layers,convnext,efficientnet,xception,moat,
mlp_mixer,fapn,nasfpn,zoo_train}.py``): a JAX module and its port are built
with the same flax weights (carried by ``iseg_tpu_torch.convert``), fed the
same seeded numpy inputs, and compared

* in eval mode in fp32, each output to ``F32_TOL`` (1e-5) of its largest
  magnitude;
* in train mode in float64 (``jax.enable_x64`` on the JAX side, the
  module in float64 on the port's), each output, every parameter's
  gradient, the input's gradient and every updated BN statistic to
  ``F64_TOL`` (1e-9) of its largest magnitude.

Where the JAX package rounds to fp32 inside a float64 run (an explicit
``astype(jnp.float32)``), ``keep_float64`` swaps in a ``jnp`` whose
``float32`` is float64 for that module, so both sides compute in float64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from iseg_tpu_torch.convert import _leaves, batch_stats_tree, flatten, load_flax, unflatten

F32_TOL, F64_TOL = 1e-5, 1e-9


class KeepFloat64:
    """``jnp`` as a module of the JAX package sees it, with ``float32``
    meaning float64, so that module's fp32 casts keep float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def keep_float64(monkeypatch, *modules) -> None:
    for module in modules:
        monkeypatch.setattr(module, "jnp", KeepFloat64())


def init_vars(jmod, *args, **kwargs) -> dict:
    """The flax variables of ``jmod`` (jitted init, PRNG key 0) as numpy."""
    fn = jax.jit(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, **kwargs))
    return jax.tree_util.tree_map(np.asarray, fn(*args))


def random_stats(variables: dict, seed: int = 1) -> dict:
    """Non-trivial BN running statistics, so eval mode really reads them."""
    if "batch_stats" not in variables:
        return variables
    rng = np.random.RandomState(seed)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, v.shape) if path[-1].key == "var"
                         else 0.1 * rng.randn(*v.shape)).astype(np.float32),
        variables["batch_stats"])
    return variables


def randomize(variables: dict, paths, scale: float, seed: int) -> dict:
    """Overwrite the params under each of ``paths`` (``a/b``; flax starts
    them at zero or a constant) with normal values times ``scale``."""
    rng = np.random.RandomState(seed)
    params = flatten(variables["params"])
    for key in params:
        if any(key == p or key.startswith(p + "/") for p in paths):
            params[key] = (scale * rng.randn(*np.shape(params[key]))).astype(np.float32)
    return {**variables, "params": unflatten(params)}


def close(t, j, tol: float = F32_TOL, what: str = "") -> None:
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    assert np.abs(j).max() > 0, what
    np.testing.assert_allclose(t, j, atol=tol * np.abs(j).max(), rtol=0, err_msg=what)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def as_list(out) -> list:
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _jax_in(x):
    return [jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x)


def _torch_in(x, **kw):
    """NHWC numpy -> the NCHW tensor view (a list of them for a list)."""
    if isinstance(x, list):
        return [_torch_in(a, **kw) for a in x]
    return torch.tensor(x).permute(0, 3, 1, 2).requires_grad_(kw.get("grad", False))


def pair(jmod, tmod, *args, stats: bool = True, **kwargs):
    """flax variables of ``jmod`` for ``args`` (NHWC arrays, or lists of
    them), loaded into ``tmod``; random BN statistics unless ``stats`` is
    False."""
    variables = init_vars(jmod, *[_jax_in(a) for a in args], **kwargs)
    if stats:
        variables = random_stats(variables)
    load_flax(tmod, variables)
    return variables


def check_eval(jmod, tmod, variables, x, tol: float = F32_TOL, j_kwargs=None):
    """fp32 eval outputs of both (NHWC ``x`` in, or a list of maps; 4-D
    outputs compared NHWC; a ``None`` endpoint must be None on both sides).
    Returns the port's."""
    j_kwargs = {"train": False, **(j_kwargs or {})}
    j = jax.jit(lambda v, a: jmod.apply(v, a, **j_kwargs))(variables, _jax_in(x))
    tmod.eval()
    with torch.no_grad():
        t = tmod(_torch_in(x))
    js, ts = as_list(j), as_list(t)
    assert len(js) == len(ts)
    for i, (a, b) in enumerate(zip(ts, js)):
        if b is None:
            assert a is None, f"output {i}"
            continue
        close(nhwc(a) if a.ndim == 4 else a.numpy(), b, tol, what=f"output {i}")
    return t


def check_train_f64(jmod, tmod, variables, x, seed: int = 5, j_kwargs=None,
                    tol: float = F64_TOL, grad_tols=None):
    """Train mode in float64 on both sides: the outputs, every parameter's
    gradient of ``sum_k <output_k, w_k>`` (random ``w_k``), the input's
    gradient and the updated BN statistics. ``grad_tols`` maps a parameter
    path prefix (or ``"input"``) to another tolerance for its gradient."""
    grad_tols = grad_tols or {}
    j_kwargs = {"train": True, **(j_kwargs or {})}
    x = ([np.asarray(a, np.float64) for a in x] if isinstance(x, list)
         else np.asarray(x, np.float64))
    tmod.double().train()
    xt = _torch_in(x, grad=True)
    t_out = as_list(tmod(xt))
    rng = np.random.RandomState(seed)
    weights = [None if o is None else rng.randn(*nhwc(o).shape if o.ndim == 4 else o.shape)
               for o in t_out]
    loss = sum((o.permute(0, 2, 3, 1) if o.ndim == 4 else o).mul(torch.tensor(w)).sum()
               for o, w in zip(t_out, weights) if o is not None)
    loss.backward()
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        stats = v64.get("batch_stats", {})

        def j_loss(params, a):
            out, mutated = jmod.apply({"params": params, "batch_stats": stats}, a,
                                      mutable=["batch_stats"], **j_kwargs)
            outs = as_list(out)
            total = sum(jnp.sum(o * w) for o, w in zip(outs, weights) if o is not None)
            return total, (outs, mutated)

        (_, (j_out, mutated)), (j_grads, j_xgrad) = jax.jit(
            jax.value_and_grad(j_loss, (0, 1), has_aux=True))(v64["params"], _jax_in(x))
        j_out = [None if o is None else np.asarray(o) for o in j_out]
        j_grads = flatten(jax.tree_util.tree_map(np.asarray, j_grads))
        j_xgrad = jax.tree_util.tree_map(np.asarray, j_xgrad)
        j_stats = flatten(jax.tree_util.tree_map(np.asarray, mutated.get("batch_stats", {})))
    for i, (a, b) in enumerate(zip(t_out, j_out)):
        if b is None:
            assert a is None
            continue
        close(nhwc(a) if a.ndim == 4 else a.detach().numpy(), b, tol, what=f"output {i}")
    # each gradient in the flax layout, by the leaf's own convert rule
    grads = {k: to_flax_fn(p.grad).numpy() for col, k, p, to_flax_fn, _ in _leaves(tmod)
             if col == "params" and isinstance(p, torch.nn.Parameter)}
    assert sorted(grads) == sorted(j_grads)
    # a bias right before a train-mode BN has a gradient of rounding size
    # (1e-14 - 1e-12) on both sides: no gradient is held closer than the
    # tolerance of 1e-3 of the model's largest one
    floor = 1e-3 * max(float(np.abs(g).max()) for g in j_grads.values())
    for k, g in grads.items():
        g_tol = next((v for prefix, v in grad_tols.items() if k.startswith(prefix)), tol)
        jg = j_grads[k]
        atol = g_tol * max(float(np.abs(jg).max()), floor)
        np.testing.assert_allclose(g, jg, atol=atol, rtol=0, err_msg=k)
    for i, (a, g) in enumerate(zip(as_list(xt), as_list(j_xgrad))):
        if not np.abs(g).any():  # an input the module does not read
            assert a.grad is None or not a.grad.abs().any(), f"input {i}"
            continue
        g_tol = grad_tols.get("input", tol)
        close(nhwc(a.grad), g, g_tol, what=f"input {i} gradient")
    for k, s in batch_stats_tree(tmod).items():
        close(s.numpy(), j_stats[k], tol, what=k)
    return t_out
