"""The port's MoE layer (``nn/moe.py``) against the JAX package's, fp32 on
the CPU, and its expert parallelism on two gloo ranks.

* ``topk_dispatch`` on the same router probabilities: combine and dispatch
  EQUAL to the JAX package's and the aux loss within 1e-6 (fp32 means
  summed in another order: 1-2 ulp apart), at k = 1, 2 and
  3, with ties (the lower expert wins) and capacity drops;
* ``MoEFeedForward`` with the JAX weights (``convert.load_flax``) at k = 1
  and 2: output within 1e-5 of max |output| and aux within 1e-6, its
  gradients within 1e-5 of max |grad|; dropped tokens give zero output; the
  k = 1 router gets a task gradient;
* expert parallelism (one spawn of ``job_ep``, experts split over two
  ranks): output, aux loss and gradients (the router and the input whole on
  both ranks, each rank its experts' ``w1`` / ``w2``) within the same
  bounds of the JAX layer without an expert axis;
* ``convert.to_flax`` / ``load_flax`` carry the three leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parallel_jobs as jobs
from iseg_tpu.nn.moe import MoEFeedForward as JMoE
from iseg_tpu.nn.moe import topk_dispatch as j_topk_dispatch
from iseg_tpu_torch.convert import load_flax, to_flax
from iseg_tpu_torch.nn.moe import MoEFeedForward, topk_dispatch
from torch_parallel_helpers import spawn

torch.set_num_threads(1)

RTOL = 1e-5  # of max |value|
CAPACITY = 2.0


def _close(got, want, rtol=RTOL, msg=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=msg)


def _jax_layer(k, capacity_factor=CAPACITY, g=64, seed=0):
    moe = JMoE(num_experts=jobs.MOE_EXPERTS, d_ff=jobs.MOE_FF, k=k,
               capacity_factor=capacity_factor)
    x = jnp.asarray(jobs.make_moe_x(g))
    params = moe.init(jax.random.PRNGKey(seed), x)["params"]
    return moe, jax.tree_util.tree_map(np.asarray, params)


def _jax_run(moe, params, x):
    def loss(p, xx):
        y, aux = moe.apply({"params": p}, xx)
        return jnp.mean((y - xx) ** 2) + 0.01 * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    return np.asarray(y), float(aux), np.asarray(gx), jax.tree_util.tree_map(np.asarray, gp)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params = {k: _jax_layer(k)[1] for k in (1, 2)}
    # both k use the k = 1 weights' seed: one tree for the job
    return spawn(jobs.job_ep, tmp_path_factory.mktemp("ep"), params=params[1],
                 capacity_factor=CAPACITY)


@pytest.mark.parametrize("k,capacity", [(1, 64), (2, 64), (3, 64), (2, 5), (1, 3)])
def test_torch_lm_moe_topk_dispatch_equals_jax(k, capacity):
    rng = np.random.RandomState(k + capacity)
    logits = rng.randn(64, 8).astype(np.float32)
    logits[::7, 2] = logits[::7, 5] = 4.0  # exact ties: the lower expert wins
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    jc, jd, ja = j_topk_dispatch(jnp.asarray(probs), k, capacity)
    c, d, a = topk_dispatch(torch.tensor(probs), k, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-6)
    if capacity < 64:
        assert d.sum() < 64 * k  # some tokens were dropped


@pytest.mark.parametrize("k", [1, 2])
def test_torch_lm_moe_layer_matches_jax(k):
    moe, params = _jax_layer(k)
    x = jobs.make_moe_x()
    y, aux, gx, gp = _jax_run(moe, params, x)
    mine = load_flax(MoEFeedForward(jobs.MOE_DIM, jobs.MOE_EXPERTS, jobs.MOE_FF, k=k,
                                    capacity_factor=CAPACITY, device="cpu"),
                     {"params": params})
    xt = torch.tensor(x, requires_grad=True)
    got, got_aux = mine(xt)
    (((got - xt) ** 2).mean() + 0.01 * got_aux).backward()
    _close(got.detach().numpy(), y)
    np.testing.assert_allclose(float(got_aux.detach()), aux, rtol=1e-6)
    _close(xt.grad.numpy(), gx)
    for name, p in mine.named_parameters():
        _close(p.grad.numpy(), gp[name], msg=name)


def test_torch_lm_moe_capacity_drops_tokens():
    moe, params = _jax_layer(1, capacity_factor=0.1, g=16)
    mine = load_flax(MoEFeedForward(jobs.MOE_DIM, jobs.MOE_EXPERTS, jobs.MOE_FF, k=1,
                                    capacity_factor=0.1, device="cpu"), {"params": params})
    x = jobs.make_moe_x(16)
    with torch.no_grad():
        y, _ = mine(torch.tensor(x))
    want, _ = moe.apply({"params": params}, jnp.asarray(x))
    dropped = np.all(y.numpy() == 0, axis=1)
    np.testing.assert_array_equal(dropped, np.all(np.asarray(want) == 0, axis=1))
    assert 0 < dropped.sum() < 16
    _close(y.numpy(), np.asarray(want))


def test_torch_lm_moe_k1_router_gets_task_gradient():
    _, params = _jax_layer(1)
    mine = load_flax(MoEFeedForward(jobs.MOE_DIM, jobs.MOE_EXPERTS, jobs.MOE_FF, k=1,
                                    capacity_factor=CAPACITY, device="cpu"), {"params": params})
    x = torch.tensor(jobs.make_moe_x())
    y, _ = mine(x)
    ((y - x) ** 2).mean().backward()  # no aux term
    assert mine.router.grad.abs().max() > 1e-6


@pytest.mark.parametrize("k", [1, 2])
def test_torch_lm_moe_expert_parallel_matches_jax(ranks, k):
    moe = JMoE(num_experts=jobs.MOE_EXPERTS, d_ff=jobs.MOE_FF, k=k, capacity_factor=CAPACITY)
    _, params = _jax_layer(1)
    y, aux, gx, gp = _jax_run(moe, params, jobs.make_moe_x())
    for r, got in enumerate(res[k] for res in ranks):
        _close(got["y"], y)
        np.testing.assert_allclose(got["aux"], aux, rtol=1e-6)
        _close(got["dx"], gx)
        _close(got["grads"]["router"], gp["router"], msg="router")
        half = jobs.MOE_EXPERTS // 2
        for name in ("w1", "w2"):
            _close(got["grads"][name], gp[name][r * half:(r + 1) * half], msg=name)


def test_torch_lm_moe_convert_round_trip():
    _, params = _jax_layer(2)
    m = load_flax(MoEFeedForward(jobs.MOE_DIM, jobs.MOE_EXPERTS, jobs.MOE_FF, device="cpu"),
                  {"params": params})
    back = to_flax(m)["params"]
    assert sorted(back) == ["router", "w1", "w2"]
    for name in back:
        np.testing.assert_array_equal(back[name], params[name])
