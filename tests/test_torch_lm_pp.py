"""Pipeline parallelism of the port (four gloo ranks) against the serial
map and against the JAX package's ``make_pp_loss_fn``, fp32.

One spawn runs ``torch_lm_parallel_jobs.job_pp`` on four ranks: the 2-stage
cases on a ``(data 2, stage 2)`` mesh without a batch axis (each data row
runs the same pipeline), the 4-stage cases on ``(1, 4)``, DP x PP on
``(2, 2)`` with ``batch_axis="data"``. The tests compare:

* ``pipeline_spmd`` at 2 and 4 stages, with and without per-microbatch
  constants: outputs, the input's gradient and each stage's parameter
  gradients within 1e-6 of max |value| of the serial map's (autograd of the
  stages applied in order);
* the Gemma PP loss (rtol 1e-6) and gradients (each stage's layers on their
  rank, the shared leaves whole on every rank) within 1e-5 of max |grad| of
  each leaf of the JAX package's PP gradients, and the loss within 1e-5 of
  the JAX package's serial loss; one rotation a tick forward and back; the
  same with each layer recomputed in the backward (``remat=True``);
* ``to_pipeline_params`` / ``from_pipeline_params`` against the JAX
  package's, exactly, on torch and numpy leaves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_lm_parallel_jobs as jobs
from iseg_tpu.nlp.gemma import GemmaCausalLM as JaxLM
from iseg_tpu.nlp.gemma import get_preset as jax_get_preset
from iseg_tpu.nlp.gemma import pipeline as jpipe
from iseg_tpu_torch.convert import flatten
from iseg_tpu_torch.nlp.gemma.pipeline import (from_pipeline_params, stage_slice,
                                               to_pipeline_params)
from iseg_tpu_torch.parallel.pipeline import stack_params, unstack_params
from torch_parallel_helpers import spawn

torch.set_num_threads(1)

SCHEDULE_RTOL = 1e-6  # of max |value|
GEMMA_RTOL = 1e-5  # of max |grad| of the leaf


@pytest.fixture(scope="module")
def jax_side():
    cfg = dataclasses.replace(jax_get_preset(jobs.PRESET), num_layers=jobs.PP_LAYERS)
    variables = JaxLM(cfg).init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return cfg, params


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    _, params = jax_side
    staged, shared = {}, None
    for n in (2, 4):
        staged[n], shared = to_pipeline_params(params, n)
    return spawn(jobs.job_pp, tmp_path_factory.mktemp("pp"), world=4, params=params,
                 staged=staged, shared=shared)


def _serial(n_stages, with_const):
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(24, 16).astype(np.float32), requires_grad=True)
    c = torch.tensor(rng.rand(24).astype(np.float32))
    params = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
              for p in jobs.make_stage_params(n_stages)]
    y = x
    for p in params:
        y = jobs.stage_fn_const(p, y, c) if with_const else jobs.stage_fn(p, y)
    (y ** 2).sum().backward()
    return y.detach().numpy(), x.grad.numpy(), [{k: v.grad.numpy() for k, v in p.items()}
                                                for p in params]


def _close(got, want, rtol, msg=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=msg)


@pytest.mark.parametrize("n_stages", [2, 4])
@pytest.mark.parametrize("with_const", [False, True], ids=["plain", "const"])
def test_torch_lm_pp_schedule_matches_serial(ranks, n_stages, with_const):
    y, dx, dps = _serial(n_stages, with_const)
    for r in ranks:
        got = r[f"schedule{n_stages}"]
        if with_const:
            _close(got["y_const"], y, SCHEDULE_RTOL)
            for k, v in got["dp_const"].items():
                _close(v, dps[got["stage"]][k], SCHEDULE_RTOL, k)
        else:
            _close(got["y"], y, SCHEDULE_RTOL)
            _close(got["dx"], dx, SCHEDULE_RTOL)
            for k, v in got["dp"].items():
                _close(v, dps[got["stage"]][k], SCHEDULE_RTOL, k)
    assert sorted(r[f"schedule{n_stages}"]["stage"] for r in ranks) == sorted(
        [s for s in range(n_stages)] * (4 // n_stages))


def _jax_pp(cfg, params, n_stages, batch_axis, m):
    shape = (2, 2) if batch_axis else (n_stages,)
    names = ("data", "stage") if batch_axis else ("stage",)
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)
    staged, shared = jpipe.to_pipeline_params(params, n_stages)
    ids = jnp.asarray(jobs.make_ids(b=8), jnp.int32)
    weights = jnp.asarray(jobs.make_weights(ids.shape))
    loss_fn = jpipe.make_pp_loss_fn(cfg, mesh, num_microbatches=m, batch_axis=batch_axis)
    loss, (g_staged, g_shared) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        staged, shared, ids, weights)
    return float(loss), jax.tree_util.tree_map(np.asarray, (g_staged, g_shared))


@pytest.mark.parametrize("label,n_stages,batch_axis,m", [
    ("gemma2", 2, None, 4), ("gemma4", 4, None, 4), ("dp_pp", 2, "data", 2),
    ("gemma2_remat", 2, None, 4)])
def test_torch_lm_pp_gemma_loss_and_grads_match_jax(jax_side, ranks, label, n_stages,
                                                    batch_axis, m):
    cfg, params = jax_side
    loss, (g_staged, g_shared) = _jax_pp(cfg, params, n_stages, batch_axis, m)
    lm = JaxLM(cfg)
    ids = jnp.asarray(jobs.make_ids(b=8), jnp.int32)
    w = jnp.asarray(jobs.make_weights(ids.shape))[:, 1:]
    logits = lm({"params": params}, ids)
    lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(lp, ids[:, 1:, None], axis=-1)[..., 0]
    serial = float(jnp.sum(nll * w) / jnp.maximum(jnp.sum(w), 1.0))
    g_shared = flatten(g_shared)
    for r in ranks:
        got = r[label]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
        np.testing.assert_allclose(got["loss"], serial, rtol=1e-5)
        mine = flatten(stage_slice(g_staged, got["stage"]))
        theirs = flatten(got["g_stage"])
        assert sorted(theirs) == sorted(mine)
        for path, g in theirs.items():
            if path.endswith("_scale"):  # not applied: no gradient
                assert not np.any(g) and not np.any(mine[path])
                continue
            _close(g, mine[path], GEMMA_RTOL, f"{label} stage {got['stage']} {path}")
        for path, g in flatten(got["g_shared"]).items():
            if path.endswith("_scale"):
                continue
            _close(g, g_shared[path], GEMMA_RTOL, f"{label} shared {path}")
        # forward: M + S - 2 rotations (the last tick sends nothing)
        assert got["calls"]["ppermute"] == m + n_stages - 2


@pytest.mark.parametrize("n_stages", [1, 2])
def test_torch_lm_pp_params_round_trip_matches_jax(jax_side, n_stages):
    _, params = jax_side
    j_staged, j_shared = jpipe.to_pipeline_params(params, n_stages)
    staged, shared = to_pipeline_params(params, n_stages)
    for a, b in ((staged, j_staged), (shared, j_shared)):
        fa, fb = flatten(a), flatten(jax.tree_util.tree_map(np.asarray, b))
        assert sorted(fa) == sorted(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
    back = from_pipeline_params(staged, shared)
    assert sorted(flatten(back)) == sorted(flatten(params))
    torch_params = jax.tree_util.tree_map(torch.tensor, params)
    t_staged, t_shared = to_pipeline_params(torch_params, n_stages)
    for k, v in flatten(from_pipeline_params(t_staged, t_shared)).items():
        np.testing.assert_array_equal(v.numpy(), flatten(params)[k])
    with pytest.raises(ValueError, match="not divisible"):
        to_pipeline_params(params, 3)


def test_torch_lm_pp_stack_unstack():
    ps = [{k: torch.tensor(v) for k, v in p.items()} for p in jobs.make_stage_params(3)]
    stacked = stack_params(ps)
    assert stacked["w"].shape == (3, 16, 16)
    for a, b in zip(unstack_params(stacked, 3), ps):
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_torch_lm_pp_staged_trees_carry_through_convert(jax_side):
    """``convert.to_flax`` of a port model, staged and unstaged, loads back
    bit for bit; a stage's layer maps onto a decoder block by
    ``module_params_from_flax`` (views: a gradient lands on the staged
    leaf)."""
    from iseg_tpu_torch.convert import load_flax, module_params_from_flax, to_flax
    from iseg_tpu_torch.nlp.gemma import GemmaCausalLM, get_preset
    from iseg_tpu_torch.nlp.gemma.model import GemmaDecoderBlock

    cfg = dataclasses.replace(get_preset(jobs.PRESET), num_layers=jobs.PP_LAYERS)
    _, params = jax_side
    lm = load_flax(GemmaCausalLM(cfg, device="cpu"), {"params": params})
    staged, shared = to_pipeline_params(to_flax(lm)["params"], 2)
    back = load_flax(GemmaCausalLM(cfg, device="cpu"),
                     {"params": from_pipeline_params(staged, shared)})
    for (name, a), b in zip(lm.named_parameters(), back.parameters()):
        assert torch.equal(a, b), name
    leaf = torch.tensor(stage_slice(staged, 1)["attention"]["query"]["kernel"],
                        requires_grad=True)
    layer = jax.tree_util.tree_map(lambda a: torch.tensor(a[0]), stage_slice(staged, 1))
    layer["attention"]["query"]["kernel"] = leaf[0]
    block = GemmaDecoderBlock(cfg, device="cpu")
    mapped = module_params_from_flax(block, layer)
    assert torch.equal(mapped["attention.query.weight"].detach(),
                       lm.backbone.layer_2.attention.query.weight)
    mapped["attention.query.weight"].sum().backward()
    assert leaf.grad[0].abs().sum() > 0 and not leaf.grad[1:].any()
