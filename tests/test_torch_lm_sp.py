"""Sequence parallelism of the port's Gemma (two gloo ranks, the sequence
over ``model``) against the JAX package's ``seq_axis`` runs on a ``(1, 2)``
mesh and against dense attention, at ``gemma_test`` in fp32; and the ring
alone, mirroring ``tests/test_ring_attention.py``.

One spawn runs ``torch_lm_parallel_jobs.job_sp``; the tests compare:

* logits and ``score`` (the ranks' slices concatenated) under
  ``"allgather"`` and ``"ring"`` within 1e-5 of max |value| of the JAX
  package's SP runs and of the dense forward;
* the next-token loss (rtol 1e-6) and its gradients, summed over the
  ranks, within 1e-5 of max |grad| of each leaf of the JAX SP gradients;
* the collectives a forward issues: one K/V all-gather pair a layer, or
  n - 1 = 1 rotation a layer;
* ring attention of global arrays: causal and not, a batch axis, padding
  at position -1, GQA blocks, and its gradients, within 1e-5 (outputs) and
  1e-4 (gradients) of max |value| of dense attention; its errors; the
  fallback to dense attention without a mesh; decode unaffected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_lm_parallel_jobs as jobs
from iseg_tpu.nlp.gemma import GemmaCausalLM as JaxLM
from iseg_tpu.nlp.gemma import get_preset as jax_get_preset
from iseg_tpu_torch.convert import flatten, load_flax
from iseg_tpu_torch.nlp.gemma import GemmaCausalLM, get_preset
from torch_parallel_helpers import spawn

torch.set_num_threads(1)

RTOL = 1e-5  # of max |value|
MODES = ("allgather", "ring")


@pytest.fixture(scope="module")
def jax_side():
    cfg = jax_get_preset(jobs.PRESET)
    jlm = JaxLM(cfg)
    variables = jlm.init(jax.random.PRNGKey(0))
    return cfg, jlm, variables


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    params = jax.tree_util.tree_map(np.asarray, jax_side[2]["params"])
    return spawn(jobs.job_sp, tmp_path_factory.mktemp("sp"), params=params)


def _sp_mesh():
    return Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "model"))


def _jax_sp(jax_side, mode, fn):
    cfg, _, variables = jax_side
    lm = JaxLM(cfg, seq_axis="model", data_axis="data", sp_mode=mode)
    mesh = _sp_mesh()
    with jax.set_mesh(mesh):
        ids = jax.device_put(jnp.asarray(jobs.make_ids(), jnp.int32),
                             NamedSharding(mesh, P("data", "model")))
        return jax.device_get(jax.jit(lambda v, i: fn(lm, v, i))(variables, ids))


def _loss(lm, params, ids):
    weights = jnp.asarray(jobs.make_weights(ids.shape))
    logits = lm({"params": params}, ids)
    lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(lp, ids[:, 1:, None], axis=-1)[..., 0]
    w = weights[:, 1:]
    return jnp.sum(nll * w) / jnp.maximum(jnp.sum(w), 1.0)


def _close(got, want, rtol=RTOL, msg=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=msg)


@pytest.mark.parametrize("mode", MODES)
def test_torch_lm_sp_logits_and_score_match_jax(jax_side, ranks, mode):
    _, jlm, variables = jax_side
    ids = jnp.asarray(jobs.make_ids(), jnp.int32)
    want_logits = _jax_sp(jax_side, mode, lambda lm, v, i: lm(v, i))
    want_score = _jax_sp(jax_side, mode, lambda lm, v, i: lm.score(v, i))
    dense = np.asarray(jlm(variables, ids))
    got_logits = np.concatenate([r[mode]["logits"] for r in ranks], axis=1)
    got_score = np.concatenate([r[mode]["score"] for r in ranks], axis=1)
    assert got_score.shape == (4, 15)
    _close(got_logits, want_logits)
    _close(got_logits, dense)
    _close(got_score, want_score)
    _close(got_score, np.asarray(jlm.score(variables, ids)))


@pytest.mark.parametrize("mode", MODES)
def test_torch_lm_sp_loss_and_grads_match_jax(jax_side, ranks, mode):
    cfg, _, variables = jax_side
    lm = JaxLM(cfg, seq_axis="model", data_axis="data", sp_mode=mode)
    mesh = _sp_mesh()
    with jax.set_mesh(mesh):
        ids = jax.device_put(jnp.asarray(jobs.make_ids(), jnp.int32),
                             NamedSharding(mesh, P("data", "model")))
        l_sp, g_sp = jax.device_get(jax.jit(jax.value_and_grad(
            lambda p: _loss(lm, p, ids)))(variables["params"]))
    g_sp = flatten(jax.tree_util.tree_map(np.asarray, g_sp))
    for r in ranks:
        got = r[mode]
        np.testing.assert_allclose(got["loss"], float(l_sp), rtol=1e-6)
        assert sorted(got["grads"]) == sorted(p for p in g_sp if not p.endswith("_scale"))
        for path, g in got["grads"].items():
            _close(g, g_sp[path], msg=f"{mode} {path}")


def test_torch_lm_sp_collective_counts(ranks):
    """Two forwards (logits, score) of two layers: allgather gathers K and V
    once a layer; the ring rotates n - 1 = 1 time a layer (and gathers its
    blocks' positions once); ``score`` shifts the next tokens once."""
    for r in ranks:
        assert r["allgather"]["calls"] == {"all_gather": 8, "ppermute": 1, "all_reduce": 0}
        assert r["ring"]["calls"] == {"all_gather": 4, "ppermute": 5, "all_reduce": 0}


def _dense(q, k, v, causal, kv_pos=None):
    t = q.shape[1]
    rep = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    s = np.einsum("bthd,bshd->bhts", q.astype(np.float64), k)
    ok = np.ones((1, 1, t, t), bool)
    if causal:
        ok = np.arange(t)[None, None, None, :] <= np.arange(t)[None, None, :, None]
    if kv_pos is not None:
        ok = ok & (kv_pos >= 0)[:, None, None, :]
        if causal:
            ok = ok & (kv_pos[:, None, None, :] <= np.arange(t)[None, None, :, None])
    s = np.where(ok, s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhts,bshd->bthd", p, v)


@pytest.mark.parametrize("case", ["causal=True", "causal=False", "batch_axis", "padding",
                                  "gqa"])
def test_torch_lm_sp_ring_matches_dense(ranks, case):
    q, k, v = jobs.make_qkv(kvh=2, seed=3) if case == "gqa" else jobs.make_qkv()
    kv_pos = None
    if case == "padding":
        kv_pos = np.broadcast_to(np.arange(32), (2, 32)).copy()
        kv_pos[:, 16:] = -1
    want = _dense(q, k, v, case != "causal=False", kv_pos)
    for r in ranks:
        _close(r["ring_alone"][case], want)


def test_torch_lm_sp_ring_grads_match_dense(ranks):
    q, k, v = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
               for a in jobs.make_qkv())
    s = torch.einsum("bthd,bshd->bhts", q, k)
    mask = torch.tril(torch.ones(32, 32, dtype=torch.bool))
    out = torch.einsum("bhts,bshd->bthd", torch.softmax(s.masked_fill(~mask, -1e30), -1), v)
    (out ** 2).sum().backward()
    for r in ranks:
        for got, want in zip(r["ring_alone"]["grads"], (q.grad, k.grad, v.grad)):
            _close(got, want.numpy(), rtol=1e-4)


def test_torch_lm_sp_ring_errors(ranks):
    for r in ranks:
        errors = r["ring_alone"]["errors"]
        assert "not divisible" in errors["seq"]
        assert "must be a multiple of kv heads" in errors["heads"]
        assert "needs a mesh" in errors["no_mesh"]


def test_torch_lm_sp_ring_without_mesh_is_dense(jax_side):
    params = jax.tree_util.tree_map(np.asarray, jax_side[2]["params"])
    cfg = get_preset(jobs.PRESET)
    plain = load_flax(GemmaCausalLM(cfg, device="cpu"), {"params": params})
    ring = load_flax(GemmaCausalLM(cfg, device="cpu", seq_axis="model", sp_mode="ring"),
                     {"params": params})
    ids = torch.tensor(jobs.make_ids())
    with torch.no_grad():
        np.testing.assert_array_equal(ring(ids).numpy(), plain(ids).numpy())


def test_torch_lm_sp_generation_unaffected(jax_side, ranks):
    _, jlm, variables = jax_side
    prompt, lengths = jobs.PROMPT
    want = np.asarray(jlm.generate(variables, jnp.asarray(prompt), jnp.asarray(lengths),
                                   max_length=jobs.GEN_LEN))
    for r in ranks:
        np.testing.assert_array_equal(r["generate"], want)
