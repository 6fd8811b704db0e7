"""Tensor-parallel Gemma in the port (two gloo ranks, model parallelism 2)
against the JAX package's ``GemmaCausalLM`` with ``shard_gemma_params`` on
a ``(4, 2)`` mesh, at ``gemma_test`` (4 heads over 2 KV heads) in fp32.

One spawn runs ``torch_lm_parallel_jobs.job_tp``; the tests compare:

* logits within 1e-5 of max |logit| (the heads' partial sums meet in
  another order), the two ranks' bit for bit;
* the tokens of greedy and beam-4 ``generate`` (segmented and monolithic
  cache) EQUAL to the JAX package's, and equal on both ranks (top-k
  sampling too, from generators seeded alike);
* the next-token loss's gradient: each rank's shard of every leaf within
  1e-5 of max |grad| of the JAX gradient's slice by the layout;
* the layout map's specs equal to ``get_layout_map``'s; a single KV head
  (``gemma_2b_en``'s) raises on two ranks, as ``jax.device_put`` does; a
  mesh axis name the mesh does not have raises, as it does in JAX;
* the seeded shard loader against the world-size-1 model of the same seed
  (1e-5 of max |logit|), the differentiable collectives' values and
  gradients exactly, and the example driver's tokens against one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_lm_parallel_jobs as jobs
from iseg_tpu.nlp.gemma import GemmaCausalLM as JaxLM
from iseg_tpu.nlp.gemma import get_layout_map as jax_get_layout_map
from iseg_tpu.nlp.gemma import get_preset as jax_get_preset
from iseg_tpu.nlp.gemma import samplers as jax_samplers
from iseg_tpu.nlp.gemma import shard_gemma_params as jax_shard_gemma_params
from iseg_tpu.parallel.mesh import create_mesh as jax_create_mesh
from iseg_tpu_torch.convert import flatten
from iseg_tpu_torch.nlp.gemma import GemmaCausalLM, get_layout_map, get_preset
from iseg_tpu_torch.nlp.gemma.layout import init_seeded_shard, layout_spec
from torch_parallel_helpers import spawn

torch.set_num_threads(1)

LOGIT_RTOL = 1e-5  # of max |logit|
GRAD_RTOL = 1e-5  # of max |grad| over the leaf


@pytest.fixture(scope="module")
def jax_side():
    jlm = JaxLM(jax_get_preset(jobs.PRESET))
    variables = jlm.init(jax.random.PRNGKey(0), batch=1, seq=8)
    mesh = jax_create_mesh(model_parallelism=2)  # 4 data x 2 model
    sharded = {"params": jax_shard_gemma_params(variables["params"], mesh)}
    return jlm, variables, sharded


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    params = jax.tree_util.tree_map(np.asarray, jax_side[1]["params"])
    return spawn(jobs.job_tp, tmp_path_factory.mktemp("tp"), params=params)


def test_torch_lm_tp_local_shapes(ranks):
    for r in ranks:
        assert r["local_shapes"] == {"query": (2 * 16, 64), "embedding": (256, 64),
                                     "cache": (2, 2, 2, 8, 1, 16)}


def test_torch_lm_tp_logits_match_jax_mesh(jax_side, ranks):
    jlm, _, sharded = jax_side
    want = np.asarray(jlm(sharded, jnp.asarray(jobs.make_ids())))
    np.testing.assert_array_equal(ranks[0]["logits"], ranks[1]["logits"])
    np.testing.assert_allclose(ranks[0]["logits"], want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("program", ["greedy", "beam", "beam_mono"])
def test_torch_lm_tp_tokens_equal_jax(jax_side, ranks, program):
    jlm, _, sharded = jax_side
    prompt, lengths = (jnp.asarray(a) for a in jobs.PROMPT)
    if program == "greedy":
        want = jlm.generate(sharded, prompt, lengths, max_length=jobs.GEN_LEN)
    else:
        want = jlm.generate(sharded, prompt, lengths, max_length=jobs.GEN_LEN + 4,
                            sampler=jax_samplers.BeamSampler(4))
    np.testing.assert_array_equal(ranks[0][program], np.asarray(want))
    np.testing.assert_array_equal(ranks[1][program], np.asarray(want))


def test_torch_lm_tp_sampling_equal_on_both_ranks(ranks):
    np.testing.assert_array_equal(ranks[0]["top_k"], ranks[1]["top_k"])
    for r in ranks:  # CPU tensors: the gather's plain version, no launch
        assert r["gather_launches"] == {"gather": 0}
        assert r["staged"] == {"all_gather": 0, "reduce_scatter": 0, "ppermute": 0}


def test_torch_lm_tp_gradients_are_jax_shards(jax_side, ranks):
    jlm, variables, _ = jax_side
    ids = jnp.asarray(jobs.make_ids())
    weights = jnp.asarray(jobs.make_weights(ids.shape))

    def loss(params):
        logits = jlm({"params": params}, ids)
        lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(lp, ids[:, 1:, None], axis=-1)[..., 0]
        w = weights[:, 1:]
        return jnp.sum(nll * w) / jnp.maximum(jnp.sum(w), 1.0)

    l_ref, g_ref = jax.jit(jax.value_and_grad(loss))(variables["params"])
    g_ref = flatten(jax.tree_util.tree_map(np.asarray, g_ref))
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], float(l_ref), rtol=1e-6)
        # the int8 scales are buffers in the port (carried, not applied)
        assert sorted(got["grads"]) == sorted(p for p in g_ref if not p.endswith("_scale"))
        for path, full in g_ref.items():
            if path.endswith("_scale"):
                continue
            spec = layout_spec(path, full.ndim)
            want = full
            if "model" in spec:
                dim = spec.index("model")
                want = np.split(full, 2, axis=dim)[r]
            np.testing.assert_allclose(got["grads"][path], want, rtol=0,
                                       atol=GRAD_RTOL * np.abs(full).max(), err_msg=path)


def test_torch_lm_tp_layout_map_matches_jax(jax_side):
    params = jax.tree_util.tree_map(np.asarray, jax_side[1]["params"])
    want = flatten(jax.tree_util.tree_map(tuple, jax_get_layout_map(params),
                                          is_leaf=lambda x: isinstance(x, P)))
    got = flatten(get_layout_map(params))
    assert got == want
    sharded = sorted(p for p, s in got.items() if any(a is not None for a in s))
    assert any("query" in p for p in sharded) and any("gating_ffw" in p for p in sharded)
    assert "token_embedding/embedding" in sharded


def test_torch_lm_tp_single_kv_head_raises_like_jax(ranks):
    mesh = jax_create_mesh(model_parallelism=2)
    spec = jax_get_layout_map({"attention": {"key": {"kernel": np.zeros((64, 1, 16))}}})
    with pytest.raises(ValueError, match="divisible by 2"):
        jax.device_put(np.zeros((64, 1, 16), np.float32),
                       NamedSharding(mesh, spec["attention"]["key"]["kernel"]))
    for r in ranks:
        assert "KV heads (1) should be divisible" in r["one_kv_error"]
        assert "should be divisible by 2" in r["leaf_error"]


@pytest.mark.parametrize("case", ["gemma_seq_axis", "moe_expert_axis", "pipeline_stage_axis",
                                  "ring_seq_axis", "layout_axis"])
def test_torch_lm_tp_unknown_axis_raises(ranks, case):
    """A name the ``(data, model)`` mesh does not have is an error, never
    one rank holding the whole model."""
    for r in ranks:
        assert r["unknown_axis"][case] is not None, case
        assert "has no axis" in r["unknown_axis"][case]


def test_torch_lm_tp_unknown_axis_raises_in_jax():
    """The reference: an expert axis the JAX mesh does not have raises."""
    from iseg_tpu.nn.moe import MoEFeedForward as JaxMoE

    moe = JaxMoE(8, 16, k=2, expert_axis="expert")
    x = jnp.ones((64, 8))
    variables = moe.init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="not found in mesh"):
        with jax.set_mesh(jax_create_mesh(model_parallelism=2)):
            jax.jit(moe.apply)(variables, x)


def test_torch_lm_tp_seeded_shard_matches_world_one(ranks):
    lm = init_seeded_shard(GemmaCausalLM(get_preset(jobs.PRESET), device="cpu"), 3)
    with torch.no_grad():
        want = lm(torch.tensor(jobs.make_ids())).numpy()
    for r in ranks:
        np.testing.assert_allclose(r["seeded_logits"], want, rtol=0,
                                   atol=LOGIT_RTOL * np.abs(want).max())


def test_torch_lm_tp_collectives_and_their_gradients(ranks):
    x = [np.arange(6, dtype=np.float64).reshape(2, 3) + 10 * r for r in (0, 1)]
    w = [np.full((2, 3), r + 1.0) for r in (0, 1)]
    for r, got in enumerate(res["collectives"] for res in ranks):
        o = 1 - r
        y, g = got["ppermute"]  # rank r receives rank r - 1's, sends to r + 1
        np.testing.assert_array_equal(y, x[o])
        np.testing.assert_array_equal(g, w[o])  # the inverse rotation
        y, g = got["ppermute_back"]
        np.testing.assert_array_equal(y, x[o])
        np.testing.assert_array_equal(g, w[o])
        y, g = got["reduce_from"]  # a replicated sum: its gradient once
        np.testing.assert_array_equal(y, x[0] + x[1])
        np.testing.assert_array_equal(g, w[r])
        y, g = got["copy_to"]  # uses that differ by rank: their sum
        np.testing.assert_array_equal(y, x[r])
        np.testing.assert_array_equal(g, w[0] + w[1])
        y, g = got["gather_slice"]
        np.testing.assert_array_equal(y, np.concatenate(x, axis=1))
        np.testing.assert_array_equal(g, w[r])
        y, g = got["gather_rs"]
        np.testing.assert_array_equal(g, w[0] + w[1])


def test_torch_lm_tp_example_matches_one_process(ranks):
    from iseg_tpu_torch.examples import gemma_generate

    want = gemma_generate.main(["--device", "cpu", "--max_length", "12"])
    assert ranks[0]["example"] == ranks[1]["example"] == want
