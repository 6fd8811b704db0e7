"""The port's ``GemmaCausalLM.generate`` against the JAX package's: the same
prompts, the JAX model's weights, ``gemma_test`` in fp32 on the CPU, and
tokens that are EQUAL for every deterministic program (greedy, beam search
with a segmented and a monolithic cache, contrastive search in both modes).
The random samplers cannot match ``jax.random`` draw for draw: they are held
by their support and by temperature 0 = greedy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.nlp.gemma import GemmaCausalLM as JaxLM
from iseg_tpu.nlp.gemma import get_preset as jax_get_preset
from iseg_tpu.nlp.gemma import samplers as jax_samplers
from iseg_tpu_torch import convert
from iseg_tpu_torch.nlp.gemma import (
    BeamSampler,
    ContrastiveSampler,
    GemmaCausalLM,
    GreedySampler,
    RandomSampler,
    TopKSampler,
    TopPSampler,
    get_preset,
    get_sampler,
)
from iseg_tpu_torch.nlp.gemma import causal_lm as causal_lm_module
from iseg_tpu_torch.nlp.gemma import samplers as S
from iseg_tpu_torch.ops.kernels import cache_gather as cg

torch.set_num_threads(1)

RAGGED = (np.array([[5, 9, 3, 7], [11, 2, 0, 0]], np.int32), np.array([4, 2], np.int32))
EVEN = (np.array([[5, 7, 11], [9, 2, 4]], np.int32), np.array([3, 3], np.int32))


@pytest.fixture(scope="module")
def lms():
    jlm = JaxLM(jax_get_preset("gemma_test"))
    variables = jlm.init(jax.random.PRNGKey(0), batch=1, seq=8)
    lm = GemmaCausalLM(get_preset("gemma_test"), device="cpu")
    convert.load_flax(lm, jax.tree_util.tree_map(np.asarray, variables))
    return jlm, variables, lm.eval()


def _both(lms, prompt, lengths, max_length, jax_sampler, sampler, **kw):
    jlm, variables, lm = lms
    want = np.asarray(jlm.generate(variables, jnp.asarray(prompt), jnp.asarray(lengths),
                                   max_length=max_length, sampler=jax_sampler, **kw))
    got = lm.generate(prompt, lengths, max_length=max_length, sampler=sampler, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    return got.numpy(), want


# -- tokens equal to the JAX package's -----------------------------------------


@pytest.mark.parametrize("prompts", [EVEN, RAGGED], ids=["even", "ragged"])
def test_torch_gemma_generate_greedy_equals_jax(lms, prompts):
    got, want = _both(lms, *prompts, 14, None, None)
    np.testing.assert_array_equal(got, want)
    for row, n in enumerate(prompts[1]):
        np.testing.assert_array_equal(got[row, :n], prompts[0][row, :n])


@pytest.mark.parametrize("num_beams", [2, 4])
@pytest.mark.parametrize("prompts", [EVEN, RAGGED], ids=["even", "ragged"])
def test_torch_gemma_generate_beam_segmented_equals_jax(lms, prompts, num_beams):
    """segment_len 4 over 14 to 16 generated slots: the active cache grows
    three times inside one generation."""
    cg.reset_launch_counts()
    got, want = _both(lms, *prompts, 18, jax_samplers.BeamSampler(num_beams),
                      BeamSampler(num_beams), cache_policy="segmented", segment_len=4)
    np.testing.assert_array_equal(got, want)
    assert cg.LAUNCH_COUNTS == {"gather": 0}  # CPU tensors: the plain version


@pytest.mark.parametrize("num_beams", [2, 4])
def test_torch_gemma_generate_beam_monolithic_equals_jax(lms, num_beams):
    got, want = _both(lms, *RAGGED, 18, jax_samplers.BeamSampler(num_beams),
                      BeamSampler(num_beams), cache_policy="monolithic")
    np.testing.assert_array_equal(got, want)
    _, _, lm = lms
    seg = lm.generate(*RAGGED, max_length=18, sampler=BeamSampler(num_beams), segment_len=5)
    np.testing.assert_array_equal(seg.numpy(), want)


@pytest.mark.parametrize("policy", ["segmented", "monolithic"])
def test_torch_gemma_generate_beam_end_token_equals_jax(lms, policy):
    """The greedy first token as end token: the best beam stops at once and
    continues with token 0 at a frozen score."""
    _, _, lm = lms
    prompt, lengths = np.array([[5, 9, 3]], np.int32), np.array([3], np.int32)
    end_id = int(lm.generate(prompt, lengths, max_length=5)[0, 3])
    for end in (end_id, 1):
        got, want = _both(lms, prompt, lengths, 16, jax_samplers.BeamSampler(2), BeamSampler(2),
                          end_token_id=end, cache_policy=policy, segment_len=5)
        np.testing.assert_array_equal(got, want)
    arr = list(got[0])
    if 1 in arr[3:]:
        assert all(t == 0 for t in arr[3 + arr[3:].index(1) + 1:])


def test_torch_gemma_generate_greedy_end_token_equals_jax(lms):
    _, _, lm = lms
    end_id = int(lm.generate(*EVEN, max_length=6)[0, 4])
    got, want = _both(lms, *EVEN, 12, None, None, end_token_id=end_id)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("policy", ["segmented", "monolithic"])
@pytest.mark.parametrize("prompts", [EVEN, RAGGED], ids=["even", "ragged"])
def test_torch_gemma_generate_contrastive_equals_jax(lms, prompts, policy):
    """``cache_policy`` picks the shared-context or the monolithic
    formulation of the candidate forward."""
    got, want = _both(lms, *prompts, 14, jax_samplers.ContrastiveSampler(k=3, alpha=0.5),
                      ContrastiveSampler(k=3, alpha=0.5), cache_policy=policy)
    np.testing.assert_array_equal(got, want)


def test_torch_gemma_generate_contrastive_strong_penalty_equals_jax(lms):
    got, want = _both(lms, *EVEN, 12, jax_samplers.ContrastiveSampler(k=4, alpha=0.9),
                      ContrastiveSampler(k=4, alpha=0.9), end_token_id=1)
    np.testing.assert_array_equal(got, want)


# -- the port's own invariants -------------------------------------------------


def test_torch_gemma_generate_beam1_and_alpha0_are_greedy(lms):
    _, _, lm = lms
    greedy = lm.generate(*RAGGED, max_length=10)
    for sampler, kw in ((BeamSampler(1), {}), (BeamSampler(1), dict(cache_policy="monolithic")),
                        (ContrastiveSampler(k=4, alpha=0.0), {}), ("greedy", {}),
                        (GreedySampler(), {}), (RandomSampler(temperature=0.0), {})):
        out = lm.generate(*RAGGED, max_length=10, sampler=sampler, **kw)
        assert torch.equal(out, greedy), sampler


def test_torch_gemma_generate_matches_stepwise_forward(lms):
    """Greedy generate equals the argmax of repeated full forwards."""
    _, _, lm = lms
    out = lm.generate(np.array([[9, 2]]), np.array([2]), max_length=6)
    ids = [9, 2]
    with torch.no_grad():
        for _ in range(4):
            ids.append(int(lm(torch.tensor([ids]))[0, -1].argmax()))
    assert out[0].tolist() == ids


def test_torch_gemma_generate_ragged_rows_equal_solo_rows(lms):
    """A short row generates from its OWN length, and equals the same row
    generated alone without padding."""
    _, _, lm = lms
    prompt, lengths = np.array([[5, 7, 11], [2, 9, 0]]), np.array([3, 2])
    for sampler in (GreedySampler(), BeamSampler(2), ContrastiveSampler(k=2, alpha=0.3)):
        out = lm.generate(prompt, lengths, max_length=7, sampler=sampler)
        solo0 = lm.generate(prompt[:1], lengths[:1], max_length=7, sampler=sampler)
        solo1 = lm.generate(prompt[1:, :2], lengths[1:], max_length=7, sampler=sampler)
        assert torch.equal(out[0], solo0[0]) and torch.equal(out[1], solo1[0]), sampler


def test_torch_gemma_generate_takes_tensors_and_arrays(lms):
    _, _, lm = lms
    want = lm.generate(*EVEN, max_length=8)
    got = lm.generate(torch.tensor(EVEN[0]), torch.tensor(EVEN[1]), max_length=8)
    assert torch.equal(got, want)
    got = lm.generate(EVEN[0].tolist(), list(EVEN[1]), max_length=8)
    assert torch.equal(got, want)


def test_torch_gemma_beam_swaps_two_buffers(lms, monkeypatch):
    """Every segmented beam step reorders into the idle one of two buffers,
    which change only when a segment grows."""
    _, _, lm = lms
    calls = []

    def spy(cache, parent, out=None):
        assert out is not None and out.shape == cache.shape
        assert parent.dtype == torch.int64 and tuple(parent.shape) == tuple(cache.shape[:2])
        calls.append((cache.data_ptr(), out.data_ptr(), cache.shape[4]))
        return cg.beam_cache_gather(cache, parent, out=out)

    monkeypatch.setattr(causal_lm_module, "beam_cache_gather", spy)
    lm.generate(*RAGGED, max_length=16, sampler=BeamSampler(3), segment_len=5)
    assert len(calls) == 16 - 2  # one per decode step, from the shortest prompt on
    widths = [w for _, _, w in calls]
    assert sorted(set(widths)) == [5, 10, 14]  # ends at 7, 12, 16 from start 2
    for (src, dst, w), (src2, dst2, w2) in zip(calls, calls[1:]):
        if w == w2:
            assert (src2, dst2) == (dst, src)
    for width in set(widths):  # two buffers per segment, no cache-sized tensor per step
        assert len({ptr for src, dst, w in calls if w == width for ptr in (src, dst)}) == 2


# -- samplers ------------------------------------------------------------------


def test_torch_gemma_get_sampler_resolution():
    assert isinstance(get_sampler(None), GreedySampler)
    assert isinstance(get_sampler("greedy"), GreedySampler)
    assert get_sampler("top_p", p=0.5) == TopPSampler(p=0.5)
    assert get_sampler("beam", num_beams=3) == BeamSampler(3)
    assert get_sampler("contrastive", k=3, alpha=0.5) == ContrastiveSampler(3, 0.5)
    s = TopKSampler(k=7)
    assert get_sampler(s) is s
    with pytest.raises(ValueError):
        get_sampler("nope")
    with pytest.raises(TypeError):
        get_sampler(3)
    assert sorted(S._NAMED) == sorted(jax_samplers._NAMED)
    for name, cls in S._NAMED.items():  # the same fields and defaults
        assert vars(cls()) == vars(jax_samplers._NAMED[name]())
    for structural in (BeamSampler(), ContrastiveSampler()):
        with pytest.raises(TypeError):
            structural.sample(torch.zeros(1, 4))


def _seen(sampler, logits, draws):
    gen = torch.Generator().manual_seed(0)
    return {int(sampler.sample(logits, gen)[0]) for _ in range(draws)}


def test_torch_gemma_samplers_support():
    logits = torch.log(torch.tensor([[0.6, 0.3, 0.08, 0.02]]))
    assert _seen(TopPSampler(p=0.7), logits, 200) == {0, 1}  # token 1 crosses 0.7
    logits = torch.log(torch.tensor([[0.4, 0.3, 0.2, 0.1]]))
    assert _seen(TopPSampler(p=1.0, k=2), logits, 100) == {0, 1}
    assert _seen(RandomSampler(), logits, 300) == {0, 1, 2, 3}
    logits = torch.tensor([[5.0, 4.0, 3.0, -10.0, -10.0, -10.0]])
    assert _seen(TopKSampler(k=3), logits, 100) == {0, 1, 2}
    assert _seen(TopKSampler(k=3, temperature=100.0), logits, 300) == {0, 1, 2}
    rnd = torch.tensor(np.random.RandomState(0).randn(4, 16).astype(np.float32))
    tok = TopPSampler(p=1e-6).sample(rnd, torch.Generator().manual_seed(0))
    assert torch.equal(tok, rnd.argmax(-1))


def test_torch_gemma_samplers_zero_temperature_is_greedy():
    logits = torch.tensor(np.random.RandomState(1).randn(3, 32).astype(np.float32))
    want = np.argmax(logits.numpy(), -1)
    for s, js in ((RandomSampler(temperature=0.0), jax_samplers.RandomSampler(temperature=0.0)),
                  (TopKSampler(5, 0.0), jax_samplers.TopKSampler(5, 0.0)),
                  (TopPSampler(0.9, None, 0.0), jax_samplers.TopPSampler(0.9, None, 0.0)),
                  (GreedySampler(), jax_samplers.GreedySampler())):
        np.testing.assert_array_equal(s.sample(logits, None).numpy(), want)
        np.testing.assert_array_equal(
            np.asarray(js.sample(jnp.asarray(logits.numpy()), jax.random.PRNGKey(0))), want)


def test_torch_gemma_top_k_breaks_ties_by_lowest_index():
    """As ``jax.lax.top_k``: among equal values the lower index first, which
    is what keeps beam search's dead beams (tied at -1e9) on JAX's tokens."""
    row = np.full((2, 12), -1e9, np.float32)
    row[0, 7] = 0.0
    row[1, [3, 9]] = 1.0
    vals, idx = S.top_k(torch.tensor(row), 4)
    jvals, jidx = jax.lax.top_k(jnp.asarray(row), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert idx.tolist() == [[7, 0, 1, 2], [3, 9, 0, 1]]


def test_torch_gemma_generate_shorthand_resolution(lms, monkeypatch):
    """The temperature / top_k / top_p shorthand and the named samplers
    resolve as in the JAX package."""
    _, _, lm = lms
    seen = []

    def spy(prompt_ids, prompt_lengths, *, sampler, **kw):
        seen.append(sampler)
        return torch.zeros((prompt_ids.shape[0], kw["max_length"]), dtype=torch.long)

    monkeypatch.setattr(lm, "_generate_impl", spy)
    cases = [
        (dict(), GreedySampler()),
        (dict(temperature=0.7), RandomSampler(temperature=0.7)),
        (dict(temperature=0.7, top_k=20), TopKSampler(k=20, temperature=0.7)),
        (dict(top_k=20), GreedySampler()),
        (dict(top_p=0.8, temperature=0.7), TopPSampler(p=0.8, k=None, temperature=0.7)),
        (dict(top_p=0.8, top_k=9), TopPSampler(p=0.8, k=9, temperature=1.0)),
        (dict(sampler="top_k", top_k=20, temperature=0.7), TopKSampler(k=20, temperature=0.7)),
        (dict(sampler="top_k"), TopKSampler()),
        (dict(sampler="top_p", top_p=0.8), TopPSampler(p=0.8)),
        (dict(sampler="top_p", top_k=4, temperature=0.5), TopPSampler(0.9, 4, 0.5)),
        (dict(sampler="random", temperature=2.0), RandomSampler(temperature=2.0)),
        (dict(sampler="greedy", temperature=2.0), GreedySampler()),
        (dict(sampler=TopKSampler(k=3), top_k=20), TopKSampler(k=3)),
    ]
    for kw, want in cases:
        lm.generate(*EVEN, max_length=5, **kw)
        assert seen[-1] == want, kw


def test_torch_gemma_generate_random_samplers_run(lms):
    """Random programs: valid ids, the prompt preserved, repeatable from a
    seeded generator; top-p at a vanishing temperature is greedy."""
    _, _, lm = lms
    greedy = lm.generate(*EVEN, max_length=9)
    for kw in (dict(temperature=0.8), dict(top_k=5, temperature=0.8), dict(top_p=0.9),
               dict(sampler="top_k", top_k=3, temperature=1.5)):
        a = lm.generate(*EVEN, max_length=9, generator=torch.Generator().manual_seed(3), **kw)
        b = lm.generate(*EVEN, max_length=9, generator=torch.Generator().manual_seed(3), **kw)
        assert torch.equal(a, b)
        assert torch.equal(a[:, :3], torch.tensor(EVEN[0]))
        assert int(a.min()) >= 0 and int(a.max()) < lm.config.vocab_size
    nucleus = lm.generate(*EVEN, max_length=9, sampler=TopPSampler(p=0.9, temperature=1e-4),
                          generator=torch.Generator().manual_seed(3))
    assert torch.equal(nucleus, greedy)
