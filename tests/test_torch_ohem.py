"""The port's OHEM selectors and the OHEM model loss against ``iseg_tpu``'s,
on the CPU.

Keep maps are 0/1 and compared exactly. The losses are distinct random
floats (no tie at the k-th value) except in the tie case, where the port's
stable descending sort must keep what ``jax.lax.top_k`` keeps (the lower
flat index among equal losses). The model loss (fp32 logits, bilinear
upsample + CE + OHEM) agrees to rtol 1e-6 and its logits gradient to 1e-6
of its largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.losses.ohem import get_ohem_fn as j_get_ohem_fn
from iseg_tpu_torch.core import model as tmodel
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.losses import get_ohem_fn

torch.set_num_threads(1)

N, H, W = 2, 12, 10  # 240 pixels


def _inputs(seed, ignore_share=0.2, all_ignored=False, tie_levels=None):
    rng = np.random.RandomState(seed)
    probs = rng.rand(N, H, W).astype(np.float32)
    losses = -np.log(np.maximum(probs, 1e-6)).astype(np.float32)
    if tie_levels is not None:  # few distinct values: many ties at every rank
        losses = (np.floor(losses * tie_levels) / tie_levels).astype(np.float32)
    mask = (rng.rand(N, H, W) >= ignore_share).astype(np.float32)
    if all_ignored:
        mask[:] = 0.0
    return losses, probs, mask


# (thresh, min_kept, input kwargs); 240 pixels, about 190 valid
CASES = {
    "hard_below_k_topk_fills": (0.1, 60, {}),
    "n_hard_at_least_k": (0.9, 20, {}),
    "fewer_valid_than_min_kept": (0.3, 500, dict(ignore_share=0.5)),
    "all_ignored": (0.7, 50, dict(all_ignored=True)),
    "loss_ties_at_kth": (0.05, 80, dict(tie_levels=4)),
    "thresh_none": (None, 30, {}),
    "thresh_none_min_kept_over_n": (None, 400, {}),
}


SELECTOR_CASES = [(case, ref_exact) for case in sorted(CASES) for ref_exact in (False, True)
                  if ref_exact or CASES[case][0] is not None]


@pytest.mark.parametrize("case,ref_exact", SELECTOR_CASES,
                         ids=[f"{c}-{'ref_exact' if r else 'default'}" for c, r in SELECTOR_CASES])
def test_torch_ohem_selector_matches_jax(case, ref_exact):
    thresh, min_kept, kw = CASES[case]
    for seed in range(3):
        losses, probs, mask = _inputs(seed, **kw)
        j = np.asarray(j_get_ohem_fn(thresh, min_kept, ref_exact)(
            jnp.asarray(losses), jnp.asarray(probs), jnp.asarray(mask)))
        t = get_ohem_fn(thresh, min_kept, ref_exact)(
            torch.tensor(losses), torch.tensor(probs), torch.tensor(mask))
        assert t.dtype == torch.float32 and tuple(t.shape) == (N, H, W)
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f"seed {seed}")
        if case == "all_ignored" and not ref_exact:
            assert t.sum() == 0


def test_torch_ohem_default_selector_needs_thresh():
    """Without a threshold the default selector raises, as JAX's does."""
    losses, probs, mask = _inputs(0)
    with pytest.raises(TypeError):
        j_get_ohem_fn(None, 10)(jnp.asarray(losses), jnp.asarray(probs), jnp.asarray(mask))
    with pytest.raises(TypeError):
        get_ohem_fn(None, 10)(torch.tensor(losses), torch.tensor(probs), torch.tensor(mask))


def test_torch_ohem_keep_map_carries_no_gradient():
    losses, probs, mask = _inputs(0)
    lt = torch.tensor(losses, requires_grad=True)
    for ref_exact in (False, True):
        kept = get_ohem_fn(0.5, 40, ref_exact)(lt, torch.tensor(probs), torch.tensor(mask))
        assert not kept.requires_grad


C = 5


def _logits_labels(seed=0, side=8, full=32):
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(N, side, side, C)).astype(np.float32)
    labels = rng.randint(0, C, (N, full, full))
    labels = np.where(rng.rand(N, full, full) < 0.1, 255, labels).astype(np.int32)
    return logits, labels


OHEM_MODELS = {
    "default": dict(use_ohem=True, ohem_thresh=0.3, ohem_min_kept=300),
    "default_n_hard_wins": dict(use_ohem=True, ohem_thresh=0.9, ohem_min_kept=50),
    "ref_exact": dict(use_ohem=True, ohem_thresh=0.3, ohem_min_kept=150, ohem_ref_exact=True),
    "ref_exact_thresh_none": dict(use_ohem=True, ohem_thresh=None, ohem_min_kept=150,
                                  ohem_ref_exact=True),
}


@pytest.mark.parametrize("fused", [False, True], ids=["full_res_logits", "fused_requested"])
@pytest.mark.parametrize("name", sorted(OHEM_MODELS))
def test_torch_ohem_model_loss_and_grad_match_jax(name, fused, monkeypatch):
    """``build_loss_fn`` with OHEM on the main output. With
    ``fuse_upsample_loss`` requested, OHEM gates the fused kernel off: the
    low-res logits are upsampled and go through CE + OHEM (the fused
    wrapper must not be called)."""
    kw = dict(OHEM_MODELS[name], fuse_upsample_loss=fused, upsample_logits=not fused)
    logits, labels = _logits_labels(side=8 if fused else 32)
    j_fn = JSegManaged(num_class=C, **kw).build_loss_fn()
    j_loss, j_grad = jax.value_and_grad(lambda lg: j_fn(lg, jnp.asarray(labels))[0])(
        jnp.asarray(logits))

    def refuse(*a, **k):
        raise AssertionError("OHEM must gate the fused loss off")

    monkeypatch.setattr(tmodel, "upsample_cross_entropy", refuse)
    t_logits = torch.tensor(logits, requires_grad=True)
    t_loss, parts = TSegManaged(num_class=C, **kw).build_loss_fn()(t_logits, torch.tensor(labels))
    t_loss.backward()
    assert set(parts) == {"output_0_loss", "loss"}
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-6)
    j_grad = np.asarray(j_grad)
    np.testing.assert_allclose(t_logits.grad.numpy(), j_grad, rtol=0,
                               atol=1e-6 * np.abs(j_grad).max())


def test_torch_ohem_applies_to_the_main_output_only():
    logits, labels = _logits_labels(side=32)
    other, _ = _logits_labels(seed=5, side=32)
    kw = dict(use_ohem=True, ohem_thresh=0.3, ohem_min_kept=100)
    t_fn = TSegManaged(num_class=C, **kw).build_loss_fn()
    plain = TSegManaged(num_class=C).build_loss_fn()
    outs = {"output_0": torch.tensor(logits), "output_1": torch.tensor(other)}
    _, parts = t_fn(outs, torch.tensor(labels))
    _, plain_parts = plain(outs, torch.tensor(labels))
    assert float(parts["output_1_loss"]) == float(plain_parts["output_1_loss"])
    assert float(parts["output_0_loss"]) != float(plain_parts["output_0_loss"])
    j_fn = JSegManaged(num_class=C, **kw).build_loss_fn()
    _, j_parts = j_fn({"output_0": jnp.asarray(logits), "output_1": jnp.asarray(other)},
                      jnp.asarray(labels))
    for k in ("output_0_loss", "output_1_loss"):
        np.testing.assert_allclose(float(parts[k]), float(j_parts[k]), rtol=1e-6)
