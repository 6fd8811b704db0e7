"""The port's connected-components labeling (``iseg_tpu_torch/ops/ccl.py``)
against the JAX package's ``label_components``: the labels (a component's
smallest linear index plus 1, background 0, int32) equal exactly on the
cases of ``tests/test_ccl_h5.py`` (two components, diagonal 4- and
8-connectivity, batched and empty, the snake), on a serpentine (a fixpoint
hundreds of iterations away) and on seeded random blobs;
``relabel_sequential`` equal too."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.ops.ccl import label_components as j_label
from iseg_tpu.ops.ccl import relabel_sequential as j_relabel
from iseg_tpu_torch.ops.ccl import CHECK_EVERY, label_components, relabel_sequential

torch.set_num_threads(1)


def _snake(side):
    mask = np.zeros((side, side), bool)
    mask[0, :] = True
    mask[:, side - 1] = True
    mask[side - 1, :] = True
    return mask


def _serpentine(side, runs):
    """Horizontal runs joined at alternate ends: one long winding component."""
    mask = np.zeros((side, side), bool)
    rows = np.linspace(0, side - 1, runs).astype(int)
    for i, y in enumerate(rows):
        mask[y, :] = True
        if i + 1 < len(rows):
            mask[y:rows[i + 1] + 1, side - 1 if i % 2 == 0 else 0] = True
    return mask


def _blobs(n, side, seed):
    rng = np.random.RandomState(seed)
    return rng.rand(n, side, side) > 0.55


CASES = {
    "two_components": np.array([[1, 1, 0, 0], [1, 0, 0, 1], [0, 0, 1, 1], [0, 0, 1, 0]], bool),
    "diagonal": np.array([[1, 0], [0, 1]], bool),
    "batched_and_empty": np.zeros((2, 4, 4), bool),
    "snake": _snake(8),
    "serpentine": _serpentine(40, 5),
    "blobs": _blobs(3, 32, seed=0),
}
CASES["batched_and_empty"][0, 1:3, 1:3] = True


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_label_components_equal_jax(case, connectivity):
    mask = CASES[case]
    want = np.asarray(jax.jit(j_label, static_argnums=1)(jnp.asarray(mask), connectivity))
    got, iterations = label_components(torch.tensor(mask), connectivity, return_iterations=True)
    assert got.dtype == torch.int32 and got.shape == mask.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert iterations % CHECK_EVERY == 0
    np.testing.assert_array_equal(relabel_sequential(got.numpy()), j_relabel(want))


def test_torch_label_components_known_counts():
    lab4 = relabel_sequential(label_components(torch.tensor(CASES["diagonal"]), 4).numpy())
    lab8 = relabel_sequential(label_components(torch.tensor(CASES["diagonal"]), 8).numpy())
    assert lab4.max() == 2 and lab8.max() == 1
    batch = label_components(torch.tensor(CASES["batched_and_empty"])).numpy()
    assert batch[1].max() == 0 and len(np.unique(batch[0])) == 2
    assert relabel_sequential(label_components(torch.tensor(CASES["snake"])).numpy()).max() == 1
    with pytest.raises(ValueError, match="connectivity"):
        label_components(torch.tensor(CASES["diagonal"]), 6)
