"""The port's FSDP placement rule against ``iseg_tpu.parallel.fsdp``:
``fsdp_spec`` picks the same dim (or none) for every shape, axis size and
``min_size``, and ``fsdp_shardings`` gives the same per-leaf specs for a
tree, with and without tensor-parallel ``base_specs`` (JAX's
``PartitionSpec`` compared as a tuple). Exact."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from iseg_tpu.parallel.fsdp import fsdp_shardings as j_fsdp_shardings
from iseg_tpu.parallel.fsdp import fsdp_spec as j_fsdp_spec
from iseg_tpu.parallel.mesh import create_mesh
from iseg_tpu_torch.parallel.fsdp import fsdp_shardings, fsdp_spec, sharded_dim

torch.set_num_threads(1)

SHAPES = [(128, 512, 64), (7, 9), (64,), (), (3, 3, 256, 512), (1, 1, 2048, 21),
          (96, 96), (4096, 3), (5, 4096), (17, 8, 8)]


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
@pytest.mark.parametrize("axis_size", [2, 4, 8])
@pytest.mark.parametrize("min_size", [1, 2 ** 14])
def test_torch_fsdp_spec_matches_jax(shape, axis_size, min_size):
    want = tuple(j_fsdp_spec(shape, axis_size, min_size=min_size))
    got = fsdp_spec(shape, axis_size, min_size=min_size)
    assert got == want
    if got:
        assert shape[sharded_dim(got)] % axis_size == 0


def _tree():
    rng = np.random.RandomState(0)
    return {"embed": rng.rand(256, 64).astype(np.float32),
            "block": {"q": rng.rand(64, 8, 16).astype(np.float32),
                      "bias": rng.rand(64).astype(np.float32),
                      "odd": rng.rand(7, 9).astype(np.float32)},
            "head": [rng.rand(64, 130).astype(np.float32), rng.rand(130).astype(np.float32)]}


@pytest.mark.parametrize("with_base", [False, True], ids=["fsdp", "fsdp_over_tp"])
def test_torch_fsdp_shardings_match_jax(with_base):
    tree = _tree()
    base = None
    if with_base:
        base = {"embed": P("model", None), "block": {"q": P(None, "model", None),
                                                     "bias": P(), "odd": P()},
                "head": [P(None, "model"), P()]}
    mesh = create_mesh(jax.devices()[:4], model_parallelism=2 if with_base else 1)
    want = j_fsdp_shardings(tree, mesh, min_size=64, base_specs=base)
    got = fsdp_shardings(tree, mesh.shape["data"], min_size=64,
                         base_specs=None if base is None else jax.tree_util.tree_map(
                             tuple, base, is_leaf=lambda x: isinstance(x, P)))
    flat_want = jax.tree_util.tree_leaves(want)
    flat_got = [got["block"]["bias"], got["block"]["odd"], got["block"]["q"], got["embed"],
                got["head"][0], got["head"][1]]
    # jax sorts dict keys: block/{bias, odd, q}, embed, head[0], head[1]
    assert [tuple(s.spec) for s in flat_want] == [tuple(g) for g in flat_got]
    assert any(a == "data" for g in flat_got for a in g)
