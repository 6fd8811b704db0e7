"""The port's beam cache gather (``iseg_tpu_torch/ops/kernels/cache_gather.py``)
against the JAX package's: the plain PyTorch version, which the wrapper takes
for CPU tensors, is bitwise equal to ``_xla_gather`` and to the Pallas kernel
in interpret mode. The CUDA kernel itself is held against the plain version
on the card (``tests/test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.ops.pallas.cache_gather import _xla_gather
from iseg_tpu.ops.pallas.cache_gather import beam_cache_gather as jax_beam_cache_gather
from iseg_tpu_torch.ops.kernels import cache_gather as cg

torch.set_num_threads(1)

_TORCH = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_JAX = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}

SHAPES = [
    (2, 4, (3, 2, 64, 1, 128), "bfloat16"),  # beam active-cache shape
    (1, 2, (2, 2, 40, 2, 64), "float32"),  # odd widths
    (3, 3, (512,), "bfloat16"),  # minimal slab
    (2, 4, (2, 2, 512, 2, 128), "bfloat16"),  # a slab of several Pallas blocks
    (1, 2, (433, 8, 128), "bfloat16"),  # odd W: the Pallas kernel falls back
    (2, 3, (5, 7), "float32"),  # not a lane multiple: untileable on the TPU
]


def _inputs(b, nb, slab, dtype, seed=0):
    rng = np.random.RandomState(seed)
    cache32 = rng.randn(b, nb, *slab).astype(np.float32)
    parent = rng.randint(0, nb, (b, nb)).astype(np.int32)
    # round through the working type on the torch side so both see the same bits
    cache_t = torch.tensor(cache32).to(_TORCH[dtype])
    cache_j = jnp.asarray(cache_t.float().numpy(), _JAX[dtype])
    return cache_t, cache_j, parent


def _bits(x) -> np.ndarray:
    """The array's bytes, so that bf16 compares bitwise."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("b,nb,slab,dtype", SHAPES, ids=[str(s[2]) for s in SHAPES])
def test_torch_cache_gather_matches_xla_and_pallas(b, nb, slab, dtype):
    cache_t, cache_j, parent = _inputs(b, nb, slab, dtype)
    want_xla = _xla_gather(cache_j, jnp.asarray(parent))
    want_pallas = jax_beam_cache_gather(cache_j, jnp.asarray(parent), interpret=True)
    for index_dtype in (torch.int32, torch.int64):
        idx = torch.tensor(parent).to(index_dtype)
        for got in (cg.beam_cache_gather_reference(cache_t, idx),
                    cg.beam_cache_gather(cache_t, idx)):
            assert got.dtype == cache_t.dtype and got.shape == cache_t.shape
            np.testing.assert_array_equal(_bits(got), _bits(want_xla))
            np.testing.assert_array_equal(_bits(got), _bits(want_pallas))


def test_torch_cache_gather_repeated_steps():
    """Four reorders in a row with two buffers swapped, as the beam loop
    does, against four XLA gathers."""
    rng = np.random.RandomState(2)
    cache_t, cache_j, _ = _inputs(2, 2, (2, 2, 16, 1, 128), "bfloat16", seed=2)
    parents = rng.randint(0, 2, (4, 2, 2)).astype(np.int32)
    active, spare = cache_t.clone(), torch.empty_like(cache_t)
    want = cache_j
    for step in range(4):
        out = cg.beam_cache_gather(active, torch.tensor(parents[step]), out=spare)
        assert out is spare
        active, spare = spare, active
        want = _xla_gather(want, jnp.asarray(parents[step]))
    np.testing.assert_array_equal(_bits(active), _bits(want))


def test_torch_cache_gather_repeated_and_negative_parents():
    cache = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    parent = torch.tensor([[2, 2, 0], [-1, 1, 1]])
    got = cg.beam_cache_gather(cache, parent)
    want = torch.stack([cache[0, [2, 2, 0]], cache[1, [2, 1, 1]]])
    assert torch.equal(got, want)


def test_torch_cache_gather_rejects_wrong_inputs():
    cache = torch.zeros((2, 3, 4, 5))
    parent = torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="overlaps"):
        cg.beam_cache_gather(cache, parent, out=cache)
    with pytest.raises(ValueError, match="overlaps"):  # a view into the same storage
        cg.beam_cache_gather(cache, parent, out=cache.view(2, 3, 20).view(2, 3, 4, 5))
    with pytest.raises(ValueError, match="must match"):
        cg.beam_cache_gather(cache, parent, out=torch.zeros((2, 3, 4, 6)))
    with pytest.raises(ValueError, match="must match"):
        cg.beam_cache_gather(cache, parent, out=torch.zeros((2, 3, 4, 5), dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="int32 or int64"):
        cg.beam_cache_gather(cache, parent.float())
    with pytest.raises(ValueError, match=r"\[B, NB\]"):
        cg.beam_cache_gather(cache, parent[:, :2])
    with pytest.raises(ValueError, match="contiguous"):
        cg.beam_cache_gather(cache.transpose(2, 3), parent)
    with pytest.raises(ValueError, match="contiguous"):
        cg.beam_cache_gather(cache, parent, out=torch.zeros((2, 3, 5, 4)).transpose(2, 3))
    with pytest.raises(ValueError, match=r"\[B, NB, \*slab\]"):
        cg.beam_cache_gather(torch.zeros(3), torch.zeros(3, dtype=torch.int64))


def test_torch_cache_gather_copy_width():
    """The widest of 16, 8, 4, 2, 1 bytes that divides the slab and the
    base addresses."""
    base = torch.zeros(64, dtype=torch.uint8)
    assert base.data_ptr() % 16 == 0
    assert cg.copy_width(4096, base) == 16
    assert cg.copy_width(140, base) == 4  # 35 floats
    assert cg.copy_width(24, base) == 8
    assert cg.copy_width(6, base) == 2
    assert cg.copy_width(7, base) == 1
    assert cg.copy_width(4096, base, base[4:]) == 4  # a misaligned second tensor
    assert cg.copy_width(4096, base[1:]) == 1


def test_torch_cache_gather_cpu_counts_no_launch():
    cg.reset_launch_counts()
    cache = torch.zeros((1, 2, 8))
    cg.beam_cache_gather(cache, torch.zeros((1, 2), dtype=torch.int32))
    assert cg.LAUNCH_COUNTS == {"gather": 0}
