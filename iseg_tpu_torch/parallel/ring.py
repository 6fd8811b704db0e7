"""Ring attention: blockwise context-parallel attention over a mesh axis
(counterpart of ``iseg_tpu/parallel/ring.py``).

Each rank holds its slice of the sequence. Instead of gathering the whole
K/V onto every rank (the ``"allgather"`` path of the Gemma model), K/V blocks
rotate around the axis while each rank accumulates flash-style
online-softmax statistics for its own queries (Ring Attention, Liu et al.,
2023): no ``[T_local, T]`` score matrix and O(T / n) resident context.

The structure is the JAX function's, tick for tick:

* the *unrepeated* GQA blocks ``[B, T/n, KVH, D]`` rotate (K and V together,
  one message a tick), broadcast to the query heads inside the block;
* n - 1 rotations: the last block is consumed after the loop, so no tick
  sends a block nobody reads;
* the statistics (running max, sum, accumulator) are fp32; the causal mask
  comes from global positions, and a position of -1 marks padding;
* the per-block body is recomputed in the backward
  (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``);
* the rotation is :func:`~iseg_tpu_torch.parallel.collectives.ppermute`,
  whose backward is the inverse rotation, so autograd builds the backward
  ring that ``jax.grad`` builds through the ``lax.scan``.

The K/V blocks' positions are all-gathered once a call (they carry no
gradient) and indexed by the block each tick holds, instead of rotating
beside the blocks: the same positions, one collective instead of n - 1.

The block products are plain ``torch`` matmuls, as the JAX ring is plain
``jnp`` (no Pallas kernel).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from iseg_tpu_torch.parallel import collectives as C
from iseg_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

__all__ = ["ring_attention", "ring_attention_local"]

_NEG = -1e30


def _block(qf, kv, kvp, q_pos, m, l, acc, causal: bool):
    """One K/V block into the running statistics. qf ``[B, Tl, H, D]`` fp32;
    kv ``[2, B, Ts, KVH, D]``; kvp ``[B, Ts]``; m, l ``[B, H, Tl]``; acc
    ``[B, H, Tl, D]``."""
    b, tl, h, d = qf.shape
    kf, vf = kv[0].float(), kv[1].float()
    kvh, ts = kf.shape[2], kf.shape[1]
    rep = h // kvh
    # grouped-query scores against the unrepeated block: query head j is KV
    # head j // rep, the grouping a repeat would give
    qg = qf.reshape(b, tl, kvh, rep, d)
    s = torch.einsum("btkrd,bskd->bkrts", qg, kf).reshape(b, h, tl, ts)
    allowed = (kvp >= 0)[:, None, None, :]  # -1 marks padding
    if causal:
        allowed = allowed & (kvp[:, None, None, :] <= q_pos[:, None, :, None])
    else:
        allowed = allowed.expand(b, 1, tl, ts)
    s = torch.where(allowed, s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a fully masked block must add nothing (exp(s - m_new) would be 1 there)
    p = torch.where(allowed, torch.exp(s - m_new[..., None]), 0.0)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    pg = p.reshape(b, kvh, rep, tl, ts)
    acc = acc * alpha[..., None] + torch.einsum("bkrts,bskd->bkrtd", pg, vf).reshape(b, h, tl, d)
    return m_new, l, acc


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor, group, causal: bool = True,
                         kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ring attention on this rank's shards: q ``[B, Tl, H, D]`` (pre-scaled),
    k/v ``[B, Tl, KVH, D]`` with KVH dividing H, positions ``[B, Tl]`` the
    global positions of the local queries (``kv_positions`` of the local
    keys; the same by default). Returns ``[B, Tl, H, D]`` in ``q.dtype``.
    ``group`` is the sequence axis's group (None: one rank, the same sums)."""
    b, tl, h, d = q.shape
    kvh = k.shape[2]
    if kvh == 0 or h % kvh != 0:
        raise ValueError(f"query heads {h} must be a multiple of kv heads {kvh}")
    if kv_positions is None:
        kv_positions = positions
    group = C.explicit_group(group)
    n = 1 if group is None else dist.get_world_size(group)
    r = 0 if group is None else dist.get_rank(group)
    # the blocks' positions, in rank order: tick t holds rank (r - t)'s block
    kvp_all = C.all_gather(kv_positions.contiguous()[None], group).view(n, b, -1) \
        if n > 1 else kv_positions[None]

    qf = q.float()
    m = torch.full((b, h, tl), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, tl, d), dtype=torch.float32, device=q.device)
    kv = torch.stack((k, v))
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))

    def step(kv_c, t, m, l, acc):
        kvp_c = kvp_all[(r - t) % n]
        if needs_grad:  # recompute s / p in the backward
            return checkpoint(_block, qf, kv_c, kvp_c, positions, m, l, acc, causal,
                              use_reentrant=False)
        return _block(qf, kv_c, kvp_c, positions, m, l, acc, causal)

    for t in range(n - 1):
        m, l, acc = step(kv, t, m, l, acc)
        kv = C.ppermute(kv, group, shift=1)
    m, l, acc = step(kv, n - 1, m, l, acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # [B, H, Tl, D]
    return out.transpose(1, 2).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                   axis: str, batch_axis: Optional[str] = None, causal: bool = True,
                   kv_positions: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Context-parallel attention of GLOBAL arrays, every rank holding all
    of them, as the JAX function takes them: q ``[B, T, H, D]``, k/v ``[B,
    T, KVH, D]``, positions ``[B, T]``; T is split over ``axis`` of
    ``mesh`` and B over ``batch_axis``. Each rank runs
    :func:`ring_attention_local` on its block, and the blocks are gathered
    back: the global output on every rank. The inputs' gradients are whole
    on every rank (each rank's share, summed: ``copy_to``). Raises as the
    JAX function does."""
    if mesh is None:
        raise ValueError("ring_attention needs a mesh: pass mesh=")
    n = axis_size(mesh, axis)
    b, t, h, _ = q.shape
    if t % n != 0:
        raise ValueError(f"sequence length {t} is not divisible by the {axis}-axis size {n}; "
                         "pad the sequence to a multiple of the ring size")
    if k.shape[2] == 0 or h % k.shape[2] != 0:
        raise ValueError(f"query heads {h} must be a multiple of kv heads {k.shape[2]}")
    nb = axis_size(mesh, batch_axis) if batch_axis is not None else 1
    if b % nb != 0:
        raise ValueError(f"batch {b} is not divisible by the {batch_axis}-axis size {nb}")
    if kv_positions is None:
        kv_positions = positions
    tl, bl = t // n, b // nb
    r, rb = axis_rank(mesh, axis), (axis_rank(mesh, batch_axis) if nb > 1 else 0)

    seq_group = axis_group(mesh, axis) if n > 1 else None
    batch_group = axis_group(mesh, batch_axis) if nb > 1 else None

    def local(x):
        x = C.copy_to(C.copy_to(x, seq_group), batch_group)
        return x[rb * bl:(rb + 1) * bl, r * tl:(r + 1) * tl]

    out = ring_attention_local(local(q), local(k), local(v), local(positions), seq_group,
                               causal=causal, kv_positions=local(kv_positions))
    out = C.gather_from(out, seq_group, dim=1)
    return C.gather_from(out, batch_group, dim=0)
