"""What each rank runs in the language-model distribution tests
(``torch_parallel_helpers.spawn``): tensor, sequence, pipeline and expert
parallelism.

Imports torch and the port only. Inputs are made from numpy seeds by the
``make_*`` functions, which the tests call too; weights come from the
parent (the JAX package's, in the flax layout). Each job returns numpy
arrays for the parent to compare.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PRESET = "gemma_test"  # 2 layers, hidden 64, 4 heads over 2 KV heads, vocab 512
PROMPT = (np.array([[5, 9, 3, 7], [11, 2, 0, 0]], np.int32), np.array([4, 2], np.int32))
GEN_LEN = 14
PP_LAYERS = 4  # gemma_test's widths at four layers: one a stage at 4 stages


def make_ids(b=4, t=16, seed=0):
    return np.random.RandomState(seed).randint(1, 512, (b, t)).astype(np.int64)


def make_weights(shape, seed=1):
    return (np.random.RandomState(seed).rand(*shape) > 0.2).astype(np.float32)


def make_qkv(kvh=4, seed=0):
    rng = np.random.RandomState(seed)
    b, t, h, d = 2, 32, 4, 8
    q = rng.randn(b, t, h, d).astype(np.float32) * 0.5
    k = rng.randn(b, t, kvh, d).astype(np.float32) * 0.5
    v = rng.randn(b, t, kvh, d).astype(np.float32)
    return q, k, v


def make_stage_params(n_stages, dim=16, seed=0):
    rng = np.random.RandomState(seed)
    return [{"w": (rng.randn(dim, dim) * 0.1).astype(np.float32),
             "b": (rng.randn(dim) * 0.1).astype(np.float32)} for _ in range(n_stages)]


def stage_fn(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


def stage_fn_const(p, x, c):
    return x + torch.tanh(x @ p["w"] + p["b"]) * c[:, None]


def _np(t):
    return t.detach().cpu().numpy().copy()


def _flax_grads(model) -> dict:
    """The model's parameter gradients keyed by flax path, in the flax
    layout."""
    from iseg_tpu_torch.convert import _leaves

    return {path: _np(to_flax(t.grad)) for col, path, t, to_flax, _ in _leaves(model)
            if col == "params" and isinstance(t, torch.nn.Parameter) and t.grad is not None}


def _tp_model(cfg, mesh, params):
    from iseg_tpu_torch.convert import load_flax
    from iseg_tpu_torch.nlp.gemma import GemmaCausalLM, shard_gemma_params

    lm = GemmaCausalLM(cfg, device="cpu", mesh=mesh, model_axis="model")
    return load_flax(lm, {"params": shard_gemma_params(params, mesh)})


# ------------------------------------------------------------------ TP

def job_tp(env, params):
    """World 2, model parallelism 2: logits, tokens, gradients, the layout's
    errors, the seeded shard, the collectives, and the example driver."""
    from iseg_tpu_torch.nlp.gemma import BeamSampler, GemmaCausalLM, get_preset
    from iseg_tpu_torch.nlp.gemma.layout import init_seeded_shard, shard_gemma_leaf
    from iseg_tpu_torch.ops.kernels import cache_gather as cg
    from iseg_tpu_torch.parallel import collectives as C
    from iseg_tpu_torch.parallel.mesh import MODEL_AXIS, axis_group, create_mesh

    cfg = get_preset(PRESET)
    mesh = create_mesh(model_parallelism=2)
    rank = env.rank
    res = {"rank": rank}
    lm = _tp_model(cfg, mesh, params)
    res["local_shapes"] = {"query": tuple(lm.backbone.layer_0.attention.query.weight.shape),
                           "embedding": tuple(lm.backbone.token_embedding.embedding.shape),
                           "cache": tuple(lm.build_cache(2, 8).shape)}
    ids = torch.tensor(make_ids())
    with torch.no_grad():
        res["logits"] = _np(lm(ids))
    cg.reset_launch_counts()
    prompt, lengths = PROMPT
    res["greedy"] = _np(lm.generate(prompt, lengths, max_length=GEN_LEN))
    res["beam"] = _np(lm.generate(prompt, lengths, max_length=GEN_LEN + 4,
                                  sampler=BeamSampler(4), segment_len=4))
    res["beam_mono"] = _np(lm.generate(prompt, lengths, max_length=GEN_LEN + 4,
                                       sampler=BeamSampler(4), cache_policy="monolithic"))
    res["top_k"] = _np(lm.generate(prompt, lengths, max_length=GEN_LEN, temperature=1.0,
                                   top_k=8, generator=torch.Generator().manual_seed(5)))
    res["gather_launches"] = dict(cg.LAUNCH_COUNTS)

    # the gradient of the mean next-token loss: each rank's shards
    weights = torch.tensor(make_weights(ids.shape))
    loss = lm.next_token_loss(ids, weights)
    loss.backward()
    res["loss"] = float(loss)
    res["grads"] = _flax_grads(lm)

    # gemma_2b_en's single KV head does not split over two ranks
    one_kv = dataclasses.replace(cfg, num_kv_heads=1)
    try:
        GemmaCausalLM(one_kv, device="cpu", mesh=mesh, model_axis=MODEL_AXIS)
        res["one_kv_error"] = None
    except ValueError as e:
        res["one_kv_error"] = str(e)
    try:
        shard_gemma_leaf("layer_0/attention/key/kernel", np.zeros((64, 1, 16)), mesh)
        res["leaf_error"] = None
    except ValueError as e:
        res["leaf_error"] = str(e)

    # an axis the (data, model) mesh does not have raises, as in JAX
    from iseg_tpu_torch.nn.moe import MoEFeedForward
    from iseg_tpu_torch.parallel.pipeline import pipeline_spmd
    from iseg_tpu_torch.parallel.ring import ring_attention

    q, k, v = (torch.tensor(a) for a in make_qkv())
    pos = torch.arange(32)[None].expand(2, 32)
    unknown = {}
    for name, call in (
            ("gemma_seq_axis", lambda: GemmaCausalLM(cfg, device="cpu", mesh=mesh,
                                                     seq_axis="seq")),
            ("moe_expert_axis", lambda: MoEFeedForward(8, 8, 16, expert_axis="expert",
                                                       mesh=mesh, device="cpu")),
            ("pipeline_stage_axis", lambda: pipeline_spmd(stage_fn, mesh, "stage", 2)),
            ("ring_seq_axis", lambda: ring_attention(q, k, v, pos, "seq", mesh=mesh)),
            ("layout_axis", lambda: shard_gemma_leaf("layer_0/attention/key/kernel",
                                                     np.zeros((64, 2, 16)), mesh, "seq")),
    ):
        try:
            call()
            unknown[name] = None
        except ValueError as e:
            unknown[name] = str(e)
    res["unknown_axis"] = unknown

    seeded = init_seeded_shard(GemmaCausalLM(cfg, device="cpu", mesh=mesh,
                                             model_axis=MODEL_AXIS), 3)
    with torch.no_grad():
        res["seeded_logits"] = _np(seeded(ids))

    # the differentiable collectives on rank-dependent values
    group = axis_group(mesh, MODEL_AXIS)
    x = torch.arange(6, dtype=torch.float64).reshape(2, 3).add(10 * rank).requires_grad_()
    w = torch.full((2, 3), float(rank + 1), dtype=torch.float64)
    coll = {}
    for name, fn in (("ppermute", lambda a: C.ppermute(a, group)),
                     ("ppermute_back", lambda a: C.ppermute(a, group, shift=-1)),
                     ("reduce_from", lambda a: C.reduce_from(a, group)),
                     ("copy_to", lambda a: C.copy_to(a, group)),
                     ("gather_slice", lambda a: C.gather_from(a, group, dim=1)),
                     ("gather_rs", lambda a: C.gather_from(a, group, dim=1,
                                                           grad="reduce_scatter"))):
        x.grad = None
        y = fn(x)
        wy = w.repeat(1, 2) if name.startswith("gather") else w
        (y * wy).sum().backward()
        coll[name] = (_np(y), _np(x.grad))
    res["collectives"] = coll
    res["staged"] = dict(C.HOST_STAGED)

    from iseg_tpu_torch.examples import gemma_generate

    res["example"] = gemma_generate.main(["--device", "cpu", "--model_parallelism", "2",
                                          "--max_length", "12"])
    return res


# ------------------------------------------------------------------ SP

def job_sp(env, params):
    """World 2, the sequence over ``model``: score, loss and gradients in
    both modes, the ring's checks, and generation."""
    from iseg_tpu_torch.convert import load_flax
    from iseg_tpu_torch.nlp.gemma import GemmaCausalLM, get_preset
    from iseg_tpu_torch.parallel import collectives as C
    from iseg_tpu_torch.parallel.mesh import create_mesh
    from iseg_tpu_torch.parallel.ring import ring_attention

    cfg = get_preset(PRESET)
    mesh = create_mesh(model_parallelism=2)
    res = {"rank": env.rank}
    ids = torch.tensor(make_ids())
    weights = torch.tensor(make_weights(ids.shape))
    for mode in ("allgather", "ring"):
        lm = load_flax(GemmaCausalLM(cfg, device="cpu", mesh=mesh, seq_axis="model",
                                     sp_mode=mode), {"params": params})
        C.reset_host_staged()
        with torch.no_grad():
            logits = lm(lm.shard_tokens(ids))
            score = lm.score(lm.shard_tokens(ids))
        calls = dict(C.CALLS)
        loss = lm.next_token_loss(lm.shard_tokens(ids), lm.shard_tokens(weights))
        loss.backward()
        lm.reduce_gradients()
        res[mode] = {"logits": _np(logits), "score": _np(score), "loss": float(loss),
                     "grads": _flax_grads(lm), "calls": calls}
        if mode == "ring":
            prompt, lengths = PROMPT
            res["generate"] = _np(lm.generate(prompt, lengths, max_length=GEN_LEN))

    # the ring alone: global arrays in, global arrays out
    ring = {}
    q, k, v = (torch.tensor(a) for a in make_qkv())
    pos = torch.arange(32)[None].expand(2, 32)
    for causal in (True, False):
        ring[f"causal={causal}"] = _np(ring_attention(q, k, v, pos, "model", causal=causal,
                                                      mesh=mesh))
    ring["batch_axis"] = _np(ring_attention(q, k, v, pos, "model", batch_axis="data",
                                            mesh=mesh))
    pad = pos.clone()
    pad[:, 16:] = -1
    ring["padding"] = _np(ring_attention(q, k, v, pos, "model", kv_positions=pad, mesh=mesh))
    qg, kg, vg = (torch.tensor(a) for a in make_qkv(kvh=2, seed=3))
    ring["gqa"] = _np(ring_attention(qg, kg, vg, pos, "model", mesh=mesh))
    qr, kr, vr = (a.clone().requires_grad_() for a in (q, k, v))
    (ring_attention(qr, kr, vr, pos, "model", mesh=mesh) ** 2).sum().backward()
    ring["grads"] = [_np(a.grad) for a in (qr, kr, vr)]
    errors = {}
    for name, call in (
            ("seq", lambda: ring_attention(q[:, :31], k[:, :31], v[:, :31], pos[:, :31],
                                           "model", mesh=mesh)),
            ("heads", lambda: ring_attention(q, k[:, :, :3], v[:, :, :3], pos, "model",
                                             mesh=mesh)),
            ("no_mesh", lambda: ring_attention(q, k, v, pos, "model")),
    ):
        try:
            call()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    ring["errors"] = errors
    res["ring_alone"] = ring
    return res


# ------------------------------------------------------------------ PP

def job_pp(env, params, staged, shared):
    """World 4: the schedule at 2 stages (on a (data 2, stage 2) mesh,
    without a batch axis) and 4 stages, with constants, and the Gemma PP
    loss at 2 and 4 stages and DP x PP."""
    from iseg_tpu_torch.nlp.gemma import get_preset
    from iseg_tpu_torch.nlp.gemma.pipeline import make_pp_loss_fn, stage_slice
    from iseg_tpu_torch.parallel import collectives as C
    from iseg_tpu_torch.parallel.mesh import axis_rank, create_mesh
    from iseg_tpu_torch.parallel.pipeline import pipeline_spmd

    names = ("data", "stage")
    meshes = {2: create_mesh(model_parallelism=2, axis_names=names),
              4: create_mesh(model_parallelism=4, axis_names=names)}
    res = {"rank": env.rank}
    rng = np.random.RandomState(0)
    x = rng.randn(24, 16).astype(np.float32)
    c = rng.rand(24).astype(np.float32)
    for n_stages, m in ((2, 6), (4, 4)):
        mesh = meshes[n_stages]
        s = axis_rank(mesh, "stage")
        p = {k: torch.tensor(v, requires_grad=True)
             for k, v in make_stage_params(n_stages)[s].items()}
        xt = torch.tensor(x, requires_grad=True)
        y = pipeline_spmd(stage_fn, mesh, "stage", m)(p, xt)
        (y ** 2).sum().backward()
        pc = {k: torch.tensor(v, requires_grad=True)
              for k, v in make_stage_params(n_stages)[s].items()}
        yc = pipeline_spmd(stage_fn_const, mesh, "stage", m)(pc, torch.tensor(x),
                                                             const=torch.tensor(c))
        (yc ** 2).sum().backward()
        res[f"schedule{n_stages}"] = {
            "stage": s, "y": _np(y), "dx": _np(xt.grad),
            "dp": {k: _np(v.grad) for k, v in p.items()},
            "y_const": _np(yc), "dp_const": {k: _np(v.grad) for k, v in pc.items()}}

    cfg = dataclasses.replace(get_preset(PRESET), num_layers=PP_LAYERS)
    ids = torch.tensor(make_ids(b=8))
    weights = torch.tensor(make_weights(ids.shape))
    for label, n_stages, batch_axis, m, remat in (
            ("gemma2", 2, None, 4, False), ("gemma4", 4, None, 4, False),
            ("dp_pp", 2, "data", 2, False), ("gemma2_remat", 2, None, 4, True)):
        mesh = meshes[n_stages]
        s = axis_rank(mesh, "stage")
        mine = {k: v for k, v in _torch_tree(stage_slice(staged[n_stages], s)).items()}
        sh = _torch_tree(shared)
        C.reset_host_staged()
        loss_fn = make_pp_loss_fn(cfg, mesh, num_microbatches=m, batch_axis=batch_axis,
                                  remat=remat)
        loss = loss_fn(mine, sh, ids, weights)
        calls = dict(C.CALLS)
        loss.backward()
        res[label] = {"stage": s, "loss": float(loss), "calls": calls,
                      "g_stage": _grad_tree(mine), "g_shared": _grad_tree(sh)}
    return res


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), requires_grad=True)


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    # the int8 scales are carried and not applied: no gradient reaches them
    return np.zeros(tree.shape, np.float32) if tree.grad is None else _np(tree.grad)


# ------------------------------------------------------------------ EP

MOE_DIM, MOE_EXPERTS, MOE_FF = 8, 8, 16


def make_moe_x(g=64, seed=4):
    return np.random.RandomState(seed).randn(g, MOE_DIM).astype(np.float32)


def job_ep(env, params, capacity_factor):
    """World 2, the experts over ``expert``: output, aux loss and gradients
    at k = 1 and 2."""
    from iseg_tpu_torch.convert import load_flax
    from iseg_tpu_torch.nn.moe import MoEFeedForward, shard_experts
    from iseg_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(model_parallelism=2, axis_names=("data", "expert"))
    res = {"rank": env.rank}
    for k in (1, 2):
        moe = MoEFeedForward(MOE_DIM, MOE_EXPERTS, MOE_FF, k=k, capacity_factor=capacity_factor,
                             expert_axis="expert", mesh=mesh, device="cpu")
        load_flax(moe, {"params": shard_experts(params, mesh, "expert")})
        x = torch.tensor(make_moe_x(), requires_grad=True)
        y, aux = moe(x)
        (((y - x) ** 2).mean() + 0.01 * aux).backward()
        res[k] = {"y": _np(y), "aux": float(aux), "dx": _np(x.grad),
                  "grads": {n: _np(p.grad) for n, p in moe.named_parameters()}}
    return res
