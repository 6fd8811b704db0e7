"""The port's optimizers, schedules, LR multipliers, multi-optimizer and
gradient accumulation against ``iseg_tpu.core.optimizer`` (optax).

Each case runs 5 updates of the same float64 gradients through both
(``jax.enable_x64``), applying every update to its params, and holds the
port's params to the JAX package's at rtol 1e-9 after every step (both
compute in float64; ``keras_adamw`` rounds its LR and bias factor to fp32
on both sides). Schedules: rtol 1e-12 of float64 values. The cases run on
cosine or constant schedules, which optax computes in float64 under x64;
the JAX package's poly schedule rounds the step to fp32 (held at rtol 1e-5
in ``tests/test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iseg_tpu.core import optimizer as jopt
from iseg_tpu_torch.convert import flatten, unflatten
from iseg_tpu_torch.core import optimizer as topt

torch.set_num_threads(1)

RTOL = 1e-9
STEPS = 5

PATHS = {
    "backbone/stem0/conv/kernel": (3, 3, 4, 8),
    "backbone/stem0/norm/scale": (8,),
    "backbone/stem0/norm/bias": (8,),
    "backbone/stage2_module0/branch0_block0/conv1/conv/kernel": (3, 3, 8, 8),
    "head/dw_conv1/kernel": (3, 3, 1, 8),
    "head/dw_conv1/bias": (8,),
    "logits_conv/kernel": (1, 1, 8, 5),
    "logits_conv/bias": (5,),
    "logits_conv_1/kernel": (1, 1, 8, 5),
}


def _grads(rng, nan=False):
    g = {k: rng.randn(*s) for k, s in PATHS.items()}
    if nan:
        g["backbone/stem0/conv/kernel"][0, 0, 0, :2] = [np.nan, np.inf]
    return g


def _run(j_make, t_make, nan=False, steps=STEPS):
    """Apply ``steps`` updates of the same gradients on both sides; compare
    the params after each. ``*_make(params) -> tx``."""
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s) for k, s in PATHS.items()}
    grads = [_grads(rng, nan) for _ in range(steps)]
    with jax.enable_x64(True):
        j_tree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), unflatten(params))
        j_tx = j_make(j_tree)
        j_state = j_tx.init(j_tree)
        j_hist = []
        for g in grads:
            g_tree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), unflatten(g))
            upd, j_state = j_tx.update(g_tree, j_state, j_tree)
            j_tree = optax.apply_updates(j_tree, upd)
            j_hist.append(flatten(jax.tree_util.tree_map(np.asarray, j_tree)))
    t_params = {k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()}
    t_tx = t_make(t_params)
    t_state = t_tx.init(t_params)
    for step, (g, j_flat) in enumerate(zip(grads, j_hist)):
        upd, t_state = t_tx.update({k: torch.tensor(v) for k, v in g.items()}, t_state,
                                   t_params)
        assert list(upd) == list(PATHS)
        t_params = {k: t_params[k] + upd[k] for k in t_params}
        for k in PATHS:
            np.testing.assert_allclose(t_params[k].numpy(), j_flat[k], rtol=RTOL, atol=1e-14,
                                       err_msg=f"{k} at step {step}")
    return t_state


# ------------------------------------------------------------------ schedules

SCHEDULES = {
    "cosine": dict(decay_strategy="cosine", learning_rate=0.1, train_steps=8),
    "cosine_floor": dict(decay_strategy="cosine", learning_rate=0.1, train_steps=8,
                         end_learning_rate=0.01),
    "warmup_cosine": dict(decay_strategy="cosine", learning_rate=0.1, train_steps=10,
                          warmup_steps=3),
    "warmup_cosine_floor": dict(decay_strategy="cosine", learning_rate=0.1, train_steps=10,
                                warmup_steps=3, end_learning_rate=0.02),
    "constant": dict(decay_strategy="constant", learning_rate=0.1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_torch_schedule_matches_optax(name):
    """Cosine: the warmup starts at 0, ``decay_steps`` includes it, the floor
    is ``end_lr`` (``alpha = end_lr / lr``)."""
    _, t = topt.get_optimizer({}, "sgd", **SCHEDULES[name])
    with jax.enable_x64(True):
        _, j = jopt.get_optimizer({}, "sgd", **SCHEDULES[name])
        want = [float(j(jnp.asarray(s, jnp.int32))) for s in range(14)]
    np.testing.assert_allclose([t(s) for s in range(14)], want, rtol=1e-12, atol=1e-15)
    if name.startswith("warmup"):  # fp32 values there, as optax's
        assert t(0) == 0.0 and t(3) == float(np.float32(0.1))
    if name.endswith("floor"):
        assert abs(t(100) - SCHEDULES[name]["end_learning_rate"]) < 1e-9


def test_torch_cosine_needs_decay_steps_beyond_the_warmup():
    with pytest.raises(ValueError):
        topt.warmup_cosine_decay(0.1, 3, warmup_steps=3)


# ------------------------------------------------------------------ optimizers

MULTS = {"head/": 10.0, "logits_conv_1": 0.5}
OPTIMIZERS = {
    "sgd_multipliers": dict(name="sgd", weight_decay=1e-2, lr_multipliers=MULTS),
    "sgd_keras_momentum_multipliers": dict(name="sgd", keras_momentum=True,
                                           lr_multipliers=MULTS),
    "adam": dict(name="adam"),
    "adam_decay": dict(name="adam", weight_decay=1e-2),
    "amsgrad": dict(name="amsgrad", adam_beta2=0.9),
    "adamw": dict(name="adamw", weight_decay=1e-2),
    "adamw_cosine_multipliers_clip_nan": dict(
        name="adamw", weight_decay=1e-2, decay_strategy="cosine", warmup_steps=2,
        lr_multipliers=MULTS, clip_norm=2.0),
    "adamw_extra_no_decay": dict(name="adamw", weight_decay=1e-1, extra_no_decay=("stem0",)),
    "keras_adam": dict(name="adam", keras_adam=True, adam_epsilon=1e-7),
    "keras_amsgrad": dict(name="amsgrad", keras_adam=True, adam_beta2=0.9),
    "keras_adamw_multipliers_cosine": dict(
        name="adamw", keras_adam=True, weight_decay=1e-2, lr_multipliers=MULTS,
        decay_strategy="cosine", warmup_steps=2, adam_epsilon=1e-7),
    "keras_adamw_clip_nan": dict(name="adamw", keras_adam=True, weight_decay=1e-2,
                                 clip_norm=2.0),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_torch_optimizer_matches_optax(case):
    kw = dict(learning_rate=0.05, train_steps=10, decay_strategy="cosine")
    kw.update(OPTIMIZERS[case])
    state = _run(lambda p: jopt.get_optimizer(p, **kw)[0],
                 lambda p: topt.get_optimizer(p, **kw)[0], nan="nan" in case)
    if "adam" in kw["name"]:
        assert state.count == STEPS
        assert (state.nu_hat is not None) == (kw["name"] == "amsgrad")


def test_torch_keras_adamw_alone_matches_jax():
    """``keras_adamw`` as one transform (no scrub or clip), with a
    multiplier tree and a decay mask given directly."""
    def make(mod, tree_fn):
        def build(params):
            return mod.keras_adamw(lambda c: 0.01 * 0.9 ** c, weight_decay=0.1,
                                   wd_mask=mod.weight_decay_mask(params),
                                   multiplier_tree=tree_fn(mod, params), amsgrad=True)
        return build

    def tree(mod, params):
        return mod.lr_multiplier_tree(params, {"conv1": 3.0})

    _run(make(jopt, tree), make(topt, tree))


def test_torch_scale_by_lr_multipliers_and_layerwise_decay_match_jax():
    def layer(path):
        return 0 if "stem0" in path else 2 if "stage2" in path else None

    def make(mod):
        def build(params):
            mults = mod.layerwise_decay_multipliers(params, 0.5, layer, num_layers=3)
            return mod.scale_by_lr_multipliers(mults)
        return build

    _run(make(jopt), make(topt))
    t = topt.layerwise_decay_multipliers(dict.fromkeys(PATHS), 0.5, layer, num_layers=3)
    assert t["backbone/stem0/norm/bias"] == 0.125 and t["logits_conv/bias"] == 1.0


# ------------------------------------------------------------------ multi-optimizer

def test_torch_optimizer_list_matches_optax():
    """Two groups by regex (the backbone on SGD, the rest on AdamW), each
    with lr multipliers matched by path inside its group and its own
    clip: each group's transform sees only its own leaves."""
    kw = dict(group_patterns=["^backbone/", "^head/"], names=["sgd", "adamw"],
              learning_rates=[0.05, 0.01], default_group=1, weight_decay=1e-2,
              lr_multipliers=MULTS, clip_norm=1.0, train_steps=10, decay_strategy="cosine")
    state = _run(lambda p: jopt.get_optimizer_list(p, **kw),
                 lambda p: topt.get_optimizer_list(p, **kw))
    assert sorted(state.inner_states) == ["0", "1"]
    assert state.inner_states["1"].count == STEPS


def test_torch_multi_optimizer_labels_and_refusal():
    def label(path):
        return "slow" if "backbone" in path else "fast"

    def make(mod):
        def build(params):
            return mod.get_multi_optimizer(params, label, {
                "slow": mod.get_optimizer(params, "sgd", learning_rate=0.01,
                                          decay_strategy=None)[0],
                "fast": mod.get_optimizer(params, "adam", learning_rate=0.01,
                                          decay_strategy=None)[0]})
        return build

    _run(make(jopt), make(topt))
    with pytest.raises(ValueError):
        topt.get_multi_optimizer(dict.fromkeys(PATHS), label, {"slow": None}).init({})


# ------------------------------------------------------------------ accumulation

@pytest.mark.parametrize("inner", ["sgd", "adamw_cosine"])
def test_torch_with_grad_accum_matches_optax_multisteps(inner):
    """Every 3 micro-steps: zero updates in between, one update from the
    running mean of the micro-gradients, the inner schedule counting real
    updates (6 micro-steps = 2 updates)."""
    kw = (dict(name="sgd", weight_decay=1e-2, decay_strategy="cosine") if inner == "sgd" else
          dict(name="adamw", weight_decay=1e-2, decay_strategy="cosine", warmup_steps=1))
    kw.update(learning_rate=0.05, train_steps=4)
    state = _run(lambda p: jopt.with_grad_accum(jopt.get_optimizer(p, **kw)[0], 3),
                 lambda p: topt.with_grad_accum(topt.get_optimizer(p, **kw)[0], 3), steps=6)
    assert (state.mini_step, state.gradient_step, state.inner_opt_state.count) == (0, 2, 2)
    assert all(float(a.abs().max()) == 0.0 for a in state.acc_grads)


def test_torch_with_grad_accum_validates_and_passes_through():
    base = topt.get_optimizer({}, "sgd")[0]
    assert topt.with_grad_accum(base, 1) is base
    with pytest.raises(ValueError):
        topt.with_grad_accum(base, 0)


def test_torch_param_paths_are_the_jax_multiplier_strings():
    """The regexes of ``lr_multiplier_tree``, the decay mask and the
    multi-optimizer's labels read the lower-cased ``/``-joined flax path:
    ``param_tree``'s keys give the same string for every leaf of an HRNet +
    JPU + aux model, and the decisions agree."""
    from iseg_tpu.backbones.hrnet import HRNet as JHRNet
    from iseg_tpu.core.model import SegManaged as JSegManaged
    from iseg_tpu.nn.heads.jpu import JPU as JJPU
    from iseg_tpu_torch.backbones.hrnet import HRNet as THRNet
    from iseg_tpu_torch.convert import param_tree
    from iseg_tpu_torch.core.model import SegManaged as TSegManaged
    from iseg_tpu_torch.nn.heads import JPU as TJPU

    small = dict(width=8, stage_modules=(1, 1, 1, 1))
    jm = JSegManaged(num_class=3, backbone=JHRNet(**small), head=JJPU(filters=8),
                     num_aux_loss=1, use_aux_head_endpoints=True)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    leaves = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    j_paths = sorted(jopt._path_str(p) for p, _ in leaves)
    tm = TSegManaged(num_class=3, backbone=THRNet(**small), head=TJPU([16, 32, 64], filters=8),
                     num_aux_loss=1, use_aux_head_endpoints=True)
    t_params = param_tree(tm)
    assert sorted(k.lower() for k in t_params) == j_paths
    rules = {r"stage4_module0/fuse/up\d": 0.1, "^head/dw_": 3.0, "logits_conv_1": 10.0,
             "transition": 0.5}
    j_mults = flatten(jopt.lr_multiplier_tree(shapes["params"], rules))
    assert topt.lr_multiplier_tree(t_params, rules) == j_mults
    assert topt.weight_decay_mask(t_params) == flatten(jopt.weight_decay_mask(shapes["params"]))
