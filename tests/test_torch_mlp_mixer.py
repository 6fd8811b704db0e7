"""The port's MLP-Mixer (``iseg_tpu_torch/backbones/mlp_mixer.py``) against
``iseg_tpu.backbones.mlp_mixer``, with the same weights (carried by
``iseg_tpu_torch.convert``) and seeded numpy inputs, on the CPU.

A reduced Mixer (patch 8, width 32, depth 2, token MLP 24, channel MLP 64)
built for a 2 x 32 x 48 input (24 patches): its one endpoint in fp32 eval
to 1e-5 of max |ref|; in float64 train mode the endpoint, every
parameter's gradient (the token-mixing ``nn.Linear`` kernels over the
patch axis included) and the input's gradient to 1e-9. The JAX module
takes its token count from its first call, the port from ``input_size``:
another size raises a clear error, and the ``to_flax`` round trip keeps
the token-axis kernels' ``[tokens, hidden]`` layout. Also the full-width
``mlp_mixer_l16`` parameter shapes at 512 x 512 against ``jax.eval_shape``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones import mlp_mixer as jmix
from iseg_tpu.backbones.registry import get_backbone as j_get_backbone
from iseg_tpu_torch.backbones import get_backbone
from iseg_tpu_torch.backbones import mlp_mixer as tmix
from iseg_tpu_torch.convert import flatten, param_tree, to_flax
from torch_zoo_helpers import check_eval, check_train_f64, pair

torch.set_num_threads(1)

SMALL = dict(patch_size=8, dim=32, depth=2, tokens_mlp_dim=24, channels_mlp_dim=64)
HW = (32, 48)


def _setup():
    x = np.random.RandomState(0).randn(2, *HW, 3).astype(np.float32)
    jm, tm = jmix.MLPMixer(**SMALL), tmix.MLPMixer(**SMALL, input_size=HW)
    return jm, tm, pair(jm, tm, x), x


def test_torch_mlp_mixer_eval_matches_jax():
    jm, tm, variables, x = _setup()
    out = check_eval(jm, tm, variables, x)
    assert len(out) == 1 and tuple(out[0].shape) == (2, 32, 4, 6)
    assert tm.endpoint_strides == [8] and tm.endpoint_channels == [32]


def test_torch_mlp_mixer_train_grads_match_jax():
    jm, tm, variables, x = _setup()
    check_train_f64(jm, tm, variables, x)


def test_torch_mlp_mixer_pins_its_input_size_and_round_trips():
    _, tm, variables, _ = _setup()
    back = flatten(to_flax(tm)["params"])
    want = flatten(variables["params"])
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    assert back["block0/token_fc1/kernel"].shape == (24, 24)  # [tokens, hidden]
    assert back["block0/token_fc2/kernel"].shape == (24, 24)
    with pytest.raises(ValueError, match=r"built for 32x48 inputs.*got 48x48"):
        tm(torch.zeros(1, 3, 48, 48))
    with pytest.raises(ValueError, match="multiple of patch_size"):
        tmix.MLPMixer(**SMALL, input_size=(30, 48))
    assert get_backbone("mlp_mixer_b16").input_size == (224, 224)


def test_torch_mlp_mixer_l16_matches_jax_shapes():
    jm = j_get_backbone("mlp_mixer_l16")
    want = flatten(jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                                  jnp.zeros((1, 512, 512, 3)))["params"])
    with torch.device("meta"):
        tm = get_backbone("mlp_mixer_l16", input_size=512)
    got = {}
    for k, p in param_tree(tm).items():
        s = tuple(p.shape)
        got[k] = (s[2], s[3], s[1], s[0]) if len(s) == 4 else (s[1], s[0]) if len(s) == 2 else s
    assert got == {k: tuple(v.shape) for k, v in want.items()}
