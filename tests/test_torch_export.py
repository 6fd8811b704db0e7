"""The port's serving export (``iseg_tpu_torch/core/export.py``) against the
JAX package's ``iseg_tpu/core/export.py``, on the CPU.

The same weights (ResNet-9 os32 + SimpleDecoder(16, 8), 4 classes, drawn by
the JAX init and converted) go into both exporters at 32x32 (48x32 for the
sliding window), and each artifact serves the same seeded images. Tolerance:
fp32 within 1e-5 of max |logit| (the two frameworks sum in other orders);
labels equal wherever JAX's top-two logit gap exceeds 1e-4. The int8
artifact must also be below 0.75 of the float one, as the JAX test asks.
A small Swin artifact is loaded in a fresh process that imports no model
code: its graph calls the window-attention operator.
"""

import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones import get_backbone as jax_get_backbone
from iseg_tpu.core import export as jexport
from iseg_tpu.core.model import SegManaged as JaxSegManaged
from iseg_tpu.nn.heads import SimpleDecoder as JaxSimpleDecoder
from iseg_tpu_torch.backbones import get_backbone
from iseg_tpu_torch.backbones.swin import SwinTransformer
from iseg_tpu_torch.core import export as texport
from iseg_tpu_torch.core.model import SegManaged
from iseg_tpu_torch.nn.heads import SimpleDecoder
from iseg_tpu_torch.nn.initializers import initialize

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-5  # of max |logit|
LABEL_GAP = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = JaxSegManaged(num_class=4, backbone=jax_get_backbone("resnet9", output_stride=32),
                       head=JaxSimpleDecoder(filters=16, low_level_filters=8))
    variables = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))()
    variables = jax.tree_util.tree_map(np.asarray, variables)
    bb = get_backbone("resnet9", output_stride=32)
    tm = SegManaged(num_class=4, backbone=bb, head=SimpleDecoder(bb.endpoint_channels, 16, 8))
    return jm, tm, variables


def _images(seed, b, hw=32):
    return np.random.RandomState(seed).rand(b, hw, hw, 3).astype(np.float32)


def _both(models, hw=(32, 32), **kw):
    """(port artifact bytes, JAX artifact bytes) of the same weights."""
    jm, tm, variables = models
    return (texport.export_inference(tm, variables, hw, **kw),
            jexport.export_inference(jm, variables, hw, **kw))


def _close(got: torch.Tensor, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.fixture(scope="module")
def logits_artifacts(models):
    """(port artifact bytes, port serve, JAX serve) of the logits export."""
    tblob, jblob = _both(models)
    return tblob, texport.load_exported(tblob), jexport.load_exported(jblob)


@pytest.mark.parametrize("batch", [2, 1, 3])
def test_torch_export_logits_match_jax_at_any_batch(logits_artifacts, batch):
    """Traced at batch 2, served at batches 2, 1 and 3."""
    _, serve, jserve = logits_artifacts
    x = _images(batch, batch)
    _close(serve(torch.tensor(x)), jserve(x))


def test_torch_export_probs_match_jax(models):
    tblob, jblob = _both(models, output="probs")
    x = _images(3, 2)
    got = texport.load_exported(tblob)(x)  # numpy in, as the JAX serve takes it
    _close(got, jexport.load_exported(jblob)(x))
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_torch_export_labels_match_jax(models, logits_artifacts):
    tblob, jblob = _both(models, output="label")
    x = _images(4, 2)
    got = texport.load_exported(tblob)(x)
    want = np.asarray(jexport.load_exported(jblob)(x))
    assert got.dtype == torch.int32 and got.shape == (2, 32, 32)
    logits = np.sort(np.asarray(logits_artifacts[2](x)), axis=-1)
    clear = logits[..., -1] - logits[..., -2] > LABEL_GAP
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])


def test_torch_export_multi_scale_flip_matches_jax(models):
    tblob, jblob = _both(models, scale_rates=(0.5, 1.0), flip=True, batch_polymorphic=False)
    x = _images(5, 1)
    _close(texport.load_exported(tblob)(x), jexport.load_exported(jblob)(x))


def test_torch_export_sliding_window_matches_jax(models):
    """Two 32x32 windows over a 48x32 image."""
    tblob, jblob = _both(models, hw=(48, 32), sliding_window_crop_size=(32, 32),
                         batch_polymorphic=False)
    x = np.random.RandomState(6).rand(1, 48, 32, 3).astype(np.float32)
    _close(texport.load_exported(tblob)(x), jexport.load_exported(jblob)(x))


def test_torch_export_int8_weights_match_jax(models, logits_artifacts):
    tblob, jblob = _both(models, int8_weights=True)
    assert len(tblob) < 0.75 * len(logits_artifacts[0])
    x = _images(7, 2)
    _close(texport.load_exported(tblob)(x), jexport.load_exported(jblob)(x))


def test_torch_export_leaves_the_live_model_as_it_was(models, logits_artifacts):
    """Exporting fills the caches with real tensors: the live model runs
    after it and gives the artifact's logits."""
    _, tm, _ = models
    x = torch.tensor(_images(8, 2))
    with torch.no_grad():
        live = tm(x)
    assert torch.equal(logits_artifacts[1](x), live)
    with pytest.raises(ValueError, match="output"):
        texport.export_inference(tm, None, (32, 32), output="mask")


_CHILD = """
import json, sys
import numpy as np
from iseg_tpu_torch.core.export import load_exported
serve = load_exported(sys.argv[1])
out = serve(np.load(sys.argv[2]))
np.save(sys.argv[3], out.numpy())
print(json.dumps(sorted(m for m in sys.modules if m.startswith("iseg_tpu"))))
"""


def test_torch_export_loads_without_model_code(tmp_path):
    """A Swin artifact: its graph calls ``iseg::window_attention_fwd``, and
    a fresh process that imports only ``core.export`` (and through it the
    two operator modules) serves it with the live model's output."""
    bb = SwinTransformer(embed_dim=16, depths=(2, 2), num_heads=(2, 2), window_size=4)
    model = SegManaged(num_class=3, backbone=bb, head=None)
    initialize(model, torch.Generator().manual_seed(0))
    path = tmp_path / "swin.pt2"
    texport.export_inference(model.eval(), None, (32, 32), path=str(path))
    targets = {str(n.target) for m in torch.export.load(str(path)).graph_module.modules()
               if hasattr(m, "graph") for n in m.graph.nodes}
    assert "iseg.window_attention_fwd.default" in targets
    x = _images(9, 3)
    np.save(tmp_path / "x.npy", x)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(path), str(tmp_path / "x.npy"),
         str(tmp_path / "y.npy")], capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(texport.SERVING_OP_MODULES) <= set(loaded)
    assert not [m for m in loaded if m.startswith(("iseg_tpu_torch.backbones",
                                                  "iseg_tpu_torch.nn", "iseg_tpu_torch.convert",
                                                  "iseg_tpu_torch.core.model", "iseg_tpu."))]
    with torch.no_grad():
        want = model(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want)
