"""The port's on-device augment against ``iseg_tpu.data.device_augment``.

JAX's per-sample draws are re-derived from its key (the split of
``_augment_one``) and handed to the port's ``apply_augment``, so the two
compute the same augment: images within 1e-4 of 255 (the resample's
float32 coordinates take different but equivalent roads: JAX a weight
matrix, the port ``grid_sample`` on normalized coordinates), labels
exactly. On the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.data import device_augment as jda
from iseg_tpu_torch.data import device_augment as tda

torch.set_num_threads(1)

IMAGE_ATOL = 1e-4 * 255

CONFIGS = {
    "scale_0.5": dict(min_scale_factor=0.5, max_scale_factor=0.5),
    "scale_2.0": dict(min_scale_factor=2.0, max_scale_factor=2.0),
    "steps": dict(),
    "uniform": dict(scale_step_size=0.0),
    "crop_past_source": dict(crop_size=(40, 36), min_scale_factor=0.5, max_scale_factor=1.25),
    "brightness_erasing": dict(random_brightness=True, random_erasing=True, erase_prob=0.7),
    "no_flip": dict(flip_prob=0.0, mean_pixel=(123.675, 116.28, 103.53), ignore_label=0),
    "always_flip": dict(flip_prob=1.0, random_erasing=True, erase_prob=1.0),
}


def _inputs(n=6, h=29, w=34, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    labels = rng.randint(0, 21, (n, h, w)).astype(np.uint8)
    labels[:, :3, :5] = 255
    return images, labels


def _cfgs(name):
    kw = {"crop_size": (24, 28), **CONFIGS[name]}
    return jda.DeviceAugmentConfig(**kw), tda.DeviceAugmentConfig(**kw)


def _jax_params(rng, n, cfg, channels=3) -> tda.AugmentParams:
    """The draws of ``make_device_augment(cfg)(rng, ...)``, sample by sample."""
    ch, cw = cfg.crop_size
    fields = {k: [] for k in ("scale", "offset", "flip", "brightness", "erase", "erase_side",
                              "erase_origin", "erase_noise")}
    for key in jax.random.split(rng, n):
        k_scale, k_crop, k_flip, k_bri, k_er1, k_er2, k_er3 = jax.random.split(key, 7)
        fields["scale"].append(jda._sample_scale(k_scale, cfg))
        fields["offset"].append(jax.random.uniform(k_crop, (2,)))
        fields["flip"].append(jax.random.bernoulli(k_flip, cfg.flip_prob))
        fields["brightness"].append(jax.random.uniform(
            k_bri, (), minval=-cfg.brightness_max_delta, maxval=cfg.brightness_max_delta))
        fields["erase"].append(jax.random.bernoulli(k_er1, cfg.erase_prob))
        fields["erase_side"].append(jnp.sqrt(ch * cw * jax.random.uniform(
            k_er2, (), minval=cfg.erase_scale[0], maxval=cfg.erase_scale[1])))
        fields["erase_origin"].append(jnp.stack([
            jax.random.randint(k_er3, (), 0, max(ch - 1, 1)),
            jax.random.randint(jax.random.fold_in(k_er3, 1), (), 0, max(cw - 1, 1))]))
        fields["erase_noise"].append(jax.random.uniform(
            jax.random.fold_in(k_er3, 2), (ch, cw, channels), minval=0.0, maxval=255.0))
    t = {k: torch.tensor(np.stack([np.asarray(v) for v in vs])) for k, vs in fields.items()}
    t["erase_origin"] = t["erase_origin"].to(torch.int64)
    if not cfg.random_brightness:
        t["brightness"] = None
    if not cfg.random_erasing:
        for k in ("erase", "erase_side", "erase_origin", "erase_noise"):
            t[k] = None
    return tda.AugmentParams(**t)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_torch_apply_augment_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    images, labels = _inputs()
    rng = jax.random.PRNGKey(7)
    j_img, j_lab = jda.make_device_augment(jcfg)(rng, jnp.asarray(images), jnp.asarray(labels))
    params = _jax_params(rng, len(images), jcfg)
    t_img, t_lab = tda.apply_augment(torch.tensor(images), torch.tensor(labels), params, tcfg)
    assert t_img.dtype == torch.float32 and t_lab.dtype == torch.int32
    assert tuple(t_img.shape) == tuple(j_img.shape) and tuple(t_lab.shape) == tuple(j_lab.shape)
    np.testing.assert_array_equal(t_lab.numpy(), np.asarray(j_lab))
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), rtol=0, atol=IMAGE_ATOL)
    # the draws reach the border and the fill: some pixels come from outside the source
    if name in ("scale_0.5", "crop_past_source"):
        assert (t_lab == tcfg.ignore_label).float().mean() > 0.2


def test_torch_apply_augment_border_samples_match_jax():
    """Offsets 0 and 1 put the crop at the scaled image's edges, where the
    sample positions fall in the half pixel outside the outer centers."""
    jcfg, tcfg = _cfgs("steps")
    images, labels = _inputs(n=4)
    for scale in (0.5, 1.25, 2.0):
        for off in ((0.0, 0.0), (0.999999, 0.999999), (0.0, 0.999999)):
            params = tda.AugmentParams(scale=torch.full((4,), scale),
                                       offset=torch.tensor([off] * 4, dtype=torch.float32),
                                       flip=torch.tensor([False, True, False, True]))
            t_img, t_lab = tda.apply_augment(torch.tensor(images), torch.tensor(labels),
                                             params, tcfg)
            for i in range(4):
                key_img, key_lab = _jax_one(images[i], labels[i], scale, off,
                                            bool(params.flip[i]), jcfg)
                np.testing.assert_array_equal(t_lab[i].numpy(), key_lab)
                np.testing.assert_allclose(t_img[i].numpy(), key_img, rtol=0, atol=IMAGE_ATOL)


def _jax_one(image, label, scale, off, flip, cfg):
    """``_augment_one``'s geometry at a given scale, offset and flip."""
    h, w, c = image.shape
    ch, cw = cfg.crop_size
    scale = jnp.float32(scale)
    ty = -jnp.float32(off[0]) * jnp.maximum(h * scale - ch, 0.0)
    tx = -jnp.float32(off[1]) * jnp.maximum(w * scale - cw, 0.0)
    img = jax.image.scale_and_translate(
        jnp.asarray(image, jnp.float32), (ch, cw, c), (0, 1, 2), jnp.array([scale, scale, 1.0]),
        jnp.array([ty, tx, 0.0]), method="linear", antialias=False)
    dy = (jnp.arange(ch, dtype=jnp.float32) + 0.5 - ty) / scale - 0.5
    dx = (jnp.arange(cw, dtype=jnp.float32) + 0.5 - tx) / scale - 0.5
    yi = jnp.round(dy).astype(jnp.int32)
    xi = jnp.round(dx).astype(jnp.int32)
    valid = ((yi >= 0) & (yi < h))[:, None] & ((xi >= 0) & (xi < w))[None, :]
    lab = jnp.asarray(label)[jnp.clip(yi, 0, h - 1)][:, jnp.clip(xi, 0, w - 1)]
    lab = jnp.where(valid, lab, cfg.ignore_label)
    img = jnp.where(valid[:, :, None], img, jnp.asarray(cfg.mean_pixel, jnp.float32))
    if flip:
        img, lab = img[:, ::-1], lab[:, ::-1]
    return np.asarray(img), np.asarray(lab)


def test_torch_device_augment_is_deterministic_per_generator():
    _, cfg = _cfgs("brightness_erasing")
    images, labels = (torch.tensor(a) for a in _inputs())
    augment = tda.make_device_augment(cfg)
    a = augment(torch.Generator().manual_seed(3), images, labels)
    b = augment(torch.Generator().manual_seed(3), images, labels)
    c = augment(torch.Generator().manual_seed(4), images, labels)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (6, 24, 28, 3) and float(a[0].min()) >= 0 and float(a[0].max()) <= 255


def test_torch_sample_augment_params_ranges():
    _, cfg = _cfgs("brightness_erasing")
    p = tda.sample_augment_params(torch.Generator().manual_seed(0), 4096, cfg)
    steps = torch.linspace(0.5, 2.0, 7)
    assert set(p.scale.tolist()) == set(steps.tolist())
    assert float(p.offset.min()) >= 0 and float(p.offset.max()) < 1
    assert 0.45 < float(p.flip.float().mean()) < 0.55
    assert float(p.brightness.abs().max()) <= 32.0
    assert 0.65 < float(p.erase.float().mean()) < 0.75
    ch, cw = cfg.crop_size
    assert float(p.erase_side.min()) >= np.sqrt(0.02 * ch * cw) - 1e-4
    assert float(p.erase_side.max()) <= np.sqrt(0.2 * ch * cw) + 1e-4
    assert int(p.erase_origin[:, 0].max()) < ch - 1 and int(p.erase_origin[:, 1].max()) < cw - 1
    assert p.erase_noise.shape == (4096, ch, cw, 3)
    uniform = tda.sample_augment_params(torch.Generator().manual_seed(0), 512,
                                        dataclasses.replace(cfg, scale_step_size=0.0))
    assert float(uniform.scale.min()) >= 0.5 and float(uniform.scale.max()) < 2.0
    assert len(set(uniform.scale.tolist())) > 100
