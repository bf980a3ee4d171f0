"""The glow output stage: the port's ``apply_glow`` against JAX's.

Seeded HDR frames (a dim base, scattered pixels and a block above the
threshold, so the bright pass is not empty) go through the JAX stage and
the port's plain PyTorch stage, with ``GlowSettings.demo()`` and a
one-level setting, at 96×144, 135×241 (odd sizes: ``_down2`` truncates)
and 1080×1920 (the down chain 540 → 270 → 135 → 67 → 33 → 16, upsampled
back with half-pixel bilinear weights): atol 1e-5.  Also the helpers,
``Scene.apply_environment`` with and without an environment, and the
package export.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.render import glow as jglow
import godot_atmosphere_shader_tpu_torch as port
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.models.scene import Scene
from godot_atmosphere_shader_tpu_torch.render import glow as tglow

torch.set_num_threads(2)

ONE_LEVEL = dict(levels=(0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0), intensity=1.0, strength=1.0,
                 hdr_scale=1.0)


def _hdr_frame(h, w, seed):
    rng = np.random.default_rng(seed)
    img = (0.3 * rng.random((h, w, 3))).astype(np.float32)
    n = max(3, h * w // 2000)
    img[rng.integers(0, h, n), rng.integers(0, w, n)] = rng.uniform(1.0, 8.0, (n, 3))
    img[h // 3:h // 3 + h // 20 + 1, w // 2:w // 2 + w // 20 + 1] = 6.0
    return img


@pytest.mark.parametrize("settings", ["demo", "one_level"])
@pytest.mark.parametrize("h,w", [(96, 144), (135, 241), (1080, 1920)])
def test_glow_matches_jax(h, w, settings):
    img = _hdr_frame(h, w, h + w)
    if settings == "demo":
        jset, tset = jglow.GlowSettings.demo(), tglow.GlowSettings.demo()
    else:
        jset, tset = jglow.GlowSettings(**ONE_LEVEL), tglow.GlowSettings(**ONE_LEVEL)
    ref = np.asarray(jglow.apply_glow(jnp.asarray(img), jset))
    got = tglow.apply_glow(torch.from_numpy(img), tset).numpy()
    assert np.abs(ref - img).max() > 1e-2  # the bloom is not empty
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_settings_match_jax():
    for j, t in ((jglow.GlowSettings(), tglow.GlowSettings()),
                 (jglow.GlowSettings.demo(), tglow.GlowSettings.demo())):
        assert tuple(getattr(t, f) for f in t.__dataclass_fields__) == tuple(
            getattr(j, f) for f in j.__dataclass_fields__)


@pytest.mark.parametrize("shape", [(7, 9, 3), (32, 32, 3)])
def test_blur_and_down_match_jax(shape):
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    np.testing.assert_allclose(tglow._blur3(torch.from_numpy(x)).numpy(),
                               np.asarray(jglow._blur3(jnp.asarray(x))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tglow._down2(torch.from_numpy(x)).numpy(),
                               np.asarray(jglow._down2(jnp.asarray(x))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tglow._up2(torch.from_numpy(x), 2 * shape[0] + 1, 3 * shape[1]).numpy(),
                               np.asarray(jglow._up2(jnp.asarray(x), 2 * shape[0] + 1, 3 * shape[1])),
                               rtol=0, atol=1e-6)


def test_disabled_and_weightless_glow_are_identity():
    img = torch.from_numpy(_hdr_frame(32, 48, 2))
    assert torch.equal(tglow.apply_glow(img, tglow.GlowSettings(enabled=False)), img)
    assert torch.equal(tglow.apply_glow(img, tglow.GlowSettings(levels=(0.0,) * 7)), img)


def test_apply_environment():
    img = torch.from_numpy(_hdr_frame(64, 96, 3))
    assert Scene(device="cpu").apply_environment(img) is img  # no environment: a no-op
    scene = tdemo.build_demo_scene("no_clouds", device="cpu")
    assert scene.environment is None and scene.apply_environment(img) is img
    scene.environment = port.GlowSettings.demo()
    out = scene.apply_environment(img)
    np.testing.assert_array_equal(out.numpy(), tglow.apply_glow(img, tglow.GlowSettings.demo()).numpy())
    assert float((out - img).max()) > 0.02 and float((out - img).min()) >= -1e-6
    lit = Scene(environment=port.GlowSettings.demo(), device="cpu")
    assert torch.equal(lit.apply_environment(img), out)
    assert port.apply_glow is tglow.apply_glow
