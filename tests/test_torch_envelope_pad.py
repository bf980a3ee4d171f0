"""K1's procedural envelope on the CPU: a frame whose height is not a
multiple of its LOD group (cloud_lod·cloud_coverage_lod = 16 rows, 40
rows).  The JAX megakernel pads its last 32-row tile with real rays past
the frame and crops (its XLA path refuses such a frame); the port's plain
renderer pads the last group the same way, and the kernel's grid rounds up.
The port's ``Scene.render`` against JAX ``render_frame_pallas`` in
interpret mode (~45 s of compile), at the cloud tolerance; the helpers and
tolerances are ``test_torch_envelope.py``'s.
"""

from godot_atmosphere_shader_tpu.ops.pallas.megakernel import render_frame_pallas
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from test_torch_envelope import W, _cloud_ok, _image, _scenes

H = 40


def test_partial_lod_group_matches_the_jax_kernel():
    jscene, jcam, scene, cam = _scenes("group_16")
    atmo = jscene.atmospheres[0]
    jcfg = atmo.effective_config()
    assert H % (jcfg.cloud_lod * jcfg.cloud_coverage_lod) == 8
    _, _, configs = scene._sorted_layers(cam)
    mk.check_config(configs[0])  # the card renders it too
    ref = _image(render_frame_pallas(atmo.build_params(), jcfg, jcam, jscene.opaque, H, W,
                                     interpret=True))
    got = _image({k: v.numpy() for k, v in scene.render(cam, H, W).items()})
    assert got.shape == (H, W, 4) and got[..., 3].max() > 0.05
    assert _cloud_ok(got, ref)
