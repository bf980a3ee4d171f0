"""PyTorch/CUDA port of the JAX renderer ``godot_atmosphere_shader_tpu``.

Same layout and module names as the JAX package, which stays the reference
each module is tested against.  This package imports ``torch`` and numpy,
never JAX.  The frame's hot path is one CUDA megakernel written for Hopper
(``csrc/megakernel.cu``, ``ops/kernels/megakernel.py``); CPU tensors take
its plain PyTorch version.  The output stage, the environment's glow
(:class:`GlowSettings`, ``Scene(environment=...)``), is plain PyTorch, and
so is inverse rendering (:func:`fit`: autograd through the plain frame).
Everything runs on the card unless the caller asks for the CPU
(``device="cpu"``).

Quick start::

    from godot_atmosphere_shader_tpu_torch import (Scene, PlanetAtmosphere, Node3D,
                                                   Camera, look_at)

    sun = Node3D(position=(0, 0, 600))
    planet = PlanetAtmosphere(planet_radius=100.0, atmosphere_height=8.0,
                              sun=sun, custom_shader="no_clouds")
    planet.set_shader_parameter("u_density", 0.5)
    scene = Scene(atmospheres=[planet])
    cam = Camera.create(look_at((0, 150, 420), (0, 0, 0)))
    scene.update(time_s=0.0, camera=cam)
    frame = scene.render(cam, 1080, 1920)  # the CUDA megakernel on the card

Or migrate an existing Godot scene directly::

    from godot_atmosphere_shader_tpu_torch import load_tscn
    scene = load_tscn("demo/planet_atmosphere_test.tscn").scene
"""

from .models.demo import build_demo_scene, default_node_scene, demo_camera
from .models.inverse import fit
from .models.noise_cubemap import NoiseCubemap
from .models.params import VARIANTS, AtmosphereParams, ProceduralField, VariantConfig
from .models.scene import Node3D, PlanetAtmosphere, Scene
from .models.serialization import load_scene, save_scene
from .models.tscn import load_tscn
from .ops.noise import NoiseSpec
from .ops.optical_depth import bake_optical_depth
from .render.glow import GlowSettings, apply_glow
from .render.opaque import OpaqueScene
from .render.renderer import render_frame
from .utils.camera import Camera, look_at
from .utils.flight import FlyCamera, approach_path, orbit_path

__all__ = [
    "AtmosphereParams", "Camera", "FlyCamera", "GlowSettings", "NoiseCubemap", "NoiseSpec",
    "Node3D", "OpaqueScene", "PlanetAtmosphere", "ProceduralField", "Scene",
    "VariantConfig", "VARIANTS", "apply_glow", "approach_path", "bake_optical_depth",
    "build_demo_scene", "default_node_scene", "demo_camera", "fit", "load_scene", "load_tscn",
    "look_at", "orbit_path", "render_frame", "save_scene",
]

__version__ = "0.1.0"
