"""The system under test: the PyTorch and CUDA port, driven through its
public API (``Scene.update``, ``Scene.render``, ``Scene.render_flight``).

The benchmark takes from the program only these entry points, the kernel
counters that say the kernel route ran, and the kernels' names in the
trace.  The port is imported here and nowhere else in the harness.
"""

from __future__ import annotations

import dataclasses

import torch


class Program:
    """A configuration's scene, made by the port's own function
    (``config["make_scene"]``) on ``device``, with ``config["overrides"]``
    applied to its one layer's variant."""

    def __init__(self, config: dict, device):
        import godot_atmosphere_shader_tpu_torch as port
        from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel, taa

        self._port = port
        self._counters = (megakernel.counters, taa.counters)
        self.device = torch.device(device)
        make = config["make_scene"]
        self.scene = getattr(port, make["function"])(**make["args"], device=self.device)
        if config["overrides"]:
            for atmo in self.scene.atmospheres:
                atmo.set_custom_shader(dataclasses.replace(atmo.config, **config["overrides"]))
        self.lens = config["scene"]["camera"]

    def camera(self, view_to_world):
        """A new camera on the device at this host pose, as an engine hands
        one over each frame."""
        c = self.lens
        return self._port.Camera.create(view_to_world, fov_y_deg=c["fov_y_deg"], near=c["near"],
                                        far=c["far"], device=self.device)

    def update(self, camera, time_s: float):
        self.scene.update(time_s, camera)

    def render(self, camera, height: int, width: int) -> dict:
        return self.scene.render(camera, height, width)

    def render_flight(self, camera, times, poses, height: int, width: int, taa: dict) -> dict:
        return self.scene.render_flight(camera, times, height, width, cam_transforms=poses,
                                        taa_blend=taa["blend"], taa_depth_eps=taa["depth_eps"],
                                        taa_clamp=taa["clamp"], taa_clamp_gamma=taa["clamp_gamma"])

    def reset_counters(self):
        for c in self._counters:
            c.reset()

    def route(self) -> dict:
        """Kernel launches and plain-path calls since :meth:`reset_counters`."""
        mk, taa = self._counters
        return {"k1_launches": mk.megakernel_launches, "k3_launches": taa.launches,
                "plain_calls": mk.plain_calls + taa.plain_calls}
