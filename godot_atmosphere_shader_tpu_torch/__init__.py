"""PyTorch/CUDA port of the JAX renderer ``godot_atmosphere_shader_tpu``.

Same layout and module names as the JAX package, which stays the reference
each module is tested against.  This package imports ``torch`` and numpy,
never JAX.  The frame's hot path is one CUDA megakernel written for Hopper
(``csrc/megakernel.cu``, ``ops/kernels/megakernel.py``); CPU tensors take
its plain PyTorch version.  The output stage, the environment's glow
(:class:`GlowSettings`, ``Scene(environment=...)``), is plain PyTorch.
"""

from .render.glow import GlowSettings, apply_glow

__all__ = ["GlowSettings", "apply_glow"]
