"""Inverse rendering: fit atmosphere parameters to a target image.

Counterpart of ``godot_atmosphere_shader_tpu/models/inverse.py``.  The
frame's gradient with respect to the physical knobs is autograd through the
plain PyTorch frame, ``render/renderer.py::render_frame`` in its JAX form
(every layer fullscreen over the opaque pass: ``render_scene``), which is
the twin of the XLA frame (``render_frame_impl``) that the JAX fitter
differentiates.  The CUDA megakernel has no backward, as the Pallas one has
none: a fitted parameter set renders through it like any other.  This
module's fitter serves the CLI ``fit`` command; the row-sharded training
step is ``parallel/sharding.py::train_step_sharded``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..models.params import AtmosphereParams, VariantConfig
from ..ops.kernels import megakernel as mk
from ..utils.camera import Camera

#: parameters the fitter optimizes by default: the scalar knobs an artist
#: would tune by hand in the reference's inspector
DEFAULT_TRAINABLE = ("density", "scattering_strength", "atmosphere_modulate",
                     "atmosphere_ambient_color", "cloud_density_scale",
                     "cloud_coverage_bias", "cloud_shape_factor")


def leaves(train: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``train``'s tensors as fresh autograd leaves (detached copies that
    require a gradient)."""
    return {k: v.detach().clone().requires_grad_(True) for k, v in train.items()}


def gradients(loss: torch.Tensor, train: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """d loss / d ``train``.  A knob with no path to the loss (a cloud knob
    of a cloud-free variant) gets zeros, as ``jax.grad`` gives it."""
    grads = torch.autograd.grad(loss, list(train.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(train.items(), grads)}


def loss_and_gradients(train: Dict[str, torch.Tensor], params: AtmosphereParams,
                       config: VariantConfig, camera: Camera, opaque, target: torch.Tensor,
                       height: int, width: int):
    """``(loss, grads)`` of ``mean((render − target)²)`` with ``train``'s
    knobs, ``jax.value_and_grad`` of the JAX fitter's loss: the plain frame
    in the JAX form (every layer fullscreen over the opaque pass, counted
    in ``counters.plain_calls``), differentiated by autograd."""
    train = leaves(train)
    p = dataclasses.replace(params, **train)
    color = mk.render_scene_plain((p,), (config,), camera, opaque, height, width)["color"]
    loss = torch.mean((color - target) ** 2)
    return loss.detach(), gradients(loss, train)


def fit_step(train: Dict[str, torch.Tensor], params: AtmosphereParams, config: VariantConfig,
             camera: Camera, opaque, target: torch.Tensor, height: int, width: int,
             lr: float = 0.05) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One normalised gradient step on ``mean((render − target)²)``.
    Returns ``(loss, train)``, both detached, on the device of ``camera``."""
    loss, grads = loss_and_gradients(train, params, config, camera, opaque, target, height,
                                     width)

    # normalized (sign-like) steps: the physical knobs span wildly different
    # scales, so raw-gradient SGD crawls; a per-parameter unit step of size
    # ``lr`` converges in tens of iterations for artist-tuned scalars
    with torch.no_grad():
        new_train = {}
        for k, v in train.items():
            g = grads[k]
            norm = torch.sqrt(torch.mean(g * g)) + 1e-12
            new_train[k] = torch.clamp(v - lr * g / norm, min=0.0)
    return loss, new_train


def fit(params: AtmosphereParams, config: VariantConfig, camera: Camera, opaque,
        target: torch.Tensor, height: int, width: int, steps: int = 50, lr: float = 0.05,
        trainable=DEFAULT_TRAINABLE):
    """Gradient-descent fit.  Returns ``(fitted_params, losses)``: the losses
    stay on the device until the last step, then come back as floats."""
    params = params.resolve_frame_state()
    train = {k: getattr(params, k) for k in trainable}
    losses = []
    for _ in range(steps):
        loss, train = fit_step(train, params, config, camera, opaque, target, height, width,
                               lr=lr)
        losses.append(loss)
    losses = torch.stack(losses).tolist() if losses else []
    return dataclasses.replace(params, **train), losses
