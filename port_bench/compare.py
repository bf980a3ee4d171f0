"""The comparison that decides ``correct``: each compared frame of the
program against the reference's frame of the same inputs.

The numbers, over every color and alpha value of a frame (H, W, 4), the
worst frame counting: ``p999`` the 99.9th percentile of |Δ| and ``mean``
the mean |Δ|.  A value that is not finite counts as an infinite |Δ|.  The
limits lie between the program's largest readings over a dozen seeds and
more and the control's smallest (PERF.md §2).
"""

from __future__ import annotations

import numpy as np
import torch

#: name → limit.  Readings at 1920×1080 on the H100 (PERF.md §2): the program's
#: largest p999 1.2e-4 and mean 2.5e-6, the control's smallest 1.93e-3 and 2.5e-4
LIMITS = {"p999": 5e-4, "mean": 3e-5}


def rgba(out: dict, i=None) -> torch.Tensor:
    """``color`` and ``alpha`` of a frame (or of frame ``i`` of a flight)
    stacked to (H, W, 4), float32."""
    color, alpha = out["color"], out["alpha"]
    if i is not None:
        color, alpha = color[i], alpha[i]
    return torch.cat([color, alpha[..., None]], dim=-1).float()


def deltas(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The compared numbers of one (H, W, 4) frame against its reference."""
    d = (got.double() - ref.double().to(got.device)).abs()
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
    flat = d.reshape(-1).cpu().numpy()
    return {"p999": float(np.percentile(flat, 99.9)), "mean": float(flat.mean())}


def worst(stats) -> dict:
    """The largest reading of each number over several frames."""
    stats = list(stats)
    return {k: max(s[k] for s in stats) for k in LIMITS}


def judge(reading: dict, limits=None) -> bool:
    limits = LIMITS if limits is None else limits
    return all(reading[k] <= limits[k] for k in limits)


def control(out: dict) -> dict:
    """The control in the program's place: the reference's frame with its
    color and alpha planes in bfloat16, the precision below the float32 the
    configuration states (a frame stored at half the bytes)."""
    return {k: v.to(torch.bfloat16).to(torch.float32) for k, v in out.items()}
