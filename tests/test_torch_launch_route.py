"""The launch route every kernel launcher takes (``ops/kernels/library.py::
launch``), K2 alone's plan (``megakernel.texsample_plan``) against its
definition and the kernel source, and the CPU side of the wrappers that
launch T1 and T3: on the CPU they take their plain versions and launch
nothing.  The kernels themselves are held against their plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 3b and 7).
"""

import os
import re

import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu_torch.ops.kernels import library, probes
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as ts


def _never(*args):
    raise AssertionError("the route called the launcher")


@pytest.mark.parametrize("tensor,dtype,message", [
    (torch.zeros((4, 8)), torch.float32, "CUDA"),
    (torch.zeros((8, 4)).t(), torch.float32, "contiguous"),
    (torch.zeros((4, 8), dtype=torch.float64), torch.float32, "contiguous"),
    (torch.zeros((4, 8)), torch.int32, "contiguous"),
])
def test_launch_route_refuses_what_no_kernel_takes(tensor, dtype, message):
    """A CPU tensor, a non-contiguous one or one of another type raises
    before the launcher is called."""
    with pytest.raises(ValueError, match=message):
        library.launch(_never, tensor, (1, 2), (3,), dtype=dtype)


def test_fill_refuses_a_cpu_plane_and_fills_on_the_cpu_with_no_launch():
    probes.counters.reset()
    with pytest.raises(ValueError, match="CUDA"):
        probes.launch_fill(0.25, torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="plane"):
        probes.launch_fill(0.25, torch.zeros(8))
    got = probes.fill(0.25, 3, 5, device="cpu")
    assert probes.counters.launches == 0
    assert torch.equal(got, torch.full((3, 5), 0.25))


def _define(name: str) -> int:
    path = os.path.join(library.CSRC, "megakernel.cu")
    with open(path) as f:
        return int(re.search(r"#define %s (\d+)" % name, f.read()).group(1))


def test_texsample_constants_match_the_kernel_source():
    assert (mk.TEXSAMPLE_THREADS, mk.TEXSAMPLE_KEEP, mk.TEXSAMPLE_BOX) == (
        _define("TS_THREADS"), _define("TS_KEEP"), _define("TS_BOX"))


@pytest.mark.parametrize("batches", [1, 1530])
@pytest.mark.parametrize("n", [1, 3, 4, 1023, 2048, 2052, 8192, 8193, 20000])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", [True, False])
def test_texsample_plan_matches_its_definition(batches, n, aligned, shape):
    """One block a batch; 16-byte loads and stores only on aligned planes
    with n % 4 == 0; the threads' samples cover the batch and no thread
    takes a step more than it needs; a batch read once where it fits the
    kept planes, twice beyond; two blocks' kept planes and texel boxes fit
    an SM's 228 KB, with the 1 KB a block reserves and 1 KB of static
    shared memory."""
    plan = mk.texsample_plan(batches, n, aligned, shape)
    vector = aligned and n % 4 == 0
    width = 4 if vector else 1
    assert plan["blocks"] == batches and plan["threads"] == mk.TEXSAMPLE_THREADS
    assert plan["vector"] == vector
    steps = plan["samples_per_thread"] // width
    assert plan["samples_per_thread"] % width == 0
    assert steps * width * plan["threads"] >= n > (steps - 1) * width * plan["threads"]
    assert plan["reads"] == (1 if n <= mk.TEXSAMPLE_KEEP else 2)
    floats = 3 if shape else 2
    assert plan["smem_bytes"] == 4 * ((floats * n if n <= mk.TEXSAMPLE_KEEP else 0)
                                      + mk.TEXSAMPLE_BOX)
    assert 2 * (plan["smem_bytes"] + 2048) <= 228 * 1024


@pytest.mark.parametrize("n", [1, 1023, 8193])
def test_sample_batches_on_the_cpu_is_the_plain_sampler_at_any_length(n):
    """Batch lengths that take each of the kernel's paths on the card go
    through the plain samplers on the CPU, batch by batch, with no
    launch."""
    rng = np.random.default_rng(n)
    data, meta = ts.build_tex3d_pyramid(rng.random((32, 32, 32)).astype(np.float32))
    table = torch.as_tensor(data)
    lo = rng.random((3, 2, 1)) * 0.8
    planes = [torch.as_tensor((lo[a] + 0.1 * rng.random((2, n))).astype(np.float32))
              for a in range(3)]
    mk.counters.reset()
    out, mode, level = mk.sample_batches(table, meta, *planes)
    assert mk.counters.texsample_launches == 0 and out.shape == (2, n)
    for i in range(2):
        ref, m, lv = ts.sample_tex3d(table, meta, *(p[i] for p in planes), return_choice=True)
        assert torch.equal(out[i], ref) and (int(mode[i]), int(level[i])) == (m, lv)
