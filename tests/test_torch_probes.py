"""The peak probe T2 (``ops/kernels/probes.py``) on the CPU: its plain chains
against a numpy transcription of the TPU probe's body,
``tools/vpu_peak.py::_chain_kernel`` (16 accumulator chains started at
``a·(0.4 + 0.01 i) + b``, advanced by ``y·a + b`` or ``exp(−|y|)``, summed in
chain order), and the uint32 multiply-add chain against numpy's uint64
arithmetic.  ``_run_chain`` has no interpret mode (it is a TPU-only
``pallas_call``), so its body is transcribed here; the kernel itself is
held against the plain chains on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 7b).
"""

import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu_torch.ops.kernels import probes


def _planes(seed=3):
    g = np.random.default_rng(seed)
    return ((g.random(probes.PEAK_PLANE) * 0.5 + 0.25).astype(np.float32),
            (g.random(probes.PEAK_PLANE) * 0.1).astype(np.float32))


def _chain_kernel(a, b, op, steps):
    """vpu_peak.py:57-76 in numpy float32: N_ACC chains of ``op``."""
    ys = [a * np.float32(0.4 + 0.01 * i) + b for i in range(probes.PEAK_CHAINS)]
    for _ in range(steps):
        ys = [y * a + b if op == "fma" else np.exp(-np.abs(y)) for y in ys]
    acc = ys[0]
    for y in ys[1:]:
        acc = acc + y
    return acc


@pytest.mark.parametrize("op,atol", [("fma", 0.0), ("exp", 4e-6)])
@pytest.mark.parametrize("iters", [1, 6])
def test_plain_chains_match_the_tpu_probe_body(op, atol, iters):
    """The same operations in the same order: fma exactly (a multiply then
    an add on both sides), exp to a few ulps of the 16-chain sum (≈9.1,
    ulp 9.5e-7: numpy's and PyTorch's exp round some chains differently)."""
    a, b = _planes()
    ref = _chain_kernel(a, b, op, iters * probes.PEAK_INNER[op])
    got = probes.chains_plain(torch.from_numpy(a), torch.from_numpy(b), op, iters)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)


def test_plain_imad_chain_matches_uint32_arithmetic():
    a, b = _planes(4)
    ua = (a.view(np.uint32) | 1).astype(np.uint64)
    ub = b.view(np.uint32).astype(np.uint64)
    ys = [(ua * (k + 1) + ub) % 2**32 for k in range(probes.PEAK_CHAINS)]
    for _ in range(3 * probes.PEAK_INNER["imad"]):
        ys = [(y * ua + ub) % 2**32 for y in ys]
    want = ((sum(ys) % 2**32) >> 8).astype(np.float32)
    got = probes.chains_plain(torch.from_numpy(a), torch.from_numpy(b), "imad", 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_peak_chains_on_the_cpu_take_the_plain_version():
    """Thread i of the kernel takes element i % 2048 of a and b: on the CPU
    the plain chains are repeated over the grid's threads."""
    a, b = (torch.from_numpy(p) for p in _planes())
    probes.counters.reset()
    out = probes.peak_chains(a, b, "fast_exp", 2, 16)
    assert out.shape == (16 * probes.PEAK_THREADS,) and probes.counters.peak_launches == 0
    torch.testing.assert_close(out.reshape(-1, probes.PEAK_PLANE),
                               probes.chains_plain(a, b, "exp", 2).expand(2, -1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("kw", [dict(op="sqrt"), dict(blocks=4), dict(blocks=0),
                                dict(a=torch.zeros(100))])
def test_peak_chains_refuses_bad_arguments(kw):
    a, b = (torch.from_numpy(p) for p in _planes())
    args = dict(a=a, b=b, op="fma", iters=1, blocks=8)
    args.update(kw)
    with pytest.raises(ValueError):
        probes.peak_chains(args["a"], args["b"], args["op"], args["iters"], args["blocks"])
