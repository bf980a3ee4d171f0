"""Build and load the port's CUDA kernels: one shared library from every
source under ``csrc/``.

Each source compiles on its own ``nvcc`` process (``sm_90a``, plain C
interface), all started together, into an object; one more ``nvcc`` links
the objects into ``build/torch_kernels/libkernels-<hash>.so`` at the root of
the checkout.  The hash covers every source and the flags, so an edit of
any source rebuilds.  The library is loaded with ``ctypes``; each wrapper
module binds its own launchers (:func:`function`) and calls every one of
them through :func:`launch`, the one launch route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG_DIR, "csrc")
#: the kernel sources, one ``nvcc`` each
SOURCES = tuple(os.path.join(CSRC, name) for name in ("megakernel.cu", "taa.cu", "probes.cu"))
#: Build directory: ``build/`` at the root of the checkout.
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def nvcc_command(output: str, source: str, ptxas_info: bool = False, defines=()) -> list:
    """The ``nvcc`` command line that compiles one source into the object
    ``output``, with ``-D`` for each of ``defines``.  No fast math;
    ``a*b + c`` contracts into FMAs (``-fmad=true``, measured against
    ``-fmad=false`` in PERF.md)."""
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-fmad=true", *(f"-D{d}" for d in defines), "-c"]
    if ptxas_info:
        cmd.append("-Xptxas=-v")
    return cmd + ["-o", output, source]


def link_command(output: str, objects) -> list:
    return [_nvcc(), *ARCH_FLAGS, "-shared", "-o", output, *objects]


def library_path(build_dir: str = BUILD_DIR, sources=None, defines=()) -> str:
    """Where the library for these sources (default :data:`SOURCES`) and
    flags is built."""
    digest = hashlib.sha256()
    for source in SOURCES if sources is None else sources:
        with open(source, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(nvcc_command("", "", defines=defines)[1:]).encode())
    return os.path.join(build_dir, f"libkernels-{digest.hexdigest()[:16]}.so")


def _run_all(commands) -> str:
    """Run the commands in parallel; raise with the stderr of the first
    that fails, else return their stderr joined."""
    procs = [subprocess.Popen(c, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
             for c in commands]
    logs = [p.communicate()[1] for p in procs]
    for cmd, proc, log in zip(commands, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}) building "
                               f"{cmd[-1]}:\n{log}")
    return "".join(logs)


def build(build_dir: str = BUILD_DIR, ptxas_info: bool = False, sources=None,
          defines=()) -> tuple:
    """Compile the kernel library of ``sources`` (default :data:`SOURCES`)
    with ``defines`` (``-D``; the package's own build sets none) unless it
    is already built.  Returns ``(path, compiler log)``; a failed ``nvcc``
    raises with its stderr."""
    sources = SOURCES if sources is None else tuple(sources)
    path = library_path(build_dir, sources, defines)
    if os.path.exists(path) and not ptxas_info:
        return path, ""
    os.makedirs(build_dir, exist_ok=True)
    stem = f"{path}.{os.getpid()}"
    objects = [f"{stem}.{i}.o" for i in range(len(sources))]
    try:
        log = _run_all([nvcc_command(o, s, ptxas_info, defines)
                        for o, s in zip(objects, sources)])
        log += _run_all([link_command(f"{stem}.tmp", objects)])
        os.replace(f"{stem}.tmp", path)
    finally:
        for o in objects:
            if os.path.exists(o):
                os.remove(o)
    return path, log


_LIBRARY = None


def load_library():
    """Build (if needed) and load the kernel library; cached per process."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = ctypes.CDLL(build()[0])
    return _LIBRARY


def function(name: str, argtypes):
    """The library's C function ``name`` with its ``argtypes`` bound;
    every launcher returns an ``int`` (a CUDA error code, 0 on success)."""
    fn = getattr(load_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(fn, anchor: torch.Tensor, head, tail=(), dtype=torch.float32) -> int:
    """The launch route every launcher takes: ``fn(*head, stream, *tail)``
    with ``stream`` the raw handle of PyTorch's current stream on the
    device of ``anchor``, a tensor the kernel writes.  The handle is read
    anew at every call, since ``torch.cuda.stream(...)`` and graph capture
    change the current stream, and no ``Stream`` object is built for it; a
    device guard is opened only where ``anchor``'s device is not the
    current one (on a process with one card it always is, and the current
    device is not read).  ``anchor`` must be a contiguous ``dtype`` CUDA tensor,
    else ``ValueError``.  Returns ``fn``'s CUDA error code, which the
    launcher checks."""
    index = anchor.get_device()  # -1 on the CPU
    if anchor.dtype != dtype or not anchor.is_contiguous():
        raise ValueError(f"a kernel launch writes a contiguous {dtype} tensor "
                         f"(got {anchor.dtype}, contiguous {anchor.is_contiguous()})")
    if index < 0:
        raise ValueError(f"a kernel launch needs a CUDA tensor (got {anchor.device})")
    if torch.cuda.device_count() == 1 or index == torch._C._cuda_getDevice():
        return fn(*head, torch._C._cuda_getCurrentRawStream(index), *tail)
    with torch.cuda.device(index):
        return fn(*head, torch._C._cuda_getCurrentRawStream(index), *tail)
