"""Two builds of the frame megakernel (its instances ``megakernel_gen``,
``megakernel_tex``, ``megakernel_tex_general``, ``megakernel_clear``) and
of the TAA resolve (``taa_kernel``) on one card, in turns.

    python3 compare_megakernel.py PARENT_MEGAKERNEL_CU [PARENT_TAA_CU]
    python3 compare_megakernel.py --parent-tree PARENT_CHECKOUT

Builds, all ``nvcc`` at once, the checkout's kernel library and one of the
parent's sources (another commit's ``csrc/megakernel.cu`` and, when given,
its ``csrc/taa.cu``, copied under ``build/compare/parent/`` with the
queries ``megakernel_gen_info``, ``megakernel_tex_info``,
``megakernel_clear_info``, ``megakernel_work_slots`` and ``taa_info``
appended where it has none, and the checkout's layout of the launch
structs where it predates it (the texture struct's fields, the scene
buffer's pointers), beside the checkout's other kernel
sources), and each side's measurement build.  ``--parent-tree`` takes a
checkout of the parent commit (``git archive``) instead: its
``megakernel.cu``, ``taa.cu`` and ``probes.cu``, and its package, whose
wrappers and launch route the parent's passes then run.  Then the sides
run in turns, ``parent, change, change, parent``; each pass takes,
through that side's library:

* the main path's 1080p frames (the flagship
  ``clouds_high``/avatar, ``clouds_high``/interior, ``clouds``/avatar,
  ``clouds_high`` at avatar and sunward with a seeded 1024×2048 sky, JAX
  bench cell 5, the flagship on 2 shards, the four envelope frames of
  ``chip_smoke.py`` phase 4f; the texture instance: ``clouds_high``
  texture/avatar (JAX bench cell 6) and texture/interior, the everything-on
  frame at avatar with its sky, and the everything-on frame at 1920×1024 on
  4 shards, whose planet layer is a chained texture launch per shard), the
  64×128 frames whose work counts ``tests/test_torch_cuda.py`` holds
  against the parent's, and the device busy ms per frame of the three 1080p
  K = 8 flights (``torch.profiler``);
* the texture envelope: ``chip_smoke.py`` phase 3h's cases at 64×128 and
  phase 4g's frames at 1080p (against a parent without
  ``megakernel_tex_general``, on the change alone, its second pass held
  against its first);
* the cloud-free instance's frames, JAX bench cells 1, 2
  and 7 (the gas giant's 64-step band at its limb pose) and the
  everything-on frame at space with its sky (an opaque-only pass that draws
  the sky), and cell 7 at 192×128, whose work counts
  ``tests/test_torch_cuda.py`` holds against the parent's; cell 5 (in
  ``main``) also runs one;
* the TAA resolve alone at 1080p on ``chip_smoke.py`` phase
  7's inputs (the flight's second frame, rendered by the plain path, a
  seeded history) and on one 256-row shard of 1920×1024 with its 32-row
  halo (phase 4e's inputs), each with both clamp modes;
* K2 alone (T1) on phase 7's 1080p-sized batches of both kinds, and the
  fill kernel (T3) back to back at 1080p beside ``fill_`` (phase 7's);

each K1 launch's kernel ms (CUDA events) and device ms (``torch.profiler``;
the general texture instance's two launches together, its tile pass's
apart) with its work counts (the march's lane utilisation among them) and what its
instance uses (registers, stack, resident blocks per SM, shared memory; the
row cache, the threads per block, or the blocks launched); each K3 launch's
kernel and device ms and what the kernel uses (CTAs per tile, threads,
registers, stack, CTAs per SM, shared memory); each frame, and each
resolve's frame, depth and validity, held against the first pass's parent
(max |Δ|, p99.9; the resolve bit for bit).

Each pass runs in a process of its own that loads only that side's
library, so no two builds of one kernel share a process.  The bounds are
``chip_smoke.py``'s, from the change's first pass's work counts under T2's
measured ceilings: a parent that lacks a work slot (``od_segments``) is
compared on the others, and its bound is the change's, since the work
these inputs need is the same on both sides.  Each side's measurement
build (``MK_STAGE_CLOCKS``) runs once more per frame with clouds: cycles
per stage, summed over warps (zeros for an instance the parent does not
clock).  It prints each pass as a JSON line, the compiler's report of each
side's kernels, a summary of each side's SASS (``cuobjdump``): the
instructions and MUFU operations of the loop of ``megakernel_clear`` that
issues the most MUFU operations (the atmosphere's steps), whether each
instance of ``megakernel_gen``, ``megakernel_tex``, ``megakernel_clear``
and ``taa_kernel`` has the parent's SASS instruction for instruction, and, last, one
JSON summary per frame and resolve: both sides' times, the change over the
parent, the bound's share and whether the work counts equal the parent's.
Run from the repository root on one card; it needs no network.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
COMPARE_DIR = os.path.join(ROOT, "build", "compare")
KERNEL_FRAMES = 20
# the occupancy query for a parent whose texture instance is one 128 x 32 / G
# thread block per tile with the 26 knots and the reduction scratch in shared
# memory
TEX_INFO_SHIM = r'''
extern "C" int megakernel_tex_info(const MegakernelParams* params, const TexParams* tex,
                                   int* out) {
  (void)tex;
  const int G = params->cloud_lod * params->coverage_lod;
  if (G != 4 && G != 8) return -1;
  const int nt = 128 * (MK_TILE_ROWS / G);
  const int smem = (MK_KNOTS + MK_SHAPE_KNOTS + 2) * nt * (int)sizeof(float) +
                   (nt / 32) * 2 * 3 * (int)sizeof(float);
  auto kernel = G == 4 ? megakernel_tex<MK_KNOTS, MK_SHAPE_KNOTS, 4>
                       : megakernel_tex<MK_KNOTS, MK_SHAPE_KNOTS, 8>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, nt, smem);
  if (err != cudaSuccess) return (int)err;
  const int info[6] = {G, attr.numRegs, (int)attr.localSizeBytes, blocks, smem, nt};
  for (int i = 0; i < 6; ++i) out[i] = info[i];
  return 0;
}
'''
# the occupancy query for a parent whose launcher has one procedural kernel
# and sizes its shared memory by the knot rows alone (no row cache)
GEN_INFO_SHIM = r'''
extern "C" int megakernel_gen_info(const MegakernelParams* params, int* out) {
  const int smem = knot_rows(params) * MK_TILE_COLS * (int)sizeof(float);
  cudaFuncAttributes attr;
  cudaError_t err = smem > 48 * 1024 ? cudaFuncSetAttribute(
      megakernel_gen, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) : cudaSuccess;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, megakernel_gen);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, megakernel_gen, MK_TILE_COLS, smem);
  if (err != cudaSuccess) return (int)err;
  const int info[6] = {params->coverage_lod, attr.numRegs, (int)attr.localSizeBytes, blocks, smem,
                       0};
  for (int i = 0; i < 6; ++i) out[i] = info[i];
  return 0;
}
'''


# the cloud-free instance's occupancy query for a parent without one (one
# 128-thread block per row of 128 columns)
CLEAR_INFO_SHIM = r'''
extern "C" int megakernel_clear_info(const MegakernelParams* params, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, megakernel_clear);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, megakernel_clear, MK_TILE_COLS, 0);
  if (err != cudaSuccess) return (int)err;
  const int info[5] = {attr.numRegs, (int)attr.localSizeBytes, blocks, MK_TILE_COLS,
                       (params->width + MK_TILE_COLS - 1) / MK_TILE_COLS * params->rows};
  for (int i = 0; i < 5; ++i) out[i] = info[i];
  return 0;
}
'''
# the work slots of a parent that does not report them
WORK_SLOTS_SHIM = r'''
extern "C" int megakernel_work_slots(void) { return MK_WORK_SLOTS; }
'''
# the resolve's query for a parent with one block of 128 x 32 / TAA_ROWS_PER_THREAD
# threads per tile and static shared memory alone
TAA_INFO_SHIM = r'''
extern "C" int taa_info(int* out) {
  const int nt = TAA_TILE_COLS * (TAA_TILE_ROWS / TAA_ROWS_PER_THREAD);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, taa_kernel);
  int blocks = 0, device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, taa_kernel, nt, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int info[7] = {1, nt, attr.numRegs, (int)attr.localSizeBytes, blocks,
                       (int)attr.sharedSizeBytes, blocks * sms};
  for (int i = 0; i < 7; ++i) out[i] = info[i];
  return 0;
}
'''
# a source's shims: (the query it needs, its code)
SHIMS = {"megakernel.cu": (("megakernel_gen_info", GEN_INFO_SHIM),
                           ("megakernel_tex_info", TEX_INFO_SHIM),
                           ("megakernel_clear_info", CLEAR_INFO_SHIM),
                           ("megakernel_work_slots", WORK_SLOTS_SHIM)),
         "taa.cu": (("taa_info", TAA_INFO_SHIM),)}


REPORTED = ("megakernel_gen", "megakernel_tex", "megakernel_clear", "taa_kernel",
            "tex_choice_kernel", "sky_choice_kernel", "texsample_kernel", "fill_kernel")


def gen_report(ptxas: str) -> dict:
    """Registers, stack frame and spills of each kernel of :data:`REPORTED`
    in a ``-Xptxas=-v`` log, by mangled name."""
    out, props, entry = {}, None, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if any(k in m.group(1) for k in REPORTED) else None
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1) if any(k in m.group(1) for k in REPORTED) else None
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props:
            out.setdefault(props, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def parent_tex_params(source: str) -> str:
    """A parent's ``megakernel.cu`` whose texture launch struct predates
    the fields' sources (``shape_source``, ``cov_source``) and 16 pyramid
    levels, given the checkout's layout of ``TexParams``: the levels'
    arrays lengthened and the two fields appended.  Its kernels read the
    struct by field, so what they compute does not change."""
    if "shape_source" in source:
        return source
    source = re.sub(r"#define MK_MAX_LEVELS \d+", "#define MK_MAX_LEVELS 16", source)
    return re.sub(r"(struct TexParams \{.*?)(\n\};)",
                  r"\1\n  int shape_source;\n  int cov_source;\2", source, count=1, flags=re.S)


def parent_scene_buffer(source: str) -> str:
    """A parent's ``megakernel.cu`` whose launch structs predate the scene
    buffer (every sphere, box and octave inline, at most 8, 4 and 8),
    given the checkout's layout: the buffer's fields appended to
    ``NoiseParams`` (``ext_octaves``, ``ext_warp_octaves``, ``ext``) and
    ``MegakernelParams`` (``ext_spheres``, ``ext_boxes``, ``geom``).  Its kernels read none of them, so
    what they compute does not change."""
    if "const float* geom;" in source:
        return source
    for struct, fields in (("NoiseParams", ("int ext_octaves", "int ext_warp_octaves",
                                            "const float* ext")),
                           ("MegakernelParams", ("int ext_spheres", "int ext_boxes",
                                                 "const float* geom"))):
        decl = "".join(f"\n  {f};" for f in fields)
        source = re.sub(r"(struct %s \{.*?)(\n\};)" % struct,
                        lambda m: m.group(1) + decl + m.group(2), source, count=1, flags=re.S)
    return source


def parent_copy(path: str, name: str, parent_dir: str) -> str:
    """A parent's source copied into ``parent_dir`` as ``name`` (the
    checkout's source it stands for) with the shims of the queries it lacks
    appended (:data:`SHIMS`) and, for ``megakernel.cu``, the checkout's
    layout of the launch structs (:func:`parent_tex_params`,
    :func:`parent_scene_buffer`);
    returns the copy's path."""
    with open(path) as f:
        source = f.read()
    if name == "megakernel.cu":
        source = parent_scene_buffer(parent_tex_params(source))
    for query, shim in SHIMS.get(name, ()):
        if query not in source:
            source += shim
    copy = os.path.join(parent_dir, name)
    with open(copy, "w") as f:
        f.write(source)
    return copy


def build_sides(parent_cu: str, parent_taa=None, parent_probes=None) -> tuple:
    """The libraries of all the kernel sources: the parent's (its
    ``megakernel.cu`` and, where given, its ``taa.cu`` and ``probes.cu``,
    each with the queries it lacks appended, beside the checkout's other
    sources), the checkout's (the package's own build) and each one's
    measurement build.  All ``nvcc`` at once.  Returns ``({side: path},
    {side: compiler report})``."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import library
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    parent_dir = os.path.join(COMPARE_DIR, "parent")
    os.makedirs(parent_dir)
    copies = {name: parent_copy(path, name, parent_dir)
              for name, path in (("megakernel.cu", parent_cu), ("taa.cu", parent_taa),
                                 ("probes.cu", parent_probes)) if path}
    parent_sources = tuple(copies.get(os.path.basename(s), s) for s in library.SOURCES)
    jobs = {"change": dict(ptxas_info=True),
            "parent": dict(build_dir=parent_dir, sources=parent_sources, ptxas_info=True),
            "change/stages": dict(build_dir=os.path.join(COMPARE_DIR, "stages"),
                                  defines=mk.MEASURE_DEFINES),
            "parent/stages": dict(build_dir=os.path.join(COMPARE_DIR, "parent-stages"),
                                  sources=parent_sources, defines=mk.MEASURE_DEFINES)}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(library.build, **kw) for k, kw in jobs.items()}
        built = {k: f.result() for k, f in futures.items()}
    return ({k: v[0] for k, v in built.items()},
            {k: gen_report(v[1]) for k, v in built.items() if v[1]})


# the kernels whose instances are held against the parent's, instruction
# for instruction (sass_equal): a change that leaves them as they were
# leaves their time as it was
UNCHANGED = ("megakernel_gen", "megakernel_tex", "megakernel_clear", "megakernel_tex_general",
             "tex_choice_kernel", "sky_choice_kernel", "taa_kernel")
# the kernels whose last template argument is EXT (csrc/megakernel.cu: the
# instance for launches that read the scene's buffer); a parent without it
# has only the other instance
EXT_KERNELS = ("megakernel_gen", "megakernel_tex", "megakernel_clear", "megakernel_tex_general",
               "tex_choice_kernel")


def sass_functions(lib: str) -> dict:
    """Each kernel of the library ``lib`` (``cuobjdump -sass``) by mangled
    name: its instructions as ``(offset, text)``, encodings dropped."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    out, code = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            code = out.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if code is not None and m:
            code.append((int(m.group(1), 16), m.group(2)))
    return out


def base_name(mangled: str) -> str:
    """A mangled kernel name's identifier (``_Z14megakernel_genILi1EE...``:
    ``megakernel_gen``)."""
    m = re.match(r"_Z(\d+)", mangled)
    return mangled[m.end():m.end() + int(m.group(1))] if m else mangled


def instance_name(mangled: str) -> str:
    """A kernel instance's readable name from its mangled one: the
    identifier and its integer template arguments, ``EXT`` last where the
    kernel has that argument and it is true (``megakernel_gen<16>``,
    ``megakernel_gen<16, EXT>``, ``megakernel_clear``)."""
    name = base_name(mangled)
    rest = mangled[re.match(r"_Z\d+", mangled).end() + len(name):] if mangled[:2] == "_Z" else ""
    m = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    args = re.findall(r"L([ib])(\d+)E", m.group(1)) if m else []
    ext = name in EXT_KERNELS and bool(args) and args[-1] == ("b", "1")
    if name in EXT_KERNELS and args and args[-1][0] == "b":
        args = args[:-1]
    shown = [v if t == "i" else ("true" if v == "1" else "false") for t, v in args]
    shown += ["EXT"] if ext else []
    return f"{name}<{', '.join(shown)}>" if shown else name


def sass_equal(parent: str, change: str) -> dict:
    """Each instance of the kernels of :data:`UNCHANGED` in the libraries
    ``parent`` and ``change``, by :func:`instance_name` (a parent's
    instance against the change's that is not EXT): whether its SASS is
    the same instruction for instruction, and its instructions on each
    side."""
    a = {instance_name(k): v for k, v in sass_functions(parent).items()}
    b = {instance_name(k): v for k, v in sass_functions(change).items()}
    return {name: {"equal": a.get(name) == b.get(name),
                   "instructions": [len(a.get(name, ())), len(b.get(name, ()))]}
            for name in sorted(set(a) | set(b)) if name.split("<")[0] in UNCHANGED}


def sass_summary(lib: str, kernel: str = "megakernel_clear") -> dict:
    """The SASS of ``kernel`` (an :func:`instance_name`) in the library
    ``lib`` (``cuobjdump -sass``): its instructions and MUFU operations,
    and those of its loop (a branch back to an earlier offset) that holds
    the most MUFU operations, by kind."""
    code = [ins for name, rows in sass_functions(lib).items() if instance_name(name) == kernel
            for ins in rows]

    def mufu(rows):
        kinds = {}
        for _, ins in rows:
            m = re.search(r"MUFU\.(\w+)", ins)
            if m:
                kinds[m.group(1)] = kinds.get(m.group(1), 0) + 1
        return kinds

    best = None
    for at, ins in code:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < at:
            body = [(o, i) for o, i in code if int(m.group(1), 16) <= o <= at]
            n = sum(mufu(body).values())
            if best is None or n > best[0]:
                best = (n, body)
    out = {"kernel": kernel, "instructions": len(code), "mufu": mufu(code)}
    if best is not None:
        out.update(loop_instructions=len(best[1]), loop_mufu=mufu(best[1]),
                   loop_calls=sum("CALL" in i for _, i in best[1]))
    return out


class Case:
    """One frame of the comparison: its launches far to near (each ``(kind,
    struct, args, planes, shard?)``), the cloud layers timed."""

    def __init__(self, label, scene, cam, h, w, launches, config_of):
        self.label, self.scene, self.cam, self.h, self.w = label, scene, cam, h, w
        self.launches = launches
        self.config_of = config_of  # launch index -> its layer's config

    def run_all(self):
        from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

        for _, struct, args, planes, _ in self.launches:
            mk.launch(struct, planes[0], planes[1], depth=planes[2], **args)

    def frame(self) -> np.ndarray:
        """The frame the launches render: each set of planes' rows in turn."""
        self.run_all()
        torch.cuda.synchronize()
        planes = {id(launch[3]): launch[3] for launch in self.launches}.values()
        return np.concatenate([np.concatenate([c.cpu().numpy(), a.cpu().numpy()[..., None]], -1)
                               for c, a, _ in planes], axis=0)

    def clouds(self):
        """The cloud launches: every procedural or texture cloud layer."""
        return [i for i, (_, st, _, _, _) in enumerate(self.launches)
                if st.clouds_enabled and st.with_atmosphere]


def plan_case(label, scene, cam, h, w, device) -> Case:
    """A frame's launches as ``Scene.render`` plans them, on one set of
    planes."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    params, configs, tex, bands, rows = cs.scene_plan(scene, cam, h)
    pano_data, pano_meta = scene._pano_plan() or (None, None)
    launches = mk.scene_launches(params, configs, cam, scene.opaque, h, w, tex_data=tex,
                                 bands=bands, band_rows=rows, pano_data=pano_data,
                                 pano_meta=pano_meta)
    planes = (torch.empty((h, w, 3), device=device), torch.empty((h, w), device=device),
              torch.empty((h, w), device=device))
    layer_of = ([0] if launches[0][0] == "opaque" else []) + list(range(len(configs)))
    return Case(label, scene, cam, h, w,
                [(kind, st, args, planes, False) for kind, st, args in launches],
                {i: configs[li] for i, li in enumerate(layer_of)})


def shard_case(label, scene, cam, h, w, n, device) -> Case:
    """n row shards of a frame through the band entries, each on its own
    planes of its rows."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    params, configs, tex, pdata, pmeta = cs.shard_inputs(scene, cam)
    rows = h // n
    launches, config_of = [], {}
    for s in range(n):
        planes = (torch.empty((rows, w, 3), device=device), torch.empty((rows, w), device=device),
                  torch.empty((rows, w), device=device))
        for layer, (kind, st, args) in enumerate(mk.band_launches(
                params, configs, cam, scene.opaque, h, w, s * rows, rows, tex_data=tex,
                pano_data=pdata, pano_meta=pmeta)):
            config_of[len(launches)] = configs[layer]
            launches.append((kind, st, args, planes, True))
    return Case(label, scene, cam, h, w, launches, config_of)


#: ``tests/test_torch_cuda.py``'s frames whose work counts it holds against
#: the parent's: the flagship and the same layer straddling the shell's edge,
#: and the texture frame
SMALL_CASES = (("clouds_high", "avatar"), ("clouds_high", "exterior"))
SMALL_SIZE = (64, 128)
#: the gas giant's band at the size whose work counts ``tests/test_torch_cuda.py``
#: holds against the parent's
GAS_GIANT_SMALL = (192, 128)


def cases(device, textures, tex_envelope: bool = True) -> list:
    """The frames compared; ``tex_envelope``: with ``chip_smoke.py`` phase
    3h's cases at 64×128 and phase 4g's frames at 1080p (the texture
    envelope, which a parent without ``megakernel_tex_general`` does not
    render)."""
    H, W = cs.FULL_SIZE
    pano = cs.synthetic_panorama(*cs.PANO_SIZE)
    out = []
    for cell, kind, pose, ch, cw in cs.BENCH_CELLS:
        if cell == "5":
            continue
        scene, cam = cs.build_scene(kind, device), cs.scene_camera(kind, pose, device)
        scene.update(0.5, cam)
        out.append(plan_case(f"cell {cell}", scene, cam, ch, cw, device))
    allon = cs.with_panorama(cs.build_scene("allon", device, textures), pano)
    cam = cs.scene_camera("allon", "space", device)
    allon.update(0.25, cam)
    out.append(plan_case("everything-on/space with the sky", allon, cam, H, W, device))
    scene, cam = cs.build_scene("gas_giant", device), cs.scene_camera("gas_giant", "limb", device)
    scene.update(0.5, cam)
    out.append(plan_case(f"cell 7 {GAS_GIANT_SMALL[0]}x{GAS_GIANT_SMALL[1]}", scene, cam,
                         *GAS_GIANT_SMALL, device))
    for variant, pose in SMALL_CASES:
        scene, cam = cs.scene_and_camera(variant, pose, device)
        out.append(plan_case(f"{variant}/{pose} {SMALL_SIZE[0]}x{SMALL_SIZE[1]}", scene, cam,
                             *SMALL_SIZE, device))
    scene, cam = cs.scene_and_camera("clouds_high", "avatar", device, textures=textures)
    out.append(plan_case(f"clouds_high texture/avatar {SMALL_SIZE[0]}x{SMALL_SIZE[1]}", scene,
                         cam, *SMALL_SIZE, device))
    if tex_envelope:
        for name, changes in cs.TEX_ENVELOPE_CASES.items():
            scene, cam = cs.tex_envelope_scene(changes, device, textures)
            out.append(plan_case(f"texture envelope {name} {SMALL_SIZE[0]}x{SMALL_SIZE[1]}",
                                 scene, cam, *SMALL_SIZE, device))
        for name, changes in cs.TEX_ENVELOPE_FRAMES.items():
            scene, cam = cs.tex_envelope_scene(changes, device, textures)
            out.append(plan_case(name, scene, cam, H, W, device))
    for variant, pose in (("clouds_high", "avatar"), ("clouds_high", "interior"),
                          ("clouds", "avatar")):
        scene, cam = cs.scene_and_camera(variant, pose, device)
        out.append(plan_case(f"{variant}/{pose}", scene, cam, H, W, device))
    for pose in cs.TEXTURE_POSES:
        scene, cam = cs.scene_and_camera("clouds_high", pose, device, textures=textures)
        out.append(plan_case(f"clouds_high texture/{pose}", scene, cam, H, W, device))
    allon = cs.with_panorama(cs.build_scene("allon", device, textures), pano)
    cam = cs.scene_camera("allon", "avatar", device)
    allon.update(0.25, cam)
    out.append(plan_case("everything-on/avatar with the sky", allon, cam, H, W, device))
    SH, SW = cs.SHARD_SIZE
    out.append(shard_case(f"everything-on/avatar {SH}x{SW} on {cs.SHARDS} shards", allon, cam,
                          SH, SW, cs.SHARDS, device))
    for pose in ("avatar", "sunward"):
        scene = cs.with_panorama(cs.build_scene("clouds_high", device), pano)
        cam = cs.scene_camera("clouds_high", pose, device)
        scene.update(0.5, cam)
        out.append(plan_case(f"clouds_high/{pose} with the sky", scene, cam, H, W, device))
    _, kind, pose, ch, cw = [c for c in cs.BENCH_CELLS if c[0] == "5"][0]
    scene, cam = cs.build_scene(kind, device), cs.scene_camera(kind, pose, device)
    scene.update(0.5, cam)
    out.append(plan_case("cell 5", scene, cam, ch, cw, device))
    scene, cam = cs.scene_and_camera("clouds_high", "avatar", device)
    out.append(shard_case(f"clouds_high/avatar on {cs.FLAGSHIP_SHARDS} shards", scene, cam, H, W,
                          cs.FLAGSHIP_SHARDS, device))
    for name in cs.ENVELOPE_FRAMES:
        scene, cam = cs.envelope_scene(name, device)
        out.append(plan_case(name, scene, cam, H, W, device))
    return out


def flights(device, textures) -> dict:
    """The three 1080p K = 8 flights of ``chip_smoke.py`` phase 6, each a
    function that renders it once."""
    from godot_atmosphere_shader_tpu_torch.utils.camera import Camera

    H, W = cs.FULL_SIZE
    K = cs.FLIGHT_FRAMES
    stack = cs.fly_path(K)
    out = {}
    for label, tx, blend in (("clouds_high TAA", None, cs.FLIGHT_BLEND),
                             ("clouds_high texture TAA", textures, cs.FLIGHT_BLEND),
                             ("clouds_high", None, None)):
        scene, _ = cs.scene_and_camera("clouds_high", "avatar", device, textures=tx)
        cam = Camera.create(stack[0], device=device)
        out[label] = (lambda scene=scene, cam=cam, blend=blend: scene.render_flight(
            cam, cs.flight_times(K, 5.0), H, W, cam_transforms=stack, taa_blend=blend))
    return out


def resolves(device) -> dict:
    """The TAA resolve's cases: ``{label: (launch struct, (cur, linear depth,
    history, history depth))}``, at 1080p on phase 7's inputs (the flight's
    second frame, rendered by the plain path; a history seeded on the
    host) and on the second of 4 shards of 1920×1024 with a 32-row halo on
    phase 4e's inputs, each with both clamp modes."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.ops.kernels import taa
    from godot_atmosphere_shader_tpu_torch.utils.camera import Camera

    H, W = cs.FULL_SIZE
    stack = cs.fly_path(cs.FLIGHT_FRAMES)
    scene, _ = cs.scene_and_camera("clouds_high", "avatar", device)
    cam = Camera.create(stack[0], device=device)
    scene.update(0.5, cam)
    inputs, _ = cs.frame_inputs(scene, cam)
    raw = mk.render_frame_plain(inputs[0], inputs[1], cam, inputs[3], H, W)
    g = torch.Generator().manual_seed(7)
    hist = torch.rand((H, W, 3), generator=g).to(device)
    planes = (raw["color"].contiguous(), raw["linear_depth"].contiguous(), hist,
              raw["linear_depth"].clone())
    SH, SW = cs.SHARD_SIZE
    rows, halo = SH // cs.SHARDS, cs.TAA_HALO
    case = next(c for c in cs.TAA_CASES if c[0] == "partial_tile")
    _, prev, now, blend, _ = case
    color, ld, hst, hd = cs.taa_case_inputs(case, SH, SW, device)
    z = lambda t: torch.zeros((halo,) + tuple(t.shape[1:]), device=device)  # noqa: E731
    hp, dp = torch.cat([z(hst), hst, z(hst)]), torch.cat([z(hd), hd, z(hd)])
    r0 = rows
    band = (color[r0:r0 + rows], ld[r0:r0 + rows], hp[r0:r0 + rows + 2 * halo],
            dp[r0:r0 + rows + 2 * halo])
    cams = (Camera.create(prev, device="cpu"), Camera.create(now, device="cpu"))
    out = {}
    for mode in taa.CLAMP_MODES:
        settings = taa.TaaSettings(blend=cs.FLIGHT_BLEND, clamp_mode=mode)
        out[f"K3 1080p {mode}"] = (taa.flight_constants(cam, stack, settings, H, W)[1], planes)
        out[f"K3 {rows}-row shard of {SH}x{SW} {mode}"] = (
            taa.taa_constants(*cams, blend, SH, SW, rows + 2 * halo, clamp_mode=mode, rows=rows,
                              row0=r0, hist_row0=r0 - halo), band)
    return out


def resolve_pass(all_resolves: dict, ref_dir: str) -> dict:
    """Each resolve through this process's library: its events and device
    ms per launch, what the kernel uses, and its frame, depth and validity
    against the reference in ``ref_dir`` (written by the first pass)."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import taa

    out = {}
    for n, (label, (p, planes)) in enumerate(all_resolves.items()):
        res = torch.empty_like(planes[0])
        depth = torch.empty_like(planes[1])
        valid = torch.empty(planes[1].shape, dtype=torch.uint8, device=res.device)
        taa.launch(p, *planes, res, depth, valid)
        torch.cuda.synchronize()
        got = {"frame": res.cpu().numpy(), "depth": depth.cpu().numpy(),
               "valid": valid.cpu().numpy()}
        equal = {}
        for k, v in got.items():
            ref_path = os.path.join(ref_dir, f"k3-{n}-{k}.npy")
            if not os.path.exists(ref_path):
                np.save(ref_path, v)
            equal[k] = bool(np.array_equal(v, np.load(ref_path)))
        ms = cs.time_cuda(lambda i: taa.launch(p, *planes, res, depth), KERNEL_FRAMES)
        trace = cs.kernel_trace(lambda: [taa.launch(p, *planes, res, depth)
                                         for _ in range(KERNEL_FRAMES)], "taa_kernel")
        px = p.rows * p.width
        halo_rows = p.hist_rows - p.rows
        t_bytes = (px * cs.BYTES_TAA_PIXEL + halo_rows * p.width * 16) / cs.PEAK_BYTES * 1e3
        t_ops = cs.ops_time_ms(px * cs.OPS_TAA_PIXEL)
        out[label] = {"ms": ms, "device_ms": trace["device_us"] / 1e3,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "equal_to_reference": equal, "instance": taa.info()}
    return out


def probe_pass(device, ref_dir: str) -> dict:
    """The small kernels through this process's library and wrappers:
    K2 alone (T1, ``sample_batches``) on ``chip_smoke.py`` phase 7's
    1080p-sized batches of both kinds and the fill kernel (T3) launched
    ``FILL_LAUNCHES`` times back to back into 1080p planes, as phase 7
    times them; each one's events ms (by the wrapper, its launch route
    included) and device ms, its bound, and its output against the first
    pass's (``equal_to_reference``); the fill also beside ``fill_``."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.ops.kernels import probes
    from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as ts

    def same(name: str, got: dict) -> dict:
        equal = {}
        for k, v in got.items():
            ref_path = os.path.join(ref_dir, f"{name}-{k}.npy")
            if not os.path.exists(ref_path):
                np.save(ref_path, v)
            equal[k] = bool(np.array_equal(v, np.load(ref_path)))
        return equal

    rng = np.random.default_rng(5)
    pyramids = {"tex3d": ts.build_tex3d_pyramid(rng.random((64, 64, 64)).astype(np.float32)),
                "latlong": ts.build_latlong_pyramid(rng.random((6, 64, 64)).astype(np.float32),
                                                    width=512)}
    b, n = 34 * 15 * 3, 8 * 1024
    out = {}
    for kind, (data, meta) in pyramids.items():
        table = torch.as_tensor(data, device=device)
        planes = cs.k2_planes(kind, device, b, n)
        kw = cs.K2_TEX3D_CASES[2][5] if kind == "tex3d" else {}
        values, mode, level = mk.sample_batches(table, meta, *planes, **kw)
        torch.cuda.synchronize()
        equal = same(f"k2-{kind}", {"values": values.cpu().numpy(), "mode": mode.cpu().numpy(),
                                    "level": level.cpu().numpy()})
        ms = cs.time_cuda(lambda i: mk.sample_batches(table, meta, *planes, **kw), KERNEL_FRAMES)
        trace = cs.kernel_trace(lambda: [mk.sample_batches(table, meta, *planes, **kw)
                                         for _ in range(KERNEL_FRAMES)], "texsample_kernel")
        ops = cs.OPS_TEX3D if kind == "tex3d" else cs.OPS_K2_LATLONG
        t_ops = cs.ops_time_ms(b * n * ops)
        t_bytes = (b * n * 16 + table.numel() * 4) / cs.PEAK_BYTES * 1e3
        out[f"T1 K2 alone {kind} {b}x{n}"] = {
            "ms": ms, "device_ms": trace["device_us"] / 1e3, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "equal_to_reference": equal, "instance": None}
    H, W = cs.FULL_SIZE
    planes = torch.empty((cs.FILL_LAUNCHES, H, W), device=device)
    probes.launch_fill(0.5, planes[0])
    torch.cuda.synchronize()
    equal = same("fill", {"plane": planes[0].cpu().numpy()})
    ms = cs.time_cuda(lambda i: probes.launch_fill(float(i), planes[i % cs.FILL_LAUNCHES]),
                      cs.FILL_LAUNCHES)
    library_ms = cs.time_cuda(lambda i: planes[i % cs.FILL_LAUNCHES].fill_(float(i)),
                              cs.FILL_LAUNCHES)
    trace = cs.kernel_trace(lambda: [probes.launch_fill(float(i), planes[i])
                                     for i in range(cs.FILL_LAUNCHES)], "fill_kernel")
    out[f"T3 fill {H}x{W}"] = {"ms": ms, "device_ms": trace["device_us"] / 1e3,
                               "library_ms": library_ms,
                               "bound_ms": (H * W * 4 + 4) / cs.PEAK_BYTES * 1e3,
                               "bound_by": "bytes", "equal_to_reference": equal,
                               "instance": None}
    return out


def bound(case: Case, i: int, work: dict) -> dict:
    """The launch's roofline bound as ``chip_smoke.py`` takes it (the
    general texture instance's: its tile pass's plus its frame's, each
    also apart); none for work counts without every slot the bound reads
    (a parent's)."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    if "od_segments" not in work:
        return {"bound_ms": None, "bound_by": None}
    kind, st, args, _, shard = case.launches[i]
    if shard:
        per_px = cs.BYTES_CHAINED_PIXEL if st.with_background else cs.BYTES_BAND_PIXEL
    else:
        per_px = (cs.BYTES_OPAQUE_PIXEL if kind == "opaque" else cs.BYTES_CHAINED_PIXEL
                  if st.with_background else cs.BYTES_LAYER_PIXEL)
    cost = {}
    if st.with_sky:
        cost = cs.sky_cost(case.cam, case.h, case.w, case.scene._pano_plan()[1],
                           in_block=args["tex"] is not None, row0=st.row0, rows=st.rows)
    tl = args["tex"]
    table_bytes = 0 if tl is None else sum(x.numel() * 4 for x in tl[1:] if x is not None)
    frame = dict(frame_bytes=st.rows * case.w * per_px, sky_bytes=cost.get("sky_bytes", 0),
                 sky_choice_ops=cost.get("sky_choice_ops", 0))
    if tl is not None and not mk.fixed_texture_instance(st, tl[0]):
        # the general texture instance's two launches, each charged with what it runs
        depth = st.rows * case.w * 4 if shard or st.with_background else 0
        b = cs.tex_general_roofline(work, case.config_of[i], st, tl[0], table_bytes,
                                    depth_bytes=depth, **frame)
        return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "choice_bound_ms": b["tile"]["bound_ms"], "frame_bound_ms": b["frame"]["bound_ms"]}
    b = cs.roofline(work, case.config_of[i], case.h, case.w, table_bytes, **frame)
    return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}


def instance(st, args) -> dict:
    """What the instance that launches ``st`` uses on this card."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    if not (st.clouds_enabled and st.with_atmosphere):
        return {"instance": "clear", **mk.clear_info(st)}
    if args["tex"] is None:
        return {"instance": "gen", **mk.gen_info(st)}
    info = mk.tex_info(st, args["tex"][0])
    return {"instance": "tex_general" if info["general"] else "tex", **info}


def one_pass(all_cases: list, all_flights: dict, ref_dir: str) -> dict:
    """Every case and flight through this process's library: each
    launch's events and device ms, work counts, instance and bound; the
    frame against the reference frames in ``ref_dir`` (written by the first
    pass); each flight's device busy ms per frame."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    out = {}
    for case in all_cases:
        case.run_all()  # the planes the chained launches read
        rows = []
        for i in range(len(case.launches)):
            _, st, args, planes, _ = case.launches[i]
            ms = cs.time_cuda(lambda k, st=st, args=args, planes=planes: mk.launch(
                st, planes[0], planes[1], depth=planes[2], **args), KERNEL_FRAMES)
            device = {k: v["device_us"] / 1e3 for k, v in cs.kernel_traces(
                lambda st=st, args=args, planes=planes: [mk.launch(
                    st, planes[0], planes[1], depth=planes[2], **args)
                    for _ in range(KERNEL_FRAMES)], ("megakernel", "tex_choice_kernel")).items()}
            work = mk.work_counts(st, planes[0], planes[1], depth=planes[2], **args)
            # the general texture instance's device ms: its tile pass's and its frame's
            rows.append({"row0": st.row0, "rows": st.rows, "ms": ms,
                         "device_ms": device["megakernel"] + device["tex_choice_kernel"],
                         "choice_device_ms": device["tex_choice_kernel"], "work": work,
                         "lane_utilisation": cs.lane_utilisation(work), **instance(st, args),
                         **bound(case, i, work)})
        img = case.frame()
        ref_path = os.path.join(ref_dir, re.sub(r"\W+", "_", case.label) + ".npy")
        if not os.path.exists(ref_path):
            np.save(ref_path, img)
        d = np.abs(img.astype(np.float64) - np.load(ref_path))
        out[case.label] = {"launches": rows, "ms": sum(r["ms"] for r in rows),
                           "vs_reference_max": float(d.max()),
                           "vs_reference_p999": float(np.percentile(d, 99.9))}
    for label, fn in all_flights.items():
        fn()  # warm
        trace = cs.flight_trace(fn)
        out[label] = {"device_busy_ms_per_frame": trace["device_busy_ms"] / cs.FLIGHT_FRAMES,
                      "frame_kernels": trace["frame_kernels"]}
    return out


def stage_pass(all_cases: list) -> dict:
    """This process's library is a measurement build: each cloud launch's
    cycles per stage, summed over warps, and its lane utilisation."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    out = {}
    for case in all_cases:
        case.run_all()
        split = []
        for i in case.clouds():
            _, st, args, planes, _ = case.launches[i]
            work = mk.work_counts(st, planes[0], planes[1], depth=planes[2], stages=True, **args)
            cycles = {k: work[f"stage_{k}_cycles"] for k in mk.STAGE_SLOTS}
            total = sum(cycles.values())
            split.append({"cycles": cycles, "lane_utilisation": cs.lane_utilisation(work),
                          "share": {k: v / total for k, v in cycles.items()} if total else None})
        out[case.label] = split
    return out


def run_pass(args) -> int:
    """One pass in this process, through the library at ``args.library``
    alone; its result as JSON to ``args.out``.  A library that writes
    fewer work slots than the checkout names (a parent's) is read with the
    slots it writes, the first ones."""
    if args.package_root:  # the parent's package: its wrappers and launch route
        sys.path.insert(0, os.path.abspath(args.package_root))
    from godot_atmosphere_shader_tpu_torch.models.demo import bake_demo_textures
    from godot_atmosphere_shader_tpu_torch.ops.kernels import library
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    library._LIBRARY = ctypes.CDLL(args.library)  # every kernel of this process
    slots = library._LIBRARY.megakernel_work_slots()
    if slots > len(mk.WORK_SLOTS):
        raise RuntimeError(f"{args.library} writes {slots} work slots, more than the checkout's")
    mk.WORK_SLOTS = mk.WORK_SLOTS[:slots]
    cs.PEAK.update(fp32=args.peak_fp32, int32=args.peak_int32)
    device = torch.device("cuda", 0)
    textures = bake_demo_textures(device=device)
    all_cases = cases(device, textures, not args.without_tex_envelope)
    if args.stages:
        result = stage_pass([c for c in all_cases if c.clouds()])
    else:
        result = one_pass(all_cases, flights(device, textures), args.reference)
        result.update(resolve_pass(resolves(device), args.reference))
        result.update(probe_pass(device, args.reference))
    cs.log(f"[compare] pass through {args.library} and the wrappers of "
           f"{os.path.dirname(os.path.dirname(os.path.dirname(mk.__file__)))}")
    with open(args.out, "w") as f:
        json.dump(result, f)
    return 0


def launch_bounds(launches: list) -> list:
    """Each launch's bound, and where it has two kernels (the general
    texture instance) each one's."""
    return [{k: x[k] for k in ("bound_ms", "choice_bound_ms", "frame_bound_ms") if k in x}
            for x in launches]


def summarise(runs: dict, sides: list, label: str) -> dict:
    """One frame's or resolve's summary over every side's passes."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    first = runs["parent"][0][label]
    if "device_busy_ms_per_frame" in first:  # a flight
        return {side: [r[label]["device_busy_ms_per_frame"] for r in runs[side]]
                for side in sides}
    if "equal_to_reference" in first:  # a resolve
        s = {"bound_ms": first["bound_ms"], "bound_by": first["bound_by"]}
        parent_ms = min(r[label]["ms"] for r in runs["parent"])
        # a trace can miss the kernel (0 ms): the readings that caught it
        parent_dev = min((r[label]["device_ms"] for r in runs["parent"]
                          if r[label]["device_ms"] > 0), default=None)
        for side in sides:
            ms = [r[label]["ms"] for r in runs[side]]
            dev = [r[label]["device_ms"] for r in runs[side]]
            best_dev = min((d for d in dev if d > 0), default=None)
            s[side] = {"ms": ms, "device_ms": dev, "best_ms": min(ms),
                       "best_device_ms": best_dev, "vs_parent": min(ms) / parent_ms,
                       "device_vs_parent": best_dev / parent_dev if best_dev and parent_dev
                       else None,
                       "bound_share_device": s["bound_ms"] / best_dev if best_dev else None,
                       "equal_to_parent": all(all(r[label]["equal_to_reference"].values())
                                              for r in runs[side]),
                       "instance": runs[side][0][label]["instance"]}
        return s
    # the work a bound counts (the march's lane slots differ by design), in
    # the slots both sides write
    counted = [k for k in mk.WORK_SLOTS if not k.startswith("march_")]
    change = runs["change"][0][label]["launches"]
    s = {"bound_ms": sum(x["bound_ms"] for x in change),
         "bound_by": [x["bound_by"] for x in change], "launch_bounds": launch_bounds(change)}
    parent_ms = min(r[label]["ms"] for r in runs["parent"])
    for side in sides:
        ms = [r[label]["ms"] for r in runs[side]]
        launches = runs[side][0][label]["launches"]
        s[side] = {"ms": ms, "best_ms": min(ms), "bound_share": s["bound_ms"] / min(ms),
                   "vs_parent": min(ms) / parent_ms,
                   "launch_ms": [min(r[label]["launches"][i]["ms"] for r in runs[side])
                                 for i in range(len(launches))],
                   "launch_device_ms": [min(r[label]["launches"][i]["device_ms"]
                                            for r in runs[side])
                                        for i in range(len(launches))],
                   "launch_choice_device_ms": [min(r[label]["launches"][i]["choice_device_ms"]
                                                   for r in runs[side])
                                               for i in range(len(launches))],
                   "max_vs_parent": max(r[label]["vs_reference_max"] for r in runs[side]),
                   "work_equals_parent": all(
                       all(a["work"][k] == b["work"][k] for k in counted
                           if k in a["work"] and k in b["work"])
                       for a, b in zip(launches, first["launches"])),
                   "lane_utilisation": [x["lane_utilisation"] for x in launches],
                   "work": [x["work"] for x in launches],
                   "instance": [{k: x[k] for k in ("instance", *mk_info(x["instance"]))}
                                for x in launches]}
    return s


def summarise_alone(passes: list, label: str) -> dict:
    """A frame that only the change renders (the texture envelope, which a
    parent without ``megakernel_tex_general`` skips): its passes' times,
    bound, work, instance, and the second pass against the first (max
    |Δ|)."""
    launches = passes[0][label]["launches"]
    bound_ms = sum(x["bound_ms"] for x in launches)
    best = min(r[label]["ms"] for r in passes)
    return {"bound_ms": bound_ms, "bound_by": [x["bound_by"] for x in launches],
            "launch_bounds": launch_bounds(launches),
            "ms": [r[label]["ms"] for r in passes], "best_ms": best,
            "bound_share": bound_ms / best,
            "launch_device_ms": [min(r[label]["launches"][i]["device_ms"] for r in passes)
                                 for i in range(len(launches))],
            "max_vs_first_pass": max(r[label]["vs_reference_max"] for r in passes),
            "work": [x["work"] for x in launches],
            "instance": [{k: x[k] for k in ("instance", *mk_info(x["instance"]))}
                         for x in launches]}


def mk_info(kind: str) -> tuple:
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    return (mk.GEN_INFO if kind == "gen" else mk.TEX_INFO if kind.startswith("tex")
            else mk.CLEAR_INFO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent_cu", nargs="?", help="the parent commit's csrc/megakernel.cu")
    ap.add_argument("parent_taa", nargs="?", help="the parent commit's csrc/taa.cu (default: "
                    "the checkout's)")
    ap.add_argument("--parent-tree", help="a checkout of the parent commit (git archive): "
                    "its three kernel sources, and its package's wrappers for the parent's "
                    "passes")
    # one pass in a process of its own (the comparison starts these)
    ap.add_argument("--library", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--reference", help=argparse.SUPPRESS)
    ap.add_argument("--stages", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--peak-fp32", type=float, help=argparse.SUPPRESS)
    ap.add_argument("--peak-int32", type=float, help=argparse.SUPPRESS)
    ap.add_argument("--without-tex-envelope", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--package-root", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the comparison needs one GPU")
    if args.library:
        return run_pass(args)
    parent_probes = None
    if args.parent_tree:
        csrc = os.path.join(args.parent_tree, "godot_atmosphere_shader_tpu_torch", "csrc")
        args.parent_cu = args.parent_cu or os.path.join(csrc, "megakernel.cu")
        args.parent_taa = args.parent_taa or os.path.join(csrc, "taa.cu")
        parent_probes = os.path.join(csrc, "probes.cu")
    if not args.parent_cu:
        ap.error("the parent's megakernel.cu (or --parent-tree) is required")

    device = torch.device("cuda", 0)
    card = cs.smi("name,power.limit")
    cs.log(card)
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    shutil.rmtree(COMPARE_DIR, ignore_errors=True)
    paths, reports = build_sides(args.parent_cu, args.parent_taa, parent_probes)
    cs.log(f"[compare] compiler report of {', '.join(REPORTED)} per side: "
           f"{json.dumps(reports)}")
    for side, path in paths.items():
        for kernel in ("megakernel_clear", "taa_kernel"):
            cs.log(f"[compare] SASS of {side}: {json.dumps(sass_summary(path, kernel))}")
    same = sass_equal(paths["parent"], paths["change"])
    cs.log(f"[compare] SASS of {', '.join(UNCHANGED)}, parent against change: "
           f"{json.dumps(same)}; every instance the same: "
           f"{all(v['equal'] for v in same.values())}")
    mk.load_library()
    peak = cs.peak_probe(device)
    cs.PEAK.update(fp32=max(peak["fp32_flops"], peak["clock_fp32_flops"]),
                   int32=max(peak["int32_per_s"], peak["clock_int32_per_s"]))
    cs.log(f"[compare] bounds divide by fp32 {cs.PEAK['fp32'] / 1e12:.3f} TFLOP/s and INT32 "
           f"{cs.PEAK['int32'] / 1e12:.3f} T/s on {card}")
    ref_dir = os.path.join(COMPARE_DIR, "reference")
    os.makedirs(ref_dir)

    with open(args.parent_cu) as f:
        parent_general = "megakernel_tex_general" in f.read()
    def start(side: str, lib: str, stages: bool = False) -> dict:
        out = os.path.join(COMPARE_DIR, f"pass-{side.replace('/', '-')}.json")
        # a parent without the general texture instance skips the texture
        # envelope, which the change then runs alone
        alone = not parent_general and side.startswith("parent")
        cmd = [sys.executable, os.path.abspath(__file__), "--library", lib, "--out", out,
               "--reference", ref_dir, "--peak-fp32", repr(cs.PEAK["fp32"]),
               "--peak-int32", repr(cs.PEAK["int32"])] + (["--stages"] if stages else []) + (
                   ["--without-tex-envelope"] if alone else []) + (
                   ["--package-root", args.parent_tree]
                   if args.parent_tree and side.startswith("parent") else [])
        subprocess.run(cmd, check=True)
        with open(out) as f:
            return json.load(f)

    sides = ["parent", "change"]
    runs = {s: [] for s in sides}
    for side in sides + sides[::-1]:  # the first pass writes the reference frames
        result = start(side, paths[side])
        runs[side].append(result)
        cs.log(f"[compare] pass {side} on {card}: {json.dumps(result)}")
        cs.log(f"[compare] after the pass: "
               f"{cs.smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    for side in sides:
        cs.log(f"[compare] stages {side} on {card}: "
               f"{json.dumps(start(f'{side}-stages', paths[f'{side}/stages'], stages=True))}")
    for label in runs["parent"][0]:
        cs.log(f"[compare] {label} on {card}: {json.dumps(summarise(runs, sides, label))}")
    for label in runs["change"][0]:
        if label not in runs["parent"][0]:
            cs.log(f"[compare] {label} (the change alone) on {card}: "
                   f"{json.dumps(summarise_alone(runs['change'], label))}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
