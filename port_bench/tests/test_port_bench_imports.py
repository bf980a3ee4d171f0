"""What the harness and the reference import: never JAX nor the JAX
package (top-level names compared whole), and the reference nothing of the
port.  Each check imports the modules in a fresh interpreter and reads its
``sys.modules``."""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "port_bench")
FORBIDDEN = {"jax", "jaxlib", "flax", "godot_atmosphere_shader_tpu"}
PORT = "godot_atmosphere_shader_tpu_torch"


def _modules(path: str) -> list:
    """Dotted names of the Python modules under ``port_bench/<path>``."""
    out = []
    for dirpath, _, files in os.walk(os.path.join(BENCH, path)):
        for f in sorted(files):
            if f.endswith(".py") and "tests" not in dirpath and "metrics" not in dirpath:
                rel = os.path.relpath(os.path.join(dirpath, f[:-3]), ROOT)
                out.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return out


def _loaded_after(code: str) -> list:
    """Top-level names of every module loaded after ``code`` runs in a fresh
    interpreter at the root of the checkout."""
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_reference_imports_neither_jax_nor_the_port():
    mods = _modules("reference") + ["port_bench.compare"] + _modules("roofline")
    loaded = _loaded_after("\n".join(f"import {m}" for m in mods))
    assert not FORBIDDEN & set(loaded)
    assert PORT not in loaded


def test_the_reference_sources_name_no_program_module():
    """The same by the sources: no import of the port or of JAX in any file
    of the reference or the yardstick."""
    for folder in ("reference", "roofline"):
        for dirpath, _, files in os.walk(os.path.join(BENCH, folder)):
            for f in files:
                if not f.endswith(".py"):
                    continue
                tree = ast.parse(open(os.path.join(dirpath, f)).read())
                for node in ast.walk(tree):
                    names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                             [node.module or ""] if isinstance(node, ast.ImportFrom)
                             and not node.level else [])
                    for n in names:
                        assert n.split(".")[0] not in FORBIDDEN | {PORT}, (f, n)


def test_the_harness_and_the_program_load_no_jax():
    """Every harness module, every metric reader and the program's scene
    built on the CPU: still no JAX and no JAX package."""
    metrics = sorted(f[:-3] for f in os.listdir(os.path.join(BENCH, "metrics"))
                     if f.endswith(".py"))
    code = "\n".join([f"import {m}" for m in _modules("")] + [
        "from port_bench import harness",
        f"for name in {metrics!r}: harness.load_metric(name)",
        "from port_bench.program import Program",
        "Program(harness.load_config('demo_clouds_high'), 'cpu')",
    ])
    loaded = _loaded_after(code)
    assert PORT in loaded
    assert not FORBIDDEN & set(loaded)


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla", "flax", "godot_atmosphere_shader_tpu.cli"])
def test_the_run_refuses_a_forbidden_module(name, monkeypatch):
    from port_bench import run

    monkeypatch.setitem(sys.modules, name, object())
    assert name in run.forbidden_modules()


def test_the_port_name_is_not_taken_for_the_jax_package(monkeypatch):
    from port_bench import run

    monkeypatch.setitem(sys.modules, PORT + ".models", object())
    assert all(m.split(".")[0] != PORT for m in run.forbidden_modules())
