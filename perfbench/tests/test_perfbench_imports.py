"""Nothing the benchmark loads is the JAX stack or the JAX package: every
module of ``perfbench`` (and so of the program it drives) imported in a
fresh process, and every top-level module name held against ``jax``,
``jaxlib``, ``flax`` and ``repro`` whole (``repro_torch`` is neither)."""
from __future__ import annotations

import os
import subprocess
import sys

from perfbench.tests import smoke_root

REPO = smoke_root.REPO


def test_importing_the_benchmark_loads_no_jax_and_no_repro():
    files = sorted(p for p in (REPO / "perfbench").rglob("*.py")
                   if "tests" not in p.parts)
    code = (
        "import importlib.util, sys\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        "from perfbench import harness\n"
        f"for f in {[str(f) for f in files]!r}:\n"
        "    harness.load_file_module(f)\n"
        "import repro_torch.launch.steps, repro_torch.launch.mesh\n"
        "bad = harness.forbidden_modules()\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_guard_compares_whole_names():
    from perfbench import harness
    clean = ["repro_torch", "repro_torch.launch", "jaxfoo.bar", "flaxen",
             "reproducible", "torch"]
    assert harness.forbidden_modules(clean) == []
    assert harness.forbidden_modules(
        clean + ["jax.numpy", "repro", "jaxlib", "flax.linen",
                 "repro.core"]) == ["flax.linen", "jax.numpy", "jaxlib",
                                    "repro", "repro.core"]
