"""The port stands alone: no JAX, no ``repro``, and no silent CPU fallback."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(
        "repro_torch" + "".join(
            f".{p}" for p in f.relative_to(PORT).with_suffix("").parts)
        .replace(".__init__", "")
        for f in PORT.rglob("*.py"))


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_runtime_is_covered():
    """The fault-tolerant runtime is part of the port, and so of the
    checks below."""
    names = set(_modules())
    assert {f"repro_torch.runtime.{m}" for m in (
        "faults", "watchdog", "health", "straggler", "elastic")} \
        | {"repro_torch.runtime"} <= names
    assert {f.name for f in FILES if f.parent.name == "runtime"} == {
        "__init__.py", "faults.py", "watchdog.py", "health.py",
        "straggler.py", "elastic.py"}


def test_the_tuner_is_covered():
    """Measured-cost tuning and the guideline timing are part of the
    port, and so of the checks below."""
    names = set(_modules())
    assert {f"repro_torch.tuning.{m}" for m in (
        "table", "store", "fit", "guideline_report", "probe",
        "tune_smoke")} | {"repro_torch.tuning",
                          "repro_torch.core.guidelines"} <= names
    assert {f.name for f in FILES if f.parent.name == "tuning"} == {
        "__init__.py", "table.py", "store.py", "fit.py",
        "guideline_report.py", "probe.py", "tune_smoke.py"}


def test_the_third_axis_is_covered():
    """Tensor and expert parallelism are part of the port, and so of the
    checks below."""
    from repro_torch.models import layers, moe, parallel
    assert "repro_torch.models.parallel" in set(_modules())
    assert {f.name for f in FILES if f.parent.name == "models"} >= {
        "parallel.py", "layers.py", "moe.py", "transformer.py"}
    for name in ("mlp_tp", "mlp_tp_reduce"):
        assert callable(getattr(layers, name))
    assert callable(moe.moe_block_ep)
    assert callable(parallel.parallel_context)


def test_the_lint_is_covered():
    """lanelint and the serving smoke leg are part of the port, and so of
    the checks below."""
    names = set(_modules())
    assert {f"repro_torch.analysis.{m}" for m in (
        "diagnostics", "baseline", "footprint", "rules", "steps", "astlint",
        "lint")} | {"repro_torch.analysis",
                    "repro_torch.serve.serve_smoke"} <= names
    assert {f.name for f in FILES if f.parent.name == "analysis"} == {
        "__init__.py", "diagnostics.py", "baseline.py", "footprint.py",
        "rules.py", "steps.py", "astlint.py", "lint.py"}
    from repro_torch.analysis.astlint import run_ast_rules
    assert run_ast_rules() == []


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_default_device_is_cuda_and_never_falls_back():
    """Entry points default to "cuda"; on a host without a card they
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the check is for CPU hosts")
    from repro_torch.configs import resolve
    from repro_torch.launch import train
    from repro_torch.launch.steps import init_train_state
    from repro_torch.models import init_cache, init_model
    from repro_torch.serve import ContinuousBatcher
    for arch in ("llama3.2-3b", "mamba2-780m", "granite-moe-3b-a800m",
                 "llava-next-mistral-7b", "whisper-large-v3"):
        cfg = resolve(arch, smoke=True)
        params = init_model(cfg, device="cpu")
        with pytest.raises(RuntimeError, match="cuda"):
            ContinuousBatcher(params, cfg, slots=2, max_seq=64)
        with pytest.raises(RuntimeError, match="cuda"):
            init_model(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            init_cache(cfg, 1, 64)
        with pytest.raises(RuntimeError, match="cuda"):
            init_train_state(params)
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--arch", arch, "--smoke", "--steps", "1"])
