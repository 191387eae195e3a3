"""lanelint layer 2 — architectural AST rules over ``src/repro_torch/**``.

Counterpart of ``repro.analysis.astlint``.  Where layer 1 proves the
ISSUED communication is the paper's, this layer keeps the SOURCE honest
about how it gets there:

  A0  every module parses.
  A1  no raw collectives outside the communication layers — every
      ``torch.distributed`` communication call (``RAW_COLLECTIVES``,
      written ``dist.<name>``, ``torch.distributed.<name>`` or as a bare
      name imported ``from torch.distributed``) must live in ``comm/``,
      ``core/`` or the explicit whitelist below.  Everything else goes
      through ``LaneComm`` so the registry, dispatch and lanelint see
      it; and a bare imported name would also escape the recorder,
      which replaces the module attribute.  Group creation and rank
      queries are not collectives.
  A2  no user-facing control flow on bare ``assert`` — ``python -O``
      strips asserts, so input validation must raise.  (The reference
      oracles and the lint itself are exempt.)
  A3  no wall-clock or unseeded randomness in the seeded-determinism
      modules (``serve/sampling``, ``serve/prng``, ``runtime/faults``,
      ``data/``): ``time.time*``, legacy ``numpy.random.*`` globals, a
      zero-arg ``default_rng()``, and torch's global-RNG draws without a
      ``generator=`` all break replay.
  A4  every ``register_impl`` cell is priced or explicitly opts out:
      the call must pass ``cost=`` or a literal ``auto_ok=False`` —
      an unpriced auto-eligible cell would silently never win (or worse,
      win by registration-order accident) in auto dispatch.

Pure stdlib ``ast``: the AST leg runs anywhere in milliseconds.
"""
from __future__ import annotations

import ast
import os
from typing import Iterable, Optional

from .diagnostics import Finding
from .footprint import RAW_COLLECTIVES

__all__ = ["run_ast_rules", "iter_source_files", "lint_file",
           "RAW_COLLECTIVES", "A1_ALLOWED_DIRS", "A1_FILE_WHITELIST",
           "A2_EXEMPT", "A3_SCOPE", "TORCH_RNG"]

#: directories (relative to the repro_torch package) allowed raw
#: collectives
A1_ALLOWED_DIRS = ("comm", "core")

#: file → why it may call raw collectives
A1_FILE_WHITELIST = {
    "optim/gradsync.py": "gradient-sync stage library: the node/lane "
                         "stage primitives the registry cells compose",
    "launch/mesh.py": "world setup: the spawned ranks' closing barrier",
    "launch/steps.py": "step assembly: the scalar loss/grad-norm "
                       "reductions of the step skeleton, the TP "
                       "gradient sums over the model group and the "
                       "checkpoint gathers to the lead (payload comm "
                       "goes through LaneComm)",
    "launch/train.py": "training loop: the SIGTERM flag reduction, the "
                       "cache broadcast and the barriers over the job's "
                       "flag group",
    "runtime/straggler.py": "quorum machinery: masked lane sums are the "
                            "fault-detection protocol itself",
    "tuning/probe.py": "probe harness: the fences and the slowest-rank "
                       "reduction around registry cells under "
                       "measurement",
    "tuning/tune_smoke.py": "tuning entry point: the lead's table "
                            "broadcast to the other ranks",
}

#: files/dirs exempt from A2 (bare asserts fine: never ships user input)
A2_EXEMPT = ("core/ref.py", "analysis")

#: seeded-determinism scope for A3
A3_SCOPE = ("serve/sampling.py", "serve/prng.py", "runtime/faults.py",
            "data")

#: torch's global-RNG draws: banned in A3's scope without ``generator=``
TORCH_RNG = frozenset({"rand", "randn", "randint", "randperm", "normal",
                       "bernoulli", "multinomial"})

_TIME_BANNED = frozenset({"time", "time_ns"})


def _pkg_root() -> str:
    """Absolute path of the ``repro_torch`` package directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _under(rel: str, prefixes: Iterable[str]) -> bool:
    for p in prefixes:
        if rel == p or rel.startswith(p.rstrip("/") + "/"):
            return True
    return False


def iter_source_files(root: Optional[str] = None):
    """(abs_path, package-relative posix path) of every port module."""
    root = root or _pkg_root()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            ap = os.path.join(dirpath, fn)
            yield ap, os.path.relpath(ap, root).replace(os.sep, "/")


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target ('dist.all_reduce', …)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _dist_names(tree: ast.Module) -> tuple:
    """(the names this module binds to ``torch.distributed``, the
    collectives it imported from it by name)."""
    modules, bare = {"torch.distributed"}, set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    modules.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if node.module == "torch" and a.name == "distributed":
                    modules.add(a.asname or a.name)
                elif node.module == "torch.distributed" \
                        and a.name in RAW_COLLECTIVES:
                    bare.add(a.asname or a.name)
    return modules, bare


def _check_a1(tree: ast.Module, rel: str, target_file: str) -> list:
    if _under(rel, A1_ALLOWED_DIRS) or rel in A1_FILE_WHITELIST:
        return []
    modules, bare = _dist_names(tree)
    hits: dict = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = None
        if isinstance(node.func, ast.Attribute):
            head, _, leaf = _dotted(node.func).rpartition(".")
            if leaf in RAW_COLLECTIVES and head in modules:
                name = leaf
        elif isinstance(node.func, ast.Name) and node.func.id in bare:
            name = node.func.id
        if name:
            hits.setdefault(name, []).append(node.lineno)
    return [
        Finding("A1", f"{target_file}#{name}",
                f"raw collective `{name}` called at line(s) "
                f"{sorted(lines)} outside comm/core and the whitelist — "
                f"route it through LaneComm so dispatch, tuning and "
                f"lanelint all see it")
        for name, lines in sorted(hits.items())]


def _check_a2(tree: ast.Module, rel: str, target_file: str) -> list:
    if _under(rel, A2_EXEMPT):
        return []
    lines = [n.lineno for n in ast.walk(tree)
             if isinstance(n, ast.Assert)]
    if not lines:
        return []
    return [Finding(
        "A2", f"{target_file}#assert",
        f"bare assert at line(s) {sorted(lines)} — `python -O` strips "
        f"asserts, so validation that guards user-facing behavior must "
        f"raise (ValueError/RuntimeError) instead")]


def _check_a3(tree: ast.Module, rel: str, target_file: str) -> list:
    if not _under(rel, A3_SCOPE):
        return []
    hits: dict = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        head, _, leaf = dotted.rpartition(".")
        if head == "time" and leaf in _TIME_BANNED:
            hits.setdefault(dotted, []).append(node.lineno)
            continue
        if head == "torch" and leaf in TORCH_RNG:
            # a draw from an explicit torch.Generator is seeded
            if not any(k.arg == "generator" for k in node.keywords):
                hits.setdefault(dotted, []).append(node.lineno)
            continue
        # the ban is the stdlib global RNG and numpy's legacy globals
        legacy = head in ("np.random", "numpy.random", "random")
        if legacy and leaf == "default_rng":
            if not node.args and not node.keywords:
                hits.setdefault(dotted + "()", []).append(node.lineno)
        elif legacy:
            hits.setdefault(dotted, []).append(node.lineno)
    return [
        Finding("A3", f"{target_file}#{name}",
                f"`{name}` at line(s) {sorted(lines)} in a "
                f"seeded-determinism module — wall-clock/unseeded "
                f"randomness breaks replay; thread an explicit seed or "
                f"clock through the call")
        for name, lines in sorted(hits.items())]


def _check_a4(tree: ast.Module, rel: str, target_file: str) -> list:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted.rpartition(".")[2] != "register_impl":
            continue
        cell = "/".join(
            a.value for a in node.args[:2]
            if isinstance(a, ast.Constant) and isinstance(a.value, str))
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        priced = "cost" in kw
        opted_out = isinstance(kw.get("auto_ok"), ast.Constant) \
            and kw["auto_ok"].value is False
        if not (priced or opted_out):
            out.append(Finding(
                "A4", f"{target_file}#{cell or 'register_impl'}",
                f"register_impl({cell or '?'}) at line {node.lineno} "
                f"has neither cost= nor a literal auto_ok=False — an "
                f"unpriced auto-eligible cell wins or loses dispatch by "
                f"registration-order accident"))
    return out


def lint_file(abs_path: str, rel: str, *, src_prefix: str) -> list:
    with open(abs_path, encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=abs_path)
    except SyntaxError as e:
        return [Finding("A0", f"{src_prefix}{rel}",
                        f"unparseable module: {e}")]
    target_file = f"{src_prefix}{rel}"
    return (_check_a1(tree, rel, target_file)
            + _check_a2(tree, rel, target_file)
            + _check_a3(tree, rel, target_file)
            + _check_a4(tree, rel, target_file))


def run_ast_rules(root: Optional[str] = None) -> list:
    """A0–A4 over every module of the repro_torch package."""
    findings = []
    for abs_path, rel in iter_source_files(root):
        findings += lint_file(abs_path, rel, src_prefix="src/repro_torch/")
    return findings
