"""The benchmark's core: find a cell's files by name, run its driver on
every rank, read the metrics and compose the result line.

Everything that belongs to one cell, configuration, traffic mix, driver
or metric is a file of its own that this module finds by the names in
``BENCHMARK.json``:

  perfbench/cells/<workload>.json        the cell: driver, step options,
                                         the limits of its comparison
  <configs entry's file>                 the configuration as it is run
  perfbench/traffic/<traffic>.json       the traffic mix's parameters
  perfbench/drivers/<driver>.py          ``run(ctx) -> record``
  perfbench/reference/<family>.py        the plain reference
  perfbench/end_to_end/<metric>.py       ``read(rec, ctx) -> value|None``
  perfbench/layer_metrics/<metric>.py    ``read(rec, ctx) -> value|None``

A cell on several chips runs one process a chip: this process is rank 0
and prints the result; ranks 1.. are started with ``multiprocessing``'s
spawn and rendezvous at a free local TCP port.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import multiprocessing as mp
import os
import pathlib
import socket
import sys
import threading
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_LOADED: dict = {}


def forbidden_modules(names=None) -> list:
    """The modules of ``names`` (default: those loaded in this process)
    whose top-level name is the JAX stack's or the JAX package's,
    compared whole: ``repro_torch`` is neither."""
    names = sys.modules if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file_module(path: pathlib.Path):
    """The module at ``path``, loaded once a process under a name of its
    own (the name-found files are not a package)."""
    path = pathlib.Path(path).resolve()
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no file {path}")
        name = "perfbench_found_" + "_".join(
            p.replace(".", "_").replace("-", "_") for p in path.parts[-2:])
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


@dataclasses.dataclass
class Context:
    """One rank's view of a run."""
    root: pathlib.Path
    manifest: dict
    workload: dict
    cell: dict
    config: dict
    traffic: dict
    family: object
    seed: int
    seconds: float
    trace: bool
    device_type: str
    rank: int = 0
    world: int = 1
    init_method: str = ""
    t_start: float = 0.0
    fault: str = ""
    control: bool = False

    def log(self, msg: str) -> None:
        if self.rank == 0:
            print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def find(root, name: str) -> dict:
    """(manifest, workload entry, cell, config, traffic, config entry)
    of the workload ``name`` under ``root``."""
    root = pathlib.Path(root)
    manifest = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(work)}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return {"manifest": manifest, "workload": w,
            "cell": load_json(root / "perfbench" / "cells" / f"{name}.json"),
            "config": load_json(root / cfg_entry["file"]),
            "traffic": load_json(root / "perfbench" / "traffic"
                                 / f"{w['traffic']}.json"),
            "config_entry": cfg_entry}


def make_context(root, name, seed, seconds, trace, device_type, *, rank=0,
                 world=1, init_method="", t_start=None, fault="") -> Context:
    f = find(root, name)
    root = pathlib.Path(root)
    family = load_file_module(root / "perfbench" / "reference"
                              / f"{f['config']['family']}.py")
    return Context(root=root, manifest=f["manifest"], workload=f["workload"],
                   cell=f["cell"], config=f["config"], traffic=f["traffic"],
                   family=family, seed=int(seed), seconds=float(seconds),
                   trace=bool(trace), device_type=device_type, rank=rank,
                   world=world, init_method=init_method,
                   t_start=time.time() if t_start is None else t_start,
                   fault=fault)


def metrics_of(ctx: Context, kind: str) -> list:
    """The manifest's metrics of ``kind`` (``end_to_end`` or
    ``per_layer``) that this cell reports."""
    name = ctx.workload["name"]
    e2e = [m["name"] for m in ctx.manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    out = []
    for m in ctx.manifest[kind]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def read_metrics(ctx: Context, rec: dict) -> dict:
    kind, folder = ("per_layer", "layer_metrics") if ctx.trace \
        else ("end_to_end", "end_to_end")
    out = {}
    for m in metrics_of(ctx, kind):
        reader = load_file_module(ctx.root / "perfbench" / folder
                                  / f"{m['name']}.py")
        value = reader.read(rec, ctx)
        if value is not None:
            if not math.isfinite(value):
                raise RuntimeError(f"{m['name']} read {value}")
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def compose(ctx: Context, rec: dict) -> dict:
    """The result line's object; ``checks`` comes last."""
    device = {"platform": "gpu" if ctx.device_type == "cuda"
              else ctx.device_type, "kind": rec["device_kind"],
              "count": ctx.world,
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    result = {"correct": rec["correct"], "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": read_metrics(ctx, rec),
              "device": device}
    if ctx.trace:
        device["busy_s"] = rec["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    result["checks"] = rec["checks"]
    return result


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _apply_fault(ctx: Context):
    if not ctx.fault:
        return contextlib.nullcontext()
    from perfbench import faults
    return faults.planted(ctx.fault)


def run_rank(ctx: Context) -> dict:
    driver = load_file_module(ctx.root / "perfbench" / "drivers"
                              / f"{ctx.cell['driver']}.py")
    with _apply_fault(ctx):
        return driver.run(ctx)


def _rank_main(args: dict) -> None:
    """Rank r > 0 of a several-chip cell: run, then refuse a JAX module."""
    parent = os.getppid()
    threading.Thread(target=_orphan_guard, args=(parent,),
                     daemon=True).start()
    ctx = make_context(**args)
    run_rank(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"rank {ctx.rank}: loaded {bad}", file=sys.stderr, flush=True)
        sys.exit(3)


def _orphan_guard(parent: int) -> None:
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(4)


def _watch(procs) -> None:
    """Rank 0 stops the run at once when another rank fails, rather than
    waiting in a collective for its timeout."""
    while True:
        for p in procs:
            if p.exitcode not in (None, 0):
                print(f"[perfbench] rank process {p.name} exited with "
                      f"{p.exitcode}", file=sys.stderr, flush=True)
                for q in procs:
                    if q.is_alive():
                        q.terminate()
                os._exit(1)
        if all(p.exitcode == 0 for p in procs):
            return
        time.sleep(0.5)


def run(root, name, seed, seconds, trace, device_type="cuda", *,
        t_start=None) -> dict:
    """Run the workload on as many processes as its cell's chips and
    return rank 0's record and result: ``(rec, result)``."""
    f = find(root, name)
    world = int(f["workload"]["chips"])
    init_method = ""
    procs = []
    if world > 1:
        init_method = f"tcp://127.0.0.1:{free_port()}"
        spawn = mp.get_context("spawn")
        for r in range(1, world):
            args = dict(root=str(root), name=name, seed=seed,
                        seconds=seconds, trace=trace,
                        device_type=device_type, rank=r, world=world,
                        init_method=init_method)
            p = spawn.Process(target=_rank_main, args=(args,),
                              name=f"rank{r}", daemon=True)
            p.start()
            procs.append(p)
        threading.Thread(target=_watch, args=(procs,), daemon=True).start()
    ctx = make_context(root, name, seed, seconds, trace, device_type,
                       world=world, init_method=init_method,
                       t_start=t_start)
    try:
        rec = run_rank(ctx)
    except BaseException:
        for p in procs:
            p.terminate()
        raise
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
    bad = [p.name for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"rank processes {bad} failed")
    return rec, compose(ctx, rec)
