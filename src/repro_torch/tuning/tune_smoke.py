"""tune-smoke: probe → persist → round-trip → fit → report.

Counterpart of ``repro.tuning.tune_smoke``.  Runs the whole tuning loop
end to end on the started world: probes the auto-eligible grad_sync /
allreduce / prefetch_allgather cells at the smoke ladder (``--full-ladder``
the full one), commits the TimingTable to ``--cache``, verifies that the
cache round-trips BIT-identically through save → load → save, fits HW
constants, and writes the decomposed-vs-native guideline report to
``--out``.  The defaults write under ``build/tuning/`` (relative to the
working directory).

Under ``torchrun`` the world is the launcher's (gloo on the CPU; 8 ranks
make ``repro``'s 2 pods × 4), laid out as 2 pods when the ranks are even
and more than one, else one; run alone, it starts a one-rank world of
its own (NCCL on ``--device cuda``, the default, gloo on ``cpu``; file
rendezvous under ``build/tuning/``), where p = 1 and the fit sees no lane
level.  The lead rank writes the files and prints.

Exit status is the verdict, on every rank: nonzero on a guideline
violation above tolerance, a broken round-trip, or a failed fit.

Usage: python -m repro_torch.tuning.tune_smoke [--cache PATH] [--out PATH]
           [--reps R] [--tolerance X] [--full-ladder] [--device DEV]
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.tuning.tune_smoke \\
      --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

import torch.distributed as dist

from repro_torch.launch import mesh
from repro_torch.tuning.fit import fit_hw
from repro_torch.tuning.guideline_report import DEFAULT_TOLERANCE, \
    build_report
from repro_torch.tuning.probe import DEFAULT_LADDER, SMOKE_LADDER, \
    probe_cells
from repro_torch.tuning.store import load_timing_table, save_timing_table

OUT_DIR = pathlib.Path("build") / "tuning"


def roundtrip_identical(cache: pathlib.Path, table) -> bool:
    """The cache is a pure function of its entries: load(cache) holds
    ``table``'s entries and save(load(cache)) writes ``cache``'s bytes."""
    restored = load_timing_table(cache)
    if restored.to_doc() != table.to_doc():
        return False
    second = pathlib.Path(str(cache) + ".roundtrip")
    save_timing_table(second, restored)
    try:
        return second.read_bytes() == cache.read_bytes()
    finally:
        second.unlink()


def tune(topo, *, device, cache, out, reps=5, tolerance=DEFAULT_TOLERANCE,
         ladder=SMOKE_LADDER, lead=True) -> tuple:
    """The loop on ``topo`` (every rank calls it): (exit code, table, fit,
    report, probe seconds).  The lead rank writes ``cache`` and ``out``,
    checks the round trip and prints; the exit code is the lead's,
    agreed by every rank."""
    t0 = time.perf_counter()
    table = probe_cells(topo, device=device, ladder=ladder, reps=reps,
                        verbose=lead)
    probe_s = time.perf_counter() - t0
    rc, fit, report = 0, None, None
    if lead:
        print(f"probed {len(table)} cells on {table.signatures()} in "
              f"{probe_s:.2f} s", flush=True)
        cache = save_timing_table(cache, table)
        if not roundtrip_identical(cache, table):
            print("FAIL: cache bytes not reproducible across "
                  "save/load/save", flush=True)
            rc = 1
        else:
            print(f"cache committed: {cache} ({os.path.getsize(cache)} B, "
                  f"round-trip bit-identical)", flush=True)
    try:
        fit = fit_hw(table)
    except ValueError as e:
        if lead:
            print(f"FAIL: {e}", flush=True)
        rc = 1
    if fit is not None:
        report = build_report(table, tolerance=tolerance, fit=fit)
        if lead:
            report_fit(fit, report, out)
        rc = rc or (0 if report["ok"] else 1)
    if dist.get_world_size(topo.group) > 1:
        agreed = [rc]
        dist.broadcast_object_list(agreed, src=topo.ranks[0],
                                   group=topo.group)
        rc = agreed[0]
    return rc, table, fit, report, probe_s


def report_fit(fit, report, out) -> None:
    print(f"fit: alpha_node={fit.params['alpha_node']:.3e}s "
          f"alpha_lane={fit.params['alpha_lane']:.3e}s "
          f"node_bw={fit.hw.node_bw:.3e}B/s lane_bw={fit.hw.lane_bw:.3e}B/s "
          f"residual_rms={fit.residual_rms_us:.1f}us "
          f"residual_max={fit.residual_max_us:.1f}us "
          f"over {fit.num_cells} cells", flush=True)
    if fit.blind:
        print(f"fit: no cell moves bytes over the {' or '.join(fit.blind)} "
              f"level (p = 1 has no lane level), so its constants are the "
              f"floors; nothing is read from them", flush=True)
    out = pathlib.Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    for c in report["cells"]:
        mark = "OK " if c["status"] == "ok" else "VIOLATION"
        print(f"  {mark} {c['collective']:18s} {c['payload_bytes']:>9d}B "
              f"native={c['native_us']:9.1f}us best "
              f"{c['best_strategy']:15s}={c['best_decomposed_us']:9.1f}us "
              f"ratio={c['ratio']:.2f}", flush=True)
    print(f"wrote {out}: {len(report['cells'])} cells, "
          f"{report['violations']} violation(s), ok={report['ok']}",
          flush=True)


def _start_world(device: str):
    """(device, whether the world was started here, the rendezvous file of
    a one-rank world or None): the launcher's world, or a one-rank world
    of this process."""
    if dist.is_initialized():
        return mesh.init_world(device), False, None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return mesh.init_world(device), True, None
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    init = (OUT_DIR / f"rendezvous_{os.getpid()}_{time.time_ns()}").resolve()
    return mesh.init_world(device, rank=0, world_size=1,
                           init_method=init.as_uri()), True, init


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache", default=str(OUT_DIR / "tuning_cache.json"),
                    help="timing-cache file to write")
    ap.add_argument("--out", default=str(OUT_DIR / "tuning_report.json"),
                    help="guideline report to write")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE)
    ap.add_argument("--full-ladder", action="store_true",
                    help="probe the full payload ladder (default: smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev, owns, init = _start_world(args.device)
    try:
        world = dist.get_world_size()
        pods = 2 if world > 1 and world % 2 == 0 else 1
        topo = mesh.new_lane_topology(world // pods, pods)
        rc = tune(topo, device=dev, cache=args.cache, out=args.out,
                  reps=args.reps, tolerance=args.tolerance,
                  ladder=DEFAULT_LADDER if args.full_ladder
                  else SMOKE_LADDER,
                  lead=topo.global_rank() == 0)[0]
    finally:
        if owns:
            dist.destroy_process_group()
        if init is not None:
            init.unlink(missing_ok=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
