"""The readings that a cell's limits are set from, on the card.

  python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
      [--control-seeds 1,2] [--faults half_batch,altered] \\
      [--fault-seeds 1,2] [--out chiprun_out/calibrate.jsonl]

For each seed it takes the cell's checked steps with the program and the
reference, as a run does, without the window, and prints the numbers of
``compare.gaps`` for the program (the lower readings), for the control
(the reference in float8 in the program's place, on the control seeds:
the upper readings) and for each planted fault (``faults.py``) on the
fault seeds.  One JSON object a line, on standard output and in
``--out``.  The benchmark's own runs do not run it.  A cell on several
chips runs each item on a world of its own.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def _ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x.strip()]


def items(args) -> list:
    out = [(s, "", s in args.control_seeds) for s in args.seeds]
    out += [(s, f, False) for f in args.faults for s in args.fault_seeds]
    return out


def rank_loop(root, args, rank, world, ports, device_type, out=None):
    """Every item on this rank, each on a world of its own (the driver
    starts it at the item's port and ends it, so that no communicator
    outlives its item); rank 0 returns the lines and appends each to
    ``out`` as it comes."""
    from perfbench import compare, harness
    lines = []
    for (seed, fault, control), port in zip(items(args), ports):
        ctx = harness.make_context(
            root, args.workload, seed, 0, False, device_type, rank=rank,
            world=world, init_method=f"tcp://127.0.0.1:{port}" if port
            else "", fault=fault)
        ctx.control = control
        rec = harness.run_rank(ctx)
        sides = [("program" if not fault else fault, rec["program"])]
        if control:
            sides.append(("control", rec["control"]))
        for side, got in sides:
            g = compare.gaps(got, rec["reference"],
                             ctx.cell.get("loss_steps"))
            line = {"workload": args.workload, "seed": seed, "side": side,
                    "device": rec["device_kind"],
                    **{k: v[0] for k, v in g.items()},
                    "at": {k: v[1] for k, v in g.items()},
                    "step_loss_gaps": [
                        abs(p - r) / abs(r) for p, r in zip(
                            got["losses"], rec["reference"]["losses"])],
                    "losses": got["losses"],
                    "ref_losses": rec["reference"]["losses"]}
            lines.append(line)
            if rank == 0:
                print(json.dumps(line), flush=True)
                if out is not None:
                    with open(out, "a") as f:
                        f.write(json.dumps(line) + "\n")
    return lines


def _child(root, args, rank, world, ports, device_type):
    rank_loop(root, args, rank, world, ports, device_type)


def main(argv=None, root=ROOT, device_type="cuda") -> list:
    ap = argparse.ArgumentParser(prog="python3 perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default=[],
                    type=lambda s: [x for x in s.split(",") if x])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from perfbench import harness
    world = int(harness.find(root, args.workload)["workload"]["chips"])
    ports = [harness.free_port() if world > 1 else 0 for _ in items(args)]
    procs = []
    if world > 1:
        spawn = mp.get_context("spawn")
        procs = [spawn.Process(target=_child, daemon=True,
                               args=(str(root), args, r, world, ports,
                                     device_type)) for r in range(1, world)]
        for p in procs:
            p.start()
    out = None
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
    try:
        lines = rank_loop(root, args, 0, world, ports, device_type, out)
    except BaseException:
        for p in procs:
            p.terminate()
        raise
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
    return lines


if __name__ == "__main__":
    main()
