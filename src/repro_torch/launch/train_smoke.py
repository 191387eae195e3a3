"""The training driver's smoke leg: every registered train-step flavor
trains, commits a checkpoint and resumes from it.

Counterpart of ``repro.launch.train_smoke``.  The sweep is derived from
the registry, never written out: every ``strategies_for("train_step")``
flavor on ``llama3.2-3b``, and ``lane_zero3`` once more on each family of
``family_smoke_archs(driver_trainable_only=True)`` (dense, moe, ssm,
hybrid), so a new registration joins the sweep and a lost one fails it.
Each cell drives ``launch.train.run`` twice with ``repro``'s argv
(``--smoke --batch 8 --seq 32 --ckpt D --ckpt-every 2 --log-every 1
--pods 2``): a fresh 2-step run that must commit step 2, then a 3-step
run that must restore it and commit step 3.  A raise, in either run, or
a checkpoint that is not there fails the cell; the exit code is the
number of failed cells.

  PYTHONPATH=src python -m repro_torch.launch.train_smoke --device cpu
  python -m repro_torch.launch.train_smoke            # one card, NCCL

On the CPU the sweep runs on one spawned gloo world of 4 ranks (2 pods x
2), kept up across the cells; on a card on one NCCL rank, each run on
the 1 x 1 topology (``launch.mesh.new_lane_topology(1, 1)``), where a
gather is a copy and a sync moves nothing but the kernels and the
layouts all run.  ``sweep`` is what both call, and what a caller with a
started world calls with its own topology.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys
import tempfile

__all__ = ["cells", "cell_argv", "run_cell", "sweep", "one_rank_world",
           "main"]

DENSE_ARCH = "llama3.2-3b"
CPU_RANKS = 4


def cells() -> list:
    """``[(name, strategy, family, arch)]``: every ``train_step`` flavor on
    the dense smoke arch, and ``lane_zero3`` on each driver-trainable
    family's."""
    import repro_torch.launch.steps  # noqa: F401 - registers train_step
    from repro_torch.comm import strategies_for
    from repro_torch.models.blockstack import family_smoke_archs
    fams = family_smoke_archs(driver_trainable_only=True)
    out = []
    for s in strategies_for("train_step"):
        if s == "lane_zero3":
            out += [(f"{s}[{fam}]", s, fam, arch) for fam, arch in
                    fams.items()]
        else:
            out.append((s, s, "dense", DENSE_ARCH))
    return out


def cell_argv(strategy: str, arch: str, ckpt: str, device: str,
              seq: int = 32, extra=()) -> list:
    """``repro``'s train-smoke argv, without ``--steps``."""
    return ["--arch", arch, "--smoke", "--batch", "8", "--seq", str(seq),
            "--ckpt", ckpt, "--ckpt-every", "2", "--log-every", "1",
            "--gradsync", strategy, "--pods", "2", *extra,
            "--device", device]


def run_cell(base: list, ckpt: str, *, topo=None, driver=None) -> list:
    """The fresh 2-step run and the resumed 3-step run of one cell;
    returns the resumed run's losses (step 3's alone).  Raises if either
    run raises or does not commit its last step."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train
    driver = driver or train.run
    driver([*base, "--steps", "2"], topo=topo)
    if latest_step(ckpt) != 2:
        raise RuntimeError(f"fresh run committed step {latest_step(ckpt)}, "
                           f"not 2")
    losses = driver([*base, "--steps", "3"], topo=topo)[0]
    if latest_step(ckpt) != 3 or len(losses) != 1:
        raise RuntimeError(f"resumed run committed step "
                           f"{latest_step(ckpt)} with {len(losses)} "
                           f"losses, not step 3 with 1")
    return losses


def _lead() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def sweep(root: str, *, device: str = "cpu", topo=None, driver=None,
          only=None) -> tuple:
    """Run every cell (``only``: those of ``cells()`` it names) with its
    checkpoints under ``root`` (the same directory on every rank), on the
    started world's topology ``topo`` (None: the one the driver makes).
    Returns ``(failed names, {name: the resumed step-3 loss})``; the
    lead rank prints ``repro``'s lines."""
    lead = _lead()
    fails, resumed = [], {}
    todo = [c for c in cells() if only is None or c[0] in only]
    for name, strategy, _, arch in todo:
        if lead:
            print(f"=== train-smoke {name} ===", flush=True)
        ck = os.path.join(root, name)
        try:
            resumed[name] = run_cell(cell_argv(strategy, arch, ck, device),
                                     ck, topo=topo, driver=driver)[0]
        except Exception as e:  # noqa: BLE001 - a failed cell is counted
            fails.append(name)
            if lead:
                print(f"FAIL {name}: {e!r}", flush=True)
        else:
            if lead:
                print(f"PASS {name}", flush=True)
    if lead:
        print(f"train-smoke: {len(todo) - len(fails)}/{len(todo)} cells OK"
              + (f"; FAILED {fails}" if fails else ""), flush=True)
    return fails, resumed


def _sweep_rank(root: str):
    """One rank of the CPU world: the sweep, on the driver's topology."""
    return sweep(root, device="cpu")


def one_rank_world(device: str, tmp: str):
    """Start a one-rank world for ``device`` (NCCL on a card; file
    rendezvous in the directory ``tmp``) and return its 1 x 1 topology."""
    from repro_torch.launch import mesh
    mesh.init_world(device, rank=0, world_size=1,
                    init_method=pathlib.Path(tmp, "rendezvous").as_uri())
    return mesh.new_lane_topology(1, 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train_smoke")
    ap.add_argument("--device", default="cuda",
                    help="cuda (one NCCL rank, the 1 x 1 topology) or cpu "
                         f"(a spawned gloo world of {CPU_RANKS} ranks)")
    args = ap.parse_args(argv)
    from repro_torch.launch import mesh
    with tempfile.TemporaryDirectory(prefix="train_smoke_") as root:
        if args.device == "cpu":
            fails = mesh.spawn(_sweep_rank, CPU_RANKS, root,
                               timeout=1800)[0][0]
        else:
            import torch.distributed as dist
            topo = one_rank_world(args.device, root)
            try:
                fails = sweep(root, device=args.device, topo=topo)[0]
            finally:
                dist.destroy_process_group()
    return len(fails)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
