"""The third parallelism axis through the training driver: tensor and
expert parallelism train, checkpoint and resume.

Counterpart of ``repro.launch.tp_smoke``, with its five ``CELLS``:
``--model-parallel 2`` (the MLP's activation collectives over each model
group, ``models.layers.mlp_tp``) on ``llama3.2-3b`` under the replicated
``lane`` step and under ``lane_zero3``, and ``--expert-parallel`` (the
MoE's tokens routed by the ``moe_route`` all-to-all,
``models.moe.moe_block_ep``) on ``dbrx-132b`` under ``lane`` and under
``lane_zero3``, the latter also with ``--ep-blocks 2``.  Each cell is a
fresh 2-step run that commits a checkpoint and a resumed 3-step run that
must restore it (``launch.train_smoke.run_cell``, ``--seq 16``); the
exit code is the number of failed cells.

  PYTHONPATH=src python -m repro_torch.launch.tp_smoke --device cpu

On the CPU the cells run on one spawned gloo world of 8 ranks (2 pods x
2 x tp 2 for the TP cells; the EP cells lay the same 8 ranks out as 2
pods of 4).  On a card, :func:`run_tp_cell` runs one cell on a started
world with its topology; a TP cell needs as many GPUs as its degree
(NCCL refuses two ranks on one GPU) and raises on fewer, so one card
runs the three EP cells at p = 1.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

__all__ = ["CELLS", "EP_CELLS", "run_tp_cell", "sweep", "main"]

# (name, arch, gradsync, extra args), repro's table
CELLS = [
    ("tp2_lane[dense]", "llama3.2-3b", "lane", ["--model-parallel", "2"]),
    ("tp2_zero3[dense]", "llama3.2-3b", "lane_zero3",
     ["--model-parallel", "2"]),
    ("ep_lane[moe]", "dbrx-132b", "lane", ["--expert-parallel"]),
    ("ep_zero3[moe]", "dbrx-132b", "lane_zero3", ["--expert-parallel"]),
    ("ep_zero3_blocks2[moe]", "dbrx-132b", "lane_zero3",
     ["--expert-parallel", "--ep-blocks", "2"]),
]
EP_CELLS = tuple(c[0] for c in CELLS if "--expert-parallel" in c[3])
CPU_RANKS = 8


def _tp_degree(extra) -> int:
    return int(extra[extra.index("--model-parallel") + 1]) \
        if "--model-parallel" in extra else 1


def run_tp_cell(name: str, root: str, *, device: str = "cuda",
                topo=None) -> list:
    """One cell of ``CELLS`` on the started world (``topo``: its topology,
    None for the one the driver makes), checkpoints under ``root``;
    returns the resumed run's losses and raises on a failure, or where
    the world has fewer ranks than the cell's TP degree."""
    import torch.distributed as dist
    from repro_torch.launch.train_smoke import cell_argv, run_cell
    _, arch, gradsync, extra = next(c for c in CELLS if c[0] == name)
    tp = _tp_degree(extra)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < tp:
        raise ValueError(
            f"{name} needs --model-parallel {tp} ranks in a model group; "
            f"this world has {world} (one rank a GPU: NCCL refuses two "
            f"ranks of one communicator on one GPU)")
    ck = os.path.join(root, name)
    return run_cell(cell_argv(gradsync, arch, ck, device, 16, extra), ck,
                    topo=topo)


def sweep(root: str, *, device: str = "cpu", topo=None, only=None) -> list:
    """Every cell (``only``: those it names); returns the failed names,
    the lead rank printing ``repro``'s lines."""
    import torch.distributed as dist
    lead = not dist.is_initialized() or dist.get_rank() == 0
    todo = [c[0] for c in CELLS if only is None or c[0] in only]
    fails = []
    for name in todo:
        if lead:
            print(f"=== tp-smoke {name} ===", flush=True)
        try:
            run_tp_cell(name, root, device=device, topo=topo)
        except Exception as e:  # noqa: BLE001 - a failed cell is counted
            fails.append(name)
            if lead:
                print(f"FAIL {name}: {e!r}", flush=True)
        else:
            if lead:
                print(f"PASS {name}", flush=True)
    if lead:
        print(f"tp-smoke: {len(todo) - len(fails)}/{len(todo)} cells OK"
              + (f"; FAILED {fails}" if fails else ""), flush=True)
    return fails


def _sweep_rank(root: str):
    return sweep(root, device="cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.tp_smoke")
    ap.add_argument("--device", default="cuda",
                    help="cpu (a spawned gloo world of 8 ranks) or cuda "
                         "(one NCCL rank: the EP cells)")
    args = ap.parse_args(argv)
    from repro_torch.launch import mesh
    with tempfile.TemporaryDirectory(prefix="tp_smoke_") as root:
        if args.device == "cpu":
            fails = mesh.spawn(_sweep_rank, CPU_RANKS, root,
                               timeout=1800)[0]
        else:
            import torch.distributed as dist
            from repro_torch.launch.train_smoke import one_rank_world
            topo = one_rank_world(args.device, root)
            try:
                fails = sweep(root, device=args.device, topo=topo,
                              only=EP_CELLS)
            finally:
                dist.destroy_process_group()
    return len(fails)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
