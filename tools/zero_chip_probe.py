#!/usr/bin/env python3
"""Two probes behind ``chip_smoke.py`` phase 9's gates, on one CUDA card.

Run from the root of a checkout:

    python3 tools/zero_chip_probe.py

1. CUDA division by a Python number: PyTorch computes ``x / 127.0`` on a
   CUDA tensor as ``x * (1 / 127)``; the count of f32 quotients (of 4 M
   bf16-valued elements) that differ from the CPU's, and the same with
   the divisor a 0-d tensor on the card (``optim/gradsync.py``'s
   ``compress_int8`` divides so).
2. How far ZeRO training departs from the replicated step in bf16:
   llama3.2-3b (replicated, lane_zero1, lane_zero3) and mamba2-780m
   (replicated, lane_zero3) at full width, 5 AdamW steps of 4 x 1024
   tokens from seed 0, under three schedules (lr 3e-4 with phase 7c's
   warmup of 4 in 20 steps, lr 1e-4 and lr 3e-5 with a warmup of 1):
   every step's loss and its relative distance from the replicated
   step's, through ``chip_smoke.zero_run`` on a one-rank NCCL world.
"""
from __future__ import annotations

import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

SCHEDULES = {
    "lr 3e-4, warmup 4 of 20": cs.AdamWConfig(warmup_steps=4,
                                               total_steps=20),
    "lr 1e-4, warmup 1 of 5": cs.AdamWConfig(lr=1e-4, warmup_steps=1,
                                              total_steps=5),
    "lr 3e-5, warmup 1 of 5": cs.AdamWConfig(lr=3e-5, warmup_steps=1,
                                              total_steps=5),
}
RUNS = (("llama3.2-3b", ("replicated", "lane_zero1", "lane_zero3")),
        ("mamba2-780m", ("replicated", "lane_zero3")))


def division_probe() -> None:
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(1 << 22, generator=g) * 1e-3).to(torch.bfloat16).float()
    cpu = x / 127.0
    by_number = (x.cuda() / 127.0).cpu()
    by_tensor = (x.cuda() / torch.full((), 127.0, device="cuda")).cpu()
    print(f"[probe] x / 127.0: {int((by_number != cpu).sum())} of "
          f"{x.numel()} quotients on the card differ from the CPU's; "
          f"divided by a 0-d tensor on the card: "
          f"{int((by_tensor != cpu).sum())}", flush=True)


def main() -> int:
    t0 = time.perf_counter()
    name = cs.phase_device()
    cs.phase_build()
    division_probe()
    topo, init = cs.phase_lane_world()
    try:
        with torch.enable_grad():
            for arch, modes in RUNS:
                cfg = cs.resolve(arch)
                for sched, opt in SCHEDULES.items():
                    ref = None
                    for mode in modes:
                        torch.cuda.empty_cache()
                        losses, sec, _, _ = cs.zero_run(
                            cfg, mode, topo,
                            cs.init_model(cfg, seed=0, device="cuda"),
                            steps_n=cs.ZERO_STEPS, batch=cs.TRAIN_BATCH,
                            seq=cs.TRAIN_SEQ, device="cuda", opt=opt,
                            full=False)
                        ref = ref or losses
                        rel = [abs(a - b) / abs(b) for a, b in
                               zip(losses, ref)]
                        print(f"[drift] {name} | {arch} {sched} {mode}: "
                              f"losses {[round(v, 5) for v in losses]}, "
                              f"relative to the replicated step's "
                              f"{['%.2e' % r for r in rel]}", flush=True)
    finally:
        cs.dist.destroy_process_group()
        init.unlink(missing_ok=True)
    print(f"[time] total: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
