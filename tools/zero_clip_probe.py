#!/usr/bin/env python3
"""What tells ZeRO's bf16 losses apart from their witnesses', on one CUDA
card: ``chip_smoke.py`` phase 9b's runs (``chip_smoke.zero_run`` on a
one-rank NCCL world, full width, 5 AdamW steps of 4 x 1024 tokens from
seed 0), every step's loss printed in full.

Run from the root of a checkout:

    python3 tools/zero_clip_probe.py

1. mamba2-780m replicated, "masters" and lane_zero3 with AdamW's clip
   (norm 1.0), each twice: whether a run repeats itself bit for bit.
2. The same three runs with the clip off (``clip_norm=inf``; the norm
   is still computed), and llama3.2-3b replicated, lane_zero1,
   "masters", lane_zero3, blocking and regather: whether the pairs that
   9b gates (lane_zero1 and the replicated step; lane_zero3 and
   "masters"; its modes and lane_zero3) are then equal, so that the clip
   norm's sum, taken in another order by each layout, is what parts
   them with the clip on.
"""
from __future__ import annotations

import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def runs(topo, arch, modes, opt):
    for mode in modes:
        torch.cuda.empty_cache()
        cfg = cs.resolve(arch)
        t0 = time.perf_counter()
        losses, _, _, _ = cs.zero_run(
            cfg, mode, topo, cs.init_model(cfg, seed=0, device="cuda"),
            steps_n=cs.ZERO_STEPS, batch=cs.TRAIN_BATCH, seq=cs.TRAIN_SEQ,
            device="cuda", opt=opt, full=False)
        print(f"P9X {arch} {mode} clip={opt.clip_norm}: "
              f"{[repr(x) for x in losses]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


def main() -> int:
    t0 = time.perf_counter()
    with torch.no_grad():
        cs.timed("device", cs.phase_device)
        cs.timed("build", cs.phase_build)
        topo, init = cs.phase_lane_world()
        try:
            with torch.enable_grad():
                opt = cs.AdamWConfig(warmup_steps=1,
                                     total_steps=cs.ZERO_STEPS)
                runs(topo, "mamba2-780m", ["replicated", "replicated",
                                           "masters", "masters",
                                           "lane_zero3", "lane_zero3"], opt)
                nc = cs.AdamWConfig(warmup_steps=1,
                                    total_steps=cs.ZERO_STEPS,
                                    clip_norm=float("inf"))
                runs(topo, "mamba2-780m", ["replicated", "masters",
                                           "lane_zero3"], nc)
                runs(topo, "llama3.2-3b", ["replicated", "lane_zero1",
                                           "masters", "lane_zero3",
                                           "blocking", "regather"], nc)
        finally:
            cs.dist.destroy_process_group()
            init.unlink(missing_ok=True)
    cs.log("time", f"total: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
