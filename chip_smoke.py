#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each printing its own lines and its seconds; any failure raises
and the script exits non-zero:

  1. device: require CUDA, print the card's name and power limit;
  2. build K1 (``csrc/flash_attention.cu``) and K2 (``csrc/ssd.cu``) with
     nvcc, both at once, and print each kernel's registers and spills
     from ptxas;
  3. hold K1 against its plain PyTorch version on the card (the kernel
     tests' shapes, the prefill shapes of llama3.2-3b, zamba2-7b,
     granite-moe-3b-a800m and llava-next-mistral-7b (576 vision tokens
     plus the prompt), whisper-large-v3's encoder (Tq = Tk = 1500,
     non-causal) and cross-attention (Tq 32 and 512 against 1500 frames),
     Tq != Tk with a window at hd 112, granite-34b's G=48 with one K/V
     head (T = 512, 792) and h2o-danube-3-4b's hd 120 with its window of
     4096 at T = 512 and at T = 4300, where the window masks keys) at
     2e-5 (f32) / 2e-2 (bf16);
  4. hold K2, y and final state, against its plain chunked version on the
     card (the kernel tests' shapes, mamba2-780m's and zamba2-7b's prefill
     shapes at T in {3, 64, 387, 512, 792}, with and without an initial
     state, the model's dt/A with an initial state at T=792) at 1e-4
     (f32) / 5e-2 (bf16);
  5. for each of llama3.2-3b, mamba2-780m, zamba2-7b, granite-moe-3b-
     a800m, llava-next-mistral-7b, whisper-large-v3, granite-34b and
     h2o-danube-3-4b at full width (bf16, random weights from seed 0):
     serve 8 ``mixed`` requests through ``ContinuousBatcher`` (4 slots,
     max_seq 1024; llava 1600, so that 1024 positions follow its 576
     vision tokens; whisper 448, its decoder's context; danube 4352, for
     a ninth request whose 4300-token prompt prefills past its window of
     4096; greedy) with the kernels' launch counts set to 0 just before
     and read just after, check every request's tokens and that each
     kernel ran once per layer that uses it and prefill (K1 three times
     per whisper decoder layer and prefill: encoder, self, cross), print
     the peak memory and granite-moe's share of dropped (token, expert)
     assignments per prefill, and check the cached prefill and first
     decode logits against the no-cache forward beside a negative
     control that must miss the tolerance (llama3.2-3b and whisper in
     bf16; the recurrent models, granite-moe, llava and danube in f32,
     same seed, granite-34b in f32 cut to 4 of its 88 layers, their bf16
     numbers printed: see LOGIT_TOL).  After llama3.2-3b, serve its
     requests sampled (seeded, two temperatures), batched at 4 slots and
     request by request: the tokens must be identical; and check that
     the sampler's threefry gives the same bits on the card as on the
     CPU;
  6. for each model: time prefill, a decode step at 4 slots, one traced
     prefill and decode step (device busy time, idle share, operations
     launched); K1 at T=512 beside its bound, its plain version and
     ``scaled_dot_product_attention`` (llama3.2-3b's and zamba2-7b's
     shapes; llava's at T = 576 + 512, whisper's encoder, T = 1500
     non-causal, granite-34b's (G=48) and danube's at T=512 and 4300 with
     its window also); K2 at T=512 beside its bound and its plain version (no
     single PyTorch call computes it; mamba2-780m's and zamba2-7b's
     shapes, the first in the JSON line).  Each kernel and SDPA is timed
     two ways: host+device, 50 back-to-back calls between two CUDA events
     (the wrapper's host work included; the JSON line's ``ms``), and
     device time per launch, the sum of the CUDA kernel rows the
     profiler records for 20 calls (K2's three kernels together).  A
     profiler session that records no device kernel, or a kernel fewer
     times than the calls launched it, is run again, twice at most;
     after that the device time comes from CUDA events around
     20 calls queued behind a sleep kernel, and the line says so.  That
     queued time is printed beside the profiler's in every case, as
     ``queued``;
  7. training, under autograd (phases 1-6 run without it):
     (a) K1's and K2's ``torch.autograd.Function``s against autograd of
     their plain versions, forward and every input's gradient, f32 and
     bf16 (K1 at llama3.2-3b's T=1024 causal, whisper-large-v3's encoder
     and its cross-attention against 1500 frames, zamba2-7b's hd 112 and
     h2o-danube-3-4b's hd 120 with its window at T=4300; K2 at
     mamba2-780m's T=1024 with the model's dt/A, where ``repro``'s scan
     has NaN gradients, with and without an initial state), and the plain
     attention backward's device time at llama3.2-3b's training shape;
     (b) one train step of llama3.2-3b and mamba2-780m at full width cut
     to 2 layers, f32, on the card and on the CPU from the same weights:
     the loss, every gradient leaf and the parameters after one AdamW
     update, each beside a negative control (the labels shifted by one
     position) that must miss the gate;
     (c) 20 bf16 steps of each at full width, 4 x 1024 tokens, through
     ``launch.train.main`` on SyntheticLM (seed 0), with the launch counts
     set to 0 just before and read just after (K1 once per layer and step,
     K2 the same): every loss finite, the last below the first; step ms
     (median of steps 3-20, each synchronised), tokens/s, ``train_mfu``
     (model FLOPs over the bf16 dense peak, on a line of its own), peak
     memory, and the last step traced: device busy, idle share, device
     operations, the forward / backward / optimizer split, and per layer
     the kernel's forward and its backward's device time;
  8. the node/lane collectives and the gradient sync (``core``,
     ``comm``, ``optim/gradsync.py``, ``launch/mesh.py``):
     (a) a torch.distributed world over NCCL through ``launch.mesh``, file
     rendezvous under build/: one process on cuda:0, so p = n = N = 1
     with one card visible (NCCL across several cards is not checked);
     (b) every collective, lane, native and pipelined, in f32, bf16 and
     int32 at odd leading dims, against ``core.ref``'s oracles, exactly
     (at p = 1 the NCCL code path, not the multi-rank semantics);
     (c) the gradients of one bf16 llama3.2-3b step at 4 x 1024 tokens
     through ``LaneComm.grad_sync`` with native, lane, lane_pipelined (the
     cost model's K, and K=1) and lane_int8: each one's device time (CUDA
     events), peak memory above the gradients (at most one flat f32 copy
     for lane and lane_pipelined), K and device operations; lane and
     lane_pipelined bit-identical to native; lane_int8 within half a
     quantization step per 1024-element chunk (the bf16 cast on top), its
     relative error printed, and its bucket 0 wire bytes equal to the
     CPU's;
     (d) on the CPU with gloo, not the card: 4 spawned ranks (2 pods x 2)
     train llama3.2-3b --smoke 3 steps with --gradsync lane
     --gradsync-buckets 4; the losses equal the one-process run's within
     1e-6 and the parameters are bitwise equal across ranks;
  9. ZeRO training (``launch/steps.py``'s ZeRO steps, ``models/
     blockstack.py``, ``optim/gradsync.py``'s shard layouts) on phase 8's
     one-rank NCCL world, built with ``single=False`` on its 1 x 1
     topology: the code every rank of a multi-pod world runs, with node
     and lane groups of one process (before 8d):
     (a) llama3.2-3b at full width cut to 2 layers, f32, 1 x 256
     tokens, 2 steps each of lane_zero1, lane_zero3 (prefetch),
     --fsdp-regather and --fsdp-prefetch -1 on the card against
     lane_zero3 on the CPU (a gloo group of the same rank): every loss
     within 1e-5, the parameters after the last step within 1e-3 lr at
     all but 1% of the elements (mamba2-780m's ZeRO state is held by 9b
     and 10a, its f32 step against the CPU's by 7b);
     (b) 5 bf16 steps at full width, 4 x 1024 tokens, AdamW unclipped:
     llama3.2-3b replicated (native), lane_zero1, lane_zero3 (prefetch),
     regather and blocking, and mamba2-780m replicated and lane_zero3,
     with the witness "masters" (the replicated step with f32 master
     weights) for each: step ms, peak memory beside the replicated
     step's, layer gathers and K1/K2 launches per step (each checked: L
     per step, 2L under regather), step 1's loss equal to the replicated
     step's and the replicated's to phase 7c's first, steps 2-5 equal to
     the replicated step's for lane_zero1, to "masters"' for lane_zero3
     and to lane_zero3's for its other modes (see ZERO_GATE); a layout
     that does not fit prints its OOM, and then every run goes again at
     --microbatch 2, where an OOM fails the phase;
 10. checkpoints (``checkpoint/``, ``launch/steps.py``'s layouts and
     restores, ``launch/train.py``'s ``--ckpt``) and serving from them
     under ``lane_zero3`` (``serve/steps.py``, ``scan_stack_cached``,
     ``kv_splice``, ``load_serve_params``), on phase 9's one-rank world,
     its checkpoint directories under build/ removed at the end, also on
     failure; free disk and host RAM printed first:
     (a) mamba2-780m (replicated, lane_zero1, lane_zero3) at full width
     cut to 2 layers, f32: 2 steps, the state saved from the card and
     from a CPU copy (identical ``arr_<i>.npy`` files and manifest step,
     layout and leaves), restored into its own layout (equal to the
     state saved) with step 3 from it equal to the uninterrupted step 3,
     and into every other layout with the canonical form bit-identical;
     one flipped byte: an explicit step raises CheckpointCorruptError,
     step=None falls back (llama3.2-3b's layouts are 15b's);
     (b) mamba2-780m, bf16, 4 x 1024, ``launch.train.run --gradsync
     lane_zero3 --ckpt --ckpt-every 2`` for 4 steps, step 4 removed, the
     run again (resumed at 2): steps 3-4 equal; per save the loop's
     blocking ms, the writer's s, GB and GB/s, and the restore's s; the
     step-4 checkpoint restored into the replicated bf16 layout (every
     parameter its f32 master cast) and one native step from it, finite;
     (c) ``load_serve_params`` on that checkpoint, 8 ``mixed`` requests,
     4 slots, under replicated and under lane_zero3 with the ``lane`` and
     the ``native`` kv_splice: identical tokens, K2 48 per prefill under
     each; llama3.2-3b from phase 5's weights under lane_zero3: phase 5's
     tokens, K1 224; prefill ms at T=512, decode ms, layer gathers per
     decode step (L) and peak memory per hosting; phase 10's seconds;
 11. the fault-tolerant runtime (``runtime/``, the ``lane_quorum``
     step and sync, ``launch/train.py``'s recovery ladder) on phase 10's
     one-rank world and 1 x 1 topology, its checkpoint directories
     under build/ removed at the end, also on failure:
     (a) llama3.2-3b at full width, bf16, 4 x 1024 tokens, 4 steps
     through ``launch.train.run`` with ``--gradsync lane``, then
     ``--gradsync lane_quorum --fault-plan pod_slow@2:pod=0
     --quorum-staleness 2``: steps 0-1 (the full quorum) bit-identical
     to lane's, step 2 DEGRADED with a loss of exactly 0.0, HEALTHY ->
     DEGRADED at 2 and DEGRADED -> HEALTHY at 3, step 3 finite, K1 28 a
     step in both; each run's step ms;
     (b) llama3.2-3b at full width cut to 2 layers, bf16, 1 x 256,
     ``--ckpt --ckpt-every 2 --steps 4 --fault-plan
     "ckpt_io@2:count=2;corrupt_leaf@4:leaf=1"``: step 2 committed on
     its third attempt and verified, step 4's flipped byte caught, and a
     second run with ``--steps 6`` resumed from step 2 and committed step
     6;
     (c) at (b)'s size, ``--gradsync lane_quorum --fault-plan
     pod_lost@1:pod=0 --quorum-staleness 1``: RESTART at step 2, its
     emergency checkpoint committed and verified, then ``repro``'s
     ValueError ("all slices of the outer batch axis lost"), which the
     phase requires;
 12. measured-cost tuning (``tuning/``, ``core/guidelines.py``,
     ``LaneComm.select``'s measured tier, ``launch/train.py``'s
     ``--gradsync auto``, ``--tune`` and ``--tuning-cache``) on phase
     11's one-rank world and 1 x 1 topology, its cache directory under
     build/ removed at the end, also on failure:
     (a) ``tuning.probe_cells`` at ``DEFAULT_LADDER`` on the card (each
     cell's median and minimum µs), the cache saved, loaded and saved
     again with identical bytes, then the fit and the guideline report
     printed (constants, residuals, each cell's ratio; nothing gated: at
     p = 1 no row sees the lane level);
     (b) llama3.2-3b at full width, bf16, 4 x 1024 tokens, 3 steps
     through ``launch.train.run`` three times: ``--gradsync auto --tune
     --tuning-cache C`` (the gradient payload lies beyond the ladder:
     ranked by the model, and the three cells' misses committed to C);
     the same again (the worklist probe times exactly those payloads, and
     its seconds are printed; ranked by measurement, the strategy the
     table's argmin at the payload, C's misses consumed); and
     ``--gradsync <that strategy>`` (the losses of the second run, bit for
     bit); K1 28 a step in each; after the phase the cost model's
     constants are those from before it;
 13. tensor and expert parallelism (``models/parallel.py``, ``mlp_tp``,
     ``moe_block_ep``, the ``moe_route`` cells, the ep ``lane_zero3``
     state and checkpoint) on phase 12's one-rank world and 1 x 1
     topology, its checkpoint directory under build/ removed at the end,
     also on failure:
     (a) ``mlp_tp`` and ``mlp_tp_reduce`` over the topology's model group
     (tp = 1: NCCL refuses two ranks on one card) at llama3.2-3b's MLP
     (d 3072, f 8192), bf16, 4 x 1024 tokens, forward and backward against
     ``mlp``: max |delta| of the output and every gradient (gate 2e-2 of
     the largest value), and each one's device us;
     (b) granite-moe-3b-a800m at full width, bf16, 4 x 1024 tokens, 3
     steps each through ``launch.train.run``: ``--gradsync lane`` and
     ``--gradsync lane_zero3`` (the gathered MoE), ``--gradsync lane
     --expert-parallel`` and ``--gradsync lane_zero3 --expert-parallel
     --ep-blocks 2``, AdamW unclipped (as 9b), each state freed before
     the next: losses finite,
     K1 32 a step, the forward routes 2 · 32 · ep_blocks a step, each EP
     run's losses within 1e-6 of its layout's gathered run's at every
     step; step ms, peak and the dropped share printed;
     (c) granite-moe-3b-a800m at full width cut to 2 layers, bf16, 1 x 256:
     ``--gradsync lane_zero3 --expert-parallel --steps 3 --ckpt D
     --ckpt-every 2`` (the ep layout), step 3 removed, then ``--gradsync
     lane``, resumed at step 2 into the replicated layout through the
     canonical form: its step-3 loss within 1e-6 of the uninterrupted
     run's;
 14. lanelint's collective recorder (``analysis/footprint.py``) and the
     serving smoke leg (``serve/serve_smoke.py``) on phase 13's one-rank
     world and 1 x 1 topology:
     (a) one bf16 step of llama3.2-3b at full width, 4 x 1024 tokens,
     ``--gradsync lane``, under ``record_collectives()``, then the next
     step without it (both after a first, untimed step): K1 28 in the
     recorded step, every recorded op on
     CUDA tensors, the sync's calls and issued bytes by kind those of the
     ``lane`` cell's K buckets over the padded f32 flat buffer (12.85 GB:
     K reduce-scatters of the buckets, K all-reduces and K all-gathers of
     their stripes), the wire 0 at every level (p = 1), R1 clean; both
     step times printed (the recorder's cost, not gated); then one
     ``lane_zero3`` decode step (4 slots) under the recorder: 28 layer
     gathers, R1 clean, wire 0;
     (b) ``serve_smoke.run_scenarios`` at full width, bf16, seed-0 weights,
     4 slots, max_seq 1024, for llama3.2-3b and mamba2-780m over the
     kinds phase 5 does not serve (short_chat, long_context, bursty; 5
     requests each): every request finished with a reason and a
     first-token time, K1 28 per llama prefill and K2 48 per mamba2
     prefill, counted from the requests; tok/s per kind printed (a smoke
     reading over the wall time, prefills included: not a decode rate);
 15. the launch layer (``launch/dryrun.py``'s planner,
     ``launch/train_smoke.py``, ``launch/tp_smoke.py``, the
     ``("train_step", ...)`` registry cells) on phase 14's one-rank world
     and 1 x 1 topology, its checkpoint directories under build/ removed
     at the end, also on failure:
     (a) the planner's state bytes at full width: for llama3.2-3b under
     the replicated layout (native), lane_zero1 and lane_zero3, and
     granite-moe-3b-a800m under lane_zero3 --expert-parallel, the growth
     of ``torch.cuda.memory_allocated()`` across ``init_model`` and
     ``init_lane_train_state`` (the init tree dropped) within 0.5% of
     ``dryrun.train_state_bytes`` at p = 1, one layout built and freed at
     a time; after the replicated state, one bf16 step at 4 x 1024 and its
     peak printed beside the planned state (no gate; K1 28);
     (b) ``train_smoke``'s 11 cells (every ``train_step`` flavor on
     llama3.2-3b --smoke, lane_zero3 on each driver-trainable family's
     smoke arch), each a fresh 2-step run committing step 2 and a resumed
     3-step run committing step 3 through ``launch.train.run`` with
     ``--device cuda``: every cell passes, K1 (f32, hd 16) once per
     attention layer and step and K2 once per Mamba2 layer and step (3
     steps a cell), printed per cell;
     (c) ``tp_smoke``'s three expert-parallel cells on dbrx-132b --smoke
     (``ep_lane``, ``ep_zero3``, ``ep_zero3_blocks2``) at p = 1, fresh
     and resumed, K1 3 steps x L; and a TP cell refused with its reason
     (one GPU: NCCL refuses two ranks on one card).

Both kernels choose by dtype inside their C entry point: bf16 (the
serving and training paths) runs on the tensor cores, f32 on the CUDA
cores.  The line before the last is a JSON object with K1's and K2's
numbers (launches per path, the training runs and phases 10 to 15
included);
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import filecmp
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch import _tree  # noqa: E402
from repro_torch.configs import RunConfig, resolve  # noqa: E402
from repro_torch.data import make_loader  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd as k2  # noqa: E402
from repro_torch.models import (ServeState, decode_step, init_model,  # noqa: E402
                                model_forward)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.transformer import _hybrid_split  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatcher, Request, SamplerConfig, build_serve_step,
    make_scenario)
from repro_torch.serve import prng  # noqa: E402
from repro_torch.serve.sampling import sample_token  # noqa: E402
from repro_torch.serve.engine import DEFAULT_BUCKETS  # noqa: E402
from repro_torch.launch import mesh, steps, train  # noqa: E402
from repro_torch.launch.steps import init_train_state  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.optim import gradsync  # noqa: E402
from repro_torch.comm import CommConfig, LaneComm  # noqa: E402
from repro_torch.comm.impls import grad_sync_buckets  # noqa: E402
from repro_torch.core import ref as oracles  # noqa: E402
from repro_torch.core.lane import LaneTopology  # noqa: E402
from repro_torch.core.pipeline import pipelined_allgather_lane  # noqa: E402
from repro_torch.checkpoint import (REPLICATED, CheckpointCorruptError,  # noqa: E402
                                    save_checkpoint)
from repro_torch.checkpoint.store import host_array  # noqa: E402
from repro_torch.serve import load_serve_params  # noqa: E402
from repro_torch.serve.serve_smoke import run_scenarios  # noqa: E402
from repro_torch.analysis import record_collectives  # noqa: E402
from repro_torch.analysis.rules import (SMALL_GLOBAL_BYTES,  # noqa: E402
                                        check_step_footprint)
from repro_torch.launch import dryrun, tp_smoke, train_smoke  # noqa: E402
from repro_torch.launch.dryrun import (attention_pairs,  # noqa: E402
                                       train_flops)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12         # dense tensor-core peak, bf16
F32_FLOP_PER_S = 67e12           # CUDA-core peak, f32
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
K2_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# logits of the cached path against the no-cache forward, as max abs
# difference over the largest reference logit.  The two paths round bf16
# at different points (plain decode attention and decode step vs K1 and K2,
# cuBLAS tiles that change with T), and across the layers of random
# weights that moves the logits by a few percent: on zamba2-7b (81 + 26
# sublayers) the no-cache forward moves by 5e-2 when only the scan's chunk
# length changes, a computation that is mathematically the same.  So the
# dense family is held in bf16 at LOGIT_TOL, and the recurrent families,
# whose check is about the state handed from prefill to decode, in f32 at
# F32_LOGIT_TOL (the same seed's weights unrounded; that forward moves by
# 7e-6 under the same change of chunk), with their bf16 numbers printed
# beside that bf16 noise floor.  The vlm family is held in f32 too: at
# llava's 32 x 4096 behind its 576 vision tokens the bf16 first decode step
# moved by 3.5e-2 and 4.3e-2 from the no-cache forward (f32: 1.0e-5 and
# 8.0e-6), on an H100.  The moe family is held in f32 as well: a
# near-tie among its top-8-of-40 routing flips under a bf16 rounding and
# moves the logits far, and its capacity (from the bucket at prefill, from
# the exact length in the no-cache forward) may drop different tokens;
# its gate therefore also widens the capacity factor to E/K, so that
# C >= T and nothing can drop (a test-only config; the served run keeps
# 1.25).  Each check prints, beside it, a negative control that it must
# fail.
LOGIT_TOL = 3e-2
F32_LOGIT_TOL = 1e-4
# every negative control must miss the tolerance; the recurrent families'
# control (a decode step from a zeroed ssm state) must miss it by at least
# this factor on the longest prompt, whose state holds the most.  (In bf16
# on a 3-token prompt the state holds little: mamba2-780m's control there
# gave 2.2x LOGIT_TOL, on the 792-token prompt 6.7x, on an H100.)
CONTROL_FACTOR = 3.0

ATT_SHAPES = [
    # B, H, K, Tq, Tk, hd  (the kernel tests' shapes)
    (1, 2, 2, 128, 128, 64),
    (2, 4, 2, 256, 256, 64),
    (1, 8, 2, 256, 512, 32),
    (1, 2, 1, 512, 512, 128),
]
MAIN_T = (32, 64, 128, 256, 512, 682)   # prefill buckets + an exact length
# K1 at hd 16 (Tq, Tk, causal, window): the smoke training's T = 32 and 16,
# a window, and Tq != Tk
SMOKE_K1 = ((32, 32, True, 0), (16, 16, True, 0), (200, 200, True, 24),
            (96, 160, True, 0), (64, 130, False, 0))
SSD_SHAPES = [
    # b, H, T, P, S, chunk  (the kernel tests' shapes)
    (1, 4, 64, 32, 32, 16),
    (2, 8, 128, 32, 64, 32),
    (1, 8, 128, 64, 128, 64),
    (2, 4, 96, 16, 16, 32),
]
SSM_T = (3, 64, 387, 512, 792)      # exact prompt lengths of the ssm paths
PATHS = ("llama3.2-3b", "mamba2-780m", "zamba2-7b", "granite-moe-3b-a800m",
         "llava-next-mistral-7b", "whisper-large-v3", "granite-34b",
         "h2o-danube-3-4b")
SLOTS, N_REQ = 4, 8
# max_seq per path: 1024, but llava's 576 vision tokens come first,
# whisper-large-v3's decoder has a context of 448 (max_target_positions in
# its published config), and h2o-danube-3-4b serves one more request
# whose prompt is longer than its window of 4096 (LONG_PROMPT)
MAX_SEQ = {"llava-next-mistral-7b": 1600, "whisper-large-v3": 448,
           "h2o-danube-3-4b": 4352}
# the usual 8 requests are drawn for 1024 positions (after llava's
# prefix; whisper's 448 cap them)
SCENARIO_POSITIONS = 1024
# (prompt length, new tokens) of the extra request past the window
LONG_PROMPT = {"h2o-danube-3-4b": (4300, 10)}
# the paths whose cached forward is gated in bf16; the others are gated
# in f32 (the same seed's weights unrounded) with their bf16 numbers
# printed, granite-34b cut to F32_LAYERS layers at full width (in f32 its
# 88 layers would take 135 GB)
BF16_GATED = ("llama3.2-3b", "whisper-large-v3")
F32_LAYERS = {"granite-34b": 4}
# the sampled runs of llama3.2-3b: a usual setting (T=0.8, top_p=0.9),
# and one hot enough that the draw departs from greedy (the random
# weights' logits are ~50 apart, so at T=0.8 every draw is greedy's)
SAMPLERS = (SamplerConfig(temperature=0.8, top_p=0.9, seed=1234),
            SamplerConfig(temperature=64.0, top_p=0.9, seed=1234))
GUMBEL_ULPS = 4     # card against CPU, in ulps of max(|g|, 1)
# prefill lengths timed in phase 6 (text tokens; vlm adds its prefix),
# and the one traced, by family; others 64 / 512 / 792 and 512
PERF_T = {"dense": (*DEFAULT_BUCKETS, 682), "audio": (64, 256, 448),
          "granite-34b": (64, 512, 792), "h2o-danube-3-4b": (64, 512, 4300)}
TRACED_T = {"dense": 32, "audio": 448}
# phase 7: bf16 training at full width through launch.train.main, and the
# train step held card against CPU in f32 on CHECK_LAYERS layers.  remat
# "none" keeps llama3.2-3b's peak under the card's 80 GB at 4 x 1024 tokens
TRAIN_ARCHS = ("llama3.2-3b", "mamba2-780m")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 20, 4, 1024
TRAIN_REMAT = {"llama3.2-3b": "none", "mamba2-780m": "none"}
CHECK_LAYERS, CHECK_T = 2, 256
# card against CPU in f32: the loss (relative), each gradient leaf (of its
# largest magnitude), and AdamW's step (within UPDATE_TOL x lr at all but
# FLIP_SHARE of the elements: its normalised step passes each element's
# relative rounding on whole, large for gradients near 0 or near its eps,
# see tests/test_torch_train.py)
CARD_LOSS_TOL, CARD_GRAD_TOL = 1e-5, 1e-4
UPDATE_TOL, FLIP_SHARE = 1e-3, 1e-2


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def qkv_inputs(B, H, K, Tq, Tk, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    return mk(B, H, Tq, hd), mk(B, K, Tk, hd), mk(B, K, Tk, hd)


def compare(q, k, v, *, causal, window):
    """K1 against its plain version on the same inputs: (max abs err,
    within the dtype's tolerance)."""
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        return float("inf"), False
    diff = (got.float() - want.float()).abs()
    tol = TOL[q.dtype]
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return float(diff.max()), ok


def k1_bound(q, k, *, causal, window):
    """Least time (ms) for K1's work on these inputs, and what bounds it."""
    B, H, Tq, hd = q.shape
    Tk = k.shape[2]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4 * hd * B * H * attention_pairs(Tq, Tk, causal, window)
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, reps=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_rows(avg) -> list:
    """The rows of ``avg`` (``key_averages()``) of device operations that
    took time: kernels, copies and sets, not the device side of a
    ``record_function`` range (``repro_torch.obs`` spans), which bears
    its host range's name."""
    host = {r.key for r in avg
            if r.device_type != torch.autograd.DeviceType.CUDA}
    return [r for r in avg
            if r.device_type == torch.autograd.DeviceType.CUDA
            and r.self_device_time_total > 0 and r.key not in host]


def profiled(run, tries=3, reps=None):
    """``run`` once under torch.profiler: (its CUDA kernel rows, wall ms).
    Now and then CUPTI hands the profiler no device record for a session
    in which kernels did run, or only some of the records (a kernel that
    ``run`` launched ``reps`` times counted fewer times); such a session
    is run again, up to ``tries`` times in all, and ``[]`` comes back if
    none recorded every kernel.  Without ``reps`` the launches cannot be
    counted, and a session with any record is kept.  The profiler slows
    the host side, so the wall time is above the untraced one."""
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = device_rows(prof.key_averages())
        short = [f"{r.key[:40]} x{r.count}" for r in rows
                 if reps and r.count % reps]
        if rows and not short:
            return rows, wall
        log("perf", f"the profiler recorded "
            + (f"only some launches of {reps}: {'; '.join(short)}" if rows
               else "no device kernel")
            + f" (session {attempt} of {tries})")
    return [], wall


def queued_us(fn, reps=20, cycles=50_000_000, tries=4):
    """Device time per call of ``fn``, in us, without the profiler: CUDA
    events around ``reps`` calls that the host queues behind a sleep
    kernel, so that the card runs them back to back.  The sleep has to
    outlast the host's queueing; if the first event had already passed
    when the last call was queued, the sleep is doubled and the timing
    taken again."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(tries):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) * 1e3 / reps
        cycles *= 2
    raise RuntimeError("the host could not queue the calls ahead of the card")


def device_us(fn, reps=20, warmup=3):
    """Device time per call of ``fn``, in us, from the profiler's CUDA
    kernel rows: (the sum over every kernel the calls launched, "name us"
    per kernel).  Unlike ``cuda_ms`` it leaves out the host's time between
    launches.  Where no profiler session recorded every launch of every
    kernel, the time comes from ``queued_us`` and the one row says so."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(reps):
            fn()

    rows, _ = profiled(run, reps=reps)
    if not rows:
        us = queued_us(fn, reps)
        return us, [f"queued behind a sleep, CUDA events {us:.2f}"]
    total = sum(r.self_device_time_total for r in rows) / reps
    return total, [f"{r.key[:40]} {r.self_device_time_total / reps:.2f}"
                   for r in rows]


def host_ms(fn, reps=5, warmup=1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def traced(fn):
    """One call of ``fn`` under torch.profiler: (wall ms, device busy ms,
    device operations launched, the five device kernels that took the
    most time as "name ms" strings), or None where no profiler session
    recorded a kernel."""
    kernels, wall = profiled(fn)
    if not kernels:
        return None
    busy = sum(r.self_device_time_total for r in kernels) / 1e3
    ops = sum(r.count for r in kernels)
    top = sorted(kernels, key=lambda r: -r.self_device_time_total)[:5]
    return wall, busy, ops, [
        f"{r.key[:48]} {r.self_device_time_total / 1e3:.2f}" for r in top]


def ssd_inputs(b, H, T, P, S, dtype, seed, *, model_like=False,
               init=False):
    """K2's inputs on the card.  The kernel tests draw dt in [0.01, 0.1]
    and A in [-2, -0.5]; ``model_like`` takes the model's own ranges
    instead (A = -linspace(1, 16, H), dt = softplus of a unit normal), where
    exp(cum) underflows within a chunk."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *sh: torch.randn(sh, generator=g, device="cuda")
    x = mk(b, H, T, P).to(dtype)
    if model_like:
        A = -torch.linspace(1.0, 16.0, H, device="cuda")
        dt = F.softplus(mk(b, H, T))
    else:
        A = -(torch.rand(H, generator=g, device="cuda") * 1.5 + 0.5)
        dt = torch.rand(b, H, T, generator=g, device="cuda") * 0.09 + 0.01
    B, C = mk(b, T, S).to(dtype), mk(b, T, S).to(dtype)
    return x, dt, A, B, C, (mk(b, H, P, S) if init else None)


def ssd_compare(x, dt, A, B, C, s0, chunk):
    """K2 against its plain chunked version on the same inputs: (max abs
    err of y, of the final state, both within the dtype's tolerance)."""
    got = k2.ssd_cuda(x, dt, A, B, C, chunk=chunk, init_state=s0)
    want = ref.ssd_chunked_ref(x, dt, A, B, C, chunk=chunk, init_state=s0)
    torch.cuda.synchronize()
    tol, errs, ok = K2_TOL[x.dtype], [], True
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            return float("inf"), float("inf"), False
        d = (g.float() - w.float()).abs()
        ok &= bool((d <= tol + tol * w.float().abs()).all())
        errs.append(float(d.max()))
    return errs[0], errs[1], ok


def k2_bound(x, B, s0, chunk):
    """Least time (ms) for K2's work on these inputs, and what bounds it.
    Bytes: x, dt, A, B, C and the initial state read once, y and the final
    state written once.  Operations: per chunk of length n, C.B^T over its
    n(n+1)/2 causal pairs (once, shared by the heads), the intra-chunk
    product over the same pairs, the state update and, where the state
    before the chunk is not zero, the inter-chunk product."""
    b, H, T, P = x.shape
    S = B.shape[2]
    es = x.element_size()
    nbytes = (2 * x.numel() + 2 * B.numel()) * es + 4 * (b * H * T + H) \
        + 4 * b * H * P * S * (2 if s0 is not None else 1)
    Q = min(chunk, T)
    flops = 0
    for c0 in range(0, T, Q):
        n = min(Q, T - c0)
        pairs = n * (n + 1) // 2
        inter = c0 > 0 or s0 is not None
        flops += b * 2 * pairs * S + b * H * 2 * pairs * P \
            + b * H * 2 * n * P * S * (2 if inter else 1)
    peak = BF16_FLOP_PER_S if x.dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def expected_launches(cfg, prefills: int) -> dict:
    """Each kernel runs once per layer that uses it and prefill; a whisper
    decoder layer runs K1 twice (self- and cross-attention) and each of
    its encoder layers once."""
    if cfg.family in ("dense", "moe", "vlm"):
        return {"flash_attention": cfg.num_layers * prefills, "ssd": 0}
    if cfg.family == "audio":
        return {"flash_attention": (cfg.encoder_layers + 2 * cfg.num_layers)
                * prefills, "ssd": 0}
    groups = _hybrid_split(cfg)[0] if cfg.family == "hybrid" else 0
    return {"flash_attention": groups * prefills,
            "ssd": cfg.num_layers * prefills}


def zero_ssm_state(cache: dict) -> dict:
    """A copy of a serving cache with every ``ssm`` leaf set to zero."""
    return {k: zero_ssm_state(v) if isinstance(v, dict)
            else torch.zeros_like(v) if k == "ssm" else v.clone()
            for k, v in cache.items()}


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "runs only on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain versions are
    torch.backends.cudnn.allow_tf32 = False         # the yardstick
    name = card()
    log("device", f"{name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} visible")
    return name


def ptxas_lines(nvcc_log: str) -> list:
    """'kernel: registers; spills' for each entry function in nvcc's
    ``-Xptxas -v`` output (names demangled where c++filt is found)."""
    out, fn, spill = [], None, ""
    for line in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn:
            used = line.split(":", 1)[1].strip()
            out.append((fn, f"{used}; {spill}"))
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(f for f, _ in out),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
        out = [(m.group(1) if (m := re.search(r"(\w+<[^>]*>|\w+)\(", n))
                else n, s) for n, (_, s) in zip(names, out)]
    return [f"{n}: {s}" for n, s in out]


def phase_build() -> None:
    t0 = time.perf_counter()
    for mod in (fa, k2):            # one nvcc per source, all at once
        mod.LIBRARY.start()
    for label, mod in (("K1", fa), ("K2", k2)):
        mod.build()
        log("build", f"{label} built and loaded "
            f"{time.perf_counter() - t0:.1f} s after the start")
        for line in ptxas_lines(mod.LIBRARY.log):
            log("build", f"{label} ptxas: {line}")


def phase_kernel() -> float:
    """Every case must pass; returns the max abs error at the serving
    paths' shapes."""
    bad = []
    seed = 0

    def case(label, q, k, v, causal, window):
        nonlocal seed
        err, ok = compare(q, k, v, causal=causal, window=window)
        log("kernel", f"K1 {label}: max_abs_err={err:.3e} "
            f"tol={TOL[q.dtype]:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(label)
        return err

    for B, H, K, Tq, Tk, hd in ATT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for mode in ("causal", "full", "window"):
                seed += 1
                q, k, v = qkv_inputs(B, H, K, Tq, Tk, hd, dtype, seed)
                case(f"B{B} H{H} K{K} Tq{Tq} Tk{Tk} hd{hd} "
                     f"{str(dtype)[6:]} {mode}", q, k, v,
                     mode == "causal", 96 if mode == "window" else 0)
    main_err = 0.0
    for T in MAIN_T:
        seed += 1
        q, k, v = qkv_inputs(1, 24, 8, T, T, 128, torch.bfloat16, seed)
        main_err = max(main_err, case(f"llama prefill T={T} bf16 causal",
                                      q, k, v, True, 0))
    zc = resolve("zamba2-7b")
    for T, dtype in [(T, torch.bfloat16) for T in SSM_T] + \
            [(512, torch.float32)]:
        seed += 1
        q, k, v = qkv_inputs(1, zc.num_heads, zc.num_kv_heads, T, T,
                             zc.hd(), dtype, seed)
        err = case(f"zamba2 prefill T={T} hd{zc.hd()} {str(dtype)[6:]} "
                   f"causal", q, k, v, True, 0)
        if dtype == torch.bfloat16:
            main_err = max(main_err, err)
    gc = resolve("granite-moe-3b-a800m")
    for T in (512, 792):
        seed += 1
        q, k, v = qkv_inputs(1, gc.num_heads, gc.num_kv_heads, T, T,
                             gc.hd(), torch.bfloat16, seed)
        main_err = max(main_err, case(
            f"granite-moe prefill T={T} hd{gc.hd()} bf16 causal", q, k, v,
            True, 0))
    lc, wc = resolve("llava-next-mistral-7b"), resolve("whisper-large-v3")
    shapes = [(f"llava prefill T={lc.vision_tokens}+{T}", lc,
               lc.vision_tokens + T, lc.vision_tokens + T, True)
              for T in (512, 792)]
    shapes += [(f"whisper encoder (ragged) Tq=Tk={wc.encoder_seq}", wc,
                wc.encoder_seq, wc.encoder_seq, False)]
    shapes += [(f"whisper cross Tq={T} Tk={wc.encoder_seq}", wc, T,
                wc.encoder_seq, False) for T in (32, 512)]
    for label, cfg, Tq, Tk, causal in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            seed += 1
            q, k, v = qkv_inputs(1, cfg.num_heads, cfg.num_kv_heads, Tq, Tk,
                                 cfg.hd(), dtype, seed)
            err = case(f"{label} hd{cfg.hd()} {str(dtype)[6:]} "
                       f"{'causal' if causal else 'full'}", q, k, v, causal,
                       0)
            if dtype == torch.bfloat16:
                main_err = max(main_err, err)
    for causal in (True, False):
        seed += 1
        q, k, v = qkv_inputs(1, zc.num_heads, zc.num_kv_heads, 387, 792,
                             zc.hd(), torch.bfloat16, seed)
        case(f"Tq=387 Tk=792 hd{zc.hd()} bf16 "
             f"{'causal ' if causal else ''}window 96", q, k, v, causal, 96)
    # hd 16, every --smoke config with attention (d_model 64 over 4 heads):
    # the shapes phase 15's smoke training runs at, causal, windowed and
    # Tq != Tk, both dtypes
    for Tq, Tk, causal, window in SMOKE_K1:
        for dtype in (torch.float32, torch.bfloat16):
            seed += 1
            q, k, v = qkv_inputs(8, 4, 2, Tq, Tk, 16, dtype, seed)
            case(f"smoke B8 H4 K2 Tq{Tq} Tk{Tk} hd16 {str(dtype)[6:]} "
                 f"{'causal' if causal else 'full'}"
                 + (f" window {window}" if window else ""), q, k, v, causal,
                 window)
    # granite-34b: 48 query heads on one K/V head; h2o-danube-3-4b: hd 120
    # (3840 / 32), its window of 4096 masking keys at T = 4300
    g34, dn = resolve("granite-34b"), resolve("h2o-danube-3-4b")
    shapes = [(f"granite-34b prefill T={T} G={g34.num_heads}", g34, T, 0)
              for T in (512, 792)]
    shapes += [(f"h2o-danube-3-4b prefill T={T} window {dn.sliding_window}",
                dn, T, dn.sliding_window)
               for T in (512, LONG_PROMPT[dn.name][0])]
    for label, cfg, T, window in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            seed += 1
            q, k, v = qkv_inputs(1, cfg.num_heads, cfg.num_kv_heads, T, T,
                                 cfg.hd(), dtype, seed)
            err = case(f"{label} hd{cfg.hd()} {str(dtype)[6:]} causal", q,
                       k, v, True, window)
            if dtype == torch.bfloat16:
                main_err = max(main_err, err)
    if bad:
        raise RuntimeError(f"K1 disagrees with its plain version: {bad}")
    return main_err


def phase_ssd() -> float:
    """Every case must pass; returns the max abs error of y at the serving
    paths' shapes in bf16."""
    bad = []
    seed = 1000

    def case(label, b, H, T, P, S, chunk, dtype, **kw):
        nonlocal seed
        seed += 1
        ey, es, ok = ssd_compare(*ssd_inputs(b, H, T, P, S, dtype, seed,
                                             **kw), chunk)
        log("ssd", f"K2 {label} {str(dtype)[6:]}: y max_abs_err={ey:.3e} "
            f"final state {es:.3e} tol={K2_TOL[dtype]:.0e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"{label} {dtype}")
        return ey

    for b, H, T, P, S, chunk in SSD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for init in (False, True):
                case(f"b{b} H{H} T{T} P{P} S{S} chunk{chunk}"
                     f"{' init_state' if init else ''}", b, H, T, P, S,
                     chunk, dtype, init=init)
    main_err = 0.0
    for cfg in [resolve(a) for a in PATHS]:
        if cfg.family not in ("ssm", "hybrid"):
            continue
        arch = cfg.name
        shape = (1, cfg.ssm_heads(), None, cfg.ssm_head_dim, cfg.ssm_state,
                 cfg.ssm_chunk)
        for T in SSM_T:
            for model_like in (False, True):
                sh = shape[:2] + (T,) + shape[3:]
                main_err = max(main_err, case(
                    f"{arch} prefill H{sh[1]} T{T} P{sh[3]} S{sh[4]}"
                    f"{' model dt/A' if model_like else ''}", *sh,
                    torch.bfloat16, model_like=model_like))
        sh = shape[:2] + (512,) + shape[3:]
        case(f"{arch} prefill T=512", *sh, torch.float32)
        sh = shape[:2] + (387,) + shape[3:]
        case(f"{arch} prefill T=387 init_state", *sh, torch.bfloat16,
             init=True)
        sh = shape[:2] + (792,) + shape[3:]
        case(f"{arch} prefill T=792 init_state model dt/A", *sh,
             torch.bfloat16, init=True, model_like=True)
    if bad:
        raise RuntimeError(f"K2 disagrees with its plain version: {bad}")
    return main_err


def negative_control(cfg, st1, L):
    """(label, config, state): a decode step the first decode step of an
    L-token prompt must not agree with, a fault of the hand-off from
    prefill to decode that each family can make."""
    if cfg.family in ("ssm", "hybrid"):
        return "from a zeroed ssm state", cfg, ServeState(
            cache=zero_ssm_state(st1.cache), length=st1.length.clone())
    if cfg.family == "vlm":
        # the decode step forgets the vision prefix in the length
        return "without the vision prefix in its length", cfg, ServeState(
            cache=st1.cache, length=st1.length - cfg.vision_tokens)
    if cfg.family == "audio":
        # (one position off moved whisper's logits by only 0.6x LOGIT_TOL
        # on its 342-token prompt, on an H100; this gave 26x)
        return "from a zeroed enc_kv", cfg, ServeState(
            cache=st1.cache, length=st1.length.clone(),
            enc_kv={k: torch.zeros_like(v) for k, v in st1.enc_kv.items()})
    if 0 < cfg.sliding_window < L:
        # past the window: the same step attending to every key
        return "without its sliding window", dataclasses.replace(
            cfg, sliding_window=0), st1
    # the same decode step one cache position early (overwrites the last
    # prompt token, rotates at L - 1)
    return "one position off", cfg, ServeState(cache=st1.cache,
                                               length=st1.length - 1)


def check_cached(cfg, params, step, bucket_for, reqs, *, tol, gate=True,
                 served=True) -> None:
    """Cached prefill and first decode step against the no-cache forward
    (these launches are apart from the counted run), for the first two
    requests and the longest, each beside a negative control that the
    check must see (``negative_control``), and beside a noise floor under
    a change that is mathematically nothing: for the recurrent families
    the same no-cache forward at chunk 32, for the others the same
    prefill at the prompt's exact length (where its bucket is longer).
    With ``gate`` False the numbers are only printed.  ``served``: these
    are the served weights, so the prefill must also reproduce each
    request's first token."""
    recurrent = cfg.family in ("ssm", "hybrid")
    checked = [reqs[0], reqs[1]]
    longest = max(reqs, key=lambda r: len(r.prompt))
    if all(longest is not r for r in checked):
        checked.append(longest)
    for r in checked:
        prompt = torch.as_tensor(np.asarray(r.prompt, np.int64),
                                 device="cuda")[None]
        extra = None if r.extra is None else \
            torch.as_tensor(r.extra, device="cuda")[None]
        L = prompt.shape[1]
        b = bucket_for(L)
        toks = torch.zeros((1, b), dtype=torch.long, device="cuda")
        toks[0, :L] = prompt[0]
        logits, st1 = step.prefill(params, toks, L, extra)
        ref_logits, _ = model_forward(params, cfg, prompt,
                                      extra_embeds=extra)
        e_pre = rel_err(logits[0, -1], ref_logits[0, -1])
        first = torch.tensor([[r.out[0]]], device="cuda")
        full = torch.cat([prompt, first], 1)
        ref2, _ = model_forward(params, cfg, full, extra_embeds=extra)
        control, cfg_off, lost = negative_control(cfg, st1, L)
        dec_logits, _ = decode_step(params, cfg, first, st1)
        e_dec = rel_err(dec_logits[0, -1], ref2[0, -1])
        off, _ = decode_step(params, cfg_off, first, lost)
        e_off = rel_err(off[0, -1], ref2[0, -1])
        first_ok = int(logits[0, -1].float().argmax()) == r.out[0]
        floor = ""
        if recurrent:
            c32, _ = model_forward(params, dataclasses.replace(
                cfg, ssm_chunk=32), full)
            floor = (f"; noise floor, the same no-cache forward at chunk "
                     f"32: {rel_err(c32[0, -1], ref2[0, -1]):.3e}")
        elif b != L:
            exact, _ = step.prefill(params, prompt, L, extra)
            floor = (f"; noise floor, the same prefill at its exact length: "
                     f"{rel_err(exact[0, -1], logits[0, -1]):.3e}")
        if 0 < cfg.sliding_window < L:
            # repro's decode_attention keeps one key fewer of the window
            # than its prefill; the port keeps the prefill's
            short, _ = decode_step(params, dataclasses.replace(
                cfg, sliding_window=cfg.sliding_window - 1), first, st1)
            floor += (f"; the same step with repro's decode window (one key "
                      f"fewer): {rel_err(short[0, -1], ref2[0, -1]):.3e}")
        log("serve", f"{cfg.name} {cfg.dtype} request {r.rid} (prompt {L}, "
            f"bucket {b}): prefill vs no-cache forward rel err "
            f"{e_pre:.3e}, first decode step {e_dec:.3e} (tol {tol:.0e}"
            f"{'' if gate else ', not gated'}; the same step {control}: "
            f"{e_off:.3e} = {e_off / tol:.1f} x tol){floor}"
            + (f"; first token reproduced {first_ok}" if served else ""))
        if served and not first_ok:
            raise RuntimeError(f"{cfg.name} request {r.rid}: the prefill "
                               f"does not reproduce the served first token")
        if not gate:
            continue
        if not (e_pre <= tol and e_dec <= tol):
            raise RuntimeError(f"{cfg.name} request {r.rid}: cached logits "
                               f"disagree with the no-cache forward")
        need = CONTROL_FACTOR * tol if r is longest and (
            recurrent or 0 < cfg.sliding_window < L) else tol
        if e_off <= need:
            raise RuntimeError(f"{cfg.name} request {r.rid}: a decode "
                               f"{control} is within {need:.0e}; the check "
                               f"is blind")


class DropWatch:
    """Within ``with``: for each prefill the served run makes, its true
    length and every layer's ``keep`` mask of the moe dispatch, recorded
    by wrapping ``batcher.step.prefill`` and ``moe._dispatch_buffer`` (the
    masks stay on the card until ``shares`` reads them)."""

    def __init__(self, batcher):
        self.batcher, self.prefills = batcher, []

    def __enter__(self):
        self.dispatch, self.prefill = (moe_mod._dispatch_buffer,
                                       self.batcher.step.prefill)

        def dispatch(p, x, cfg):
            out = self.dispatch(p, x, cfg)
            if x.shape[1] > 1:                 # a prefill, not a decode step
                self.prefills[-1][2].append(out[2])
            return out

        def prefill(params, toks, true_len, extra=None):
            self.prefills.append((true_len, toks.shape[1], []))
            return self.prefill(params, toks, true_len, extra)

        moe_mod._dispatch_buffer = dispatch
        self.batcher.step.prefill = prefill
        return self

    def __exit__(self, *exc):
        moe_mod._dispatch_buffer = self.dispatch
        self.batcher.step.prefill = self.prefill

    def shares(self, K: int) -> list:
        """(true length, bucket, dropped share of the prompt's (token, k)
        assignments, the same in the first and in the last layer, dropped
        share with the pad tokens) per prefill."""
        out = []
        for L, T, keeps in self.prefills:
            drop = torch.stack([~k.reshape(T, K) for k in keeps]).float()
            real = drop[:, :L].mean(dim=(1, 2))
            out.append((L, T, float(real.mean()), float(real[0]),
                        float(real[-1]), float(drop.mean())))
        return out


def scenario(cfg, max_seq):
    """The path's requests: 8 ``mixed`` ones, plus the long one past the
    window where the path has one (LONG_PROMPT)."""
    prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    reqs = make_scenario(cfg, kind="mixed", n=N_REQ, seed=0,
                         max_seq=min(max_seq, prefix + SCENARIO_POSITIONS))
    if cfg.name in LONG_PROMPT:
        L, new = LONG_PROMPT[cfg.name]
        prompt = np.random.default_rng([0, L]).integers(1, cfg.vocab_size, L)
        reqs.append(Request(rid=N_REQ, prompt=prompt.astype(np.int32),
                            max_new_tokens=new))
    return reqs


def phase_serve(cfg, max_seq):
    held = torch.cuda.memory_allocated()
    log("serve", f"{cfg.name}: {held / 2**30:.3f} GiB allocated on the card "
        f"before init")
    if held > 2**30:
        raise RuntimeError(f"{held / 2**30:.2f} GiB still held from earlier "
                           f"paths")
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log("serve", f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B params, "
        f"{cfg.dtype}, {cfg.num_layers} layers"
        + (f" + {cfg.encoder_layers} encoder layers over "
           f"{cfg.encoder_seq} frames" if cfg.family == "audio" else "")
        + (f", {cfg.vision_tokens} vision tokens" if cfg.family == "vlm"
           else "")
        + f", d_model {cfg.d_model}, max_seq {max_seq}, init on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    reqs = scenario(cfg, max_seq)
    log("serve", "prompt lengths " + str([len(r.prompt) for r in reqs])
        + ", max_new_tokens " + str([r.max_new_tokens for r in reqs]))
    batcher = ContinuousBatcher(params, cfg, slots=SLOTS, max_seq=max_seq,
                                eos_id=-1, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    with DropWatch(batcher) as drops:
        fa.launches = k2.launches = 0
        _, stats = batcher.run(reqs)
        torch.cuda.synchronize()
        launches = {"flash_attention": fa.launches, "ssd": k2.launches}
    log("serve", f"{cfg.name}: peak memory allocated during serving "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (weights "
        f"included)")

    for r in reqs:
        if r.finish_reason != "length" or len(r.out) != r.max_new_tokens:
            raise RuntimeError(f"request {r.rid}: {r.finish_reason}, "
                               f"{len(r.out)}/{r.max_new_tokens} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.out):
            raise RuntimeError(f"request {r.rid}: token out of vocabulary")
    want = expected_launches(cfg, len(reqs))
    log("serve", f"{cfg.name}: {len(reqs)} requests done, all 'length'; "
        f"launches during the run {launches} (want {want} for "
        f"{len(reqs)} prefills); {stats['decode_tokens']} decode tokens in "
        f"{stats['steps']} steps, {stats['wall_s']:.3f} s")
    if launches != want:
        raise RuntimeError(f"{cfg.name}: kernel launches {launches}, want "
                           f"{want}")
    if cfg.family == "moe":
        for L, T, real, first, last, padded in drops.shares(
                cfg.experts_per_token):
            log("serve", f"{cfg.name} prefill of prompt {L} (bucket {T}, "
                f"capacity {moe_mod._capacity(cfg, T)} per expert): dropped "
                f"{real:.4%} of the prompt's (token, expert) assignments "
                f"over {cfg.num_layers} layers (first layer {first:.4%}, "
                f"last {last:.4%}), {padded:.4%} with the pad tokens")
    if cfg.name in BF16_GATED:
        check_cached(cfg, params, batcher.step, batcher._bucket_for, reqs,
                     tol=LOGIT_TOL)
    else:
        check_cached(cfg, params, batcher.step, batcher._bucket_for, reqs,
                     tol=LOGIT_TOL, gate=False)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        if cfg.name in F32_LAYERS:
            cfg32 = dataclasses.replace(cfg32, num_layers=F32_LAYERS[cfg.name])
            log("serve", f"{cfg.name}: the f32 check runs the first "
                f"{cfg32.num_layers} of {cfg.num_layers} layers at full width")
        if cfg.family == "moe":
            # C >= T: nothing drops, so prefill and no-cache forward agree
            cfg32 = dataclasses.replace(
                cfg32, moe_capacity_factor=cfg.num_experts
                / cfg.experts_per_token)
        params32 = init_model(cfg32, seed=0, device="cuda")
        step32 = build_serve_step(cfg32, max_seq=max_seq, slots=1,
                                  device="cuda")
        check_cached(cfg32, params32, step32, batcher._bucket_for, reqs,
                     tol=F32_LOGIT_TOL, served=False)
        if cfg32.num_layers == cfg.num_layers and cfg.family != "moe":
            bf16_resolution(cfg, params, cfg32, params32, batcher.step,
                            batcher._bucket_for, reqs[0])
        del params32, step32
    return batcher, stats, launches, reqs


def bf16_resolution(cfg, params, cfg32, params32, step, bucket_for, r):
    """How far bf16 moves this path's logits from the same weights in f32
    (the bf16 weights are the f32 ones rounded), for the no-cache forward
    and for the cached first decode step of request ``r``: a gap between
    the two bf16 paths no larger than their distances from f32 is bf16's
    resolution, not a fault (the f32 gate holds the function itself)."""
    prompt = torch.as_tensor(np.asarray(r.prompt, np.int64),
                             device="cuda")[None]
    extra = None if r.extra is None else \
        torch.as_tensor(r.extra, device="cuda")[None]
    L = prompt.shape[1]
    full = torch.cat([prompt, torch.tensor([[r.out[0]]], device="cuda")], 1)
    f32, _ = model_forward(params32, cfg32, full, extra_embeds=extra)
    nc16, _ = model_forward(params, cfg, full, extra_embeds=extra)
    toks = torch.zeros((1, bucket_for(L)), dtype=torch.long, device="cuda")
    toks[0, :L] = prompt[0]
    _, st1 = step.prefill(params, toks, L, extra)
    dec16, _ = decode_step(params, cfg, full[:, -1:], st1)
    log("serve", f"{cfg.name} bf16 resolution, request {r.rid} (prompt {L}),"
        f" first decode position: the bf16 no-cache forward is "
        f"{rel_err(nc16[0, -1], f32[0, -1]):.3e} from the f32 one, the bf16 "
        f"cached decode step {rel_err(dec16[0, -1], f32[0, -1]):.3e} from "
        f"it, and {rel_err(dec16[0, -1], nc16[0, -1]):.3e} from the bf16 "
        f"no-cache forward")


def prng_on_card() -> None:
    """The sampler's threefry on the card against the same keys on the
    CPU: bits and uniforms equal bit for bit, the Gumbel noise within
    GUMBEL_ULPS (the two devices' ``log`` differ by an ulp or so)."""
    worst = 0.0
    for seed, rid, pos in ((0, 0, 0), (1234, 5, 17), (7, 2**31 + 5, 999)):
        keys = [prng.fold_in(prng.fold_in(prng.prng_key(seed, d), rid), pos)
                for d in ("cuda", "cpu")]
        for shape in ((128256,), (4, 32001)):
            bits = [prng.random_bits(k, shape).cpu() for k in keys]
            uni = [prng.uniform(k, shape).cpu().view(torch.int32)
                   for k in keys]
            g = [prng.gumbel(k, shape).cpu() for k in keys]
            if not (torch.equal(*bits) and torch.equal(*uni)):
                raise RuntimeError(f"threefry bits differ between the card "
                                   f"and the CPU (seed {seed}, rid {rid}, "
                                   f"position {pos}, shape {shape})")
            ulp = torch.from_numpy(np.spacing(
                np.maximum(g[1].abs().numpy(), 1).astype(np.float32)))
            worst = max(worst, float(((g[0] - g[1]).abs() / ulp).max()))
    log("sample", f"threefry on the card = on the CPU: bits and uniforms "
        f"equal for 3 keys x shapes (128256,), (4, 32001); Gumbel noise "
        f"at most {worst:.1f} ulps of max(|g|, 1) apart (limit "
        f"{GUMBEL_ULPS})")
    if worst > GUMBEL_ULPS:
        raise RuntimeError("the card's Gumbel noise is too far from the "
                           "CPU's")


def phase_sampled(cfg, batcher, greedy) -> dict:
    """``cfg``'s requests served sampled at each of SAMPLERS: once batched
    at SLOTS slots (the counted run) and once request by request at batch
    1; each request's tokens must be identical.  Prints how many tokens
    differ from the greedy run's (``greedy``) and the sampler's time
    beside a decode step's.  Returns the batched runs' launch counts."""
    prng_on_card()
    step1 = build_serve_step(cfg, max_seq=batcher.max_seq, slots=1,
                             device="cuda")
    launches = {}
    for s in SAMPLERS:
        name = f"{cfg.name} sampled T={s.temperature:g}"
        reqs = scenario(cfg, batcher.max_seq)
        eng = ContinuousBatcher(batcher.hosted, cfg, slots=SLOTS,
                                max_seq=batcher.max_seq, sampler=s,
                                step=batcher.step)
        fa.launches = k2.launches = 0
        _, stats = eng.run(reqs)
        torch.cuda.synchronize()
        launches[name] = {"flash_attention": fa.launches, "ssd": k2.launches}
        want = expected_launches(cfg, len(reqs))
        if launches[name] != want:
            raise RuntimeError(f"{name}: kernel launches {launches[name]}, "
                               f"want {want}")
        for r in reqs:
            alone = Request(r.rid, r.prompt, max_new_tokens=r.max_new_tokens)
            ContinuousBatcher(batcher.hosted, cfg, slots=1,
                              max_seq=batcher.max_seq, sampler=s,
                              step=step1).run([alone])
            if alone.out != r.out or len(r.out) != r.max_new_tokens:
                raise RuntimeError(f"{name} request {r.rid}: batched "
                                   f"{r.out}, alone {alone.out}")
        n = sum(len(r.out) for r in reqs)
        differ = sum(a != b for r, g in zip(reqs, greedy)
                     for a, b in zip(r.out, g.out))
        log("sample", f"{name} top_p={s.top_p} seed={s.seed}: {len(reqs)} "
            f"requests, batched at {SLOTS} slots == request by request "
            f"({n} tokens identical); {differ} of {n} tokens differ from "
            f"greedy; launches {launches[name]}; {stats['steps']} steps, "
            f"{stats['wall_s']:.3f} s")
    # the sampler's time beside a decode step's, at 4 rows of the vocab
    tok = np.zeros((SLOTS, 1), np.int64)
    logits, _ = batcher.step.decode(batcher.hosted, tok, batcher.state)
    rows = logits[:, -1]
    draw = lambda: sample_token(rows, SAMPLERS[0], list(range(SLOTS)),
                                [9] * SLOTS)
    ms = cuda_ms(draw, reps=20, warmup=3)
    # device time from the profiler only: the keys' copy to the card may
    # wait for a pinned buffer, so the calls cannot be queued behind a sleep
    rows, _ = profiled(lambda: [draw() for _ in range(20)], reps=20)
    dev = (f"{sum(r.self_device_time_total for r in rows) / 20:.1f} us "
           f"in {sum(r.count for r in rows) // 20} device operations"
           if rows else "not measured")
    dec = host_ms(lambda: batcher.step.decode(batcher.hosted, tok,
                                              batcher.state), reps=10,
                  warmup=2)
    log("sample", f"{cfg.name} sampler, {SLOTS} rows x {cfg.vocab_size}: "
        f"{ms:.3f} ms host+device per call, device {dev}; a decode step "
        f"{dec:.3f} ms; the sampler is {ms / (ms + dec):.1%} of a sampled "
        f"step")
    return launches


def extra_inputs(cfg, g):
    """Random patches (vlm) or frames (audio) for one request on the card,
    drawn as the scenarios draw them, or None."""
    n = {"vlm": cfg.vision_tokens, "audio": cfg.encoder_seq}.get(cfg.family)
    if n is None:
        return None
    return torch.randn((1, n, cfg.d_model), generator=g, device="cuda") * 0.02


def phase_perf(cfg, name, batcher, stats):
    step, hosted = batcher.step, batcher.hosted
    g = torch.Generator(device="cuda").manual_seed(1)
    lengths = PERF_T.get(cfg.name, PERF_T.get(cfg.family, (64, 512, 792)))
    traced_T = TRACED_T.get(cfg.family, 512)
    extra = extra_inputs(cfg, g)
    prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    toks_traced = None
    for T in lengths:
        toks = torch.randint(1, cfg.vocab_size, (1, T), generator=g,
                             device="cuda")
        toks_traced = toks if T == traced_T else toks_traced
        ms = host_ms(lambda: step.prefill(hosted, toks, T, extra))
        log("perf", f"{name} | {cfg.name} prefill T={T}"
            + (f" (+{prefix} vision tokens)" if prefix else "")
            + (f" (+ the encoder over {cfg.encoder_seq} frames)"
               if cfg.family == "audio" else "")
            + f": {ms:.3f} ms ({T / ms * 1e3:.0f} prompt tok/s)")
    if toks_traced is None:
        toks_traced = torch.randint(1, cfg.vocab_size, (1, traced_T),
                                    generator=g, device="cuda")
    tok = np.zeros((SLOTS, 1), np.int64)
    ms = host_ms(lambda: step.decode(hosted, tok, batcher.state), reps=20,
                 warmup=3)
    log("perf", f"{name} | {cfg.name} decode, {SLOTS} slots, max_seq "
        f"{batcher.max_seq}: {ms:.3f} ms/step = {SLOTS / ms * 1e3:.1f} "
        f"tok/s; the batcher run made {stats['tok_per_s']:.1f} decode tok/s "
        f"wall-clock, prefills included")
    for label, fn, layers in (
            (f"prefill T={traced_T}",
             lambda: step.prefill(hosted, toks_traced, traced_T, extra),
             cfg.num_layers + cfg.encoder_layers),
            ("decode step", lambda: step.decode(hosted, tok, batcher.state),
             cfg.num_layers)):
        got = traced(fn)
        if got is None:
            log("perf", f"{name} | {cfg.name} traced {label}: not measured, "
                "the profiler recorded no device kernel")
            continue
        wall, busy, ops, top = got
        log("perf", f"{name} | {cfg.name} traced {label}: wall {wall:.3f} "
            f"ms, device busy {busy:.3f} ms (idle {1 - busy / wall:.1%}), "
            f"{ops} device operations ({ops / layers:.1f} per "
            f"layer); most device time (ms): {'; '.join(top)}")


def time_k1(name, B, H, K, T, hd, *, causal=True, window=0):
    """K1 at a prefill shape (bf16, L2 warm) beside its bound, its plain
    version and scaled_dot_product_attention (with a window: given as a
    boolean mask, the same function)."""
    q, k, v = qkv_inputs(B, H, K, T, T, hd, torch.bfloat16, 99)
    launches = fa.launches
    run = lambda: fa.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window)
    ms = cuda_ms(run)
    dev, dev_rows = device_us(run)
    dev_q = queued_us(run)
    fa.launches = launches
    plain = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=causal,
                                              window=window), reps=20)
    if window:
        pos = torch.arange(q.shape[2], device="cuda")
        mask = pos[None, :] >= pos[:, None] - window
        if causal:
            mask &= pos[None, :] <= pos[:, None]
        sdpa = lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
    else:
        sdpa = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
    lib = cuda_ms(sdpa)
    lib_dev, lib_rows = device_us(sdpa)
    lib_q = queued_us(sdpa)
    bound, bound_by = k1_bound(q, k, causal=causal, window=window)
    log("perf", f"{name} | K1 T={T} (B{B} H{H} K{K} hd{hd} bf16 "
        f"{'causal' if causal else 'non-causal'}"
        f"{f' window {window}' if window else ''}, L2 warm): device "
        f"{dev:.2f} us/launch ({'; '.join(dev_rows)}; queued {dev_q:.2f}), "
        f"host+device {ms * 1e3:.2f} us/call; bound {bound * 1e3:.2f} us "
        f"({bound_by}); plain {plain * 1e3:.2f} us; sdpa device "
        f"{lib_dev:.2f} us ({'; '.join(lib_rows)}; queued {lib_q:.2f}), "
        f"host+device {lib * 1e3:.2f} us; K1 / sdpa device "
        f"{dev / lib_dev:.2f}")
    return ms, plain, lib, bound, bound_by


def time_k2(name, cfg, T=512):
    """K2 at a prefill shape (bf16, L2 warm) beside its bound and its plain
    version; no single PyTorch call computes the SSD scan."""
    H, P, S = cfg.ssm_heads(), cfg.ssm_head_dim, cfg.ssm_state
    x, dt, A, B, C, _ = ssd_inputs(1, H, T, P, S, torch.bfloat16, 98,
                                   model_like=True)
    launches = k2.launches
    run = lambda: k2.ssd_cuda(x, dt, A, B, C, chunk=cfg.ssm_chunk)
    ms = cuda_ms(run)
    dev, dev_rows = device_us(run)
    dev_q = queued_us(run)
    k2.launches = launches
    plain = cuda_ms(lambda: ref.ssd_chunked_ref(x, dt, A, B, C,
                                                chunk=cfg.ssm_chunk), reps=20)
    bound, bound_by = k2_bound(x, B, None, cfg.ssm_chunk)
    log("perf", f"{name} | K2 {cfg.name} T={T} (b1 H{H} P{P} S{S} chunk "
        f"{cfg.ssm_chunk} bf16, L2 warm): device {dev:.2f} us/launch "
        f"({'; '.join(dev_rows)}; queued {dev_q:.2f}), host+device "
        f"{ms * 1e3:.2f} us/call; "
        f"bound {bound * 1e3:.2f} us ({bound_by}); plain "
        f"{plain * 1e3:.2f} us; library: no single PyTorch call")
    return ms, plain, bound, bound_by


# ---------------------------------------------------------------------------
# phase 7: training
# ---------------------------------------------------------------------------

# the autograd Functions' cases: (label, config, Tq, Tk, causal, window)
def autograd_cases():
    llama, whisper = resolve("llama3.2-3b"), resolve("whisper-large-v3")
    zamba, danube = resolve("zamba2-7b"), resolve("h2o-danube-3-4b")
    return [("llama T=1024 causal", llama, 1024, 1024, True, 0),
            (f"whisper encoder T={whisper.encoder_seq} non-causal", whisper,
             whisper.encoder_seq, whisper.encoder_seq, False, 0),
            (f"whisper cross Tq=448 Tk={whisper.encoder_seq}", whisper, 448,
             whisper.encoder_seq, False, 0),
            ("zamba2 hd112 T=512 causal", zamba, 512, 512, True, 0),
            (f"danube hd120 T=4300 window {danube.sliding_window}", danube,
             4300, 4300, True, danube.sliding_window)]


def grads_err(got, want):
    """Worst ``max|g - w| / max|w|`` over pairs of gradients (inf where a
    gradient is not finite)."""
    worst = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            return float("inf")
        scale = float(w.float().abs().max()) or 1.0
        worst = max(worst, float((g.float() - w.float()).abs().max())
                    / scale)
    return worst


def phase_autograd() -> None:
    """K1's and K2's autograd Functions against autograd of their plain
    versions, forward and every input's gradient, f32 and bf16.  The
    gradients are held to the kernels' forward tolerances (TOL, K2_TOL)
    times the reference gradient's largest magnitude and must be finite.
    K2 runs at mamba2-780m's shape with the model's dt/A, where ``repro``'s
    own scan has NaN gradients."""
    bad, seed = [], 2000
    for label, cfg, Tq, Tk, causal, window in autograd_cases():
        for dtype in (torch.float32, torch.bfloat16):
            seed += 1
            q, k, v = qkv_inputs(1, cfg.num_heads, cfg.num_kv_heads, Tq, Tk,
                                 cfg.hd(), dtype, seed)
            dout = torch.randn_like(q)
            ins = [t.requires_grad_() for t in (q, k, v)]
            out = fa.FlashAttentionFunction.apply(*ins, causal, window)
            got = torch.autograd.grad(out, ins, dout)
            ref_out = ref.attention_ref(*ins, causal=causal, window=window)
            want = torch.autograd.grad(ref_out, ins, dout)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            e_out = rel_err(out.detach(), ref_out.detach())
            e_grad = grads_err(got, want)
            ok = e_out <= tol and e_grad <= tol and all(
                g.dtype == dtype for g in got)
            log("train", f"K1 Function {label} {str(dtype)[6:]}: forward "
                f"{e_out:.3e}, dq/dk/dv {e_grad:.3e} of their largest "
                f"(tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"K1 {label} {dtype}")
    cfg = resolve("mamba2-780m")
    H, P, S = cfg.ssm_heads(), cfg.ssm_head_dim, cfg.ssm_state
    for init in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            seed += 1
            x, dt, A, B, C, s0 = ssd_inputs(1, H, 1024, P, S, dtype, seed,
                                            model_like=True, init=init)
            ins = [t.requires_grad_() for t in (x, dt, A, B, C)] + (
                [s0.requires_grad_()] if init else [])
            s_in = ins[5] if init else None
            y, fin = k2.SSDFunction.apply(*ins[:5], s_in, cfg.ssm_chunk)
            dy, dfin = torch.randn_like(y), torch.randn_like(fin)
            outs, gouts = ([y, fin], [dy, dfin]) if init else ([y], [dy])
            got = torch.autograd.grad(outs, ins, gouts)
            ry, rfin = ref.ssd_chunked_ref(*ins[:5], chunk=cfg.ssm_chunk,
                                           init_state=s_in)
            want = torch.autograd.grad([ry, rfin][:len(outs)], ins, gouts)
            torch.cuda.synchronize()
            tol = K2_TOL[dtype]
            e_out = max(rel_err(y.detach(), ry.detach()),
                        rel_err(fin.detach(), rfin.detach()))
            e_grad = grads_err(got, want)
            ok = e_out <= tol and e_grad <= tol
            log("train", f"K2 Function mamba2 T=1024 model dt/A"
                f"{' init_state' if init else ''} {str(dtype)[6:]}: forward "
                f"{e_out:.3e}, dx/ddt/dA/dB/dC{'/ds0' if init else ''} "
                f"{e_grad:.3e} of their largest (tol {tol:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"K2 init={init} {dtype}")
    # the attention backward at llama3.2-3b's training shape (B=4, T=1024)
    cfg = resolve("llama3.2-3b")
    q, k, v = qkv_inputs(TRAIN_BATCH, cfg.num_heads, cfg.num_kv_heads,
                         TRAIN_SEQ, TRAIN_SEQ, cfg.hd(), torch.bfloat16, 7)
    out = fa.flash_attention_cuda(q, k, v)
    dout = torch.randn_like(out)
    dev, rows = device_us(lambda: fa.attention_backward(q, k, v, out, dout),
                          reps=5, warmup=1)
    how = rows[0] if len(rows) == 1 else f"{len(rows)} kernels, profiler"
    log("perf", f"attention_backward (plain PyTorch, f32) at llama3.2-3b's "
        f"training shape B{TRAIN_BATCH} T{TRAIN_SEQ} H{cfg.num_heads} "
        f"K{cfg.num_kv_heads} bf16: device {dev / 1e3:.3f} ms per layer "
        f"({how})")
    if bad:
        raise RuntimeError(f"the autograd Functions disagree with autograd "
                           f"of their plain versions: {bad}")




def _step_err(got_p, want_p, before, lr):
    """(share of elements whose AdamW step differs by more than
    UPDATE_TOL x lr, the largest difference over lr)."""
    over, n, worst = 0, 0, 0.0
    for g, w, b in zip(got_p, want_p, before):
        d = ((g.detach().float().cpu() - b) - (w.detach().float() - b)).abs()
        over += int((d > UPDATE_TOL * lr).sum())
        n += d.numel()
        worst = max(worst, float(d.max()) / lr)
    return over / n, worst


def phase_train_check() -> None:
    """One train step of llama3.2-3b and mamba2-780m at full width cut to
    CHECK_LAYERS layers, in f32, batch 1 x CHECK_T tokens, the same weights
    and batch on the card and on the CPU: the loss, every gradient leaf
    and the parameters after one AdamW update, each beside a negative
    control that must miss the gate (the card's step with the labels
    shifted by one position)."""
    opt = AdamWConfig(warmup_steps=0, total_steps=TRAIN_STEPS)
    for arch in TRAIN_ARCHS:
        cfg = dataclasses.replace(resolve(arch), num_layers=CHECK_LAYERS,
                                  dtype="float32")
        run = RunConfig(model=cfg)
        vg = steps._value_and_grad(steps._make_loss(run))
        toks, labels = make_loader(cfg, CHECK_T, 1, seed=0).batch_at(0)
        toks, labels = torch.as_tensor(toks), torch.as_tensor(labels)
        # the weights are drawn once, on the CPU, and copied to the card
        params0 = init_model(cfg, seed=0, device="cpu")
        before = [t.clone() for t in _tree.leaves(params0)]
        t0 = time.perf_counter()
        p_cpu, s_cpu = init_train_state(params0, device="cpu")
        l_cpu, g_cpu = vg(p_cpu, toks, labels, None)
        adamw_update(opt, g_cpu, s_cpu, p_cpu)
        t_cpu = time.perf_counter() - t0
        res = {}
        for name, lab in (("step", labels),
                          ("control", torch.roll(labels, 1, dims=1))):
            p, s = init_train_state(
                _tree.unflatten(params0, before), device="cuda")
            fa.launches = k2.launches = 0
            loss, g = vg(p, toks.cuda(), lab.cuda(), None)
            adamw_update(opt, g, s, p)
            torch.cuda.synchronize()
            res[name] = (abs(float(loss) - float(l_cpu)) / abs(float(l_cpu)),
                         grads_err([t.cpu() for t in _tree.leaves(g)],
                                   _tree.leaves(g_cpu)),
                         *_step_err(_tree.leaves(p), _tree.leaves(p_cpu),
                                    before, opt.lr))
            if name == "step":
                launches = (fa.launches, k2.launches)
            del p, s, g
            torch.cuda.empty_cache()
        (e_l, e_g, share, worst), (c_l, c_g, c_share, _) = \
            res["step"], res["control"]
        log("train", f"{arch} {CHECK_LAYERS} layers at full width, f32, "
            f"B1 T{CHECK_T}, card vs CPU (CPU step {t_cpu:.1f} s; launches "
            f"K1/K2 {launches}): loss {e_l:.3e} (tol {CARD_LOSS_TOL:.0e}; "
            f"labels shifted {c_l:.3e}), worst gradient leaf {e_g:.3e} of "
            f"its largest (tol {CARD_GRAD_TOL:.0e}; shifted {c_g:.3e}), "
            f"AdamW steps off by > {UPDATE_TOL:.0e} lr at {share:.3e} of "
            f"the elements (tol {FLIP_SHARE:.0e}; shifted {c_share:.3e}), "
            f"largest {worst:.3e} lr")
        if not (e_l <= CARD_LOSS_TOL and e_g <= CARD_GRAD_TOL
                and share <= FLIP_SHARE):
            raise RuntimeError(f"{arch}: the card's train step disagrees "
                               f"with the CPU's")
        if not (c_l > CARD_LOSS_TOL and c_g > CARD_GRAD_TOL
                and c_share > FLIP_SHARE):
            raise RuntimeError(f"{arch}: a train step on shifted labels "
                               f"passes the gate; the check is blind")


class StepClock:
    """Within ``with``: every call of the step that ``launch.train.main``
    builds is synchronised and timed, and call ``trace_at`` (0-based) runs
    under torch.profiler, by wrapping ``train.build_train_step``."""

    def __init__(self, trace_at: int):
        self.trace_at, self.seconds, self.prof = trace_at, [], None

    def __enter__(self):
        self.build = train.build_train_step

        def build(*args, **kw):
            step = self.build(*args, **kw)

            def timed_step(*args, **kw):
                torch.cuda.synchronize()
                if len(self.seconds) == self.trace_at:
                    self.prof = profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA])
                    self.prof.__enter__()
                t0 = time.perf_counter()
                out = step(*args, **kw)
                torch.cuda.synchronize()
                self.seconds.append(time.perf_counter() - t0)
                if len(self.seconds) == self.trace_at + 1:
                    self.prof.__exit__(None, None, None)
                return out
            timed_step.__dict__.update(step.__dict__)
            return timed_step
        train.build_train_step = build
        return self

    def __exit__(self, *exc):
        train.build_train_step = self.build


def phase_train(cfg, name) -> dict:
    """TRAIN_STEPS bf16 steps of ``cfg`` at full width through
    ``launch.train.main``, SyntheticLM seed 0, with the kernels' launch
    counts set to 0 just before and read just after; the last step
    traced."""
    held = torch.cuda.memory_allocated()
    if held > 2**30:
        raise RuntimeError(f"{held / 2**30:.2f} GiB still held before "
                           f"training")
    remat = TRAIN_REMAT[cfg.name]
    argv = ["--arch", cfg.name, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--remat", remat]
    log("train", f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B params, "
        f"{cfg.num_layers} layers, bf16, remat {remat}: train.main("
        f"{argv})")
    torch.cuda.reset_peak_memory_stats()
    with StepClock(trace_at=TRAIN_STEPS - 1) as clock:
        fa.launches = k2.launches = 0
        t0 = time.perf_counter()
        losses = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa.launches, "ssd": k2.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    layers = cfg.num_layers * (2 if remat == "full" else 1)
    want = {"flash_attention": layers * TRAIN_STEPS
            if cfg.family == "dense" else 0,
            "ssd": layers * TRAIN_STEPS if cfg.family == "ssm" else 0}
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS:
        raise RuntimeError(f"{cfg.name}: losses {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{cfg.name}: loss did not fall: {losses}")
    if launches != want:
        raise RuntimeError(f"{cfg.name}: launches {launches}, want {want}")
    ms = float(np.median(clock.seconds[2:])) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    log("train", f"{name} | {cfg.name}: {TRAIN_STEPS} steps in {wall:.1f} s "
        f"(init and data included); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, every loss finite; launches {launches} (want "
        f"{want}); step {ms:.1f} ms (median of steps 3-{TRAIN_STEPS}, "
        f"synchronised; step {TRAIN_STEPS} traced), {tokens / ms * 1e3:.0f} "
        f"tokens/s; peak memory {peak:.2f} GiB")
    print(f"train_mfu {cfg.name} {flops / (ms / 1e3) / BF16_FLOP_PER_S:.4f} "
          f"({flops:.3e} model FLOPs a step over {ms:.1f} ms at "
          f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16 dense peak; {name})",
          flush=True)
    report_traced_step(cfg, name, clock)
    return launches, losses


ANNOTATIONS = ("train_step/forward", "train_step/backward",
               "train_step/optimizer", "attention_backward", "ssd_backward")


def report_traced_step(cfg, name, clock) -> None:
    """The traced step: wall, device busy, idle share, device operations,
    the device time of the forward, backward and optimizer ranges (the
    backward's range opens and closes on autograd's device thread, which
    runs its kernels), the backward again as busy less the forward and
    the optimizer (a range's device time takes a kernel twice where
    CUPTI links it to a "Command Buffer Full" record as well), and per
    layer K1's or K2's forward and its backward's device time."""
    avg = clock.prof.key_averages()
    kernels = device_rows(avg)
    wall = clock.seconds[clock.trace_at] * 1e3
    if not kernels:
        log("train", f"{name} | {cfg.name} traced step: not measured, the "
            f"profiler recorded no device kernel")
        return
    busy = sum(r.self_device_time_total for r in kernels) / 1e3
    ops = sum(r.count for r in kernels)
    cpu = {r.key: r for r in avg
           if r.device_type == torch.autograd.DeviceType.CPU
           and r.key in ANNOTATIONS}
    dev = lambda k: cpu[k].device_time_total / 1e3 if k in cpu else 0.0
    host = lambda k: cpu[k].cpu_time_total / 1e3 if k in cpu else 0.0
    fwd, back, opt = (dev(f"train_step/{k}")
                      for k in ("forward", "backward", "optimizer"))
    top = sorted(kernels, key=lambda r: -r.self_device_time_total)[:5]
    log("train", f"{name} | {cfg.name} traced step: wall {wall:.1f} ms, "
        f"device busy {busy:.1f} ms (idle {1 - busy / wall:.1%}), {ops} "
        f"device operations; device ms: forward {fwd:.1f}, backward "
        f"{back:.1f} (busy less the other two {busy - fwd - opt:.1f}), "
        f"optimizer {opt:.1f}; host ms (traced): forward "
        f"{host('train_step/forward'):.1f}, backward "
        f"{host('train_step/backward'):.1f}, optimizer "
        f"{host('train_step/optimizer'):.1f}; most device time (ms): "
        + "; ".join(f"{r.key[:40]} {r.self_device_time_total / 1e3:.2f}"
                    for r in top))
    mark, bwd = ("flash_attention", "attention_backward") \
        if cfg.family == "dense" else ("ssd_", "ssd_backward")
    rows = [r for r in kernels if mark in r.key and "_kernel" in r.key]
    per = lambda us: f"{us / 1e3 / cfg.num_layers:.3f}"
    log("train", f"{name} | {cfg.name} traced step, per layer: "
        f"{'K1' if cfg.family == 'dense' else 'K2'} forward device "
        f"{per(sum(r.self_device_time_total for r in rows))} ms "
        f"({sum(r.count for r in rows)} kernel launches in the step), its "
        f"backward ({bwd}, plain PyTorch f32) "
        + (f"{per(cpu[bwd].device_time_total)} ms" if bwd in cpu
           and cpu[bwd].device_time_total else "not measured"))


# ---------------------------------------------------------------------------
# phase 8: the node/lane collectives and the gradient sync
# ---------------------------------------------------------------------------

LANE_ARCH = "llama3.2-3b"
LANE_ROWS = (3, 5, 9)                    # odd leading dims (x feature 2)
LANE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
               "int32": torch.int32}
# (label, strategy, num_buckets): None = the cost model's K
LANE_SYNCS = (("native", "native", None), ("lane", "lane", None),
              ("lane_pipelined", "lane_pipelined", None),
              ("lane_pipelined K=1", "lane_pipelined", 1),
              ("lane_int8", "lane_int8", None))
ALLOC_SLACK = 64 * 2**20                 # allocator rounding, small buffers
LANE_CPU_ARGV = ["--arch", LANE_ARCH, "--smoke", "--steps", "3", "--batch",
                 "4", "--seq", "32", "--gradsync", "lane", "--pods", "2",
                 "--gradsync-buckets", "4", "--device", "cpu"]
LANE_CPU_TOL = 1e-6


def phase_lane_world():
    """8a: a torch.distributed world over NCCL through ``launch.mesh``, in
    this process on cuda:0 (one process per card; with one card visible,
    the world of every visible card), file rendezvous under build/."""
    world = 1
    root = pathlib.Path(__file__).resolve().parent / "build" / "lane_world"
    root.mkdir(parents=True, exist_ok=True)
    init = root / f"rendezvous_{time.time_ns()}"
    mesh.init_world("cuda", rank=0, world_size=world,
                    init_method=init.as_uri())
    topo, single = mesh.make_lane_topology(TRAIN_BATCH, pods=1)
    log("lanes", f"world: NCCL, p={topo.p()} (n={topo.n()} per node, "
        f"N={topo.N()} nodes) on {torch.cuda.device_count()} visible "
        f"card(s); NCCL across several cards is not checked here")
    return topo, init


def _lane_cases():
    """(label, call(comm, topo, x), its oracle) for every lane, native and
    pipelined cell at p = 1."""
    out = []
    for coll in ("allreduce", "reduce_scatter", "allgather", "bcast",
                 "alltoall", "reduce", "gather", "scatter", "scan"):
        for strategy in ("lane", "native"):
            out.append((f"{coll}.{strategy}",
                        lambda c, t, x, coll=coll, s=strategy:
                        getattr(c, coll)(x, strategy=s),
                        getattr(oracles, f"oracle_{coll}")))
    for coll in ("allreduce", "bcast", "reduce"):
        out.append((f"{coll}.lane_pipelined",
                    lambda c, t, x, coll=coll: getattr(c, coll)(
                        x, strategy="lane_pipelined", num_blocks=1),
                    getattr(oracles, f"oracle_{coll}")))
    out.append(("pipelined_allgather", lambda c, t, x:
                pipelined_allgather_lane(x, t, num_blocks=1),
                oracles.oracle_allgather))
    return out


def phase_lane_conformance(topo) -> int:
    """8b: every collective, lane, native and pipelined, in f32, bf16 and
    int32 at odd leading dims, on NCCL against ``core.ref``'s oracles,
    exactly (integer-valued payloads)."""
    comm = LaneComm(topo)
    g = np.random.default_rng(8)
    n_cases = 0
    for label, call, oracle in _lane_cases():
        for dt, tdt in LANE_DTYPES.items():
            for rows in LANE_ROWS:
                xs = g.integers(-4, 5, (1, rows, 2)).astype(
                    np.int32 if dt == "int32" else np.float32)
                x = torch.from_numpy(xs[0]).to(tdt).cuda()
                got = call(comm, topo, x)
                torch.cuda.synchronize()
                if got.device != x.device or got.dtype != tdt:
                    raise RuntimeError(f"{label} {dt}: {got.device} "
                                       f"{got.dtype}")
                want = oracle(xs)[0]
                got = got.cpu().to(torch.int32 if dt == "int32"
                                   else torch.float32).numpy()
                if got.shape != want.shape or not np.array_equal(got, want):
                    raise RuntimeError(f"{label} {dt} rows {rows}: not "
                                       f"equal to its oracle")
                n_cases += 1
    log("lanes", f"conformance: {n_cases} cases (9 collectives x lane/"
        f"native, 3 pipelined and the pipelined allgather; f32, bf16, "
        f"int32; rows {LANE_ROWS}) on NCCL equal core.ref's oracles "
        f"exactly; at p=1 this checks the NCCL code path, not the "
        f"multi-rank semantics (those are the CPU gloo tests)")
    return n_cases


def _int8_chunk_error(x, y):
    """Per 1024-element chunk of one bucket: the largest error of ``y``
    against ``x`` (the gradients, exact in f32) over half the chunk's
    quantization step, (max|chunk|/127 + 1e-12)/2 (``repro``'s
    max|chunk|/254 with the quantizer's scale offset, which is all of the
    step where a chunk's values are below 1e-12); and the sums of squares
    of the error and of x."""
    pad = (-x.shape[0]) % 1024
    xr = torch.cat([x, x.new_zeros(pad)]).view(-1, 1024)
    yr = torch.cat([y, y.new_zeros(pad)]).view(-1, 1024)
    half_step = (xr.abs().amax(1) / 127.0 + 1e-12) / 2
    ratio = float(((yr - xr).abs().amax(1) / half_step).max())
    return ratio, float(((yr - xr) ** 2).sum()), float((xr ** 2).sum())


def phase_lane_gradsync(topo, name) -> dict:
    """8c: the gradients of one bf16 llama3.2-3b step at TRAIN_BATCH x
    TRAIN_SEQ tokens (phase 7's configuration, SyntheticLM seed 0)
    through ``LaneComm.grad_sync`` with every ported strategy: device
    time (CUDA events), peak memory above the gradients, K and the device
    operations of each; lane and lane_pipelined equal native bit for bit;
    lane_int8 within its half-step bound, its bucket's wire bytes equal
    to the CPU's."""
    held = torch.cuda.memory_allocated()
    if held > 2**30:
        raise RuntimeError(f"{held / 2**30:.2f} GiB still held before the "
                           f"gradient sync")
    cfg = resolve(LANE_ARCH)
    vg = steps._value_and_grad(steps._make_loss(RunConfig(model=cfg)))
    toks, labels = make_loader(cfg, TRAIN_SEQ, TRAIN_BATCH,
                               seed=0).batch_at(0)
    params = _tree.tree_map(lambda p: p.requires_grad_(True),
                            init_model(cfg, seed=0, device="cuda"))
    fa.launches = k2.launches = 0
    with torch.enable_grad():
        loss, grads = vg(params, torch.as_tensor(toks).cuda(),
                         torch.as_tensor(labels).cuda(), None)
    torch.cuda.synchronize()
    launches = {"flash_attention": fa.launches, "ssd": k2.launches}
    del params
    torch.cuda.empty_cache()
    leaves = _tree.leaves(grads)
    ref_leaves = [g.clone() for g in leaves]
    numel = sum(g.numel() for g in leaves)
    grad_bytes = sum(g.numel() * g.element_size() for g in leaves)
    log("lanes", f"{LANE_ARCH}: {numel / 1e9:.3f} B gradients in "
        f"{leaves[0].dtype} ({grad_bytes / 2**30:.2f} GiB, {len(leaves)} "
        f"leaves) from one bf16 step at {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        f"loss {float(loss):.4f}; K1 launches {launches}")
    comm = LaneComm(topo, CommConfig())

    def restore():
        for g, r in zip(leaves, ref_leaves):
            g.copy_(r)

    results = {}
    native = None
    for label, strategy, nb in LANE_SYNCS:
        K = grad_sync_buckets(comm, grads, nb) if strategy != "native" \
            else 1
        flat_bytes = 4 * (numel + (-numel) % (K * topo.n()))
        times = []
        for _ in range(3):
            restore()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            comm.grad_sync(grads, strategy=strategy, num_buckets=nb)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            peak = torch.cuda.max_memory_allocated() - base
        if strategy == "native":
            native = [g.clone() for g in leaves]
            if not all(torch.equal(a, b) for a, b in zip(native,
                                                         ref_leaves)):
                raise RuntimeError("native grad_sync at p=1 changed the "
                                   "gradients")
        elif strategy == "lane_int8":
            int8 = check_int8(topo, grads, ref_leaves, K)
        elif not all(torch.equal(a, b) for a, b in zip(leaves, native)):
            raise RuntimeError(f"{label}: not bit-identical to native")
        if strategy in ("lane", "lane_pipelined") \
                and peak > flat_bytes + ALLOC_SLACK:
            raise RuntimeError(f"{label}: {peak / 2**30:.2f} GiB above the "
                               f"gradients, more than one flat f32 copy "
                               f"({flat_bytes / 2**30:.2f} GiB)")

        tr = traced(lambda: comm.grad_sync(grads, strategy=strategy,
                                           num_buckets=nb))
        ops = "not measured" if tr is None else tr[2]
        results[label] = dict(ms=float(np.median(times)), peak=peak, K=K,
                              ops=ops, flat=flat_bytes)
        log("lanes", f"{name} | grad_sync {label}: device "
            f"{np.median(times):.2f} ms (CUDA events, median of 3, "
            f"flatten and unflatten included; min {min(times):.2f}), peak "
            f"{peak / 2**30:.3f} GiB above the gradients (one flat f32 copy "
            f"{flat_bytes / 2**30:.3f} GiB), "
            + (f"K={K}, " if strategy != "native" else "per leaf, ")
            + f"device operations "
            f"{ops} (one traced sync)"
            + ("; bit-identical to native" if label != "native"
               and strategy != "lane_int8" else ""))
    log("lanes", f"{name} | lane_int8: equal to the gradients quantized, "
        f"dequantized and cast, element for element; dequantized f32 "
        f"within {int8[3]:.6f} of its half step (max|chunk|/127 + 1e-12)/2 "
        f"(gate 1 + 2^-14, f32 rounding); after the cast to the leaves' dtype, relative error "
        f"{int8[0]:.3e} (||int8 - native|| / ||native||) and largest chunk "
        f"error {int8[1]:.3f} half steps (readings); bucket 0's wire bytes "
        f"({int8[2]} B) equal the CPU's")
    del grads, leaves, ref_leaves, native
    torch.cuda.empty_cache()
    return {f"gradsync {LANE_ARCH}": launches}


def check_int8(topo, grads, ref_leaves, K):
    """lane_int8 at p = 1, where its result is known exactly: every
    bucket's f32 values quantized and dequantized (``compress_int8`` then
    ``decompress_int8``, on the card), then cast to each leaf's dtype.
    Gated: the synced leaves equal that exactly; the dequantized f32
    values lie within ``repro``'s half step of the gradients; bucket 0's
    packed bytes on the card equal the CPU's.  Read, not gated: the
    relative error of the synced leaves and their worst chunk error in
    half steps (the cast to the leaves' dtype on top)."""
    flat_x, _ = gradsync._flatten_bucket(
        _tree.unflatten(grads, ref_leaves), pad_to=K * topo.n())
    bsz = flat_x.shape[0] // K
    x0 = flat_x[:bsz]
    card = gradsync.pack_int8_payload(*gradsync.compress_int8(x0)[:2])
    cpu = gradsync.pack_int8_payload(*gradsync.compress_int8(x0.cpu())[:2])
    if not torch.equal(card.cpu(), cpu):
        raise RuntimeError("lane_int8: bucket 0's wire bytes on the card "
                           "differ from the CPU's")
    nbytes = card.numel()
    del card, cpu
    flat_y, _ = gradsync._flatten_bucket(grads, pad_to=K * topo.n())
    worst, e2, x2 = 0.0, 0.0, 0.0
    for b in range(K):
        sl = slice(b * bsz, (b + 1) * bsz)
        ratio, e, x = _int8_chunk_error(flat_x[sl], flat_y[sl])
        worst, e2, x2 = max(worst, ratio), e2 + e, x2 + x
    del flat_y
    deq_worst = 0.0
    for b in range(K):                   # flat_x becomes the expected sync
        sl = slice(b * bsz, (b + 1) * bsz)
        deq = gradsync.decompress_int8(*gradsync.compress_int8(flat_x[sl]))
        deq_worst = max(deq_worst, _int8_chunk_error(flat_x[sl], deq)[0])
        flat_x[sl] = deq
    # f32 rounding of x/scale and of q*scale: < 2 * 127 * 2^-24 of a step
    if deq_worst > 1 + 2.0 ** -14:
        raise RuntimeError(f"lane_int8: dequantized values past the half "
                           f"step ({deq_worst:.6f} of it)")
    ofs, bad = 0, 0
    for g in _tree.leaves(grads):   # the flat buffer's order
        want = flat_x[ofs:ofs + g.numel()].view(g.shape).to(g.dtype)
        bad += int((g != want).sum())
        ofs += g.numel()
    if bad:
        raise RuntimeError(f"lane_int8: {bad} elements differ from the "
                           f"gradients quantized, dequantized and cast")
    del flat_x
    return (e2 / x2) ** 0.5, worst, nbytes, deq_worst


def phase_lane_cpu() -> None:
    """8d, on the CPU (gloo), not the card: 4 spawned ranks, 2 pods x 2,
    train LANE_ARCH --smoke for 3 steps with --gradsync lane
    --gradsync-buckets 4; the losses equal the one-process run's on the
    same global batch within LANE_CPU_TOL, the parameters are bitwise
    equal across ranks.  This is how the chip machine's torch gets its
    torch.distributed calls checked."""
    ranks = mesh.spawn(train.rank_worker, 4, LANE_CPU_ARGV)
    one = train.main([a for a in LANE_CPU_ARGV if a not in ("--pods", "2")])
    digests = {d for _, d in ranks}
    for losses, _ in ranks:
        err = max(abs(a - b) / abs(b) for a, b in zip(losses, one))
        if len(losses) != 3 or err > LANE_CPU_TOL:
            raise RuntimeError(f"4-rank losses {losses} against one "
                               f"process {one}")
    if len(digests) != 1:
        raise RuntimeError(f"parameters differ across ranks: {digests}")
    log("lanes", f"cpu, gloo (torch {torch.__version__}), not the card: 4 "
        f"ranks (2 pods x 2) train {LANE_ARCH} --smoke 3 steps with "
        f"--gradsync lane --gradsync-buckets 4: losses "
        f"{[round(x, 6) for x in ranks[0][0]]} equal the one-process run's "
        f"within {LANE_CPU_TOL:g} (worst {err:.2e}); parameters bitwise "
        f"equal on every rank")


def phase_lanes(name, first_loss, served) -> dict:
    """Phases 8 to 15 on one NCCL world (8d on the CPU after it)."""
    topo, init = timed("8a lane world", phase_lane_world)
    try:
        timed("8b lane conformance", phase_lane_conformance, topo)
        launches = timed("8c gradient sync", phase_lane_gradsync, topo, name)
        with torch.enable_grad():
            timed("9a ZeRO card vs CPU", phase_zero_check, topo)
            launches.update(timed("9b ZeRO at full width", phase_zero_train,
                                  topo, name, first_loss))
        launches.update(timed("10 checkpoints and lane_zero3 serving",
                              phase_ckpt, topo, name, served))
        launches.update(timed("11 faults, quorum and restarts",
                              phase_faults, topo, name))
        torch.cuda.empty_cache()
        launches.update(timed("12 measured-cost tuning", phase_tuning,
                              topo, name))
        torch.cuda.empty_cache()
        launches.update(timed("13 tensor and expert parallelism",
                              phase_tp_ep, topo, name))
        torch.cuda.empty_cache()
        launches.update(timed("14 the recorder and serve_smoke",
                              phase_lint_smoke, topo, name))
        torch.cuda.empty_cache()
        launches.update(timed("15 the launch layer", phase_launch, topo,
                              name))
    finally:
        dist.destroy_process_group()
        init.unlink(missing_ok=True)
    with torch.enable_grad():
        timed("8d cpu gloo train", phase_lane_cpu)
    return launches


# ---------------------------------------------------------------------------
# phase 9: ZeRO training (lane_zero1, lane_zero3) on the one-rank world
# ---------------------------------------------------------------------------

# mode: (gradsync, fsdp_prefetch, fsdp_regather)
ZERO_MODES = {"replicated": ("native", 0, False),
              "lane_zero1": ("lane_zero1", 0, False),
              "lane_zero3": ("lane_zero3", 0, False),
              "regather": ("lane_zero3", 0, True),
              "blocking": ("lane_zero3", -1, False)}
ZERO_CHECK_STEPS = 2
# 9a holds llama3.2-3b alone, the f32 card against the CPU: mamba2-780m's
# ZeRO state is held on the card by 9b (lane_zero3 at full width equal
# to "masters" at every step) and 10a (replicated, lane_zero1 and
# lane_zero3 saved, restored and resumed bit for bit), its f32 step
# against the CPU's by 7b; and the gather code is the family-agnostic
# block stack's
ZERO_CHECK_ARCHS = ("llama3.2-3b",)
ZERO_CHECK_MODES = ("lane_zero1", "lane_zero3", "regather", "blocking")
# 9b: 5 bf16 steps at 4 x 1024 tokens, AdamW with no clipping (the clip
# norm is still computed): the one rounding that tells the layouts
# apart is the clip norm's sum, taken in another order by each (PERF.md
# §6: with the clip, mamba2-780m's lane_zero3 and "masters" part by
# 2.1e-4 at step 2 and 1.0e-2 at step 5; without it, every pair below
# is equal), and the clip's arithmetic is held card against CPU in 9a.
# Step 1 of every run equals its replicated step's exactly (the same
# bf16 weights through the same forward) and phase 7c's first loss.
# Each run's steps 2-5 must equal those of the run ZERO_GATE names,
# whose parameters round to bf16 the same way: lane_zero1 the replicated
# step's (both update the bf16 weights), lane_zero3 those of "masters",
# and regather and blocking lane_zero3's.  "masters" is the witness for
# lane_zero3's f32 masters that shares none of the ZeRO code
# (masters_step): the replicated step's bf16 forward and backward with
# AdamW on f32 copies of the parameters.  It equals the replicated step
# at step 2 only: its first update, cast to bf16, is the replicated
# step's rounded update; from then on the masters keep the updates below
# half a bf16 ulp that the replicated bf16 parameters drop, and from
# this init the loss moves erratically (103 -> 70 -> 227 -> 1635), so
# the two part by up to 2x (printed).  Each run's references come
# before it in ZERO_RUNS.
ZERO_STEPS = 5
ZERO_RUNS = (("llama3.2-3b", "replicated"), ("llama3.2-3b", "lane_zero1"),
             ("llama3.2-3b", "masters"), ("llama3.2-3b", "lane_zero3"),
             ("llama3.2-3b", "regather"), ("llama3.2-3b", "blocking"),
             ("mamba2-780m", "replicated"), ("mamba2-780m", "masters"),
             ("mamba2-780m", "lane_zero3"))
# the run each mode's steps 2-5 are held to, and how many of them
ZERO_GATE = {"lane_zero1": ("replicated", ZERO_STEPS),
             "masters": ("replicated", 2),
             "lane_zero3": ("masters", ZERO_STEPS),
             "regather": ("lane_zero3", ZERO_STEPS),
             "blocking": ("lane_zero3", ZERO_STEPS)}


def masters_step(cfg, opt, params, microbatch=0):
    """(step, state, opt_state) of the witness "masters": the replicated
    step's bf16 forward and backward (its microbatching included), then
    ``optim.adamw_update`` on f32 master copies of the parameters, which
    are then cast into the bf16 parameters, as lane_zero3 casts its f32
    masters into the rows it gathers.  No sharding, gather, transpose or
    flat AdamW."""
    run = RunConfig(model=cfg, microbatch=microbatch)
    vg = steps._microbatched(steps._value_and_grad(steps._make_loss(run)),
                             run.microbatch, steps._accum_dtype(run))
    masters = _tree.tree_map(lambda p: p.detach().float(), params)
    params = _tree.tree_map(lambda p: p.requires_grad_(True), params)

    def step(params, opt_state, tokens, labels):
        loss, grads = vg(params, tokens, labels, None)
        with torch.no_grad():
            adamw_update(opt, grads, opt_state, masters)
            for p, m in zip(_tree.leaves(params), _tree.leaves(masters)):
                p.copy_(m)
        return loss, params, opt_state
    step.full_params = lambda params: params
    return step, params, adamw_init(masters)


def zero_run(cfg, mode, topo, params, *, steps_n, batch, seq, device, opt,
             microbatch=0, full=True):
    """``steps_n`` steps of ``cfg`` in ``mode`` through
    ``launch.steps.build_train_step`` / ``init_lane_train_state`` with
    ``single=False`` on ``topo`` (the code the ranks of a multi-pod world
    run), from ``params`` (moved to ``device``), on SyntheticLM seed 0
    batches: (losses, step seconds each synchronised, the whole parameter
    tree after the last step (None unless ``full``), layer gathers)."""
    if mode == "masters":
        step, state, opt_state = masters_step(cfg, opt, params, microbatch)
    else:
        gradsync, pre, regather = ZERO_MODES[mode]
        run = RunConfig(model=cfg, gradsync=gradsync, fsdp_prefetch=pre,
                        fsdp_regather=regather, microbatch=microbatch)
        comm = LaneComm(topo, CommConfig.from_run(run))
        step = steps.build_train_step(run, opt, comm, single=False)
        state, opt_state, _ = steps.init_lane_train_state(run, params, comm,
                                                       single=False,
                                                       device=device)
    del params
    loader = make_loader(cfg, seq, batch, seed=0)
    gathers = getattr(step, "gathers", None)
    g0 = gathers[0].gathers if gathers else 0
    losses, seconds = [], []
    for s in range(steps_n):
        toks, labels = (torch.as_tensor(a, device=device)
                        for a in loader.batch_at(s))
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, state, opt_state = step(state, opt_state, toks, labels)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
    layer_gathers = (gathers[0].gathers - g0) if gathers else 0
    full = step.full_params(state) if full else None
    del state, opt_state
    return losses, seconds, full, layer_gathers


def phase_zero_check(topo) -> None:
    """9a: ZERO_CHECK_ARCHS at full width cut to CHECK_LAYERS
    layers, f32, 1 x CHECK_T tokens, ZERO_CHECK_STEPS steps of each of
    ZERO_CHECK_MODES on the card (NCCL, one rank) against lane_zero3 on
    the CPU (a gloo group of the same one rank): every loss within
    CARD_LOSS_TOL, and the parameters after the last step within
    UPDATE_TOL x lr of the CPU's at all but FLIP_SHARE of the elements.
    The CPU runs lane_zero3 once: its modes, and lane_zero1, are the same
    f32 arithmetic up to the order of the global norm's sum (pinned on
    the CPU, 4 ranks, by tests/test_torch_train_zero.py).  The weights
    go to the card once and each mode starts from a copy made there."""
    cpu_group = dist.new_group([0], backend="gloo")
    cpu_topo = LaneTopology(1, 1, lane_rank=0, node_rank=0,
                            node_group=cpu_group, lane_group=cpu_group,
                            group=cpu_group, node_ranks=[0], lane_ranks=[0],
                            ranks=[0])
    opt = AdamWConfig(warmup_steps=0, total_steps=ZERO_CHECK_STEPS)
    kw = dict(steps_n=ZERO_CHECK_STEPS, batch=1, seq=CHECK_T, opt=opt)
    for arch in ZERO_CHECK_ARCHS:
        cfg = dataclasses.replace(resolve(arch), num_layers=CHECK_LAYERS,
                                  dtype="float32")
        params0 = init_model(cfg, seed=0, device="cpu")
        before = {p: t.clone() for p, t in _tree.flatten(params0)}
        on_card = _tree.tree_map(lambda t: t.to("cuda"), params0)
        t0 = time.perf_counter()
        want, _, full, _ = zero_run(cfg, "lane_zero3", cpu_topo, params0,
                                    device="cpu", **kw)
        want_p, t_cpu = dict(_tree.flatten(full)), time.perf_counter() - t0
        del full, params0
        for mode in ZERO_CHECK_MODES:
            fa.launches = k2.launches = 0
            losses, _, full, gathers = zero_run(
                cfg, mode, topo, _tree.tree_map(torch.clone, on_card),
                device="cuda", **kw)
            torch.cuda.synchronize()
            e_l = max(abs(a - b) / max(abs(b), 1e-12)
                      for a, b in zip(losses, want))
            paths = [p for p, _ in _tree.flatten(full)]
            got_p = dict(_tree.flatten(full))
            share, worst = _step_err([got_p[p] for p in paths],
                                     [want_p[p] for p in paths],
                                     [before[p] for p in paths], opt.lr)
            log("zero", f"{arch} {CHECK_LAYERS} layers at full width, f32, "
                f"B1 T{CHECK_T}, {ZERO_CHECK_STEPS} steps of {mode}, card "
                f"(NCCL, p=1) vs CPU (lane_zero3, gloo, p=1; {t_cpu:.1f} s): "
                f"losses {[round(x, 6) for x in losses]}, worst "
                f"{e_l:.3e} (tol {CARD_LOSS_TOL:.0e}); parameters off by "
                f"> {UPDATE_TOL:.0e} lr at {share:.3e} of the elements (tol "
                f"{FLIP_SHARE:.0e}), largest {worst:.3e} lr; layer gathers "
                f"{gathers}; launches K1/K2 {(fa.launches, k2.launches)}")
            if not (e_l <= CARD_LOSS_TOL and share <= FLIP_SHARE):
                raise RuntimeError(f"{arch} {mode}: the card's ZeRO steps "
                                   f"disagree with the CPU's")
            del full, got_p
            torch.cuda.empty_cache()
        del on_card
        torch.cuda.empty_cache()
    dist.destroy_process_group(cpu_group)


def phase_zero_train(topo, name, first_loss) -> dict:
    """9b: ZERO_STEPS bf16 steps at full width, TRAIN_BATCH x TRAIN_SEQ
    tokens, of each of ZERO_RUNS: step ms (median of steps 3-5), peak
    memory beside the replicated step's, layer gathers and K1/K2
    launches per step, and the losses held equal as ZERO_GATE says.  A
    layout that does not fit prints its OOM, and then every
    run goes again at --microbatch 2; one that does not fit there either
    fails the phase.  The witness's launches are not the main
    path's and stay out of the returned counts."""
    opt = AdamWConfig(warmup_steps=1, total_steps=ZERO_STEPS,
                      clip_norm=float("inf"))
    rel = lambda a, b: [abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b)]
    bad = []
    for mb in (0, 2):
        out, launches, oom = {}, {}, []
        for arch, mode in ZERO_RUNS:
            cfg = resolve(arch)
            L = cfg.num_layers
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fa.launches = k2.launches = 0
            try:
                losses, sec, _, gathers = zero_run(
                    cfg, mode, topo, init_model(cfg, seed=0, device="cuda"),
                    steps_n=ZERO_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    device="cuda", opt=opt, microbatch=mb, full=False)
            except torch.cuda.OutOfMemoryError as e:
                log("zero", f"{name} | {arch} {mode} microbatch {mb}: OOM "
                    f"at 4 x 1024: {str(e).splitlines()[0]}")
                oom.append((arch, mode))
                continue
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            gathers /= ZERO_STEPS
            per = {"flash_attention": fa.launches / ZERO_STEPS,
                   "ssd": k2.launches / ZERO_STEPS}
            if mode != "masters":
                launches[f"zero {arch} {mode}" + (f" mb{mb}" if mb
                                                  else "")] = {
                    "flash_attention": fa.launches, "ssd": k2.launches}
            out[arch, mode] = (losses, peak)
            # per forward, and one forward per microbatch
            fwd = max(mb, 1)
            want = {"flash_attention": fwd * (2 * L if mode == "regather"
                                              else L)
                    if cfg.family == "dense" else 0,
                    "ssd": fwd * L if cfg.family == "ssm" else 0}
            want_g = 0 if mode in ("replicated", "lane_zero1", "masters") \
                else fwd * (2 * L if mode == "regather" else L)
            rep = out.get((arch, "replicated"))
            # the same weights and batch as phase 7c's first step (but
            # not its microbatching)
            first = first_loss[arch] if mode == "replicated" and not mb \
                else rep[0][0] if rep else None
            gate, upto = ZERO_GATE.get(mode, (None, 0))
            ref = out.get((arch, gate))
            drift = max(rel(losses[1:upto], ref[0][1:upto]), default=0.0) \
                if ref else None
            steps_ = "step 2" if upto == 2 else f"steps 2-{upto}"
            log("zero", f"{name} | {arch} {mode}" + (f" microbatch {mb}"
                if mb else "") + f": step {np.median(sec[2:]) * 1e3:.1f} ms "
                f"(median of steps 3-{ZERO_STEPS}, synchronised), peak "
                f"{peak:.2f} GiB (replicated "
                + (f"{rep[1]:.2f}" if rep else "not measured") + " GiB), "
                f"layer gathers per step {gathers:g} (want {want_g}), K1/K2 "
                f"launches per step {per['flash_attention']:g}/"
                f"{per['ssd']:g} (want {want['flash_attention']}/"
                f"{want['ssd']}); losses {[round(x, 5) for x in losses]}; "
                f"step 1 {losses[0]!r} vs {first!r}"
                + (" (phase 7c)" if mode == "replicated" and not mb else "")
                + "; relative to the replicated step's "
                + str([f"{x:.2e}" for x in rel(losses, rep[0])] if rep
                      else "not measured")
                + (f"; {steps_} {drift:.3e} from {gate}'s (must be 0)"
                   if drift is not None else ""))
            if first is None or (gate and ref is None):
                # a reference ran out of memory: this pass is run again
                # at microbatch 2, or fails below
                continue
            if losses[0] != first:
                bad.append(f"{arch} {mode} microbatch {mb}: step 1's loss "
                           f"{losses[0]!r} is not {first!r}")
            if drift is not None and drift != 0:
                bad.append(f"{arch} {mode} microbatch {mb}: {steps_} "
                           f"{drift:.3e} from {gate}'s")
            if gathers != want_g or per != {k: float(v)
                                            for k, v in want.items()}:
                bad.append(f"{arch} {mode} microbatch {mb}: gathers "
                           f"{gathers}, launches {per}")
            if not all(np.isfinite(losses)):
                bad.append(f"{arch} {mode} microbatch {mb}: losses {losses}")
        if not oom:
            break
        log("zero", f"{name} | {len(oom)} run(s) did not fit at 4 x 1024 "
            f"with microbatch {mb} ({oom})"
            + (": every run again at --microbatch 2" if not mb else ""))
    if oom:
        raise RuntimeError(f"ZeRO runs out of memory even at --microbatch "
                           f"2: {oom}")
    missing = [r for r in ZERO_RUNS if r not in out]
    if missing:
        raise RuntimeError(f"ZeRO runs without a result: {missing}")
    if bad:
        raise RuntimeError("; ".join(bad))
    return launches


# ---------------------------------------------------------------------------
# phase 10: checkpoints, and serving from them under lane_zero3
# ---------------------------------------------------------------------------

# mode: gradsync
CKPT_MODES = {"replicated": "native", "lane_zero1": "lane_zero1",
              "lane_zero3": "lane_zero3"}
CKPT_ARCH = "mamba2-780m"
# 10a's layouts per model (phase_ckpt_exact says why llama takes none)
CKPT_EXACT = {"mamba2-780m": tuple(CKPT_MODES)}
CKPT_ARGV = ["--arch", CKPT_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
             str(TRAIN_SEQ), "--device", "cuda", "--log-every", "1"]
SERVE_ARCH = "llama3.2-3b"
SERVE_T = 512


def _ckpt_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent / "build" / "ckpt"


def canonical(d, cfg):
    """A checkpoint's state in the replicated form (CPU tensors)."""
    man, state, _ = steps.load_canonical_state(str(d), cfg)
    return steps.state_to_replicated(cfg, man["layout"], state)


def host_canonical(tree, layout, cfg):
    """A checkpoint tree (``state_to_host``'s) in the replicated form."""
    canon = _tree.unflatten(tree, [layout.to_canonical(p, host_array(leaf))
                                   for p, leaf in _tree.flatten(tree)])
    return steps.state_to_replicated(cfg, layout.manifest_entry(), canon)


def states_equal(a, b) -> bool:
    """Two states (any layout, any device; ints for the step counts) hold
    the same leaves bit for bit."""
    la, lb = _tree.leaves(a), _tree.leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(la, lb))


def same_files(a, b) -> list:
    """What differs between two committed steps: arr_<i>.npy files, and
    the manifests' step, layout and leaves."""
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    bad = [k for k in ("step", "layout", "leaves") if ma[k] != mb[k]]
    return bad + [i for i in range(len(ma["leaves"]))
                  if not filecmp.cmp(a / f"arr_{i}.npy", b / f"arr_{i}.npy",
                                     shallow=False)]


def ckpt_layout(cfg, mode):
    if mode == "lane_zero1":
        return steps.zero1_checkpoint_layout(init_model(cfg, device="meta"),
                                             1)
    if mode == "lane_zero3":
        return steps.zero3_checkpoint_layout(cfg, 1, 1)
    return REPLICATED


def phase_ckpt_exact(topo, root) -> None:
    """10a: mamba2-780m at full width cut to CHECK_LAYERS layers, f32, 1 x
    CHECK_T tokens, in the layouts of CKPT_EXACT (``single=False`` on the
    1 x 1 topology): 2 steps on the card, the state saved from the card
    and, copied to the CPU, into a second directory (identical files and
    manifests); restored on the card into its own layout (equal to the
    state saved, leaf for leaf) and step 3 taken from it against the
    uninterrupted step 3 (exact; if not, a second uninterrupted run says
    how far apart two runs are, and the resumed step may be no further);
    restored into every other layout, each restore's canonical form
    bit-identical to the saved one's; and on its lane_zero3 checkpoint
    one flipped byte: an explicit step raises CheckpointCorruptError,
    step=None falls back to the earlier step.  llama3.2-3b's 2-layer
    state is 7.2 GB (its 394 M-row embedding and its moments), and the
    host moves ~1 GB/s on the card's machine (PERF.md §5): its save,
    restore and resume in every layout are phase 15b's, at smoke width
    on this world, and its lane_zero3 checkpoint served at full width is
    10c's."""
    opt = AdamWConfig(warmup_steps=0, total_steps=3)
    modes = list(CKPT_MODES)
    bad = []
    for arch in CKPT_EXACT:
        cfg = dataclasses.replace(resolve(arch), num_layers=CHECK_LAYERS,
                                  dtype="float32")
        loader = make_loader(cfg, CHECK_T, 1, seed=0)
        batches = [tuple(torch.as_tensor(a, device="cuda")
                         for a in loader.batch_at(s)) for s in range(3)]
        params0 = init_model(cfg, seed=0, device="cuda")
        for mode in CKPT_EXACT[arch]:
            run = RunConfig(model=cfg, gradsync=CKPT_MODES[mode])
            comm = LaneComm(topo, CommConfig.from_run(run))
            step = steps.build_train_step(run, opt, comm, single=False)

            def train(stop):
                p, o, layout = steps.init_lane_train_state(
                    run, _tree.tree_map(torch.clone, params0), comm,
                    single=False, device="cuda")
                losses = []
                for s in range(stop):
                    loss, p, o = step(p, o, *batches[s])
                    losses.append(float(loss))
                return losses, p, o, layout
            losses, p, o, layout = train(2)
            d = root / arch / mode
            t0 = time.perf_counter()
            save_checkpoint(str(d / "card"), 2,
                            steps.state_to_host(run, layout, p, o, comm),
                            layout)
            t_card = time.perf_counter() - t0
            cpu = lambda tree: _tree.tree_map(
                lambda t: t.detach().cpu() if torch.is_tensor(t) else t, tree)
            save_checkpoint(str(d / "cpu"), 2, steps.state_to_host(
                run, layout, cpu(p), cpu(o), comm), layout)
            diff = same_files(d / "card" / "step_2", d / "cpu" / "step_2")
            shutil.rmtree(d / "cpu")
            t0 = time.perf_counter()
            (rp, ro), _ = steps.restore_lane_train_state(
                str(d / "card"), run, layout, comm, device="cuda")
            t_rest = time.perf_counter() - t0
            same = states_equal((rp, ro), (p, o))
            loss3 = float(step(p, o, *batches[2])[0])
            loss3r = float(step(rp, ro, *batches[2])[0])
            del p, o, rp, ro
            apart = abs(loss3r - loss3)
            noise = 0.0 if apart == 0 else abs(loss3 - train(3)[0][2])
            log("ckpt", f"{arch} {CHECK_LAYERS} layers at full width, f32, "
                f"{mode}: 2 steps {[round(x, 6) for x in losses]}; saved "
                f"from the card in {t_card:.2f} s, from a CPU copy: "
                + ("identical files and manifest" if not diff
                   else f"DIFFERENT {diff}") + f"; restored in "
                f"{t_rest:.2f} s: " + ("equal to the state saved" if same
                                       else "DIFFERENT from the state saved")
                + f"; resumed step 3 {loss3r!r} vs uninterrupted {loss3!r}: "
                f"apart {apart:.3e}" + (f" (two uninterrupted runs "
                                        f"{noise:.3e})" if apart else ""))
            if diff or not same or apart > noise:
                bad.append(f"{arch} {mode}: files {diff}, restore equal "
                           f"{same}, step 3 apart {apart:.3e}")
            torch.cuda.empty_cache()
        pairs = [(a, b) for a in modes for b in modes if a != b]
        for src in dict.fromkeys(a for a, _ in pairs):
            d = root / arch / src / "card"
            want = canonical(d, cfg)
            for tgt in (b for a, b in pairs if a == src):
                run = RunConfig(model=cfg, gradsync=CKPT_MODES[tgt])
                comm = LaneComm(topo, CommConfig.from_run(run))
                layout = ckpt_layout(cfg, tgt)
                t0 = time.perf_counter()
                (p, o), _ = steps.restore_lane_train_state(
                    str(d), run, layout, comm, device="cuda")
                t_rest = time.perf_counter() - t0
                got = host_canonical(steps.state_to_host(run, layout, p, o,
                                                         comm), layout, cfg)
                del p, o
                same = states_equal(got, want)
                log("ckpt", f"{arch} {src} checkpoint restored as {tgt} on "
                    f"the card in {t_rest:.2f} s: canonical form "
                    + ("bit-identical" if same else "DIFFERENT"))
                if not same:
                    bad.append(f"{arch} {src} -> {tgt}: canonical form "
                               f"differs")
            del want
        if arch == CKPT_ARCH:
            d = root / arch / "lane_zero3" / "card"
            shutil.copytree(d / "step_2", d / "step_1")
            f = d / "step_2" / "arr_0.npy"
            raw = bytearray(f.read_bytes())
            raw[-1] ^= 0xFF
            f.write_bytes(bytes(raw))
            run = RunConfig(model=cfg, gradsync="lane_zero3")
            comm = LaneComm(topo, CommConfig.from_run(run))
            layout = ckpt_layout(cfg, "lane_zero3")
            try:
                steps.restore_lane_train_state(str(d), run, layout, comm,
                                               step=2, device="cuda")
                raised = None
            except CheckpointCorruptError as e:
                raised = str(e)
            (p, o), got = steps.restore_lane_train_state(
                str(d), run, layout, comm, device="cuda")
            del p, o
            log("ckpt", f"{arch} lane_zero3, one byte of step 2's arr_0.npy "
                f"flipped: explicit step 2 "
                + (f"raised CheckpointCorruptError ({raised[:60]}...)"
                   if raised else "DID NOT RAISE")
                + f"; step=None restored step {got}")
            if raised is None or got != 1:
                bad.append(f"{arch}: the corrupt-leaf control failed "
                           f"(raised {raised is not None}, fell back to "
                           f"{got})")
        shutil.rmtree(root / arch, ignore_errors=True)
        torch.cuda.empty_cache()
    if bad:
        raise RuntimeError("; ".join(bad))


def _host_room(path) -> str:
    free = shutil.disk_usage(path).free / 1e9
    avail = "not measured"
    try:
        for line in pathlib.Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("MemAvailable:"):
                avail = f"{int(line.split()[1]) * 1024 / 1e9:.1f} GB"
    except OSError:
        pass
    return f"free disk {free:.1f} GB, host RAM available {avail}"


def phase_ckpt_train(topo, root, name) -> dict:
    """10b: mamba2-780m at full width, bf16, TRAIN_BATCH x TRAIN_SEQ,
    through ``launch.train.run --gradsync lane_zero3`` on the 1 x 1
    topology: 4 steps with --ckpt-every 2 (checkpoints at 2 and 4), then
    step 4 removed and the run again: it resumes at step 2 and its steps
    3-4 must equal the first run's (exactly; if not, a second
    uninterrupted run says how far apart two runs are, and the resumed
    losses may be no further).  Per
    save the loop's blocking ms (the copy to the host), the writer's
    seconds, GB and GB/s, and the restore's seconds.  Then the step-4
    zero3 checkpoint restored into the replicated bf16 layout: every
    parameter equals its f32 master cast to its dtype (the resumed run's
    parameters, gathered from the masters on the card), and one
    --gradsync native step from it (the batch of step 5) has a finite
    loss."""
    cfg = resolve(CKPT_ARCH)
    d = root / "train"
    log("ckpt", f"{name} | before 10b: {_host_room(root)}")
    argv = [*CKPT_ARGV, "--steps", "4", "--gradsync", "lane_zero3"]
    fa.launches = k2.launches = 0
    st = {}
    first = train.run([*argv, "--ckpt", str(d), "--ckpt-every", "2"],
                      topo=topo, stats=st)[0]
    shutil.rmtree(d / "step_4")
    st2 = {}
    resumed, full4, _ = train.run(
        [*argv, "--ckpt", str(d), "--ckpt-every", "2"], topo=topo,
        stats=st2)
    torch.cuda.synchronize()
    apart = max(abs(a - b) for a, b in zip(resumed, first[2:]))
    second = train.run(argv, topo=topo)[0] if apart else first
    noise = max(abs(a - b) for a, b in zip(first[2:], second[2:]))
    for rec in st["saves"] + st2["saves"]:
        gb = rec["bytes"] / 1e9
        log("ckpt", f"{name} | {CKPT_ARCH} lane_zero3 save at step "
            f"{rec['step']}: loop blocked {rec['copy_s'] * 1e3:.1f} ms (the "
            f"copy to the host), writer {rec['write_s']:.2f} s, {gb:.2f} GB, "
            f"{gb / rec['write_s']:.2f} GB/s")
    log("ckpt", f"{name} | {CKPT_ARCH} lane_zero3, bf16, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}: uninterrupted {first}; restored step 2 in "
        f"{st2['restore_s']:.2f} s and resumed: {resumed} (apart "
        f"{apart:.3e}" + (f"; a second uninterrupted run {second}, "
                          f"{noise:.3e} apart" if apart else "") + ")")
    if len(resumed) != 2 or apart > noise:
        raise RuntimeError(f"the resumed run's losses {resumed} depart "
                           f"from the uninterrupted {first[2:]}")
    # the step-4 zero3 checkpoint into the replicated bf16 layout, and one
    # --gradsync native step from it (the driver's step on the batch of
    # step 5)
    run = RunConfig(model=cfg, gradsync="native")
    comm = LaneComm(topo, CommConfig.from_run(run))
    t0 = time.perf_counter()
    (p, o), got = steps.restore_lane_train_state(str(d), run, REPLICATED,
                                                 comm, step=4, device="cuda")
    t_cross = time.perf_counter() - t0
    # the resumed run's last parameters are its f32 masters cast to each
    # leaf's dtype on the card (the rows gathered and cast by the
    # ZeRO-3 step's own gather)
    same = states_equal([p], [full4])
    del full4
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=5)
    step = steps.build_train_step(run, opt, comm, single=False)
    toks, labels = (torch.as_tensor(a, device="cuda") for a in make_loader(
        cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0).batch_at(4))
    native = float(step(p, o, toks, labels)[0])
    del p, o
    torch.cuda.synchronize()
    log("ckpt", f"{name} | the step-{got} lane_zero3 checkpoint restored as "
        f"the replicated bf16 layout in {t_cross:.2f} s: every parameter "
        + ("equals" if same else "DIFFERS from")
        + f" its f32 master cast to its dtype (bf16; A_log, D and dt_bias "
        f"f32; the resumed run's gathered parameters); one native step "
        f"from it: {native!r}; K1/K2 launches in 10b "
        f"{(fa.launches, k2.launches)}")
    if not same or not np.isfinite(native):
        raise RuntimeError("the cross-layout restore into the replicated "
                           "bf16 run failed")
    return {"ckpt train": {"flash_attention": fa.launches,
                           "ssd": k2.launches}}


def serve_perf(cfg, batcher, name, label):
    """Prefill ms at T=SERVE_T, decode ms at SLOTS slots, layer gathers
    per decode step, under ``batcher``'s hosting."""
    step, hosted = batcher.step, batcher.hosted
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (1, SERVE_T), generator=g,
                         device="cuda")
    pre = host_ms(lambda: step.prefill(hosted, toks, SERVE_T, None), reps=3)
    tok = np.zeros((SLOTS, 1), np.int64)
    dec = host_ms(lambda: step.decode(hosted, tok, batcher.state), reps=10,
                  warmup=2)
    g0 = step.gathers()
    step.decode(hosted, tok, batcher.state)
    per = step.gathers() - g0
    log("ckpt", f"{name} | {cfg.name} {label}: prefill T={SERVE_T} "
        f"{pre:.3f} ms, decode ({SLOTS} slots) {dec:.3f} ms/step, layer "
        f"gathers per decode step {per}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return per


def serve_hosted(cfg, params, hosting, topo, kv, max_seq=1024):
    """Serve the path's requests under ``hosting``: (tokens, launches,
    the batcher)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batcher = ContinuousBatcher(params, cfg, slots=SLOTS, max_seq=max_seq,
                                device="cuda", hosting=hosting,
                                topo=topo if hosting == "lane_zero3" else None,
                                kv_strategy=kv)
    reqs = scenario(cfg, max_seq)
    fa.launches = k2.launches = 0
    _, stats = batcher.run(reqs)
    torch.cuda.synchronize()
    if stats["hosting"] != hosting:
        raise RuntimeError(f"asked for {hosting}, served {stats['hosting']}")
    return [list(r.out) for r in reqs], {"flash_attention": fa.launches,
                                         "ssd": k2.launches}, batcher


def phase_ckpt_serve(topo, root, name, served) -> dict:
    """10c: ``load_serve_params`` on 10b's step-4 checkpoint, served at
    full width (8 ``mixed`` requests, 4 slots) under replicated and under
    lane_zero3 with the ``lane`` and the ``native`` kv_splice: the same
    tokens, K2 launches equal and L per prefill; then llama3.2-3b from
    phase 5's seed-0 bf16 weights under lane_zero3: phase 5's replicated
    tokens, K1 L per prefill.  Each model's prefill ms at T=SERVE_T,
    decode ms, layer gathers per decode step (L under lane_zero3) and
    peak memory under both hostings (llama3.2-3b's replicated ones are
    phase 5's and 6's lines of the same run)."""
    out, bad = {}, []
    cfg = resolve(CKPT_ARCH)
    params, step4 = load_serve_params(str(root / "train"), cfg, step=4,
                                      device="cuda")
    shutil.rmtree(root / "train", ignore_errors=True)
    want = expected_launches(cfg, N_REQ)
    tokens = {}
    for hosting, kv in (("replicated", "lane"), ("lane_zero3", "lane"),
                        ("lane_zero3", "native")):
        label = hosting + (f" (kv_splice {kv})" if hosting == "lane_zero3"
                           else "")
        tokens[label], launches, batcher = serve_hosted(cfg, params, hosting,
                                                        topo, kv)
        out[f"ckpt serve {CKPT_ARCH} {label}"] = launches
        log("ckpt", f"{name} | {CKPT_ARCH} from the step-{step4} checkpoint, "
            f"{label}: launches {launches} (want {want})")
        if launches != want:
            bad.append(f"{CKPT_ARCH} {label}: launches {launches}")
        if kv == "lane":
            per = serve_perf(cfg, batcher, name, label)
            if hosting == "lane_zero3" and per != cfg.num_layers:
                bad.append(f"{CKPT_ARCH}: {per} gathers per decode step")
        del batcher
    ref_tokens = tokens["replicated"]
    for label, toks in tokens.items():
        if toks != ref_tokens:
            bad.append(f"{CKPT_ARCH} {label}: tokens differ from replicated")
    log("ckpt", f"{name} | {CKPT_ARCH}: tokens identical under every "
        f"hosting: {all(t == ref_tokens for t in tokens.values())}")
    del params
    cfg = resolve(SERVE_ARCH)
    want = expected_launches(cfg, N_REQ)
    for hosting in ("lane_zero3",):
        params = init_model(cfg, seed=0, device="cuda")
        toks, launches, batcher = serve_hosted(cfg, params, hosting, topo,
                                               "lane")
        del params
        if hosting == "lane_zero3":
            out[f"ckpt serve {SERVE_ARCH} lane_zero3"] = launches
        per = serve_perf(cfg, batcher, name, hosting)
        log("ckpt", f"{name} | {SERVE_ARCH} {hosting}: launches {launches} "
            f"(want {want}); tokens "
            + ("equal phase 5's" if toks == served[SERVE_ARCH]
               else "DIFFER from phase 5's"))
        if toks != served[SERVE_ARCH] or launches != want:
            bad.append(f"{SERVE_ARCH} {hosting}: tokens or launches")
        if hosting == "lane_zero3" and per != cfg.num_layers:
            bad.append(f"{SERVE_ARCH}: {per} gathers per decode step")
        del batcher
    if bad:
        raise RuntimeError("; ".join(bad))
    return out


def phase_ckpt(topo, name, served) -> dict:
    """Phase 10; its checkpoint directories (under build/, ignored by
    git) are removed at the end, also on failure."""
    root = _ckpt_root()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        with torch.enable_grad():
            timed("10a checkpoint exactness", phase_ckpt_exact, topo, root)
            launches = timed("10b train, checkpoint, resume",
                             phase_ckpt_train, topo, root, name)
        torch.cuda.empty_cache()
        launches.update(timed("10c serving from the checkpoint",
                              phase_ckpt_serve, topo, root, name, served))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        log("time", f"phase 10: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 11: the fault-tolerant runtime on the one-rank world
# ---------------------------------------------------------------------------

FAULT_STEPS = 4
FAULT_ARCH = "llama3.2-3b"
# 11b and 11c: FAULT_ARCH at full width cut to CHECK_LAYERS layers, bf16,
# 1 x CHECK_T tokens, registered under this name for launch.train.run
FAULT_CUT = "llama3.2-3b-cut"
FAULT_PLAN_A = "pod_slow@2:pod=0"


def _fault_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent / "build" / "faults"


def _run_logged(argv, topo, **kw):
    """``train.run(argv, topo=topo)``: (its result, stdout, stderr), both
    streams echoed after the run."""
    import contextlib
    import io
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            return train.run(argv, topo=topo, **kw), out.getvalue(), \
                err.getvalue()
    finally:
        sys.stdout.write(out.getvalue())
        sys.stderr.write(err.getvalue())
        sys.stdout.flush()


def phase_fault_quorum(topo, name) -> dict:
    """11a: FAULT_ARCH at full width, bf16, TRAIN_BATCH x TRAIN_SEQ,
    FAULT_STEPS steps through ``launch.train.run`` on the 1 x 1 topology
    (``single=False``), first ``--gradsync lane``, then ``--gradsync
    lane_quorum --fault-plan FAULT_PLAN_A --quorum-staleness 2``: steps
    0-1 (the full quorum) bit-identical to lane's; step 2 DEGRADED (the
    lone pod masked: loss exactly 0.0, the gradient 0, AdamW moving by its
    moments), HEALTHY -> DEGRADED at 2 and DEGRADED -> HEALTHY at 3, step
    3 finite; K1 once per layer and step in both; each run's step ms
    (median of steps 1-3, synchronised)."""
    cfg = resolve(FAULT_ARCH)
    base = ["--arch", FAULT_ARCH, "--steps", str(FAULT_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1",
            "--device", "cuda"]
    runs, out = {}, {}
    for label, extra in (("lane", ["--gradsync", "lane"]),
                         ("lane_quorum", ["--gradsync", "lane_quorum",
                                          "--fault-plan", FAULT_PLAN_A,
                                          "--quorum-staleness", "2"])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        with StepClock(trace_at=10 ** 9) as clock:
            fa.launches = k2.launches = 0
            losses = train.run(base + extra, topo=topo, stats=stats)[0]
            torch.cuda.synchronize()
            launches = {"flash_attention": fa.launches, "ssd": k2.launches}
        runs[label] = (losses, stats["events"], clock.seconds,
                       torch.cuda.max_memory_allocated() / 2**30)
        out[f"fault {label}"] = launches
        want = {"flash_attention": cfg.num_layers * FAULT_STEPS, "ssd": 0}
        ms = float(np.median(clock.seconds[1:])) * 1e3
        log("faults", f"{name} | {FAULT_ARCH} {label}"
            + (f" --fault-plan {FAULT_PLAN_A} --quorum-staleness 2"
               if label == "lane_quorum" else "")
            + f", bf16, {TRAIN_BATCH} x {TRAIN_SEQ}: losses {losses}; "
            f"step ms {[round(x * 1e3, 1) for x in clock.seconds]} "
            f"(median of steps 1-{FAULT_STEPS - 1} {ms:.1f} ms); launches "
            f"{launches} (want {want}); peak {runs[label][3]:.2f} GiB")
        if launches != want or len(losses) != FAULT_STEPS:
            raise RuntimeError(f"{label}: launches {launches}, want {want}; "
                               f"losses {losses}")
    (lane, _, t_lane, _), (quorum, events, t_q, _) = runs["lane"], \
        runs["lane_quorum"]
    got = [(e.step, e.old, e.new) for e in events]
    want_ev = [(2, "HEALTHY", "DEGRADED"), (3, "DEGRADED", "HEALTHY")]
    log("faults", f"{name} | full quorum (steps 0-1) "
        + ("bit-identical to" if quorum[:2] == lane[:2] else "DIFFERS from")
        + f" lane; step 2 DEGRADED, loss {quorum[2]!r}; step 3 "
        f"{quorum[3]!r}; transitions {got}; step ms lane "
        f"{np.median(t_lane[1:]) * 1e3:.1f}, lane_quorum "
        f"{np.median(t_q[1:]) * 1e3:.1f} (the DEGRADED step "
        f"{t_q[2] * 1e3:.1f})")
    if quorum[:2] != lane[:2] or quorum[2] != 0.0 \
            or not np.isfinite(quorum[3]) or got != want_ev:
        raise RuntimeError(f"the quorum run {quorum} against lane {lane}, "
                           f"transitions {got}")
    return out


def _cut_config():
    """Register FAULT_CUT: FAULT_ARCH at full width, CHECK_LAYERS layers."""
    from repro_torch.configs.base import register
    cut = lambda: dataclasses.replace(resolve(FAULT_ARCH),
                                      num_layers=CHECK_LAYERS)
    register(FAULT_CUT, cut, cut)
    return cut()


def phase_fault_ckpt(topo, root, name) -> dict:
    """11b: FAULT_CUT, bf16, 1 x CHECK_T tokens, ``--ckpt --ckpt-every 2
    --steps 4 --fault-plan "ckpt_io@2:count=2;corrupt_leaf@4:leaf=1"``:
    the step-2 save fails twice, commits on its third attempt and
    verifies; step 4 commits, then a flipped byte fails its
    verification; a second run with ``--steps 6`` resumes from step 2 and
    commits step 6, which verifies."""
    from repro_torch.checkpoint import latest_step, verify_checkpoint
    cfg = _cut_config()
    d = root / "ckpt"
    argv = ["--arch", FAULT_CUT, "--batch", "1", "--seq", str(CHECK_T),
            "--log-every", "1", "--device", "cuda", "--ckpt", str(d),
            "--ckpt-every", "2"]
    fa.launches = k2.launches = 0
    t0 = time.perf_counter()
    (losses, _, _), _, err = _run_logged(
        argv + ["--steps", "4", "--fault-plan",
                "ckpt_io@2:count=2;corrupt_leaf@4:leaf=1"], topo)
    verify_checkpoint(str(d), 2)
    retried = "attempt 1/3 failed" in err and "attempt 2/3 failed" in err
    try:
        verify_checkpoint(str(d), 4)
        caught = False
    except CheckpointCorruptError:
        caught = True
    (resumed, _, _), out, _ = _run_logged(argv + ["--steps", "6"], topo)
    verify_checkpoint(str(d), 6)
    launches = {"flash_attention": fa.launches, "ssd": k2.launches}
    ok = retried and caught and "resumed from step 2" in out \
        and latest_step(str(d)) == 6 and len(resumed) == 4
    log("faults", f"{name} | {FAULT_CUT} ({CHECK_LAYERS} layers, full "
        f"width), bf16, 1 x {CHECK_T}: step 2 retried twice and committed: "
        f"{retried}, verifies; step 4's flipped byte caught: {caught}; the "
        f"second run resumed from step 2: {'resumed from step 2' in out}, "
        f"committed step 6, verifies; losses {losses} then {resumed}; "
        f"launches {launches}; {time.perf_counter() - t0:.1f} s")
    want = cfg.num_layers * (4 + 4)
    if not ok or launches["flash_attention"] != want:
        raise RuntimeError(f"the checkpoint rungs failed (launches "
                           f"{launches}, want {want})")
    return {"fault ckpt": launches}


def phase_fault_restart(topo, root, name) -> dict:
    """11c: the lone pod lost, ``--gradsync lane_quorum --fault-plan
    pod_lost@1:pod=0 --quorum-staleness 1 --steps 4 --ckpt`` at 11b's
    size: DEGRADED at 1, RESTART at 2, the emergency checkpoint of step 2
    committed and verified, then ``repro``'s ValueError ("all slices of
    the outer batch axis lost") from the re-plan; the phase fails if it
    does not raise."""
    from repro_torch.checkpoint import latest_step, verify_checkpoint
    cfg = _cut_config()
    d = root / "restart"
    argv = ["--arch", FAULT_CUT, "--batch", "1", "--seq", str(CHECK_T),
            "--log-every", "1", "--device", "cuda", "--ckpt", str(d),
            "--gradsync", "lane_quorum", "--fault-plan", "pod_lost@1:pod=0",
            "--quorum-staleness", "1", "--steps", "4"]
    fa.launches = k2.launches = 0
    stats = {}
    try:
        _run_logged(argv, topo, stats=stats)
        raised = None
    except ValueError as e:
        raised = str(e)
    launches = {"flash_attention": fa.launches, "ssd": k2.launches}
    committed = latest_step(str(d))
    verify_checkpoint(str(d), 2)
    got = [(e.step, e.old, e.new) for e in stats.get("events", [])]
    log("faults", f"{name} | {FAULT_CUT} lane_quorum, the lone pod lost at "
        f"step 1, K=1: transitions {got}; emergency checkpoint step "
        f"{committed} committed and verified; the re-plan raised "
        f"{raised!r}; launches {launches}")
    if raised != "all slices of the outer batch axis lost" \
            or committed != 2 or got != [(1, "HEALTHY", "DEGRADED"),
                                         (2, "DEGRADED", "RESTART")] \
            or launches["flash_attention"] != cfg.num_layers * 2:
        raise RuntimeError("the RESTART rung did not commit, then refuse")
    return {"fault restart": launches}


def phase_faults(topo, name) -> dict:
    """Phase 11; its checkpoint directories (under build/, ignored by git)
    are removed at the end, also on failure."""
    root = _fault_root()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        with torch.enable_grad():
            launches = timed("11a quorum at full width", phase_fault_quorum,
                             topo, name)
            torch.cuda.empty_cache()
            launches.update(timed("11b checkpoint rungs", phase_fault_ckpt,
                                  topo, root, name))
            launches.update(timed("11c lone pod lost", phase_fault_restart,
                                  topo, root, name))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        log("time", f"phase 11: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 12: measured-cost tuning on the one-rank world
# ---------------------------------------------------------------------------

TUNE_ARCH = "llama3.2-3b"
TUNE_STEPS = 3


def _tune_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent / "build" / "tuning_phase"


def phase_tune_probe(topo, root, name) -> None:
    """12a: ``tuning.tune_smoke.tune`` at DEFAULT_LADDER on the card:
    each cell's median and minimum printed, the cache committed to
    ``root/cache.json`` (the file 12b starts from) and saved, loaded and
    saved again (the bytes must be identical), then ``fit_hw`` and
    ``build_report``: the constants, residuals and each cell's ratio are
    printed, and nothing is gated on them (at p = 1 the fit sees no lane
    level; the tolerance is infinite)."""
    from repro_torch.tuning import DEFAULT_LADDER
    from repro_torch.tuning.tune_smoke import tune
    rc, table, _, _, probe_s = tune(
        topo, device="cuda", cache=root / "cache.json",
        out=root / "report.json", ladder=DEFAULT_LADDER,
        tolerance=float("inf"))
    log("tune", f"{name} | probe at {DEFAULT_LADDER} B: {len(table)} cells "
        f"on {table.signatures()} in {probe_s:.2f} s; tune_smoke exit {rc}")
    if rc:
        raise RuntimeError(f"tune_smoke.tune exited {rc} (round trip or fit)")


def phase_tune_train(topo, root, name) -> dict:
    """12b: TUNE_ARCH at full width, bf16, TRAIN_BATCH x TRAIN_SEQ,
    TUNE_STEPS steps through ``launch.train.run`` on the 1 x 1 topology,
    three runs: (1) ``--gradsync auto --tune --tuning-cache C`` on 12a's
    cache C (the ladder is measured already, so nothing is probed): the
    gradient payload lies beyond the ladder, so the sync is ranked by the
    model and its misses are committed to C; (2) the same again: the
    worklist probe times exactly those payloads, the sync is ranked by
    measurement, the strategy is the table's argmin at the payload and
    C's misses are consumed; (3) ``--gradsync <that strategy>``: the
    losses of (2), bit for bit.  K1 once per layer and step in each."""
    from repro_torch.tuning import (load_misses, load_timing_table,
                                    topology_signature)
    cfg = resolve(TUNE_ARCH)
    cache = root / "cache.json"
    base = ["--arch", TUNE_ARCH, "--steps", str(TUNE_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1",
            "--device", "cuda"]
    tuned = ["--gradsync", "auto", "--tune", "--tuning-cache", str(cache)]
    want = {"flash_attention": cfg.num_layers * TUNE_STEPS, "ssd": 0}
    out, runs = {}, []

    def run(label, extra):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        with StepClock(trace_at=10 ** 9) as clock:
            fa.launches = k2.launches = 0
            t0 = time.perf_counter()
            losses, params, _ = train.run(base + extra, topo=topo,
                                          stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"flash_attention": fa.launches, "ssd": k2.launches}
        # the gradient sync's payload: every parameter as f32
        payload = 4 * sum(leaf.numel() for leaf in _tree.leaves(params))
        del params
        sels = {(x.strategy, x.source, x.payload_bytes)
                for x in stats["selections"]}
        tuning = stats.get("tuning", {})
        log("tune", f"{name} | {TUNE_ARCH} {' '.join(extra)}, bf16, "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}: losses {losses}; selections "
            f"{sorted(sels)}; probe {tuning}; step ms "
            f"{[round(x * 1e3, 1) for x in clock.seconds]}; {wall:.1f} s; "
            f"launches {launches} (want {want}); peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if launches != want or len(losses) != TUNE_STEPS \
                or not all(np.isfinite(losses)):
            raise RuntimeError(f"{label}: launches {launches}, want {want}; "
                               f"losses {losses}")
        out[f"tune {label}"] = launches
        runs.append((losses, sels, tuning, payload))

    run("auto model", tuned)
    misses = load_misses(cache)
    (_, sels1, _, payload), = runs
    want_misses = sorted(("grad_sync", s, 1, 1, payload)
                         for s in ("native", "lane", "lane_pipelined"))
    log("tune", f"{name} | run 1 ranked by {sorted({x[1] for x in sels1})}"
        f"; misses committed {misses}")
    if {x[1:] for x in sels1} != {("model", payload)} \
            or misses != want_misses:
        raise RuntimeError(f"run 1: selections {sels1}, misses {misses}, "
                           f"want {want_misses}")
    run("auto measured", tuned)
    losses2, sels2, tuning2, _ = runs[1]
    table = load_timing_table(cache)
    sig = topology_signature(1, 1, device="cuda")
    measured = {s: table.lookup_us("grad_sync", s, sig, payload)
                for s in ("native", "lane", "lane_pipelined")}
    best = min(measured, key=measured.get)
    left = load_misses(cache)
    log("tune", f"{name} | run 2: worklist of {tuning2.get('worklist')} "
        f"cells probed in {tuning2.get('worklist_s', float('nan')):.2f} s "
        f"(ladder {tuning2.get('ladder_s', float('nan')):.2f} s, all "
        f"measured before); the gradient sync at {payload} B measured "
        f"{ {k: round(v, 1) for k, v in measured.items()} } us, argmin "
        f"{best}; selected {sorted(sels2)}; misses left {left}")
    if sels2 != {(best, "measured", payload)} or left \
            or tuning2.get("worklist") != 3:
        raise RuntimeError(f"run 2: selections {sels2}, argmin {best}, "
                           f"misses left {left}, probe {tuning2}")
    run("fixed", ["--gradsync", best])
    losses3 = runs[2][0]
    log("tune", f"{name} | --gradsync {best}: losses "
        + ("bit-identical to" if losses3 == losses2 else "DIFFER from")
        + " the measured auto run's")
    if losses3 != losses2:
        raise RuntimeError(f"--gradsync {best} {losses3} against auto "
                           f"{losses2}")
    return out


def phase_tuning(topo, name) -> dict:
    """Phase 12; its cache directory (under build/, ignored by git) is
    removed at the end, also on failure, and the cost model's constants
    must be those from before the phase."""
    from repro_torch.core.costmodel import get_hw
    root = _tune_root()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    hw0 = get_hw()
    t0 = time.perf_counter()
    try:
        timed("12a probe, cache and fit", phase_tune_probe, topo, root, name)
        with torch.enable_grad():
            launches = timed("12b --gradsync auto at full width",
                             phase_tune_train, topo, root, name)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        log("time", f"phase 12: {time.perf_counter() - t0:.1f} s")
    log("tune", f"{name} | cost-model constants after phase 12 "
        + ("are" if get_hw() is hw0 else "ARE NOT") + " those before it")
    if get_hw() is not hw0:
        raise RuntimeError(f"get_hw() {get_hw()} after phase 12, {hw0} "
                           f"before")
    return launches


# ---------------------------------------------------------------------------
# phase 13: tensor and expert parallelism on the one-rank world
# ---------------------------------------------------------------------------

TP_ARCH = "llama3.2-3b"           # 13a: its MLP, d 3072, f 8192
EP_ARCH = "granite-moe-3b-a800m"  # 13b, 13c: 40 experts top-8, d_ff 512
EP_STEPS = 3
# 13b's runs: (label, flags, the gathered run an EP run is held to),
# remat none (each peaks under 70 GiB), AdamW with no clipping (the clip
# norm is still computed): the gathered lane_zero3 state sums the
# experts' squares inside its stripes, the EP one apart, so with the clip
# their norms part by an ulp, and from step 2 their losses (7.4e-6 at
# step 2 and 2.3e-4 at step 3, PERF.md §6); without it they are
# equal, as phase 9b's layouts are
EP_RUNS = (("lane", ["--gradsync", "lane"], None),
           ("lane_zero3", ["--gradsync", "lane_zero3"], None),
           ("lane ep", ["--gradsync", "lane", "--expert-parallel"], "lane"),
           ("lane_zero3 ep b2", ["--gradsync", "lane_zero3",
                                 "--expert-parallel", "--ep-blocks", "2"],
            "lane_zero3"))
# the CPU tests' tolerance of EP against the gathered MoE (f32, 8 gloo
# ranks: tests/test_torch_train_tp_ep.py), relative
EP_TOL = 1e-6
EP_CUT = "granite-moe-3b-a800m-cut"


def _tp_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent / "build" / "tp_ep"


def phase_tp_mlp(topo, name) -> None:
    """13a: ``mlp_tp`` and ``mlp_tp_reduce`` over the model group of the
    1 x 1 topology (tp = 1: a one-rank NCCL group; NCCL refuses two ranks
    on one card) at TP_ARCH's MLP, bf16, TRAIN_BATCH x TRAIN_SEQ tokens,
    seed-0 weights, forward and backward against ``mlp`` on the same
    inputs: max |delta| of the output and of every gradient (mlp_tp: 0
    expected), gated at TOL[bf16] of the largest reference magnitude;
    device us of each (forward and backward) beside mlp's."""
    from repro_torch.models import layers as L
    cfg = resolve(TP_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = L.init_mlp(cfg, generator=gen, device=torch.device("cuda"))
    x = L.dense_init((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), torch.bfloat16,
                     generator=gen, device=torch.device("cuda"), scale=1.0)
    dy = L.dense_init(x.shape, torch.bfloat16, generator=gen,
                      device=torch.device("cuda"), scale=1.0)
    comm = LaneComm(topo.model)
    names = ("x", "w_up", "w_gate", "w_down")
    fns = {"mlp": lambda q, h: L.mlp(q, h, cfg),
           "mlp_tp": lambda q, h: L.mlp_tp(q, h, cfg, comm=comm),
           "mlp_tp_reduce": lambda q, h: L.mlp_tp_reduce(q, h, cfg,
                                                         comm=comm)}

    def fwd_bwd(fn):
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, p["w_up"], p["w_gate"], p["w_down"])]
        y = fn(dict(zip(names[1:], leaves[1:])), leaves[0])
        return [y.detach(), *torch.autograd.grad(y, leaves, dy)]

    want = fwd_bwd(fns["mlp"])
    us = {}
    for label, fn in fns.items():
        us[label], _ = device_us(lambda fn=fn: fwd_bwd(fn), reps=5,
                                 warmup=1)
        if label == "mlp":
            continue
        got = fwd_bwd(fn)
        errs = {k: float((a.float() - b.float()).abs().max())
                for k, a, b in zip(("y", *(f"d{n}" for n in names)), got,
                                   want)}
        scale = {k: float(b.float().abs().max()) for k, b in
                 zip(errs, want)}
        log("tp", f"{name} | {label} at tp=1, {TP_ARCH}'s MLP d "
            f"{cfg.d_model} f {cfg.d_ff}, bf16, {TRAIN_BATCH} x "
            f"{TRAIN_SEQ}: max |delta| against mlp "
            f"{ {k: v for k, v in errs.items()} } (gate "
            f"{TOL[torch.bfloat16]:g} of the largest |value|)")
        bad = [k for k in errs if not errs[k] <= TOL[torch.bfloat16]
               * scale[k]]
        if bad:
            raise RuntimeError(f"{label}: {bad} past the gate: {errs}")
    log("tp", f"{name} | forward + backward device us: "
        + ", ".join(f"{k} {v:.1f}" for k, v in us.items()))


@contextlib.contextmanager
def unclipped():
    """Within ``with``: ``launch.train`` builds AdamW with no clipping."""
    train.AdamWConfig = lambda **kw: AdamWConfig(
        **kw, clip_norm=float("inf"))
    try:
        yield
    finally:
        train.AdamWConfig = AdamWConfig


class EpWatch:
    """Within ``with``: every moe dispatch's assignments and drops (``moe.
    _dispatch_buffer`` wrapped, summed on the card) and the forward
    routing all-to-alls started (``moe._route_start`` wrapped: dispatch
    and combine; the backward's reverse routes are not counted)."""

    def __enter__(self):
        self.dispatch = moe_mod._dispatch_buffer
        self.route_start = moe_mod._route_start
        self.kept, self.total, self.routes = [], 0, 0

        def dispatch(p, x, cfg):
            out = self.dispatch(p, x, cfg)
            self.kept.append(out[2].sum())
            self.total += out[2].numel()
            return out

        def route_start(*args, **kw):
            self.routes += 1
            return self.route_start(*args, **kw)
        moe_mod._dispatch_buffer = dispatch
        moe_mod._route_start = route_start
        return self

    def __exit__(self, *exc):
        moe_mod._dispatch_buffer = self.dispatch
        moe_mod._route_start = self.route_start

    def dropped(self) -> float:
        return 1.0 - float(torch.stack(self.kept).sum()) / self.total


def phase_ep_train(topo, name) -> dict:
    """13b: EP_ARCH at full width, bf16, TRAIN_BATCH x TRAIN_SEQ tokens,
    EP_STEPS steps each of EP_RUNS through ``launch.train.run`` on the
    1 x 1 topology (the gathered MoE under lane and lane_zero3, then
    expert-parallel under lane, then expert-parallel lane_zero3 with
    ep_blocks 2: C = 256 splits in two); each run's state freed before
    the next; AdamW unclipped (EP_RUNS).  Gates: every loss finite; K1
    once per layer and forward; 2·L·ep_blocks forward routes per forward
    under EP and none gathered; every EP run's losses within EP_TOL of
    its own layout's gathered run's at every step (lane_zero3's f32
    masters keep the sub-ulp updates the replicated bf16 weights drop,
    phase 9b, so it is held to the gathered lane_zero3 run).  Printed:
    step ms (median of steps 2-3), peak GiB, routes and K1 per step, the
    dropped share."""
    cfg = resolve(EP_ARCH)
    Lc = cfg.num_layers
    base = ["--arch", EP_ARCH, "--steps", str(EP_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1",
            "--device", "cuda"]
    out, runs = {}, {}
    for label, flags, _ in EP_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with StepClock(trace_at=10 ** 9) as clock, EpWatch() as w, \
                unclipped():
            fa.launches = k2.launches = 0
            losses = train.run(base + flags, topo=topo)[0]
            torch.cuda.synchronize()
            launches = {"flash_attention": fa.launches, "ssd": k2.launches}
            routes, dropped = w.routes, w.dropped()
        peak = torch.cuda.max_memory_allocated() / 2**30
        blocks = int(flags[flags.index("--ep-blocks") + 1]) \
            if "--ep-blocks" in flags else 1
        want_k1 = Lc * EP_STEPS
        want_routes = 2 * Lc * blocks * EP_STEPS \
            if "--expert-parallel" in flags else 0
        ms = float(np.median(clock.seconds[1:])) * 1e3
        runs[label] = losses
        out[f"ep {label}"] = launches
        log("ep", f"{name} | {EP_ARCH} {' '.join(flags)}, bf16, "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}: losses {losses}; step ms "
            f"{[round(x * 1e3, 1) for x in clock.seconds]} (median of "
            f"steps 2-{EP_STEPS} {ms:.1f} ms); peak {peak:.2f} GiB; "
            f"moe_route {routes / EP_STEPS:.0f} a step (want "
            f"{want_routes // EP_STEPS}); K1 "
            f"{launches['flash_attention'] / EP_STEPS:.0f} a step (want "
            f"{want_k1 // EP_STEPS}); dropped share {dropped:.4f}")
        if len(losses) != EP_STEPS or not all(np.isfinite(losses)) \
                or launches != {"flash_attention": want_k1, "ssd": 0} \
                or routes != want_routes:
            raise RuntimeError(f"{label}: losses {losses}, launches "
                               f"{launches}, routes {routes}")
        torch.cuda.empty_cache()
    for label, _, ref in EP_RUNS:
        if ref is None:
            continue
        rel = [abs(a - b) / abs(b) for a, b in zip(runs[label], runs[ref])]
        log("ep", f"{name} | {label} against the gathered {ref} run: "
            f"relative |delta| per step {[f'{r:.2e}' for r in rel]} "
            f"(gated at {EP_TOL:g})")
        if max(rel) > EP_TOL:
            raise RuntimeError(f"{label}: {runs[label]} against the "
                               f"gathered {ref} {runs[ref]}")
    return out


def phase_ep_ckpt(topo, root, name) -> dict:
    """13c: EP_ARCH at full width cut to CHECK_LAYERS layers (EP_CUT),
    bf16, 1 x CHECK_T tokens: ``--gradsync lane_zero3 --expert-parallel
    --steps 3 --ckpt D --ckpt-every 2`` (the ep layout saved at steps 2
    and 3), step 3 removed, then ``--gradsync lane --steps 3``: resumed
    at step 2 into the replicated layout through the canonical form, its
    loss at step 3 within EP_TOL of the uninterrupted ep run's."""
    from repro_torch.checkpoint import latest_step, verify_checkpoint
    from repro_torch.configs.base import register
    cut = lambda: dataclasses.replace(resolve(EP_ARCH),
                                      num_layers=CHECK_LAYERS)
    register(EP_CUT, cut, cut)
    d = root / "ep"
    argv = ["--arch", EP_CUT, "--batch", "1", "--seq", str(CHECK_T),
            "--log-every", "1", "--device", "cuda", "--ckpt", str(d),
            "--ckpt-every", "2", "--steps", "3"]
    fa.launches = k2.launches = 0
    (ep, _, _), _, _ = _run_logged(argv + ["--gradsync", "lane_zero3",
                                           "--expert-parallel"], topo)
    verify_checkpoint(str(d), 2)
    man = json.loads((d / "step_2" / "manifest.json").read_text())
    shutil.rmtree(d / "step_3")
    (resumed, _, _), out, _ = _run_logged(argv + ["--gradsync", "lane"],
                                          topo)
    launches = {"flash_attention": fa.launches, "ssd": k2.launches}
    rel = abs(resumed[0] - ep[2]) / abs(ep[2]) if resumed else float("inf")
    log("ep", f"{name} | {EP_CUT}: ep lane_zero3 losses {ep}, layout "
        f"{man['layout']}; resumed under lane at step "
        f"{latest_step(str(d))}: step 3 loss {resumed} against "
        f"{ep[2]!r}, relative |delta| {rel:.2e} (gate {EP_TOL:g}); "
        f"launches {launches}")
    if not man["layout"].get("ep") or "resumed from step 2" not in out \
            or rel > EP_TOL:
        raise RuntimeError(f"the ep checkpoint: layout {man['layout']}, "
                           f"resumed {resumed}, uninterrupted {ep}")
    return {"ep ckpt": launches}


def phase_tp_ep(topo, name) -> dict:
    """Phase 13; its checkpoint directory (under build/, ignored by git)
    is removed at the end, also on failure."""
    root = _tp_root()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        with torch.enable_grad():
            timed("13a TP MLP", phase_tp_mlp, topo, name)
            torch.cuda.empty_cache()
            launches = timed("13b EP at full width", phase_ep_train, topo,
                             name)
            torch.cuda.empty_cache()
            launches.update(timed("13c the ep checkpoint", phase_ep_ckpt,
                                  topo, root, name))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        log("time", f"phase 13: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 14: the collective recorder and the serving smoke leg at full width
# ---------------------------------------------------------------------------

LINT_ARCH = "llama3.2-3b"
SMOKE_KINDS = ("short_chat", "long_context", "bursty")   # phase 5: mixed
SMOKE_ARCHS = ("llama3.2-3b", "mamba2-780m")


def _sync_kinds(foot, K, flat_bytes, n) -> dict:
    """{kind: (calls, issued bytes)} of the recorded ops above the scalar
    exemption, and the same for the ``lane`` cell's K buckets over the
    padded f32 flat buffer of ``flat_bytes``: RS(node) of each bucket,
    AR(lane) and AG(node) of its 1/n stripe."""
    got = {}
    for op in foot.ops:
        if op.payload_bytes > SMALL_GLOBAL_BYTES:
            c, b = got.get(op.kind, (0, 0))
            got[op.kind] = (c + 1, b + int(op.payload_bytes))
    want = {"reduce-scatter": (K, flat_bytes),
            "all-reduce": (K, flat_bytes // n),
            "all-gather": (K, flat_bytes // n)}
    return got, want


def phase_recorder(topo, name) -> dict:
    """14a: one bf16 step of LINT_ARCH at full width, TRAIN_BATCH x
    TRAIN_SEQ tokens, --gradsync lane, under ``record_collectives``, then
    one without it (after a first, untimed step); then one lane_zero3
    decode step under the recorder."""
    cfg = resolve(LINT_ARCH)
    run = RunConfig(model=cfg, gradsync="lane")
    comm = LaneComm(topo, CommConfig.from_run(run))
    opt = AdamWConfig(warmup_steps=0, total_steps=3)
    step = steps.build_train_step(run, opt, comm, single=False)
    params = init_model(cfg, seed=0, device="cuda")
    total = sum(t.numel() for t in _tree.leaves(params))
    K = gradsync.resolve_num_buckets(total, topo.n(), comm.cfg.buckets)
    flat_bytes = 4 * (total + (-total) % (K * topo.n()))
    state, opt_state, _ = steps.init_lane_train_state(
        run, params, comm, single=False, device="cuda")
    del params
    loader = make_loader(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    ms, launches, bad = {}, {"flash_attention": 0, "ssd": 0}, []
    # a first step unrecorded and untimed, so that neither timed step is
    # the first on this state
    for s, recorded in enumerate((False, True, False)):
        toks, labels = (torch.as_tensor(a, device="cuda")
                        for a in loader.batch_at(s))
        torch.cuda.synchronize()
        fa.launches = k2.launches = 0
        t0 = time.perf_counter()
        with (record_collectives() if recorded
              else contextlib.nullcontext()) as rec:
            loss, state, opt_state = step(state, opt_state, toks, labels)
            torch.cuda.synchronize()
        ms[recorded] = (time.perf_counter() - t0) * 1e3
        launches["flash_attention"] += fa.launches
        launches["ssd"] += k2.launches
        if not np.isfinite(float(loss)):
            bad.append(f"step {s}: loss {float(loss)}")
        if recorded:
            k1 = fa.launches
            foot = rec.footprint(n=topo.n(), num_devices=topo.p())
    got, want = _sync_kinds(foot, K, flat_bytes, topo.n())
    devices = {op.device for op in foot.ops}
    r1 = check_step_footprint("train_step/lane", foot)
    log("lint", f"{name} | {LINT_ARCH} bf16 step, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, --gradsync lane (K={K}, flat f32 "
        f"{flat_bytes / 1e9:.2f} GB): recorded {len(foot)} ops, kinds "
        f"{foot.kind_counts()}, devices {sorted(devices)}, sync calls and "
        f"issued bytes {got} (want {want}), wire {foot.by_level()}, R1 "
        f"{[f.message for f in r1]}, K1 {k1} (want {cfg.num_layers}); step "
        f"ms with the recorder {ms[True]:.1f}, without {ms[False]:.1f}")
    if k1 != cfg.num_layers:
        bad.append(f"K1 {k1} in the recorded step")
    if devices != {"cuda"}:
        bad.append(f"recorded ops on {devices}")
    if got != want:
        bad.append(f"sync {got} != {want}")
    if foot.wire() != 0:
        bad.append(f"wire {foot.by_level()} at p = 1")
    if r1:
        bad.append(f"R1: {r1}")
    del opt_state
    torch.cuda.empty_cache()
    serve = build_serve_step(cfg, max_seq=1024, slots=SLOTS,
                             hosting="lane_zero3", device="cuda", topo=topo)
    hosted = serve.prepare(state)
    del state
    sstate = serve.init_state()
    prompt = torch.arange(1, 65, device="cuda").reshape(1, 64)
    fa.launches = k2.launches = 0
    _, st1 = serve.prefill(hosted, prompt, 64)
    serve.splice(sstate, st1, 0)
    g0 = serve.gathers()
    with record_collectives() as rec:
        serve.decode(hosted, np.ones((SLOTS, 1), np.int64), sstate)
        torch.cuda.synchronize()
    gathers = serve.gathers() - g0
    launches["flash_attention"] += fa.launches
    launches["ssd"] += k2.launches
    dfoot = rec.footprint(n=topo.n(), num_devices=topo.p())
    r1 = check_step_footprint("serve_step/lane_zero3:decode", dfoot)
    log("lint", f"{name} | {LINT_ARCH} lane_zero3 decode step ({SLOTS} "
        f"slots) under the recorder: {len(dfoot)} ops, kinds "
        f"{dfoot.kind_counts()}, layer gathers {gathers} (want "
        f"{cfg.num_layers}), devices "
        f"{sorted({op.device for op in dfoot.ops})}, wire {dfoot.wire()}, "
        f"R1 {[f.message for f in r1]}")
    if gathers != cfg.num_layers or r1 or dfoot.wire() != 0 \
            or {op.device for op in dfoot.ops} != {"cuda"}:
        bad.append(f"lane_zero3 decode: gathers {gathers}, R1 {r1}")
    del hosted, sstate, st1
    torch.cuda.empty_cache()
    if bad:
        raise RuntimeError("; ".join(bad))
    return {f"recorder {LINT_ARCH}": launches}


def phase_smoke_scenarios(name) -> dict:
    """14b: ``serve_smoke.run_scenarios`` at full width, bf16, on phase
    5's seed-0 weights, SLOTS slots, max_seq SCENARIO_POSITIONS, over the
    kinds phase 5 does not serve: every request finishes with a reason
    and a first-token time, and each kernel runs once per layer and
    prefill."""
    out, bad = {}, []
    for arch in SMOKE_ARCHS:
        cfg = resolve(arch)
        params = init_model(cfg, seed=0, device="cuda")
        fa.launches = k2.launches = 0
        res = run_scenarios(cfg, params, SMOKE_KINDS, slots=SLOTS,
                            max_seq=SCENARIO_POSITIONS, device="cuda")
        torch.cuda.synchronize()
        got = {"flash_attention": fa.launches, "ssd": k2.launches}
        prefills = sum(len(done) for done, _ in res.values())
        want = expected_launches(cfg, prefills)
        log("smoke", f"{name} | {arch} scenarios {SMOKE_KINDS}: "
            + ", ".join(f"{k} {st['decode_tokens']} tok "
                        f"{st['tok_per_s']:.1f} smoke tok/s"
                        for k, (_, st) in res.items())
            + f"; launches {got} (want {want}, {prefills} prefills)")
        if got != want:
            bad.append(f"{arch}: launches {got} != {want}")
        out[f"smoke scenarios {arch}"] = got
        del params, res
        torch.cuda.empty_cache()
    if bad:
        raise RuntimeError("; ".join(bad))
    return out


def phase_lint_smoke(topo, name) -> dict:
    """Phase 14."""
    t0 = time.perf_counter()
    try:
        with torch.enable_grad():
            launches = timed("14a the recorder on the card", phase_recorder,
                             topo, name)
        launches.update(timed("14b serve_smoke scenarios at full width",
                              phase_smoke_scenarios, name))
    finally:
        log("time", f"phase 14: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 15: the launch layer
# ---------------------------------------------------------------------------

# (arch, gradsync, expert_parallel): 15a's layouts
STATE_RUNS = (("llama3.2-3b", "native", False),
              ("llama3.2-3b", "lane_zero1", False),
              ("llama3.2-3b", "lane_zero3", False),
              ("granite-moe-3b-a800m", "lane_zero3", True))
STATE_TOL = 5e-3
SMOKE_STEPS = 3       # a cell's fresh 2 steps and its resumed third


def _launch_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent / "build" / "launch_smoke"


def phase_state_bytes(topo, name) -> dict:
    """15a: each layout of STATE_RUNS at full width, bf16, built alone on
    the card: its allocation against the planner's state bytes."""
    bad, launches = [], {}
    for arch, gradsync, ep in STATE_RUNS:
        cfg = resolve(arch)
        run = RunConfig(model=cfg, gradsync=gradsync, expert_parallel=ep)
        comm = LaneComm(topo, CommConfig.from_run(run))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        p, o, _ = steps.init_lane_train_state(
            run, init_model(cfg, seed=0, device="cuda"), comm, single=False,
            device="cuda")
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        plan = dryrun.train_state_bytes(run, *topo.sizes())
        want = sum(plan.values())
        rel = held / want - 1
        label = f"{arch} {gradsync}" + (" --expert-parallel" if ep else "")
        log("launch", f"{name} | {label}: state on the card {held / 1e9:.3f}"
            f" GB, planned {want / 1e9:.3f} GB ("
            + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in plan.items() if v)
            + f"), {rel:+.2e} (gate {STATE_TOL:g})")
        if not abs(rel) <= STATE_TOL:
            bad.append(f"{label}: {held} B held, {want} B planned")
        if gradsync == "native":
            step = steps.build_train_step(run, AdamWConfig(), comm,
                                          single=False)
            tok, lab = (torch.as_tensor(a, device="cuda") for a in
                        make_loader(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                    seed=0).batch_at(0))
            torch.cuda.reset_peak_memory_stats()
            fa.launches = k2.launches = 0
            with torch.enable_grad():
                loss = float(step(p, o, tok, lab)[0])
            torch.cuda.synchronize()
            launches["state 15a step"] = {"flash_attention": fa.launches,
                                          "ssd": k2.launches}
            peak = torch.cuda.max_memory_allocated() - base
            log("launch", f"{name} | {label}: one step at {TRAIN_BATCH} x "
                f"{TRAIN_SEQ}: loss {loss:.4f}, peak {peak / 1e9:.3f} GB "
                f"beside the planned state {want / 1e9:.3f} GB (activations "
                f"not planned), K1 {fa.launches}")
            if not np.isfinite(loss) or fa.launches != cfg.num_layers:
                bad.append(f"{label} step: loss {loss}, K1 {fa.launches}")
            del step
        del p, o, comm
        torch.cuda.empty_cache()
    if bad:
        raise RuntimeError("; ".join(bad))
    return launches


def smoke_launches(arch: str) -> dict:
    """K1 and K2 launches of one smoke cell: once per attention layer and
    Mamba2 layer a step, SMOKE_STEPS steps."""
    cfg = resolve(arch, smoke=True)
    attn = {"dense": cfg.num_layers, "moe": cfg.num_layers,
            "hybrid": cfg.num_layers // max(cfg.hybrid_attn_every, 1)}
    return {"flash_attention": SMOKE_STEPS * attn.get(cfg.family, 0),
            "ssd": SMOKE_STEPS * (cfg.num_layers if cfg.family in
                                  ("ssm", "hybrid") else 0)}


def phase_train_smoke(topo, name, root) -> dict:
    """15b: every train_smoke cell on this world, its launches counted."""
    total = {"flash_attention": 0, "ssd": 0}
    bad = []
    cells = train_smoke.cells()
    for cell, _, _, arch in cells:
        fa.launches = k2.launches = 0
        t0 = time.perf_counter()
        fails, resumed = train_smoke.sweep(str(root / "train"),
                                           device="cuda", topo=topo,
                                           only=(cell,))
        got = {"flash_attention": fa.launches, "ssd": k2.launches}
        want = smoke_launches(arch)
        log("launch", f"{name} | train-smoke {cell} ({arch} --smoke, f32): "
            f"{'PASS' if not fails else 'FAIL'} in "
            f"{time.perf_counter() - t0:.1f} s, resumed step-3 loss "
            f"{resumed.get(cell)!r}, launches {got} (want {want})")
        if fails or got != want:
            bad.append(cell)
        for k in total:
            total[k] += got[k]
    log("launch", f"train-smoke on the card: {len(cells) - len(bad)}/"
        f"{len(cells)} cells OK" + (f"; FAILED {bad}" if bad else ""))
    if bad or len(cells) != 11:
        raise RuntimeError(f"train-smoke cells failed: {bad}")
    return {"train_smoke": total}


def phase_tp_smoke(topo, name, root) -> dict:
    """15c: tp_smoke's expert-parallel cells on this world; a TP cell is
    refused on one GPU."""
    total = {"flash_attention": 0, "ssd": 0}
    for cell in tp_smoke.EP_CELLS:
        fa.launches = k2.launches = 0
        t0 = time.perf_counter()
        losses = tp_smoke.run_tp_cell(cell, str(root / "tp"),
                                      device="cuda", topo=topo)
        got = {"flash_attention": fa.launches, "ssd": k2.launches}
        want = smoke_launches("dbrx-132b")
        log("launch", f"{name} | tp-smoke {cell} (dbrx-132b --smoke, f32, "
            f"p = 1): PASS in {time.perf_counter() - t0:.1f} s, resumed "
            f"step-3 loss {losses[0]!r}, launches {got} (want {want})")
        if got != want or not np.isfinite(losses[0]):
            raise RuntimeError(f"{cell}: launches {got}, want {want}")
        for k in total:
            total[k] += got[k]
    try:
        tp_smoke.run_tp_cell("tp2_lane[dense]", str(root / "tp"),
                             device="cuda", topo=topo)
    except ValueError as e:
        log("launch", f"tp-smoke tp2_lane[dense] refused on one GPU: {e}")
    else:
        raise RuntimeError("a TP = 2 cell ran on a one-GPU world")
    return {"tp_smoke ep": total}


def phase_launch(topo, name) -> dict:
    """Phase 15."""
    t0 = time.perf_counter()
    root = _launch_root()
    shutil.rmtree(root, ignore_errors=True)
    try:
        launches = timed("15a planned state bytes", phase_state_bytes, topo,
                         name)
        with torch.enable_grad():
            launches.update(timed("15b train_smoke", phase_train_smoke,
                                  topo, name, root))
            launches.update(timed("15c tp_smoke EP cells", phase_tp_smoke,
                                  topo, name, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        log("time", f"phase 15: {time.perf_counter() - t0:.1f} s")
    return launches


def timed(label, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log("time", f"{label}: {time.perf_counter() - t0:.1f} s")
    return out


@torch.no_grad()          # serving needs no autograd; phase 7 turns it on
def main() -> int:
    t_start = time.perf_counter()
    name = timed("device", phase_device)
    timed("build", phase_build)
    k1_err = timed("K1 against its plain version", phase_kernel)
    k2_err = timed("K2 against its plain version", phase_ssd)
    launches, served = {}, {}
    for arch in PATHS:
        cfg = resolve(arch)
        batcher, stats, launches[arch], reqs = timed(
            f"serve {arch}", phase_serve, cfg, MAX_SEQ.get(arch, 1024))
        served[arch] = [list(r.out) for r in reqs]
        timed(f"perf {arch}", phase_perf, cfg, name, batcher, stats)
        if arch == "llama3.2-3b":
            k1 = timed("time K1", time_k1, name, 1, cfg.num_heads,
                       cfg.num_kv_heads, 512, cfg.hd())
            launches.update(timed(f"sampled {arch}", phase_sampled, cfg,
                                  batcher, reqs))
        elif arch == "mamba2-780m":
            k2_t = timed("time K2", time_k2, name, cfg)
        elif arch == "zamba2-7b":
            timed("time K1", time_k1, name, 1, cfg.num_heads,
                  cfg.num_kv_heads, 512, cfg.hd())
            timed("time K2", time_k2, name, cfg)
        elif arch == "llava-next-mistral-7b":
            timed("time K1", time_k1, name, 1, cfg.num_heads,
                  cfg.num_kv_heads, cfg.vision_tokens + 512, cfg.hd())
        elif arch == "whisper-large-v3":
            timed("time K1", time_k1, name, 1, cfg.num_heads,
                  cfg.num_kv_heads, cfg.encoder_seq, cfg.hd(), causal=False)
        elif arch == "granite-34b":
            timed("time K1", time_k1, name, 1, cfg.num_heads,
                  cfg.num_kv_heads, 512, cfg.hd())
        elif arch == "h2o-danube-3-4b":
            for T in (512, LONG_PROMPT[arch][0]):
                timed("time K1", time_k1, name, 1, cfg.num_heads,
                      cfg.num_kv_heads, T, cfg.hd(),
                      window=cfg.sliding_window)
        del batcher, reqs
        torch.cuda.empty_cache()
    with torch.enable_grad():
        timed("autograd Functions", phase_autograd)
        timed("train step, card vs CPU", phase_train_check)
        first_loss = {}
        for arch in TRAIN_ARCHS:
            launches[f"train {arch}"], losses = timed(
                f"train {arch}", phase_train, resolve(arch), name)
            first_loss[arch] = losses[0]
            torch.cuda.empty_cache()
    launches.update(timed("lane collectives, ZeRO, checkpoints, faults, "
                          "tuning, TP and EP", phase_lanes, name,
                          first_loss, served))
    log("time", f"total: {time.perf_counter() - t_start:.1f} s")
    by_path = {k: {a: n[k] for a, n in launches.items()}
               for k in ("flash_attention", "ssd")}
    print(name, flush=True)
    print(json.dumps({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:84",
         "launches": sum(by_path["flash_attention"].values()),
         "launches_by_path": by_path["flash_attention"],
         "max_abs_err": k1_err, "ms": k1[0], "plain_ms": k1[1],
         "bound_ms": k1[3], "bound_by": k1[4], "library_ms": k1[2]},
        {"name": "ssd", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd.cu",
         "replaces": "src/repro/kernels/ssd.py:70",
         "launches": sum(by_path["ssd"].values()),
         "launches_by_path": by_path["ssd"],
         "max_abs_err": k2_err, "ms": k2_t[0], "plain_ms": k2_t[1],
         "bound_ms": k2_t[2], "bound_by": k2_t[3], "library_ms": None}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
