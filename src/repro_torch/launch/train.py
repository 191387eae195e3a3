"""The training loop: ``main(argv) -> losses``, on one process or across
ranks.

Counterpart of ``repro.launch.train``: resolve the arch, build the
replicated step (``launch.steps``), initialise the weights from
``--seed`` on ``--device``, and take ``--steps`` AdamW steps over
``SyntheticLM`` batches of ``--batch`` rows of ``--seq`` tokens from
``make_loader``, logging as ``repro`` logs.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --smoke --steps 3 --batch 4 --seq 32 --device cpu

Across ranks it runs under ``torchrun`` (or any started process group):
``launch.mesh`` lays the world out as ``repro``'s ``(pod, data, model)``
mesh, each rank takes its rows of the global batch in ``repro``'s
sharding order (pod-major, global rank ``lane_rank·n + node_rank``), and
the step syncs the gradients with ``--gradsync`` (``native``, ``lane``,
``lane_pipelined`` or ``lane_int8``) over ``--gradsync-buckets`` buckets,
or keeps ZeRO state: ``lane_zero1`` shards the AdamW moments over the
node level, ``lane_zero3`` the parameters too, over both levels, and
gathers each layer in the forward (``--fsdp-prefetch`` blocks, -1 the
blocking gather; ``--fsdp-regather`` gathers again in the backward):

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch llama3.2-3b --smoke --gradsync lane --pods 2 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch llama3.2-3b --smoke --gradsync lane_zero3 --pods 2 --device cpu

Checkpoints, as ``repro``'s driver writes them (``--ckpt DIR``): the
state every ``--ckpt-every`` steps and at the end, on an async writer
(``checkpoint.AsyncCheckpointer``; the loop blocks only for the copy to
the host), assembled on the lead rank (global rank 0 of the topology) in
``repro``'s files.  A run with
``--ckpt`` resumes from the newest checkpoint there that verifies, in
its own layout whatever layout and number of ranks wrote it
(``launch.steps.restore_lane_train_state``); resuming a finished run does
nothing.  On an exception the last completed step is saved (not a step
that raised part-way through its in-place update) and the exception
goes on; on SIGTERM (any rank's: the flag is reduced over the ranks at
each step boundary, on the hosts through gloo, and not at all on one
rank) the loop stops at the next step boundary after an
emergency checkpoint, and the old handler comes back in ``finally``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --smoke --steps 6 --batch 4 --seq 32 --ckpt runs/ck --ckpt-every 2 \\
      --device cpu

The recovery ladder, HEALTHY -> DEGRADED -> RESTART (``runtime``):

  * ``--fault-plan`` injects a deterministic ``runtime.FaultPlan``
    (pod_slow / pod_lost / ckpt_io / corrupt_leaf; ``seed:<n>`` draws a
    seeded random plan), the same on every rank;
  * a ``Watchdog`` folds the plan's per-pod heartbeats into the 0/1
    contributing mask; under ``--gradsync lane_quorum`` the step takes
    it, and DEGRADED steps proceed with the quorum-rescaled gradient (a
    masked pod contributes zero; its (seed, step)-keyed rows are logged,
    replayable);
  * a ``HealthMonitor`` bounds the staleness (``--quorum-staleness``
    K): a pod masked for more than K consecutive steps, or any masked
    pod under a strategy with no quorum path, escalates to RESTART: the
    emergency checkpoint, then ``plan_elastic_mesh`` re-plans around the
    lost pod's ranks and the run resumes in the same processes on the
    survivors' topology (``launch.mesh.new_lane_topology(..., lanes=)``)
    from the newest verified checkpoint; the lost ranks leave.
    ``--max-restarts`` bounds the attempts.  The in-process restart
    gives the same files, byte for byte, as a fresh launch with
    ``--lose-chips`` (world ranks, ``repro``'s flat device indices) from
    the same emergency checkpoint;
  * ckpt_io faults fail the save's first attempts (its retry absorbs
    them); a corrupt_leaf fault flips a byte after the commit, which the
    restore's crc32 check refuses, falling back to the step before:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch llama3.2-3b --smoke --steps 8 --gradsync lane_quorum --pods 2 \\
      --fault-plan "pod_lost@2:pod=1" --ckpt runs/ck --ckpt-every 100 \\
      --device cpu

Measured-cost tuning (``tuning``), as ``repro``'s loop: ``--gradsync
auto`` dispatches every gradient sync by cost, the timing cache
(``--tuning-cache``, default ``tuning_cache.json`` inside ``--ckpt``)
feeds the ranking with measured cells ahead of modelled ones, and
``--tune`` first probes the started world's collectives (the payload
ladder, then the misses a previous run recorded), before the model state
is made.  The cache is the lead rank's: it alone reads the file, hands
the table to the other ranks, and commits the cache, and the misses of
this run after the loop.  The constants fitted to the cells of the
run's topology are installed for the run (``core.costmodel.set_hw``)
before the step is built, unless those cells leave a level unseen (p =
1), and the previous ones come back when ``run`` returns or raises:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch llama3.2-3b --smoke --gradsync auto --tune \\
      --tuning-cache runs/tuning_cache.json --pods 2 --device cpu

Tensor and expert parallelism, as ``repro``'s loop: ``--model-parallel
TP`` pins the world's model axis to TP (``mesh_shape``) and runs the MLP
tensor-parallel over each model group (``models.layers.mlp_tp``); the
batch is replicated over it.  ``--expert-parallel`` splits the MoE experts
over the batch ranks and routes the tokens with the ``moe_route``
all-to-all (``models.moe.moe_block_ep``), its dispatch pipelined over
``--ep-blocks`` capacity blocks; under ``lane_zero3`` the experts are
each rank's never-gathered E/p block, checkpointed in the ep layout:

  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
      --arch llama3.2-3b --smoke --batch 8 --gradsync lane_zero3 --pods 2 \
      --model-parallel 2 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch dbrx-132b --smoke --gradsync lane_zero3 --pods 2 \
      --expert-parallel --ep-blocks 2 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import math
import os
import signal
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, latest_step
from repro_torch.comm import CommConfig, LaneComm, strategies_for
from repro_torch.configs import RunConfig, resolve
from repro_torch.core.costmodel import get_hw, set_hw
from repro_torch.data import make_loader
from repro_torch.launch import mesh
from repro_torch.launch.steps import (build_train_step,
                                     init_lane_train_state,
                                     restore_lane_train_state,
                                     state_to_host)
from repro_torch.models import init_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import (DEGRADED, RESTART, FaultPlan, HealthMonitor,
                                 Watchdog, corrupt_leaf_file,
                                 plan_elastic_mesh)
from repro_torch.tuning import (DEFAULT_CACHE_NAME, DEFAULT_LADDER,
                                SMOKE_LADDER, TimingTable, Tuner, fit_hw,
                                load_misses, load_timing_table_or_none,
                                probe_cells, probe_worklist,
                                save_timing_table)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory: resume from its newest "
                         "verified step, save every --ckpt-every steps "
                         "and at the end")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--remat", default="none",
                    help="none | full (recompute each layer in the "
                         "backward) | dots (keep the matmul outputs, "
                         "recompute the rest)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatch", type=int, default=0,
                    help="gradient-accumulation microbatches per step "
                         "(0 = off); the batch must divide by it")
    ap.add_argument("--accum-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="microbatch gradient accumulator precision")
    ap.add_argument("--gradsync", default="native",
                    choices=strategies_for("train_step"),
                    help="the train step's flavor, a (\"train_step\", "
                         "name) registry cell; auto ranks each sync by "
                         "measured, then modelled cost, lane_quorum is "
                         "the quorum-degraded step")
    ap.add_argument("--gradsync-buckets", type=int, default=0,
                    help="bucket count K; 0 = cost-model auto")
    ap.add_argument("--fsdp-prefetch", type=int, default=0,
                    help="lane_zero3 gather blocks B; 0 = auto, "
                         "-1 = blocking negative control")
    ap.add_argument("--fsdp-regather", action="store_true",
                    help="lane_zero3 backward re-gather: re-run each "
                         "layer's weight gather in the backward")
    ap.add_argument("--pods", type=int, default=0,
                    help="pod (lane) axis size; 0 = auto (lane_zero3 "
                         "gets 2 when the ranks allow, else 1)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--lose-chips", default="",
                    help="comma-separated world ranks (repro's flat "
                         "device indices) to treat as lost: train on the "
                         "topology that survives them")
    ap.add_argument("--fault-plan", default="",
                    help="deterministic fault injection: "
                         "'kind@step[-until][:k=v,...];...' (kinds "
                         "pod_slow/pod_lost/ckpt_io/corrupt_leaf, see "
                         "runtime.faults) or 'seed:<n>' for a seeded "
                         "random plan")
    ap.add_argument("--quorum-staleness", type=int, default=2,
                    help="K: consecutive steps a pod may be masked out "
                         "of the quorum before DEGRADED escalates to "
                         "RESTART")
    ap.add_argument("--max-restarts", type=int, default=2,
                    help="in-process elastic restarts before giving up")
    ap.add_argument("--tune", action="store_true",
                    help="probe the started world's collective timings "
                         "before training (repro_torch.tuning): measured "
                         "costs then outrank the closed-form model in "
                         "auto dispatch; results merge into the cache")
    ap.add_argument("--tuning-cache", default="",
                    help="timing-cache path (default: tuning_cache.json "
                         "inside --ckpt when one is set); restored "
                         "entries feed dispatch without re-probing")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel degree: pins the world's model "
                         "axis to this size; the MLP's activation "
                         "collectives run over each model group (1 = off)")
    ap.add_argument("--expert-parallel", action="store_true",
                    help="MoE expert parallelism: the experts split over "
                         "the batch ranks, the tokens routed by the "
                         "moe_route all-to-all; under lane_zero3 each "
                         "rank keeps its E/p experts, never gathered")
    ap.add_argument("--ep-blocks", type=int, default=1,
                    help="capacity blocks the routing all-to-all is "
                         "pipelined over (block j+1's dispatch beside "
                         "block j's expert FFN; 1 = sequential)")
    return ap


def _multi_rank() -> bool:
    """A process group is started, or ``torchrun`` asks for one."""
    return dist.is_initialized() \
        or int(os.environ.get("WORLD_SIZE", "1")) > 1


def run(argv=None, *, params=None, topo=None, stats=None):
    """Train; returns (every step's loss as floats, the whole parameter
    tree, opt_state).  Under ``lane_zero3`` the tree is gathered from the
    stripes (every rank makes the same collective calls); ``opt_state``
    stays in the step's layout.  ``params``: the initial weights (the
    port's tree, e.g. from ``bridge.params_from_repro``); default
    ``init_model`` from ``--seed``.  ``topo``: a topology of the started
    world to train on with both of its levels as batch axes (``pod`` the
    lane level, ``data`` the node level), where
    ``launch.mesh.make_lane_topology`` would give one (e.g. the 1 x 1
    topology of one card, on which ``lane_zero3`` then runs); default
    ``make_lane_topology``.  ``stats``: a dict that receives, on the lead
    rank, ``"saves"`` (per checkpoint: step, the loop's blocking seconds,
    the writer's seconds, bytes written) and ``"restore_s"``, and on
    every rank ``"events"`` (the health ladder's transitions, every
    attempt's), ``"restarts"``, ``"selections"`` (the auto-dispatch
    ``comm.Selection`` records, every attempt's), ``"hw"`` (the
    cost-model constants the last attempt priced with) and, under
    ``--tune``, ``"tuning"`` (the last attempt's probe: ``ladder_s`` and
    ``worklist_s`` seconds, ``worklist`` cells probed, ``cells`` in the
    table).  The log lines and the closing loss check are ``repro``'s,
    printed by the lead rank (global rank 0 of the current topology).
    Resuming at or past ``--steps`` returns no losses.

    The recovery ladder: each attempt trains on the topology that
    survives the lost ranks (``--lose-chips``, then the pods each RESTART
    condemns); a RESTART commits the emergency checkpoint of the last
    completed step, and the next attempt re-plans
    (``runtime.elastic.plan_elastic_mesh``, whose ValueError when no pod
    survives propagates) and resumes from the newest verified
    checkpoint.  A rank outside the survivors returns at once with the
    losses it logged and ``None`` for the state.  Past
    ``--max-restarts`` it prints ``repro``'s line and raises."""
    args = _parser().parse_args(argv)
    prev_hw = get_hw()      # a fitted HW is this run's alone
    try:
        return _run(args, params, topo, stats)
    finally:
        set_hw(prev_hw)


def _run(args, params, topo, stats):
    cfg = resolve(args.arch, smoke=args.smoke)
    run_cfg = RunConfig(model=cfg, remat=args.remat, gradsync=args.gradsync,
                        gradsync_buckets=args.gradsync_buckets,
                        fsdp_prefetch=args.fsdp_prefetch,
                        fsdp_regather=args.fsdp_regather,
                        microbatch=args.microbatch,
                        accum_dtype=args.accum_dtype,
                        model_parallel=args.model_parallel,
                        expert_parallel=args.expert_parallel,
                        ep_blocks=args.ep_blocks)
    multi = _multi_rank()
    owns_world = multi and not dist.is_initialized()
    if multi:
        dev = mesh.init_world(args.device)
        world = dist.get_world_size()
        if topo is None:
            pods = mesh.resolve_pods(args.pods, args.gradsync)
            names, shape = mesh.mesh_axes(*mesh.mesh_shape(
                world, args.batch, pods, args.model_parallel))
        else:
            names = ("pod", "data", "model")
            shape = (topo.N(), topo.n(), world // topo.p())
    else:                                    # repro's rules, one device
        mesh.mesh_shape(1, args.batch,
                        mesh.resolve_pods(args.pods, args.gradsync, 1),
                        args.model_parallel)
        dev = resolve_device(args.device)
        names, shape = ("data", "model"), (1, 1)
    lead0 = not multi or dist.get_rank() == 0
    if args.fault_plan.startswith("seed:"):
        plan = FaultPlan.generate(int(args.fault_plan[len("seed:"):]),
                                  args.steps, shape[_outer_axis(names)])
        if lead0:
            print(f"fault plan (seeded): {plan.faults}", flush=True)
    else:
        plan = FaultPlan.parse(args.fault_plan)
    lost = {int(x) for x in args.lose_chips.split(",") if x != ""}
    stats = {} if stats is None else stats
    stats.setdefault("events", [])
    stats.setdefault("selections", [])
    stats["restarts"] = 0
    losses = []
    # SIGTERM (preemption): an emergency checkpoint at the next step
    # boundary
    terminate = {"now": False}
    old = signal.signal(signal.SIGTERM,
                        lambda *_: terminate.__setitem__("now", True))
    try:
        for attempt in range(args.max_restarts + 1):
            single, ranks = not multi, [0]
            if multi and lost:
                em = plan_elastic_mesh(names, shape, sorted(lost))
                topo, single = em.make()
                if topo is None:              # this rank is lost
                    return [float(x) for x in losses], None, None
                per = math.prod(em.shape[1:])
                ranks = [r for r in range(world) if r // per in em.lanes]
                if dist.get_rank() == ranks[0]:
                    print(f"elastic mesh: {dict(zip(names, em.shape))} "
                          f"(lost {em.lost})", flush=True)
            elif multi:
                if topo is None:
                    topo, single = mesh.make_lane_topology(
                        args.batch, pods, args.model_parallel)
                ranks = list(range(world))
            elif lost:                        # every loss empties (1, 1)
                plan_elastic_mesh(names, shape, sorted(lost))
            flags = _flag_group(ranks) if multi else None
            lead = not multi or dist.get_rank() == ranks[0]
            more, out = _attempt(args, cfg, run_cfg, plan,
                                 topo if multi else None, single, dev,
                                 params, stats, losses, flags, terminate,
                                 lead=lead)
            if more is None:
                params, opt_state = out
                break
            params = None      # the next attempt restores or re-inits
            lost |= set(_restart_flat_indices(names, shape, lost, more))
            stats["restarts"] += 1
            if lead:
                print(f"restart {attempt + 1}/{args.max_restarts}: "
                      f"re-planning around lost devices {sorted(lost)}",
                      flush=True)
        else:
            print(f"giving up after {args.max_restarts} restarts",
                  file=sys.stderr, flush=True)
            raise RuntimeError(
                f"giving up after {args.max_restarts} restarts")
    finally:
        signal.signal(signal.SIGTERM, old)
        # a group made after an elastic shrink is named by its ranks and
        # the number of groups this process holds; destroying one would
        # let a later group of the same ranks take its name (and its
        # stale rendezvous), so the flag groups stay until the world ends
        if owns_world:
            dist.destroy_process_group()
    return [float(x) for x in losses], params, opt_state


def _attempt(args, cfg, run_cfg, plan, topo, single, dev, params, stats,
             losses, flags, terminate, *, lead):
    """One attempt of the run on ``topo`` (None: one process), appending
    each step's loss to ``losses``; ``lead``: this rank logs and writes
    the checkpoints (the lowest world rank of the job, the root of its
    topology).  Returns ``(None, (params, opt_state))`` when the run
    completed or stopped (SIGTERM), or ``(the current lane ranks the
    health ladder condemned, None)`` on RESTART, after the emergency
    checkpoint committed.

    The timing cache is set up first (``_setup_tuner``: with ``--tune``
    the probe runs before any model state exists), the fitted constants
    installed, and only then the step and the state built, so the K/B
    resolutions the layouts commit to are priced with the same constants
    as dispatch; each attempt probes its own topology, whose signature a
    restart changes."""
    tuner, cache_path = _setup_tuner(args, topo, dev, flags, stats,
                                     lead=lead)
    _adopt_fitted_hw(tuner, *((topo.n(), topo.N()) if topo is not None
                              else (1, 1)), lead=lead)
    stats["hw"] = get_hw()
    if topo is not None:
        comm = LaneComm(topo, dataclasses.replace(
            CommConfig.from_run(run_cfg), tuner=tuner))
        if args.batch % topo.p():
            raise ValueError(f"global batch {args.batch} not divisible by "
                             f"the {topo.p()} processes of the batch axes")
        rows = args.batch // topo.p()
        row0 = topo.global_rank() * rows
        num_pods = topo.N()
    else:
        comm, row0, rows, num_pods = None, 0, args.batch, 1
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                          total_steps=args.steps)
    logged = []
    ckpt, start = None, 0
    # the step first (it refuses lane_zero3 on one batch axis), then the
    # state in its layout
    step = build_train_step(run_cfg, opt_cfg, comm, single=single)
    if params is None:
        params = init_model(cfg, seed=args.seed, device=dev)
    params, opt_state, layout = init_lane_train_state(
        run_cfg, params, comm, single=single, device=dev)
    if args.ckpt:
        if lead:
            ckpt = AsyncCheckpointer(args.ckpt, layout=layout)
        if latest_step(args.ckpt) is not None:
            t0 = time.perf_counter()
            del params, opt_state
            (params, opt_state), start = restore_lane_train_state(
                args.ckpt, run_cfg, layout, comm, device=dev)
            stats["restore_s"] = time.perf_counter() - t0
            if lead:
                print(f"resumed from step {start} "
                      f"(layout {layout.kind})", flush=True)
    # the fault/quorum machinery: the watchdog folds the plan's heartbeats
    # into the 0/1 contributing mask, the health monitor runs the ladder
    # on it; every rank derives the same mask and the same transitions.
    # Strategies without a quorum sync cannot form a step minus a pod, so
    # any masked pod escalates straight to RESTART (can_degrade=False).
    needs_mask = bool(getattr(step, "needs_quorum_mask", False))
    watch = Watchdog(num_pods) if (plan or needs_mask) else None
    health = HealthMonitor(
        num_pods, staleness_limit=args.quorum_staleness,
        can_degrade=needs_mask,
        log=(lambda m: print(m, flush=True)) if lead else None) \
        if watch else None
    loader = make_loader(cfg, args.seq, args.batch, seed=args.seed)
    done = saved = start    # the last completed / committed step
    in_step = False         # the in-place update is under way
    unwinding = False
    restart = None          # the condemned pods, on RESTART

    def save(at):
        t1 = time.perf_counter()
        tree = state_to_host(run_cfg, layout, params, opt_state, comm)
        if ckpt is not None:
            ckpt.save(at, tree, attempt_hook=plan.ckpt_attempt_hook(at),
                      copy=False, since=t1)
            _post_commit_faults(ckpt, plan, args.ckpt, at)

    t0 = time.time()
    try:
        try:
            for s in range(start, args.steps):
                mask = None
                if watch is not None:
                    for pod in set(range(num_pods)) \
                            - set(plan.pods_down(s, num_pods)):
                        watch.heartbeat(pod, s)
                    mask = watch.mask(s)
                    state = health.observe(s, mask)
                    if state == RESTART:
                        restart = health.restart_pods()
                        break
                    if state == DEGRADED and lead:
                        r = args.batch // num_pods
                        for pod in watch.stale(s):
                            # the dropped rows are a pure function of
                            # (seed, step, row range): ShardedLoader
                            # .batch_slice regenerates exactly them
                            print(f"degraded step {s}: pod {pod} masked; "
                                  f"rows [{pod * r}, {(pod + 1) * r}) "
                                  f"dropped, replayable from (seed="
                                  f"{args.seed}, step={s})", flush=True)
                toks, labels = loader.batch_slice(s, row0, rows)
                call = [params, opt_state, torch.as_tensor(toks, device=dev),
                        torch.as_tensor(labels, device=dev)]
                in_step = True
                if needs_mask:
                    loss, params, opt_state = step(
                        *call, quorum_mask=torch.from_numpy(
                            mask if mask is not None
                            else np.ones((num_pods,), np.float32)))
                else:
                    loss, params, opt_state = step(*call)
                in_step = False
                done = s + 1      # only once the step returned
                losses.append(loss)
                if s % args.log_every == 0 or s == args.steps - 1:
                    lv = float(loss)
                    logged.append(lv)
                    tps = (s - start + 1) * args.batch * args.seq \
                        / (time.time() - t0)
                    if lead:
                        print(f"step {s:5d}  loss {lv:8.4f}  tok/s "
                              f"{tps:9.0f}", flush=True)
                if args.ckpt and done % args.ckpt_every == 0:
                    save(done)
                    saved = done
                if _any_rank(terminate["now"], flags):
                    if lead:
                        print("SIGTERM: emergency checkpoint", flush=True)
                    break
        except BaseException:
            unwinding = True
            raise
        finally:
            if args.ckpt:
                try:
                    if done > saved and not in_step:
                        save(done)
                        saved = done
                    elif done > saved:
                        # the failing step had begun to update the state
                        # in place: it is no longer step done's
                        print(f"emergency checkpoint skipped: the state of "
                              f"step {done} was being updated in place by "
                              f"the failing step; latest committed "
                              f"checkpoint is step {saved}",
                              file=sys.stderr, flush=True)
                    if ckpt is not None:
                        ckpt.wait()
                        stats["saves"] = stats.get("saves", []) \
                            + ckpt.records
                    if flags is not None and not unwinding:
                        dist.barrier(group=flags)
                except BaseException as e:  # noqa: BLE001
                    # the writer's failure is reported; it is raised only
                    # where it would not mask the exception under way
                    print(f"CHECKPOINT ERROR: save at step {done} failed: "
                          f"{e!r}", file=sys.stderr, flush=True)
                    if not unwinding:
                        raise
    finally:
        if health is not None:
            stats["events"].extend(health.events)
        if comm is not None:
            stats["selections"].extend(comm.selections)
    _commit_tuner_misses(cache_path, tuner, flags, lead=lead)
    if lead and comm is not None and comm.last_selection is not None:
        sel = comm.last_selection
        print(f"auto {sel.collective}: {sel.strategy} ({sel.source}) at "
              f"{sel.payload_bytes} B", flush=True)
    if restart is not None:
        if lead:
            print(f"RESTART at step {done}: emergency checkpoint committed, "
                  f"shrinking around pods {restart}", flush=True)
            if not args.ckpt:
                print("WARNING: no --ckpt; the restarted attempt re-inits "
                      "from scratch", file=sys.stderr, flush=True)
        return restart, None
    params = step.full_params(params)
    if start >= args.steps:
        if lead:
            print(f"nothing to do: resumed at step {start} >= --steps "
                  f"{args.steps}")
    elif lead and not logged:
        print(f"stopped at step {done} before the first log boundary")
    elif lead and len(logged) >= 2 and logged[-1] >= logged[0]:
        print(f"WARNING: loss did not decrease ({logged[0]:.3f} → "
              f"{logged[-1]:.3f})")
    elif lead and logged:
        print(f"loss {logged[0]:.4f} → {logged[-1]:.4f}  OK")
    return None, (params, opt_state)


def _tuning_cache_path(args) -> str:
    """Where the timing cache lives: ``--tuning-cache`` if given, else
    beside the checkpoints, else nowhere ("")."""
    return args.tuning_cache or (
        os.path.join(args.ckpt, DEFAULT_CACHE_NAME) if args.ckpt else "")


def _setup_tuner(args, topo, dev, flags, stats, *, lead):
    """Restore/probe the timing cache and return ``(Tuner or None, the
    cache's path)``, as ``repro``'s ``_setup_tuner``.

    The cache rides in the checkpoint directory by default
    (``--tuning-cache`` overrides), so a resumed run re-ranks with the
    same measured costs it committed to — measure once, then commit.  A
    missing or corrupt cache degrades to the closed-form model (the
    reason printed); with ``--tune`` the probe fills (only) unmeasured
    cells — the ladder sweep PLUS the persisted cache-miss worklist
    (payloads a previous run's dispatch asked for but the cache could not
    answer) — and the lead rank saves the merged table atomically,
    consuming the worklist.  The cache is the lead's: the lead alone
    reads and writes the file, and broadcasts its path, table and
    worklist over ``flags`` (the job's processes), so every rank starts
    from the same cells whatever file it would see, probes the same
    cells and holds the same table; the others wait at a barrier while
    the lead writes.  ``--tune`` needs a started world (``topo``): one
    process has no collectives to time, and it raises."""
    if not (args.tune or _tuning_cache_path(args)):
        return None, ""
    if args.tune and topo is None:
        raise ValueError("--tune times the collectives of a started "
                         "world; run under torchrun (or pass topo=)")
    box = [None]
    if lead:
        path = _tuning_cache_path(args)
        box = [(path,
                (load_timing_table_or_none(path) if path else None)
                or TimingTable(),
                load_misses(path) if path and args.tune else [])]
    if flags is not None:
        dist.broadcast_object_list(box, src=dist.get_global_rank(flags, 0),
                                   group=flags)
    cache_path, table, worklist = box[0]
    if args.tune:
        t0 = time.perf_counter()
        probe_cells(topo, device=dev, group=flags, table=table,
                    ladder=SMOKE_LADDER if args.smoke else DEFAULT_LADDER,
                    verbose=lead)
        t1 = time.perf_counter()
        probed = probe_worklist(topo, worklist, table=table, device=dev,
                                group=flags, verbose=lead) \
            if worklist else 0
        stats["tuning"] = {"ladder_s": t1 - t0,
                           "worklist_s": time.perf_counter() - t1,
                           "worklist": probed, "cells": len(table)}
        if lead and worklist:
            print(f"tuning worklist: {probed}/{len(worklist)} recorded "
                  f"misses probed", flush=True)
        if cache_path:
            if lead:
                save_timing_table(cache_path, table)
                print(f"tuning cache committed: {cache_path} "
                      f"({len(table)} cells)", flush=True)
            if flags is not None:
                dist.barrier(group=flags)
        if dev.type == "cuda":
            torch.cuda.empty_cache()    # the probe's payloads, before the model
    return (Tuner(table, device=dev) if len(table) else None), cache_path


def _adopt_fitted_hw(tuner, n, N, *, lead) -> None:
    """Install the timing-cache-fitted HW constants BEFORE step building,
    as ``repro``'s ``_adopt_fitted_hw``: with a measured table the
    closed-form cost model prices with constants fitted to it
    (``tuning.fit_hw``), and the install comes before ``build_train_step``
    and ``init_lane_train_state`` so the K/B layout resolutions the run
    (and its checkpoint geometry) commit to are priced with the same
    constants end to end.  ``run`` restores the previous constants when
    it ends.

    Unlike ``repro``, the fit takes only the cells of this run's
    topology (``n`` x ``N``): cells of a topology a restart left behind,
    or of another card, say nothing of this one.  A table with no such
    cell, or whose cells leave a level unseen (p = 1 sees no lane level:
    the fit would clamp its constants to their floors), keeps the
    constants in force, and says why."""
    if tuner is None:
        return
    sig = tuner.signature(n, N)
    try:
        fit = fit_hw(tuner.table, topo_sig=sig)
    except ValueError as e:
        if lead:
            print(f"fitted-HW adoption skipped ({e}); cost model keeps the "
                  f"shipped constants", flush=True)
        return
    if fit.blind:
        if lead:
            print(f"fitted-HW adoption skipped (no {sig} cell sees the "
                  f"{' or '.join(fit.blind)} level); cost model keeps the "
                  f"shipped constants", flush=True)
        return
    set_hw(fit.hw)
    if lead:
        print(f"cost-model HW adopted from measured timing cache: "
              f"{fit.num_cells} cells of {sig}, residual rms "
              f"{fit.residual_rms_us:.1f}us / max "
              f"{fit.residual_max_us:.1f}us", flush=True)


def _commit_tuner_misses(cache_path, tuner, flags, *, lead) -> None:
    """Persist the misses dispatch recorded in this attempt to the lead's
    ``cache_path`` so the next ``--tune`` launch probes exactly those
    cells (the "commit" half of measure-once-then-commit for payloads
    the ladder never covered), on the lead rank; the others wait at a
    barrier, so the next attempt reads the file whole.  A failed write
    is reported and does not fail a finished run, as in ``repro``."""
    if not (cache_path and tuner is not None and tuner.misses):
        return
    if lead:
        try:
            save_timing_table(cache_path, tuner.table, misses=tuner.misses)
            uniq = len(dict.fromkeys(tuple(m) for m in tuner.misses))
            print(f"tuning misses committed: {uniq} cells queued for the "
                  f"next --tune pass ({cache_path})", flush=True)
        except OSError as e:
            print(f"WARNING: tuning miss commit failed: {e}",
                  file=sys.stderr, flush=True)
    if flags is not None:
        dist.barrier(group=flags)


def _outer_axis(names) -> int:
    """Index of the outermost batch axis (the lane level): the axis
    ``plan_elastic_mesh`` shrinks and the watchdog's quorum is over."""
    for a in ("pod", "data"):
        if a in names:
            return names.index(a)
    raise ValueError(f"no batch axis in {names}")


def _restart_flat_indices(names, shape, lost, pod_ranks) -> list:
    """The CURRENT topology's lane ranks the health ladder condemned, as
    the original mesh's flat indices (world ranks), as ``repro``'s
    ``_restart_flat_indices``.  The current topology is the original
    minus the outer slices that hold ``lost``; the surviving outer
    coordinates, in order, are its lane ranks.  Re-planning from the
    original shape and ``lost`` plus these is the ``--lose-chips`` path,
    so an in-process restart equals a fresh launch that lost the same
    pods."""
    outer = _outer_axis(names)
    dropped = {np.unravel_index(i, shape)[outer] for i in lost}
    survivors = [c for c in range(shape[outer]) if c not in dropped]
    out = []
    for q in pod_ranks:
        coord = survivors[q]
        out.extend(i for i in range(math.prod(shape))
                   if np.unravel_index(i, shape)[outer] == coord)
    return sorted(out)


def _post_commit_faults(ckpt, plan: FaultPlan, ckpt_dir: str,
                        step: int) -> None:
    """Apply the plan's corrupt_leaf fault of ``step``, if any, AFTER the
    async commit lands (so the crc32 check, not the atomic rename, is
    what must catch it)."""
    leaf = plan.corrupt_at(step)
    if leaf is not None:
        ckpt.wait()
        p = corrupt_leaf_file(ckpt_dir, step, leaf)
        print(f"fault: corrupted {p} after commit "
              f"(restore must fall back via crc32)", flush=True)


def _flag_group(ranks):
    """The group the SIGTERM flag is or'ed over, and the barrier after a
    checkpoint (a SIGTERM reaches each rank on its own; all of them must
    stop at the same step boundary): None for a job of one rank, which
    needs no reduction; else a gloo group of the job's ``ranks`` (the
    world itself where it is gloo and whole), so that the check runs on
    the hosts and never waits for the card.  After an elastic shrink the
    survivors alone create it."""
    ranks = list(ranks)
    if len(ranks) == 1:
        return None
    if len(ranks) == dist.get_world_size():
        if dist.get_backend() == "gloo":
            return dist.group.WORLD
        return dist.new_group(backend="gloo")
    return dist.new_group(ranks, backend="gloo",
                          use_local_synchronization=True)


def _any_rank(flag: bool, group) -> bool:
    """``flag`` or'ed over ``group`` (``_flag_group``'s), on the host."""
    if group is None:
        return flag
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def main(argv=None) -> list:
    """Train and return every step's loss (floats); see ``run``."""
    return run(argv)[0]


def params_digest(params) -> str:
    """sha256 of every parameter's bytes, in tree order: equal across
    ranks iff the replicas are bitwise equal."""
    h = hashlib.sha256()
    for leaf in _tree.leaves(params):
        t = leaf.detach().cpu().contiguous()
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def rank_worker(argv):
    """One rank of a ``mesh.spawn`` world: train with ``argv`` and return
    (losses, params_digest; None on a rank an elastic restart left
    out)."""
    losses, params, _ = run(argv)
    return losses, None if params is None else params_digest(params)


if __name__ == "__main__":
    main()
    sys.exit(0)
