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
the host), assembled on world rank 0 in ``repro``'s files.  A run with
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

The rest of ``repro``'s training loop is not ported yet.  Each of its flags
is accepted and raises, naming its ROADMAP.md item, when it is set away
from its default: tensor and expert parallelism, fault injection,
elastic restarts and tuning (item 10).  Nothing is ignored silently.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import signal
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, latest_step
from repro_torch.comm import CommConfig, LaneComm
from repro_torch.configs import RunConfig, resolve
from repro_torch.data import make_loader
from repro_torch.launch import mesh
from repro_torch.launch.steps import (build_train_step,
                                     init_lane_train_state,
                                     restore_lane_train_state,
                                     state_to_host)
from repro_torch.models import init_model
from repro_torch.optim import AdamWConfig

# repro's flags that the port does not honour yet: (default, ROADMAP item)
_ITEM = "ROADMAP.md, Queue 1, item"
UNPORTED = {
    "model_parallel": (1, f"{_ITEM} 10 (TP/EP)"),
    "expert_parallel": (False, f"{_ITEM} 10 (TP/EP)"),
    "ep_blocks": (1, f"{_ITEM} 10 (TP/EP)"),
    "lose_chips": ("", f"{_ITEM} 10 (runtime/)"),
    "fault_plan": ("", f"{_ITEM} 10 (runtime/)"),
    "quorum_staleness": (2, f"{_ITEM} 10 (runtime/)"),
    "max_restarts": (2, f"{_ITEM} 10 (runtime/)"),
    "tune": (False, f"{_ITEM} 10 (tuning/)"),
    "tuning_cache": ("", f"{_ITEM} 10 (tuning/)"),
}


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
                         "backward); dots is not ported")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatch", type=int, default=0,
                    help="gradient-accumulation microbatches per step "
                         "(0 = off); the batch must divide by it")
    ap.add_argument("--accum-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="microbatch gradient accumulator precision")
    ap.add_argument("--gradsync", default="native",
                    help="gradient sync across ranks: native, lane, "
                         "lane_pipelined, lane_int8, lane_zero1 or "
                         "lane_zero3 (repro's other strategies raise, "
                         "naming their items)")
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
    for name, (default, _) in UNPORTED.items():
        flag = "--" + name.replace("_", "-")
        if isinstance(default, bool):
            ap.add_argument(flag, action="store_true", help="not ported")
        else:
            ap.add_argument(flag, type=type(default), default=default,
                            help="not ported")
    return ap


def _refuse_unported(args) -> None:
    for name, (default, item) in UNPORTED.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not ported yet ({item})")


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
    world to train on with both of its levels as batch axes, where
    ``launch.mesh.make_lane_topology`` would give one (e.g. the 1 x 1
    topology of one card, on which ``lane_zero3`` then runs); default
    ``make_lane_topology``.  ``stats``: a dict that receives, on world
    rank 0, ``"saves"`` (per checkpoint: step, the loop's blocking
    seconds, the writer's seconds, bytes written) and ``"restore_s"``.
    The log lines and the closing loss check are ``repro``'s, printed by
    world rank 0.  Resuming at or past ``--steps`` returns no losses."""
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    cfg = resolve(args.arch, smoke=args.smoke)
    run_cfg = RunConfig(model=cfg, remat=args.remat, gradsync=args.gradsync,
                        gradsync_buckets=args.gradsync_buckets,
                        fsdp_prefetch=args.fsdp_prefetch,
                        fsdp_regather=args.fsdp_regather,
                        microbatch=args.microbatch,
                        accum_dtype=args.accum_dtype)
    owns_world = False
    if _multi_rank():
        owns_world = not dist.is_initialized()
        dev = mesh.init_world(args.device)
        if topo is None:
            pods = mesh.resolve_pods(args.pods, args.gradsync)
            topo, single = mesh.make_lane_topology(args.batch, pods)
        else:
            single = False
        comm = LaneComm(topo, CommConfig.from_run(run_cfg))
        flags = _flag_group()
        rows = args.batch // topo.p()
        row0 = topo.global_rank() * rows
        lead = dist.get_rank() == 0
    else:                                    # repro's rules, one device
        mesh.mesh_shape(1, args.batch,
                        mesh.resolve_pods(args.pods, args.gradsync, 1))
        dev = resolve_device(args.device)
        comm, single, row0, rows, lead = None, True, 0, args.batch, True
        flags = None
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                          total_steps=args.steps)
    stats = {} if stats is None else stats
    losses, logged = [], []
    # SIGTERM (preemption): an emergency checkpoint at the next step
    # boundary
    terminate = {"now": False}
    old = signal.signal(signal.SIGTERM,
                        lambda *_: terminate.__setitem__("now", True))
    ckpt, start = None, 0
    try:
        # the step first (it refuses lane_zero3 on one batch axis), then
        # the state in its layout
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
        loader = make_loader(cfg, args.seq, args.batch, seed=args.seed)
        done = saved = start    # the last completed / committed step
        in_step = False         # the in-place update is under way
        unwinding = False

        def save(at):
            t1 = time.perf_counter()
            tree = state_to_host(run_cfg, layout, params, opt_state, comm)
            if ckpt is not None:
                ckpt.save(at, tree, copy=False, since=t1)

        t0 = time.time()
        try:
            for s in range(start, args.steps):
                toks, labels = loader.batch_slice(s, row0, rows)
                in_step = True
                loss, params, opt_state = step(
                    params, opt_state, torch.as_tensor(toks, device=dev),
                    torch.as_tensor(labels, device=dev))
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
                        stats["saves"] = ckpt.records
                    if comm is not None and not unwinding:
                        dist.barrier()
                except BaseException as e:  # noqa: BLE001
                    # the writer's failure is reported; it is raised only
                    # where it would not mask the exception under way
                    print(f"CHECKPOINT ERROR: save at step {done} failed: "
                          f"{e!r}", file=sys.stderr, flush=True)
                    if not unwinding:
                        raise
        params = step.full_params(params)
    finally:
        signal.signal(signal.SIGTERM, old)
        if owns_world:
            dist.destroy_process_group()
        elif flags not in (None, dist.group.WORLD):
            dist.destroy_process_group(flags)
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
    return [float(x) for x in losses], params, opt_state


def _flag_group():
    """The group the SIGTERM flag is or'ed over (a SIGTERM reaches each
    rank on its own; all of them must stop at the same step boundary):
    None in a world of one rank, which needs no reduction; else the world
    where it is gloo, or a gloo group of the world, so that the check
    runs on the hosts and never waits for the card."""
    if dist.get_world_size() == 1:
        return None
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    return dist.new_group(backend="gloo")


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
    (losses, params_digest)."""
    losses, params, _ = run(argv)
    return losses, params_digest(params)


if __name__ == "__main__":
    main()
    sys.exit(0)
