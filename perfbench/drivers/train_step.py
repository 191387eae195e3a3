"""Driver ``train_step``: the program's replicated training step, timed.

Set-up builds the step as ``repro_torch.launch.train`` builds it
(``launch.mesh.init_world`` and ``make_lane_topology`` across ranks,
``launch.steps.build_train_step``, ``init_lane_train_state``), from the
benchmark's own weights (``perfbench.weights``, cast into the program's
tree) and its own rows (``perfbench.traffic``).  It then takes
``CHECKED_STEPS`` steps through the same call the window makes, on rows
that all differ, and keeps their readings: each step's loss, each
parameter's norm of the first gradient as AdamW took it (its first
moment after one step, over 1 - b1) and each parameter's norm of the
change after the last of them.  These steps are also the warm-up: the
kernels are built or loaded and every shape has run once.

``--trace 0``: the window.  Step after step, each ending with
``torch.cuda.synchronize()``, until one ends past ``--seconds``; the
steps that ended inside it count.  Across ranks a step counts only when
it ended inside the window on every rank (a flag reduced over a gloo
group after each step).

``--trace 1``: ``TRACE_STEPS`` steps under ``torch.profiler`` on every
rank, inside one ``perfbench/window`` range, after one step that the
profiler runs in its warm-up and discards (the tracer's start-up falls
there, not in the recorded steps).

Then the program's state is freed and the reference makes the same
weights again and takes the same checked steps in float32
(``reference.common.train_steps``; across ranks each rank its own rows,
the loss and gradients averaged over the ranks with
``torch.distributed.all_reduce``), and ``compare.judge`` decides.
"""
from __future__ import annotations

import gc
import math
import time

import torch
import torch.distributed as dist

from perfbench import compare, trace as trace_mod, traffic as traffic_mod
from perfbench import weights as weights_mod
from perfbench.reference import common as ref

ADAMW_KEYS = ("lr", "b1", "b2", "eps", "weight_decay", "clip_norm",
              "warmup_steps", "total_steps", "min_lr_frac")
CHECKED_STEPS = 3      # the steps the reference follows
WINDOW_BATCHES = 48    # the window's global batches, taken in turn
TRACE_STEPS = 3        # the steps a traced run profiles
HOST_THREADS = 4       # torch's CPU threads in each process on the card


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _named(tree) -> list:
    from repro_torch import _tree
    return [(".".join(map(str, path)), leaf)
            for path, leaf in _tree.flatten(tree)]


def program_config(ctx):
    """The program's model config for the configuration file, refused
    where a field differs from the file's value."""
    from repro_torch.configs import resolve
    prog = ctx.config["program"]
    cfg = resolve(prog["arch"], smoke=bool(prog.get("smoke", False)))
    for attr, key in prog["fields"].items():
        got, want = getattr(cfg, attr), ctx.config[key]
        same = math.isclose(got, want, rel_tol=1e-9) \
            if isinstance(want, float) else got == want
        if not same:
            raise ValueError(f"the program's {attr}={got!r} is not the "
                             f"configuration's {key}={want!r}")
    return cfg


def program_tree(cfg, weights: dict):
    """The program's parameter tree, each leaf a copy of the benchmark's
    weight of the same path, refused where a path, shape or type
    differs."""
    from repro_torch import _tree
    from repro_torch.models import init_model
    template = init_model(cfg, device="meta")
    named = _named(template)
    if {n for n, _ in named} != set(weights):
        raise ValueError(f"the program's parameters "
                         f"{sorted({n for n, _ in named} ^ set(weights))} "
                         f"differ from the configuration's")
    leaves = []
    for name, t in named:
        w = weights[name]
        if tuple(w.shape) != tuple(t.shape) or w.dtype != t.dtype:
            raise ValueError(f"{name}: the program holds {tuple(t.shape)} "
                             f"{t.dtype}, the configuration "
                             f"{tuple(w.shape)} {w.dtype}")
        leaves.append(w.clone())
    return _tree.unflatten(template, leaves)


def _again(specs, seed, dev, made: float) -> dict:
    """The weights made again from the seed, refused unless they are the
    ones the program was given (the same checksum)."""
    w = weights_mod.make_weights(specs, seed, dev)
    if weights_mod.checksum(w) != made:
        raise RuntimeError("the weights made again differ from the "
                           "program's")
    return w


def _readings(losses, first, params, start) -> dict:
    return {"losses": losses, "first_grad": first,
            "change": {name: float((p.detach().float()
                                    - start[name].float()).norm())
                       for name, p in _named(params)}}


def run(ctx) -> dict:
    """One rank's run (see the module docstring); across ranks the world
    is started here, unless the caller started it, and then ended before
    it returns."""
    # few host threads: on the card for steady runs, on the CPU (the
    # tests' smoke runs, several ranks a host) so as not to oversubscribe
    threads = torch.get_num_threads()
    torch.set_num_threads(HOST_THREADS if ctx.device_type == "cuda" else 1)
    try:
        return _on_world(ctx)
    finally:
        torch.set_num_threads(threads)


def _on_world(ctx) -> dict:
    from repro_torch.launch import mesh
    if ctx.world == 1:
        dev = torch.device(ctx.device_type)
        if dev.type == "cuda":
            dev = torch.device("cuda", 0)
            torch.cuda.set_device(dev)
        return _run(ctx, dev, None)
    owned = not dist.is_initialized()
    dev = mesh.init_world(ctx.device_type, rank=ctx.rank,
                          world_size=ctx.world, init_method=ctx.init_method)
    try:
        return _run(ctx, dev, dist.new_group(backend="gloo"))
    finally:
        if owned:
            dist.destroy_process_group()


def _run(ctx, dev, group) -> dict:
    from repro_torch.comm import CommConfig, LaneComm
    from repro_torch.configs import RunConfig
    from repro_torch.launch import mesh
    from repro_torch.launch import steps as S
    from repro_torch.optim import AdamWConfig

    cell, tr = ctx.cell, ctx.traffic
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else dev.type
    cfg = program_config(ctx)
    ctx.family.check(ctx.config)
    run_cfg = RunConfig(model=cfg, **cell["run"])
    rows_global, seq = int(tr["rows"]), int(tr["seq"])
    rows, row0, comm, single = rows_global // ctx.world, 0, None, True
    if ctx.world > 1:
        topo, single = mesh.make_lane_topology(rows_global,
                                               int(cell["pods"]))
        comm = LaneComm(topo, CommConfig.from_run(run_cfg))
        row0 = topo.global_rank() * rows
    opt_d = {k: cell["adamw"][k] for k in ADAMW_KEYS}
    step = S.build_train_step(run_cfg, AdamWConfig(**opt_d), comm,
                              single=single)

    specs = ctx.family.param_specs(ctx.config)
    start = weights_mod.make_weights(specs, ctx.seed, dev)
    made = weights_mod.checksum(start)
    tree = program_tree(cfg, start)
    del start
    params, opt_state, layout = S.init_lane_train_state(
        run_cfg, tree, comm, single=single, device=dev)
    del tree
    if layout.kind != "replicated":
        raise ValueError(f"driver train_step runs replicated layouts, not "
                         f"{layout.kind}")
    checked = CHECKED_STEPS
    inp, lab = traffic_mod.packed_rows(tr, ctx.config, ctx.seed,
                                       checked + WINDOW_BATCHES)
    inp = torch.from_numpy(inp[:, row0:row0 + rows]).to(dev)
    lab = torch.from_numpy(lab[:, row0:row0 + rows]).to(dev)

    losses, first, step_s = [], None, []
    for s in range(checked):
        _sync(dev)
        t = time.perf_counter()
        loss, params, opt_state = step(params, opt_state, inp[s], lab[s])
        _sync(dev)
        step_s.append(time.perf_counter() - t)
        losses.append(float(loss))
        if first is None:
            first = {n: float(m.norm()) / (1 - opt_d["b1"])
                     for n, m in _named(opt_state["m"])}
    prog = _readings(losses, first, params, _again(specs, ctx.seed, dev,
                                                   made))
    ctx.log(f"checked steps: {' '.join(f'{s:.3f}' for s in step_s)} s, "
            f"losses {' '.join(f'{x:.5f}' for x in losses)}")

    rec = {"device_kind": kind, "rows": rows, "rows_global": rows_global,
           "seq": seq}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if group is not None:
        dist.barrier(group=group)
    batch = lambda k: checked + k % WINDOW_BATCHES
    if ctx.trace:
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function, schedule)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev.type == "cuda" else [])
        n = TRACE_STEPS
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=n, repeat=1)) as prof:
            loss, params, opt_state = step(params, opt_state,
                                           inp[batch(n)], lab[batch(n)])
            _sync(dev)
            prof.step()
            with record_function(trace_mod.WINDOW):
                for k in range(n):
                    loss, params, opt_state = step(
                        params, opt_state, inp[batch(k)], lab[batch(k)])
                    _sync(dev)
        rec["trace"] = trace_mod.summarize(prof)
        rec["trace_steps"] = n
        rec["attempted"], rec["failed"] = n, int(not math.isfinite(
            float(loss)))
        del prof
    elif ctx.seconds > 0:
        rec["window_start"] = time.time()
        t0 = time.perf_counter()
        ends, window_losses, k = [], [], 0
        while True:
            loss, params, opt_state = step(params, opt_state,
                                           inp[batch(k)], lab[batch(k)])
            _sync(dev)
            t = time.perf_counter() - t0
            late = torch.tensor([int(t > ctx.seconds)])
            if group is not None:
                dist.all_reduce(late, op=dist.ReduceOp.MAX, group=group)
            if late.item():
                break
            ends.append(t)
            window_losses.append(loss.detach())
            k += 1
        if not ends:
            raise RuntimeError(f"no step ended inside {ctx.seconds} s")
        rec["window"] = {"steps": len(ends), "seconds": ends[-1],
                         "tokens": len(ends) * rows_global * seq}
        rec["attempted"] = len(ends)
        rec["failed"] = int(sum(not math.isfinite(float(x))
                                for x in window_losses))
        each = sorted(b - a for a, b in zip([0.0] + ends, ends))
        ctx.log(f"window: {len(ends)} steps in {ends[-1]:.3f} s; a step "
                f"{each[0]:.3f} / {each[len(each) // 2]:.3f} / "
                f"{each[-1]:.3f} s (least / median / most)")
    else:
        rec["attempted"], rec["failed"] = 0, 0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    busy = rec["trace"]["busy_s"] if ctx.trace else 0.0
    if group is not None:
        got = [None] * ctx.world
        dist.all_gather_object(got, (peak, busy), group=group)
        peak = max(p for p, _ in got)
        busy = sum(b for _, b in got) / ctx.world
    rec["peak_bytes_own"] = peak if group is None else got[ctx.rank][0]
    rec["memory_peak_bytes"], rec["busy_s"] = peak, busy

    del step, params, opt_state, loss
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    mean = None
    if ctx.world > 1:
        def mean(tensors):
            for t in tensors:
                dist.all_reduce(t)
                t.div_(ctx.world)
    batches = [(inp[s], lab[s]) for s in range(checked)]
    sides = {"reference": ref.Precision("f32")}
    if ctx.control:
        sides["control"] = ref.Precision("fp8")
    for side, prec in sides.items():
        w = _again(specs, ctx.seed, dev, made)
        with ref.f32_products():
            rec[side] = ref.train_steps(ctx.family, ctx.config, w, batches,
                                        opt_d, prec, mean)
        del w
        gc.collect()
    rec["program"] = prog
    rec["correct"], rec["checks"] = compare.judge(
        prog, rec["reference"], cell["limits"], cell.get("loss_steps"))
    return rec
