"""Functions the port's multi-rank tests run on every rank of a
``repro_torch.launch.mesh.spawn`` world (gloo on the CPU), and how those
tests start ``repro``'s side.  The rank functions live outside the test
files because a spawned process imports the module of the function it
runs, and test files import ``repro`` (and with it JAX), which a port
process must not.
"""
import os
import pathlib

import numpy as np
import torch

import _collective_grid as grid

ROOT = pathlib.Path(__file__).resolve().parents[1]
REPRO_SIDE = pathlib.Path(__file__).resolve().parent / "_repro_lane_side.py"

DT = {"f32": torch.float32, "bf16": torch.bfloat16, "int32": torch.int32}


def repro_env(devices: int) -> dict:
    """The environment of a ``repro`` subprocess (``REPRO_SIDE``) with
    ``devices`` host devices; the test process's own is left as it is."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def _numpy(t):
    return t.to(torch.int32 if t.dtype == torch.int32 else torch.float32
                ).numpy()


def collectives_rank(topo_key):
    """Every grid case of ``topo_key`` through the port's LaneComm (the
    pipelined allgather through ``core.pipeline``): ({case: this rank's
    output}, {error case: the exception's type name or None})."""
    from repro_torch.comm import LaneComm
    from repro_torch.core.pipeline import pipelined_allgather_lane
    from repro_torch.launch.mesh import new_lane_topology
    n, N = grid.TOPOS[topo_key]
    topo = new_lane_topology(n, N)
    comm = LaneComm(topo)
    g = topo.global_rank()
    out = {}
    for k, case in enumerate(grid.cases(topo_key)):
        xs = grid.payload(case, n, N, grid.seed_of(topo_key, k))
        x = torch.from_numpy(xs[g]).to(DT[case["dtype"]])
        if case["coll"] == "pipelined_allgather":
            y = pipelined_allgather_lane(x, topo, **case["kw"])
        else:
            y = getattr(comm, case["coll"])(x, strategy=case["strategy"],
                                            **case["kw"])
        assert y.dtype == x.dtype, (case["name"], y.dtype)
        out[case["name"]] = _numpy(y)
    errors = {}
    for key, coll, rows in grid.ERRORS:
        if key != topo_key:
            continue
        x = torch.zeros((rows, 2))
        try:
            getattr(comm, coll)(x, strategy="lane")
            errors[f"{coll}/{rows}"] = None
        except Exception as e:  # noqa: BLE001 - the type is the result
            errors[f"{coll}/{rows}"] = type(e).__name__
    return out, errors


def gradsync_rank(in_path, buckets):
    """``LaneComm.grad_sync`` of this rank's trees (``payload/leaf``
    entries of ``in_path``, stacked by global rank) on a 2 × 2 topology,
    for every ported strategy: {payload/strategy/leaf: synced leaf}."""
    from repro_torch.comm import CommConfig, LaneComm
    from repro_torch.launch.mesh import new_lane_topology
    topo = new_lane_topology(2, 2)
    comm = LaneComm(topo, CommConfig(buckets=buckets))
    g = topo.global_rank()
    trees = {}
    with np.load(in_path) as z:
        for key in z.files:
            name, leaf = key.split("/")
            trees.setdefault(name, {})[leaf] = z[key][g]
    out = {}
    for name, tree in trees.items():
        for strategy in ("native", "lane", "lane_pipelined", "lane_int8"):
            t = {k: torch.tensor(v) for k, v in tree.items()}
            synced = comm.grad_sync(t, strategy=strategy)
            assert synced is t
            for leaf, v in synced.items():
                out[f"{name}/{strategy}/{leaf}"] = v.numpy()
    return out


def zero_rank(topo_key):
    """Every ZeRO case of ``grid.zero_cases(topo_key)`` on this rank:
    {case: output}.  A grad sync takes the one-leaf tree ``{"g": x}``
    and gives its f32 shard; the shard functions are called as
    ``fn(x, topo, grid.ZERO_K)``."""
    from repro_torch.comm import LaneComm
    from repro_torch.launch.mesh import new_lane_topology
    from repro_torch.optim import gradsync
    n, N = grid.TOPOS[topo_key]
    topo = new_lane_topology(n, N)
    comm = LaneComm(topo)
    g = topo.global_rank()
    out = {}
    for k, case in enumerate(grid.zero_cases(topo_key)):
        xs = grid.payload(case, n, N, grid.seed_of(topo_key, k))
        x = torch.from_numpy(xs[g]).to(DT[case["dtype"]])
        coll = case["coll"]
        if coll == "grad_sync":
            y, _ = comm.grad_sync({"g": x}, strategy=case["strategy"],
                                  **case["kw"])
            assert y.dtype == torch.float32, (case["name"], y.dtype)
        elif coll == "prefetch_allgather":
            y = comm.prefetch_allgather(x, strategy=case["strategy"],
                                        **case["kw"])
        else:
            y = getattr(gradsync, coll)(x, topo, grid.ZERO_K)
        out[case["name"]] = _numpy(y)
    return out


def gradsync_tree_rank(in_path, arch):
    """``lane`` and ``lane_int8`` grad_sync, 3 buckets, on a 2 × 2
    topology, of this rank's ``repro``-layout gradient tree of ``arch``
    (``--smoke``) in ``in_path`` (``save_tree``, leaves stacked by global
    rank), bridged to the port's layout and back:
    {strategy/path: synced leaf}."""
    from repro_torch.bridge import params_from_repro, params_to_repro
    from repro_torch.comm import CommConfig, LaneComm
    from repro_torch.configs import resolve
    from repro_torch.launch.mesh import new_lane_topology
    topo = new_lane_topology(2, 2)
    g = topo.global_rank()
    cfg = resolve(arch, smoke=True)
    tree = load_tree(in_path)
    mine = _map(lambda a: a[g], tree)
    out = {}
    for strategy in ("lane", "lane_int8"):
        comm = LaneComm(topo, CommConfig(buckets=3))
        grads = params_from_repro(mine, cfg, device="cpu")
        synced = params_to_repro(comm.grad_sync(grads, strategy=strategy),
                                 cfg)
        out.update({f"{strategy}/{k}": v
                    for k, v in _flat(synced).items()})
    return out


def blockstack_rank(runs, seq=16):
    """For each (arch, npz) of ``runs``, on a 2 × 2 topology: the
    ``lane_zero3`` state of the ``repro``-layout weights in ``npz``, and
    the loss of one batch (the same on every rank) through a
    ``ShardedStack`` in each ``scan_stack`` mode, with the gradients of
    this rank's shard rows and the layer gathers counted after the
    forward and after the backward; beside them the replicated loss and
    this rank's stripes of its gradients (``zero3_param_shard``).
    {arch: {mode: (loss, [row grads], forward gathers, all gathers)}}."""
    from repro_torch import _tree
    from repro_torch.bridge import params_from_repro
    from repro_torch.comm import CommConfig, LaneComm
    from repro_torch.configs import RunConfig, resolve
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import new_lane_topology
    from repro_torch.models import loss_fn
    from repro_torch.models.blockstack import RowGather, ShardedStack
    from repro_torch.optim.gradsync import zero3_param_shard
    topo = new_lane_topology(2, 2)
    comm = LaneComm(topo, CommConfig(prefetch_blocks=2))
    out = {}
    for arch, npz in runs:
        cfg = resolve(arch, smoke=True)
        run = RunConfig(model=cfg, gradsync="lane_zero3", fsdp_prefetch=2)
        params = params_from_repro(load_tree(npz), cfg, device="cpu")
        rng = np.random.default_rng(7)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (2, seq + 1)))
        toks, labels = toks[:, :-1], toks[:, 1:]
        p_rep = _tree.tree_map(lambda t: t.detach().requires_grad_(True),
                               params)
        loss = loss_fn(p_rep, cfg, toks, labels)
        g_rep = torch.autograd.grad(loss, _tree.leaves(p_rep["blocks"]))
        lays = steps.zero3_stack_layouts(cfg)
        lay_b = lays["blocks"]
        B = steps.resolve_prefetch_blocks(lay_b.row_elems, 2, 2, 2)
        g_tree = _tree.unflatten(p_rep["blocks"], g_rep)
        mat = lay_b.flatten(g_tree, pad_to=B * topo.p())
        res = {"replicated": (float(loss), [
            zero3_param_shard(row, topo, B).numpy() for row in mat])}
        state, _, _ = steps.init_lane_train_state(run, params, comm,
                                               single=False, device="cpu")
        ext = lays["extras"].unflatten_row(comm.prefetch_allgather(
            state["extras"], num_blocks=steps.resolve_extras_prefetch_blocks(
                lays["extras"].row_elems, 2, 2, 2)))
        repl = {k: v for k, v in state.items()
                if k not in ("blocks", "extras")}
        for mode in ("prefetch", "blocking", "regather"):
            gather = RowGather(comm, lay_b, B)
            rows = [r.detach().requires_grad_(True) for r in state["blocks"]]
            p = {**repl, **ext, "blocks": ShardedStack(
                rows, gather, prefetch=mode != "blocking",
                regather=mode == "regather")}
            loss = loss_fn(p, cfg, toks, labels)
            fwd = gather.gathers
            grads = torch.autograd.grad(loss, rows)
            res[mode] = (float(loss), [g.numpy() for g in grads], fwd,
                         gather.gathers)
        out[arch] = res
    return out


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def save_tree(path, tree: dict) -> None:
    """Write a nested dict of numpy arrays to an ``.npz``, each leaf under
    its ``"/"``-joined path: how a test hands ``repro``'s weights to port
    processes that must not import ``repro``."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)
    walk(tree, ())
    np.savez(path, **flat)


def load_tree(path) -> dict:
    """The nested dict ``save_tree`` wrote."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = out
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    return out


def train_rank(runs):
    """For each (argv, npz) of ``runs`` in turn, on one world: train with
    ``argv`` from the ``repro``-layout weights in ``npz`` (``save_tree``),
    through ``bridge.params_from_repro``: [(losses, params digest), ...]."""
    from repro_torch.bridge import params_from_repro
    from repro_torch.configs import resolve
    from repro_torch.launch.train import params_digest, run
    out = []
    for argv, npz in runs:
        arch = argv[argv.index("--arch") + 1]
        params = params_from_repro(load_tree(npz),
                                   resolve(arch, smoke="--smoke" in argv),
                                   device="cpu")
        losses, params, _ = run(argv, params=params)
        out.append((losses, params_digest(params)))
    return out


def zero_train_rank(runs):
    """``train_rank`` for the ZeRO steps: [(losses, params digest, the
    whole parameter tree in ``repro``'s layout), ...] (the tree gathered
    from the stripes under ``lane_zero3``)."""
    from repro_torch.bridge import params_from_repro, params_to_repro
    from repro_torch.configs import resolve
    from repro_torch.launch.train import params_digest, run
    out = []
    for argv, npz in runs:
        arch = argv[argv.index("--arch") + 1]
        cfg = resolve(arch, smoke="--smoke" in argv)
        params = params_from_repro(load_tree(npz), cfg, device="cpu")
        losses, params, _ = run(argv, params=params)
        out.append((losses, params_digest(params),
                     params_to_repro(params, cfg)))
    return out


def zero_witness_rank(archs, steps_n=3, batch=2, seq=32):
    """On a one-rank world, ``chip_smoke.py``'s phase 9b runs of each
    arch's smoke config in bf16 from seed 0: {(arch, mode): losses} for
    the replicated step, the witness "masters" (AdamW on f32 master
    copies) and lane_zero3 (built with ``single=False`` on the 1 x 1
    topology, as the card runs it), AdamW unclipped as there (the clip
    norm's sum is the one rounding the two layouts take apart)."""
    import dataclasses
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import resolve
    from repro_torch.launch import mesh
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig
    topo, _ = mesh.make_lane_topology(batch, pods=1)
    opt = AdamWConfig(warmup_steps=1, total_steps=steps_n,
                      clip_norm=float("inf"))
    out = {}
    for arch in archs:
        cfg = dataclasses.replace(resolve(arch, smoke=True), dtype="bfloat16")
        for mode in ("replicated", "masters", "lane_zero3"):
            out[arch, mode] = cs.zero_run(
                cfg, mode, topo, init_model(cfg, seed=0, device="cpu"),
                steps_n=steps_n, batch=batch, seq=seq, device="cpu",
                opt=opt, full=False)[0]
    return out


# ---------------------------------------------------------------------------
# checkpoints (tests/test_torch_train_ckpt.py)
# ---------------------------------------------------------------------------

def canonical_digest(ckpt_dir, arch, step=None):
    """sha256 of a checkpoint's state in the replicated form (parameters
    and moments, every leaf's bytes in tree order, and the step count):
    equal for two checkpoints iff their canonical values are."""
    import hashlib
    from repro_torch import _tree
    from repro_torch.configs import resolve
    from repro_torch.launch import steps
    cfg = resolve(arch, smoke=True)
    man, state, _ = steps.load_canonical_state(ckpt_dir, cfg, step)
    params, opt = steps.state_to_replicated(cfg, man["layout"], state)
    h = hashlib.sha256()
    for tree in (params, opt["m"], opt["v"]):
        for t in _tree.leaves(tree):
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    h.update(str(opt["count"]).encode())
    return h.hexdigest()


def train_ckpt_rank(tmp, arch, npz, base):
    """On a 4-rank world (2 pods x 2): ``launch.train.run`` with ``base``
    argv and ``--ckpt``, from the ``repro``-layout weights in ``npz``:

      * ``--gradsync`` native, lane_zero1 and lane_zero3, 2 steps, a
        checkpoint at step 2 in ``tmp/<gradsync>``;
      * lane_zero3 4 steps with a checkpoint every 2 (``tmp/resume``),
        then, step 4 removed, the same run again (it resumes at step 2),
        then once more (resume at completion: nothing to do);
      * the lane_zero3 checkpoint restored across layouts and rank counts
        and written again: zero1 on a 2-process topology (two replicas
        of it in the world, ``tmp/chain_zero1_p2``), replicated
        (``tmp/chain_replicated_p1``), then back to zero3 and zero1 at
        p = 4 (``tmp/chain_zero3_p4``, ``tmp/chain_zero1_p4``).

    Returns {name: losses} (and the committed steps of ``tmp/resume``)."""
    import shutil
    import torch.distributed as dist
    from repro_torch.bridge import params_from_repro
    from repro_torch.checkpoint import (REPLICATED, committed_steps,
                                        save_checkpoint)
    from repro_torch.comm import LaneComm
    from repro_torch.configs import RunConfig, resolve
    from repro_torch.launch import mesh, steps
    from repro_torch.launch.train import run
    cfg = resolve(arch, smoke=True)
    tmp = pathlib.Path(tmp)
    lead = dist.get_rank() == 0
    weights = lambda: params_from_repro(load_tree(npz), cfg, device="cpu")
    argv = ["--arch", arch, *base, "--device", "cpu"]
    out = {}
    for gs in ("native", "lane_zero1", "lane_zero3"):
        out[gs] = run([*argv, "--steps", "2", "--gradsync", gs, "--ckpt",
                       str(tmp / gs), "--ckpt-every", "2"],
                      params=weights())[0]
    z3 = [*argv, "--gradsync", "lane_zero3", "--steps", "4", "--ckpt",
          str(tmp / "resume"), "--ckpt-every", "2"]
    out["uninterrupted"] = run(z3, params=weights())[0]
    dist.barrier()
    if lead:
        shutil.rmtree(tmp / "resume" / "step_4")
    dist.barrier()
    out["resumed"] = run(z3, params=weights())[0]
    out["completed"] = run(z3, params=weights())[0]
    out["resume_steps"] = committed_steps(tmp / "resume")

    def rewrite(src, name, run_cfg, layout, comm):
        (params, opt), _ = steps.restore_lane_train_state(
            str(src), run_cfg, layout, comm, device="cpu")
        tree = steps.state_to_host(run_cfg, layout, params, opt, comm)
        if lead:
            save_checkpoint(str(tmp / name), 2, tree, layout)
        dist.barrier()
        return tmp / name

    world = mesh.new_lane_topology(2, 2)
    half = mesh.new_lane_topology(2, 1, replicas=2)
    template = weights()
    z1 = RunConfig(model=cfg, gradsync="lane_zero1")
    src = rewrite(tmp / "lane_zero3", "chain_zero1_p2", z1,
                  steps.zero1_checkpoint_layout(template, 2),
                  LaneComm(half))
    src = rewrite(src, "chain_replicated_p1", RunConfig(model=cfg),
                  REPLICATED, None)
    rewrite(src, "chain_zero3_p4",
            RunConfig(model=cfg, gradsync="lane_zero3"),
            steps.zero3_checkpoint_layout(cfg, 2, 2), LaneComm(world))
    rewrite(src, "chain_zero1_p4", z1,
            steps.zero1_checkpoint_layout(template, 2), LaneComm(world))
    return out


def _hooked_loader(hook):
    """Make ``launch.train``'s loader call ``hook(step)`` before each
    batch (this process only)."""
    import repro_torch.launch.train as T
    real = T.make_loader

    class Hooked:
        def __init__(self, inner):
            self.inner = inner

        def batch_slice(self, step, row0, rows):
            hook(step)
            return self.inner.batch_slice(step, row0, rows)

    T.make_loader = lambda *a, **kw: Hooked(real(*a, **kw))


def emergency_rank(tmp, case, argv):
    """A spawned rank: ``launch.train.run`` with ``argv`` and ``--ckpt
    tmp`` under an injected fault at step 2: ``"sigterm"`` (the process
    sends itself SIGTERM; on a world of several ranks only rank 1 does),
    ``"crash"`` (the loader raises), ``"writer"`` (SIGTERM, and the
    checkpoint writer fails).  Returns (the exception's text or None,
    committed steps, whether the SIGTERM handler was restored, the
    losses, stdout, stderr)."""
    import torch.distributed as dist
    import io
    import contextlib
    import signal
    import repro_torch.checkpoint.store as store
    from repro_torch.checkpoint import committed_steps
    from repro_torch.launch.train import run

    def hook(step):
        if step == 2:
            if case == "crash":
                raise RuntimeError("injected data failure")
            if dist.get_world_size() == 1 or dist.get_rank() == 1:
                os.kill(os.getpid(), signal.SIGTERM)

    if case == "writer":
        def boom(*a, **kw):
            raise RuntimeError("disk full")
        store.save_checkpoint = boom
    _hooked_loader(hook)
    before = signal.getsignal(signal.SIGTERM)
    err, losses = None, None
    buf_out, buf_err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(buf_out), \
                contextlib.redirect_stderr(buf_err):
            losses = run([*argv, "--ckpt", str(tmp)])[0]
    except RuntimeError as e:
        err = str(e)
    return (err, committed_steps(tmp), signal.getsignal(signal.SIGTERM)
            is before, losses, buf_out.getvalue(), buf_err.getvalue())


# ---------------------------------------------------------------------------
# lane_zero3 serving (tests/test_torch_serve_zero3.py)
# ---------------------------------------------------------------------------

SERVE_MAX_SEQ = 96


def _serve_tokens(params, cfg, kind, *, slots, hosting="replicated",
                  topo=None, sampler=None, **kw):
    from repro_torch.serve import ContinuousBatcher, make_scenario
    reqs = make_scenario(cfg, kind=kind, n=6, seed=1,
                         max_seq=SERVE_MAX_SEQ)
    eng = ContinuousBatcher(params, cfg, slots=slots, max_seq=SERVE_MAX_SEQ,
                            sampler=sampler, hosting=hosting, topo=topo,
                            device="cpu", **kw)
    done, stats = eng.run(reqs)
    return {r.rid: list(r.out) for r in done}, stats, eng


def serve_zero3_rank(npz_by_arch, cases, samplers, tmp):
    """On a 4-rank world (2 x 2): for each ``(name, arch, kind, prefetch,
    kv)`` of ``cases``, the tokens of replicated hosting (4 slots) and of
    ``lane_zero3`` (8 slots) from the ``repro``-layout weights in
    ``npz_by_arch[arch]``; for each sampler (temperature, top_p, seed)
    replicated at 2 slots against lane_zero3 at 8; llama3.2-3b served
    from the checkpoints of a 2-step ``--gradsync`` native / lane_zero1 /
    lane_zero3 run (``load_serve_params``); ``kv_splice`` native against
    lane on random leaves; the layer gathers of one prefill and one
    decode; and the errors of the hybrid family and of slots % p.
    Returns a dict of those results."""
    import torch.distributed as dist
    from repro_torch.bridge import params_from_repro
    from repro_torch.comm import LaneComm
    from repro_torch.configs import resolve
    from repro_torch.launch import mesh
    from repro_torch.launch.train import run
    from repro_torch.serve import SamplerConfig, build_serve_step
    from repro_torch.serve import load_serve_params
    topo = mesh.new_lane_topology(2, 2)
    cfgs = {a: resolve(a, smoke=True) for a in npz_by_arch}
    weights = {a: params_from_repro(load_tree(p), cfgs[a], device="cpu")
               for a, p in npz_by_arch.items()}
    out = {"tokens": {}, "sampled": {}, "ckpt": {}}
    for name, arch, kind, prefetch, kv in cases:
        cfg, params = cfgs[arch], weights[arch]
        rep, _, _ = _serve_tokens(params, cfg, kind, slots=4)
        z3, stats, eng = _serve_tokens(params, cfg, kind, slots=8,
                                       hosting="lane_zero3", topo=topo,
                                       prefetch_blocks=prefetch,
                                       kv_strategy=kv)
        out["tokens"][name] = (rep, z3, stats["hosting"],
                               eng.step.collectives)
    llama = "llama3.2-3b"
    for t, top_p, seed in samplers:
        s = SamplerConfig(temperature=t, top_p=top_p, seed=seed)
        rep, _, _ = _serve_tokens(weights[llama], cfgs[llama], "short_chat",
                                  slots=2, sampler=s)
        z3, _, _ = _serve_tokens(weights[llama], cfgs[llama], "short_chat",
                                 slots=8, sampler=s, hosting="lane_zero3",
                                 topo=topo)
        out["sampled"][t] = (rep, z3)
    for gs in ("native", "lane_zero1", "lane_zero3"):
        ck = str(pathlib.Path(tmp) / gs)
        run(["--arch", llama, "--smoke", "--batch", "8", "--seq", "32",
             "--steps", "2", "--ckpt", ck, "--ckpt-every", "2", "--gradsync",
             gs, "--pods", "2", "--device", "cpu"],
            params=params_from_repro(load_tree(npz_by_arch[llama]),
                                     cfgs[llama], device="cpu"))
        params, step = load_serve_params(ck, cfgs[llama], device="cpu")
        rep, _, _ = _serve_tokens(params, cfgs[llama], "short_chat", slots=2)
        z3, _, _ = _serve_tokens(params, cfgs[llama], "short_chat", slots=8,
                                 hosting="lane_zero3", topo=topo)
        out["ckpt"][gs] = (step, rep, z3, _manifest_kind(ck))
    # kv_splice: native and lane into every global slot, bf16 and int32
    comm = LaneComm(topo)
    g = topo.global_rank()
    rng = np.random.default_rng(5)
    big0 = torch.from_numpy(rng.normal(size=(3, 2, 5, 3)).astype(np.float32))
    splices = {}
    for dt in (torch.bfloat16, torch.int32):
        for slot in range(8):
            small = torch.from_numpy(rng.normal(size=(3, 1, 5, 3)).astype(
                np.float32) * 100).to(dt)
            if topo.lane_rank() != 0:    # the root node's copy counts
                small = small + 1
            res = {}
            for kv in ("native", "lane"):
                big = (big0 * 100).to(dt)
                comm.kv_splice(big, small=small, slot=slot, batch_axis=1,
                               strategy=kv)
                res[kv] = _numpy(big.float() if dt == torch.bfloat16
                                 else big)
            splices[str(dt), slot] = (res, _numpy(
                small.float() if dt == torch.bfloat16 else small))
    out["splice"] = splices
    # one prefill and one decode: L layer gathers each
    cfg = cfgs[llama]
    step = build_serve_step(cfg, max_seq=32, slots=8, hosting="lane_zero3",
                            topo=topo, device="cpu")
    hosted = step.prepare(weights[llama])
    state = step.init_state()
    _, st1 = step.prefill(hosted, np.ones((1, 8), np.int64), 8)
    after_prefill = step.gathers()
    step.splice(state, st1, 5)
    logits, state = step.decode(hosted, np.ones((8, 1), np.int64), state)
    out["gathers"] = (cfg.num_layers, after_prefill, step.gathers(),
                      tuple(logits.shape))
    errors = {}
    for name, kw in (("hybrid", dict(cfg=resolve("zamba2-7b", smoke=True),
                                     slots=8)),
                     ("slots", dict(cfg=cfg, slots=6))):
        try:
            build_serve_step(max_seq=32, hosting="lane_zero3", topo=topo,
                             device="cpu", **kw)
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    dist.barrier()
    return out


def _manifest_kind(ck):
    import json
    from repro_torch.checkpoint import latest_step
    d = pathlib.Path(ck) / f"step_{latest_step(ck)}"
    return json.loads((d / "manifest.json").read_text())["layout"]["kind"]


def serve_gathers_rank(arch):
    """One rank (1 x 1 topology): the layer gathers of one lane_zero3
    prefill and one decode, and the tokens against replicated hosting."""
    from repro_torch.configs import resolve
    from repro_torch.launch import mesh
    from repro_torch.models import init_model
    from repro_torch.serve import build_serve_step
    topo = mesh.new_lane_topology(1, 1)
    cfg = resolve(arch, smoke=True)
    params = init_model(cfg, seed=0, device="cpu")
    step = build_serve_step(cfg, max_seq=32, slots=2, hosting="lane_zero3",
                            topo=topo, device="cpu")
    hosted = step.prepare(params)
    state = step.init_state()
    _, st1 = step.prefill(hosted, np.ones((1, 8), np.int64), 8)
    n1 = step.gathers()
    step.splice(state, st1, 1)
    step.decode(hosted, np.ones((2, 1), np.int64), state)
    rep, _, _ = _serve_tokens(params, cfg, "mixed", slots=2)
    z3, _, _ = _serve_tokens(params, cfg, "mixed", slots=2,
                             hosting="lane_zero3", topo=topo)
    return cfg.num_layers, n1, step.gathers(), rep, z3


# ---------------------------------------------------------------------------
# the quorum collectives and the recovery ladder
# (tests/test_torch_faults_driver.py)
# ---------------------------------------------------------------------------

def quorum_rank(in_path):
    """On a 2 x 2 topology, this rank's ``x``, ``loss`` and ``tree/<leaf>``
    entries of ``in_path`` (stacked by global rank) under every mask of
    ``grid.QUORUM_MASKS``: ``quorum_stage`` on ``x`` in this rank's stripe
    of a bucket, ``quorum_mean`` of ``loss`` and the ``lane_quorum`` grad
    sync (3 buckets) of the tree; and the ``lane`` sync of the tree.
    Returns {"<mask>/stage" | "<mask>/mean" | "<mask>/tree/<leaf>" |
    "lane/tree/<leaf>": array}."""
    from repro_torch.comm import CommConfig, LaneComm
    from repro_torch.launch.mesh import new_lane_topology
    from repro_torch.runtime import quorum_mean, quorum_stage
    topo = new_lane_topology(2, 2)
    comm = LaneComm(topo, CommConfig(buckets=3))
    g = topo.global_rank()
    with np.load(in_path) as z:
        x = torch.from_numpy(z["x"][g])
        loss = torch.tensor(z["loss"][g])
        tree = {k.split("/", 1)[1]: z[k][g] for k in z.files
                if k.startswith("tree/")}
    out = {}
    runs = [(m, "".join(map(str, m))) for m in grid.QUORUM_MASKS]
    for mask, key in [*runs, (None, "lane")]:
        t = {k: torch.tensor(v) for k, v in tree.items()}
        if mask is None:
            synced = comm.grad_sync(t, strategy="lane")
        else:
            c = float(mask[topo.lane_rank()])
            bucket = torch.zeros(topo.n() * x.numel())
            s = x.numel()
            i = topo.node_rank()
            bucket[i * s:(i + 1) * s] = x
            quorum_stage(topo, c)(bucket)()
            out[f"{key}/stage"] = bucket[i * s:(i + 1) * s].numpy()
            out[f"{key}/mean"] = quorum_mean(loss, topo, c).numpy()
            synced = comm.grad_sync(t, strategy="lane_quorum",
                                    contributing=c)
        assert synced is t
        for leaf, v in synced.items():
            out[f"{key}/tree/{leaf}"] = v.numpy()
    return out


def _duplicated_pod0_loader(batch):
    """Make ``launch.train``'s loader hand every rank of pod 1 the rows of
    its counterpart in pod 0 (global rows [row0 - batch/2, ...)), this
    process only; returns the function that undoes it."""
    import repro_torch.launch.train as T
    real = T.make_loader

    class Duped:
        def __init__(self, inner):
            self.inner = inner

        def batch_slice(self, step, row0, rows):
            return self.inner.batch_slice(step, row0 % (batch // 2), rows)

    T.make_loader = lambda *a, **kw: Duped(real(*a, **kw))
    return lambda: setattr(T, "make_loader", real)


def faults_rank(tmp, npz, base, cases):
    """On a 4-rank world (2 pods x 2), ``launch.train.run`` once per
    ``(name, argv, mode)`` of ``cases``, with ``base`` argv first and
    ``{ckpt}`` in argv standing for ``<tmp>/<name>``.  Modes (a
    ``+``-joined set): ``repro_weights`` starts from the ``repro``-layout
    weights in ``npz`` (``save_tree``; else from ``--seed``);
    ``dup_pod0`` feeds pod 1 pod 0's rows (``_duplicated_pod0_loader``);
    ``copy=<src>/<step>`` first copies ``<tmp>/<src>`` into the run's
    directory without its step ``<step>`` (on world rank 0, between
    barriers).  Each run's stdout is captured, and a ``ValueError`` it
    raises is its result.  Returns {name: {"losses", "digest", "error",
    "out", "events" (the health transitions as (step, old, new)),
    "saves" (the steps this rank committed), "restarts"}}."""
    import contextlib
    import io
    import shutil
    import torch.distributed as dist
    from repro_torch.bridge import params_from_repro
    from repro_torch.configs import resolve
    from repro_torch.launch.train import params_digest, run
    tmp = pathlib.Path(tmp)
    out = {}
    for name, argv, mode in cases:
        modes = dict(m.partition("=")[::2] for m in mode.split("+") if m)
        argv = [a.format(ckpt=str(tmp / name)) for a in [*base, *argv]]
        arch = argv[argv.index("--arch") + 1]
        if "copy" in modes:
            src, step = modes["copy"].split("/")
            if dist.get_rank() == 0:
                shutil.copytree(tmp / src, tmp / name)
                shutil.rmtree(tmp / name / f"step_{step}")
            dist.barrier()
        params = params_from_repro(load_tree(npz), resolve(arch, smoke=True),
                                   device="cpu") \
            if "repro_weights" in modes else None
        undo = _duplicated_pod0_loader(
            int(argv[argv.index("--batch") + 1])) \
            if "dup_pod0" in modes else None
        buf, stats = io.StringIO(), {}
        res = {"losses": None, "digest": None, "error": None}
        try:
            with contextlib.redirect_stdout(buf):
                losses, p, _ = run(argv, params=params, stats=stats)
            res.update(losses=losses,
                       digest=None if p is None else params_digest(p))
        except ValueError as e:
            res["error"] = str(e)
        finally:
            if undo is not None:
                undo()
        res["out"] = buf.getvalue()
        res["events"] = [(e.step, e.old, e.new)
                         for e in stats.get("events", [])]
        res["saves"] = [r["step"] for r in stats.get("saves", [])]
        res["restarts"] = stats.get("restarts")
        out[name] = res
    return out


def tuning_rank(npz, planted, tuned_path, argv):
    """On a 4-rank world (2 pods x 2), in turn:

      * ``tuning.probe_cells`` at ``SMOKE_LADDER`` on the 2 x 2 topology:
        this rank's ``to_doc()``;
      * ``argv`` with ``--gradsync auto --tuning-cache planted`` from the
        ``repro``-layout weights in ``npz``: losses, the recorded
        selections ``[(strategy, source, payload bytes), ...]`` and the
        parameters' digest;
      * ``argv`` with ``--gradsync <the strategy selected>``: losses and
        digest;
      * ``argv`` with ``--gradsync auto --tuning-cache`` the planted file
        on rank 0 and a file that does not exist on the others: losses,
        selections and digest (the cache is the lead's, so every rank
        dispatches on the planted table);
      * ``argv`` with ``--gradsync auto --tune --tuning-cache
        tuned_path``: losses, selections and digest, and the cache as this
        rank reads it after the run.

    Returns a dict of those, the constants the planted run priced with
    (``stats["hw"]``), and ``get_hw()`` before and after the runs (equal:
    ``run`` restores the constants a cache installed)."""
    import torch.distributed as dist
    from repro_torch.bridge import params_from_repro
    from repro_torch.configs import resolve
    from repro_torch.core.costmodel import get_hw
    from repro_torch.launch.mesh import new_lane_topology
    from repro_torch.launch.train import params_digest, run
    from repro_torch.tuning import SMOKE_LADDER, load_timing_table, \
        probe_cells
    topo = new_lane_topology(2, 2)
    hw = get_hw()
    doc = probe_cells(topo, device="cpu", ladder=SMOKE_LADDER, reps=2,
                      warmup=1, verbose=False).to_doc()
    arch = argv[argv.index("--arch") + 1]
    cfg = resolve(arch, smoke="--smoke" in argv)

    stats = {}

    def train(extra):
        stats.clear()
        losses, params, _ = run(
            argv + extra, params=params_from_repro(load_tree(npz), cfg,
                                                   device="cpu"),
            stats=stats)
        sels = [(s.strategy, s.source, s.payload_bytes)
                for s in stats["selections"]]
        return losses, sels, params_digest(params)

    auto = train(["--gradsync", "auto", "--tuning-cache", planted])
    priced = stats["hw"]
    fixed = train(["--gradsync", auto[1][-1][0]])
    rank = dist.get_rank()
    lead_only = train(["--gradsync", "auto", "--tuning-cache",
                       planted if rank == 0 else
                       f"{tuned_path}.absent{rank}"])
    tuned = train(["--gradsync", "auto", "--tune", "--tuning-cache",
                   tuned_path])
    return {"probe": doc, "auto": auto, "fixed": fixed,
            "lead_only": lead_only, "tuned": tuned,
            "tuned_cache": load_timing_table(tuned_path).to_doc(),
            "priced": priced, "hw": (hw, get_hw())}


def parallel_rank():
    """On an 8-rank world, the third axis's cases of ``grid`` (this rank's
    results; ``_repro_lane_side.py parallel`` gives ``repro``'s):

      * ``route/<topo>/<case>``: every ``moe_route`` cell on each
        conformance topology, ``route_error/<topo>`` the indivisible
        case's exception type name;
      * ``tp<tp>/<fn>/<y|dx|dw_*>``: ``mlp_tp`` / ``mlp_tp_reduce`` on
        the model group of a (2, 8/(2·tp)) x tp world (this rank's
        zero-padded weight gradients, unsummed), and ``tp<tp>/mlp/...``
        the plain ``mlp`` on the same inputs;
      * ``ep<blocks>/<y|aux|dx|drouter|dw_*>``: ``moe_block_ep`` on a
        (pod 2 x data 2) topology (two replicas of it in the world) with
        this rank's rows of ``grid.ep_inputs``, and ``gather/...`` the
        port's ``moe_block`` on the same rows."""
    from repro_torch.comm import LaneComm
    from repro_torch.configs import resolve
    from repro_torch.launch.mesh import new_lane_topology
    from repro_torch.models.layers import mlp, mlp_tp, mlp_tp_reduce
    from repro_torch.models.moe import moe_block, moe_block_ep
    out = {}
    for key in grid.MOE_ROUTE_TOPOS:
        n, N = grid.TOPOS[key]
        topo = new_lane_topology(n, N)
        comm, g = LaneComm(topo), topo.global_rank()
        for k, case in enumerate(grid.moe_route_cases(key)):
            xs = grid.payload(case, n, N, grid.seed_of(key, k))
            y = comm.moe_route(torch.from_numpy(xs[g]).to(DT[case["dtype"]]),
                               strategy=case["strategy"])
            out[f"route/{key}/{case['name']}"] = _numpy(y)
        for tk, coll, rows in grid.MOE_ROUTE_ERRORS:
            if tk == key:
                try:
                    comm.moe_route(torch.zeros((rows, 2)), strategy="lane")
                    out[f"route_error/{key}"] = None
                except Exception as e:  # noqa: BLE001 - the type is the result
                    out[f"route_error/{key}"] = type(e).__name__

    def grads(fn, named, cot):
        leaves = [t.clone().requires_grad_(True) for t in named.values()]
        y = fn(*leaves)
        ys = y if isinstance(y, tuple) else (y,)
        gs = torch.autograd.grad(ys, leaves, cot)
        return [t.detach() for t in ys] + [t.detach() for t in gs]

    cfg = resolve("llama3.2-3b", smoke=True)
    inp = {k: torch.from_numpy(v) for k, v in
           grid.tp_inputs(cfg.d_model, cfg.d_ff).items()}
    names = ("y", "dx", "dw_up", "dw_gate", "dw_down")
    named = {k: inp[k] for k in ("x", "w_up", "w_gate", "w_down")}
    for tp in grid.TP_DEGREES:
        topo = new_lane_topology(2, 8 // (2 * tp), replicas=tp)
        comm = LaneComm(topo.model)
        for label, fn in (("mlp_tp", mlp_tp), ("mlp_tp_reduce",
                                                mlp_tp_reduce),
                          ("mlp", None)):
            def call(x, a, b, c, fn=fn):
                p = {"w_up": a, "w_gate": b, "w_down": c}
                return mlp(p, x, cfg) if fn is None else \
                    fn(p, x, cfg, comm=comm)
            res = grads(call, named, (inp["dy"],))
            for key, v in zip(names, res):
                out[f"tp{tp}/{label}/{key}"] = v.numpy()
    cfg = resolve("dbrx-132b", smoke=True)
    e = {k: torch.from_numpy(v) for k, v in
         grid.ep_inputs(cfg.d_model, cfg.d_ff, cfg.num_experts).items()}
    topo = new_lane_topology(*grid.EP_TOPO, replicas=2)
    comm, g = LaneComm(topo), topo.global_rank()
    named = {"x": e["x"][g], "router": e["router"], "w_up": e["w_up"],
             "w_gate": e["w_gate"], "w_down": e["w_down"]}
    cot = (e["dy"][g], torch.tensor(grid.EP_AUX_COT))
    keys = ("y", "aux", "dx", "drouter", "dw_up", "dw_gate", "dw_down")
    for label, blocks in [*((f"ep{b}", b) for b in grid.EP_BLOCKS),
                          ("gather", 0)]:
        def call(x, r, a, b, c, blocks=blocks):
            p = {"router": r, "w_up": a, "w_gate": b, "w_down": c}
            return moe_block(p, x, cfg) if blocks == 0 else \
                moe_block_ep(p, x, cfg, comm=comm, ep_blocks=blocks)
        for key, v in zip(keys, grads(call, named, cot)):
            out[f"{label}/{key}"] = v.numpy()
    return out


def tp_ep_train_rank(tmp, npz_by_arch, runs, serve_argv):
    """On an 8-rank world, for each ``(name, argv, action)`` of ``runs``
    in turn: ``launch.train.run(argv)`` from the ``repro``-layout
    weights of its arch (``npz_by_arch``), with ``{tmp}`` in ``argv``
    replaced by ``tmp``; ``action`` (or None), done on rank 0 between a
    barrier before the run and one after it, is ``("copy", src, dst,
    drop)``: copy the checkpoint directory ``src`` to ``dst`` without its
    step ``drop``.  Then the tokens of ``serve_argv`` = ``(arch, kind,
    slots)`` under replicated hosting and under ``lane_zero3`` on a
    (2 x 2) x 2 topology at model_parallel 1 and 2.  Returns ({name:
    (losses, params digest)}, {hosting label: tokens})."""
    import shutil
    import torch.distributed as dist
    from repro_torch.bridge import params_from_repro
    from repro_torch.configs import resolve
    from repro_torch.launch.mesh import new_lane_topology
    from repro_torch.launch.train import params_digest, run
    out = {}
    for name, argv, action in runs:
        argv = [a.replace("{tmp}", tmp) for a in argv]
        if action is not None:
            dist.barrier()
            if dist.get_rank() == 0:
                _, src, dst, drop = action
                src, dst = (pathlib.Path(a.replace("{tmp}", tmp))
                            for a in (src, dst))
                shutil.copytree(src, dst)
                shutil.rmtree(dst / f"step_{drop}")
            dist.barrier()
        arch = argv[argv.index("--arch") + 1]
        params = params_from_repro(load_tree(npz_by_arch[arch]),
                                   resolve(arch, smoke=True), device="cpu")
        losses, params, _ = run(argv, params=params)
        out[name] = (losses, params_digest(params))
    arch, kind, slots = serve_argv
    cfg = resolve(arch, smoke=True)
    params = params_from_repro(load_tree(npz_by_arch[arch]), cfg,
                               device="cpu")
    topo = new_lane_topology(2, 2, replicas=2)
    tokens = {"replicated": _serve_tokens(params, cfg, kind,
                                          slots=slots)[0]}
    for tp in (1, 2):
        tokens[f"lane_zero3 tp{tp}"] = _serve_tokens(
            params, cfg, kind, slots=2 * slots, hosting="lane_zero3",
            topo=topo, model_parallel=tp)[0]
    return out, tokens


def lint_cells_rank(n, N):
    """lanelint's cell sweep of the (n, N) topology on this rank, its live
    negative controls, and the recorder's restore after an exception:
    ({target: footprint}, {control: footprint}, restored)."""
    import torch.distributed as dist

    from repro_torch.analysis import record_collectives
    from repro_torch.analysis.rules import (CellCase, LOCAL_ELEMS,
                                            iter_cell_cases, run_cell)
    from repro_torch.core import collectives as C
    from repro_torch.launch.mesh import new_lane_topology
    topo = new_lane_topology(n, N)
    cells = {case.target: run_cell(topo, case)
             for case in iter_cell_cases(((n, N),))}

    def whole_world(comm, x):
        return C.native_allreduce(x, comm.topo)

    def serial_blocks(comm, x, *, num_blocks):
        return torch.cat([C.allreduce_lane(b, comm.topo)
                          for b in x.chunk(num_blocks)])

    c = LOCAL_ELEMS * 4
    controls = {
        "whole_world": run_cell(topo, CellCase("allreduce", "lane", n, N, c),
                                whole_world),
        "serial": run_cell(topo, CellCase(
            "allreduce", "lane_pipelined", n, N, c, (("num_blocks", 4),)),
            serial_blocks)}
    names = ("all_reduce", "batch_isend_irecv", "P2POp", "isend", "barrier")
    before = {k: getattr(dist, k) for k in names}
    try:
        with record_collectives():
            dist.all_reduce(torch.ones(4), group=topo.group)
            raise KeyError("inside the recorder")
    except KeyError:
        pass
    restored = all(getattr(dist, k) is before[k] for k in names)
    return cells, controls, restored



def train_smoke_rank(root):
    """``launch.train_smoke``'s sweep on this world (checkpoints under
    ``root``/sweep); then, for one cell per layout with the same argv, an
    uninterrupted 3-step run (committing steps 2 and 3), its step 3
    removed, and the run again, which resumes at step 2 (the learning
    rate follows ``--steps``, so the sweep's 2-step run is another
    schedule): ``(failed cells, {cell: the sweep's resumed step-3
    loss}, {cell: (uninterrupted, resumed) step-3 losses})``."""
    import shutil
    import torch.distributed as dist
    from repro_torch.launch import train, train_smoke
    fails, resumed = train_smoke.sweep(os.path.join(root, "sweep"))
    again = {}
    for name, strategy in (("lane", "lane"), ("lane_zero1", "lane_zero1"),
                           ("lane_zero3[dense]", "lane_zero3")):
        ck = os.path.join(root, "again", name)
        argv = [*train_smoke.cell_argv(strategy, train_smoke.DENSE_ARCH, ck,
                                       "cpu"), "--steps", "3"]
        straight = train.run(argv)[0]
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(os.path.join(ck, "step_3"))
        dist.barrier()
        again[name] = (straight[2], train.run(argv)[0])
    return fails, resumed, again


def planned_steps_rank(cases):
    """One recorded train step of llama3.2-3b --smoke per case
    ``(gradsync, tp, batch, seq, remat, microbatch)`` on this world (2
    pods): per case this rank's ops ``(kind, level, payload bytes, result
    bytes, wire bytes)`` read with the node size n·tp (the model axis
    innermost, inside the node), its ``(n, N)`` and its stripe index."""
    from repro_torch.analysis import record_collectives
    from repro_torch.comm import CommConfig, LaneComm
    from repro_torch.configs import RunConfig, resolve
    from repro_torch.launch import mesh
    from repro_torch.launch.steps import (build_train_step,
                                          init_lane_train_state)
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig
    import torch.distributed as dist
    cfg = resolve("llama3.2-3b", smoke=True)
    out = []
    for gradsync, tp, batch, seq, remat, mb in cases:
        topo, single = mesh.make_lane_topology(batch, 2, tp)
        run = RunConfig(model=cfg, gradsync=gradsync, model_parallel=tp,
                        remat=remat, microbatch=mb)
        comm = LaneComm(topo, CommConfig.from_run(run))
        step = build_train_step(run, AdamWConfig(), comm, single=single)
        params, opt, _ = init_lane_train_state(
            run, init_model(cfg, seed=0, device="cpu"), comm,
            single=single, device="cpu")
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, seq + 1)).astype(np.int64))
        rows = batch // topo.p()
        r0 = topo.global_rank() * rows
        with torch.enable_grad(), record_collectives() as rec:
            step(params, opt, toks[r0:r0 + rows, :-1],
                 toks[r0:r0 + rows, 1:])
        foot = rec.footprint(n=topo.n() * tp,
                             num_devices=dist.get_world_size() // tp)
        out.append(([(o.kind, o.level, o.payload_bytes, o.result_bytes,
                      o.wire_bytes) for o in foot.ops], topo.sizes(),
                    topo.node_rank() * topo.N() + topo.lane_rank()))
    return out
