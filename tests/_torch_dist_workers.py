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
        state, _ = steps.init_lane_train_state(run, params, comm,
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
