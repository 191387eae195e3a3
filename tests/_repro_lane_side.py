"""``repro``'s side of the port's multi-rank tests, run in a subprocess
whose own environment sets ``XLA_FLAGS=--xla_force_host_platform_device_
count=<devices>`` (the test process never sets it).

  python tests/_repro_lane_side.py collectives OUT.npz   # 8 devices
  python tests/_repro_lane_side.py zero OUT.npz          # 8 devices
  python tests/_repro_lane_side.py parallel OUT.npz      # 8 devices
  python tests/_repro_lane_side.py gradsync IN.npz OUT.npz   # 4 devices
  python tests/_repro_lane_side.py gradsync_tree IN.npz OUT.npz  # 4
  python tests/_repro_lane_side.py train OUT.json ARGV...    # 4 devices
  python tests/_repro_lane_side.py runs IN.json OUT.json     # 8 devices
  python tests/_repro_lane_side.py ckpt OUTDIR GS,GS ARGV...  # 4 devices
  python tests/_repro_lane_side.py quorum IN.npz OUT.npz     # 4 devices
  python tests/_repro_lane_side.py faults CASES.json OUT.json  # 4 devices
  python tests/_repro_lane_side.py tuning OUT.json CACHE ARGV...  # 4
  python tests/_repro_lane_side.py plan OUT.json     # 512 devices

``collectives`` runs every case of ``_collective_grid`` through
``repro``'s LaneComm on repro's own conformance meshes, ``zero`` its
ZeRO cases (``zero_cases``); ``gradsync``
runs ``LaneComm.grad_sync`` on a (pod 2 × data 2) mesh over the per-rank
gradient trees in IN.npz, ``gradsync_tree`` the same for nested model
gradient trees; ``train`` runs ``repro.launch.train.main``
with ARGV for each ``--arch`` given and records every step's loss at
full precision (its log lines print 4 decimals); ``ckpt`` runs
``repro.launch.train.main`` with ARGV once per comma-separated
``--gradsync`` value GS, each with ``--ckpt OUTDIR/GS``.  ``quorum`` runs
``repro.runtime.straggler``'s ``quorum_stage`` and ``quorum_mean`` and
``LaneComm.grad_sync(strategy="lane_quorum")`` on a (pod 2 × data 2)
mesh under every 0/1 mask of the 2 pods (``grid.QUORUM_MASKS``); ``faults``
runs ``repro.launch.train.main`` once per named argv of CASES.json and
records each run's losses, stdout and the ``ValueError`` it raised;
``tuning`` runs ``repro.tuning.probe_cells`` on a (pod 2 × data 2) mesh
at ``SMOKE_LADDER`` and records its cells' keys, then
``repro.launch.train.main`` with ARGV and ``--tuning-cache CACHE`` and
records its losses and the auto-dispatch selections its step recorded.
``plan`` imports ``repro.launch.dryrun`` before anything else touches
jax (it sets its own 512-device flag at import) and records
``list_cells`` and, for every cell of both production meshes under both
plans, ``plan``'s fsdp / remat / microbatch / gradsync and the global
shapes and dtypes of ``input_specs``.
"""
if __name__ == "__main__" and __import__("sys").argv[1:2] == ["plan"]:
    import repro.launch.dryrun  # noqa: F401 - first: its XLA flag
import builtins
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import repro  # noqa: E402,F401  (installs the compat shims)
from repro.comm import CommConfig, LaneComm  # noqa: E402
from repro.core import LaneTopology  # noqa: E402
from repro.core.pipeline import pipelined_allgather_lane  # noqa: E402
from repro.testing.conformance_cases import TOPOS as MESHES  # noqa: E402

import _collective_grid as grid  # noqa: E402

DT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int32": jnp.int32}


def _call(comm, topo, case):
    def fn(x):
        if case["coll"] == "pipelined_allgather":
            return pipelined_allgather_lane(x, topo, **case["kw"])
        return getattr(comm, case["coll"])(x, strategy=case["strategy"],
                                           **case["kw"])
    return fn


def _zero_call(comm, topo, case):
    from repro.optim import gradsync as jgs

    def fn(x):
        coll = case["coll"]
        if coll == "grad_sync":
            return comm.grad_sync({"g": x}, strategy=case["strategy"],
                                  **case["kw"])[0]
        if coll == "prefetch_allgather":
            return comm.prefetch_allgather(x, strategy=case["strategy"],
                                           **case["kw"])
        return getattr(jgs, coll)(x, topo, grid.ZERO_K)
    return fn


def collectives(out_path, cases_of=grid.cases, call=_call):
    np.savez(out_path, **_collectives(cases_of, call))


def _collectives(cases_of=grid.cases, call=_call):
    out = {}
    for key in grid.TOPOS:
        shape, names, node_axes, lane = MESHES[key]
        mesh = jax.make_mesh(shape, names)
        topo = LaneTopology(node_axes=node_axes, lane_axis=lane)
        comm = LaneComm(topo, mesh=mesh)
        spec = P((lane, *node_axes))
        sharding = NamedSharding(mesh, spec)
        n, N = grid.TOPOS[key]
        p = n * N
        cases = cases_of(key)
        for dt in grid.DTYPES:
            idx = [k for k, c in enumerate(cases) if c["dtype"] == dt]
            if not idx:
                continue
            xs = [grid.payload(cases[k], n, N, grid.seed_of(key, k))
                  for k in idx]
            fns = [call(comm, topo, cases[k]) for k in idx]
            args = [jax.device_put(jnp.asarray(
                x.reshape(p * x.shape[1], *x.shape[2:]), DT[dt]), sharding)
                for x in xs]
            run = jax.jit(jax.shard_map(
                lambda *a: tuple(f(x) for f, x in zip(fns, a)), mesh=mesh,
                in_specs=tuple(spec for _ in idx),
                out_specs=tuple(spec for _ in idx)))
            for k, x, y in zip(idx, xs, run(*args)):
                y = np.asarray(y)         # ints stay, floats as f32
                y = y if y.dtype == np.int32 else y.astype(np.float32)
                out[f"{key}/{cases[k]['name']}"] = y.reshape(
                    p, y.shape[0] // p, *y.shape[1:])
    return out


def parallel(out_path):
    """The third axis on 8 host devices (``tests/test_torch_parallel.py``):
    every ``moe_route`` cell of ``grid.moe_route_cases`` on its
    conformance mesh (``route/<topo>/<case>``, (p, rows, 2)); ``mlp_tp``
    and ``mlp_tp_reduce`` of ``grid.tp_inputs`` (llama3.2-3b smoke) on a
    (8/tp, tp) ``(data, model)`` mesh, their outputs and each model rank's
    input gradients for the cotangent ``dy`` (``tp<tp>/<fn>/<y|dx|dw_up|
    dw_gate|dw_down>``, (tp, ...)); and ``moe_block_ep`` of
    ``grid.ep_inputs`` (dbrx-132b smoke) on a (pod 2 x data 2 x model 2)
    mesh at each ``grid.EP_BLOCKS``, each batch rank's output, aux loss
    and gradients (``ep<blocks>/<y|aux|dx|drouter|dw_up|dw_gate|
    dw_down>``, (p, ...))."""
    from repro.configs import resolve
    from repro.models.layers import mlp_tp, mlp_tp_reduce
    from repro.models.moe import moe_block_ep
    out = {f"route/{k}": v for k, v in
           _collectives(grid.moe_route_cases).items()}
    cfg = resolve("llama3.2-3b", smoke=True)
    inp = grid.tp_inputs(cfg.d_model, cfg.d_ff)
    names = ("y", "dx", "dw_up", "dw_gate", "dw_down")
    for tp in grid.TP_DEGREES:
        mesh = jax.make_mesh((8 // tp, tp), ("data", "model"))
        comm = LaneComm(LaneTopology(node_axes=(), lane_axis="model"),
                        mesh=mesh)
        for label, fn in (("mlp_tp", mlp_tp), ("mlp_tp_reduce",
                                                mlp_tp_reduce)):
            def body(x, a, b, c, dy, fn=fn, comm=comm):
                y, vjp = jax.vjp(lambda x, a, b, c: fn(
                    {"w_up": a, "w_gate": b, "w_down": c}, x, cfg,
                    comm=comm), x, a, b, c)
                return tuple(t[None] for t in (y, *vjp(dy)))
            res = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=(P(),) * 5,
                out_specs=(P("model"),) * 5, check_vma=False))(
                *[inp[k] for k in ("x", "w_up", "w_gate", "w_down", "dy")])
            for key, v in zip(names, res):
                out[f"tp{tp}/{label}/{key}"] = np.asarray(v)
    cfg = resolve("dbrx-132b", smoke=True)
    e = grid.ep_inputs(cfg.d_model, cfg.d_ff, cfg.num_experts)
    mesh = jax.make_mesh((*grid.EP_TOPO, 2), ("pod", "data", "model"))
    comm = LaneComm(LaneTopology(node_axes=("data",), lane_axis="pod"),
                    mesh=mesh)
    bspec = P(("pod", "data"))
    for blocks in grid.EP_BLOCKS:
        def body(x, dy, router, a, b, c, blocks=blocks):
            (y, aux), vjp = jax.vjp(lambda x, r, a, b, c: moe_block_ep(
                {"router": r, "w_up": a, "w_gate": b, "w_down": c}, x, cfg,
                comm=comm, ep_blocks=blocks), x[0], router, a, b, c)
            gs = vjp((dy[0], jnp.float32(grid.EP_AUX_COT)))
            return tuple(t[None] for t in (y, aux, *gs))
        res = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(bspec, bspec, P(), P(), P(), P()),
            out_specs=(bspec,) * 7, check_vma=False))(
            *[e[k] for k in ("x", "dy", "router", "w_up", "w_gate",
                             "w_down")])
        for key, v in zip(("y", "aux", "dx", "drouter", "dw_up", "dw_gate",
                           "dw_down"), res):
            out[f"ep{blocks}/{key}"] = np.asarray(v)
    np.savez(out_path, **out)


def gradsync(in_path, out_path):
    mesh = jax.make_mesh((2, 2), ("pod", "data"))
    topo = LaneTopology(node_axes=("data",), lane_axis="pod")
    spec = P(("pod", "data"))
    sharding = NamedSharding(mesh, spec)
    out = {}
    with np.load(in_path) as z:
        trees = {}
        for key in z.files:                  # payload/leaf, stacked (p, ...)
            name, leaf = key.split("/")
            trees.setdefault(name, {})[leaf] = z[key]
    for name, tree in trees.items():
        for strategy in ("native", "lane", "lane_pipelined", "lane_int8"):
            comm = LaneComm(topo, CommConfig(buckets=3), mesh=mesh)

            def fn(t, comm=comm, strategy=strategy):
                t = jax.tree.map(lambda a: a[0], t)
                g = comm.grad_sync(t, strategy=strategy)
                return jax.tree.map(lambda a: a[None], g)
            args = jax.tree.map(
                lambda a: jax.device_put(jnp.asarray(a), sharding), tree)
            res = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,),
                                        out_specs=spec))(args)
            for leaf, v in res.items():
                out[f"{name}/{strategy}/{leaf}"] = np.asarray(v)
    np.savez(out_path, **out)


def gradsync_tree(in_path, out_path):
    """``lane`` and ``lane_int8`` grad_sync of nested per-rank gradient
    trees (IN.npz: ``save_tree`` paths, every leaf stacked (4, ...) by
    global rank) on a (pod 2 × data 2) mesh, 3 buckets: OUT.npz holds
    ``strategy/path`` -> (4, ...)."""
    mesh = jax.make_mesh((2, 2), ("pod", "data"))
    topo = LaneTopology(node_axes=("data",), lane_axis="pod")
    spec = P(("pod", "data"))
    sharding = NamedSharding(mesh, spec)
    tree = {}
    with np.load(in_path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    out = {}
    for strategy in ("lane", "lane_int8"):
        comm = LaneComm(topo, CommConfig(buckets=3), mesh=mesh)

        def fn(t, comm=comm, strategy=strategy):
            t = jax.tree.map(lambda a: a[0], t)
            g = comm.grad_sync(t, strategy=strategy)
            return jax.tree.map(lambda a: a[None], g)
        args = jax.tree.map(
            lambda a: jax.device_put(jnp.asarray(a), sharding), tree)
        res = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,),
                                    out_specs=spec))(args)
        for path, v in jax.tree_util.tree_flatten_with_path(res)[0]:
            name = "/".join(k.key for k in path)
            out[f"{strategy}/{name}"] = np.asarray(v)
    np.savez(out_path, **out)


def train(out_path, argv):
    import repro.launch.train as jtrain
    archs = [argv[i + 1] for i, a in enumerate(argv) if a == "--arch"]
    rest = [a for i, a in enumerate(argv)
            if a != "--arch" and (i == 0 or argv[i - 1] != "--arch")]
    losses = {}
    for arch in archs:
        got = []

        def record(x, got=got):     # train.py's only float(): the loss
            got.append(builtins.float(x))
            return got[-1]
        jtrain.float = record
        jtrain.main(["--arch", arch, *rest, "--log-every", "1"])
        losses[arch] = got
    pathlib.Path(out_path).write_text(json.dumps(losses))


def runs(in_path, out_path):
    """IN.json: {name: argv}; ``repro.launch.train.main`` with each argv
    in turn (``--log-every 1`` added), every step's loss recorded at full
    precision: OUT.json {name: losses}."""
    import repro.launch.train as jtrain
    losses = {}
    for name, argv in json.loads(pathlib.Path(in_path).read_text()).items():
        got = []

        def record(x, got=got):     # train.py's only float(): the loss
            got.append(builtins.float(x))
            return got[-1]
        jtrain.float = record
        rc = jtrain.main([*argv, "--log-every", "1"])
        assert rc == 0, (name, rc)
        losses[name] = got
    pathlib.Path(out_path).write_text(json.dumps(losses))


def ckpt(out_dir, strategies, argv):
    import repro.launch.train as jtrain
    for gs in strategies.split(","):
        rc = jtrain.main([*argv, "--gradsync", gs, "--ckpt",
                          str(pathlib.Path(out_dir) / gs)])
        assert rc == 0, (gs, rc)


def quorum(in_path, out_path):
    """IN.npz: ``x`` (4, s), ``loss`` (4,) and ``tree/<leaf>`` (4, ...)
    stacked by global rank.  OUT.npz, per mask ``m`` (e.g. ``10``):
    ``m/stage`` quorum_stage of each rank's ``x``, ``m/mean``
    quorum_mean of its loss, ``m/tree/<leaf>`` the lane_quorum grad sync
    (3 buckets) of its tree, each (4, ...)."""
    from repro.runtime.straggler import quorum_mean, quorum_stage
    mesh = jax.make_mesh((2, 2), ("pod", "data"))
    topo = LaneTopology(node_axes=("data",), lane_axis="pod")
    spec = P(("pod", "data"))
    sharding = NamedSharding(mesh, spec)
    with np.load(in_path) as z:
        x, loss = z["x"], z["loss"]
        tree = {k.split("/", 1)[1]: z[k] for k in z.files
                if k.startswith("tree/")}
    put = lambda a: jax.device_put(jnp.asarray(a), sharding)
    out = {}
    for mask in grid.QUORUM_MASKS:
        m = jnp.asarray(mask, jnp.float32)
        comm = LaneComm(topo, CommConfig(buckets=3), mesh=mesh)

        def fn(x, loss, t, m=m, comm=comm):
            c = m[jax.lax.axis_index("pod")]
            st = quorum_stage("pod", c)(x[0])
            qm = quorum_mean(loss[0], "pod", c)
            g = comm.grad_sync(jax.tree.map(lambda a: a[0], t),
                               strategy="lane_quorum", contributing=c)
            return st[None], qm[None], jax.tree.map(lambda a: a[None], g)
        st, qm, g = jax.jit(jax.shard_map(
            fn, mesh=mesh, in_specs=(spec, spec, spec),
            out_specs=(spec, spec, spec)))(
                put(x), put(loss), jax.tree.map(put, tree))
        key = "".join(map(str, mask))
        out[f"{key}/stage"] = np.asarray(st)
        out[f"{key}/mean"] = np.asarray(qm)
        for leaf, v in g.items():
            out[f"{key}/tree/{leaf}"] = np.asarray(v)
    np.savez(out_path, **out)


def faults(cases_path, out_path):
    """For each ``name: argv`` of CASES.json, ``repro.launch.train.main``
    with ``argv`` (plus ``--log-every 1``): OUT.json maps the name to its
    losses at full precision, its stdout, its return code and the text of
    the ``ValueError`` it raised (or None)."""
    import contextlib
    import io
    import repro.launch.train as jtrain
    out = {}
    for name, argv in json.loads(pathlib.Path(cases_path).read_text()) \
            .items():
        got = []

        def record(x, got=got):     # train.py's only float(): the loss
            got.append(builtins.float(x))
            return got[-1]
        jtrain.float = record
        buf, rc, err = io.StringIO(), None, None
        with contextlib.redirect_stdout(buf):
            try:
                rc = jtrain.main([*argv, "--log-every", "1"])
            except ValueError as e:
                err = str(e)
        out[name] = {"losses": got, "log": buf.getvalue(), "rc": rc,
                     "error": err}
    pathlib.Path(out_path).write_text(json.dumps(out))


def tuning(out_path, cache, argv):
    import repro.launch.train as jtrain
    from repro.tuning import SMOKE_LADDER, probe_cells
    mesh = jax.make_mesh((2, 2), ("pod", "data"))
    topo = LaneTopology(node_axes=("data",), lane_axis="pod")
    table = probe_cells(mesh, topo, ladder=SMOKE_LADDER, reps=1, warmup=0,
                        verbose=False)
    keys = [[e.collective, e.strategy, e.topo_sig, e.bucket]
            for e in table.entries()]
    comms, got = [], []
    build = jtrain.build_train_step_lane

    def capture(*a, **kw):          # the loop's comm, for its selections
        step, comm = build(*a, **kw)
        comms.append(comm)
        return step, comm

    def record(x):                  # train.py's only float(): the loss
        got.append(builtins.float(x))
        return got[-1]
    jtrain.build_train_step_lane = capture
    jtrain.float = record
    rc = jtrain.main([*argv, "--tuning-cache", cache, "--log-every", "1"])
    assert rc == 0, rc
    sels = [[s.strategy, s.source, s.payload_bytes]
            for c in comms for s in c.selections]
    pathlib.Path(out_path).write_text(json.dumps(
        {"keys": keys, "losses": got, "selections": sels}))


def plan(out_path):
    from repro.configs import SHAPES
    from repro.configs import resolve as jresolve
    from repro.launch import dryrun as jdry
    from repro.launch.mesh import make_production_mesh
    out = {"cells": [list(r) for r in jdry.list_cells()], "plans": {}}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch, shape, st in jdry.list_cells():
            if st != "run":
                continue
            cfg = jresolve(arch)
            for plan_name in ("default", "tp0"):
                run = jdry.plan(cfg, SHAPES[shape], mesh,
                                plan_name=plan_name)
                ins = jdry.input_specs(cfg, SHAPES[shape], mesh)
                out["plans"][f"{arch}|{shape}|{int(multi)}|{plan_name}"] = {
                    "fsdp": run.fsdp, "remat": run.remat,
                    "microbatch": run.microbatch, "gradsync": run.gradsync,
                    "inputs": {k: None if v is None else
                               [list(v.shape), str(v.dtype)]
                               for k, v in ins.items()}}
    pathlib.Path(out_path).write_text(json.dumps(out))


if __name__ == "__main__":
    cmd, *rest = sys.argv[1:]
    if cmd == "plan":
        plan(*rest)
    elif cmd == "collectives":
        collectives(*rest)
    elif cmd == "zero":
        collectives(*rest, cases_of=grid.zero_cases, call=_zero_call)
    elif cmd == "parallel":
        parallel(*rest)
    elif cmd == "runs":
        runs(*rest)
    elif cmd == "gradsync_tree":
        gradsync_tree(*rest)
    elif cmd == "gradsync":
        gradsync(*rest)
    elif cmd == "ckpt":
        ckpt(rest[0], rest[1], rest[2:])
    elif cmd == "quorum":
        quorum(*rest)
    elif cmd == "faults":
        faults(*rest)
    elif cmd == "tuning":
        tuning(rest[0], rest[1], rest[2:])
    else:
        train(rest[0], rest[1:])
