"""``repro``'s side of the port's multi-rank tests, run in a subprocess
whose own environment sets ``XLA_FLAGS=--xla_force_host_platform_device_
count=<devices>`` (the test process never sets it).

  python tests/_repro_lane_side.py collectives OUT.npz   # 8 devices
  python tests/_repro_lane_side.py zero OUT.npz          # 8 devices
  python tests/_repro_lane_side.py gradsync IN.npz OUT.npz   # 4 devices
  python tests/_repro_lane_side.py gradsync_tree IN.npz OUT.npz  # 4
  python tests/_repro_lane_side.py train OUT.json ARGV...    # 4 devices
  python tests/_repro_lane_side.py ckpt OUTDIR GS,GS ARGV...  # 4 devices
  python tests/_repro_lane_side.py quorum IN.npz OUT.npz     # 4 devices
  python tests/_repro_lane_side.py faults CASES.json OUT.json  # 4 devices
  python tests/_repro_lane_side.py tuning OUT.json CACHE ARGV...  # 4

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
"""
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


if __name__ == "__main__":
    cmd, *rest = sys.argv[1:]
    if cmd == "collectives":
        collectives(*rest)
    elif cmd == "zero":
        collectives(*rest, cases_of=grid.zero_cases, call=_zero_call)
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
