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
