"""The process world and its node/lane groups: counterpart of ``repro``'s
mesh construction (``repro.launch.train.make_mesh_auto`` /
``_resolve_pods`` and ``repro.launch.mesh``).

``repro`` lays its devices out as a mesh ``(pod, data, model)``; the batch
is sharded over ``(pod, data)`` and the ``model`` axis replicates it.  The
port lays its processes out the same way, world rank
``(pod·d + data)·m + model``, and turns the batch axes into a
:class:`~repro_torch.core.lane.LaneTopology`: with pods > 1 the node
level is ``data`` (n = d) and the lane level ``pod`` (N = pods); with one
pod the topology is ``repro``'s single-batch-axis one, n = 1 and the lane
level ``data``.  Each ``model`` index gets its own copy of the groups.

  * :func:`init_world` starts the default process group: ``nccl`` for a
    CUDA device, ``gloo`` for the CPU — chosen by the device asked for,
    never as a fallback.  Rank and world size come from ``torchrun``'s
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` or from the arguments.
  * :func:`mesh_shape` is ``make_mesh_auto``'s rule, with its messages
    (``tp`` pins the model axis).
  * :func:`new_lane_topology` makes every node group and every lane group
    on every process, in one order (``dist.new_subgroups_by_enumeration``;
    NCCL hangs otherwise) and returns this process's topology; with
    ``lanes`` it makes the survivors' topology after an elastic shrink
    (``runtime.elastic``), on the survivors alone.  Each process's model
    group (its tensor-parallel peers) comes with it, as ``topology.model``.
  * :func:`spawn` runs a function on a world of local processes (gloo on
    the CPU), for tests and the CPU rehearsal of multi-rank training.
  * :func:`make_production_mesh` and :func:`make_debug_mesh` are
    ``repro.launch.mesh``'s meshes as pure descriptors (:class:`MeshSpec`:
    axis names and shape, no process group), with :func:`batch_axes`,
    :func:`mesh_sizes` and :func:`lane_sizes`, the ``(n, N, tp)`` of the
    topology :func:`make_lane_topology` would build on such a mesh (the
    dry-run planner, ``launch.dryrun``, reads them).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pathlib
import tempfile

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.core.lane import LaneTopology

__all__ = ["init_world", "world_size", "mesh_shape", "mesh_axes",
           "resolve_pods", "new_lane_topology", "make_lane_topology",
           "spawn", "MeshSpec", "make_production_mesh", "make_debug_mesh",
           "batch_axes", "mesh_sizes", "lane_sizes"]

_TIMEOUT = datetime.timedelta(seconds=300)


def world_size() -> int:
    """Processes in the default group, 1 when there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def init_world(device="cuda", *, rank=None, world_size=None,
               init_method=None) -> torch.device:
    """Start the default process group for ``device`` (if it is not
    started yet) and return the device this process uses: ``cuda:<local
    rank>`` for CUDA, else ``device``.

    ``rank`` / ``world_size`` default to ``RANK`` / ``WORLD_SIZE`` from
    the environment (``torchrun``), ``init_method`` to ``env://``.  A CUDA
    device needs NCCL and raises without it.
    """
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError(f"device {str(dev)!r} needs the NCCL backend, "
                           f"which this torch build lacks")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the process group runs {dist.get_backend()!r}, device "
                f"{str(dev)!r} needs {backend!r}")
    else:
        rank = int(os.environ.get("RANK", 0)) if rank is None else rank
        world = int(os.environ.get("WORLD_SIZE", 1)) \
            if world_size is None else world_size
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK",
                                       rank % torch.cuda.device_count()))
            dev = torch.device("cuda", local)
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world,
                                timeout=_TIMEOUT)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_pods(pods: int, gradsync: str = "native",
                 n: "int | None" = None) -> int:
    """0 = auto, ``repro``'s rule: ``lane_zero3`` needs distinct lane and
    node levels, so it gets 2 pods when the ``n`` processes (default: the
    world) number 4 or more and are even; everything else gets one."""
    if pods:
        return pods
    n = world_size() if n is None else n
    if gradsync == "lane_zero3" and n >= 4 and n % 2 == 0:
        return 2
    return 1


def mesh_shape(n: int, batch: int = 1 << 30, pods: int = 1, tp: int = 1):
    """``(pods, d, m)`` for ``n`` processes, ``repro``'s ``make_mesh_auto``
    rule and its error messages: ``tp > 1`` pins the model axis m to tp
    and the data axis takes the rest, d = n / (pods·tp); otherwise d is
    the widest data axis that still divides ``batch``."""
    pods = max(pods, 1)
    tp = max(tp, 1)
    if n % pods:
        raise ValueError(f"{n} devices not divisible into {pods} pods")
    if pods > 1 and batch % pods:
        raise ValueError(
            f"global batch {batch} not divisible by the {pods}-pod lane "
            f"axis; pick a batch divisible by --pods")
    per = n // pods
    if tp > 1:
        if per % tp:
            raise ValueError(
                f"{per} devices per pod not divisible by "
                f"--model-parallel {tp}")
        d = per // tp
        if batch % max(pods * d, 1):
            raise ValueError(
                f"global batch {batch} not divisible by the {pods}×{d} "
                f"batch grid that --model-parallel {tp} leaves on "
                f"{n} devices; pick a divisible batch (or change "
                f"--pods/--model-parallel)")
        return pods, d, tp
    d = 1
    while d * 2 <= per and per % (d * 2) == 0 \
            and batch % (pods * d * 2) == 0:
        d *= 2
    return pods, d, per // d


def new_lane_topology(n: int, N: int, *, replicas: int = 1,
                      lanes=None) -> "LaneTopology | None":
    """This process's topology in a world of ``n·N·replicas`` processes,
    world rank ``(lane_rank·n + node_rank)·replicas + replica``.  Every
    process must call it, with the same arguments: it creates every node
    group, then every lane group, then (replicas > 1) every whole
    communicator, then every model group (the ``replicas`` processes of
    one (lane, node) place) and, for replicas > 1, every process's group
    of its own, each process taking part in all of them.  The topology's
    ``model`` is this process's model topology: n = 1, N = replicas, the
    model group its lane group and its communicator, global rank the
    replica (the tensor-parallel rank).  No group is ever destroyed.

    ``lanes``: the survivor case, a topology over a subset of the world.
    Lane rank j is then the original outer slice ``lanes[j]`` (of any
    larger world), world rank ``(lanes[j]·n + node_rank)·replicas +
    replica``, so survivors keep their world ranks; returns None on a
    process outside it.  Only the survivors take part in the groups'
    creation (``use_local_synchronization``), so processes that left at
    an earlier restart need not call it; every survivor creates the same
    groups in the same order."""
    p = n * N
    if lanes is None:
        if world_size() != p * replicas:
            raise ValueError(f"world of {world_size()} processes, topology "
                             f"{n}x{N}x{replicas} needs {p * replicas}")
        lanes = range(N)
        local = False
    else:
        lanes = list(lanes)
        if len(lanes) != N or \
                (max(lanes) + 1) * n * replicas > world_size():
            raise ValueError(f"lanes {lanes} of {n}x{N}x{replicas} do not "
                             f"fit a world of {world_size()} processes")
        local = True
    w = lambda j, i, k: (lanes[j] * n + i) * replicas + k
    node_sets = [[w(j, i, k) for i in range(n)]
                 for j in range(N) for k in range(replicas)]
    lane_sets = [[w(j, i, k) for j in range(N)]
                 for i in range(n) for k in range(replicas)]
    whole_sets = [[w(j, i, r) for j in range(N) for i in range(n)]
                  for r in range(replicas)]
    model_sets = [[w(j, i, k) for k in range(replicas)]
                  for j in range(N) for i in range(n)]
    me = dist.get_rank()
    if local:
        mine = [s for s in node_sets if me in s]
        if not mine:
            return None
        node_group, lane_group, group, model_group = (
            dist.new_group(next(s for s in sets if me in s),
                           use_local_synchronization=True)
            for sets in (node_sets, lane_sets, whole_sets, model_sets))
        own_group = model_group if replicas == 1 else \
            dist.new_group([me], use_local_synchronization=True)
    else:
        node_group, _ = dist.new_subgroups_by_enumeration(node_sets)
        lane_group, _ = dist.new_subgroups_by_enumeration(lane_sets)
        if replicas > 1:
            group, _ = dist.new_subgroups_by_enumeration(whole_sets)
        else:
            group = dist.group.WORLD
        model_group, _ = dist.new_subgroups_by_enumeration(model_sets)
        own_group = model_group if replicas == 1 else \
            dist.new_subgroups_by_enumeration(
                [[r] for r in range(world_size())])[0]
    k = me % replicas
    g = next(q for q, r in enumerate(whole_sets[k]) if r == me)
    j, i = divmod(g, n)
    model = LaneTopology(
        1, replicas, lane_rank=k, node_rank=0, node_group=own_group,
        lane_group=model_group, group=model_group, node_ranks=[me],
        lane_ranks=model_sets[g], ranks=model_sets[g])
    return LaneTopology(
        n, N, lane_rank=j, node_rank=i, node_group=node_group,
        lane_group=lane_group, group=group,
        node_ranks=[w(j, q, k) for q in range(n)],
        lane_ranks=[w(q, i, k) for q in range(N)], ranks=whole_sets[k],
        model=model)


def mesh_axes(P: int, d: int, m: int):
    """``(axis names, shape)`` of ``repro``'s mesh for ``mesh_shape``'s
    ``(P, d, m)``: ``("pod", "data", "model")`` with pods, else
    ``("data", "model")``; the world rank is the mesh's flat index."""
    if P > 1:
        return ("pod", "data", "model"), (P, d, m)
    return ("data", "model"), (d, m)


def make_lane_topology(batch: int = 1 << 30, pods: int = 1, tp: int = 1):
    """(topology, single) for the started world: ``mesh_shape``'s layout,
    node level ``data`` and lane level ``pod`` when pods > 1; with one pod
    ``single`` is True and the topology is n = 1, N = d, as ``repro``'s
    single-batch-axis mesh.  The model axis (m, tp when tp > 1) makes the
    replicas, and ``topology.model`` the tensor-parallel group."""
    P, d, m = mesh_shape(world_size(), batch, pods, tp)
    if P > 1:
        return new_lane_topology(d, P, replicas=m), False
    return new_lane_topology(1, d, replicas=m), True


# ---------------------------------------------------------------------------
# mesh descriptors: repro's production and debug meshes, no process group
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh as names and sizes: ``axis_names`` and ``shape``, the world
    rank its flat (row-major) index, as ``mesh_axes`` lays it out."""
    axis_names: tuple
    shape: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """``repro``'s production mesh: 16 x 16 ranks a pod, ``("data",
    "model")``; the multi-pod mesh adds the outer ``"pod"`` axis (2, 16,
    16).  Axis roles: ``pod`` the lane level, ``data`` the batch within a
    pod (the node level), ``model`` tensor parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshSpec(axes, shape)


def make_debug_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The small mesh with the same axis names: (2, 4), or (2, 2, 2)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshSpec(axes, shape)


def batch_axes(mesh: MeshSpec) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def mesh_sizes(mesh: MeshSpec) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def lane_sizes(mesh: MeshSpec, *, gradsync: str = "auto",
               tp: "int | None" = None):
    """``(n, N, tp)`` of the topology :func:`make_lane_topology` builds on
    ``mesh``'s world: ``tp`` (default the model axis) pins the model
    axis, the pods are the mesh's pod axis or, without one,
    :func:`resolve_pods`'s answer for ``gradsync`` (``lane_zero3`` splits
    a pod-less data axis into 2 lanes, as ``launch.train`` does with
    ``--pods 0``); one pod gives ``repro``'s single-batch-axis topology,
    n = 1 and N = d."""
    sizes = mesh_sizes(mesh)
    tp = sizes.get("model", 1) if tp is None else tp
    pods = sizes.get("pod", 0)
    world = mesh.size
    if not pods:
        pods = resolve_pods(0, gradsync, world // tp)
    P, d, m = mesh_shape(world, pods=pods, tp=tp)
    return (d, P, m) if P > 1 else (1, d, m)


# ---------------------------------------------------------------------------
# local worlds: one process per rank on this host
# ---------------------------------------------------------------------------

def _spawned(rank, world, init_file, device, fn, args, queue):
    torch.set_num_threads(1)
    try:
        init_world(device, rank=rank, world_size=world,
                   init_method=pathlib.Path(init_file).as_uri())
        out = fn(*args)
        dist.barrier()
        queue.put((rank, out, None))
    except BaseException as e:  # noqa: BLE001 - reported to the parent
        queue.put((rank, None, f"{type(e).__name__}: {e}"))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, *args, device="cpu", timeout: float = 600.0):
    """Run ``fn(*args)`` on ``nprocs`` new local processes that form one
    world (``init_world(device)``, file rendezvous in a fresh temporary
    directory) and return their results by rank.  ``fn`` must be
    importable by module and name, and so must its results be picklable.
    Each process uses one CPU thread.  Raises if any rank fails or the
    world does not finish within ``timeout`` seconds; every process is
    stopped before it returns."""
    import multiprocessing as mp
    import queue as queue_mod
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_spawned, daemon=True,
                             args=(r, nprocs, init_file, device, fn, args, q))
                 for r in range(nprocs)]
        for pr in procs:
            pr.start()
        results, errors = {}, {}
        try:
            while len(results) + len(errors) < nprocs:
                try:
                    rank, out, err = q.get(timeout=timeout)
                except queue_mod.Empty:
                    raise RuntimeError(
                        f"world of {nprocs} did not finish within "
                        f"{timeout} s") from None
                (errors if err else results)[rank] = err or out
                if errors:
                    break
        finally:
            for pr in procs:
                pr.join(timeout=0 if errors else 30)
                if pr.is_alive():
                    pr.terminate()
                    pr.join()
    if errors:
        raise RuntimeError(f"rank(s) failed: {errors}")
    return [results[r] for r in range(nprocs)]
