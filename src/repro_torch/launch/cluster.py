"""Multi-host launch: per-host torchrun plans for H100 nodes.

Counterpart of ``repro.launch.cluster``.  An H100 host carries 8 GPUs
(``GPUS_PER_HOST``), so ``repro``'s 2-pod production mesh of 512 ranks
(``launch.mesh.make_production_mesh(multi_pod=True)``) is 64 hosts, 32 a
pod, and one pod is 256 GPUs.  Every host runs the same entry point under
``torchrun``, which starts 8 processes and hands each its ``RANK``,
``LOCAL_RANK`` and ``WORLD_SIZE``; ``launch.mesh.init_world`` then joins
the job's process group at ``MASTER_ADDR:MASTER_PORT`` and lays the world
out as ``repro``'s mesh.  Nothing in the model or step code is host-aware
but the data loader, which takes ``(host_index, num_hosts)`` from this
plan's ``REPRO_*`` variables.

``plan_cluster()`` and everything else here but
:func:`maybe_initialize_distributed` is pure: it emits the per-host
environment and argv, the renumbering after a pod loss (which hosts
survive and the world they rebuild, ``runtime.elastic``), and the two
launch artifacts, a plain ssh script and a JobSet manifest whose
containers ask for 8 GPUs each.  On preemption every host receives
SIGTERM, ``launch.train``'s emergency checkpoint fires, and the restarted
JobSet resumes from the newest committed step (the data pipeline is
keyed by (seed, step), so no sample is skipped or repeated).

  PYTHONPATH=src python -c "from repro_torch.launch.cluster import *; \\
      print(render_ssh_script(plan_cluster(num_pods=2, hosts_per_pod=2)))"
"""
from __future__ import annotations

import dataclasses
import json
import os
import shlex
from typing import Sequence

__all__ = ["GPUS_PER_HOST", "HostPlan", "plan_cluster", "surviving_plans",
           "render_ssh_script", "render_jobset",
           "maybe_initialize_distributed"]

GPUS_PER_HOST = 8


@dataclasses.dataclass(frozen=True)
class HostPlan:
    host_index: int      # torchrun's --node-rank
    pod_index: int
    env: dict
    argv: tuple


def _torchrun(module: str, extra_args: Sequence[str], *, nnodes: int,
              node_rank: int, master: str, port: str) -> tuple:
    return ("torchrun", "--nnodes", str(nnodes), "--nproc-per-node",
            str(GPUS_PER_HOST), "--node-rank", str(node_rank),
            "--master-addr", master, "--master-port", port, "-m", module,
            *extra_args)


def _host_env(env: dict, rank: int, total: int) -> dict:
    env = dict(env)
    env.update(NNODES=str(total), NODE_RANK=str(rank),
               REPRO_HOST_INDEX=str(rank), REPRO_NUM_HOSTS=str(total))
    return env


def plan_cluster(*, num_pods: int = 2, hosts_per_pod: int = 32,
                 coordinator: str = "pod0-host0:29500",
                 module: str = "repro_torch.launch.train",
                 extra_args: Sequence[str] = ()) -> list:
    """One :class:`HostPlan` per host.  Hosts are numbered pod-major, so
    the world rank ``node_rank·8 + local_rank`` runs over the pod axis
    slowest, as the mesh's row-major order does."""
    total = num_pods * hosts_per_pod
    master, _, port = coordinator.rpartition(":")
    plans = []
    for pod in range(num_pods):
        for h in range(hosts_per_pod):
            rank = pod * hosts_per_pod + h
            env = _host_env({"MASTER_ADDR": master, "MASTER_PORT": port,
                             "REPRO_POD_INDEX": str(pod)}, rank, total)
            argv = _torchrun(module, extra_args, nnodes=total,
                             node_rank=rank, master=master, port=port)
            plans.append(HostPlan(rank, pod, env, argv))
    return plans


def _replace_flag(argv: tuple, flag: str, value: str) -> tuple:
    i = argv.index(flag)
    return (*argv[:i + 1], value, *argv[i + 2:])


def surviving_plans(plans: list, lost_pods: Sequence[int]) -> list:
    """Elastic shrink after a pod loss: the survivors renumbered so the
    smaller world has consecutive node ranks (pairs with
    ``runtime.plan_elastic_mesh`` for the ranks' side)."""
    lost = set(lost_pods)
    keep = [p for p in plans if p.pod_index not in lost]
    out = []
    for rank, p in enumerate(keep):
        argv = _replace_flag(p.argv, "--nnodes", str(len(keep)))
        argv = _replace_flag(argv, "--node-rank", str(rank))
        out.append(HostPlan(rank, p.pod_index,
                            _host_env(p.env, rank, len(keep)), argv))
    return out


def render_ssh_script(plans: list, hostname_fmt: str =
                      "pod{pod}-host{host}") -> str:
    """A plain ssh fan-out (small clusters, bring-up)."""
    per_pod = sum(1 for p in plans if p.pod_index == plans[0].pod_index)
    lines = ["#!/usr/bin/env bash", "set -euo pipefail", ""]
    for p in plans:
        host = hostname_fmt.format(pod=p.pod_index,
                                   host=p.host_index % per_pod)
        envs = " ".join(f"{k}={shlex.quote(v)}" for k, v in p.env.items())
        cmd = " ".join(shlex.quote(a) for a in p.argv)
        lines.append(f"ssh {host} {shlex.quote(f'{envs} {cmd}')} &")
    lines += ["", "wait"]
    return "\n".join(lines) + "\n"


def render_jobset(plans: list, *, image: str,
                  name: str = "lanecoll-train") -> str:
    """A JobSet manifest: one replicated job per pod, one 8-GPU pod of
    Kubernetes per host; ``failurePolicy`` recreates the whole set on any
    host's failure (10 times at most) and ``launch.train`` resumes from
    the newest committed checkpoint; the 120 s grace period is the
    SIGTERM checkpoint's window.  Each container's ``NODE_RANK`` comes
    from the job's completion index plus its pod's offset (the indexed
    Job's annotation), so one template serves every host."""
    num_pods = max(p.pod_index for p in plans) + 1
    hosts = sum(1 for p in plans if p.pod_index == 0)
    argv = list(plans[0].argv)
    argv[argv.index("--node-rank") + 1] = "$NODE_RANK"
    cmd = ["bash", "-c",
           f"export NODE_RANK=$((JOB_INDEX * {hosts} + "
           f"JOB_COMPLETION_INDEX)) REPRO_POD_INDEX=$JOB_INDEX; "
           f"export REPRO_HOST_INDEX=$NODE_RANK; exec " + " ".join(
               a if a == "$NODE_RANK" else shlex.quote(a) for a in argv)]
    env = [{"name": k, "value": v} for k, v in plans[0].env.items()
           if k not in ("NODE_RANK", "REPRO_HOST_INDEX", "REPRO_POD_INDEX")]
    env += [
        {"name": "JOB_INDEX", "valueFrom": {"fieldRef": {"fieldPath":
            "metadata.annotations['jobset.sigs.k8s.io/job-index']"}}},
        {"name": "JOB_COMPLETION_INDEX", "valueFrom": {"fieldRef": {
            "fieldPath": "metadata.annotations"
                         "['batch.kubernetes.io/job-completion-index']"}}},
    ]
    manifest = {
        "apiVersion": "jobset.x-k8s.io/v1alpha2",
        "kind": "JobSet",
        "metadata": {"name": name},
        "spec": {
            "failurePolicy": {"maxRestarts": 10},
            "replicatedJobs": [{
                "name": "pod",
                "replicas": num_pods,
                "template": {"spec": {
                    "parallelism": hosts, "completions": hosts,
                    "completionMode": "Indexed",
                    "backoffLimit": 0,
                    "template": {"spec": {
                        "terminationGracePeriodSeconds": 120,  # SIGTERM ckpt
                        "restartPolicy": "Never",
                        "containers": [{
                            "name": "worker", "image": image,
                            "command": cmd, "env": env,
                            "resources": {"limits": {
                                "nvidia.com/gpu": GPUS_PER_HOST}},
                        }],
                    }},
                }},
            }],
        },
    }
    return json.dumps(manifest, indent=1)


def maybe_initialize_distributed(device="cuda") -> dict:
    """Join the job's process group from torchrun's environment
    (``launch.mesh.init_world``); a no-op on one host with no torchrun.
    Returns whether it did and this host's place in the plan."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return {"distributed": False, "host_index": 0, "num_hosts": 1}
    from repro_torch.launch import mesh
    mesh.init_world(device)
    return {"distributed": True,
            "host_index": int(os.environ.get(
                "REPRO_HOST_INDEX", os.environ.get("NODE_RANK", 0))),
            "num_hosts": int(os.environ.get(
                "REPRO_NUM_HOSTS", os.environ.get("NNODES", 1)))}
