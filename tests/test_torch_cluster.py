"""``repro_torch.launch.cluster`` (torchrun host plans for 8-GPU H100
hosts) mirroring ``tests/test_cluster.py``, and ``launch.mesh``'s
production and debug mesh descriptors against ``repro``'s shapes.  Exact:
every check is a string, a count or a shape.
"""
import json
import shlex

from repro.launch.cluster import plan_cluster as jplan_cluster
from repro_torch.launch import cluster, mesh
from repro_torch.launch.cluster import (GPUS_PER_HOST, plan_cluster,
                                        render_jobset, render_ssh_script,
                                        surviving_plans)


def test_plan_shape_and_ids():
    plans = plan_cluster(num_pods=2, hosts_per_pod=32)
    assert GPUS_PER_HOST == 8
    assert len(plans) == 64
    assert 32 * GPUS_PER_HOST == 256                 # one pod: 256 GPUs
    assert [p.host_index for p in plans] == list(range(64))
    assert plans[32].pod_index == 1                  # pod-major numbering
    # the same host order as repro's plan for the same pods and hosts
    assert [p.host_index for p in plans] == \
        [p.process_id for p in jplan_cluster(num_pods=2, hosts_per_pod=32)]
    env = plans[37].env
    assert env["NNODES"] == "64" and env["NODE_RANK"] == "37"
    assert env["REPRO_HOST_INDEX"] == "37" and env["REPRO_NUM_HOSTS"] == \
        "64" and env["REPRO_POD_INDEX"] == "1"
    assert env["MASTER_ADDR"] == "pod0-host0" and \
        env["MASTER_PORT"] == "29500"


def test_argv_is_torchrun():
    p = plan_cluster(num_pods=2, hosts_per_pod=4, coordinator="h0:1234",
                     extra_args=("--arch", "llama3.2-3b"))[5]
    assert p.argv == ("torchrun", "--nnodes", "8", "--nproc-per-node", "8",
                      "--node-rank", "5", "--master-addr", "h0",
                      "--master-port", "1234", "-m",
                      "repro_torch.launch.train", "--arch", "llama3.2-3b")


def test_elastic_pod_loss_renumbers():
    plans = plan_cluster(num_pods=2, hosts_per_pod=32)
    left = surviving_plans(plans, lost_pods=[0])
    assert len(left) == 32
    assert [p.host_index for p in left] == list(range(32))
    assert all(p.pod_index == 1 for p in left)
    assert left[0].env["NNODES"] == "32"
    assert left[3].env["NODE_RANK"] == "3"
    a = left[3].argv
    assert a[a.index("--nnodes") + 1] == "32"
    assert a[a.index("--node-rank") + 1] == "3"


def test_renders():
    plans = plan_cluster(num_pods=2, hosts_per_pod=4)
    sh = render_ssh_script(plans)
    assert sh.count("ssh ") == 8 and sh.strip().endswith("wait")
    line = sh.splitlines()[3 + 5]
    assert line.startswith("ssh pod1-host1 ")
    assert "NODE_RANK=5" in shlex.split(line)[2]
    js = json.loads(render_jobset(plans, image="repro:latest"))
    assert js["spec"]["failurePolicy"]["maxRestarts"] == 10
    rj = js["spec"]["replicatedJobs"][0]
    assert rj["replicas"] == 2
    assert rj["template"]["spec"]["parallelism"] == 4
    tpl = rj["template"]["spec"]["template"]["spec"]
    assert tpl["terminationGracePeriodSeconds"] == 120   # SIGTERM ckpt
    c = tpl["containers"][0]
    assert c["resources"]["limits"] == {"nvidia.com/gpu": 8}
    assert "--node-rank $NODE_RANK" in c["command"][-1]
    assert "JOB_INDEX * 4 + JOB_COMPLETION_INDEX" in c["command"][-1]


def test_initialize_is_a_noop_on_one_host(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert cluster.maybe_initialize_distributed() == {
        "distributed": False, "host_index": 0, "num_hosts": 1}


def test_meshes_are_repros_shapes():
    m = mesh.make_production_mesh()
    assert (m.axis_names, m.shape, m.size) == (("data", "model"), (16, 16),
                                               256)
    m = mesh.make_production_mesh(multi_pod=True)
    assert (m.axis_names, m.shape) == (("pod", "data", "model"), (2, 16, 16))
    assert mesh.batch_axes(m) == ("pod", "data")
    assert mesh.mesh_sizes(m) == {"pod": 2, "data": 16, "model": 16}
    assert mesh.make_debug_mesh().shape == (2, 4)
    assert mesh.make_debug_mesh(multi_pod=True).shape == (2, 2, 2)


def test_lane_sizes_follow_make_lane_topology():
    single = mesh.make_production_mesh()
    multi = mesh.make_production_mesh(multi_pod=True)
    assert mesh.lane_sizes(single) == (1, 16, 16)     # one batch axis
    assert mesh.lane_sizes(single, gradsync="lane_zero3") == (8, 2, 16)
    assert mesh.lane_sizes(single, tp=1) == (1, 256, 1)
    assert mesh.lane_sizes(multi) == (16, 2, 16)
    assert mesh.lane_sizes(multi, tp=1) == (256, 2, 1)
    assert mesh.lane_sizes(mesh.make_debug_mesh(multi_pod=True)) == (2, 2, 2)
