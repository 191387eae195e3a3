"""The port's fault-tolerant runtime (``repro_torch.runtime``) against
``repro.runtime``, in one process on the CPU.

Both packages run on the same inputs and their answers are compared
field for field: the fault plan's grammar and its refusals, seeded plans
for seeds 0-31, the plan's queries after a shrink, the checkpoint
attempt hook, the watchdog's masks, the health ladder's states and
events over 200 seeded random mask histories, and ``plan_elastic_mesh``
on every lost set of two meshes, errors included.  Values pass between
the packages as numpy arrays and Python scalars.  The collectives of
``runtime.straggler`` and the ladder across ranks are held to ``repro``
in ``tests/test_torch_faults_driver.py``.
"""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.runtime import (FaultPlan as JFaultPlan, HealthMonitor as JHealth,
                           Watchdog as JWatchdog, corrupt_leaf_file as
                           jcorrupt, plan_elastic_mesh as jplan)
from repro_torch.runtime import (DEGRADED, HEALTHY, RESTART, FaultPlan,
                                 HealthMonitor, Watchdog, corrupt_leaf_file,
                                 parse_fault_plan, plan_elastic_mesh)

SPECS = [
    "",
    "pod_slow@2-4:pod=1;pod_lost@6:pod=0;ckpt_io@3:count=2;"
    "corrupt_leaf@8:leaf=5",
    " pod_slow@2-4:pod=1; pod_lost@5:pod=0; ckpt_io@6:count=2;"
    " corrupt_leaf@8:leaf=3 ",
    "pod_lost@2:pod=1",
    "pod_slow@0-1:pod=1",
    "ckpt_io@2:count=2;corrupt_leaf@4:leaf=1",
    "pod_slow@3",
    "pod_slow@1-1:pod=2,count=4,leaf=7;;",
]
BAD_SPECS = ["meteor@3", "pod_slow@5-2", "pod_slow@2:mass=1", "pod_slow",
             "pod_lost@x", "ckpt_io@2:count=two"]


def _fields(plan):
    return [dataclasses.astuple(f) for f in plan.faults]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_repro(spec):
    got, want = parse_fault_plan(spec), JFaultPlan.parse(spec)
    assert _fields(got) == _fields(want)
    assert bool(got) == bool(want)
    assert got == FaultPlan.parse(spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_refuses_what_repro_refuses(spec):
    with pytest.raises(ValueError) as want:
        JFaultPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("steps,num_pods,rate", [
    (20, 4, 0.25), (8, 2, 0.5), (100, 8, 1.0), (2, 1, 0.9), (1, 2, 1.0),
    (50, 3, 0.0)])
def test_generate_matches_repro_for_seeds_0_to_31(steps, num_pods, rate):
    for seed in range(32):
        got = FaultPlan.generate(seed, steps, num_pods, rate)
        want = JFaultPlan.generate(seed, steps, num_pods, rate)
        assert _fields(got) == _fields(want), seed


def test_queries_after_a_shrink_match_repro():
    spec = "pod_slow@2-4:pod=1;pod_lost@6:pod=2;pod_lost@3:pod=0;" \
           "ckpt_io@3:count=2;ckpt_io@3:count=1;corrupt_leaf@5:leaf=1"
    got, want = parse_fault_plan(spec), JFaultPlan.parse(spec)
    for step in range(9):
        for pods in (1, 2, 3, 4):
            assert got.pods_down(step, pods) == want.pods_down(step, pods)
            assert got.lost_pods(step, pods) == want.lost_pods(step, pods)
        assert got.ckpt_failures(step) == want.ckpt_failures(step)
        assert got.corrupt_at(step) == want.corrupt_at(step)
    # the pods of a shrunk lane level: entries past it are inert
    assert got.pods_down(7, 4) == (0, 2)
    assert got.pods_down(7, 2) == (0,)
    assert got.lost_pods(7, 1) == (0,)


def test_ckpt_attempt_hook():
    plan = parse_fault_plan("ckpt_io@3:count=2;corrupt_leaf@5:leaf=1")
    assert plan.ckpt_attempt_hook(2) is None
    hook = plan.ckpt_attempt_hook(3)
    for attempt in (0, 1):
        with pytest.raises(OSError, match=f"attempt {attempt + 1}/2"):
            hook(attempt)
    hook(2)                            # the third attempt goes through
    assert plan.corrupt_at(5) == 1 and plan.corrupt_at(4) is None


def test_corrupt_leaf_file_flips_the_last_byte_as_repro(tmp_path):
    for root in ("a", "b"):
        d = tmp_path / root / "step_2"
        d.mkdir(parents=True)
        np.save(d / "arr_0.npy", np.arange(7, dtype=np.float32))
    p = corrupt_leaf_file(str(tmp_path / "a"), 2, 0)
    jcorrupt(str(tmp_path / "b"), 2, 0)
    assert p.read_bytes() == (tmp_path / "b/step_2/arr_0.npy").read_bytes()
    with pytest.raises(FileNotFoundError):
        corrupt_leaf_file(str(tmp_path / "a"), 2, 9)


def test_watchdog_masks_match_repro():
    rng = np.random.default_rng(0)
    for deadline in (0, 1, 2):
        got, want = Watchdog(4, deadline), JWatchdog(4, deadline)
        for step in range(30):
            for pod in range(4):
                if rng.random() < 0.7:
                    s = step - int(rng.integers(0, 3))   # late echoes too
                    got.heartbeat(pod, s)
                    want.heartbeat(pod, s)
            m = got.mask(step)
            assert m.dtype == np.float32
            np.testing.assert_array_equal(m, want.mask(step))
            assert got.live(step) == want.live(step)
            assert got.stale(step) == want.stale(step)
    with pytest.raises(ValueError):
        Watchdog(0)
    with pytest.raises(ValueError):
        Watchdog(2).heartbeat(2, 0)


@pytest.mark.parametrize("can_degrade", [True, False])
def test_health_monitor_matches_repro_on_random_histories(can_degrade):
    """200 seeded random mask histories: the same state after every
    observation, the same restart pods and the same events and lines."""
    for seed in range(200):
        rng = np.random.default_rng(seed)
        pods = int(rng.integers(1, 5))
        k = int(rng.integers(0, 4))
        lines, jlines = [], []
        got = HealthMonitor(pods, k, can_degrade, log=lines.append)
        want = JHealth(pods, k, can_degrade, log=jlines.append)
        for step in range(int(rng.integers(1, 25))):
            mask = (rng.random(pods) > rng.random() * 0.6) \
                .astype(np.float32)
            assert got.observe(step, mask) == want.observe(step, mask)
        assert got.state == want.state
        assert got.restart_pods() == want.restart_pods()
        assert [dataclasses.astuple(e) for e in got.events] == \
            [dataclasses.astuple(e) for e in want.events]
        assert lines == jlines
        assert all(line.startswith("health: step ") for line in lines)
    assert {HEALTHY, DEGRADED, RESTART} == {"HEALTHY", "DEGRADED", "RESTART"}


@pytest.mark.parametrize("names,shape", [
    (("pod", "data", "model"), (2, 2, 2)),
    (("pod", "data", "model"), (4, 2, 1)),
    (("data", "model"), (4, 2)),
    (("model",), (4,)),
])
def test_plan_elastic_mesh_matches_repro_on_every_lost_set(names, shape):
    n = int(np.prod(shape))
    for r in range(n + 1):
        for lost in itertools.combinations(range(n), r):
            try:
                want = jplan(names, shape, lost)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    plan_elastic_mesh(names, shape, lost)
                assert str(got.value) == str(e)
                continue
            got = plan_elastic_mesh(names, shape, lost)
            assert (got.axis_names, got.shape, got.lost,
                    got.global_batch_scale) == \
                (want.axis_names, want.shape, want.lost,
                 want.global_batch_scale), lost
            # the surviving outer slices (axis 0 here), in order
            per = n // shape[0]
            assert got.lanes == (tuple(
                c for c in range(shape[0]) if c not in {i // per
                                                        for i in lost})
                if names != ("model",) else ())
    if "pod" in names:
        with pytest.raises(ValueError,
                           match="all slices of the outer batch axis lost"):
            plan_elastic_mesh(names, shape, range(n))
