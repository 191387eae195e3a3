"""The port's node/lane collectives against ``repro``'s, on the CPU.

* ``repro_torch.core.ref`` (a copy) equals ``repro.core.ref`` on a seeded
  sweep of shapes and roots.
* ``repro``'s conformance topologies t2 (n2 N4), t3 and het (n4 N2, a
  two-axis node level in ``repro``, one node group in the port), n1 (n1
  N8) and N1 (n8 N1) run as 8-rank gloo worlds, one spawn per topology
  (``repro_torch.launch.mesh.spawn``; the rank function is in
  ``_torch_dist_workers.py``).  Every lane, native and pipelined cell of
  ``_collective_grid`` — f32, bf16 and int32 payloads, odd rows per rank,
  roots other than 0, the unreplicated-root paths — equals ``repro``'s
  LaneComm output on the same seeded numpy inputs bit for bit (the
  payloads are integer-valued, so every sum is exact), and the oracles.
  ``repro``'s side runs once for the module, in a subprocess whose own
  environment gives it 8 host devices (``_repro_lane_side.py``).
* The divisibility preconditions raise ValueError, as in ``repro``.
"""
import subprocess
import sys

import numpy as np
import pytest

from repro.core import ref as jref
from repro_torch.core import ref as tref
from repro_torch.launch import mesh

import _collective_grid as grid
import _torch_dist_workers as workers
from _torch_dist_workers import REPRO_SIDE, ROOT, repro_env


@pytest.fixture(scope="module")
def repro_outputs(tmp_path_factory):
    """``get() -> {topo/case: stacked per-rank output}`` from ``repro``,
    computed in a subprocess started at setup (it runs while the first
    port world does)."""
    path = tmp_path_factory.mktemp("repro_collectives") / "out.npz"
    proc = subprocess.Popen(
        [sys.executable, str(REPRO_SIDE), "collectives", str(path)],
        env=repro_env(8), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    got = {}

    def get():
        if not got:
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, log[-4000:]
            with np.load(path) as z:
                got.update({k: z[k] for k in z.files})
        return got
    yield get
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def port_outputs():
    """``get(topo) -> (per-rank outputs, per-rank error types)`` of an
    8-rank gloo world, run once per topology."""
    made = {}

    def get(key):
        if key not in made:
            made[key] = mesh.spawn(workers.collectives_rank, grid.P, key)
        return made[key]
    return get


# ---------------------------------------------------------------------------
# the oracles
# ---------------------------------------------------------------------------

ORACLES = ["oracle_allreduce", "oracle_reduce_scatter", "oracle_allgather",
           "oracle_bcast", "oracle_alltoall", "oracle_reduce",
           "oracle_gather", "oracle_scatter", "oracle_scan"]


@pytest.mark.parametrize("name", ORACLES)
def test_ref_equals_repro(name):
    """A seeded sweep: p in 1..8, rows a multiple of p, every root."""
    rng = np.random.default_rng(ORACLES.index(name))
    rooted = name in ("oracle_bcast", "oracle_reduce", "oracle_gather",
                      "oracle_scatter")
    for _ in range(25):
        p = int(rng.integers(1, 9))
        rows = p * int(rng.integers(1, 4))
        xs = rng.normal(size=(p, rows, int(rng.integers(1, 4))))
        xs = xs.astype(rng.choice([np.float32, np.float64]))
        kw = {"root": int(rng.integers(0, p))} if rooted else {}
        want = getattr(jref, name)(xs, **kw)
        got = getattr(tref, name)(xs, **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _oracle(case, xs):
    coll, root = case["coll"], case["root"]
    if coll == "pipelined_allgather" or case["kw"].get("reorder") is False:
        return None                  # a layout of its own: repro only
    fn = getattr(tref, f"oracle_{coll}")
    return fn(xs, root=root) if root is not None else fn(xs)


# ---------------------------------------------------------------------------
# the grid on 8-rank gloo worlds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topo", list(grid.TOPOS))
def test_collectives_match_repro_bit_for_bit(topo, repro_outputs,
                                             port_outputs):
    res = port_outputs(topo)
    want_all = repro_outputs()
    cases = grid.cases(topo)
    assert len(cases) > 70
    for case in cases:
        got = np.stack([res[r][0][case["name"]] for r in range(grid.P)])
        want = want_all[f"{topo}/{case['name']}"]
        assert got.shape == want.shape, (case["name"], got.shape,
                                         want.shape)
        np.testing.assert_array_equal(got, want, err_msg=case["name"])


@pytest.mark.parametrize("topo", list(grid.TOPOS))
def test_collectives_match_oracles(topo, port_outputs):
    res = port_outputs(topo)
    n, N = grid.TOPOS[topo]
    for k, case in enumerate(grid.cases(topo)):
        xs = grid.payload(case, n, N, grid.seed_of(topo, k))
        want = _oracle(case, xs)
        if want is None:
            continue
        got = np.stack([res[r][0][case["name"]] for r in range(grid.P)])
        np.testing.assert_array_equal(got, want, err_msg=case["name"])


def test_divisibility_errors_are_value_errors(port_outputs):
    seen = {}
    for key in ("t2", "t3"):
        errors = port_outputs(key)[0][1]
        seen.update({f"{key}/{k}": v for k, v in errors.items()})
    want = {f"{t}/{c}/{r}" for t, c, r in grid.ERRORS}
    assert set(seen) == want
    assert all(v == "ValueError" for v in seen.values()), seen
