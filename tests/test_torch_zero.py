"""The port's ZeRO cells and shard layouts against ``repro``'s, on the CPU.

* ``repro``'s five conformance topologies (t2, t3, het, n1, N1) run as
  8-rank gloo worlds, one spawn per topology; the ``lane_zero1`` /
  ``lane_zero3`` grad syncs, the ``prefetch_allgather`` cells (pipelined
  and blocking) and ``optim.gradsync``'s ``zero1_param_shard`` /
  ``zero1_unshard`` / ``zero3_param_shard`` / ``zero3_unshard``
  (``_collective_grid.zero_cases``: f32, bf16 and int32, integer-valued,
  so every sum is exact) equal ``repro``'s LaneComm and functions bit for
  bit (``repro``'s side in a subprocess with 8 host devices), and the
  layouts written out in numpy: ZeRO-1 bucket-major (K, n, s) at
  node_rank, ZeRO-3 (B, n·N, s) at node_rank·N + lane_rank.
* The registry: the cells resolve, their layouts, ``prefetch_allgather``'s
  default strategy from ``prefetch_blocks``, and ``_resolve_blocks``'
  strict-explicit / shrink-on-auto rule equal to ``repro``'s.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.comm import CommConfig as JCommConfig
from repro.comm import LaneComm as JLaneComm
from repro.comm import impls as jimpls
from repro.core import LaneTopology as JLaneTopology
from repro.core import costmodel as jcm
from repro_torch.comm import CommConfig, LaneComm, get_impl
from repro_torch.comm import impls as timpls
from repro_torch.core import costmodel as tcm
from repro_torch.core.lane import LaneTopology
from repro_torch.launch import mesh

import _collective_grid as grid
import _torch_dist_workers as workers
from _torch_dist_workers import REPRO_SIDE, ROOT, repro_env


@pytest.fixture(scope="module")
def repro_outputs(tmp_path_factory):
    """``get() -> {topo/case: stacked per-rank output}`` from ``repro``,
    computed in a subprocess started at setup."""
    path = tmp_path_factory.mktemp("repro_zero") / "out.npz"
    proc = subprocess.Popen(
        [sys.executable, str(REPRO_SIDE), "zero", str(path)],
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
    """``get(topo) -> per-rank outputs`` of an 8-rank gloo world, once per
    topology."""
    made = {}

    def get(key):
        if key not in made:
            made[key] = mesh.spawn(workers.zero_rank, grid.P, key)
        return made[key]
    return get


@pytest.mark.parametrize("topo", list(grid.TOPOS))
def test_zero_cells_match_repro_bit_for_bit(topo, repro_outputs,
                                            port_outputs):
    res = port_outputs(topo)
    want_all = repro_outputs()
    cases = grid.zero_cases(topo)
    assert len(cases) == 30
    for case in cases:
        got = np.stack([res[r][case["name"]] for r in range(grid.P)])
        want = want_all[f"{topo}/{case['name']}"]
        assert got.shape == want.shape, (case["name"], got.shape,
                                         want.shape)
        np.testing.assert_array_equal(got, want, err_msg=case["name"])


def _layout_oracle(case, xs, n, N):
    """Each rank's output of a ZeRO case, from the layouts in numpy;
    global rank g = lane_rank·n + node_rank."""
    p, K = n * N, grid.ZERO_K
    coord = [(g % n, g // n) for g in range(p)]         # (i, j)
    idx = [i * N + j for i, j in coord]
    coll = case["coll"]
    if coll == "grad_sync":
        flat = xs.reshape(p, -1).astype(np.float64)
        ways = n if case["strategy"] == "lane_zero1" else p
        # resolve_num_buckets: K keeps a row per process of each bucket
        K = max(1, min(K, flat.shape[1] // ways))
        flat = np.pad(flat, ((0, 0), (0, (-flat.shape[1]) % (K * ways))))
        total = (flat.sum(0) / p).astype(np.float32).reshape(K, ways, -1)
        pick = [i for i, _ in coord] if ways == n else idx
        return np.stack([total[:, k].reshape(-1) for k in pick])
    if coll == "zero1_param_shard":
        return np.stack([xs[g].reshape(K, n, -1)[:, i].reshape(-1)
                         for g, (i, _) in enumerate(coord)])
    if coll == "zero3_param_shard":
        return np.stack([xs[g].reshape(K, p, -1, 2)[:, idx[g]].reshape(-1, 2)
                         for g in range(p)])
    if coll == "zero1_unshard":
        return np.stack([np.stack([
            xs[j * n + q].reshape(K, -1) for q in range(n)], 1).reshape(-1)
            for _, j in coord])
    # prefetch_allgather, zero3_unshard: block b holds every rank's block
    # b in (node_rank, lane_rank) order
    by_idx = [xs[g] for g in sorted(range(p), key=lambda g: idx[g])]
    full = np.stack([x.reshape(K, -1, *x.shape[1:]) for x in by_idx], 1)
    full = full.reshape(-1, *xs.shape[2:])
    return np.stack([full] * p)


@pytest.mark.parametrize("topo", list(grid.TOPOS))
def test_zero_cells_match_the_layouts(topo, port_outputs):
    res = port_outputs(topo)
    n, N = grid.TOPOS[topo]
    for k, case in enumerate(grid.zero_cases(topo)):
        xs = grid.payload(case, n, N, grid.seed_of(topo, k))
        got = np.stack([res[r][case["name"]] for r in range(grid.P)])
        want = _layout_oracle(case, xs, n, N)
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=case["name"])


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def _topo(n=2, N=2):
    return LaneTopology(n, N, lane_rank=0, node_rank=0, node_group=None,
                        lane_group=None, group=None,
                        node_ranks=list(range(n)),
                        lane_ranks=[q * n for q in range(N)],
                        ranks=list(range(n * N)))


def test_zero_cells_resolve_with_repros_flags():
    for strategy, kind in (("lane_zero1", "zero1"), ("lane_zero3", "zero3")):
        e = get_impl("grad_sync", strategy)
        assert e.auto_ok is False and e.cost is None
        assert CommConfig(strategy=strategy).strategy == strategy
        assert LaneComm(_topo()).param_layout(strategy) == kind
    pipe = get_impl("prefetch_allgather", "lane_pipelined")
    block = get_impl("prefetch_allgather", "blocking")
    assert pipe.auto_ok and pipe.cost is not None
    assert not block.auto_ok and block.probe_eligible
    for ov, want in ((0, "lane_pipelined"), (3, "lane_pipelined"),
                     (-1, "blocking")):
        comm = LaneComm(_topo(), CommConfig(prefetch_blocks=ov))
        assert comm._default_strategy("prefetch_allgather") == want


def test_resolve_blocks_matches_repro():
    """Explicit B passes through (strict); auto takes prefetch_blocks (-1
    -> 1) or the cost model, shrunk to a divisor of the stripe; with
    ``repro``'s constants installed the picks are ``repro``'s."""
    j = jcm.get_hw()
    prev = tcm.set_hw(tcm.HW(
        peak_flops_bf16=j.peak_flops_bf16, hbm_bw=j.hbm_bw, node_bw=j.ici_bw,
        lane_bw=j.dcn_bw, gpus_per_host=j.chips_per_host,
        alpha_node=j.alpha_ici, alpha_lane=j.alpha_dcn))
    try:
        for ov in (0, 1, 3, 5, -1):
            jcomm = JLaneComm(JLaneTopology(("data",), "pod"),
                              JCommConfig(prefetch_blocks=ov))
            tcomm = LaneComm(_topo(), CommConfig(prefetch_blocks=ov))
            for lead in (1, 6, 7, 60, 4096, 1 << 22):
                for nb in (None, 4):
                    assert timpls._resolve_blocks(tcomm, lead, nb) \
                        == jimpls._resolve_blocks(jcomm, lead, nb)
    finally:
        tcm.set_hw(prev)


def test_prefetch_blocks_follows_fsdp_prefetch():
    from repro_torch.configs import RunConfig, resolve
    run = RunConfig(model=resolve("llama3.2-3b", smoke=True),
                    gradsync="lane_zero3", fsdp_prefetch=-1)
    assert CommConfig.from_run(run).prefetch_blocks == -1
    assert get_impl("kv_splice", "lane").strategy == "lane"


@pytest.mark.parametrize("pods,gradsync,n,want", [
    (0, "lane_zero3", 4, 2), (0, "lane_zero3", 8, 2), (0, "lane_zero3", 2, 1),
    (0, "lane_zero3", 6, 2), (0, "lane_zero3", 5, 1), (0, "lane_zero1", 8, 1),
    (0, "native", 8, 1), (4, "lane_zero3", 8, 4)])
def test_resolve_pods_is_repros_auto_rule(pods, gradsync, n, want):
    assert mesh.resolve_pods(pods, gradsync, n) == want
