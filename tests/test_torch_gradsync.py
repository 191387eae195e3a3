"""The port's gradient sync and cost model against ``repro``'s, on the CPU.

* int8 compress and pack: the wire bytes equal ``repro``'s exactly.
* ``bucket_schedule`` emits (bucket, stage) in ``repro``'s wave order.
* ``resolve_num_buckets``, the §3/§5 closed forms and LaneComm's auto
  ranking equal ``repro``'s under the same constants, passed explicitly
  (the port's defaults are an H100 host's, ``repro``'s a TPU's).
* ``LaneComm.grad_sync`` on a 4-rank gloo world (2 pods × 2) equals
  ``repro``'s on 4 host devices (a subprocess, ``_repro_lane_side.py``):
  exactly for integer-valued gradients, at 1e-6 for random ones, and
  ``lane_int8`` within its half-step bound of the exact mean.
* The cells of later ROADMAP items raise NotImplementedError naming them;
  the ZeRO cells resolve.
"""
import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import LaneComm as JLaneComm
from repro.comm import costs as jcosts
from repro.core import LaneTopology as JLaneTopology
from repro.core import costmodel as jcm
from repro.optim import gradsync as jgs
from repro_torch.comm import CommConfig, LaneComm, get_impl
from repro_torch.comm import costs as tcosts
from repro_torch.comm.registry import UNPORTED
from repro_torch.core import costmodel as tcm
from repro_torch.core.lane import LaneTopology
from repro_torch.launch import mesh
from repro_torch.optim import gradsync as tgs

import _torch_dist_workers as workers
from _torch_dist_workers import REPRO_SIDE, ROOT, repro_env

RAND_TOL = 1e-6
BUCKETS = 3


@pytest.fixture
def repro_hw():
    """Install ``repro``'s active constants, field by field, as the port's
    active HW for one test (xdist workers are processes, so the global is
    not shared), and restore the port's afterwards."""
    j = jcm.get_hw()
    prev = tcm.set_hw(tcm.HW(
        peak_flops_bf16=j.peak_flops_bf16, hbm_bw=j.hbm_bw, node_bw=j.ici_bw,
        lane_bw=j.dcn_bw, gpus_per_host=j.chips_per_host,
        alpha_node=j.alpha_ici, alpha_lane=j.alpha_dcn))
    try:
        yield
    finally:
        tcm.set_hw(prev)


# ---------------------------------------------------------------------------
# int8 bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 5000])
def test_int8_compress_and_pack_bytes_match_repro(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * rng.choice([1e-6, 1.0, 300.0])).astype(
        np.float32)
    if n > 2048:
        x[1024:2048] = 0.0                 # an all-zero chunk: scale 1e-12
    jq, js, jn = jgs.compress_int8(jnp.asarray(x))
    tq, ts, tn = tgs.compress_int8(torch.from_numpy(x))
    assert tn == jn == n
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    jbuf = np.asarray(jgs.pack_int8_payload(jq, js))
    tbuf = tgs.pack_int8_payload(tq, ts)
    assert tbuf.dtype == torch.int8
    assert tbuf.numpy().tobytes() == jbuf.tobytes()
    q2, s2 = tgs.unpack_int8_payload(tbuf, tq.shape[0])
    assert torch.equal(q2, tq) and torch.equal(s2, ts)
    np.testing.assert_array_equal(
        tgs.decompress_int8(tq, ts, tn).numpy(),
        np.asarray(jgs.decompress_int8(jq, js, jn)))


# ---------------------------------------------------------------------------
# bucket schedule, flatten
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,S", [(1, 3), (2, 3), (5, 3), (4, 2), (3, 1)])
def test_bucket_schedule_emits_repros_wave_order(K, S):
    def recording(log, wrap):
        return [lambda v, s=s: (log.append((int(v[0]), s)), wrap(v))[1]
                for s in range(S)]
    flat = np.repeat(np.arange(K, dtype=np.float32), 4)   # bucket id
    jlog, tlog = [], []
    jgs.bucket_schedule(jnp.asarray(flat), K,
                        recording(jlog, lambda v: v))
    tgs.bucket_schedule(torch.from_numpy(flat), K,
                        recording(tlog, lambda v: None))
    assert tlog == jlog and len(tlog) == K * S


def test_flatten_casts_and_unflatten_writes_in_place():
    """``repro``'s flat order: keys sorted, so ``blocks`` comes first."""
    tree = {"w": torch.tensor([[1.5, -2.0]], dtype=torch.bfloat16),
            "blocks": [{"b": torch.arange(3, dtype=torch.float32)}]}
    flat, spec = tgs._flatten_bucket(tree, pad_to=4)
    assert flat.dtype == torch.float32 and flat.shape == (8,)
    assert flat.tolist() == [0.0, 1.0, 2.0, 1.5, -2.0, 0.0, 0.0, 0.0]
    w, b = tree["w"], tree["blocks"][0]["b"]
    out = tgs._unflatten_bucket(flat * 2, spec)
    assert out is tree and tree["w"] is w and tree["blocks"][0]["b"] is b
    assert w.dtype == torch.bfloat16 and w.tolist() == [[3.0, -4.0]]
    assert b.tolist() == [0.0, 2.0, 4.0]


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total,n,override", [
    (3_212_749_824, 1, 0), (3_212_749_824, 8, 0), (10_000, 2, 0),
    (5, 4, 0), (10_000, 2, 7), (123_456_789, 4, 0), (1, 1, 0)])
def test_resolve_num_buckets_matches_repro(total, n, override, repro_hw):
    want = jgs.resolve_num_buckets(total, n, override)
    assert tgs.resolve_num_buckets(total, n, override) == want


def test_costmodel_closed_forms_match_repro():
    for coll in ("bcast", "gather", "scatter", "allgather", "allreduce",
                 "reduce", "reduce_scatter", "alltoall"):
        for n, N in ((1, 8), (2, 4), (4, 2), (8, 1), (8, 16)):
            for c in (1.0, 4096.0, 3.2e9):
                j = jcm.mockup_cost(coll, n, N, c)
                t = tcm.mockup_cost(coll, n, N, c)
                assert dataclasses.astuple(t) == dataclasses.astuple(j)
                kw = dict(k=n, elem_bytes=4, alpha_node=3e-6,
                          beta_node=1 / 7e10, alpha_lane=2.5e-5,
                          beta_lane=1 / 3e10)
                assert tcm.klane_time(t, **kw) == jcm.klane_time(j, **kw)
    for c_bytes in (0.0, 10.0, 1e6, 1.28e10):
        for stages in (2, 3):
            ab = dict(alpha=7e-6, beta=1 / 4e10)
            assert tcm.optimal_num_buckets(c_bytes, stages=stages, **ab) \
                == jcm.optimal_num_buckets(c_bytes, stages=stages, **ab)
            for K in (1, 4, 64):
                assert tcm.bucket_pipeline_time(c_bytes, K, stages=stages,
                                                **ab) \
                    == jcm.bucket_pipeline_time(c_bytes, K, stages=stages,
                                                **ab)


def test_comm_costs_and_auto_ranking_match_repro(repro_hw):
    """Every registered cost function and LaneComm.select, the port's
    with ``repro``'s constants installed as its active ones."""
    from repro.comm import CommConfig as JCommConfig
    for buckets in (0, 5):
        jcfg = JCommConfig(buckets=buckets)
        tcfg = CommConfig(buckets=buckets)
        pairs = [(jcosts.native_cost(c), tcosts.native_cost(c))
                 for c in ("allreduce", "bcast", "alltoall", "gather")]
        pairs += [(jcosts.lane_cost(c), tcosts.lane_cost(c))
                  for c in ("allreduce", "reduce_scatter", "allgather")]
        pairs += [(getattr(jcosts, f), getattr(tcosts, f)) for f in (
            "cost_pipelined_allreduce", "cost_pipelined_allgather",
            "cost_native_scan", "cost_lane_scan", "cost_lane_scatter")]
        for jf, tf in pairs:
            for n, N in ((1, 8), (2, 4), (4, 2), (8, 1)):
                for c in (64.0, 1e6, 1.28e10):
                    assert tf(n, N, c, tcfg) == jf(n, N, c, jcfg)
        jcomm = JLaneComm(JLaneTopology(("data",), "pod"), jcfg)
        tcomm = LaneComm(None, tcfg)
        for coll in ("allreduce", "scan", "bcast", "grad_sync", "scatter"):
            for n, N in ((2, 4), (4, 2), (8, 1)):
                for c in (256, 1 << 20, 1 << 34):
                    assert tcomm.select(coll, c, n=n, N=N, lead=64) \
                        == jcomm.select(coll, c, n=n, N=N, lead=64)


def test_hw_defaults_are_an_h100_hosts():
    hw = tcm.HW()
    assert (hw.peak_flops_bf16, hw.hbm_bw, hw.node_bw, hw.lane_bw,
            hw.gpus_per_host) == (989e12, 3.35e12, 450e9, 50e9, 8)
    j = jcm.HW()
    assert hw.alpha_node != j.alpha_ici and hw.alpha_lane != j.alpha_dcn


# ---------------------------------------------------------------------------
# the cells of later items
# ---------------------------------------------------------------------------

def test_unported_cells_name_their_items():
    """What stays unported names its item (``moe_route``: 10); the ZeRO,
    ``lane_quorum`` and ``kv_splice`` cells resolve."""
    topo = LaneTopology(1, 1, lane_rank=0, node_rank=0, node_group=None,
                        lane_group=None, group=None, node_ranks=[0],
                        lane_ranks=[0], ranks=[0])
    comm = LaneComm(topo)
    entry = get_impl("grad_sync", "lane_quorum")
    assert entry.strategy == "lane_quorum" and not entry.auto_ok
    assert entry.feasible(2, 3, 4) and not entry.feasible(2, 3, 5)
    assert CommConfig(strategy="lane_quorum").strategy == "lane_quorum"
    assert "lane_quorum" not in [s for _, s in UNPORTED]
    for strategy in ("lane_zero1", "lane_zero3"):
        assert get_impl("grad_sync", strategy).strategy == strategy
        assert CommConfig(strategy=strategy).strategy == strategy
    for strategy in ("lane_pipelined", "blocking"):
        assert get_impl("prefetch_allgather", strategy).strategy == strategy
    x = torch.zeros(4)
    for strategy in ("native", "lane"):
        assert get_impl("kv_splice", strategy).strategy == strategy
    with pytest.raises(NotImplementedError, match="item 10"):
        comm.moe_route(x)
    with pytest.raises(ValueError, match="registered strategies"):
        get_impl("allreduce", "lane_zero9")
    for strategy in ("native", "lane", "lane_pipelined", "lane_int8",
                     "lane_quorum", "auto"):
        assert comm.param_layout(strategy) == "replicated"
    assert comm.param_layout("lane_zero1") == "zero1"
    assert comm.param_layout("lane_zero3") == "zero3"
    with pytest.raises(ValueError, match="no param layout"):
        comm.param_layout("lane_zero9")


# ---------------------------------------------------------------------------
# grad_sync on a 4-rank gloo world against repro on 4 host devices
# ---------------------------------------------------------------------------

LEAVES = {"a": (37, 5), "b": (9000,), "c": (3, 3, 7)}   # jax's (sorted) order


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    """(inputs {payload: {leaf: (4, ...)}}, repro's results, the port's
    results by rank), for an integer-valued and a random payload."""
    tmp = tmp_path_factory.mktemp("gradsync")
    rng = np.random.default_rng(0)
    inputs = {
        "ints": {k: rng.integers(-8, 9, size=(4, *s)).astype(np.float32)
                 for k, s in LEAVES.items()},
        "rand": {k: rng.normal(size=(4, *s)).astype(np.float32)
                 for k, s in LEAVES.items()}}
    src = tmp / "in.npz"
    np.savez(src, **{f"{p}/{k}": v for p, t in inputs.items()
                     for k, v in t.items()})
    out = tmp / "repro.npz"
    proc = subprocess.Popen(
        [sys.executable, str(REPRO_SIDE), "gradsync", str(src), str(out)],
        env=repro_env(4), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        port = mesh.spawn(workers.gradsync_rank, 4, str(src), BUCKETS)
        log, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-4000:]
    with np.load(out) as z:
        want = {k: z[k] for k in z.files}
    return inputs, want, port


def _lane_stripes(x, K, n=2, N=2):
    """Per lane j, the node sums of the f32 flat gradient in (K, n, s)
    buckets: what lane j's int8 stage compresses, stripe by stripe."""
    flat = np.concatenate([x[k].reshape(4, -1) for k in LEAVES], axis=1)
    total = flat.shape[1]
    flat = np.pad(flat, ((0, 0), (0, (-total) % (K * n))))
    return [(flat[j * n:(j + 1) * n].sum(0)).reshape(K, n, -1)
            for j in range(N)], total


def _int8_bound(x, K):
    """Σ_j max|chunk_j| / 254 per element, / 4: the half-step bound of
    the int8 lane hop on the mean, as flat elements."""
    stripes, total = _lane_stripes(x, K)
    bound = 0.0
    for st in stripes:
        s = st.shape[-1]
        pad = (-s) % 1024
        ch = np.pad(np.abs(st), ((0, 0), (0, 0), (0, pad)))
        ch = ch.reshape(*st.shape[:2], -1, 1024)
        b = np.broadcast_to(ch.max(-1, keepdims=True) / 254, ch.shape)
        bound = bound + b.reshape(*st.shape[:2], -1)[..., :s]
    return bound.reshape(-1)[:total] / 4


@pytest.mark.parametrize("strategy", ["native", "lane", "lane_pipelined"])
@pytest.mark.parametrize("payload", ["ints", "rand"])
def test_grad_sync_matches_repro(synced, strategy, payload):
    inputs, want, port = synced
    for leaf in LEAVES:
        mean = inputs[payload][leaf].astype(np.float64).mean(0)
        jv = want[f"{payload}/{strategy}/{leaf}"]
        for r in range(4):
            got = port[r][f"{payload}/{strategy}/{leaf}"]
            assert got.shape == mean.shape and got.dtype == np.float32
            if payload == "ints":
                np.testing.assert_array_equal(got, jv[r])
                np.testing.assert_array_equal(got, mean.astype(np.float32))
            else:
                np.testing.assert_allclose(got, jv[r], rtol=RAND_TOL,
                                           atol=RAND_TOL)
            # every rank holds the same bits
            np.testing.assert_array_equal(
                got, port[0][f"{payload}/{strategy}/{leaf}"])


@pytest.mark.parametrize("payload", ["ints", "rand"])
def test_grad_sync_int8_within_half_step_of_the_mean(synced, payload):
    inputs, want, port = synced
    x = inputs[payload]
    bound = _int8_bound(x, BUCKETS)
    got = np.concatenate([port[0][f"{payload}/lane_int8/{k}"].reshape(-1)
                          for k in LEAVES])
    mean = np.concatenate([x[k].astype(np.float64).mean(0).reshape(-1)
                           for k in LEAVES])
    assert (np.abs(got - mean) <= bound * (1 + 1e-5) + 1e-7).all()
    assert np.abs(got - mean).max() > 0            # it did quantize
    for leaf in LEAVES:
        for r in range(4):
            g = port[r][f"{payload}/lane_int8/{leaf}"]
            np.testing.assert_array_equal(
                g, port[0][f"{payload}/lane_int8/{leaf}"])
            np.testing.assert_allclose(
                g, want[f"{payload}/lane_int8/{leaf}"][r], rtol=RAND_TOL,
                atol=RAND_TOL)
