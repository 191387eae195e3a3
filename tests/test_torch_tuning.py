"""The port's measured-cost tuning (``repro_torch.tuning`` and
``repro_torch.core.guidelines``) against ``repro``'s, in one process.

The same seeded entries go into both packages' tables; what comes out is
compared exactly (payload buckets, signatures, lookups, measure-once
puts, the cache file's bytes, the least-squares design rows) or at rtol
1e-9 (the fit), and each package loads the other's cache file.  Where a
result depends on the active cost-model constants, both packages run on
equal ones: ``repro``'s defaults, installed in the port's ``set_hw`` for
the test alone (``equal_hw``) — the port's own are an H100's, ``repro``'s
a TPU's.  ``LaneComm.select`` with a planted tuner gives ``repro``'s
ranking and source.  The multi-rank probe and the ``--gradsync auto``
training loop are in ``test_torch_tuning_dist.py``.
"""
import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.comm import CommConfig as JCommConfig, LaneComm as JLaneComm
from repro.core import guidelines as jguide
from repro.core.costmodel import HW as JHW
from repro.core.lane import LaneTopology as JTopology
from repro import tuning as jt
from repro_torch.comm import CommConfig, LaneComm, iter_impls
from repro_torch.comm.costs import native_cost
from repro_torch.core import guidelines
from repro_torch.core.costmodel import HW, get_hw, set_hw
from repro_torch.core.lane import LaneTopology
from repro_torch.launch import train
from repro_torch import tuning as tt

SIGS = ("cpu/cpu/n2xN2", "cpu/cpu/n4xN2", "gpu/NVIDIA_H100_80GB_HBM3/n1xN1")
STRATEGIES = {"grad_sync": ("native", "lane", "lane_pipelined"),
              "allreduce": ("native", "lane", "lane_pipelined"),
              "prefetch_allgather": ("lane_pipelined", "blocking")}
TOPOS = ((1, 1), (4, 1), (1, 2), (4, 2), (2, 4))
FIT_RTOL = 1e-9


@contextlib.contextmanager
def equal_hw():
    """The port's active constants set to ``repro``'s defaults (node =
    ICI, lane = DCN) for the block, and restored after it."""
    j = JHW()
    prev = set_hw(dataclasses.replace(
        HW(), alpha_node=j.alpha_ici, node_bw=j.ici_bw,
        alpha_lane=j.alpha_dcn, lane_bw=j.dcn_bw))
    try:
        yield
    finally:
        set_hw(prev)


def _rows(seed=0, sigs=SIGS, n_payloads=4):
    """Seeded entry tuples: every (collective, strategy) of STRATEGIES at
    ``n_payloads`` payloads per signature, median and min µs drawn."""
    rng = np.random.default_rng(seed)
    rows = []
    for sig in sigs:
        for coll, strategies in STRATEGIES.items():
            for s in strategies:
                payloads = sorted({int(b) for b in
                                   2 ** rng.uniform(10, 24, n_payloads)})
                for b in payloads:
                    med = float(rng.uniform(5, 5000))
                    rows.append((coll, s, sig, b, med,
                                 med * float(rng.uniform(0.5, 1)),
                                 int(rng.integers(1, 9))))
    return rows


def _tables(rows):
    return (tt.TimingTable(tt.TimingEntry(*r) for r in rows),
            jt.TimingTable(jt.TimingEntry(*r) for r in rows))


# ---------------------------------------------------------------------------
# table
# ---------------------------------------------------------------------------

def test_payload_bucket_matches_repro():
    rng = np.random.default_rng(1)
    for b in [0, 1, 2, 3, 4096, 4097,
              *map(int, rng.integers(0, 1 << 40, 200))]:
        assert tt.payload_bucket(b) == jt.payload_bucket(b)


@pytest.mark.parametrize("n,N", TOPOS)
def test_signature_roundtrip_matches_repro(n, N):
    for platform, kind in (("cpu", "cpu"), ("gpu", "NVIDIA H100 80GB HBM3"),
                           ("gpu", "a/b c")):
        sig = tt.topology_signature(n, N, platform=platform,
                                    device_kind=kind)
        assert sig == jt.topology_signature(n, N, platform=platform,
                                            device_kind=kind)
        assert tt.parse_topology_signature(sig) == \
            jt.parse_topology_signature(sig) == (n, N)
    # the lazy default reads the device passed; jax's CPU device gives
    # the same fields
    assert tt.topology_signature(n, N, device="cpu") == \
        jt.topology_signature(n, N)
    assert tt.topology_signature(2, 4, platform="gpu",
                                 device_kind="NVIDIA H100 80GB HBM3") \
        == "gpu/NVIDIA_H100_80GB_HBM3/n2xN4"
    with pytest.raises(ValueError, match="malformed"):
        tt.parse_topology_signature("cpu/host/whatever")


def test_lookup_matches_repro_over_a_payload_grid():
    mine, ref = _tables(_rows(2))
    assert mine.to_doc() == ref.to_doc()
    rng = np.random.default_rng(3)
    queries = sorted({int(b) for b in 2 ** rng.uniform(8, 26, 300)})
    seen = {"hit": 0, "miss": 0}
    for sig in SIGS + ("cpu/cpu/n8xN1",):
        for coll, strategies in STRATEGIES.items():
            for s in strategies + ("lane_int8",):
                for b in queries + [e[3] for e in _rows(2)]:
                    got = mine.lookup_us(coll, s, sig, b)
                    assert got == ref.lookup_us(coll, s, sig, b)
                    seen["miss" if got is None else "hit"] += 1
    assert seen["hit"] > 1000 and seen["miss"] > 1000


def test_measure_once_put_and_merge_match_repro():
    rows = _rows(4)
    mine, ref = tt.TimingTable(), jt.TimingTable()
    rng = np.random.default_rng(5)
    for r in rows + [r[:4] + (r[4] * 2,) + r[5:] for r in rows[::3]]:
        bump = int(rng.integers(0, 2))      # same bucket, another payload
        r = r[:3] + (r[3] + bump,) + r[4:]
        assert mine.put(tt.TimingEntry(*r)) == ref.put(jt.TimingEntry(*r))
    assert mine.to_doc() == ref.to_doc()
    other = _rows(6)
    assert mine.merge(tt.TimingTable(tt.TimingEntry(*r) for r in other)) \
        == ref.merge(jt.TimingTable(jt.TimingEntry(*r) for r in other))
    assert mine.to_doc() == ref.to_doc()
    assert mine.signatures() == ref.signatures()


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_misses", [False, True], ids=["plain",
                                                            "misses"])
def test_cache_bytes_match_repro_and_load_across(tmp_path, with_misses):
    mine, ref = _tables(_rows(7))
    misses = [("grad_sync", "native", 2, 2, 12345),
              ("allreduce", "lane", 4, 2, 64),
              ("grad_sync", "native", 2, 2, 12345)] if with_misses else None
    p = tt.save_timing_table(tmp_path / "port.json", mine, misses=misses)
    q = jt.save_timing_table(tmp_path / "repro.json", ref, misses=misses)
    assert p.read_bytes() == q.read_bytes()
    assert jt.load_timing_table(p).to_doc() == mine.to_doc()
    assert tt.load_timing_table(q).to_doc() == ref.to_doc()
    assert tt.load_misses(q) == jt.load_misses(p) == \
        sorted(dict.fromkeys(misses or ()))
    # save -> load -> save is the same file
    again = tt.save_timing_table(tmp_path / "again.json",
                                 tt.load_timing_table(p),
                                 misses=tt.load_misses(p))
    assert again.read_bytes() == p.read_bytes()


def test_corrupt_or_stale_cache_gives_none_or_misses(tmp_path, capsys):
    mine, _ = _tables(_rows(8, sigs=("cpu/cpu/n2xN2",)))
    path = tt.save_timing_table(tmp_path / "c.json", mine,
                                misses=[("grad_sync", "lane", 2, 2, 99)])
    doc = json.loads(path.read_text())
    doc["payload"]["entries"][0]["median_us"] = 1e9      # rot a field
    path.write_text(json.dumps(doc))
    for pkg in (tt, jt):
        with pytest.raises(pkg.TuningCacheError, match="crc32"):
            pkg.load_timing_table(path)
        assert pkg.load_timing_table_or_none(path) is None
        assert pkg.load_misses(path) == []
        assert pkg.load_timing_table_or_none(tmp_path / "absent") is None
    assert "tuning cache ignored" in capsys.readouterr().out
    path.write_text("{not json")
    assert tt.load_timing_table_or_none(path) is None
    assert tt.load_misses(path) == []
    # a stale signature: None and a recorded miss, in both
    ports = tt.Tuner(mine, platform="cpu", device_kind="cpu")
    refs = jt.Tuner(jt.TimingTable.from_doc(mine.to_doc()),
                    platform="cpu", device_kind="cpu")
    for t in (ports, refs):
        assert t.measured_cost("grad_sync", "lane", 4, 2, 4096) is None
        assert t.measured_cost("grad_sync", "lane", 2, 2, 1 << 40) is None
    assert ports.misses == refs.misses == [
        ("grad_sync", "lane", 4, 2, 4096),
        ("grad_sync", "lane", 2, 2, 1 << 40)]


def test_tuner_matches_repro():
    mine, ref = _tables(_rows(9))
    ports = tt.Tuner(mine, platform="cpu", device_kind="cpu")
    refs = jt.Tuner(ref, platform="cpu", device_kind="cpu")
    rng = np.random.default_rng(10)
    for _ in range(300):
        coll = str(rng.choice(list(STRATEGIES)))
        s = str(rng.choice(STRATEGIES[coll]))
        n, N = TOPOS[int(rng.integers(0, len(TOPOS)))]
        b = int(2 ** rng.uniform(8, 26))
        assert ports.measured_cost(coll, s, n, N, b) == \
            refs.measured_cost(coll, s, n, N, b)
    assert ports.misses == refs.misses and ports.misses


def test_tuner_reads_its_device_and_never_falls_back():
    """The lazy signature is the device's; a CUDA device on a host with
    no card raises instead of keying on the CPU."""
    table = tt.TimingTable([tt.TimingEntry("grad_sync", "lane",
                                           "cpu/cpu/n2xN2", 4096, 10.0,
                                           9.0, 3)])
    assert tt.Tuner(table, device="cpu").measured_cost(
        "grad_sync", "lane", 2, 2, 4096) == pytest.approx(10e-6)
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the check is for CPU hosts")
    with pytest.raises(RuntimeError, match="cuda"):
        tt.Tuner(table).measured_cost("grad_sync", "lane", 2, 2, 4096)

    class Rotten:
        def lookup_us(self, *a):
            raise ValueError("rotten")
    assert tt.Tuner(Rotten(), device="cpu").measured_cost(
        "grad_sync", "lane", 2, 2, 4096) is None


# ---------------------------------------------------------------------------
# fit and report
# ---------------------------------------------------------------------------

def test_design_rows_match_repro_exactly():
    rng = np.random.default_rng(11)
    payloads = [float(int(b)) for b in 2 ** rng.uniform(10, 30, 3)]
    pairs = [(c, e.strategy) for c in tt.probeable_collectives()
             for e in iter_impls(c)]
    checked = 0
    with equal_hw():
        for coll, s in pairs:
            for n, N in TOPOS:
                for c in payloads:
                    try:
                        want = jt.design_row(coll, s, n, N, c)
                    except ValueError:
                        with pytest.raises(ValueError):
                            tt.design_row(coll, s, n, N, c)
                        continue
                    np.testing.assert_array_equal(
                        tt.design_row(coll, s, n, N, c), want)
                    checked += 1
    # 11 priced forms (3 + 3 + 2 + 2 + 1) at every topology and payload
    assert checked == 11 * len(TOPOS) * len(payloads)


def _fit_table(seed):
    rng = np.random.default_rng(seed)
    rows = []
    for sig in ("cpu/cpu/n4xN2", "cpu/cpu/n2xN2"):
        for coll, strategies in STRATEGIES.items():
            for s in strategies:
                for b in (1 << 12, 1 << 15, 1 << 18, 1 << 21):
                    med = float(rng.uniform(10, 3000))
                    rows.append((coll, s, sig, b, med, med * 0.9, 5))
    return _tables(rows)


def test_fit_matches_repro():
    mine, ref = _fit_table(12)
    with equal_hw():
        fit, want = tt.fit_hw(mine), jt.fit_hw(ref)
        for sig in ("cpu/cpu/n2xN2", None):
            a = tt.fit_hw(mine, topo_sig=sig)
            b = jt.fit_hw(ref, topo_sig=sig)
            assert a.num_cells == b.num_cells
    names = {"alpha_node": "alpha_ici", "beta_node": "beta_ici",
             "alpha_lane": "alpha_dcn", "beta_lane": "beta_dcn"}
    assert set(fit.params) == set(names)
    for k, jk in names.items():
        np.testing.assert_allclose(fit.params[k], want.params[jk],
                                   rtol=FIT_RTOL)
    np.testing.assert_allclose(
        [fit.hw.alpha_node, fit.hw.node_bw, fit.hw.alpha_lane,
         fit.hw.lane_bw],
        [want.hw.alpha_ici, want.hw.ici_bw, want.hw.alpha_dcn,
         want.hw.dcn_bw], rtol=FIT_RTOL)
    np.testing.assert_allclose(
        [fit.residual_rms_us, fit.residual_max_us],
        [want.residual_rms_us, want.residual_max_us], rtol=FIT_RTOL)
    assert fit.num_cells == want.num_cells == 2 * 8 * 4 - 2 * 4
    for a, b in zip(fit.cells, want.cells):
        assert a.keys() == b.keys()
        assert [a[k] for k in ("collective", "strategy", "topo_sig",
                               "payload_bytes", "measured_us")] == \
            [b[k] for k in ("collective", "strategy", "topo_sig",
                            "payload_bytes", "measured_us")]
        np.testing.assert_allclose(a["fitted_us"], b["fitted_us"],
                                   rtol=FIT_RTOL, atol=0.011)
    # installing is the caller's step: fitting leaves the constants alone
    assert get_hw() == HW()
    with pytest.raises(ValueError, match="no fittable cells"):
        tt.fit_hw(tt.TimingTable())


def test_fit_recovers_known_constants():
    true = HW(alpha_node=3e-6, node_bw=40e9, alpha_lane=25e-6,
              lane_bw=20e9)
    sig = tt.topology_signature(4, 2, platform="cpu", device_kind="cpu")
    entries = []
    for payload in (1 << 12, 1 << 15, 1 << 18):
        for s in ("native", "lane", "lane_pipelined"):
            us = tt.predicted_us("grad_sync", s, 4, 2, payload, true)
            entries.append(tt.TimingEntry("grad_sync", s, sig, payload, us,
                                          us, 3))
    fit = tt.fit_hw(tt.TimingTable(entries))
    assert fit.params["alpha_node"] == pytest.approx(3e-6, rel=1e-3)
    assert fit.params["alpha_lane"] == pytest.approx(25e-6, rel=1e-3)
    assert fit.hw.node_bw == pytest.approx(40e9, rel=1e-3)
    assert fit.hw.lane_bw == pytest.approx(20e9, rel=1e-3)
    assert fit.residual_rms_us == pytest.approx(0.0, abs=1e-3)


def test_report_matches_repro():
    mine, ref = _fit_table(13)
    with equal_hw():
        got = tt.build_report(mine, tolerance=1.5)
        want = jt.build_report(ref, tolerance=1.5)
    assert got["cells"] == want["cells"] and got["cells"]
    for k in ("topology", "tolerance", "measured_cells", "violations",
              "ok"):
        assert got[k] == want[k]
    assert set(got["fit"]) == {"alpha_node_s", "alpha_lane_s",
                               "node_bw_Bps", "lane_bw_Bps",
                               "residual_rms_us", "residual_max_us",
                               "num_cells"}
    for k, jk in (("alpha_node_s", "alpha_ici_s"),
                  ("alpha_lane_s", "alpha_dcn_s"),
                  ("node_bw_Bps", "ici_bw_Bps"),
                  ("lane_bw_Bps", "dcn_bw_Bps")):
        np.testing.assert_allclose(got["fit"][k], want["fit"][jk],
                                   rtol=FIT_RTOL)
    assert tt.DEFAULT_TOLERANCE == jt.DEFAULT_TOLERANCE


# ---------------------------------------------------------------------------
# dispatch: LaneComm.select with a tuner
# ---------------------------------------------------------------------------

def _comms(tuner_rows, n, N):
    """(port comm, repro comm) with Tuners over the same entries; the
    port's topology holds no process groups (``select`` takes n, N)."""
    topo = LaneTopology(n, N, lane_rank=0, node_rank=0, node_group=None,
                        lane_group=None, group=None, node_ranks=range(n),
                        lane_ranks=range(N), ranks=range(n * N))
    jtopo = JTopology(node_axes=("data",), lane_axis="pod")
    mine, ref = _tables(tuner_rows)
    return (LaneComm(topo, CommConfig(tuner=tt.Tuner(
                mine, platform="cpu", device_kind="cpu"))),
            JLaneComm(jtopo, JCommConfig(tuner=jt.Tuner(
                ref, platform="cpu", device_kind="cpu"))))


@pytest.mark.parametrize("n,N", TOPOS)
def test_select_matches_repro(n, N):
    rng = np.random.default_rng(14 + n * 10 + N)
    sig = f"cpu/cpu/n{n}xN{N}"
    rows = []
    for coll in ("grad_sync", "allreduce"):
        # some cells measured, some not: both tiers in play
        for s in STRATEGIES[coll]:
            if rng.uniform() < 0.6:
                for b in (1 << 12, 1 << 16, 1 << 20):
                    us = float(rng.uniform(5, 500))
                    rows.append((coll, s, sig, b, us, us, 3))
    mine, ref = _comms(rows, n, N)
    with equal_hw():
        for coll in ("grad_sync", "allreduce"):
            for b in (1 << 11, 3000, 1 << 14, 1 << 18, 1 << 21, 1 << 24):
                for lead in (None, 8 * n * N, n * N + 1):
                    got = mine._select(coll, b, n=n, N=N, lead=lead)
                    want = ref.select(coll, b, n=n, N=N, lead=lead)
                    assert got[:2] == want
                    assert got[2] == ref._select_source
    assert mine.cfg.tuner.misses == ref.cfg.tuner.misses


def test_planted_cache_flips_selection():
    """A cache that contradicts the model flips the choice: on 1 x 1 the
    model ranks lane_pipelined last, the planted cache first; and one
    measured cell outranks every modelled one, whatever its seconds."""
    payload = 64 * 4
    sig = "cpu/cpu/n1xN1"
    with equal_hw():
        bare, jbare = _comms([], 1, 1)
        model = bare._select("grad_sync", payload, n=1, N=1)
        assert model[:2] == jbare.select("grad_sync", payload, n=1, N=1)
        assert model[2] == "model" and model[0] != "lane_pipelined"
        planted = [("grad_sync", "lane_pipelined", sig, payload, 5.0, 5.0,
                    3),
                   ("grad_sync", "native", sig, payload, 300.0, 300.0, 3),
                   ("grad_sync", "lane", sig, payload, 400.0, 400.0, 3)]
        mine, ref = _comms(planted, 1, 1)
        got = mine._select("grad_sync", payload, n=1, N=1)
        assert got[:2] == ref.select("grad_sync", payload, n=1, N=1)
        assert got[0] == "lane_pipelined" and got[2] == "measured"
        assert got[1][0] == (pytest.approx(5e-6), "lane_pipelined")
        slow = [("grad_sync", "lane_pipelined", sig, payload, 1e4, 1e4, 3)]
        mine, ref = _comms(slow, 1, 1)
        got = mine._select("grad_sync", payload, n=1, N=1)
        assert got[:2] == ref.select("grad_sync", payload, n=1, N=1)
        assert got[0] == "lane_pipelined" and got[2] == "measured"
        assert {s for _, s, *_ in mine.cfg.tuner.misses} == \
            {"native", "lane"}


# ---------------------------------------------------------------------------
# the training loop's hooks
# ---------------------------------------------------------------------------

def test_tune_restore_adopts_fitted_hw(capsys):
    """The mirror of ``repro``'s test: the training loop installs the fit of a
    planted cache before the step is built, so it reprices the closed
    forms at call time, and says so; no tuner and an unfittable cache
    leave the constants alone."""
    true = HW(alpha_node=3e-6, node_bw=40e9, alpha_lane=25e-6, lane_bw=5e9)
    sig = tt.topology_signature(4, 2, platform="cpu", device_kind="cpu")
    entries = [tt.TimingEntry(
        "grad_sync", s, sig, payload,
        tt.predicted_us("grad_sync", s, 4, 2, payload, true),
        1.0, 3)
        for payload in (1 << 12, 1 << 15, 1 << 18)
        for s in ("native", "lane", "lane_pipelined")]
    c = native_cost("allreduce")
    base = c(4, 2, 1 << 20, CommConfig())
    prev = get_hw()
    try:
        train._adopt_fitted_hw(tt.Tuner(tt.TimingTable(entries),
                                        device="cpu"), 4, 2, lead=True)
        hw = get_hw()
        assert hw.node_bw == pytest.approx(40e9, rel=1e-3)
        assert hw.lane_bw == pytest.approx(5e9, rel=1e-3)
        assert c(4, 2, 1 << 20, CommConfig()) != pytest.approx(base)
        assert "cost-model HW adopted" in capsys.readouterr().out
    finally:
        set_hw(prev)
    train._adopt_fitted_hw(None, 4, 2, lead=True)
    assert get_hw() == prev
    train._adopt_fitted_hw(tt.Tuner(tt.TimingTable(), device="cpu"), 4, 2,
                           lead=True)
    assert get_hw() == prev
    assert "adoption skipped" in capsys.readouterr().out


@pytest.mark.parametrize("n,N,blind", [(2, 2, None), (1, 1, "lane"),
                                       (4, 1, "lane"), (1, 2, "node")])
def test_adoption_fits_this_topology_alone(n, N, blind, capsys):
    """The training loop fits only the cells of the run's own topology: a
    table whose cells are all of another (a topology a restart left
    behind) is skipped, and so is one whose cells leave a level unseen
    (p = 1 and N = 1 see no lane level, n = 1 no node level), where the
    fit would install that level's floors.  ``fit_hw`` itself, over the
    whole table, stays ``repro``'s."""
    true = HW(alpha_node=3e-6, node_bw=40e9, alpha_lane=25e-6, lane_bw=5e9)
    stale = tt.topology_signature(4, 2, platform="cpu", device_kind="cpu")

    def cells(sig, n, N):
        return [tt.TimingEntry("grad_sync", s, sig, b,
                               tt.predicted_us("grad_sync", s, n, N, b, true),
                               1.0, 3)
                for b in (1 << 12, 1 << 15, 1 << 18)
                for s in ("native", "lane", "lane_pipelined")]
    prev = get_hw()
    try:
        train._adopt_fitted_hw(tt.Tuner(tt.TimingTable(cells(stale, 4, 2)),
                                        device="cpu"), n, N, lead=True)
        assert get_hw() is prev
        assert "no fittable cells" in capsys.readouterr().out
        sig = tt.topology_signature(n, N, platform="cpu", device_kind="cpu")
        table = tt.TimingTable(cells(stale, 4, 2) + cells(sig, n, N))
        assert tt.fit_hw(table, topo_sig=sig).blind == \
            ((blind,) if blind else ())
        train._adopt_fitted_hw(tt.Tuner(table, device="cpu"), n, N,
                               lead=True)
        out = capsys.readouterr().out
        if blind:
            assert get_hw() is prev
            assert f"sees the {blind} level" in out
        else:
            assert get_hw().lane_bw == pytest.approx(5e9, rel=1e-3)
            assert f"cells of {sig}" in out
    finally:
        set_hw(prev)


def test_run_restores_the_constants_it_adopted(tmp_path, capsys):
    """One process, ``--gradsync auto --tuning-cache`` on a planted
    cache of its own topology (1 x 1): the fit sees no lane level, so the
    run keeps the constants in force and says so, and the constants
    before the run are the ones after it (the multi-rank run that does
    adopt is in ``test_torch_tuning_dist.py``)."""
    sig = "cpu/cpu/n1xN1"
    table = tt.TimingTable([tt.TimingEntry("grad_sync", s, sig, 1 << 16,
                                           us, us, 3)
                            for s, us in (("native", 30.0), ("lane", 10.0),
                                          ("lane_pipelined", 20.0))])
    path = tt.save_timing_table(tmp_path / "c.json", table)
    prev = get_hw()
    stats = {}
    losses, _, _ = train.run(["--arch", "llama3.2-3b", "--smoke", "--steps",
                              "2", "--batch", "2", "--seq", "8",
                              "--gradsync", "auto", "--tuning-cache",
                              str(path), "--device", "cpu"], stats=stats)
    assert len(losses) == 2
    assert "sees the lane level" in capsys.readouterr().out
    assert stats["hw"] is prev
    assert get_hw() is prev


def test_tune_never_falls_back(tmp_path):
    argv = ["--arch", "llama3.2-3b", "--smoke", "--steps", "1", "--tune",
            "--tuning-cache", str(tmp_path / "c.json")]
    with pytest.raises(ValueError, match="started"):
        train.run(argv + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.run(argv)
    topo = LaneTopology(1, 1, lane_rank=0, node_rank=0, node_group=None,
                        lane_group=None, group=None, node_ranks=[0],
                        lane_ranks=[0], ranks=[0])
    with pytest.raises(ValueError, match="probe"):
        tt.probe_cells(topo, device="cpu", collectives=("bcast",))
    assert not (tmp_path / "c.json").exists()


# ---------------------------------------------------------------------------
# core.guidelines
# ---------------------------------------------------------------------------

def test_guidelines_match_repro():
    rng = np.random.default_rng(15)
    for size in (1, 2, 5, 30, 31):
        s = [float(x) for x in rng.uniform(1, 1000, size)]
        assert guidelines.median_us(s) == jguide.median_us(s)
    with pytest.raises(ValueError):
        guidelines.median_us([])
    for _ in range(20):
        a = [float(x) for x in rng.uniform(1, 100, 4)]
        mine = guidelines.GuidelineResult("c", *a)
        ref = jguide.GuidelineResult("c", *a)
        assert (mine.violated, mine.ratio, mine.row()) == \
            (ref.violated, ref.ratio, ref.row())
    samples = guidelines.time_fn_samples(lambda x: x + 1, torch.ones(4),
                                         reps=3, warmup=1)
    assert len(samples) == 3 and all(t >= 0 for t in samples)
    avg, best = guidelines.time_fn(lambda: torch.ones(4), reps=3, warmup=0)
    assert best <= avg
