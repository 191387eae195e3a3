"""lanelint of the port (``repro_torch.analysis``) against ``repro``'s,
without a world: the footprint conventions, the volume algebra and its
departures, the rules on synthetic footprints, the AST rules, the
baseline and the CLI.  The sweeps on 8-rank worlds are in
``test_torch_lint_cells.py`` and ``test_torch_lint_steps.py``."""
import itertools
import json

import pytest

from repro.analysis import footprint as jfp
from repro.analysis.rules import iter_cell_cases as repro_cases
from repro.comm import costs as jcosts
from repro_torch.analysis import (CollOp, CommFootprint, ERROR, Finding,
                                  apply_baseline, format_findings,
                                  load_baseline, save_baseline)
from repro_torch.analysis import footprint as fp
from repro_torch.analysis.rules import (CellCase, GRID, R2_ABS_TOL,
                                        check_r1, check_r2, check_r4)
from repro_torch.comm import costs


# ---------------------------------------------------------------------------
# the footprint conventions
# ---------------------------------------------------------------------------

def _groups(n, N):
    """Every node and lane group of the (n, N) topology, the world, and
    the mixed shapes of repro's fixtures."""
    p = n * N
    node = [tuple(range(j * n, (j + 1) * n)) for j in range(N)]
    lane = [tuple(range(i, p, n)) for i in range(n)]
    mixed = [(0, 1, n, n + 1), (0, n), (0, 1, n), tuple(range(1, p))]
    return node + lane + [tuple(range(p)), (), (3,)] + mixed


@pytest.mark.parametrize("n,N", GRID)
def test_classify_group_is_repros(n, N):
    for ids in _groups(n, N):
        for num in (None, n * N):
            assert fp.classify_group(ids, n=n, num_devices=num) == \
                jfp.classify_group(ids, n=n, num_devices=num), ids


def test_footprint_wire_is_repros():
    shared = {"all-reduce": "all-reduce", "all-gather": "all-gather",
              "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
              "send": "collective-permute"}
    for (kind, jkind), g, b in itertools.product(
            shared.items(), (1, 2, 4, 8), (4.0, 4096.0, 1028.0)):
        assert fp._footprint_wire(kind, g, b) == \
            jfp._footprint_wire(jkind, g, b)
    # the rooted kinds, which repro emulates: the busiest member's bytes
    assert fp._footprint_wire("broadcast", 4, 1024.0) == 1024.0
    assert fp._footprint_wire("reduce", 4, 1024.0) == 1024.0
    assert fp._footprint_wire("gather", 4, 1024.0) == 3072.0
    assert fp._footprint_wire("scatter", 4, 1024.0) == 3072.0
    for kind in ("recv", "barrier", "broadcast-object"):
        assert fp._footprint_wire(kind, 4, 1024.0) == 0.0


# ---------------------------------------------------------------------------
# the volume algebra: where the port issues what repro lowers, the same
# ---------------------------------------------------------------------------

#: (collective, strategy) -> why the port's closed form is not repro's
DEPARTURES = {
    ("allreduce", "lane_pipelined"):
        "repro's scan runs B+2 steps whose warm-up and drain move garbage "
        "(node and lane scaled by (B+2)/B); the port's loop issues RS(node) "
        "and AG(node) only for held blocks and rings each stripe N-1 hops",
    ("grad_sync", "lane_pipelined"):
        "the same pipeline over the K buckets (core/pipeline.py)",
    ("bcast", "native"):
        "dist.broadcast, rooted, where repro emulates a masked psum",
    ("reduce", "native"): "dist.reduce, rooted, not a masked psum",
    ("scatter", "native"): "dist.scatter, rooted, not a masked psum",
    ("gather", "native"):
        "one dist.gather over the world, where XLA lowers repro's "
        "all-gather as a node and a lane all-gather",
    ("reduce_scatter", "native"):
        "one reduce-scatter over the world (XLA splits repro's over the "
        "mesh's two axes: lane then node)",
    ("allgather", "native"): "one all-gather over the world (XLA: two)",
    ("alltoall", "native"): "one all-to-all over the world (XLA: two)",
    ("moe_route", "native"): "one all-to-all over the world (XLA: two)",
    ("scan", "native"): "one all-gather over the world (XLA: two)",
    ("bcast", "lane"):
        "the stripe's lane broadcast is dist.broadcast, not a masked psum "
        "over the lane (equal at N = 2)",
    ("kv_splice", "lane"): "bcast/lane's lane broadcast on the padded leaf",
    ("reduce", "lane"):
        "dist.reduce down the lane, not an all-reduce (equal at N = 2); the "
        "stripes' gather to the root runs on the root lane alone",
    ("bcast", "lane_pipelined"):
        "each block goes down the ring once (repro's ring steps move "
        "garbage in warm-up and drain) and the last lane rank sends none",
    ("reduce", "lane_pipelined"):
        "each block's partial goes up the ring once; the root's stripes "
        "are all-gathered once",
}


def _cases():
    import repro.comm.impls  # noqa: F401  — populate repro's registry
    return list(repro_cases())


def _vol(f, case):
    v = f(case.collective, case.strategy, n=case.n, N=case.N,
          payload_bytes=case.payload_bytes, **dict(case.kw))
    return None if v is None else {k: x for k, x in v.items() if x}


def test_lowered_wire_volumes_are_repros_but_the_departures():
    departed = set()
    for case in _cases():
        key = (case.collective, case.strategy)
        mine, theirs = _vol(costs.lowered_wire_volumes, case), \
            _vol(jcosts.lowered_wire_volumes, case)
        assert mine is not None, case.target
        if key in DEPARTURES:
            if mine != pytest.approx(theirs):
                departed.add(key)
            continue
        assert set(mine) == set(theirs), case.target
        assert mine == pytest.approx(theirs, rel=1e-12), case.target
    # every listed departure departs on at least one grid topology
    assert departed == set(DEPARTURES)
    assert all(reason for reason in DEPARTURES.values())


def test_assumed_volumes_are_repros():
    for case in _cases():
        kw = dict(n=case.n, N=case.N, payload_bytes=case.payload_bytes,
                  **dict(case.kw))
        assert costs.assumed_volumes(case.collective, case.strategy,
                                     **kw) == \
            jcosts.assumed_volumes(case.collective, case.strategy, **kw)


def test_closed_forms_at_the_dump_verified_point():
    kw = dict(n=4, N=2, payload_bytes=4096)
    assert costs.lowered_wire_volumes("allreduce", "native", **kw) == \
        {"global": pytest.approx(7168)}
    assert costs.lowered_wire_volumes("allreduce", "lane", **kw) == \
        {"node": pytest.approx(6144), "lane": pytest.approx(1024)}
    assert costs.lowered_wire_volumes("allreduce", "lane_pipelined",
                                      num_blocks=4, **kw) == \
        {"node": pytest.approx(6144), "lane": pytest.approx(1024)}
    assert costs.assumed_volumes("bcast", "lane_pipelined", num_blocks=4,
                                 **kw) is None


# ---------------------------------------------------------------------------
# the rules on synthetic footprints (repro's adversarial fixtures)
# ---------------------------------------------------------------------------

def _op(kind, ranks, result_bytes, *, n=4, p=8, async_op=False, issued=0,
        completed=None):
    level = fp.classify_group(ranks, n=n, num_devices=p)
    return CollOp(kind=kind, level=level, ranks=tuple(ranks),
                  payload_bytes=result_bytes, result_bytes=result_bytes,
                  wire_bytes=fp._footprint_wire(kind, len(ranks),
                                                result_bytes),
                  async_op=async_op, issued=issued,
                  completed=issued if completed is None and not async_op
                  else completed, device="cpu")


def _levels_foot():
    """One op per level under n=4, p=8, as repro's LEVELS_HLO."""
    return CommFootprint([
        _op("all-reduce", range(8), 4096, issued=1),
        _op("all-gather", (0, 1, 2, 3), 4096, issued=2),
        _op("all-gather", (0, 4), 4096, issued=3),
        _op("all-gather", (0, 1, 4, 5), 4096, issued=4)], n=4, num_devices=8)


def test_r1_flags_mixed_and_decomposed_global():
    foot = _levels_foot()
    assert foot.levels() == ("node", "lane", "global", "mixed")
    out = check_r1("cell@n4xN2", foot, decomposed=False)
    assert [f.rule for f in out] == ["R1"]
    assert "straddles" in out[0].message
    out = check_r1("cell@n4xN2", foot, decomposed=True)
    assert len(out) == 2
    assert any("whole-world" in f.message for f in out)


def test_r1_scalar_exemption():
    foot = CommFootprint([_op("all-reduce", (0, 1, 4, 5), 16)], n=4,
                         num_devices=8)
    assert foot.mixed()
    assert check_r1("cell", foot, decomposed=True) == []


def test_r2_payload_conservation():
    case = CellCase("allreduce", "native", 4, 2, 4096)
    good = CommFootprint([_op("all-reduce", range(8), 4096)], n=4,
                         num_devices=8)
    assert check_r2(case, good) == []
    bad = CommFootprint([_op("all-reduce", range(8), 2048)], n=4,
                        num_devices=8)
    out = check_r2(case, bad)
    assert [f.rule for f in out] == ["R2"]
    assert "3584" in out[0].message and "7168" in out[0].message
    assert R2_ABS_TOL < 7168 - 3584
    # exact: one byte more than the closed form beyond the scalar
    # tolerance is a finding, the busiest rank's bytes are what count
    off = CommFootprint([_op("all-reduce", range(8), 4096 + 2048)], n=4,
                        num_devices=8)
    assert check_r2(case, [good, off]) != []


def test_r4_pipelined_and_negative_control():
    pipe = CellCase("bcast", "lane_pipelined", 4, 2, 4096)
    ctrl = CellCase("prefetch_allgather", "blocking", 4, 2, 4096)
    # an async node phase in flight across a lane hop
    carried = CommFootprint([
        _op("all-gather", (0, 1, 2, 3), 1024, async_op=True, issued=1,
            completed=4),
        _op("send", (0, 4), 256, async_op=True, issued=2, completed=3)],
        n=4, num_devices=8)
    serial = CommFootprint([
        _op("all-gather", (0, 1, 2, 3), 1024, issued=1),
        _op("send", (0, 4), 256, async_op=True, issued=2, completed=3),
        _op("all-gather", (0, 1, 2, 3), 1024, issued=4)], n=4,
        num_devices=8)
    assert check_r4(pipe, carried, expect_overlap=True) == []
    out = check_r4(pipe, serial, expect_overlap=True)
    assert [f.rule for f in out] == ["R4"]
    assert "NO node×lane" in out[0].message
    assert check_r4(ctrl, serial, expect_overlap=False) == []
    out = check_r4(ctrl, carried, expect_overlap=False)
    assert [f.rule for f in out] == ["R4"]
    assert "vacuous" in out[0].message
    # an async op never waited for is in flight to the end
    dangling = CommFootprint([
        _op("all-reduce", (0, 4), 1024, async_op=True, issued=1),
        _op("all-gather", (0, 1, 2, 3), 1024, issued=5)], n=4,
        num_devices=8)
    assert len(fp.overlap(dangling)) == 1


# ---------------------------------------------------------------------------
# diagnostics + baseline
# ---------------------------------------------------------------------------

def test_finding_key_and_format():
    a = Finding("R2", "allreduce/lane@n4xN2", "volume off", ERROR)
    b = Finding("A2", "src/repro_torch/x.py#assert", "bare assert",
                severity="warning")
    assert a.key == "R2:allreduce/lane@n4xN2"
    lines = format_findings([b, a]).splitlines()
    assert lines[0].startswith("ERROR R2")
    assert lines[1].startswith("WARNING A2")


def test_baseline_roundtrip_and_stale(tmp_path):
    path = str(tmp_path / "baseline.json")
    f1 = Finding("R2", "cell/a", "m1")
    f2 = Finding("A1", "src/x.py#all_reduce", "m2")
    save_baseline([f1, f2], path)
    base = load_baseline(path)
    assert set(base) == {f1.key, f2.key}
    unsup, stale = apply_baseline([f1], base)
    assert unsup == [] and stale == [f2.key]
    f3 = Finding("R3", "cell/b", "m3")
    unsup, _ = apply_baseline([f1, f3], base)
    assert unsup == [f3]
    doc = json.loads(open(path).read())
    doc["entries"][1]["reason"] = "because physics"
    open(path, "w").write(json.dumps(doc))
    save_baseline([f1, f2], path)
    assert load_baseline(path)[f1.key]["reason"] == "because physics"


def test_baseline_missing_file_and_reason_enforcement(tmp_path):
    from repro_torch.analysis.baseline import default_baseline_path
    assert default_baseline_path().endswith("lint_baseline_torch.json")
    assert load_baseline(str(tmp_path / "absent.json")) == {}
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({
        "version": 1,
        "entries": [{"rule": "R1", "target": "x", "reason": "  "}]}))
    with pytest.raises(ValueError, match="justified"):
        load_baseline(str(path))
    path.write_text(json.dumps({"version": 99, "entries": []}))
    with pytest.raises(ValueError, match="unsupported format"):
        load_baseline(str(path))


# ---------------------------------------------------------------------------
# AST rules on synthetic modules and on the port
# ---------------------------------------------------------------------------

def _lint_src(tmp_path, rel, src):
    from repro_torch.analysis.astlint import lint_file
    p = tmp_path / rel.replace("/", "__")
    p.write_text(src)
    return lint_file(str(p), rel, src_prefix="src/repro_torch/")


def test_a1_raw_collectives(tmp_path):
    src = ("import torch.distributed as dist\n"
           "import torch\n"
           "from torch.distributed import all_reduce\n"
           "from torch import distributed as td\n"
           "def f(x, g):\n"
           "    all_reduce(x)\n"
           "    torch.distributed.broadcast(x, src=0)\n"
           "    td.barrier()\n"
           "    dist.new_group([0]); dist.get_rank()\n"
           "    return dist.all_gather_into_tensor(x, x, group=g)\n")
    out = _lint_src(tmp_path, "models/foo.py", src)
    assert sorted(f.target for f in out) == [
        "src/repro_torch/models/foo.py#all_gather_into_tensor",
        "src/repro_torch/models/foo.py#all_reduce",
        "src/repro_torch/models/foo.py#barrier",
        "src/repro_torch/models/foo.py#broadcast"]
    assert all(f.rule == "A1" for f in out)
    assert _lint_src(tmp_path, "comm/foo.py", src) == []
    assert _lint_src(tmp_path, "optim/gradsync.py", src) == []


def test_a2_bare_assert(tmp_path):
    src = "def f(x):\n    assert x > 0, 'bad'\n    return x\n"
    assert [f.rule for f in _lint_src(tmp_path, "serve/foo.py", src)] == \
        ["A2"]
    assert _lint_src(tmp_path, "core/ref.py", src) == []
    assert _lint_src(tmp_path, "analysis/foo.py", src) == []


def test_a3_determinism_scope(tmp_path):
    src = ("import time, numpy as np, torch\n"
           "def f(g):\n"
           "    t = time.time()\n"
           "    a = np.random.normal()\n"
           "    b = np.random.default_rng()\n"
           "    c = torch.randn(3)\n"
           "    d = torch.multinomial(torch.ones(3), 1)\n"
           "    ok1 = np.random.default_rng(0)\n"
           "    ok2 = torch.rand(3, generator=g)\n"
           "    return t, a, b, c, d, ok1, ok2\n")
    out = _lint_src(tmp_path, "data/foo.py", src)
    assert sorted(f.target.split("#")[1] for f in out) == [
        "np.random.default_rng()", "np.random.normal", "time.time",
        "torch.multinomial", "torch.randn"]
    assert all(f.rule == "A3" for f in out)
    assert len(_lint_src(tmp_path, "serve/prng.py", src)) == 5
    assert _lint_src(tmp_path, "models/foo.py", src) == []


def test_a4_unpriced_cell(tmp_path):
    src = ("from repro_torch.comm.registry import register_impl\n"
           "@register_impl('allreduce', 'mystery')\n"
           "def f(comm, x): return x\n"
           "@register_impl('allreduce', 'priced', cost=lambda *a: 1.0)\n"
           "def g(comm, x): return x\n"
           "@register_impl('allreduce', 'opted', auto_ok=False)\n"
           "def h(comm, x): return x\n")
    out = _lint_src(tmp_path, "comm/foo.py", src)
    assert [f.rule for f in out] == ["A4"]
    assert "allreduce/mystery" in out[0].target


def test_a0_unparseable(tmp_path):
    assert [f.rule for f in _lint_src(tmp_path, "models/foo.py",
                                      "def f(:\n")] == ["A0"]


def test_the_port_is_ast_clean_and_its_whitelist_tight():
    """A0–A4 find nothing in the shipped port, and every whitelisted file
    does call a raw collective (an entry that is not needed goes)."""
    import ast
    from repro_torch.analysis import astlint
    assert astlint.run_ast_rules() == []
    needed = set()
    for abs_path, rel in astlint.iter_source_files():
        tree = ast.parse(open(abs_path).read())
        if rel in astlint.A1_FILE_WHITELIST and astlint._check_a1(
                tree, "models/x.py", rel):
            needed.add(rel)
    assert needed == set(astlint.A1_FILE_WHITELIST)
    assert all(astlint.A1_FILE_WHITELIST.values())


# ---------------------------------------------------------------------------
# the CLI's exit codes
# ---------------------------------------------------------------------------

def _main(monkeypatch, findings, argv):
    import repro_torch.analysis.lint as lint
    if isinstance(findings, Exception):
        def collect(args):
            raise findings
    else:
        def collect(args):
            return list(findings)
    monkeypatch.setattr(lint, "_collect", collect)
    return lint.main(argv)


def test_cli_exit_codes(monkeypatch, capsys):
    f = Finding("R2", "cell/a", "volume off")
    assert _main(monkeypatch, [], ["--ast-only", "--no-baseline"]) == 0
    assert _main(monkeypatch, [f], ["--cells-only", "--no-baseline"]) == 1
    out = capsys.readouterr().out
    assert "ERROR R2 cell/a" in out and "1 finding(s)" in out
    assert _main(monkeypatch, RuntimeError("a rank crashed"),
                 ["--ast-only"]) == 2
    assert "internal error" in capsys.readouterr().err


def test_cli_baseline_lifecycle(monkeypatch, tmp_path, capsys):
    f = Finding("R2", "cell/a", "volume off")
    base = str(tmp_path / "baseline.json")
    assert _main(monkeypatch, [f], ["--ast-only", "--baseline", base]) == 1
    assert _main(monkeypatch, [f], ["--ast-only", "--baseline", base,
                                    "--update-baseline"]) == 0
    assert load_baseline(base)[f.key]["rule"] == "R2"
    capsys.readouterr()
    assert _main(monkeypatch, [f], ["--ast-only", "--baseline", base]) == 0
    assert "1 suppressed" in capsys.readouterr().out
    assert _main(monkeypatch, [], ["--ast-only", "--baseline", base]) == 0
    assert "stale baseline entry" in capsys.readouterr().out


def test_cli_ast_only_on_the_port(capsys):
    """A real ``--ast-only`` run: the port lints clean with no baseline
    file, and none is committed."""
    from repro_torch.analysis.baseline import default_baseline_path
    from repro_torch.analysis.lint import main
    import os
    assert not os.path.exists(default_baseline_path())
    assert main(["--ast-only"]) == 0
    assert "lanelint: clean" in capsys.readouterr().out
