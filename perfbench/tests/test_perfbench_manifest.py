"""The manifest holds to the benchmark's contract, and every cell,
configuration, traffic mix, driver, reference and metric it names is
found by name; a cell added as files and a manifest entry alone runs."""
from __future__ import annotations

import json
import re

import pytest

from perfbench.tests import smoke_root

REPO = smoke_root.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj",
               "head", "expand", "experts_per_tok", "num_experts_per")


@pytest.fixture(scope="module")
def manifest():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "perfbench/run.py"]
    assert manifest["paths"] == ["perfbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_names_units_and_entries(manifest):
    names = [c["name"] for c in manifest["configs"]] \
        + [w["name"] for w in manifest["workloads"]] \
        + [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    for name in names:
        assert NAME.match(name), name
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in manifest[group]]
        assert len(got) == len(set(got)), group
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank"))
            assert not any(w in key for w in WIDTH_WORDS), key
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)


def test_metrics(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in cells:    # every cell: setup_s, another e2e, a per-layer
        reported = [m["name"] for m in manifest["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in manifest["per_layer"])


def test_every_named_file_is_found(manifest):
    from perfbench import harness
    for w in manifest["workloads"]:
        f = harness.find(REPO, w["name"])
        assert f["cell"]["driver"]
        assert (REPO / "perfbench" / "drivers"
                / f"{f['cell']['driver']}.py").is_file()
        fam = f["config"]["family"]
        assert (REPO / "perfbench" / "reference" / f"{fam}.py").is_file()
        assert set(f["config"]["reduced"]) == set(
            f["config_entry"]["reduced"])
    for m in manifest["end_to_end"]:
        assert (REPO / "perfbench" / "end_to_end"
                / f"{m['name']}.py").is_file()
    for m in manifest["per_layer"]:
        assert (REPO / "perfbench" / "layer_metrics"
                / f"{m['name']}.py").is_file()


def test_configs_are_the_programs(manifest):
    """The program's registry holds every field the configuration file
    names, at the file's value, and the reference lists the program's
    parameters, each of its shape and type."""
    import math
    from perfbench import harness
    from repro_torch.configs import resolve
    for c in manifest["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        prog = resolve(cfg["program"]["arch"])
        for attr, key in cfg["program"]["fields"].items():
            got, want = getattr(prog, attr), cfg[key]
            assert got == want or (isinstance(want, float)
                                   and math.isclose(got, want)), (attr, key)
        fam = harness.load_file_module(
            REPO / "perfbench" / "reference" / f"{cfg['family']}.py")
        fam.check(cfg)
        from repro_torch import _tree
        from repro_torch.models import init_model
        want = {".".join(map(str, path)): (tuple(t.shape), str(t.dtype))
                for path, t in _tree.flatten(init_model(prog, device="meta"))}
        got = {name: (tuple(shape), f"torch.{dt}")
               for name, shape, dt, _ in fam.param_specs(cfg)}
        assert got == want


def test_a_cell_added_as_files_runs(tmp_path):
    """A new cell, with a traffic mix of its own, exists only as files
    in a temporary root and one manifest entry; the harness finds and
    runs it without a change to any other file."""
    from perfbench import harness
    root = smoke_root.make(tmp_path)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    base = root / "perfbench"
    (base / "traffic" / "docs_3x16.json").write_text(json.dumps(
        {"kind": "packed_documents", "rows": 3, "seq": 16,
         "doc_len_median": 6, "doc_len_sigma": 0.5, "doc_len_max": 64,
         "zipf_a": 1.2}))
    cell = json.loads((base / "cells" / "mamba2.train.8x1024.json")
                      .read_text())
    (base / "cells" / "mamba2.train.3x16.json").write_text(json.dumps(cell))
    manifest["workloads"].append(
        {"name": "mamba2.train.3x16", "config": "mamba2-780m",
         "traffic": "docs_3x16", "chips": 1, "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    rec, result = harness.run(root, "mamba2.train.3x16", 5, 0.2, False,
                              "cpu")
    assert result["correct"] is True
    assert rec["rows_global"] == 3 and rec["seq"] == 16
    assert rec["attempted"] >= 1
