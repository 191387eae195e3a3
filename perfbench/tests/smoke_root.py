"""A checkout-like root for the CPU tests: the benchmark's files copied
under a temporary directory, every configuration switched to the
program's ``--smoke`` sizes (float32, a few layers of width 64) and every
traffic mix to a few short rows, so that a whole run takes seconds."""
from __future__ import annotations

import json
import math
import pathlib
import shutil
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)


def smoke_config(cfg: dict) -> dict:
    """``cfg`` with every field the program's smoke config gives."""
    from repro_torch.configs import resolve
    prog = resolve(cfg["program"]["arch"], smoke=True)
    out = json.loads(json.dumps(cfg))
    for attr, key in cfg["program"]["fields"].items():
        out[key] = getattr(prog, attr)
    out["program"]["smoke"] = True
    out["token_ids"] = prog.vocab_size
    if "attention_multiplier" in out:
        out["attention_multiplier"] = 1.0 / math.sqrt(prog.hd())
    return out


def make(tmp, *, rows_per_chip: int = 2, seq: int = 16) -> pathlib.Path:
    """A root under ``tmp`` holding ``BENCHMARK.json`` and ``perfbench/``,
    at smoke sizes."""
    root = pathlib.Path(tmp)
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        path = root / c["file"]
        path.write_text(json.dumps(smoke_config(json.loads(
            path.read_text()))))
    for w in manifest["workloads"]:
        path = root / "perfbench" / "traffic" / f"{w['traffic']}.json"
        tr = json.loads(path.read_text())
        tr.update(rows=rows_per_chip * w["chips"], seq=seq,
                  doc_len_median=8)
        path.write_text(json.dumps(tr))
    return root
