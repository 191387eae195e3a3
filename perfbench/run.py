"""The benchmark of ``repro_torch``: one run of one cell on the card(s).

  python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` names the cells).  It
prints progress and the compared numbers on standard error, and as the
last line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.

It exits non-zero and prints no result where CUDA is missing or has
fewer devices than the cell asks for, where a run fails, and where the
JAX stack or the JAX package (``repro``) is loaded once the window has
closed.  The kernels' builds stay under ``build/`` inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("USE_FLAX", "0")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "perfbench_cache" / sub)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python3 perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def _fail(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    try:
        from perfbench import harness
        chips = int(harness.find(ROOT, args.workload)["workload"]["chips"])
    except (OSError, KeyError, ValueError) as e:
        _fail(f"cannot read the cell: {e!r}")
    import torch
    if not torch.cuda.is_available():
        _fail("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        _fail(f"the cell asks for {chips} CUDA devices, "
              f"{torch.cuda.device_count()} are visible")
    rec, result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        _fail(f"the JAX stack or the JAX package is loaded: {bad}")
    for name, c in result["checks"].items():
        print(f"[perfbench] check {name} {c['value']!r} limit {c['limit']!r}"
              f" (worst at {c['at']})", file=sys.stderr)
    print(f"[perfbench] correct {result['correct']}", file=sys.stderr,
          flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
