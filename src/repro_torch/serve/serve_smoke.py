"""The serving tier must actually SERVE, end to end.

Counterpart of ``repro.serve.serve_smoke``, three legs, each a
production path rather than a unit:

  * scenario sweep — the registry-derived scenario generator drives the
    continuous batcher over every scenario kind for a bucketed family
    (dense, llama3.2-3b) and an exact-length-prefill family (ssm,
    mamba2-780m); every request must finish with a recorded reason and a
    first-token time;
  * checkpoint → serve — a REAL training-driver checkpoint (2 steps,
    ``--gradsync native``, the replicated layout) restored through
    ``load_serve_params`` must serve a scenario to completion;
  * lane_zero3 identity — those weights served under ``lane_zero3``
    hosting (1/p masters, prefetch-gathered layers, sharded slots,
    ``kv_splice``) must give the replicated hosting's tokens.  It runs on
    a spawned world: 2 pods × 2 gloo ranks on the CPU, one NCCL rank on
    a card (NCCL takes one rank a card).

Each leg prints PASS or FAIL; the exit code is the number of failed
legs.  ``run_scenarios`` is the sweep's engine loop, which
``chip_smoke.py`` calls at full width.

Usage:  python -m repro_torch.serve.serve_smoke [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
import tempfile

__all__ = ["run_scenarios", "main"]

_ARCHS = ("llama3.2-3b", "mamba2-780m")
_MAX_SEQ = 96
_N = 5       # requests of each scenario kind
_SEED = 3


def run_scenarios(cfg, params, kinds, *, slots: int, max_seq: int,
                  device) -> dict:
    """Serve ``_N`` requests of each scenario kind through a replicated
    ``ContinuousBatcher``; raise unless every request finished with a
    reason and a first-token time and some tokens were decoded.  Prints
    one line a kind; returns {kind: (requests, stats)}."""
    from repro_torch.serve import ContinuousBatcher, make_scenario
    out = {}
    for kind in kinds:
        reqs = make_scenario(cfg, kind=kind, n=_N, seed=_SEED,
                             max_seq=max_seq)
        eng = ContinuousBatcher(params, cfg, slots=slots, max_seq=max_seq,
                                device=device)
        done, stats = eng.run(reqs)
        if len(done) != len(reqs):
            raise RuntimeError(f"{kind}: {len(done)}/{len(reqs)} done")
        if stats["decode_tokens"] <= 0:
            raise RuntimeError(f"{kind}: no decode tokens")
        for r in done:
            if not r.done or r.finish_reason is None:
                raise RuntimeError(f"{kind}: request {r.rid} unfinished")
            if r.t_first is None:
                raise RuntimeError(f"{kind}: request {r.rid} missing "
                                   f"first-token time")
        print(f"  {cfg.family:6s} {kind:13s} "
              f"{stats['decode_tokens']:4d} tok  "
              f"{stats['tok_per_s']:.1f} tok/s (smoke: wall time, prefills "
              f"included)", flush=True)
        out[kind] = (done, stats)
    return out


def _identity_requests(cfg):
    from repro_torch.serve import make_scenario
    return make_scenario(cfg, kind="short_chat", n=6, seed=7,
                         max_seq=_MAX_SEQ)


def _zero3_rank(ckpt_dir: str, arch: str, n: int, N: int, device) -> dict:
    """One rank of the identity leg's world: the checkpoint served under
    lane_zero3 over the (n × N) topology; {rid: tokens}."""
    from repro_torch.configs import resolve
    from repro_torch.launch.mesh import new_lane_topology
    from repro_torch.serve import ContinuousBatcher, load_serve_params
    cfg = resolve(arch, smoke=True)
    params, _ = load_serve_params(ckpt_dir, cfg, device=device)
    eng = ContinuousBatcher(params, cfg, slots=8, max_seq=_MAX_SEQ,
                            hosting="lane_zero3",
                            topo=new_lane_topology(n, N), device=device)
    done, stats = eng.run(_identity_requests(cfg))
    if stats["hosting"] != "lane_zero3":
        raise RuntimeError(f"hosting {stats['hosting']!r}, expected "
                           f"lane_zero3")
    return {r.rid: list(r.out) for r in done}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve."
                                      "serve_smoke")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    import torch

    from repro_torch.configs import resolve
    from repro_torch.launch import train
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import init_model
    from repro_torch.serve import (ContinuousBatcher, SCENARIO_KINDS,
                                   load_serve_params)
    dev = args.device
    fails = []

    def _leg(name, fn):
        print(f"=== serve-smoke {name} ===", flush=True)
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — each leg reports
            fails.append(name)
            print(f"FAIL {name}: {e!r}", flush=True)
        else:
            print(f"PASS {name}", flush=True)

    def _scenarios():
        for arch in _ARCHS:
            cfg = resolve(arch, smoke=True)
            run_scenarios(cfg, init_model(cfg, seed=0, device=dev),
                          SCENARIO_KINDS, slots=3, max_seq=_MAX_SEQ,
                          device=dev)

    _leg("scenario_sweep[dense,ssm]", _scenarios)

    arch = _ARCHS[0]
    cfg = resolve(arch, smoke=True)
    served = {}
    with tempfile.TemporaryDirectory(prefix="serve_smoke_") as td:
        ck = f"{td}/ck"

        def _ckpt():
            losses = train.main(["--arch", arch, "--smoke", "--batch", "8",
                                 "--seq", "32", "--ckpt", ck, "--steps",
                                 "2", "--ckpt-every", "2", "--gradsync",
                                 "native", "--device", dev])
            if len(losses) != 2 or \
                    not torch.isfinite(torch.tensor(losses)).all():
                raise RuntimeError(f"training run gave losses {losses}")
            params, step = load_serve_params(ck, cfg, device=dev)
            if step != 2:
                raise RuntimeError(f"loaded step {step}, expected 2")
            eng = ContinuousBatcher(params, cfg, slots=2,
                                    max_seq=_MAX_SEQ, device=dev)
            done, _ = eng.run(_identity_requests(cfg))
            if not all(r.done for r in done):
                raise RuntimeError("replicated engine left requests undone")
            served.update({r.rid: list(r.out) for r in done})
            print(f"  ckpt step {step} -> replicated, {len(done)} "
                  f"requests", flush=True)

        _leg("ckpt_to_serve[dense]", _ckpt)

        def _identity():
            if not served:
                raise RuntimeError("no replicated tokens: the checkpoint "
                                   "leg failed")
            n, N = (2, 2) if dev == "cpu" else (1, 1)
            ranks = spawn(_zero3_rank, n * N, ck, arch, n, N, dev,
                          device=dev)
            for r, got in enumerate(ranks):
                if got != served:
                    diff = {k: (served[k], got.get(k)) for k in served
                            if got.get(k) != served[k]}
                    raise RuntimeError(f"rank {r}: lane_zero3 != "
                                       f"replicated: {diff}")
            print(f"  replicated == lane_zero3 on {n} x {N} ranks over "
                  f"{len(served)} requests", flush=True)

        _leg("zero3_identity[dense]", _identity)

    print(f"serve-smoke: {3 - len(fails)}/3 legs OK"
          + (f"; FAILED {fails}" if fails else ""))
    return len(fails)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
