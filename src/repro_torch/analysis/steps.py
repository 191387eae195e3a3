"""The composed steps of the lanelint step sweep.

Counterpart of ``repro.analysis.steps``.  The per-cell sweep
(``rules.iter_cell_cases``) proves each registered collective alone;
this module runs the COMPOSED surfaces — one train step each of
``lane_pipelined`` and ``lane_zero3``, and one ``lane_zero3`` serve
prefill, splice and decode — under the collective recorder and hands
every rank's footprint to the R1 level-disjointness check.  Volumes are
owned by the cell sweep (a step is a sum of cells), so only
disjointness is checked here; the scalar control traffic a step adds on
top of its cells (the loss mean over the batch ranks, the global-norm
sum) rides the small-payload exemption.

The world is ``repro``'s step grid: 8 gloo ranks in 2 pods (n = 4, N =
2), llama3.2-3b ``--smoke`` in its own dtype, 8 × 8 tokens a train step.
"""
from __future__ import annotations

__all__ = ["sweep_steps", "STEP_NAMES"]

_ARCH = "llama3.2-3b"
_N_NODE, _N_LANE = 4, 2
_BATCH, _SEQ = 8, 8
_GRADSYNCS = ("lane_pipelined", "lane_zero3")
_SERVE = ("prefill", "splice", "decode")

#: the targets of the step sweep, in the order it runs them
STEP_NAMES = tuple(f"train_step/{g}" for g in _GRADSYNCS) \
    + tuple(f"serve_step/lane_zero3:{s}" for s in _SERVE)


def _train_step(topo, cfg, gradsync: str, toks, labels):
    """This rank's footprint of one train step, built the way
    ``launch/train.py`` builds it."""
    import torch

    from repro_torch.comm import CommConfig, LaneComm
    from repro_torch.configs import RunConfig
    from repro_torch.launch.steps import (build_train_step,
                                          init_lane_train_state)
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig

    from .footprint import record_collectives
    run = RunConfig(model=cfg, gradsync=gradsync)
    comm = LaneComm(topo, CommConfig.from_run(run))
    step = build_train_step(run, AdamWConfig(), comm, single=False)
    params = init_model(cfg, seed=0, device="cpu")
    params, opt_state, _ = init_lane_train_state(run, params, comm,
                                                 single=False, device="cpu")
    rows = _BATCH // topo.p()
    r0 = topo.global_rank() * rows
    with torch.enable_grad(), record_collectives() as rec:
        step(params, opt_state, toks[r0:r0 + rows], labels[r0:r0 + rows])
    return rec.footprint(n=topo.n(), num_devices=topo.p())


def _serve_steps(topo, cfg) -> dict:
    """This rank's footprints of one lane_zero3 prefill, splice and
    decode."""
    import torch

    from repro_torch.models import init_model
    from repro_torch.serve.steps import build_serve_step

    from .footprint import record_collectives
    step = build_serve_step(cfg, max_seq=64, slots=8, hosting="lane_zero3",
                            device="cpu", topo=topo)
    hosted = step.prepare(init_model(cfg, seed=0, device="cpu"))
    state = step.init_state()
    toks = torch.arange(1, 9).reshape(1, 8) % cfg.vocab_size
    out = {}
    with record_collectives() as rec:
        _, st1 = step.prefill(hosted, toks, 8)
    out["prefill"] = rec
    with record_collectives() as rec:
        state = step.splice(state, st1, 3)
    out["splice"] = rec
    with record_collectives() as rec:
        step.decode(hosted, torch.ones((8, 1), dtype=torch.long), state)
    out["decode"] = rec
    return {f"serve_step/lane_zero3:{k}":
            r.footprint(n=topo.n(), num_devices=topo.p())
            for k, r in out.items()}


def _steps_rank() -> dict:
    """Every swept step on this rank: {target: footprint}."""
    import numpy as np
    import torch

    from repro_torch.configs import resolve
    from repro_torch.launch.mesh import new_lane_topology
    topo = new_lane_topology(_N_NODE, _N_LANE)
    cfg = resolve(_ARCH, smoke=True)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (_BATCH, _SEQ + 1)).astype(np.int64))
    out = {f"train_step/{g}": _train_step(topo, cfg, g, toks[:, :-1],
                                           toks[:, 1:])
           for g in _GRADSYNCS}
    out.update(_serve_steps(topo, cfg))
    return out


def sweep_steps() -> dict:
    """{target: [rank 0's footprint, ...]} of every swept step, from one
    spawned 8-rank gloo world."""
    from repro_torch.launch.mesh import spawn
    ranks = spawn(_steps_rank, _N_NODE * _N_LANE)
    return {name: [r[name] for r in ranks] for name in STEP_NAMES}
