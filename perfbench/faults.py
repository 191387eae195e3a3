"""Faults planted underneath the timed path, for the checks that the
comparison catches them (``calibrate.py`` on the card, the CPU tests).
The benchmark's own runs never plant one.

  unchanged    AdamW returns the state it was given: the step leaves
               the parameters and the moments as they were
  half_batch   the step trains on the first half of its rows, the mean
               taken over those
  no_exchange  the gradient sync returns each rank's own gradient
  altered      the step's answer is altered where it is produced: the
               first matrix of the first layer comes back moved twice
               as far as the update moved it
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")


def _first_matrix(params):
    from repro_torch import _tree
    return next(leaf for path, leaf in _tree.flatten(params)
                if path[:2] == ("blocks", 0) and leaf.ndim >= 2)


def _wrap_steps(wrap):
    from repro_torch.launch import steps as S
    build = S.build_train_step

    def built(*args, **kw):
        return wrap(build(*args, **kw))
    return built


@contextlib.contextmanager
def planted(fault: str):
    from repro_torch.comm import LaneComm
    from repro_torch.launch import steps as S
    saved = (S.adamw_update, S.build_train_step, LaneComm.grad_sync)
    if fault == "unchanged":
        S.adamw_update = lambda cfg, grads, state, params, **kw: \
            (params, state)
    elif fault == "half_batch":
        def half(step):
            def f(params, opt_state, tokens, labels, extra=None):
                h = tokens.shape[0] // 2
                return step(params, opt_state, tokens[:h], labels[:h])
            return f
        S.build_train_step = _wrap_steps(half)
    elif fault == "no_exchange":
        LaneComm.grad_sync = lambda self, grads, **kw: grads
    elif fault == "altered":
        def double(step):
            def f(params, opt_state, *args, **kw):
                w = _first_matrix(params)
                before = w.detach().clone()
                loss, params, opt_state = step(params, opt_state, *args,
                                               **kw)
                with torch.no_grad():
                    w.add_(w - before)
                return loss, params, opt_state
            return f
        S.build_train_step = _wrap_steps(double)
    else:
        raise ValueError(f"fault {fault!r} not in {FAULTS}")
    try:
        yield
    finally:
        S.adamw_update, S.build_train_step, LaneComm.grad_sync = saved
