"""Parameter-layout descriptors for the registered train-step strategies.

Counterpart of ``repro.comm.layout``.  A gradsync strategy is more than a
collective schedule: the ZeRO flavors change where the master parameters
and optimizer moments live.  Everything outside the step — the training
loop's state init and, later, the checkpoint store — must agree with the
step on that layout, so every train-step strategy declares its layout
kind via :func:`register_param_layout` (``comm.impls`` registers them
beside the gradient syncs), and :meth:`LaneComm.param_layout
<repro_torch.comm.LaneComm.param_layout>` answers it for a topology.

Kinds:

  replicated  params and optimizer state are ordinary pytrees, identical
              on every chip (native / lane / lane_pipelined / lane_int8 /
              auto).
  zero1       params replicated; optimizer moments are one flat f32
              vector sharded over the node level.
  zero3       layer stack, params and moments, sharded 1/p.

On a single batch axis (one pod) ``repro`` degrades ``lane_zero1`` to
the replicated step; the port's training loop does the same from the
topology's ``single`` flag (``launch.steps.init_lane_train_state``).
"""
from __future__ import annotations

PARAM_LAYOUT_KINDS = ("replicated", "zero1", "zero3")

_TABLE: dict[str, str] = {}


def register_param_layout(strategy: str, kind: str) -> None:
    """Declare the master-parameter layout of one train-step strategy.

    Called next to the strategy's ``@register_impl("train_step", ...)``
    registration; re-registering with a DIFFERENT kind raises (the layout
    is a contract every checkpoint ever written under the strategy
    depends on).
    """
    if kind not in PARAM_LAYOUT_KINDS:
        raise ValueError(
            f"unknown param layout kind {kind!r}; have {PARAM_LAYOUT_KINDS}")
    old = _TABLE.get(strategy)
    if old is not None and old != kind:
        raise ValueError(
            f"train-step strategy {strategy!r} already registered with "
            f"param layout {old!r}; cannot re-register as {kind!r}")
    _TABLE[strategy] = kind


def param_layout_kind(strategy: str) -> str:
    """The registered layout kind for ``strategy`` (topology-blind —
    use :meth:`LaneComm.param_layout` for the degradation-aware answer)."""
    if strategy not in _TABLE:
        raise ValueError(
            f"no param layout registered for train-step strategy "
            f"{strategy!r}; registered: {tuple(_TABLE)}")
    return _TABLE[strategy]
