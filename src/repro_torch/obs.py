"""Spans and counters where the program's work runs, on the profiler's
clock.

  span(name)                 a ``torch.profiler.record_function`` range
                             while the profiler records, else (or for
                             ``name`` None) a shared no-op context: off,
                             a span costs one flag check
  backward_span(name, x)     ``(x, close)``: the autograd backward between
                             ``close(y)`` and ``x`` runs under the range
                             ``name``; two identity ``autograd.Function``
                             nodes open and close it, and they are built
                             only while the profiler records and ``x``
                             needs a gradient
  backward_until_end(name, y)  ``y``, whose backward runs under the range
                             ``name`` from its first node until the
                             engine's final callback; one identity node,
                             built as above
  count(name, value)         adds ``value`` (an int, or a tensor's sum,
                             taken on its device without a host read) to
                             a named counter, only while the profiler
                             records: off, it does nothing
  counters()                 ``{name: int}``, every device sum read in one
                             transfer; ``reset_counters()`` clears them

A range holds only the device work launched from the thread that opened
it.  With CUDA tensors autograd runs the backward on its own device
thread, so a backward range is opened and closed by the backward's own
nodes, on that thread.  The counters are this process's, kept from the
first count until ``reset_counters()``.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

__all__ = ["recording", "span", "backward_span", "backward_until_end",
           "count", "counters", "reset_counters"]

_OFF = contextlib.nullcontext()
_COUNTS: dict = {}


def recording() -> bool:
    """Whether a profiler records on this thread."""
    return torch._C._autograd._profiler_enabled()


def span(name):
    """A context in which the launched work is attributed to ``name``;
    ``None`` names no span."""
    return record_function(name) if name and recording() else _OFF


class _Close(torch.autograd.Function):
    """Identity on the bracketed block's input; its backward, the last of
    the block's, closes the range."""

    @staticmethod
    def forward(ctx, x, held):
        ctx.held = held
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        rf = ctx.held.pop("range", None)
        if rf is not None:
            rf.__exit__(None, None, None)
        return g, None


class _Open(torch.autograd.Function):
    """Identity on the bracketed block's output; its backward, the first
    of the block's, opens the range."""

    @staticmethod
    def forward(ctx, y, held):
        ctx.held = held
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        rf = record_function(ctx.held["name"])
        rf.__enter__()
        ctx.held["range"] = rf
        return g, None


class _OpenUntilEnd(torch.autograd.Function):
    """Identity on a backward's root; its backward, the backward's first
    node, opens the range and queues its close after the last node."""

    @staticmethod
    def forward(ctx, y, name):
        ctx.name = name
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        rf = record_function(ctx.name)
        rf.__enter__()
        torch.autograd.Variable._execution_engine.queue_callback(
            lambda: rf.__exit__(None, None, None))
        return g, None


def _same(y):
    return y


def backward_span(name: str, x):
    """``(x, close)`` for a block from ``x`` to its output ``y``: pass the
    block ``x`` as returned and return ``close(y)``.  The backward's
    nodes run in the reverse order of their creation, so every node of
    the block, and nothing after it, runs between ``y``'s marker and
    ``x``'s.  Off, ``x`` is returned as it is and ``close`` is the
    identity."""
    if not (recording() and torch.is_grad_enabled() and x.requires_grad):
        return x, _same
    held = {"name": name}
    return _Close.apply(x, held), lambda y: _Open.apply(y, held)


def backward_until_end(name: str, y):
    """``y``, whose backward (from ``y`` on, to its end) runs under the
    range ``name``; off, or where ``y`` needs no gradient, ``y`` itself."""
    if not (recording() and torch.is_grad_enabled() and y.requires_grad):
        return y
    return _OpenUntilEnd.apply(y, name)


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while the profiler records;
    a tensor adds its sum, as an int64 on its device."""
    if not recording():
        return
    if isinstance(value, torch.Tensor):
        value = value.detach().sum(dtype=torch.int64)
    _COUNTS[name] = _COUNTS.get(name, 0) + value


def counters() -> dict:
    """``{name: int}`` of every counter, the device sums read at once."""
    sums = [v for v in _COUNTS.values() if isinstance(v, torch.Tensor)]
    read = iter(torch.stack(sums).tolist() if sums else ())
    return {n: int(next(read) if isinstance(v, torch.Tensor) else v)
            for n, v in _COUNTS.items()}


def reset_counters() -> None:
    _COUNTS.clear()
