"""Single-process oracles for every collective (numpy).

Each oracle takes the stacked per-rank inputs ``xs`` with leading axis =
global rank (paper's consecutive ranking: rank = lane_rank·n + node_rank)
and returns the stacked per-rank expected outputs.  Tests compare the
process-group mock-ups and natives against these.  A copy of
``repro.core.ref``, which imports no JAX either; the port keeps its own
so that it imports nothing of ``repro``, and a test holds the two equal.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "oracle_allreduce", "oracle_reduce_scatter", "oracle_allgather",
    "oracle_bcast", "oracle_alltoall", "oracle_reduce", "oracle_gather",
    "oracle_scatter", "oracle_scan",
]


def oracle_allreduce(xs: np.ndarray) -> np.ndarray:
    total = xs.sum(axis=0)
    return np.broadcast_to(total, xs.shape).copy()


def oracle_reduce_scatter(xs: np.ndarray) -> np.ndarray:
    """xs: (p, p*m, ...). out[r] = sum_r' xs[r'][r*m:(r+1)*m]."""
    p = xs.shape[0]
    assert xs.shape[1] % p == 0
    m = xs.shape[1] // p
    total = xs.sum(axis=0)
    return np.stack([total[r * m:(r + 1) * m] for r in range(p)])


def oracle_allgather(xs: np.ndarray) -> np.ndarray:
    """xs: (p, m, ...). out[r] = concat_r' xs[r'] for every r."""
    p = xs.shape[0]
    cat = xs.reshape(p * xs.shape[1], *xs.shape[2:])
    return np.broadcast_to(cat, (p, *cat.shape)).copy()


def oracle_bcast(xs: np.ndarray, root: int = 0) -> np.ndarray:
    return np.broadcast_to(xs[root], xs.shape).copy()


def oracle_alltoall(xs: np.ndarray) -> np.ndarray:
    """xs: (p, p*m, ...). out[r] = concat_j xs[j][r*m:(r+1)*m]."""
    p = xs.shape[0]
    m = xs.shape[1] // p
    out = np.empty_like(xs)
    for r in range(p):
        out[r] = np.concatenate([xs[j][r * m:(r + 1) * m] for j in range(p)])
    return out


def oracle_reduce(xs: np.ndarray, root: int = 0) -> np.ndarray:
    out = np.zeros_like(xs)
    out[root] = xs.sum(axis=0)
    return out


def oracle_gather(xs: np.ndarray, root: int = 0) -> np.ndarray:
    p = xs.shape[0]
    out = np.zeros((p, p * xs.shape[1], *xs.shape[2:]), dtype=xs.dtype)
    out[root] = xs.reshape(p * xs.shape[1], *xs.shape[2:])
    return out


def oracle_scan(xs: np.ndarray) -> np.ndarray:
    """Inclusive scan: out[r] = sum_{r' <= r} xs[r']."""
    return np.cumsum(xs, axis=0)


def oracle_scatter(xs: np.ndarray, root: int = 0) -> np.ndarray:
    p = xs.shape[0]
    m = xs.shape[1] // p
    return np.stack([xs[root][r * m:(r + 1) * m] for r in range(p)])
