"""Elastic topology: survive the loss of processes by shrinking the batch
level.

Counterpart of ``repro.runtime.elastic``.  ``plan_elastic_mesh`` is pure
topology math, ``repro``'s, with its errors.  ``ElasticMesh.make`` cannot
build a jax mesh here: it makes the survivors' lane topology
(``launch.mesh.new_lane_topology`` over the surviving lanes).

Policy:
  * the ``model`` axis is kept whole: losing one process of a replica
    group drops that whole slice of the outer batch axis, so a re-plan
    only ever shrinks the outer batch axis (``pod``, else ``data``);
  * the survivors keep their world ranks, ``(pod·d + data)·m + model``,
    which is ``repro``'s flat device index of the same mesh; the outer
    level renumbers over the surviving slices;
  * the state re-enters through the checkpoint restore across rank counts
    (``launch.steps.restore_lane_train_state``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["ElasticMesh", "plan_elastic_mesh"]


@dataclasses.dataclass(frozen=True)
class ElasticMesh:
    """A re-planned mesh: ``repro``'s fields, and ``lanes``, the outer
    coordinates of the original mesh that survive, in order (the new
    outer index j is original slice ``lanes[j]``)."""
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    lost: tuple[int, ...]          # flat indices (world ranks) lost
    global_batch_scale: float      # new outer size / old outer size
    lanes: tuple[int, ...] = ()

    def make(self):
        """``(topology, single)`` of the survivors in the started world:
        the topology on a surviving process, None on a lost one.  Every
        process of the current topology calls it (lost ones return at
        once).  ``single``: the outer axis is ``data`` (one batch axis,
        n = 1); with a ``pod`` axis the node level is ``data`` and the
        lane level ``pod``, also when one pod is left."""
        from repro_torch.launch.mesh import new_lane_topology
        sizes = dict(zip(self.axis_names, self.shape))
        m = sizes.get("model", 1)
        if "pod" in sizes:
            return new_lane_topology(sizes["data"], sizes["pod"], replicas=m,
                                     lanes=self.lanes), False
        return new_lane_topology(1, sizes["data"], replicas=m,
                                 lanes=self.lanes), True


def plan_elastic_mesh(axis_names: Sequence[str], shape: Sequence[int],
                      lost_flat_indices: Sequence[int]) -> ElasticMesh:
    """Given lost flat indices, shrink the outer batch axis to exclude
    them.

    Returns the largest surviving mesh with the same axis names and the
    same inner axis sizes.  Raises ``ValueError`` when there is no batch
    axis, or when every slice of the outer batch axis holds a lost index.
    """
    axis_names = tuple(axis_names)
    shape = list(shape)
    lost = set(int(i) for i in lost_flat_indices)
    batch_axes = [a for a in ("pod", "data") if a in axis_names]
    if not lost:
        lanes = range(shape[axis_names.index(batch_axes[0])]) \
            if batch_axes else ()
        return ElasticMesh(axis_names, tuple(shape), (), 1.0, tuple(lanes))

    # flat index -> coordinates (row-major over axes)
    def coords(i):
        out = []
        for s in reversed(shape):
            out.append(i % s)
            i //= s
        return tuple(reversed(out))

    if not batch_axes:
        raise ValueError("no batch axis to shrink")
    # drop every slice of the outermost batch axis that holds a lost
    # index
    outer = axis_names.index(batch_axes[0])
    bad = sorted({coords(i)[outer] for i in lost})
    new_size = shape[outer] - len(bad)
    if new_size < 1:
        raise ValueError("all slices of the outer batch axis lost")
    scale = new_size / shape[outer]
    new_shape = list(shape)
    new_shape[outer] = new_size
    lanes = tuple(c for c in range(shape[outer]) if c not in bad)
    return ElasticMesh(axis_names, tuple(new_shape), tuple(sorted(lost)),
                       scale, lanes)
