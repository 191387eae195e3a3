"""Checkpoint shard-layout adapters: canonical on disk, sharded in memory.

Counterpart of ``repro.checkpoint.layouts``, the same classes and
arithmetic on host numpy arrays.

The ZeRO train steps keep their master state in topology-dependent
layouts: ZeRO-1 moments as a node-sharded bucket-major flat vector,
ZeRO-3 layer stacks in the (L, B, p, s) master layout of
``models.blockstack.shard_stack``, and B, p and the padding change with
the topology.  So the store canonicalizes: every master leaf is written
in a topology-free canonical form (the unpadded flat element order of
the parameter tree, ``repro``'s flat order) and restore re-pads and
re-shapes it into the layout of the current topology.  Both directions
are pure reshapes and transposes, so a checkpoint written at p processes
restores bit-identically at p'.

A leaf's path is the tuple of dict keys and sequence indices from the
root of the tree the store writes (``repro``'s stacked layout: see
``launch.steps.state_to_host``); ``Zero3CheckpointLayout`` matches the
names ``"blocks"`` and ``"extras"`` along it, ``Zero1CheckpointLayout``
the last name ``"m"`` or ``"v"``, as ``repro`` matches them in a JAX key
path.
"""
from __future__ import annotations

import numpy as np

__all__ = ["CheckpointLayout", "Zero1CheckpointLayout",
           "Zero3CheckpointLayout", "REPLICATED",
           "concat_flat_order", "split_flat_order"]


class CheckpointLayout:
    """Identity layout: every leaf is already canonical (replicated
    trees).  Base class of the shard-aware layouts below; the store calls
    ``to_canonical`` / ``from_canonical`` per leaf with the leaf's path,
    and records / validates ``manifest_entry``."""

    kind = "replicated"

    def manifest_entry(self) -> dict:
        return {"kind": self.kind}

    def check_manifest(self, entry: dict) -> None:
        """Raise ValueError when a checkpoint's recorded layout is not
        restorable under this layout (kind or canonical-geometry drift).
        Manifests without a layout field count as replicated."""
        got = (entry or {}).get("kind", "replicated")
        if got != self.kind:
            raise ValueError(
                f"checkpoint layout mismatch: manifest records layout "
                f"{got!r} but restore was asked for {self.kind!r}; "
                f"restore with the layout of the run that WROTE the "
                f"checkpoint (strategy layouts: LaneComm.param_layout)")

    def to_canonical(self, path, leaf):
        return leaf

    def from_canonical(self, path, leaf):
        return leaf


REPLICATED = CheckpointLayout()


class Zero1CheckpointLayout(CheckpointLayout):
    """ZeRO-1 flat optimizer moments (``m`` / ``v``): the padded flat
    vector of ``gradsync.zero1_param_shard``'s layout, host-global shape
    (n·K·s,) in (process, bucket, s) order.  Canonical form: the unpadded
    flat parameter order, i.e. the (K, n, s) <- (n, K, s) transpose
    ``gradsync.zero1_unshard`` performs, then the padding stripped."""

    kind = "zero1"

    def __init__(self, total_elems: int, num_buckets: int, n: int):
        if total_elems <= 0 or num_buckets < 1 or n < 1:
            raise ValueError((total_elems, num_buckets, n))
        self.total_elems = int(total_elems)
        self.num_buckets = int(num_buckets)
        self.n = int(n)
        self.padded = -(-self.total_elems
                        // (num_buckets * n)) * (num_buckets * n)
        self.shard_elems = self.padded // (num_buckets * n)   # s

    def manifest_entry(self) -> dict:
        return {"kind": self.kind, "total_elems": self.total_elems,
                "num_buckets": self.num_buckets, "n": self.n}

    def check_manifest(self, entry: dict) -> None:
        super().check_manifest(entry)
        want = entry.get("total_elems", self.total_elems)
        if want != self.total_elems:
            raise ValueError(
                f"zero1 checkpoint holds {want} canonical elements but "
                f"the restoring run expects {self.total_elems} (different "
                f"model?)")

    def _is_master(self, path, leaf) -> bool:
        return bool(path) and path[-1] in ("m", "v") \
            and getattr(leaf, "ndim", None) == 1

    def to_canonical(self, path, leaf):
        if not (self._is_master(path, leaf)
                and leaf.shape[0] == self.padded):
            return leaf
        a = np.asarray(leaf)
        K, n, s = self.num_buckets, self.n, self.shard_elems
        return np.ascontiguousarray(
            a.reshape(n, K, s).transpose(1, 0, 2)).reshape(-1)[
                :self.total_elems]

    def from_canonical(self, path, leaf):
        if not (self._is_master(path, leaf)
                and leaf.shape[0] == self.total_elems):
            return leaf
        a = np.asarray(leaf)
        pad = self.padded - self.total_elems
        if pad:
            a = np.concatenate([a, np.zeros((pad,), a.dtype)])
        K, n, s = self.num_buckets, self.n, self.shard_elems
        return np.ascontiguousarray(
            a.reshape(K, n, s).transpose(1, 0, 2)).reshape(-1)


class Zero3CheckpointLayout(CheckpointLayout):
    """ZeRO-3 stack masters (params ``blocks`` / ``extras`` and their
    moments): host-global shape the (L, B, p, s) of ``shard_stack``.  That
    layout is already the per-layer flat (bucket, process, s) element
    order ``gradsync.zero3_unshard`` reassembles, so canonicalization is a
    reshape to (L, B·p·s) and the padding stripped: canonical form (L,
    layer_elems).  The ``extras`` pseudo-layer has its own geometry
    (``extra_elems`` / ``extra_blocks``, master (1, Be, p, se)).

    ``ep``: the expert-parallel flavour.  Its MoE expert FFN leaves live
    outside the flat stack, under an ``experts`` params / moments
    subtree whose natural (L, E, ...) shapes are canonical (passed through
    as they are: neither ``_in_blocks`` nor ``_in_extras`` matches them).
    The flag changes ``layer_elems``, so it is recorded in the manifest
    and checked on restore like the rest of the canonical geometry."""

    kind = "zero3"

    def __init__(self, num_layers: int, layer_elems: int, num_blocks: int,
                 num_shards: int, extra_elems: int = 0,
                 extra_blocks: int = 0, ep: bool = False):
        if min(num_layers, layer_elems, num_blocks, num_shards) < 1:
            raise ValueError((num_layers, layer_elems, num_blocks,
                              num_shards))
        self.ep = bool(ep)
        if (extra_elems > 0) != (extra_blocks > 0):
            raise ValueError((extra_elems, extra_blocks))
        self.num_layers = int(num_layers)                  # L
        self.layer_elems = int(layer_elems)                # D (unpadded)
        self.num_blocks = int(num_blocks)                  # B
        self.num_shards = int(num_shards)                  # p = n·N
        bp = self.num_blocks * self.num_shards
        padded = -(-self.layer_elems // bp) * bp
        self.shard_elems = padded // bp                    # s
        self.master_shape = (self.num_layers, self.num_blocks,
                             self.num_shards, self.shard_elems)
        self.extra_elems = int(extra_elems)                # De (unpadded)
        self.extra_blocks = int(extra_blocks)              # Be
        if self.extra_elems:
            bpe = self.extra_blocks * self.num_shards
            padded_e = -(-self.extra_elems // bpe) * bpe
            self.extra_shard_elems = padded_e // bpe       # se
            self.extra_master_shape = (1, self.extra_blocks,
                                       self.num_shards,
                                       self.extra_shard_elems)
        else:
            self.extra_shard_elems = 0
            self.extra_master_shape = None

    def manifest_entry(self) -> dict:
        entry = {"kind": self.kind, "num_layers": self.num_layers,
                 "layer_elems": self.layer_elems,
                 "num_blocks": self.num_blocks,
                 "num_shards": self.num_shards}
        if self.extra_elems:
            entry["extra_elems"] = self.extra_elems
            entry["extra_blocks"] = self.extra_blocks
        if self.ep:
            entry["ep"] = True
        return entry

    def check_manifest(self, entry: dict) -> None:
        super().check_manifest(entry)
        if bool(entry.get("ep", False)) != self.ep:
            raise ValueError(
                f"zero3 checkpoint ep={bool(entry.get('ep', False))} but "
                f"the restoring layout has ep={self.ep}; an expert-"
                f"parallel flavor change restores through the canonical "
                f"form (launch.steps.restore_lane_train_state), not the "
                f"same-layout fast path")
        for field in ("num_layers", "layer_elems", "extra_elems"):
            want = entry.get(field, 0 if field == "extra_elems"
                             else getattr(self, field))
            if want != getattr(self, field):
                raise ValueError(
                    f"zero3 checkpoint {field}={want} but the restoring "
                    f"run expects {getattr(self, field)} (different "
                    f"model?); num_blocks/num_shards MAY differ (elastic "
                    f"restore), canonical geometry may not")

    def _in_blocks(self, path) -> bool:
        return "blocks" in path

    def _in_extras(self, path) -> bool:
        return "extras" in path

    def to_canonical(self, path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if self._in_blocks(path) and shape == self.master_shape:
            a = np.asarray(leaf)
            return np.ascontiguousarray(
                a.reshape(self.num_layers, -1)[:, :self.layer_elems])
        if self.extra_elems and self._in_extras(path) \
                and shape == self.extra_master_shape:
            a = np.asarray(leaf)
            return np.ascontiguousarray(
                a.reshape(1, -1)[:, :self.extra_elems])
        return leaf

    def from_canonical(self, path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if self._in_blocks(path) \
                and shape == (self.num_layers, self.layer_elems):
            return self._pad_to_master(leaf, self.master_shape,
                                       self.layer_elems)
        if self.extra_elems and self._in_extras(path) \
                and shape == (1, self.extra_elems):
            return self._pad_to_master(leaf, self.extra_master_shape,
                                       self.extra_elems)
        return leaf

    @staticmethod
    def _pad_to_master(leaf, master_shape, elems):
        a = np.asarray(leaf)
        pad = master_shape[1] * master_shape[2] * master_shape[3] - elems
        if pad:
            a = np.concatenate(
                [a, np.zeros((master_shape[0], pad), a.dtype)], axis=1)
        return np.ascontiguousarray(a).reshape(master_shape)


# ---------------------------------------------------------------------------
# the canonical flat order (cross-layout restore primitives)
# ---------------------------------------------------------------------------
#
# Every layout above canonicalizes to the same element order: the
# unpadded flat concatenation of the parameter tree's leaves, leaf by
# leaf, row-major.  A checkpoint written under one strategy layout
# restores into another by lifting the canonical arrays to the
# replicated tree with these helpers and laying them out again for the
# destination (launch/steps.py: restore_lane_train_state).

def concat_flat_order(leaves) -> np.ndarray:
    """Leaves -> ONE unpadded f32 canonical flat vector (the
    ``gradsync._flatten_bucket`` element order, on the host)."""
    if not leaves:
        return np.zeros((0,), np.float32)
    return np.concatenate(
        [np.asarray(l).reshape(-1).astype(np.float32) for l in leaves])


def split_flat_order(flat, shapes, dtypes=None) -> list:
    """Inverse of :func:`concat_flat_order`: split a canonical flat
    vector back into leaves of ``shapes`` (cast to ``dtypes`` when
    given).  Raises ValueError when the element counts disagree."""
    flat = np.asarray(flat).reshape(-1)
    total = sum(int(np.prod(s)) for s in shapes)
    if flat.shape[0] != total:
        raise ValueError(
            f"canonical flat vector holds {flat.shape[0]} elements but "
            f"the target leaves need {total} (different model?)")
    out, ofs = [], 0
    for i, s in enumerate(shapes):
        sz = int(np.prod(s))
        leaf = flat[ofs:ofs + sz].reshape(s)
        if dtypes is not None:
            leaf = leaf.astype(dtypes[i])
        out.append(leaf)
        ofs += sz
    return out
