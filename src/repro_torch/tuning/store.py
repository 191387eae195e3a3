"""Persistent tuning cache: JSON + crc32, atomic commit, verified load.

Counterpart of ``repro.tuning.store``, writing the same bytes for the
same entries, so either package reads the other's file.  It mirrors the
checkpoint store's integrity discipline
(:mod:`repro_torch.checkpoint.store`): the document embeds a crc32 of its
canonically-serialized payload, writes go through a ``.tmp`` →
``os.replace`` commit (a crash mid-write never leaves a half-written
cache where the next launch will read it), and loads re-verify the crc
before a single entry reaches dispatch.  A cache that fails ANY check
raises :class:`TuningCacheError` from the strict loader — and the
dispatch-facing :func:`load_timing_table_or_none` converts every
failure into None, because a rotted tuning cache must degrade a run to
closed-form costs, never crash it.

The canonical serialization (sorted keys, fixed separators) plus the
table's key-sorted ``to_doc`` make the file a pure function of its
entries: save → load → save reproduces the bytes exactly, which is what
lets the cache ride along in the checkpoint directory and be compared
bit-for-bit across restores.
"""
from __future__ import annotations

import json
import pathlib
import zlib
from typing import Optional, Union

from .table import TimingTable

__all__ = [
    "TuningCacheError", "save_timing_table", "load_timing_table",
    "load_timing_table_or_none", "load_misses", "DEFAULT_CACHE_NAME",
]

FORMAT_VERSION = 1
DEFAULT_CACHE_NAME = "tuning_cache.json"    # lives beside the checkpoints


class TuningCacheError(RuntimeError):
    """The tuning cache failed an integrity or schema check: missing
    file, unparseable JSON, crc32 mismatch, unknown format version, or
    a malformed entry row."""


def _canon(payload) -> str:
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def save_timing_table(path: Union[str, pathlib.Path],
                      table: TimingTable,
                      misses=None) -> pathlib.Path:
    """Atomically write ``table`` to ``path`` (parents created).

    ``misses`` — optional iterable of ``(collective, strategy, n, N,
    payload_bytes)`` cache-miss tuples accumulated by a
    :class:`~repro_torch.tuning.table.Tuner`; persisted (deduplicated, sorted)
    so the next ``--tune`` launch can re-probe exactly the payloads
    dispatch asked for.  The key is serialized ONLY when non-empty, so a
    miss-free save of a loaded table reproduces the original bytes
    (the byte-identity property above).
    """
    payload = {"version": FORMAT_VERSION, "entries": table.to_doc()}
    rows = sorted(dict.fromkeys(tuple(m) for m in (misses or ())))
    if rows:
        payload["misses"] = [list(r) for r in rows]
    body = _canon(payload)
    doc = {"crc32": zlib.crc32(body.encode("utf-8")), "payload": payload}
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + ".tmp")
    tmp.write_text(_canon(doc))
    tmp.replace(p)              # the commit point, same as the ckpt store
    return p


def load_timing_table(path: Union[str, pathlib.Path]) -> TimingTable:
    """Strict load: verify crc32 + version + row schema or raise
    :class:`TuningCacheError` (the probe and training paths want the real
    reason; dispatch wants :func:`load_timing_table_or_none`)."""
    p = pathlib.Path(path)
    if not p.exists():
        raise TuningCacheError(f"tuning cache {p} does not exist")
    try:
        doc = json.loads(p.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise TuningCacheError(f"tuning cache {p} unreadable: {e}")
    if not isinstance(doc, dict) or "payload" not in doc \
            or "crc32" not in doc:
        raise TuningCacheError(f"tuning cache {p} missing payload/crc32")
    payload = doc["payload"]
    want = zlib.crc32(_canon(payload).encode("utf-8"))
    if int(doc["crc32"]) != want:
        raise TuningCacheError(
            f"tuning cache {p} failed its crc32 check "
            f"(stored {doc['crc32']}, recomputed {want}) — the file "
            f"rotted or was hand-edited; delete it and re-probe")
    if payload.get("version") != FORMAT_VERSION:
        raise TuningCacheError(
            f"tuning cache {p} has format version "
            f"{payload.get('version')!r}, this build reads "
            f"{FORMAT_VERSION}")
    try:
        return TimingTable.from_doc(payload.get("entries", []))
    except ValueError as e:
        raise TuningCacheError(f"tuning cache {p}: {e}")


def load_misses(path: Union[str, pathlib.Path]) -> list:
    """The persisted cache-miss worklist, as ``(collective, strategy,
    n, N, payload_bytes)`` tuples.  Empty list when the cache is
    missing, corrupt, or carries no ``misses`` key — misses are
    advisory (a re-probe hint), so unlike the entries themselves a
    rotten worklist never blocks a launch."""
    p = pathlib.Path(path)
    if not p.exists():
        return []
    try:
        doc = json.loads(p.read_text())
        payload = doc["payload"]
        if int(doc["crc32"]) != zlib.crc32(_canon(payload).encode("utf-8")):
            return []
        rows = payload.get("misses", [])
        return [(str(c), str(s), int(n), int(N), int(b))
                for c, s, n, N, b in rows]
    except (OSError, ValueError, KeyError, TypeError):
        return []


def load_timing_table_or_none(
        path: Union[str, pathlib.Path]) -> Optional[TimingTable]:
    """Dispatch-facing load: None on ANY failure (missing, corrupt,
    wrong version) — auto-dispatch then runs on the closed-form model,
    which is exactly the no-cache behavior.  The reason is printed once
    so a silently-ignored rotten cache is still visible in logs."""
    try:
        return load_timing_table(path)
    except TuningCacheError as e:
        if pathlib.Path(path).exists():
            print(f"tuning cache ignored: {e}", flush=True)
        return None
