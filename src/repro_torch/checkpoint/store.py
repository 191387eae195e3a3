"""Atomic, crc-checked, async checkpoints whose files are ``repro``'s.

Counterpart of ``repro.checkpoint.store``, with its layout on disk:

          <dir>/step_<N>/
             manifest.json           step, a description of the tree,
                                     the writer's shard LAYOUT, and per
                                     leaf its shape, dtype and crc32
             arr_<i>.npy             one file per leaf, in the tree's
                                     flat order
          <dir>/step_<N>.tmp/        written first, renamed when complete
          <dir>/step_<N>.old/        the previous committed copy of the
                                     same step, parked for the instant of
                                     an overwrite

The rename is the commit point: a crash mid-write never corrupts the
latest complete checkpoint.  Overwriting a step swaps through ``.old``
(the old copy renamed aside, the new one renamed in, then the old one
removed), so a crash at any instant leaves at least one committed copy,
and the scanner counts a lone ``step_N.old`` as committed.

Integrity: every leaf's crc32 (of its raw buffer) is in the manifest and
checked again on restore; a mismatch or an unreadable file raises
:class:`CheckpointCorruptError`, distinct from the ``ValueError`` of a
geometry mismatch, and ``restore_checkpoint(step=None)`` falls back to
the newest step that verifies.  ``save_checkpoint`` retries ``OSError``
a bounded number of times with exponential backoff.

Trees and leaves.  A tree is nested dicts (walked in sorted key order),
lists and tuples (in order) and leaves, walked by ``repro_torch._tree``,
so its flat order is ``jax.tree.leaves``' on the same structure once no
list of layers is left under a ``"blocks"`` key; the training state is
written in ``repro``'s stacked layout (``launch.steps.state_to_host``),
and then every ``arr_<i>.npy`` equals ``repro``'s byte for byte, and the
manifest's ``step``, ``layout`` and ``leaves`` too (``treedef`` is this
package's description of the tree, which no reader uses).  A leaf may be
a torch tensor (any device), a numpy array or a Python int (an int32
scalar, as ``repro``'s step counts).  Restore returns numpy arrays.

bf16.  numpy has no bfloat16.  ``repro`` writes a bf16 leaf with the
``.npy`` descr ``'<V2'`` (ml_dtypes' bfloat16) and the manifest dtype
``"bfloat16"``; here a bf16 leaf is a numpy array of dtype ``V2`` on the
host (its raw bits), written with that same header, and read back by the
manifest's dtype into ``torch.bfloat16`` (:func:`to_torch`).  ``repro``
itself cannot restore such a leaf: ``np.load`` returns ``|V2``, which
JAX refuses.

:class:`AsyncCheckpointer` writes on a worker thread; ``save`` returns
once it holds its own host copy of every leaf (the train step updates
the parameters and moments in place), and the worker's errors come back
from ``wait()``, the next ``save()`` and ``error``.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import sys
import threading
import time
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import _tree

from .layouts import CheckpointLayout, REPLICATED

__all__ = ["CheckpointCorruptError", "save_checkpoint", "restore_checkpoint",
           "verify_checkpoint", "latest_verified_step", "peek_manifest",
           "load_canonical", "keep_last_k", "committed_steps", "latest_step",
           "step_dir", "AsyncCheckpointer", "host_array", "to_torch",
           "BF16"]

#: host dtype of a bf16 leaf: its raw 16 bits
BF16 = np.dtype("V2")
_BF16_DESCR = "<V2"            # the header ml_dtypes' bfloat16 gives


class CheckpointCorruptError(RuntimeError):
    """A committed checkpoint failed its integrity check: a leaf's crc32
    disagrees with the manifest, a leaf file is missing or unreadable, or
    the manifest cannot be parsed.  Distinct from the ValueErrors of a
    geometry mismatch (wrong model or topology), which the verified
    fallback must never skip."""


# ---------------------------------------------------------------------------
# leaves and trees
# ---------------------------------------------------------------------------

def host_array(leaf, *, copy: bool = False) -> np.ndarray:
    """A leaf as a host numpy array: a tensor from any device (bf16 as
    ``BF16``), a numpy array, or a Python int (an int32 step count).
    ``copy``: never share memory with ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.clone() if copy and t.device.type == "cpu" else t.cpu()
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16)
        return t.numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def to_torch(arr, dtype: Optional[str] = None) -> torch.Tensor:
    """A host leaf (numpy) as a CPU tensor, bf16 when ``arr`` holds raw
    bf16 bits (``BF16``) or ``dtype`` (a manifest dtype) says so."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:       # (ascontiguousarray makes 0-d 1-d)
        arr = arr.copy()
    if arr.dtype == BF16 or dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def dtype_name(arr: np.ndarray) -> str:
    """The manifest dtype of a host leaf (``repro``'s ``str(dtype)``)."""
    return "bfloat16" if arr.dtype == BF16 else str(arr.dtype)


def _describe(paths) -> str:
    return "leaves: " + " ".join("/".join(map(str, p)) or "." for p in paths)


def _crc32(arr: np.ndarray) -> int:
    """crc32 of the raw buffer (read in place, not copied)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _save_npy(path: pathlib.Path, arr: np.ndarray) -> None:
    """``np.save``, except that a bf16 leaf gets ``repro``'s ``'<V2'``
    descr (``np.save`` would write ``'|V2'``)."""
    if arr.dtype != BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr).tobytes())


# ---------------------------------------------------------------------------
# committed steps
# ---------------------------------------------------------------------------

def _parse_step(name: str) -> Optional[int]:
    """``step_<N>`` / ``step_<N>.old`` -> N; anything else -> None."""
    if name.endswith(".old"):
        name = name[:-len(".old")]
    if not name.startswith("step_"):
        return None
    suffix = name[len("step_"):]
    return int(suffix) if suffix.isdigit() else None


def step_dir(ckpt_dir: str, step: int) -> Optional[pathlib.Path]:
    """The committed directory of ``step``: its final name, or the parked
    ``.old`` copy when a crash mid-overwrite left only that; None when
    neither holds a manifest."""
    base = pathlib.Path(ckpt_dir)
    for d in (base / f"step_{step}", base / f"step_{step}.old"):
        if (d / "manifest.json").exists():
            return d
    return None


def committed_steps(ckpt_dir: str) -> list:
    """Sorted committed step numbers (manifest present; ``.old``-only
    counts; other names and in-flight ``.tmp`` directories skipped)."""
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return []
    steps = set()
    for p in base.iterdir():
        if not p.is_dir() or p.name.endswith(".tmp"):
            continue
        s = _parse_step(p.name)
        if s is not None and (p / "manifest.json").exists():
            steps.add(s)
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    layout: Optional[CheckpointLayout] = None, *,
                    attempts: int = 3, backoff_s: float = 0.05,
                    attempt_hook: Optional[Callable[[int], None]] = None
                    ) -> str:
    """Write ``tree`` atomically; master leaves canonicalize through
    ``layout`` (None: replicated, the identity), so the files are
    topology-free.  Every leaf's crc32 goes into the manifest.

    ``OSError`` is retried up to ``attempts`` times with exponential
    backoff from ``backoff_s``, each retry from a clean ``.tmp``; any
    other exception, and an OSError on the last attempt, propagates.
    ``attempt_hook(attempt)`` (0-based) runs at the start of each attempt,
    inside the retried region (fault injection)."""
    layout = layout or REPLICATED
    base = pathlib.Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    tmp = base / f"step_{step}.tmp"
    final = base / f"step_{step}"
    old = base / f"step_{step}.old"
    last_err: Optional[OSError] = None
    for attempt in range(max(attempts, 1)):
        if attempt:
            time.sleep(backoff_s * (2 ** (attempt - 1)))
        try:
            if attempt_hook is not None:
                attempt_hook(attempt)
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            pairs = _tree.flatten(tree)
            manifest = {"step": step,
                        "treedef": _describe(p for p, _ in pairs),
                        "layout": layout.manifest_entry(), "leaves": []}
            for i, (path, leaf) in enumerate(pairs):
                arr = np.asarray(layout.to_canonical(path, host_array(leaf)))
                _save_npy(tmp / f"arr_{i}.npy", arr)
                manifest["leaves"].append({"shape": list(arr.shape),
                                           "dtype": dtype_name(arr),
                                           "crc32": _crc32(arr)})
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            # the overwrite swap: park the committed copy, rename the new
            # one in, then drop the parked copy
            if old.exists():
                shutil.rmtree(old)
            if final.exists():
                final.rename(old)
            tmp.rename(final)                  # commit point
            if old.exists():
                shutil.rmtree(old)
            return str(final)
        except OSError as e:
            last_err = e
            print(f"checkpoint save step {step}: attempt "
                  f"{attempt + 1}/{attempts} failed ({e}); "
                  f"{'retrying' if attempt + 1 < attempts else 'giving up'}",
                  file=sys.stderr, flush=True)
    raise last_err


# ---------------------------------------------------------------------------
# verify and read
# ---------------------------------------------------------------------------

def _read_manifest(d: pathlib.Path) -> dict:
    try:
        return json.loads((d / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest in {d}: {e}") from e


def _load_leaf(d: pathlib.Path, i: int, entry: dict,
               verify: bool) -> np.ndarray:
    try:
        # mapped, checked in place, then copied once into memory
        try:
            arr = np.load(d / f"arr_{i}.npy", mmap_mode="r")
        except ValueError:                 # an empty leaf maps nothing
            arr = np.load(d / f"arr_{i}.npy")
        if verify and entry.get("crc32") is not None \
                and _crc32(arr) != entry["crc32"]:
            raise CheckpointCorruptError(
                f"crc32 mismatch on {d / f'arr_{i}.npy'}: manifest "
                f"{entry['crc32']:#010x}, file {_crc32(arr):#010x}")
        return np.array(arr)
    except CheckpointCorruptError:
        raise
    except Exception as e:  # noqa: BLE001 - any load failure is rot
        raise CheckpointCorruptError(
            f"unreadable leaf {d / f'arr_{i}.npy'}: {e}") from e


def verify_checkpoint(ckpt_dir: str, step: int) -> dict:
    """Check every leaf of one committed step against its manifest crc32.
    Returns the manifest; raises :class:`CheckpointCorruptError` naming
    the first bad leaf (leaves without a crc32 pass)."""
    d = step_dir(ckpt_dir, step)
    if d is None:
        raise FileNotFoundError(f"no committed step {step} in {ckpt_dir}")
    manifest = _read_manifest(d)
    for i, entry in enumerate(manifest["leaves"]):
        if entry.get("crc32") is not None:
            _load_leaf(d, i, entry, True)
    return manifest


def latest_verified_step(ckpt_dir: str) -> Optional[int]:
    """Newest committed step whose every leaf passes its crc32 check;
    None when nothing verifies."""
    for s in reversed(committed_steps(ckpt_dir)):
        try:
            verify_checkpoint(ckpt_dir, s)
            return s
        except CheckpointCorruptError as e:
            print(f"checkpoint step {s} failed verification ({e}); "
                  f"trying an earlier step", file=sys.stderr, flush=True)
    return None


def restore_checkpoint(ckpt_dir: str, tree_like: Any, step: int | None = None,
                       layout: Optional[CheckpointLayout] = None,
                       verify: bool = True) -> tuple[Any, int]:
    """Restore into the structure of ``tree_like`` (whose leaves give the
    shapes: arrays, tensors, or ints for scalars); returns ``(tree of
    numpy arrays, step)``.  ``layout`` is the current run's: the stored
    canonical leaves are laid out through ``layout.from_canonical`` (the
    manifest's layout must agree in kind and canonical geometry; B and p
    may differ).

    With ``verify`` every leaf is crc-checked as it is read.  An explicit
    ``step`` that fails raises :class:`CheckpointCorruptError`;
    ``step=None`` walks the committed steps newest first and restores the
    newest that verifies.  Geometry ValueErrors always propagate."""
    candidates = [step] if step is not None \
        else list(reversed(committed_steps(ckpt_dir)))
    if not candidates:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    last_err: Optional[CheckpointCorruptError] = None
    for s in candidates:
        try:
            return _restore_one(ckpt_dir, tree_like, s, layout, verify)
        except CheckpointCorruptError as e:
            last_err = e
            if step is not None:
                raise
            print(f"checkpoint step {s} is corrupt ({e}); falling back "
                  f"to the previous committed step",
                  file=sys.stderr, flush=True)
    raise CheckpointCorruptError(
        f"no verifiable checkpoint in {ckpt_dir} "
        f"(tried steps {candidates})") from last_err


def _shape(ref) -> tuple:
    return tuple(getattr(ref, "shape", ()))


def _restore_one(ckpt_dir: str, tree_like: Any, step: int,
                 layout: Optional[CheckpointLayout],
                 verify: bool) -> tuple[Any, int]:
    layout = layout or REPLICATED
    d = step_dir(ckpt_dir, step)
    if d is None:
        raise FileNotFoundError(f"no committed step {step} in {ckpt_dir}")
    manifest = _read_manifest(d)
    layout.check_manifest(manifest.get("layout"))
    pairs = _tree.flatten(tree_like)
    if len(manifest["leaves"]) != len(pairs):
        raise ValueError(
            f"checkpoint {d} holds {len(manifest['leaves'])} leaves but "
            f"the restore target tree has {len(pairs)}")
    out = []
    for i, (path, ref) in enumerate(pairs):
        arr = layout.from_canonical(
            path, _load_leaf(d, i, manifest["leaves"][i], verify))
        if tuple(arr.shape) != _shape(ref):
            raise ValueError(
                f"checkpoint leaf {i} ({d / f'arr_{i}.npy'}) restores to "
                f"shape {tuple(arr.shape)} but the target tree expects "
                f"{_shape(ref)}: topology/layout mismatch?")
        out.append(arr)
    return _tree.unflatten(tree_like, out), step


def peek_manifest(ckpt_dir: str, step: int | None = None
                  ) -> tuple[dict, int]:
    """One checkpoint's manifest alone (no arrays): enough to decide the
    layout kind before a full read."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = step_dir(ckpt_dir, step)
    if d is None:
        raise FileNotFoundError(f"no committed step {step} in {ckpt_dir}")
    return _read_manifest(d), step


def load_canonical(ckpt_dir: str, step: int | None = None,
                   verify: bool = True) -> tuple[dict, list, int]:
    """One checkpoint's manifest and its raw canonical leaves
    (crc-checked), with no layout validation: the cross-layout restore
    pairs them with a template of the stored layout.  Returns
    ``(manifest, [numpy arrays], step)``."""
    manifest, step = peek_manifest(ckpt_dir, step)
    d = step_dir(ckpt_dir, step)
    arrays = [_load_leaf(d, i, manifest["leaves"][i], verify)
              for i in range(len(manifest["leaves"]))]
    return manifest, arrays, step


def keep_last_k(ckpt_dir: str, k: int = 3) -> None:
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return
    for s in committed_steps(ckpt_dir)[:-k]:
        shutil.rmtree(base / f"step_{s}", ignore_errors=True)
        shutil.rmtree(base / f"step_{s}.old", ignore_errors=True)


class AsyncCheckpointer:
    """One background writer, at most one save in flight (a later save
    waits for it, which back-pressures rather than stacking host copies).
    ``layout`` goes into every ``save_checkpoint``; ``attempts`` /
    ``backoff_s`` set the retry of every save."""

    def __init__(self, ckpt_dir: str, keep: int = 3,
                 layout: Optional[CheckpointLayout] = None,
                 attempts: int = 3, backoff_s: float = 0.05):
        self.dir = ckpt_dir
        self.keep = keep
        self.layout = layout or REPLICATED
        self.attempts = attempts
        self.backoff_s = backoff_s
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self.records: list = []

    @property
    def error(self) -> Optional[BaseException]:
        """The pending worker failure, if any (read without raising)."""
        return self._err

    def save(self, step: int, tree: Any,
             attempt_hook: Optional[Callable[[int], None]] = None, *,
             copy: bool = True, since: Optional[float] = None) -> None:
        """Copy ``tree`` to the host (a copy of its own, so that in-place
        updates after the return cannot reach the file), then write it on
        the worker.  ``copy=False``: ``tree`` already holds host copies
        that nothing else writes to, made from ``time.perf_counter()``
        ``since``.  ``records`` gets the save's step, the caller's
        blocking seconds (the host copy), the writer's seconds and the
        bytes written."""
        self.wait()
        t0 = time.perf_counter() if since is None else since
        if copy:
            tree = _tree.tree_map(lambda l: host_array(l, copy=True), tree)
        rec = {"step": step, "copy_s": time.perf_counter() - t0}

        def work():
            t1 = time.perf_counter()
            try:
                path = save_checkpoint(self.dir, step, tree,
                                       layout=self.layout,
                                       attempts=self.attempts,
                                       backoff_s=self.backoff_s,
                                       attempt_hook=attempt_hook)
                rec["write_s"] = time.perf_counter() - t1
                rec["bytes"] = sum(f.stat().st_size
                                   for f in pathlib.Path(path).iterdir())
                self.records.append(rec)
                keep_last_k(self.dir, self.keep)
            except BaseException as e:  # noqa: BLE001
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
