"""The port's checkpoint store (``repro_torch.checkpoint``) against
``repro``'s.

The store's behaviours are ``tests/test_checkpoint_runtime.py``'s (round
trip, ``.tmp`` ignored, ``keep_last_k``, the async writer and its
errors, kind and shape mismatches raising ``ValueError``) with the ones
``repro`` documents beside them: the corrupt-leaf fallback, the ``.old``
swap, the retried ``OSError``, and the async writer's own host copy.

File parity: llama3.2-3b's smoke state (random moments, step count 3) in
each layout for a 2 x 2 topology (``replicated_to_state`` on both
sides, the host-global trees a 4-rank run writes), and in bf16, gives
``arr_<i>.npy`` files byte-identical to ``repro``'s and identical
manifests apart from ``treedef``.  Each package restores the other's
f32 checkpoints to the values written; the port also reads ``repro``'s
bf16 leaves, which ``repro`` itself cannot.
"""
import dataclasses
import filecmp
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import REPLICATED as JREPLICATED
from repro.checkpoint import load_canonical as jload_canonical
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.checkpoint import Zero1CheckpointLayout as JZero1
from repro.checkpoint import Zero3CheckpointLayout as JZero3
from repro.configs import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig
from repro.configs import resolve as jresolve
from repro.launch import steps as jsteps
from repro.models import init_model as jinit
from repro_torch import _tree
from repro_torch.bridge import params_from_repro
from repro_torch.checkpoint import (AsyncCheckpointer, CheckpointCorruptError,
                                    REPLICATED, Zero1CheckpointLayout,
                                    Zero3CheckpointLayout, committed_steps,
                                    keep_last_k, latest_step,
                                    latest_verified_step, peek_manifest,
                                    restore_checkpoint, save_checkpoint,
                                    verify_checkpoint)
from repro_torch.configs import RunConfig, resolve
from repro_torch.launch import steps

ARCH = "llama3.2-3b"
N_NODE, N_LANE = 2, 2


def _tree_(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.tensor(rng.normal(size=(4, 3)), dtype=torch.float32),
            "b": {"c": torch.tensor(rng.integers(0, 9, (2,)),
                                    dtype=torch.int32),
                  "h": torch.tensor(rng.normal(size=(5,))).bfloat16()},
            "n": seed}


def _like(t):
    return {"a": np.zeros((4, 3)), "b": {"c": np.zeros(2), "h": np.zeros(5)},
            "n": 0}


def _equal(got, want):
    assert int(got["n"]) == want["n"]
    assert got["a"].tobytes() == want["a"].numpy().tobytes()
    assert got["b"]["c"].tobytes() == want["b"]["c"].numpy().tobytes()
    assert got["b"]["h"].tobytes() == \
        want["b"]["h"].view(torch.int16).numpy().tobytes()


# ---------------------------------------------------------------------------
# the store (repro's behaviours)
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    t = _tree_()
    save_checkpoint(tmp_path, 7, t)
    got, step = restore_checkpoint(tmp_path, _like(t))
    assert step == 7
    _equal(got, t)
    man, _ = peek_manifest(tmp_path)
    assert [e["dtype"] for e in man["leaves"]] == ["float32", "int32",
                                                   "bfloat16", "int32"]


def test_latest_ignores_tmp(tmp_path):
    save_checkpoint(tmp_path, 3, _tree_())
    (pathlib.Path(tmp_path) / "step_9.tmp").mkdir()   # a crash mid-write
    (pathlib.Path(tmp_path) / "step_backup").mkdir()  # an operator's copy
    assert latest_step(tmp_path) == 3


def test_keep_last_k(tmp_path):
    for s in (1, 2, 3, 4):
        save_checkpoint(tmp_path, s, _tree_())
    keep_last_k(tmp_path, 2)
    assert committed_steps(tmp_path) == [3, 4]
    assert not (pathlib.Path(tmp_path) / "step_1").exists()


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        ck.save(s, _tree_(s))
    ck.wait()
    assert committed_steps(tmp_path) == [20, 30]
    got, _ = restore_checkpoint(tmp_path, _like(None))
    _equal(got, _tree_(30))
    assert [r["step"] for r in ck.records] == [10, 20, 30]
    assert all(r["bytes"] > 0 and r["write_s"] >= 0 for r in ck.records)


def test_async_checkpointer_copies_before_returning(tmp_path):
    """The train step updates in place: an update after ``save`` returns
    must not reach the file (on the CPU a tensor's ``numpy()`` shares its
    storage)."""
    t = _tree_(1)
    want = _tree_(1)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, t)
    t["a"].add_(1.0)
    t["b"]["h"].mul_(3)
    ck.wait()
    got, _ = restore_checkpoint(tmp_path, _like(t))
    _equal(got, want)


def test_async_checkpointer_worker_error_propagates(tmp_path):
    target = tmp_path / "not_a_dir"
    target.write_text("occupied")          # mkdir in the worker fails
    ck = AsyncCheckpointer(str(target))
    ck.save(1, _tree_())
    ck._thread.join()
    assert isinstance(ck.error, FileExistsError)
    with pytest.raises(FileExistsError):
        ck.wait()
    assert ck.error is None                # consumed by the raise


def test_restore_layout_kind_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path, 1, _tree_())
    with pytest.raises(ValueError, match="layout mismatch"):
        restore_checkpoint(tmp_path, _like(None),
                           layout=Zero3CheckpointLayout(1, 8, 1, 2))


def test_restore_shape_mismatch_raises_valueerror(tmp_path):
    save_checkpoint(tmp_path, 1, _tree_())
    bad = _like(None)
    bad["a"] = np.zeros((4, 5))
    with pytest.raises(ValueError, match=r"leaf 0.*\(4, 5\)") as ei:
        restore_checkpoint(tmp_path, bad)
    assert "(4, 3)" in str(ei.value)


def _flip_byte(path):
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))


def test_corrupt_leaf_falls_back(tmp_path):
    save_checkpoint(tmp_path, 1, _tree_(1))
    save_checkpoint(tmp_path, 2, _tree_(2))
    _flip_byte(tmp_path / "step_2" / "arr_0.npy")
    with pytest.raises(CheckpointCorruptError, match="crc32 mismatch"):
        verify_checkpoint(tmp_path, 2)
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(tmp_path, _like(None), step=2)
    got, step = restore_checkpoint(tmp_path, _like(None))
    assert step == 1
    _equal(got, _tree_(1))
    assert latest_verified_step(tmp_path) == 1
    (tmp_path / "step_1" / "manifest.json").write_text("{not json")
    assert latest_verified_step(tmp_path) is None
    with pytest.raises(CheckpointCorruptError, match="no verifiable"):
        restore_checkpoint(tmp_path, _like(None))


def test_overwrite_swaps_through_old(tmp_path):
    save_checkpoint(tmp_path, 5, _tree_(1))
    save_checkpoint(tmp_path, 5, _tree_(2))        # overwrite
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_5"]
    got, _ = restore_checkpoint(tmp_path, _like(None))
    _equal(got, _tree_(2))
    # a crash between the two renames leaves only the parked copy
    (tmp_path / "step_5").rename(tmp_path / "step_5.old")
    assert committed_steps(tmp_path) == [5]
    got, step = restore_checkpoint(tmp_path, _like(None))
    assert step == 5
    _equal(got, _tree_(2))
    save_checkpoint(tmp_path, 5, _tree_(3))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_5"]


def test_save_retries_oserror(tmp_path, capsys):
    calls = []

    def hook(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise OSError("flaky filesystem")
    save_checkpoint(tmp_path, 1, _tree_(), attempt_hook=hook, backoff_s=0)
    assert calls == [0, 1, 2] and latest_step(tmp_path) == 1
    assert "retrying" in capsys.readouterr().err
    with pytest.raises(OSError, match="flaky"):
        save_checkpoint(tmp_path, 2, _tree_(), backoff_s=0, attempts=2,
                        attempt_hook=lambda a: (_ for _ in ()).throw(
                            OSError("flaky")))
    assert latest_step(tmp_path) == 1


# ---------------------------------------------------------------------------
# the layouts, against repro's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mine,theirs,shape", [
    (Zero3CheckpointLayout(3, 100, 2, 4), JZero3(3, 100, 2, 4), (3, 100)),
    (Zero3CheckpointLayout(3, 100, 3, 2, extra_elems=37, extra_blocks=2),
     JZero3(3, 100, 3, 2, extra_elems=37, extra_blocks=2), (3, 100)),
    (Zero1CheckpointLayout(53, 3, 2), JZero1(53, 3, 2), (53,)),
    (Zero1CheckpointLayout(53, 2, 4), JZero1(53, 2, 4), (53,)),
])
def test_layouts_match_repro(mine, theirs, shape):
    rng = np.random.default_rng(0)
    canon = rng.normal(size=shape).astype(np.float32)
    path = ("blocks",) if len(shape) == 2 else ("m",)
    jpath = (jax.tree_util.DictKey(path[0]),)
    master = mine.from_canonical(path, canon)
    np.testing.assert_array_equal(master,
                                  theirs.from_canonical(jpath, canon))
    np.testing.assert_array_equal(mine.to_canonical(path, master), canon)
    assert mine.manifest_entry() == theirs.manifest_entry()
    assert mine.from_canonical(("count",), np.float32(3)) == 3


def test_zero3_layout_elastic_roundtrip_bit_identical():
    rng = np.random.default_rng(0)
    canon = rng.normal(size=(3, 100)).astype(np.float32)
    a = Zero3CheckpointLayout(3, 100, 2, 4)
    b = Zero3CheckpointLayout(3, 100, 3, 2)
    ma = a.from_canonical(("blocks",), canon)
    mb = b.from_canonical(("blocks",), a.to_canonical(("blocks",), ma))
    assert mb.shape == b.master_shape != a.master_shape
    np.testing.assert_array_equal(b.to_canonical(("blocks",), mb), canon)
    with pytest.raises(ValueError, match="layer_elems"):
        b.check_manifest({**a.manifest_entry(), "layer_elems": 99})
    # the expert-parallel flavour builds, records itself, and refuses a
    # restore across the flavour with repro's error
    ep = Zero3CheckpointLayout(3, 100, 2, 4, ep=True)
    jep = JZero3(3, 100, 2, 4, ep=True)
    assert ep.manifest_entry() == jep.manifest_entry()
    assert ep.manifest_entry()["ep"] is True
    ep.check_manifest(jep.manifest_entry())
    for layout, other, jl, jo in ((a, ep, JZero3(
            3, 100, 2, 4), jep), (ep, a, jep, JZero3(
            3, 100, 2, 4))):
        with pytest.raises(ValueError) as mine:
            layout.check_manifest(other.manifest_entry())
        with pytest.raises(ValueError) as theirs:
            jl.check_manifest(jo.manifest_entry())
        assert str(mine.value) == str(theirs.value)
    # the experts' natural-shape leaves pass through as they are
    leaf = rng.normal(size=(3, 4, 5)).astype(np.float32)
    assert ep.to_canonical(("experts", "w_up"), leaf) is leaf


# ---------------------------------------------------------------------------
# file parity with repro
# ---------------------------------------------------------------------------

KINDS = ("replicated", "zero1", "zero3")


def _state(dtype="float32"):
    """(repro cfg, port cfg, repro params, port params, repro moments,
    port moments): llama3.2-3b smoke from repro's seed-0 init, moments
    random, both packages' trees holding the same values."""
    jc = dataclasses.replace(jresolve(ARCH, smoke=True), dtype=dtype)
    tc = dataclasses.replace(resolve(ARCH, smoke=True), dtype=dtype)
    jp = jinit(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(3)
    mom = {k: jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), jp) for k in ("m", "v")}
    jp_np = jax.tree.map(np.asarray, jp)
    tp = params_from_repro(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        jp_np), tc, device="cpu")
    f32 = dataclasses.replace(tc, dtype="float32")
    tmom = {k: params_from_repro(v, f32, device="cpu")
            for k, v in mom.items()}
    return jc, tc, jp_np, tp, mom, tmom


def _jlayout(kind, jc, params):
    if kind == "zero1":
        return jsteps.zero1_checkpoint_layout(params, N_NODE)
    if kind == "zero3":
        return jsteps.zero3_checkpoint_layout(jc, N_NODE, N_LANE)
    return JREPLICATED


def _tlayout(kind, tc, params):
    if kind == "zero1":
        return steps.zero1_checkpoint_layout(params, N_NODE)
    if kind == "zero3":
        return steps.zero3_checkpoint_layout(tc, N_NODE, N_LANE)
    return REPLICATED


def _write_both(tmp_path, kind, dtype="float32"):
    jc, tc, jp, tp, mom, tmom = _state(dtype)
    jrun = JRunConfig(model=jc, shape=ShapeConfig("t", 32, 4, "train"))
    trun = RunConfig(model=tc)
    jtree = jsteps.replicated_to_state(jc, jrun, N_NODE, N_LANE, jp,
                                       {**mom, "count": np.int32(3)},
                                       kind=kind)
    ttree = steps.replicated_to_state(tc, trun, N_NODE, N_LANE, tp,
                                      {**tmom, "count": 3}, kind=kind)
    jdir, tdir = tmp_path / "repro", tmp_path / "port"
    jsave(str(jdir), 3, jtree, _jlayout(kind, jc, jp))
    save_checkpoint(str(tdir), 3, ttree, _tlayout(kind, tc, tp))
    return jc, tc, jp, tp, mom, tmom, jdir, tdir


def _assert_same_files(jdir, tdir):
    jm = json.loads((jdir / "step_3" / "manifest.json").read_text())
    tm = json.loads((tdir / "step_3" / "manifest.json").read_text())
    for key in ("step", "layout", "leaves"):
        assert tm[key] == jm[key], key
    assert list(tm) == list(jm)
    for i in range(len(jm["leaves"])):
        assert filecmp.cmp(jdir / "step_3" / f"arr_{i}.npy",
                           tdir / "step_3" / f"arr_{i}.npy",
                           shallow=False), i
    return jm


@pytest.mark.parametrize("kind", [*KINDS, "bf16"])
def test_files_match_repro(tmp_path, kind):
    dtype = "bfloat16" if kind == "bf16" else "float32"
    layout = "replicated" if kind == "bf16" else kind
    *_, jdir, tdir = _write_both(tmp_path, layout, dtype)
    man = _assert_same_files(jdir, tdir)
    assert man["layout"]["kind"] == layout
    if kind == "bf16":
        assert "bfloat16" in {e["dtype"] for e in man["leaves"]}
        head = (tdir / "step_3" / "arr_0.npy").read_bytes()[:64]
        assert b"'descr': '<V2'" in head


def _port_replicated(tc, tp, tmom):
    """The values a port restore must give back, as numpy by path."""
    return {"params": {p: t.numpy() for p, t in _tree.flatten(
        _tree.tree_map(lambda x: x.detach(), tp))},
        **{k: {p: t.numpy() for p, t in _tree.flatten(v)}
           for k, v in tmom.items()}}


def _bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("kind", [*KINDS, "bf16"])
def test_port_restores_repros_checkpoint(tmp_path, kind):
    """``repro`` writes; the port restores into its replicated state (the
    same-kind path for replicated checkpoints, the canonical cross-layout
    path for the ZeRO ones) and reads the serving weights: the values
    written, bit for bit (bf16 leaves by the manifest's dtype)."""
    dtype = "bfloat16" if kind == "bf16" else "float32"
    layout = "replicated" if kind == "bf16" else kind
    jc, tc, jp, tp, mom, tmom, jdir, _ = _write_both(tmp_path, layout, dtype)
    run = RunConfig(model=tc)
    (params, opt), step = steps.restore_lane_train_state(
        str(jdir), run, REPLICATED, device="cpu")
    assert step == 3 and opt["count"] == 3
    for (path, got), want in zip(_tree.flatten(params), _tree.leaves(tp)):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(_bits(got), _bits(want), str(path))
    for k in ("m", "v"):
        for got, want in zip(_tree.leaves(opt[k]), _tree.leaves(tmom[k])):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    from repro_torch.serve import load_serve_params
    served, step = load_serve_params(str(jdir), tc, device="cpu")
    assert step == 3
    for got, want in zip(_tree.leaves(served), _tree.leaves(tp)):
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("kind", KINDS)
def test_repro_restores_ports_checkpoint(tmp_path, kind):
    """The port writes (f32); ``repro`` restores: the replicated kind
    through its ``restore_checkpoint``, the ZeRO kinds through its
    canonical path (``load_canonical``, ``state_to_replicated``)."""
    jc, tc, jp, tp, mom, tmom, _, tdir = _write_both(tmp_path, kind)
    if kind == "replicated":
        tmpl = (jax.tree.map(np.zeros_like, jp),
                {"count": np.zeros((), np.int32),
                 **{k: jax.tree.map(np.zeros_like, v)
                    for k, v in mom.items()}})
        (params, opt), step = jrestore(str(tdir), tmpl)
    else:
        man, arrays, step = jload_canonical(str(tdir))
        src_t = jsteps._canonical_state_template(jc, man["layout"])
        src = jax.tree.unflatten(jax.tree.structure(src_t), arrays)
        params, opt = jsteps.state_to_replicated(jc, man["layout"], src)
    assert step == 3 and int(opt["count"]) == 3
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), params, jp)
    for k in ("m", "v"):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)), opt[k], mom[k])


def test_repro_cannot_restore_its_own_bf16_leaf(tmp_path):
    """The reference caveat the port's reader avoids: ``np.load`` gives
    ``|V2`` for ``repro``'s bf16 leaf, which JAX refuses."""
    jsave(str(tmp_path), 1, {"w": jnp.ones((3,), jnp.bfloat16)})
    with pytest.raises(TypeError, match="V2"):
        jax.tree.map(jnp.asarray, jrestore(str(tmp_path),
                                           {"w": np.zeros(3)})[0])
    got, _ = restore_checkpoint(tmp_path, {"w": np.zeros(3)})
    from repro_torch.checkpoint.store import to_torch
    assert torch.equal(to_torch(got["w"], "bfloat16"),
                       torch.ones(3, dtype=torch.bfloat16))


def test_port_serves_repros_params_only_checkpoint(tmp_path):
    """``load_serve_params`` also takes a replicated checkpoint of the
    parameters alone, as ``repro``'s does."""
    jc, tc, jp, tp, _, _ = _state()
    jsave(str(tmp_path), 5, jp)
    from repro_torch.serve import load_serve_params
    served, step = load_serve_params(str(tmp_path), tc, device="cpu")
    assert step == 5
    for got, want in zip(_tree.leaves(served), _tree.leaves(tp)):
        np.testing.assert_array_equal(got.numpy(), want.detach().numpy())
    with pytest.raises(ValueError, match="different model"):
        load_serve_params(str(tmp_path), resolve("mamba2-780m", smoke=True),
                          device="cpu")
