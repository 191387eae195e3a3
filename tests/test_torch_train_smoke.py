"""``repro_torch.launch.train_smoke`` against ``repro``'s leg: the same
derived cells, every cell training, committing and resuming on a
4-rank gloo world (2 pods x 2), a resumed step 3 equal to an
uninterrupted one bit for bit (one cell per layout: the uninterrupted
3-step run, its step 3 removed, resumed), and a raising driver counted
as a failed cell.  Also K1's plain version at the smoke configs' head
dim 16 against ``repro``'s Pallas kernel in interpret mode (2e-5, f32:
every smoke config is f32), the shape the sweep's attention runs at on
a card.

The losses are compared exactly: the resumed run restores the state the
fresh run saved bit for bit and takes the same (seed, step)-keyed batch.
"""
import numpy as np
import torch

import repro.launch.steps  # noqa: F401 - registers repro's train_step
from repro.comm import strategies_for as jstrategies_for
from repro.models.blockstack import family_smoke_archs as jfamilies
from repro_torch.configs import resolve
from repro_torch.launch import mesh, train, train_smoke
from repro_torch.models.blockstack import family_smoke_archs

import _torch_dist_workers as workers


def test_cells_equal_repros_derived_list():
    """``repro``'s derivation (``train_smoke.main``) over its own
    registry, against the port's ``cells()``."""
    jfams = jfamilies(driver_trainable_only=True)
    want = []
    for s in jstrategies_for("train_step"):
        if s == "lane_zero3":
            want += [(f"{s}[{fam}]", s, fam, arch)
                     for fam, arch in jfams.items()]
        else:
            want.append((s, s, "dense", "llama3.2-3b"))
    assert train_smoke.cells() == want
    assert len(want) == 11
    assert family_smoke_archs(driver_trainable_only=True) == jfams
    assert set(jfams) == {"dense", "moe", "ssm", "hybrid"}


def test_sweep_on_four_ranks_and_resume_is_exact(tmp_path):
    res = mesh.spawn(workers.train_smoke_rank, 4, str(tmp_path),
                     timeout=900)
    fails, resumed, again = res[0]
    assert fails == []
    assert sorted(resumed) == sorted(c[0] for c in train_smoke.cells())
    assert all(np.isfinite(v) for v in resumed.values())
    for name, (straight, losses) in again.items():   # one cell a layout
        assert losses == [straight], (name, losses, straight)
    for r in res[1:]:                       # every rank saw the same
        assert r == res[0]


def test_a_raising_driver_fails_its_cell(tmp_path, capsys):
    """A cell whose driver raises is counted FAIL, and the others still
    run: ``native`` trains on this one process (one pod: ``--pods 2``
    needs a world), ``lane`` raises."""
    def driver(argv, topo=None):
        if argv[argv.index("--gradsync") + 1] == "lane":
            raise RuntimeError("planted")
        i = argv.index("--pods")
        return train.run(argv[:i] + argv[i + 2:], topo=topo)

    fails, resumed = train_smoke.sweep(str(tmp_path), driver=driver,
                                       only=("native", "lane"))
    assert fails == ["lane"]
    assert list(resumed) == ["native"] and np.isfinite(resumed["native"])
    out = capsys.readouterr().out
    assert "PASS native" in out and "FAIL lane: RuntimeError('planted')" \
        in out and "train-smoke: 1/2 cells OK; FAILED ['lane']" in out


def test_k1_plain_at_smoke_head_dim_matches_repro():
    """hd 16 (d_model 64 over 4 heads, every --smoke config with
    attention), causal, windowed and Tq != Tk, f32 at 2e-5."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention_tpu
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    cfg = resolve("llama3.2-3b", smoke=True)
    assert cfg.hd() == 16 and 16 in fa.HEAD_DIMS
    rng = np.random.default_rng(16)
    for Tq, Tk, causal, window in ((128, 128, True, 0), (128, 128, True, 24),
                                   (64, 128, False, 0), (96, 160, True, 0)):
        arrs = [rng.normal(size=s).astype(np.float32) for s in
                ((2, 4, Tq, 16), (2, 2, Tk, 16), (2, 2, Tk, 16))]
        got = ops.flash_attention(*map(torch.tensor, arrs), causal=causal,
                                  window=window)
        jx = [jnp.asarray(a) for a in arrs]
        if causal and Tq != Tk:     # repro's oracle for the aligned mask
            want = jref.attention_ref(*jx, causal=True, window=window)
        else:
            want = flash_attention_tpu(*jx, causal=causal, window=window,
                                       block_q=64, block_k=64,
                                       interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
