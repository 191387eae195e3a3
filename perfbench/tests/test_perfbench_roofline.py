"""The FLOP and byte counters against hand counts at small shapes, and
the traffic generator's rows."""
from __future__ import annotations

import numpy as np
import pytest

from perfbench.tests import smoke_root  # noqa: F401  (sys.path)
from perfbench import traffic
from perfbench.roofline import flops

PK = {"bf16_flop_per_s": 1e12, "f32_flop_per_s": 1e11,
      "hbm_bytes_per_s": 1e9}


def test_attention_pairs_by_hand():
    assert flops.attention_pairs(4, 4, True) == 1 + 2 + 3 + 4
    assert flops.attention_pairs(4, 4, False) == 16
    assert flops.attention_pairs(5, 5, True, window=1) == 1 + 2 + 2 + 2 + 2
    assert flops.attention_pairs(1024, 1024, True) == 1024 * 1025 // 2


def test_k1_bound_by_hand():
    # B=1, H=2, K=1, T=4, hd=8, causal: 10 pairs
    t, what = flops.k1_bound_s(PK, 1, 2, 1, 4, 4, 8, causal=True)
    nbytes = (2 * 1 * 2 * 4 * 8 + 2 * 1 * 1 * 4 * 8) * 2
    ops = 4 * 8 * 1 * 2 * 10
    assert t == pytest.approx(max(nbytes / 1e9, ops / 1e12))
    assert what == "bytes"


def test_ssd_flops_and_k2_bound_by_hand():
    # b=1, H=1, T=4, P=2, S=3, chunk 2: two chunks of 2, 3 pairs each
    chunk0 = 2 * 3 * 3 + 2 * 3 * 2 + 2 * 2 * 2 * 3 * 1
    chunk1 = 2 * 3 * 3 + 2 * 3 * 2 + 2 * 2 * 2 * 3 * 2
    assert flops.ssd_scan_flops(1, 1, 4, 2, 3, 2) == chunk0 + chunk1
    t, what = flops.k2_bound_s(PK, 1, 1, 4, 2, 3, 2)
    nbytes = (2 * 4 * 2 + 2 * 4 * 3) * 2 + 4 * (4 + 1) + 4 * 2 * 3
    assert t == pytest.approx(max(nbytes / 1e9, (chunk0 + chunk1) / 1e12))
    assert what == "bytes"


def test_train_step_flops_by_hand():
    dm = {"layers": 2, "d_model": 4, "vocab": 10, "layer_params_active": 50,
          "attn_layers": 2, "heads": 2, "head_dim": 2}
    rows, seq = 3, 4
    want = 6 * (2 * 50 + 4 * 10) * rows * seq \
        + 3 * 4 * 2 * 2 * 2 * rows * 10
    assert flops.train_step_flops(dm, rows, seq) == want
    dm = {"layers": 1, "d_model": 4, "vocab": 10, "layer_params_active": 7,
          "ssd_layers": 1, "ssd_heads": 1, "ssd_head_dim": 2,
          "ssd_state": 3, "ssd_chunk": 2}
    want = 6 * (7 + 40) * 1 * 4 + 3 * flops.ssd_scan_flops(1, 1, 4, 2, 3, 2)
    assert flops.train_step_flops(dm, 1, 4) == want


def test_granite_active_parameters():
    """granite-moe-3b-a800m: the non-expert products and 8 of 40 experts
    a layer, and the untied unembedding."""
    import json
    from perfbench import harness
    cfg = json.loads((smoke_root.REPO / "perfbench" / "configs"
                      / "granite_moe_3b_a800m.json").read_text())
    fam = harness.load_file_module(smoke_root.REPO / "perfbench"
                                   / "reference" / "moe.py")
    d, f = 1536, 512
    attn = d * 24 * 64 * 2 + 2 * d * 8 * 64
    layer = attn + d * 40 + 8 * 3 * d * f
    assert flops.active_matmul_params(fam.dims(cfg)) == \
        32 * layer + d * 49155


def test_peaks_table():
    pk = flops.peaks("NVIDIA H100 80GB HBM3")
    assert pk["bf16_flop_per_s"] == 989e12
    assert pk["hbm_bytes_per_s"] == 3.35e12
    assert flops.peaks("no such card") is None


MODEL = {"token_ids": 50, "eos_token_id": 0}
MIX = {"kind": "packed_documents", "rows": 3, "seq": 32,
       "doc_len_median": 8, "doc_len_sigma": 1.0, "doc_len_max": 64,
       "zipf_a": 1.0}


def test_packed_rows_shapes_and_seed():
    a, b = traffic.packed_rows(MIX, MODEL, 2**31 + 11, 4)
    assert a.shape == b.shape == (4, 3, 32)
    assert (a[..., 1:] == b[..., :-1]).all()
    assert a.min() >= 0 and a.max() < 50 and (a == 0).any()
    a2, _ = traffic.packed_rows(MIX, MODEL, 2**31 + 11, 4)
    assert (a == a2).all()
    a3, _ = traffic.packed_rows(MIX, MODEL, 2**31 + 12, 4)
    assert (a != a3).any()
    rows = a.reshape(12, 32)
    assert len({r.tobytes() for r in rows}) == 12


def test_packed_rows_are_zipf_skewed():
    mix = dict(MIX, rows=8, seq=1024, doc_len_median=512)
    a, _ = traffic.packed_rows(mix, {"token_ids": 1000,
                                     "eos_token_id": 0}, 3, 2)
    counts = np.sort(np.bincount(a.ravel(), minlength=1000))[::-1]
    assert counts[0] > 20 * np.median(counts)


def test_seed_sequence_takes_any_whole_number():
    for s in (0, -5, 2**31 + 7, 2**64 + 3):
        traffic.seed_sequence(s).generate_state(1)
    assert traffic.seed_sequence(-5).entropy != traffic.seed_sequence(
        5).entropy
