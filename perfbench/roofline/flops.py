"""Operations and bytes of the benchmark's cells: the yardstick of
``train_mfu`` and of the kernels' roofline shares.

Every count is worked out from a configuration's dimensions (a family
module's ``dims``) and the cell's shapes, never read from the program.
``attention_pairs``, ``k1_bound`` and ``k2_bound`` are frozen copies of
the program's arithmetic (``launch/dryrun.py`` and the kernel bounds of
``chip_smoke.py``), taking plain numbers instead of tensors.
"""
from __future__ import annotations

import json
import pathlib

PEAKS_FILE = pathlib.Path(__file__).with_name("peaks.json")


def peaks(kind: str):
    """The published peaks of the device named ``kind``
    (``torch.cuda.get_device_name()``), or None for a device the table
    does not hold."""
    return json.loads(PEAKS_FILE.read_text()).get(kind)


def attention_pairs(Tq: int, Tk: int, causal: bool, window: int = 0) -> int:
    """(q, k) pairs the mask keeps: the work an attention of this shape
    needs."""
    total = 0
    for q in range(Tq):
        hi = min(q + 1, Tk) if causal else Tk
        lo = max(q - window, 0) if window else 0
        total += max(hi - lo, 0)
    return total


def active_matmul_params(dm: dict) -> int:
    """Parameters that one token multiplies with in a forward pass: every
    projection of every layer, ``experts_per_token`` of the experts and
    the router, and the unembedding.  The input table of an untied
    embedding is a lookup, not a product, and is left out; a tied table
    is counted once, as the unembedding.  Norm scales and the SSM's
    per-head scalars are counted where the family lists them."""
    return dm["layer_params_active"] * dm["layers"] \
        + dm["d_model"] * dm["vocab"]


def ssd_scan_flops(b: int, H: int, T: int, P: int, S: int, chunk: int,
                   init_state: bool = False) -> int:
    """Operations of one chunked SSD scan, as ``k2_bound`` counts them:
    per chunk of length n, C.B^T over its n(n+1)/2 causal pairs (once,
    shared by the heads), the intra-chunk product over the same pairs,
    the state update and, where the state before the chunk is not zero,
    the inter-chunk product."""
    Q = min(chunk, T)
    flops = 0
    for c0 in range(0, T, Q):
        n = min(Q, T - c0)
        pairs = n * (n + 1) // 2
        inter = c0 > 0 or init_state
        flops += b * 2 * pairs * S + b * H * 2 * pairs * P \
            + b * H * 2 * n * P * S * (2 if inter else 1)
    return flops


def train_step_flops(dm: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one train step over ``rows`` x ``seq`` tokens: 6 per
    active product parameter and token, plus 3x the causal attention's
    forward (QK^T and PV over the pairs the mask keeps) and 3x the SSD
    scan's forward where the family has them.  Recomputation is not
    counted, and a (token, expert) assignment that the capacity drops is
    counted all the same."""
    flops = 6 * active_matmul_params(dm) * rows * seq
    if dm.get("attn_layers"):
        flops += 3 * 4 * dm["head_dim"] * dm["heads"] * dm["attn_layers"] \
            * rows * attention_pairs(seq, seq, True, dm.get("window", 0))
    if dm.get("ssd_layers"):
        flops += 3 * dm["ssd_layers"] * ssd_scan_flops(
            rows, dm["ssd_heads"], seq, dm["ssd_head_dim"], dm["ssd_state"],
            dm["ssd_chunk"])
    return float(flops)


def k1_bound_s(pk: dict, B: int, H: int, K: int, Tq: int, Tk: int, hd: int,
               *, causal: bool, window: int = 0, elem_bytes: int = 2):
    """Least time (s) for K1's forward at these shapes, and what bounds
    it: q, k, v read once and the output written once, 4 hd FLOPs a kept
    (q, k) pair and head."""
    nbytes = (2 * B * H * Tq * hd + 2 * B * K * Tk * hd) * elem_bytes
    flops = 4 * hd * B * H * attention_pairs(Tq, Tk, causal, window)
    peak = pk["bf16_flop_per_s"] if elem_bytes == 2 else pk["f32_flop_per_s"]
    t_bytes, t_ops = nbytes / pk["hbm_bytes_per_s"], flops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def k2_bound_s(pk: dict, b: int, H: int, T: int, P: int, S: int, chunk: int,
               *, init_state: bool = False, elem_bytes: int = 2):
    """Least time (s) for K2's forward at these shapes, and what bounds
    it.  Bytes: x, dt, A, B, C and the initial state read once, y and the
    final state written once.  Operations: ``ssd_scan_flops``."""
    nbytes = (2 * b * H * T * P + 2 * b * T * S) * elem_bytes \
        + 4 * (b * H * T + H) + 4 * b * H * P * S * (2 if init_state else 1)
    flops = ssd_scan_flops(b, H, T, P, S, chunk, init_state)
    peak = pk["bf16_flop_per_s"] if elem_bytes == 2 else pk["f32_flop_per_s"]
    t_bytes, t_ops = nbytes / pk["hbm_bytes_per_s"], flops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
