#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

  1. device: require CUDA, print the card's name and power limit;
  2. build K1 (``src/repro_torch/csrc/flash_attention.cu``) with nvcc;
  3. hold K1 against its plain PyTorch version on the card (the kernel
     tests' shapes, the serving path's prefill shapes, a ragged 1500-long
     case) at 2e-5 (f32) / 2e-2 (bf16);
  4. serve llama3.2-3b at full width (28 layers, d_model 3072, bf16,
     random weights from seed 0) through ``ContinuousBatcher``: 8
     ``mixed`` requests, 4 slots, max_seq 1024, greedy; check every
     request's tokens, that K1 ran 28 times per prefill, and that the
     cached prefill and decode logits agree with the no-cache forward;
  5. time prefill per bucket, decode per step, one traced prefill and
     decode step (device busy time, idle share, operations launched), and
     K1 at T=512 beside its bound, its plain version and
     ``scaled_dot_product_attention``.

The line before the last is a JSON object with K1's numbers; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.configs import resolve  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import (ServeState, decode_step, init_model,  # noqa: E402
                                model_forward)
from repro_torch.serve import ContinuousBatcher, make_scenario  # noqa: E402
from repro_torch.serve.engine import DEFAULT_BUCKETS  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12         # dense tensor-core peak, bf16
F32_FLOP_PER_S = 67e12           # CUDA-core peak, f32
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# logits of the cached path against the no-cache forward, as max abs
# difference over the largest reference logit.  The two paths round bf16
# at different points (plain decode attention vs K1, and cuBLAS tiles that
# change with T), and across 28 layers of random weights that moves the
# logits by up to a few percent; phase 4 prints, beside each check, what a
# decode one cache position off gives, and requires it to miss this bound
LOGIT_TOL = 3e-2

ATT_SHAPES = [
    # B, H, K, Tq, Tk, hd  (the kernel tests' shapes)
    (1, 2, 2, 128, 128, 64),
    (2, 4, 2, 256, 256, 64),
    (1, 8, 2, 256, 512, 32),
    (1, 2, 1, 512, 512, 128),
]
MAIN_T = (32, 64, 128, 256, 512, 682)   # prefill buckets + an exact length
ARCH, SLOTS, MAX_SEQ, N_REQ = "llama3.2-3b", 4, 1024, 8


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def qkv_inputs(B, H, K, Tq, Tk, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    return mk(B, H, Tq, hd), mk(B, K, Tk, hd), mk(B, K, Tk, hd)


def compare(q, k, v, *, causal, window):
    """K1 against its plain version on the same inputs: (max abs err,
    within the dtype's tolerance)."""
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        return float("inf"), False
    diff = (got.float() - want.float()).abs()
    tol = TOL[q.dtype]
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return float(diff.max()), ok


def attention_pairs(Tq, Tk, causal, window):
    """(q, k) pairs the masks keep: the work this input needs."""
    qpos = np.arange(Tq)
    hi = np.minimum(qpos + 1, Tk) if causal else np.full(Tq, Tk)
    lo = np.maximum(qpos - window, 0) if window else np.zeros(Tq, int)
    return int(np.clip(hi - lo, 0, None).sum())


def k1_bound(q, k, *, causal, window):
    """Least time (ms) for K1's work on these inputs, and what bounds it."""
    B, H, Tq, hd = q.shape
    Tk = k.shape[2]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4 * hd * B * H * attention_pairs(Tq, Tk, causal, window)
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, reps=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps=5, warmup=1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def traced(fn):
    """One call of ``fn`` under torch.profiler: (wall ms, device busy ms,
    device operations launched).  The profiler slows the host side, so
    the wall time here is above the untraced one."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    busy = sum(r.self_device_time_total for r in rows) / 1e3
    ops = sum(r.count for r in rows
              if r.device_type == torch.autograd.DeviceType.CUDA)
    return wall, busy, ops


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "runs only on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain versions are
    torch.backends.cudnn.allow_tf32 = False         # the yardstick
    name = card()
    log("device", f"{name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} visible")
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    fa.build()
    log("build", f"K1 built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in fa.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())


def phase_kernel() -> float:
    """Every case must pass; returns the max abs error at the serving
    path's shapes."""
    bad = []
    seed = 0

    def case(label, q, k, v, causal, window):
        nonlocal seed
        err, ok = compare(q, k, v, causal=causal, window=window)
        log("kernel", f"{label}: max_abs_err={err:.3e} "
            f"tol={TOL[q.dtype]:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(label)
        return err

    for B, H, K, Tq, Tk, hd in ATT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for mode in ("causal", "full", "window"):
                seed += 1
                q, k, v = qkv_inputs(B, H, K, Tq, Tk, hd, dtype, seed)
                case(f"B{B} H{H} K{K} Tq{Tq} Tk{Tk} hd{hd} "
                     f"{str(dtype)[6:]} {mode}", q, k, v,
                     mode == "causal", 96 if mode == "window" else 0)
    main_err = 0.0
    for T in MAIN_T:
        seed += 1
        q, k, v = qkv_inputs(1, 24, 8, T, T, 128, torch.bfloat16, seed)
        main_err = max(main_err, case(f"serving prefill T={T} bf16 causal",
                                      q, k, v, True, 0))
    for dtype in (torch.float32, torch.bfloat16):
        seed += 1
        q, k, v = qkv_inputs(1, 20, 20, 1500, 1500, 64, dtype, seed)
        case(f"ragged Tq=Tk=1500 hd64 {str(dtype)[6:]} full", q, k, v,
             False, 0)
    if bad:
        raise RuntimeError(f"K1 disagrees with its plain version: {bad}")
    return main_err


def phase_serve(cfg):
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log("serve", f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B params, "
        f"{cfg.dtype}, init on the card in {time.perf_counter() - t0:.1f} s")
    reqs = make_scenario(cfg, kind="mixed", n=N_REQ, seed=0, max_seq=MAX_SEQ)
    log("serve", "prompt lengths " + str([len(r.prompt) for r in reqs])
        + ", max_new_tokens " + str([r.max_new_tokens for r in reqs]))
    batcher = ContinuousBatcher(params, cfg, slots=SLOTS, max_seq=MAX_SEQ,
                                eos_id=-1, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    fa.launches = 0
    _, stats = batcher.run(reqs)
    torch.cuda.synchronize()
    launches = fa.launches

    for r in reqs:
        if r.finish_reason != "length" or len(r.out) != r.max_new_tokens:
            raise RuntimeError(f"request {r.rid}: {r.finish_reason}, "
                               f"{len(r.out)}/{r.max_new_tokens} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.out):
            raise RuntimeError(f"request {r.rid}: token out of vocabulary")
    want = cfg.num_layers * len(reqs)
    log("serve", f"{len(reqs)} requests done, all 'length'; K1 launches "
        f"during the run {launches} (want {cfg.num_layers} x {len(reqs)} "
        f"prefills = {want}); {stats['decode_tokens']} decode tokens in "
        f"{stats['steps']} steps, {stats['wall_s']:.3f} s")
    if launches != want:
        raise RuntimeError(f"K1 launched {launches} times, want {want}")

    # cached path against the no-cache forward (these launches are apart)
    step = batcher.step
    for r in (reqs[0], reqs[1]):
        prompt = torch.as_tensor(np.asarray(r.prompt, np.int64),
                                 device="cuda")[None]
        L = prompt.shape[1]
        b = batcher._bucket_for(L)
        toks = torch.zeros((1, b), dtype=torch.long, device="cuda")
        toks[0, :L] = prompt[0]
        logits, st1 = step.prefill(batcher.hosted, toks, L)
        ref_logits, _ = model_forward(params, cfg, prompt)
        e_pre = rel_err(logits[0, -1], ref_logits[0, -1])
        first = torch.tensor([[r.out[0]]], device="cuda")
        dec_logits, _ = decode_step(params, cfg, first, st1)
        ref2, _ = model_forward(params, cfg, torch.cat([prompt, first], 1))
        e_dec = rel_err(dec_logits[0, -1], ref2[0, -1])
        first_ok = int(logits[0, -1].float().argmax()) == r.out[0]
        # negative control: the same decode step one cache position early
        # (overwrites the last prompt token, rotates at L - 1) must miss
        # the tolerance, or the check above could not see such a bug
        off, _ = decode_step(params, cfg, first, ServeState(
            cache=st1.cache, length=st1.length - 1))
        e_off = rel_err(off[0, -1], ref2[0, -1])
        log("serve", f"request {r.rid} (prompt {L}, bucket {b}): prefill vs "
            f"no-cache forward rel err {e_pre:.3e}, first decode step "
            f"{e_dec:.3e} (tol {LOGIT_TOL:.0e}; the same step one position "
            f"off: {e_off:.3e}); first token reproduced {first_ok}")
        if not (e_pre <= LOGIT_TOL and e_dec <= LOGIT_TOL and first_ok):
            raise RuntimeError(f"request {r.rid}: cached logits disagree "
                               f"with the no-cache forward")
        if e_off <= LOGIT_TOL:
            raise RuntimeError(f"request {r.rid}: a decode one position off "
                               f"passes the tolerance; the check is blind")
    return params, batcher, stats, launches


def phase_perf(cfg, name, batcher, stats):
    step, hosted = batcher.step, batcher.hosted
    g = torch.Generator(device="cuda").manual_seed(1)
    toks32 = torch.randint(1, cfg.vocab_size, (1, 32), generator=g,
                           device="cuda")
    for T in (*DEFAULT_BUCKETS, 682):
        toks = torch.randint(1, cfg.vocab_size, (1, T), generator=g,
                             device="cuda")
        ms = host_ms(lambda: step.prefill(hosted, toks, T))
        log("perf", f"{name} | prefill T={T}: {ms:.3f} ms "
            f"({T / ms * 1e3:.0f} prompt tok/s)")
    tok = np.zeros((SLOTS, 1), np.int64)
    ms = host_ms(lambda: step.decode(hosted, tok, batcher.state), reps=20,
                 warmup=3)
    log("perf", f"{name} | decode, {SLOTS} slots, max_seq {MAX_SEQ}: "
        f"{ms:.3f} ms/step = {SLOTS / ms * 1e3:.1f} tok/s; the batcher run "
        f"made {stats['tok_per_s']:.1f} decode tok/s wall-clock, prefills "
        f"included")
    for label, fn in (
            ("prefill T=32", lambda: step.prefill(hosted, toks32, 32)),
            ("decode step", lambda: step.decode(hosted, tok, batcher.state))):
        wall, busy, ops = traced(fn)
        log("perf", f"{name} | traced {label}: wall {wall:.3f} ms, device "
            f"busy {busy:.3f} ms (idle {1 - busy / wall:.1%}), {ops} device "
            f"operations")
    log("perf", f"{name} | peak memory allocated during serving "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    q, k, v = qkv_inputs(1, 24, 8, 512, 512, 128, torch.bfloat16, 99)
    launches = fa.launches
    k1 = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    fa.launches = launches
    plain = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True), reps=20)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    bound, bound_by = k1_bound(q, k, causal=True, window=0)
    log("perf", f"{name} | K1 T=512 (B1 H24 K8 hd128 bf16 causal, L2 warm):"
        f" {k1 * 1e3:.2f} us/launch; bound {bound * 1e3:.2f} us "
        f"({bound_by}); plain {plain * 1e3:.2f} us; sdpa {lib * 1e3:.2f} us")
    return k1, plain, lib, bound, bound_by


def main() -> int:
    name = phase_device()
    phase_build()
    main_err = phase_kernel()
    cfg = resolve(ARCH)
    _, batcher, stats, launches = phase_serve(cfg)
    k1, plain, lib, bound, bound_by = phase_perf(cfg, name, batcher, stats)
    print(name, flush=True)
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "launches": launches, "max_abs_err": main_err,
        "ms": k1, "plain_ms": plain, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": lib}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
