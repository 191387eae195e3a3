"""The port's SSD scan and Mamba2 block against ``repro``'s, on the CPU.

K2 itself cannot run here (no card, no nvcc); ``chip_smoke.py`` holds it
against its plain version, ``kernels.ref.ssd_chunked_ref``, on the H100.
Here that plain version, the sequential oracle ``ssd_ref``, the decode
step, the conv and the whole Mamba2 block are held to ``repro``.  Inputs
are numpy draws from a seed, handed to both packages.

Tolerances: f32 1e-5 of the reference's largest magnitude (at least 1)
where only the two frameworks' reduction order differs; against
``repro``'s Pallas kernel in interpret mode, ``tests/test_kernels.py``'s
own 1e-4 (f32) and 5e-2 (bf16, y rounded to bf16 by both).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import resolve as jresolve
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd_tpu
from repro.models import init_model as jinit
from repro.models import ssm as jS
from repro_torch.bridge import params_from_repro
from repro_torch.configs import resolve
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as k2
from repro_torch.models import ssm as S

TOL = 1e-5
SSD_SHAPES = [
    # b, H, T, P, S, chunk, hb  (as in tests/test_kernels.py)
    (1, 4, 64, 32, 32, 16, 4),
    (2, 8, 128, 32, 64, 32, 4),
    (1, 8, 128, 64, 128, 64, 8),
    (2, 4, 96, 16, 16, 32, 2),
]
KERNEL_TOL = {"f32": (jnp.float32, torch.float32, 1e-4),
              "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} > {tol} x {scale}"


def _ssd_inputs(b, T, H, P, S_, G, seed, *, head_major=False):
    """numpy x, dt, A, B, C (+ a random initial state), token-major as in
    ``ssd_chunked``, or head-major with one group as K2 takes them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, T, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, size=(b, T, H)).astype(np.float32)
    A = (-rng.uniform(0.5, 2.0, size=(H,))).astype(np.float32)
    B = rng.normal(size=(b, T, G, S_)).astype(np.float32)
    C = rng.normal(size=(b, T, G, S_)).astype(np.float32)
    s0 = rng.normal(size=(b, H, P, S_)).astype(np.float32)
    if head_major:
        x, dt = x.transpose(0, 2, 1, 3).copy(), dt.transpose(0, 2, 1).copy()
        B, C = B[:, :, 0].copy(), C[:, :, 0].copy()
    return x, dt, A, B, C, s0


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
@pytest.mark.parametrize("T,chunk,G", [(32, 8, 1), (21, 8, 1), (5, 8, 1),
                                       (19, 8, 2)],
                         ids=["multiple", "ragged", "below_chunk",
                              "ragged_2groups"])
def test_ssd_chunked_matches_repro(T, chunk, G, init):
    x, dt, A, B, C, s0 = _ssd_inputs(2, T, 4, 8, 16, G, seed=T)
    s0 = s0 if init else None
    got_y, got_s = ref.ssd_chunked(
        *map(torch.tensor, (x, dt, A, B, C)), chunk=chunk,
        init_state=None if s0 is None else torch.tensor(s0))
    want_y, want_s = jS.ssd_chunked(
        *map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk,
        init_state=None if s0 is None else jnp.asarray(s0))
    _close(got_y, want_y)
    _close(got_s, want_s)
    assert got_s.dtype == torch.float32


@pytest.mark.parametrize("dtype", list(KERNEL_TOL))
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_plain_matches_repro_kernel(shape, dtype):
    """The CPU path of ``ops.ssd`` (K2's plain version) against repro's
    Pallas kernel in interpret mode, on the kernel tests' shapes."""
    b, H, T, P, S_, chunk, hb = shape
    jdt, tdt, tol = KERNEL_TOL[dtype]
    x, dt, A, B, C, _ = _ssd_inputs(b, T, H, P, S_, 1, seed=T + P,
                                    head_major=True)
    jx, jB, jC = (jnp.asarray(a, jdt) for a in (x, B, C))
    tx, tB, tC = (torch.tensor(_np(a)).to(tdt) for a in (jx, jB, jC))
    got, final = ops.ssd(tx, torch.tensor(dt), torch.tensor(A), tB, tC,
                         chunk=chunk)
    want = ssd_tpu(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                   chunk=chunk, heads_blk=hb, interpret=True)
    assert got.dtype == tdt and got.shape == tx.shape
    assert final.shape == (b, H, P, S_) and final.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_ssd_ref_matches_repro():
    x, dt, A, B, C, _ = _ssd_inputs(2, 24, 4, 8, 16, 1, seed=3,
                                    head_major=True)
    _close(ref.ssd_ref(*map(torch.tensor, (x, dt, A, B, C))),
           jref.ssd_ref(*map(jnp.asarray, (x, dt, A, B, C))))


@pytest.mark.parametrize("T,chunk", [(48, 16), (37, 16), (9, 16)])
def test_ssd_plain_matches_sequential_oracle(T, chunk):
    """The chunked form equals the recurrence it decomposes, with the
    final state equal to the recurrence's last state."""
    x, dt, A, B, C, _ = _ssd_inputs(1, T, 4, 8, 16, 1, seed=T,
                                    head_major=True)
    tx, tdt, tA, tB, tC = map(torch.tensor, (x, dt, A, B, C))
    y, final = ref.ssd_chunked_ref(tx, tdt, tA, tB, tC, chunk=chunk)
    _close(y, ref.ssd_ref(tx, tdt, tA, tB, tC))
    # one decode step from the state before the last token gives the
    # final state and the last y
    _, final2 = ref.ssd_chunked_ref(tx[:, :, :T - 1], tdt[:, :, :T - 1], tA,
                                    tB[:, :T - 1], tC[:, :T - 1],
                                    chunk=chunk)
    y_last, step = S.ssd_decode_step(final2, tx[:, :, -1], tdt[:, :, -1], tA,
                                     tB[:, -1:], tC[:, -1:])
    _close(step, final)
    _close(y_last, y[:, :, -1])


def test_ssd_split_prefill_carries_the_state():
    """Two prefills, the second from the first's final state, equal one."""
    x, dt, A, B, C, _ = _ssd_inputs(1, 40, 4, 8, 16, 1, seed=5,
                                    head_major=True)
    tx, tdt, tA, tB, tC = map(torch.tensor, (x, dt, A, B, C))
    y, final = ops.ssd(tx, tdt, tA, tB, tC, chunk=16)
    y1, s1 = ops.ssd(tx[:, :, :23], tdt[:, :, :23], tA, tB[:, :23],
                     tC[:, :23], chunk=16)
    y2, s2 = ops.ssd(tx[:, :, 23:], tdt[:, :, 23:], tA, tB[:, 23:],
                     tC[:, 23:], chunk=16, init_state=s1)
    _close(torch.cat([y1, y2], dim=2), y)
    _close(s2, final)


def test_cpu_path_launches_no_kernel():
    x, dt, A, B, C, _ = _ssd_inputs(1, 16, 2, 16, 16, 1, seed=0,
                                    head_major=True)
    ops.ssd(*map(torch.tensor, (x, dt, A, B, C)), chunk=8)
    assert k2.launches == 0


def test_cuda_wrapper_refuses_cpu_tensors():
    """K2's wrapper never falls back: a CPU tensor is an error."""
    x, dt, A, B, C, _ = _ssd_inputs(1, 16, 2, 16, 16, 1, seed=0,
                                    head_major=True)
    with pytest.raises(ValueError, match="not a CUDA device"):
        k2.ssd_cuda(*map(torch.tensor, (x, dt, A, B, C)), chunk=8)
    assert k2.launches == 0


@pytest.mark.parametrize("which", ["x", "dt", "B", "init_state"])
def test_cuda_wrapper_refuses_grad(which):
    """The raw wrapper has no backward: under grad mode an input that
    requires grad raises (before any device test, so it is pinned here
    without a card), naming the autograd Function that carries K2's
    backward; under no_grad or inference_mode the same call reaches the
    device test."""
    x, dt, A, B, C, _ = _ssd_inputs(1, 16, 2, 16, 16, 1, seed=0,
                                    head_major=True)
    args = dict(zip(("x", "dt", "A", "B", "C"),
                    map(torch.tensor, (x, dt, A, B, C))))
    args["init_state"] = torch.zeros((1, 2, 16, 16))
    args[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward.*SSDFunction.*item 6"):
        k2.ssd_cuda(**args, chunk=8)
    for mode in (torch.no_grad, torch.inference_mode):
        with mode(), pytest.raises(ValueError, match="not a CUDA device"):
            k2.ssd_cuda(**args, chunk=8)
    assert k2.launches == 0


def test_ops_ssd_refuses_other_devices():
    x = torch.empty((1, 2, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.ssd(x, x[..., 0], x[0, :, 0, 0], x[:, 0], x[:, 0], chunk=8)


def test_k2_wrapper_scratch_and_signature():
    """The bf16 kernels' scratch (cum and the chunk states), as the
    wrapper's docstring states it at zamba2-7b's prefill shape, and the
    C entry point's ctypes signature, set once when the library loads:
    ten pointers (the scratch among them), seven ints, the stream."""
    import ctypes
    H, T, P, S_ = 112, 792, 64, 64
    states = 13 * H * P * S_ * 4
    assert round(states / 1e6, 1) == 23.9
    assert k2.scratch_bytes(1, H, T, P, S_, 64) == 4 * H * T + states
    assert k2.scratch_bytes(1, 4, 3, 16, 16, 64) == 4 * (4 * 3 + 4 * 16 * 16)
    argtypes, restype = k2.LIBRARY.signatures["repro_ssd_fwd"]
    assert argtypes == [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    assert restype is ctypes.c_int


# ---------------------------------------------------------------------------
# decode step, conv, the Mamba2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 2])
def test_ssd_decode_step_matches_repro(G):
    rng = np.random.default_rng(G)
    b, H, P, S_ = 3, 4, 8, 16
    state = rng.normal(size=(b, H, P, S_)).astype(np.float32)
    x = rng.normal(size=(b, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, size=(b, H)).astype(np.float32)
    A = (-rng.uniform(0.5, 2.0, size=(H,))).astype(np.float32)
    B = rng.normal(size=(b, G, S_)).astype(np.float32)
    C = rng.normal(size=(b, G, S_)).astype(np.float32)
    got = S.ssd_decode_step(*map(torch.tensor, (state, x, dt, A, B, C)))
    want = jS.ssd_decode_step(*map(jnp.asarray, (state, x, dt, A, B, C)))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no_state", "state"])
@pytest.mark.parametrize("T", [1, 2, 7])
def test_conv1d_matches_repro(T, with_state):
    """Includes T < W - 1, where the new state reaches into the old."""
    rng = np.random.default_rng(T)
    W, Cn = 4, 6
    x = rng.normal(size=(2, T, Cn)).astype(np.float32)
    w = rng.normal(size=(W, Cn)).astype(np.float32)
    bias = rng.normal(size=(Cn,)).astype(np.float32)
    st = rng.normal(size=(2, W - 1, Cn)).astype(np.float32) \
        if with_state else None
    got = S._conv1d(torch.tensor(x), torch.tensor(w), torch.tensor(bias),
                    None if st is None else torch.tensor(st))
    want = jS._conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                      None if st is None else jnp.asarray(st))
    for g, wnt in zip(got, want):
        _close(g, wnt)


@pytest.fixture(scope="module")
def mamba_layer():
    jc, tc = jresolve("mamba2-780m", smoke=True), \
        resolve("mamba2-780m", smoke=True)
    jp = jinit(jax.random.PRNGKey(0), jc)
    tp = params_from_repro(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jax.tree.map(lambda a: a[1], jp["blocks"])["mamba"], \
        tp["blocks"][1]["mamba"]


@pytest.mark.parametrize("mode", ["no_state", "prefill", "decode"])
def test_mamba2_block_matches_repro(mamba_layer, mode):
    jc, tc, jp, tp = mamba_layer
    T = 1 if mode == "decode" else 13
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, T, tc.d_model)).astype(np.float32)
    state = None
    if mode != "no_state":
        state = {k: rng.normal(size=a.shape).astype(np.float32)
                 for k, a in S.init_mamba_state(tc, 2, device="cpu").items()}
    got, got_st = S.mamba2_block(
        tp, torch.tensor(x), tc,
        state=None if state is None else
        {k: torch.tensor(v) for k, v in state.items()})
    want, want_st = jS.mamba2_block(
        jp, jnp.asarray(x), jc,
        state=None if state is None else
        {k: jnp.asarray(v) for k, v in state.items()})
    _close(got, want)
    if state is None:
        assert got_st is None and want_st is None
    else:
        assert set(got_st) == set(want_st)
        for k in want_st:
            _close(got_st[k], want_st[k])


def test_mamba2_block_bf16_promotes_like_repro(mamba_layer):
    """bf16 weights and activations: ``y + xs * D`` promotes to f32 and is
    cast back, as in repro; the two agree to a few bf16 ulps."""
    jc, tc, jp, tp = mamba_layer
    jc = dataclasses.replace(jc, dtype="bfloat16")
    tc = dataclasses.replace(tc, dtype="bfloat16")
    keep = ("A_log", "D", "dt_bias")          # f32 in repro's bf16 models
    jpb = {k: v if k in keep else jax.tree.map(
        lambda a: a.astype(jnp.bfloat16), v) for k, v in jp.items()}
    tpb = {k: v if k in keep else
           {"scale": v["scale"].to(torch.bfloat16)} if k == "norm" else
           v.to(torch.bfloat16) for k, v in tp.items()}
    x = np.random.default_rng(8).normal(size=(1, 11, tc.d_model))
    xb = jnp.asarray(x, jnp.bfloat16)
    got, _ = S.mamba2_block(tpb, torch.tensor(_np(xb)).to(torch.bfloat16),
                            tc)
    want, _ = jS.mamba2_block(jpb, xb, jc)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-2)


def test_init_mamba2_follows_repro():
    """Same leaves, shapes and dtypes as repro's; A_log and D exactly
    repro's constants; softplus(dt_bias) inside [1e-3, 1e-1]; seeded."""
    jc, tc = jresolve("mamba2-780m", smoke=True), \
        resolve("mamba2-780m", smoke=True)
    want = jS.init_mamba2(jax.random.PRNGKey(0), jc)
    mk = lambda seed: S.init_mamba2(
        tc, generator=torch.Generator().manual_seed(seed),
        device=torch.device("cpu"))
    got, again, other = mk(0), mk(0), mk(1)
    flat = lambda t: {k: v for k, v in jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]}
    g, w = flat(got), flat(want)
    assert set(g) == set(w)
    for k in w:
        assert tuple(g[k].shape) == w[k].shape, k
        assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype), k
    _close(got["A_log"], want["A_log"])
    assert torch.equal(got["D"], torch.ones_like(got["D"]))
    sp = torch.nn.functional.softplus(got["dt_bias"])
    assert float(sp.min()) >= 1e-3 * (1 - 1e-5)
    assert float(sp.max()) <= 1e-1 * (1 + 1e-5)
    assert torch.equal(got["w_x"], again["w_x"])
    assert not torch.equal(got["w_x"], other["w_x"])
    assert float(got["conv_x_w"].abs().max()) <= 1.0 + 1e-6   # 0.5 x [-2, 2]


# ---------------------------------------------------------------------------
# where K2's bf16 tensor-core kernels round (csrc/ssd.cu)
# ---------------------------------------------------------------------------

def _bf16(v):
    return v.to(torch.bfloat16).float()


def _split_bf16(v):
    """The kernels' two-term split of an f32 operand: hi + lo in bf16."""
    hi = _bf16(v)
    return hi + _bf16(v - hi)


def _k2_bf16_model(x, dt, A, B, C, *, chunk, init_state=None,
                   operand=_split_bf16, select_mask=True):
    """K2's bf16 kernels in plain f32 PyTorch, rounding where they round.

    Head-major as K2 takes it.  Chunk by chunk (Q = min(chunk, T), the
    ragged tail zero-padded): x, B and C enter the products as the bf16
    they are; the f32-valued operands -- x o w of the chunk state, the
    scores and the carried state -- go through ``operand`` (the kernels'
    hi + lo split, or plain bf16 for the negative control); exp(cum_q)
    multiplies C . state^T after the product; t > q is selected to 0
    before the exponential (``select_mask``) or, for the negative control,
    multiplied by a 0/1 mask.  y is rounded once, to x's dtype."""
    b, H, T, P = x.shape
    S = B.shape[-1]
    Q = min(chunk, T)
    nc = -(-T // Q)
    pad = nc * Q - T
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, pad))
    Bf = torch.nn.functional.pad(B.float(), (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(C.float(), (0, 0, 0, pad))
    state = torch.zeros(b, H, P, S) if init_state is None \
        else init_state.float().clone()
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xc, dc, Bc, Cc = xf[:, :, sl], dtf[:, :, sl], Bf[:, sl], Cf[:, sl]
        cum = torch.cumsum(dc * A[None, :, None], -1)            # (b,H,Q)
        seg = cum[..., -1]
        w = torch.exp(seg[..., None] - cum) * dc
        own = torch.einsum("bhtp,bts->bhps", operand(xc * w[..., None]), Bc)
        cb = torch.einsum("bqs,bts->bqt", Cc, Bc)[:, None]        # exact
        diff = cum[..., :, None] - cum[..., None, :]
        decay = torch.where(tri, torch.exp(diff), torch.zeros(())) \
            if select_mask else torch.exp(diff) * tri.float()
        scores = cb * decay * dc[..., None, :]
        y_intra = torch.einsum("bhqt,bhtp->bhqp", operand(scores), xc)
        y_inter = torch.exp(cum)[..., None] * torch.einsum(
            "bqs,bhps->bhqp", Cc, operand(state))
        ys.append(y_intra + y_inter)
        state = state * torch.exp(seg)[..., None, None] + own
    return torch.cat(ys, 2)[:, :, :T].to(x.dtype), state


def _model_rate_inputs(H, T, P, S_, seed, init):
    """bf16 x, B, C and the model's own dt/A (dt = softplus of a unit
    normal, A = -linspace(1, 16, H)), where exp(cum) underflows within a
    chunk; head-major, one group."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, H, T, P))
    dt = np.log1p(np.exp(rng.normal(size=(1, H, T)))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    B = rng.normal(size=(1, T, S_))
    C = rng.normal(size=(1, T, S_))
    s0 = rng.normal(size=(1, H, P, S_)).astype(np.float32) if init else None
    x, B, C = (torch.tensor(a, dtype=torch.float32).to(torch.bfloat16)
               for a in (x, B, C))
    return x, torch.tensor(dt), torch.tensor(A), B, C, \
        None if s0 is None else torch.tensor(s0)


def _repro_ssd(x, dt, A, B, C, chunk, s0):
    """repro's ssd_chunked on the same bf16 inputs, back in K2's layout."""
    jb = lambda t: jnp.asarray(_np(t), jnp.bfloat16)
    y, final = jS.ssd_chunked(
        jb(x.transpose(1, 2)), jnp.asarray(_np(dt).transpose(0, 2, 1)),
        jnp.asarray(_np(A)), jb(B[:, :, None]), jb(C[:, :, None]),
        chunk=chunk, init_state=None if s0 is None else jnp.asarray(_np(s0)))
    return _np(y).transpose(0, 2, 1, 3), _np(final)


def _k2_err_over_tol(got, want):
    """Worst |got - want| / (5e-2 + 5e-2 |want|): chip_smoke's bf16 K2
    tolerance; above 1 misses it."""
    got, want = _np(got), np.asarray(want, np.float32)
    if not np.isfinite(got).all():
        return float("inf")
    return float((np.abs(got - want) / (5e-2 + 5e-2 * np.abs(want))).max())


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
@pytest.mark.parametrize("T", [3, 387])
def test_k2_bf16_rounding_design_matches_repro(T, init):
    """The split-bf16 design, at the model's dt/A, is within K2's bf16
    tolerance of repro's ssd_chunked, y and final state."""
    chunk = 64
    inp = _model_rate_inputs(4, T, 32, 64, seed=T, init=init)
    y, final = _k2_bf16_model(*inp[:5], chunk=chunk, init_state=inp[5])
    want_y, want_s = _repro_ssd(*inp[:5], chunk, inp[5])
    assert y.dtype == torch.bfloat16 and final.dtype == torch.float32
    assert _k2_err_over_tol(y, want_y) <= 1.0
    assert _k2_err_over_tol(final, want_s) <= 1.0


def test_k2_plain_bf16_operands_miss_the_tolerance():
    """Negative control: the same design with the f32-valued operands
    rounded to plain bf16 misses 5e-2 at the model's rates (mamba2-780m's
    per-head widths, T=387), where the split passes on the same inputs."""
    inp = _model_rate_inputs(8, 387, 64, 128, seed=0, init=True)
    want_y, _ = _repro_ssd(*inp[:5], 64, inp[5])
    split_y, _ = _k2_bf16_model(*inp[:5], chunk=64, init_state=inp[5])
    plain_y, _ = _k2_bf16_model(*inp[:5], chunk=64, init_state=inp[5],
                                operand=_bf16)
    assert _k2_err_over_tol(split_y, want_y) <= 1.0
    assert _k2_err_over_tol(plain_y, want_y) > 1.0


def test_k2_multiply_mask_gives_nan():
    """Negative control: masking t > q by multiplying gives inf * 0 = NaN
    at the model's rates; selecting before the exponential does not."""
    inp = _model_rate_inputs(4, 387, 16, 32, seed=1, init=False)
    y_sel, s_sel = _k2_bf16_model(*inp[:5], chunk=64)
    y_mul, _ = _k2_bf16_model(*inp[:5], chunk=64, select_mask=False)
    assert torch.isfinite(y_sel.float()).all() and torch.isfinite(s_sel).all()
    assert torch.isnan(y_mul.float()).any()
