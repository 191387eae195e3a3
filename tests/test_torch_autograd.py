"""The backward passes of K1 and K2 against ``repro``'s autograd, on the CPU.

``repro`` has no backward kernel: it trains through the AD of its lax
attention and of its lax ``ssd_chunked``.  The port's
``FlashAttentionFunction`` and ``SSDFunction`` run the kernels forward on
the card (``chip_smoke.py`` holds them there); their backward passes are
the plain functions ``attention_backward`` and ``ssd_backward``, held here
to ``jax.vjp`` of ``repro``'s oracles on numpy inputs from a seed.

Tolerance 1e-5, relative to the reference's largest magnitude (at least
1): the f32 reduction order differs between the frameworks, and against
the f64 sequential recurrence the f32 scan's sums (dA sums b·T·P terms)
round at 1e-6 of that.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.models import ssm as jS
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import attention_backward
from repro_torch.kernels.ssd import ssd_backward

TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_vjp(fn, args, cot):
    """``(fn(*args), its vjp at cot)``, traced and run once under jit."""
    def both(args, cot):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cot)
    return jax.jit(both)(tuple(map(jnp.asarray, args)), cot)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} > {tol} x {scale}"


# ---------------------------------------------------------------------------
# K1: attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,K,Tq,Tk,hd,causal,window", [
    (2, 4, 2, 24, 24, 16, True, 0),      # GQA, causal
    (1, 4, 2, 40, 40, 16, True, 7),      # a window that masks keys
    (1, 6, 2, 12, 30, 8, False, 0),      # Tq != Tk, non-causal (cross)
    (1, 2, 2, 20, 20, 32, False, 0),     # MHA, bidirectional (encoder)
    (1, 4, 1, 16, 16, 16, False, 5),     # MQA, window without causality
], ids=["gqa_causal", "window", "cross", "encoder", "mqa_window"])
def test_attention_backward_matches_repro_vjp(B, H, K, Tq, Tk, hd, causal,
                                              window):
    rng = np.random.default_rng(Tq * 7 + hd)
    q = rng.normal(size=(B, H, Tq, hd)).astype(np.float32)
    k = rng.normal(size=(B, K, Tk, hd)).astype(np.float32)
    v = rng.normal(size=(B, K, Tk, hd)).astype(np.float32)
    dout = rng.normal(size=(B, H, Tq, hd)).astype(np.float32)
    out, want = _jax_vjp(lambda a, b, c: jref.attention_ref(
        a, b, c, causal=causal, window=window), (q, k, v), jnp.asarray(dout))
    tq, tk, tv = map(torch.tensor, (q, k, v))
    tout = ref.attention_ref(tq, tk, tv, causal=causal, window=window)
    _close(tout, out)
    got = attention_backward(tq, tk, tv, tout, torch.tensor(dout),
                             causal=causal, window=window)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.shape == t.shape and g.dtype == t.dtype
        _close(g, w)


def test_attention_backward_is_autograd_of_the_plain_version():
    """In bf16 too: the gradients equal autograd of ``attention_ref`` (in
    the same dtype) and come back in bf16; a row with no key in its window
    gets no gradient, as masked_fill gives it none."""
    rng = np.random.default_rng(3)
    # Tq > Tk with a window: the last rows see no key at all
    q, dout = (torch.tensor(rng.normal(size=(1, 4, 20, 16)),
                            dtype=torch.float32) for _ in range(2))
    k, v = (torch.tensor(rng.normal(size=(1, 2, 12, 16)),
                         dtype=torch.float32) for _ in range(2))
    for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, 2e-2)):
        ins = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        out = ref.attention_ref(*ins, causal=True, window=3)
        want = torch.autograd.grad(out, ins, dout.to(dtype))
        got = attention_backward(*[t.detach() for t in ins], out.detach(),
                                 dout.to(dtype), causal=True, window=3)
        for g, w in zip(got, want):
            assert g.dtype == dtype
            _close(g.float(), w.float(), tol)
    assert float(got[0][:, :, 15:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# K2: the SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(b, T, H, P, S, seed, *, dt=None, A=None):
    """numpy x, dt, A, B, C, an initial state and the cotangents of y and
    of the final state, token-major as ``ssd_chunked`` takes them (one
    group).  ``dt``/``A`` given: constant dt, that A."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x, B, C, s0 = f(b, T, H, P), f(b, T, 1, S), f(b, T, 1, S), f(b, H, P, S)
    dts = (rng.uniform(0.01, 0.1, size=(b, T, H)) if dt is None
           else np.full((b, T, H), dt)).astype(np.float32)
    As = (-rng.uniform(0.5, 2.0, size=(H,)) if A is None
          else np.asarray(A)).astype(np.float32)
    return x, dts, As, B, C, s0, f(b, T, H, P), f(b, H, P, S)


def _head_major(x, dt, A, B, C):
    """Token-major numpy → the head-major tensors ``ssd_backward`` takes."""
    return (torch.tensor(x.transpose(0, 2, 1, 3).copy()),
            torch.tensor(dt.transpose(0, 2, 1).copy()), torch.tensor(A),
            torch.tensor(B[:, :, 0].copy()), torch.tensor(C[:, :, 0].copy()))


@pytest.mark.parametrize("T,chunk,init,final", [
    (32, 8, False, False), (21, 8, True, True), (21, 8, False, True)],
    ids=["y_only", "ragged_init_and_final", "ragged_final_grad"])
def test_ssd_backward_matches_repro_vjp(T, chunk, init, final):
    x, dt, A, B, C, s0, dy, dfin = _ssd_inputs(2, T, 3, 8, 16, seed=T)
    args = [x, dt, A, B, C] + ([s0] if init else [])
    _, want = _jax_vjp(
        lambda *a: jS.ssd_chunked(*a[:5], chunk=chunk,
                                  init_state=a[5] if init else None),
        args, (jnp.asarray(dy), jnp.asarray(dfin if final else 0 * dfin)))
    tdy = torch.tensor(dy.transpose(0, 2, 1, 3).copy())
    got = ssd_backward(*_head_major(x, dt, A, B, C),
                       torch.tensor(s0) if init else None, tdy,
                       torch.tensor(dfin) if final else None, chunk=chunk)
    gx, gdt, gA, gB, gC, gs0 = got
    _close(gx.transpose(1, 2), want[0])
    _close(gdt.transpose(1, 2), want[1])
    _close(gA, want[2])
    _close(gB[:, :, None], want[3])
    _close(gC[:, :, None], want[4])
    if init:
        _close(gs0, want[5])
    else:
        assert gs0 is None


def test_ssd_backward_needs_and_no_cotangent():
    """Only the flagged inputs get a gradient; with no cotangent at all
    every flagged one is zero, in its input's dtype."""
    x, dt, A, B, C, _, dy, _ = _ssd_inputs(1, 16, 2, 8, 16, seed=5)
    tx, tdt, tA, tB, tC = _head_major(x, dt, A, B, C)
    tx = tx.to(torch.bfloat16)
    needs = (True, False, True, False, False, False)
    got = ssd_backward(tx, tdt, tA, tB, tC, None,
                       torch.tensor(dy.transpose(0, 2, 1, 3).copy()), None,
                       chunk=8, needs=needs)
    assert [g is not None for g in got] == list(needs)
    assert got[0].dtype == torch.bfloat16 and got[2].dtype == torch.float32
    none = ssd_backward(tx, tdt, tA, tB, tC, None, None, None, chunk=8,
                        needs=needs)
    assert float(none[0].abs().max()) == 0.0 and none[0].shape == tx.shape
    assert float(none[2].abs().max()) == 0.0


@pytest.mark.parametrize("dt", [0.1, 0.5])
def test_ssd_gradient_finite_where_repro_is_nan(dt):
    """The overflow regime: chunk 64, A down to -16 (mamba2-780m's), and
    dt |A| (Q - 1) far past 88.7.  ``repro``'s ``ssd_chunked`` computes
    ``where(causal, exp(diff), 0)``: its forward is right, its gradient of
    dt and A is NaN.  The port masks before the exponential: the same
    forward, and a finite gradient equal to the autograd of the sequential
    recurrence in f64."""
    H, chunk = 4, 64
    A = -np.linspace(1.0, 16.0, H)
    x, dts, As, B, C, _, dy, _ = _ssd_inputs(1, 96, H, 8, 16, seed=11, dt=dt,
                                             A=A)
    (y, _), jgrads = _jax_vjp(
        lambda *a: jS.ssd_chunked(*a, chunk=chunk), (x, dts, As, B, C),
        (jnp.asarray(dy), jnp.zeros((1, H, 8, 16), jnp.float32)))
    assert np.isnan(np.asarray(jgrads[1])).any()     # dt
    assert np.isnan(np.asarray(jgrads[2])).any()     # A

    ins = _head_major(x, dts, As, B, C)
    tdy = torch.tensor(dy.transpose(0, 2, 1, 3).copy())
    got = ssd_backward(*ins, None, tdy, None, chunk=chunk)
    y_port, _ = ref.ssd_chunked_ref(*ins, chunk=chunk)
    _close(y_port.transpose(1, 2), y)               # the forward agrees

    f64 = [t.double().requires_grad_() for t in ins]
    want = torch.autograd.grad(ref.ssd_ref(*f64), f64, tdy.double())
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w)

    # the CPU model path differentiates the same repaired form
    f32 = [t.clone().requires_grad_() for t in ins]
    y32, _ = ops.ssd(*f32, chunk=chunk)
    auto = torch.autograd.grad(y32, f32, tdy)
    for g, w in zip(auto, want):
        _close(g, w)
