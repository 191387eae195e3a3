"""Continuous-batching serving engine over a serve step.

Counterpart of ``repro.serve.engine``, with the same contracts:

  * batched == sequential: continuous batching, greedy or sampled, is
    token-identical to decoding each request alone at batch 1 — decode
    rows are independent, prefill is per-request batch-1, and a sampled
    token is keyed by its request's (seed, rid, position) alone
    (``serve.sampling``).
  * admission: a prompt longer than its bucket selects a larger bucket
    (never truncated); a request that cannot fit
    ``prefix + len(prompt) + max_new_tokens`` inside ``max_seq`` raises
    ValueError at admit (prefix: the vlm's vision tokens, else 0).
  * termination: eos / max_new_tokens / max_seq fire exactly once per
    request and are recorded in ``finish_reason``.

The engine owns only host-side bookkeeping (slots, admission, sampling,
termination, latency); the :class:`~repro_torch.serve.steps.ServeStep`
runs the model on its device.  Each step's logits are reduced to token
ids on the device (greedy or sampled, every slot's row in one pass), and
only the ids come back to the host.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Any, Optional

import numpy as np

from .sampling import SamplerConfig, sample_token
from .steps import ServeStep, build_serve_step

__all__ = ["Request", "ContinuousBatcher", "termination_reason",
           "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)
# families whose state folds in every token it is given: their prefill
# runs at the exact prompt length, since pad tokens would enter the state
_RECURRENT_FAMILIES = ("ssm", "hybrid")


@dataclasses.dataclass
class Request:
    """One serving request (mutated in place by the engine)."""
    rid: Any
    prompt: Any                       # sequence of int token ids
    max_new_tokens: int = 32
    arrival_step: int = 0             # decode step at which it arrives
    extra: Any = None                 # vlm patches / audio frames
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None
    t_arrival: Optional[float] = dataclasses.field(default=None,
                                                   repr=False)
    t_first: Optional[float] = dataclasses.field(default=None, repr=False)
    t_done: Optional[float] = dataclasses.field(default=None, repr=False)


def termination_reason(token: int, n_out: int, length: int, *,
                       eos_id: int, max_new_tokens: int,
                       max_seq: int) -> Optional[str]:
    """The single termination decision, applied after appending the
    ``n_out``-th generated token (``length`` = cache positions consumed
    so far).  Priority: eos, then the token budget, then cache capacity.
    Returns None while the request should keep decoding."""
    if eos_id >= 0 and token == eos_id:
        return "eos"
    if n_out >= max_new_tokens:
        return "length"
    if length >= max_seq:
        return "max_seq"
    return None


def _int_rid(rid) -> int:
    """Stable uint32 for the sampling key (non-int rids hash via crc32)."""
    if isinstance(rid, (int, np.integer)):
        return int(rid) & 0xFFFFFFFF
    return zlib.crc32(str(rid).encode()) & 0xFFFFFFFF


class ContinuousBatcher:
    """Slot-based continuous batching over one ServeStep.

    params    weights on ``device`` (``models.init_model`` or
              ``bridge.params_from_repro``).
    sampler   None = greedy argmax; a SamplerConfig = seeded temperature/
              top-p sampling keyed by (seed, rid, position).
    device    where the model runs; defaults to ``"cuda"`` and raises
              when there is no GPU.
    hosting   ``"replicated"`` or ``"lane_zero3"``: 1/p weight stripes
              and slots over ``topo`` (every rank of it runs the same
              engine on the same requests, in lockstep; each gets every
              slot's logits), with the gather's ``prefetch_blocks`` and
              the ``kv_strategy`` of the splice (``serve.steps``), and
              ``model_parallel``, tensor-parallel serving over the
              topology's model group.
    step      inject a prebuilt ServeStep (its device wins).
    """

    def __init__(self, params, cfg, *, slots: int, max_seq: int,
                 eos_id: int = -1, sampler: Optional[SamplerConfig] = None,
                 hosting: str = "replicated",
                 step: Optional[ServeStep] = None, device="cuda",
                 topo=None, prefetch_blocks: int = 0,
                 kv_strategy: str = "lane", model_parallel: int = 1):
        self.cfg = cfg
        self.slots = int(slots)
        self.max_seq = int(max_seq)
        self.eos_id = int(eos_id)
        self.sampler = sampler
        if step is not None:
            if (step.ctx.max_seq, step.ctx.slots) != (self.max_seq,
                                                      self.slots):
                raise ValueError(
                    f"injected step was built for max_seq="
                    f"{step.ctx.max_seq}, slots={step.ctx.slots}; engine "
                    f"wants max_seq={self.max_seq}, slots={self.slots}")
            self.step = step
        else:
            self.step = build_serve_step(
                cfg, max_seq=self.max_seq, slots=self.slots,
                hosting=hosting, device=device, topo=topo,
                prefetch_blocks=prefetch_blocks, kv_strategy=kv_strategy,
                model_parallel=model_parallel)
        self.hosted = self.step.prepare(params)
        self.state = self.step.init_state()
        self._active: dict[int, Request] = {}
        self._free = list(range(self.slots))
        self._last_tok = np.zeros((self.slots,), np.int64)
        # positions each slot's cache holds, kept on the host (a sharded
        # state holds only its own slots' lengths)
        self._length = np.zeros((self.slots,), np.int64)
        self._prefix = cfg.vision_tokens if cfg.family == "vlm" else 0

    # -- sampling / termination -------------------------------------------

    def _next_tokens(self, rows, reqs) -> list:
        """One token per logits row (rows: (n, V) on the device), each
        sampled at its request's own position ``len(req.out)`` (0 = the
        prefill-produced token); a row without a request (None: an idle
        slot) is drawn at rid 0, position 0 and left unread."""
        rids = [0 if r is None else _int_rid(r.rid) for r in reqs]
        pos = [0 if r is None else len(r.out) for r in reqs]
        return sample_token(rows, self.sampler, rids, pos).tolist()

    def _finish_if_done(self, req: Request, token: int,
                        length: int) -> bool:
        reason = termination_reason(
            token, len(req.out), length, eos_id=self.eos_id,
            max_new_tokens=req.max_new_tokens, max_seq=self.max_seq)
        if reason is None:
            return False
        if req.finish_reason is not None:
            raise RuntimeError(
                f"request {req.rid} finished twice "
                f"({req.finish_reason!r} then {reason!r})")
        req.finish_reason = reason
        req.done = True
        req.t_done = time.perf_counter()
        return True

    # -- admission --------------------------------------------------------

    def _bucket_for(self, L: int) -> int:
        """Prompt pad width: smallest bucket >= L, else the prompt length
        itself past the largest bucket, capped at ``max_seq - prefix``;
        exact L for the recurrent families.  Never below L (admission has
        proven ``prefix + L + max_new_tokens <= max_seq``)."""
        if self.cfg.family in _RECURRENT_FAMILIES:
            return L
        cap = self.max_seq - self._prefix
        for b in DEFAULT_BUCKETS:
            if b >= L:
                return min(b, cap)
        return min(max(L, DEFAULT_BUCKETS[-1]), cap)

    def _extra_embeds(self, req: Request):
        """The request's patches (vlm) or frames (audio) as (1, n, d) f32,
        or None for the other families."""
        if self.cfg.family not in ("vlm", "audio"):
            return None
        kind = "patch" if self.cfg.family == "vlm" else "frame"
        if req.extra is None:
            raise ValueError(
                f"request {req.rid!r}: family {self.cfg.family!r} needs "
                f"{kind} embeddings in Request.extra")
        x = np.asarray(req.extra, np.float32)
        return x[None] if x.ndim == 2 else x

    def admit(self, req: Request, slot: int):
        """Prefill ``req`` at batch 1 and splice its state into ``slot``.
        Produces the first generated token (from the last true prompt
        position).  Raises ValueError when the request cannot fit
        ``max_seq``."""
        prompt = np.asarray(req.prompt, np.int64).reshape(-1)
        L = int(prompt.shape[0])
        if L == 0:
            raise ValueError(f"request {req.rid!r}: empty prompt")
        need = self._prefix + L + int(req.max_new_tokens)
        if need > self.max_seq:
            raise ValueError(
                f"request {req.rid!r}: prompt length {L}"
                + (f" + {self._prefix} vision tokens"
                   if self._prefix else "")
                + f" + max_new_tokens {req.max_new_tokens} = {need} "
                f"exceeds max_seq={self.max_seq}; shorten the prompt or "
                f"lower max_new_tokens")
        b = self._bucket_for(L)
        if b < L:
            raise RuntimeError(
                f"prefill bucket {b} shorter than prompt length {L}")
        toks = np.zeros((1, b), np.int64)
        toks[0, :L] = prompt          # whole prompt, never sliced
        logits, st1 = self.step.prefill(self.hosted, toks, L,
                                        self._extra_embeds(req))
        if req.t_arrival is None:
            req.t_arrival = time.perf_counter()
        t, = self._next_tokens(logits[:, -1], [req])
        req.out.append(t)
        req.t_first = time.perf_counter()
        if self._finish_if_done(req, t, self._prefix + L):
            return
        self.state = self.step.splice(self.state, st1, slot)
        self._active[slot] = req
        self._last_tok[slot] = t
        self._length[slot] = self._prefix + L

    # -- decode -----------------------------------------------------------

    def step_decode(self) -> int:
        """One batched decode over every slot (idle slots carry garbage
        rows; decode rows are independent so they cannot influence the
        active ones).  Returns the number of tokens appended."""
        tok = self._last_tok.reshape(self.slots, 1)
        logits, self.state = self.step.decode(self.hosted, tok, self.state)
        toks = self._next_tokens(logits[:, -1], [
            self._active.get(slot) for slot in range(self.slots)])
        self._length += 1
        produced = 0
        for slot, req in list(self._active.items()):
            t = toks[slot]
            req.out.append(t)
            self._last_tok[slot] = t
            produced += 1
            if self._finish_if_done(req, t, int(self._length[slot])):
                del self._active[slot]
                self._free.append(slot)
        return produced

    # -- the serving loop -------------------------------------------------

    def run(self, requests, *, max_steps: int = 10_000):
        """Serve ``requests`` to completion (or ``max_steps`` decode
        steps).  Admission honours ``arrival_step`` and otherwise follows
        submission order.  Returns ``(requests, stats)``."""
        pending = list(requests)
        t0 = time.perf_counter()
        steps = 0
        decode_tokens = 0
        while (pending or self._active) and steps < max_steps:
            now = time.perf_counter()
            for r in pending:
                if r.arrival_step <= steps and r.t_arrival is None:
                    r.t_arrival = now
            while self._free and pending:
                nxt = next((r for r in pending
                            if r.arrival_step <= steps), None)
                if nxt is None:
                    break
                pending.remove(nxt)
                slot = self._free.pop(0)
                self.admit(nxt, slot)
                if nxt.done:          # finished on its very first token
                    self._free.insert(0, slot)
            if not self._active:
                steps += 1            # idle tick toward the next arrival
                continue
            decode_tokens += self.step_decode()
            steps += 1
        wall = time.perf_counter() - t0
        stats = {
            "steps": steps,
            "decode_tokens": decode_tokens,
            "wall_s": wall,
            "tok_per_s": decode_tokens / wall if wall > 0 else 0.0,
            "hosting": self.step.hosting,
            "requests": [
                {"rid": r.rid,
                 "tokens": len(r.out),
                 "finish_reason": r.finish_reason,
                 "ttft_ms": None if r.t_first is None or r.t_arrival is None
                 else (r.t_first - r.t_arrival) * 1e3,
                 "latency_ms": None if r.t_done is None or r.t_arrival is None
                 else (r.t_done - r.t_arrival) * 1e3}
                for r in requests],
        }
        return requests, stats
