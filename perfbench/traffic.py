"""The one traffic generator: documents packed into training rows.

A traffic mix is a JSON file under ``perfbench/traffic/`` whose
parameters this module reads:

  kind             "packed_documents"
  rows             rows of one global step (all ranks together)
  seq              tokens a row trains on (a row holds seq + 1 ids: the
                   inputs are the first seq, the labels the last seq)
  doc_len_median   median document length in tokens (lognormal)
  doc_len_sigma    sigma of the length's logarithm
  doc_len_max      longest document
  zipf_a           exponent of the unigram distribution of the ids

Documents are drawn one after another from the seed, each a lognormal
length and ids from a Zipf(a) unigram over the configuration's
``token_ids`` (the ids the tokenizer emits, the end-of-text id left out
of the content), with the ranks of the ids permuted by the seed; the end
of each document is the configuration's ``eos_token_id``.  The stream is
cut into rows of seq + 1 ids, one after another.  Every step gets rows
of its own, and every seed the same shapes.
"""
from __future__ import annotations

import numpy as np

KINDS = ("packed_documents",)


def seed_sequence(seed: int, *salt: int) -> np.random.SeedSequence:
    """A numpy seed sequence from any whole ``seed`` (negative or beyond
    64 bits too) and salt words."""
    words = []
    s = int(seed)
    words.append(1 if s < 0 else 0)
    s = abs(s)
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            break
    return np.random.SeedSequence(words + [int(x) for x in salt])


def packed_rows(traffic: dict, model: dict, seed: int, steps: int):
    """(inputs, labels): int64 arrays of shape (steps, rows, seq), the
    global batches of ``steps`` steps."""
    if traffic.get("kind") != "packed_documents":
        raise ValueError(f"traffic kind {traffic.get('kind')!r} not in "
                         f"{KINDS}")
    rows, seq = int(traffic["rows"]), int(traffic["seq"])
    need = steps * rows * (seq + 1)
    rng = np.random.Generator(np.random.PCG64(seed_sequence(seed, 0x7AFF)))
    n_ids = int(model["token_ids"])
    eos = int(model["eos_token_id"])
    content = np.array([i for i in range(n_ids) if i != eos], np.int64)
    content = content[rng.permutation(len(content))]     # rank -> id
    weights = 1.0 / np.arange(1, len(content) + 1) ** float(traffic["zipf_a"])
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    mu = np.log(float(traffic["doc_len_median"]))
    sigma = float(traffic["doc_len_sigma"])
    longest = int(traffic["doc_len_max"])
    out = np.empty(need, np.int64)
    at = 0
    while at < need:
        lens = np.clip(np.rint(rng.lognormal(mu, sigma, 256)), 1,
                       longest).astype(np.int64)
        ids = content[np.searchsorted(cdf, rng.random(int(lens.sum())),
                                      side="right").clip(max=len(cdf) - 1)]
        ends = np.cumsum(lens)
        docs = np.insert(ids, ends, eos)       # eos after every document
        take = min(len(docs), need - at)
        out[at:at + take] = docs[:take]
        at += take
    out = out.reshape(steps, rows, seq + 1)
    return out[:, :, :-1].copy(), out[:, :, 1:].copy()
