"""The one traffic generator: a mix's data file in, the inputs of one
call out.  Every input is drawn from the run's seed and the call's index
through one ``numpy`` generator each, so the same seed gives the same
inputs; the amount of work is fixed by the data file alone, so every
seed gives the same work in another order."""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import numpy as np


def rng(seed: int, *keys: int) -> np.random.Generator:
    """The generator for ``(seed, *keys)``; any whole seed, however
    large."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) & (2 ** 64 - 1), *(int(k) for k in keys)]))


def permuted_rounds(values: Sequence[int], rounds: int, lanes: int,
                    gen: np.random.Generator) -> np.ndarray:
    """``(rounds, lanes)`` counts: each lane cycles through ``values``
    to ``rounds`` entries, in its own seeded order."""
    base = np.resize(np.asarray(values, np.int64), rounds)
    return np.stack([gen.permutation(base) for _ in range(lanes)], axis=1)


def stream_arrivals(traffic: Dict, seed: int, call: int, senders: int
                    ) -> np.ndarray:
    """One call's ``(rounds, senders)`` arrivals, drawn by
    :func:`permuted_rounds`."""
    return permuted_rounds(traffic["per_sender_per_round"],
                           traffic["rounds"], senders, rng(seed, call))


def lognormal_lengths(n: int, median: float, sigma: float, lo: int,
                      hi: int) -> np.ndarray:
    """``n`` lengths at the midpoint quantiles of a lognormal of this
    median and sigma, clipped to ``[lo, hi]``: the distribution's shape
    with no draw, so every call holds the same multiset."""
    z = [statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    x = median * np.exp(sigma * np.asarray(z))
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def serve_batch(traffic: Dict, seed: int, call: int, vocab: int
                ) -> List[List[Tuple[np.ndarray, int]]]:
    """One offline batch: per replica, ``requests`` requests of
    ``(prompt ids, output tokens)``.  Prompt lengths spread evenly over
    ``prompt_len`` and output lengths are :func:`lognormal_lengths`.
    Their pairing and order are drawn from the call's index alone, since
    the order sets how the slots pack and so the rounds a batch takes:
    every seed does the same work.  The token ids are drawn from the
    seed (never 0)."""
    n = traffic["requests_per_replica"]
    lo, hi = traffic["prompt_len"]
    out_spec = traffic["output_len"]
    outs = lognormal_lengths(n, out_spec["median"], out_spec["sigma"],
                             out_spec["min"], out_spec["max"])
    prompts = np.resize(np.arange(lo, hi + 1), n)
    batch = []
    for g in range(traffic["replicas"]):
        order = rng(call, g)
        p_len = order.permutation(prompts)
        o_len = order.permutation(outs)
        gen = rng(seed, call, g)
        batch.append([(gen.integers(1, vocab, int(p), dtype=np.int64)
                       .astype(np.int32), int(o))
                      for p, o in zip(p_len, o_len)])
    return batch


def train_tokens(traffic: Dict, seed: int, step: int, vocab: int
                 ) -> np.ndarray:
    """Step ``step``'s ``(batch, seq_len)`` token ids, every row its
    own draw."""
    gen = rng(seed, step)
    return gen.integers(0, vocab, (traffic["global_batch"],
                                   traffic["seq_len"]), dtype=np.int64)
