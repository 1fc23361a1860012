"""Sustained-traffic load generation for the serve engine (port of
``repro/serve/loadgen.py``: the same draws from the same seed).

``poisson_requests`` draws a Poisson arrival process (exponential
inter-arrival gaps at ``rate_rps``) with mixed-length prompts and
decode budgets — the production-shaped traffic the continuous-batching
engine is built for (short and long requests interleaved, so a fixed
batch wastes decode steps idling finished slots).  Everything is
seeded and drawn from a private ``default_rng`` so workloads replay
bit-identically.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serve.engine import Request


def poisson_requests(n: int, *, rate_rps: float = 50.0, seed: int = 0,
                     prompt_lens=(4, 8, 12), new_tokens=(2, 32),
                     vocab_size: int = 256, users: int = 4,
                     bimodal: float = 0.5) -> list:
    """``n`` requests with Poisson arrivals and mixed lengths.

    prompt_lens: discrete prompt-length choices (few distinct lengths
    keep prefill recompiles bounded).  new_tokens: (lo, hi) decode
    budget range; ``bimodal`` is the probability of drawing from the
    short third of the range vs the long third — the mixed-length
    traffic shape where head-of-line blocking hurts a fixed batch most.
    users: round-robin-free random user pool for per-user aggregation.
    """
    rng = np.random.default_rng(seed)
    lo, hi = int(new_tokens[0]), int(new_tokens[1])
    assert hi >= lo >= 1
    span = max(hi - lo, 1)
    short_hi = lo + max(span // 3, 1)
    long_lo = hi - max(span // 3, 1)
    t = 0.0
    out = []
    for rid in range(n):
        t += float(rng.exponential(1.0 / rate_rps))
        plen = int(rng.choice(np.asarray(prompt_lens, np.int64)))
        if rng.random() < bimodal:
            mnt = int(rng.integers(lo, short_hi + 1))
        else:
            mnt = int(rng.integers(long_lo, hi + 1))
        prompt = rng.integers(1, vocab_size, size=(plen,)).astype(np.int32)
        out.append(Request(rid=rid, prompt=prompt, max_new_tokens=mnt,
                           arrival_s=t,
                           user=f"user{int(rng.integers(users))}"))
    return out
