"""Synthetic open-loop request workload for the serving engine (own copy
of ``repro.serve.workload``: the same numpy draws, so the same seed gives
the same requests in both packages).

Open-loop means arrivals follow an external clock (a Poisson process)
independent of service progress: when the server falls behind, the queue
grows.  Arrival times are seconds for the wall-clock engine, or decode-step
indices for the deterministic ``"steps"`` clock.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One inference request of the open-loop stream."""
    rid: int
    arrival: float                # seconds (wall clock) or steps (virtual)
    prompt: tuple[int, ...]       # token ids
    gen_len: int                  # tokens to generate (incl. the first)


def open_loop_requests(n: int, rate: float, vocab_size: int,
                       prompt_lens: tuple[int, ...] = (8, 16, 32),
                       gen_lens: tuple[int, ...] = (4, 8, 16, 48),
                       seed: int = 0) -> list[Request]:
    """Sample ``n`` requests with exponential inter-arrival gaps at
    ``rate`` requests per clock unit (first arrival at t=0), uniform choice
    of prompt/generation lengths, and uniform random prompt tokens."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    gaps[0] = 0.0
    arrivals = np.cumsum(gaps)
    out = []
    for i in range(n):
        plen = int(rng.choice(prompt_lens))
        glen = int(rng.choice(gen_lens))
        prompt = tuple(int(t) for t in
                       rng.integers(0, vocab_size, size=plen))
        out.append(Request(rid=i, arrival=float(arrivals[i]),
                           prompt=prompt, gen_len=glen))
    return out
