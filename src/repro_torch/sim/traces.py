"""Request traces for the simulator (paper §5.2, Azure Conversation-like).

The paper prunes the Azure Conversation dataset to input <= 2048 and output
<= 1024, yielding 16657 requests with mean input 763 and mean output 232.
We generate a synthetic trace matched to those statistics (lognormal lengths
clipped to the caps), plus Poisson/online arrival processes scaled to a
fraction of cluster peak throughput.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Iterator, List, Optional


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    request_id: int
    arrival_s: float
    input_tokens: int
    output_tokens: int


def _lognormal_clipped(rng: random.Random, mean_target: float, cap: int,
                       sigma: float) -> int:
    # pick mu so the clipped mean approximates mean_target (sigma fixed)
    mu = math.log(mean_target) - sigma ** 2 / 2
    x = rng.lognormvariate(mu, sigma)
    return max(1, min(cap, int(x)))


def azure_conversation_lengths(rng: random.Random) -> tuple:
    """Input/output lengths matched to the pruned Azure Conversation stats
    (mean input 763 <= 2048, mean output 232 <= 1024)."""
    inp = _lognormal_clipped(rng, mean_target=820.0, cap=2048, sigma=0.9)
    out = _lognormal_clipped(rng, mean_target=250.0, cap=1024, sigma=0.8)
    return inp, out


def _poisson_gap(rng: random.Random, rate_per_s: float,
                 burstiness: float) -> float:
    """One inter-arrival gap of the (optionally bursty) Poisson process.
    ``burstiness`` in [0,1) mixes in a second, 4x-rate regime to mimic
    the diurnal bursts of the real trace."""
    rate = rate_per_s
    if burstiness and rng.random() < burstiness:
        rate *= 4.0
    return rng.expovariate(rate)


def arrival_gaps(rate_per_s: float, *, seed: int = 0,
                 burstiness: float = 0.0) -> Iterator[float]:
    """Endless inter-arrival gaps for an open-loop arrival process — the
    SAME process ``make_trace`` uses for the simulator, shared with the
    wall-clock client (``examples/openloop_client.py``) and the online
    latency benchmark so simulated and served arrivals agree."""
    rng = random.Random(seed)
    while True:
        yield _poisson_gap(rng, rate_per_s, burstiness)


def arrival_times(n: int, rate_per_s: float, *, seed: int = 0,
                  burstiness: float = 0.0) -> List[float]:
    """First ``n`` absolute arrival times of the open-loop process."""
    gaps = arrival_gaps(rate_per_s, seed=seed, burstiness=burstiness)
    t, out = 0.0, []
    for _ in range(n):
        t += next(gaps)
        out.append(t)
    return out


def make_trace(num_requests: int, arrival_rate_per_s: float,
               seed: int = 0, burstiness: float = 0.0) -> List[TraceRequest]:
    """Poisson arrivals at ``arrival_rate_per_s`` requests/s (see
    ``arrival_gaps`` for the burstiness mix)."""
    rng = random.Random(seed)
    out: List[TraceRequest] = []
    t = 0.0
    for i in range(num_requests):
        t += _poisson_gap(rng, arrival_rate_per_s, burstiness)
        inp, outp = azure_conversation_lengths(rng)
        out.append(TraceRequest(i, t, inp, outp))
    return out


def make_offline_trace(num_requests: int, seed: int = 0) -> List[TraceRequest]:
    """Offline serving: all requests available at t=0 (rate-unconstrained)."""
    rng = random.Random(seed)
    out = []
    for i in range(num_requests):
        inp, outp = azure_conversation_lengths(rng)
        out.append(TraceRequest(i, 0.0, inp, outp))
    return out


def online_rate_for_cluster(peak_decode_tokens_per_s: float,
                            utilization: float = 0.75,
                            mean_output_tokens: float = 250.0) -> float:
    """Paper: online arrivals scaled to 75% of the cluster's peak throughput."""
    return peak_decode_tokens_per_s * utilization / mean_output_tokens
