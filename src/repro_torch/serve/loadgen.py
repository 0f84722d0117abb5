"""Open-loop Poisson load generation for the serving service (a copy of
``repro/serve/loadgen.py``).

One shared arrival driver for the ``launch.serve --service`` mode, the
chaos soak (``serve/faults.py``) and ``chip_smoke.py``'s service drive:
requests fire on a precomputed exponential schedule and never wait for
earlier results — the way independent users actually load a service
(a closed loop would hide queueing collapse behind its own
self-throttling).

Adversarial knobs (ARCHITECTURE.md §Faults): a fraction of requests can
be **malformed** (shape-corrupted, so admission-time validation must
reject them without poisoning anyone else) and a fraction can be
**abandoned** (submitted with a deadline the client then walks away
from — the service must still resolve those futures, with a result or
``ServiceExpired``, never leak them).  Which requests are malformed /
abandoned is drawn from the seeded RNG, so a chaos run replays exactly.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.service import ServiceOverloaded, ServingService

__all__ = ["LoadReport", "poisson_open_loop"]


@dataclasses.dataclass
class LoadReport:
    """What one open-loop run submitted and how admission went.

    ``admitted`` pairs each accepted request's *original index* with its
    result future; ``abandoned`` holds the futures the simulated clients
    walked away from (the chaos driver still gathers them — an abandoned
    future must resolve like any other); ``malformed`` counts corrupted
    submissions rejected at validation.  Iterating yields
    ``(admitted, rejected)``, so legacy two-tuple unpacking keeps
    working.
    """

    admitted: List[Tuple[int, "asyncio.Future"]]
    rejected: int = 0
    malformed: int = 0
    abandoned: List[Tuple[int, "asyncio.Future"]] = dataclasses.field(
        default_factory=list
    )

    def __iter__(self):
        return iter((self.admitted, self.rejected))


async def poisson_open_loop(
    service: ServingService,
    name: str,
    requests: Sequence[np.ndarray],
    rate: float,
    *,
    seed: int = 0,
    preprocessed: bool = False,
    host_ingress: bool = False,
    deadline_s: Optional[float] = None,
    malformed_frac: float = 0.0,
    abandon_frac: float = 0.0,
) -> LoadReport:
    """Submit ``requests`` at Poisson rate ``rate`` (requests/s).

    Returns a :class:`LoadReport` (unpacks as the legacy
    ``(admitted, rejected)`` pair).  The caller gathers the futures (and
    normally drains the service) when the stream ends.

    ``host_ingress=True`` replays the legacy per-request host pipeline
    (the pre-device-ingress baseline the raw-path benchmarks compare
    against) via ``submit_host_nowait`` — admission still rejects
    synchronously, but the pipeline itself runs on the service's ingress
    thread so the baseline measurement does not also stall the
    coalescer's event loop.  The default raw path enqueues pixels with a
    shape check only.

    ``deadline_s`` rides on every submission (requests shed past it fail
    with ``ServiceExpired``).  ``malformed_frac`` corrupts that fraction
    of requests (last axis truncated — wrong shape) before submission;
    they must be rejected at validation (counted, not admitted).
    ``abandon_frac`` marks that fraction of *admitted* requests as
    client-abandoned: their futures land in ``report.abandoned`` instead
    of ``report.admitted``, modeling a client that stops waiting once
    its deadline passes.
    """
    if rate <= 0:
        raise ValueError("rate must be > 0")
    if not 0.0 <= malformed_frac <= 1.0:
        raise ValueError("malformed_frac must be in [0, 1]")
    if not 0.0 <= abandon_frac <= 1.0:
        raise ValueError("abandon_frac must be in [0, 1]")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, len(requests))
    malformed_mask = rng.random(len(requests)) < malformed_frac
    abandon_mask = rng.random(len(requests)) < abandon_frac
    loop = asyncio.get_running_loop()
    report = LoadReport(admitted=[])
    next_t = loop.time()
    for i, batch in enumerate(requests):
        next_t += gaps[i]
        # sleep(0) when behind schedule: still yields, so the dispatch
        # loop keeps draining while the generator catches up (open loop).
        await asyncio.sleep(max(next_t - loop.time(), 0.0))
        if malformed_mask[i]:
            # Corrupt the trailing axis: fails the cheap shape validation
            # at admission, exactly like a buggy client would.
            batch = np.asarray(batch)[..., :-1]
        try:
            if host_ingress and not preprocessed:
                fut = service.submit_host_nowait(
                    name, batch, deadline_s=deadline_s
                )
            else:
                fut = service.submit_nowait(
                    name, batch,
                    preprocessed=preprocessed, deadline_s=deadline_s,
                )
        except ServiceOverloaded:
            report.rejected += 1
            continue
        except (ValueError, TypeError):
            # Malformed submissions are rejected at validation; anything
            # the generator corrupted SHOULD land here (a corrupted
            # request that slipped through would poison its microbatch).
            report.malformed += 1
            continue
        if abandon_mask[i]:
            report.abandoned.append((i, fut))
        else:
            report.admitted.append((i, fut))
    return report
