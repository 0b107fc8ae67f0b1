"""Open-loop synthetic load generator for the serve path.

The port of ``cfk_tpu/serving/loadgen.py``.  Open loop: request i is
scheduled at ``i / rate`` and sent when the clock passes it, never gated on
responses, and its latency is counted from the SCHEDULED send — so a backlog
in the generator counts against the server, as it would for real clients
(no coordinated omission).  Users are drawn Zipf-skewed from a seed.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from cfk_tpu_torch.telemetry.metrics import Histogram

# Big enough that a run of up to 4096 requests keeps every latency sample
# (exact quantiles); bounded beyond it.
LATENCY_RESERVOIR = 4096


@dataclasses.dataclass(frozen=True)
class LoadReport:
    """One open-loop run's measured outcome."""

    num_requests: int
    answered: int
    wall_s: float
    qps_target: float
    qps_achieved: float
    p50_ms: float
    p99_ms: float
    max_ms: float
    batches: int
    mean_batch: float

    def as_row(self) -> dict:
        return {
            "requests": self.num_requests,
            "answered": self.answered,
            "wall_s": round(self.wall_s, 4),
            "qps_target": round(self.qps_target, 1),
            "qps": round(self.qps_achieved, 1),
            "p50_ms": round(self.p50_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
            "max_ms": round(self.max_ms, 3),
            "batches": self.batches,
            "mean_batch": round(self.mean_batch, 1),
        }


def zipf_user_rows(num_users: int, n: int, *, seed: int = 0,
                   a: float = 1.2) -> np.ndarray:
    """n user rows with a Zipf(a) popularity skew over the row space."""
    rng = np.random.default_rng(seed)
    return ((rng.zipf(a, size=n) - 1) % num_users).astype(np.int64)


def warm_serve_programs(client, server, pool, k: int, max_batch: int) -> None:
    """Serve one coalesced batch at every pow2 size below ``max_batch`` and
    at ``max_batch`` itself, before a measured run."""
    pool = np.asarray(pool, np.int64)
    sizes = []
    warm = 4
    while warm < max_batch:
        sizes.append(warm)
        warm *= 2
    sizes.append(max_batch)
    for s in sizes:
        take = pool[: min(s, pool.shape[0])]
        if take.shape[0]:
            client.ask(take, k, server=server)


def run_open_loop(client, *, rate_qps: float, num_requests: int, user_rows,
                  k: int = 10, server=None, drive_server: bool = False,
                  timeout_s: float = 120.0, clock=time.monotonic,
                  sleep=time.sleep) -> LoadReport:
    """Send ``num_requests`` at ``rate_qps`` open-loop; block for the tail.

    ``drive_server=True`` pumps ``server.step()`` inline between sends (one
    interpreter for generator and server)."""
    user_rows = np.asarray(user_rows, np.int64)
    if user_rows.shape[0] < num_requests:
        user_rows = np.resize(user_rows, num_requests)
    outstanding: dict[int, float] = {}  # req_id -> scheduled send time
    lat = Histogram("serve_request_latency_ms", reservoir=LATENCY_RESERVOIR)
    batches_before = getattr(server, "batches", 0)

    def drain():
        for resp in client.poll_responses():
            scheduled = outstanding.pop(resp.req_id, None)
            if scheduled is not None:
                lat.observe((clock() - scheduled) * 1e3)

    t0 = clock()
    for i in range(num_requests):
        scheduled = t0 + i / rate_qps
        while True:
            now = clock()
            if now >= scheduled:
                break
            if drive_server and server is not None and server.step():
                drain()
                continue
            drain()
            sleep(min(scheduled - now, 0.001))
        rid = client.request(int(user_rows[i]), k)
        client.flush()
        outstanding[rid] = scheduled
        drain()
    deadline = clock() + timeout_s
    while outstanding:
        if drive_server and server is not None:
            server.step()
        drain()
        if clock() > deadline:
            break
        if not drive_server:
            sleep(0.001)
    wall = max(clock() - t0, 1e-9)
    answered = lat.count
    if answered == 0:
        raise TimeoutError(
            f"no responses within {timeout_s}s — server not draining")
    batches = getattr(server, "batches", 0) - batches_before
    return LoadReport(
        num_requests=num_requests, answered=answered, wall_s=wall,
        qps_target=rate_qps, qps_achieved=answered / wall,
        p50_ms=lat.quantile(0.5), p99_ms=lat.quantile(0.99), max_ms=lat.max,
        batches=int(batches),
        mean_batch=(answered / batches if batches else 0.0),
    )
