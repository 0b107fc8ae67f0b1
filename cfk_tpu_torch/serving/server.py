"""Request server: top-K queries over a partitioned log.

The port of ``cfk_tpu/serving/server.py`` for one server: requests arrive on
the ``serve-requests`` topic, everything pending (up to ``max_batch``) is
coalesced into ONE scoring batch through the ``ServeEngine``, and answers go
to the ``serve-responses`` partition the client named.  Under open-loop load
a busy server finds more requests per poll, so the batch size tunes itself.
A malformed frame is counted and skipped (the cursor moves past it); a
request for an unknown user or a bad k gets an error response without
failing its co-batched neighbours.

The fleet's seams (``serving.fleet``): a server may own only some request
partitions (``partitions``; a replica owns partition i of N), shed a poll's
backlog beyond an admission controller's depth with explicit retriable
rejections (``admission``), stamp every response with its epoch and a
staleness bound (``staleness_fn``), and label its /metrics samples
(``labels``).  Its read cursors are committed only after a batch's
responses are flushed (``committed_cursors``): a survivor that adopts a
dead replica's partition there re-serves whatever was polled but never
answered.
"""

from __future__ import annotations

import os
import time

import numpy as np

from cfk_tpu_torch.resilience.retry import backoff_delays
from cfk_tpu_torch.serving.topk_kernel import _pow2_ceil
from cfk_tpu_torch.telemetry import record_event, span
from cfk_tpu_torch.telemetry.metrics import Metrics
from cfk_tpu_torch.transport.serdes import (
    ScoreRequest,
    ScoreResponse,
    decode_score_request,
    decode_score_response,
    encode_score_request,
    encode_score_response,
)

REQUESTS_TOPIC = "serve-requests"
RESPONSES_TOPIC = "serve-responses"


def ensure_serve_topics(transport, *, requests_topic: str = REQUESTS_TOPIC,
                        responses_topic: str = RESPONSES_TOPIC,
                        request_partitions: int = 1,
                        response_partitions: int = 1) -> None:
    """Create the serve topics if absent."""
    for name, parts in ((requests_topic, request_partitions),
                        (responses_topic, response_partitions)):
        try:
            transport.num_partitions(name)
        except KeyError:
            transport.create_topic(name, parts)


class RecommendServer:
    """Drain score requests from the log, answer in coalesced batches."""

    def __init__(self, engine, transport, *,
                 requests_topic: str = REQUESTS_TOPIC,
                 responses_topic: str = RESPONSES_TOPIC,
                 max_batch: int = 256, poll_wait_s: float = 0.002,
                 metrics=None, metrics_port: int | None = None,
                 partitions=None, admission=None, staleness_fn=None,
                 labels: dict | None = None) -> None:
        self.engine = engine
        self.transport = transport
        self.requests_topic = requests_topic
        self.responses_topic = responses_topic
        self.max_batch = int(max_batch)
        self.poll_wait_s = poll_wait_s
        self.metrics = metrics if metrics is not None else Metrics()
        self.admission = admission
        self._staleness_fn = staleness_fn
        own = (range(transport.num_partitions(requests_topic))
               if partitions is None else [int(p) for p in partitions])
        self._cursors = {p: 0 for p in own}
        # Moved only after a batch's responses are flushed: the failover
        # handoff point (at-least-once; clients dedup by req_id).
        self.committed_cursors = dict(self._cursors)
        self.requests_served = 0
        self.batches = 0
        self.malformed_requests = 0
        self.shed = 0
        # Live export: with a port, GET /metrics answers the Prometheus text
        # of ``self.metrics`` while batches are in flight (0 binds an
        # ephemeral port: read it back from ``metrics_server.port``);
        # /readyz reports the engine's readiness; ``labels`` ride every
        # sample (a replica's index).  ``close()`` stops it.
        self.metrics_server = None
        if metrics_port is not None:
            from cfk_tpu_torch.telemetry import MetricsHTTPServer

            self.metrics_server = MetricsHTTPServer(
                self.metrics, port=int(metrics_port), labels=labels,
                ready_fn=lambda: self.ready).start()

    @property
    def ready(self) -> bool:
        return bool(getattr(self.engine, "ready", True))

    def adopt_partition(self, partition: int, cursor: int = 0) -> None:
        """Take over a request partition at ``cursor`` (failover: a dead
        replica's partition at its committed cursor)."""
        p = int(partition)
        self._cursors[p] = int(cursor)
        self.committed_cursors[p] = int(cursor)

    def close(self) -> None:
        """Stop the /metrics endpoint, if one runs."""
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None

    def _poll_requests(self) -> list[ScoreRequest]:
        """Everything pending, up to ``max_batch``, in (partition, offset)
        order; a malformed frame is skipped, never re-read."""
        out: list[ScoreRequest] = []
        for p in sorted(self._cursors):
            if len(out) >= self.max_batch:
                break
            take = self.max_batch - len(out)
            got = 0
            for rec in self.transport.consume(self.requests_topic, p,
                                              self._cursors[p]):
                got += 1
                try:
                    out.append(decode_score_request(rec.value))
                except ValueError:
                    self.malformed_requests += 1
                    self.metrics.incr("serve_malformed_requests")
                if got >= take:
                    break
            self._cursors[p] += got
        return out

    def _stamp(self, engine) -> tuple[int, int]:
        """(epoch, staleness) for a batch ``engine`` serves; a staleness
        that cannot be read is -1, never a silent 0."""
        epoch = int(getattr(engine, "epoch", 0))
        stale = 0
        if self._staleness_fn is not None:
            try:
                stale = int(self._staleness_fn())
            except Exception:
                stale = -1
        return epoch, stale

    def step(self) -> int:
        """Serve ONE coalesced batch; returns the requests answered (0 =
        nothing pending).  Requests shed by admission control are answered
        too, with a retriable rejection, and count in the return value."""
        nresp = self.transport.num_partitions(self.responses_topic)
        reqs = []
        for r in self._poll_requests():
            if 0 <= r.reply_partition < nresp:
                reqs.append(r)
            else:  # nowhere to answer: counted and dropped
                self.malformed_requests += 1
                self.metrics.incr("serve_malformed_requests")
        if not reqs:
            return 0
        shed: list[ScoreRequest] = []
        if self.admission is not None:
            reqs, shed = self.admission.admit(reqs)
        t_batch = time.perf_counter()
        # One engine for the whole batch: a rollover flip between batches
        # never shows a batch two epochs' tables.
        engine = self.engine
        epoch, staleness = self._stamp(engine)
        with self.metrics.phase("serve_batch"), \
                span("serve/batch", requests=len(reqs), shed=len(shed)):
            with span("serve/batch/validate", requests=len(reqs)):
                valid: list[ScoreRequest] = []
                errors: list[ScoreRequest] = []
                for r in reqs:
                    ok = (0 <= r.user < engine.num_users
                          and 1 <= r.k <= engine.num_movies)
                    (valid if ok else errors).append(r)
            responses: list[tuple[int, ScoreResponse]] = []
            stamp = dict(epoch=epoch, staleness=staleness)
            if valid:
                k_pad = min(_pow2_ceil(max(r.k for r in valid),
                                       min(8, engine.num_movies)),
                            engine.num_movies)
                rows = np.asarray([r.user for r in valid], np.int64)
                # engine.topk opens the serve/batch/assemble and compute
                # spans: the kernel side of this batch's timeline
                scores, ids = engine.topk(rows, k_pad)
                for i, r in enumerate(valid):
                    responses.append((r.reply_partition, ScoreResponse(
                        req_id=r.req_id, movie_rows=ids[i, : r.k],
                        scores=scores[i, : r.k], **stamp)))
            for r in errors:
                responses.append((r.reply_partition, ScoreResponse(
                    req_id=r.req_id, movie_rows=np.zeros(0, np.int32),
                    scores=np.zeros(0, np.float32),
                    error=(f"user row {r.user} out of range "
                           f"[0, {engine.num_users}) or k {r.k} "
                           f"outside [1, {engine.num_movies}]"),
                    **stamp)))
            for r in shed:
                # Answered, not dropped: the client backs off and re-sends.
                responses.append((r.reply_partition, ScoreResponse(
                    req_id=r.req_id, movie_rows=np.zeros(0, np.int32),
                    scores=np.zeros(0, np.float32),
                    error="overloaded: admission queue depth exceeded",
                    retriable=True, **stamp)))
            with span("serve/batch/respond", responses=len(responses)):
                for part, resp in responses:
                    self.transport.produce(
                        self.responses_topic,
                        key=int(resp.req_id % (1 << 31)),
                        value=encode_score_response(resp), partition=part)
                flush = getattr(self.transport, "flush", None)
                if flush is not None:
                    flush()
        # The responses are durable: commit the read cursors.
        self.committed_cursors.update(self._cursors)
        self.requests_served += len(reqs)
        self.batches += 1
        self.metrics.incr("serve_requests", len(reqs))
        self.metrics.incr("serve_batches")
        if shed:
            self.shed += len(shed)
            self.metrics.incr("serve_shed", len(shed))
            record_event("serve", "shed", requests=len(shed),
                         served=len(reqs))
        self.metrics.observe("serve_batch_ms",
                             (time.perf_counter() - t_batch) * 1e3)
        self.metrics.observe("serve_batch_size", len(reqs))
        record_event("serve", "batch", requests=len(reqs), batch=self.batches)
        return len(reqs) + len(shed)

    def serve_forever(self, *, max_requests: int | None = None,
                      idle_timeout_s: float | None = None, stop=None) -> int:
        """Poll-and-serve loop; returns requests served.  Stops when
        ``stop()`` is true, after ``max_requests``, or after
        ``idle_timeout_s`` without a request."""
        served = 0
        idle_since = time.monotonic()
        while True:
            if stop is not None and stop():
                return served
            if max_requests is not None and served >= max_requests:
                return served
            got = self.step()
            if got:
                served += got
                idle_since = time.monotonic()
                continue
            if (idle_timeout_s is not None
                    and time.monotonic() - idle_since >= idle_timeout_s):
                return served
            time.sleep(self.poll_wait_s)


class ServeClient:
    """Produce score requests, consume this client's response partition."""

    def __init__(self, transport, *, reply_partition: int = 0,
                 requests_topic: str = REQUESTS_TOPIC,
                 responses_topic: str = RESPONSES_TOPIC,
                 route_by_user: bool = False) -> None:
        self.transport = transport
        self.requests_topic = requests_topic
        self.responses_topic = responses_topic
        self.reply_partition = int(reply_partition)
        # Fleet routing: user % N pins a user's requests to one replica's
        # partition (and so to its hot-row overlay); otherwise req_ids
        # spread over the partitions.
        self.route_by_user = bool(route_by_user)
        self._req_parts = transport.num_partitions(requests_topic)
        # A random 40-bit base: two clients that share a response partition
        # by mistake cannot confuse each other's answers.
        self._next_req = int.from_bytes(os.urandom(5), "big") << 16
        self._cursor = transport.end_offset(responses_topic, reply_partition)
        self.malformed_responses = 0
        self.retries = 0
        self.rejections = 0

    def request(self, user: int, k: int) -> int:
        """Send one query; returns its req_id."""
        req_id = self._next_req
        self._next_req += 1
        part = (int(user) if self.route_by_user else req_id) % self._req_parts
        self.transport.produce(
            self.requests_topic, key=int(user) % (1 << 31),
            value=encode_score_request(ScoreRequest(
                req_id=req_id, user=int(user), k=int(k),
                reply_partition=self.reply_partition)),
            partition=part)
        return req_id

    def flush(self) -> None:
        flush = getattr(self.transport, "flush", None)
        if flush is not None:
            flush()

    def poll_responses(self) -> list[ScoreResponse]:
        """All responses since the last poll; a malformed frame is counted
        and skipped."""
        out = []
        seen = 0
        for rec in self.transport.consume(self.responses_topic,
                                          self.reply_partition, self._cursor):
            seen += 1
            try:
                out.append(decode_score_response(rec.value))
            except ValueError:
                self.malformed_responses += 1
        self._cursor += seen
        return out

    def ask(self, users, k: int, *, server=None, timeout_s: float = 30.0,
            poll_wait_s: float = 0.002, retries: int = 3,
            backoff_base: float = 0.02, rng=None,
            sleep=time.sleep) -> dict[int, ScoreResponse]:
        """Send, then poll until every response is back, driving
        ``server.step()`` inline when a server is given.  Returns {req_id:
        response} keyed by the first attempt's req_ids.  The poll window
        splits over ``retries + 1`` attempts with jittered exponential
        backoff; a retriable refusal or a missing answer is re-sent; the
        final failure is a TimeoutError."""
        self.flush()
        ids = [self.request(int(u), k) for u in users]
        self.flush()
        user_of = {rid: int(u) for rid, u in zip(ids, users)}
        alias: dict[int, int] = {}
        got: dict[int, ScoreResponse] = {}
        attempts = max(int(retries), 0) + 1
        window = max(timeout_s / attempts, poll_wait_s)
        delays = backoff_delays(base=backoff_base, rng=rng)
        rejected: set[int] = set()

        def drain() -> None:
            for resp in self.poll_responses():
                orig = alias.get(resp.req_id, resp.req_id)
                if orig not in user_of:
                    continue
                if resp.retriable:
                    self.rejections += 1
                    rejected.add(orig)
                    continue
                got.setdefault(orig, resp)

        for attempt in range(attempts):
            deadline = time.monotonic() + window
            rejected.clear()
            while set(user_of) - set(got):
                if server is not None:
                    server.step()
                drain()
                missing_now = set(user_of) - set(got)
                if missing_now:
                    if missing_now <= rejected or time.monotonic() > deadline:
                        break
                    if server is None:
                        sleep(poll_wait_s)
            missing = set(user_of) - set(got)
            if not missing:
                return got
            if attempt == attempts - 1:
                break
            sleep(next(delays))
            for orig in sorted(missing):
                alias[self.request(user_of[orig], k)] = orig
                self.retries += 1
            self.flush()
        raise TimeoutError(
            f"{len(set(user_of) - set(got))} of {len(ids)} responses "
            f"missing after {timeout_s}s ({attempts} attempts, "
            f"{self.rejections} rejections seen)"
        )
