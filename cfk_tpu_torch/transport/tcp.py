"""TCP Transport client for the port's log broker
(``cfk_tpu_torch/csrc/host/cfk_broker.cpp``).

The port of ``cfk_tpu/transport/tcp.py``.  The reference's durable-log
service is a Kafka broker reached over TCP (``apps/BaseKafkaApp.java:19``
hardcodes ``localhost:29092``); this is the framework's native equivalent —
``TcpBrokerClient`` implements the same ``Transport`` protocol as
``InMemoryBroker``/``FileBroker``, so ingest's EOF-barrier protocol, the
checkpoint journal, the streaming consumer and the serving fleet run
unchanged against a broker *process*, across process and host boundaries.
The wire protocol and the data directory's format are the JAX package's, so
either package's client talks to either package's broker.

Throughput comes from batching, the same lever as the reference's Kafka
producer (async sends, unbounded ``buffer.memory``,
``producers/NetflixDataFormatProducer.java:31-33``): ``produce`` buffers
records client-side and ships one PRODUCE_BATCH frame per
``batch_records``/``batch_bytes`` window.  Read-your-writes holds because
every read operation (``consume``/``end_offset``) flushes the buffer first.

Wire protocol: see the header comment of ``csrc/host/cfk_broker.cpp``.
The broker executable is built from that source by ``_build.build_broker``
(the host C++ compiler, into ``cfk_tpu_torch/_build/``) on first use.
"""

from __future__ import annotations

import os
import socket
import struct
import subprocess
import threading
import time
from typing import Iterator

from cfk_tpu_torch.transport.broker import Record

_OP_CREATE_TOPIC = 1
_OP_PRODUCE_BATCH = 2
_OP_FETCH = 3
_OP_NUM_PARTITIONS = 4
_OP_END_OFFSET = 5
_OP_DELETE_TOPIC = 6
_OP_PING = 7
_OP_LIST_TOPICS = 8

# Keep every request body under the server's 64 MiB frame cap (cfk_broker's
# kMaxBodyLen) with headroom for the op/name/count framing; the server closes
# the connection on an oversized frame rather than answering with an error.
_MAX_BATCH_BYTES = (64 << 20) - 4096


class BrokerRequestError(RuntimeError):
    """The broker rejected a request (unknown topic, bad partition, ...)."""


def _recv_exact(sock: socket.socket, n: int, timeouts: int = 0) -> bytes:
    """Read exactly ``n`` bytes; with a socket read timeout set, tolerate
    up to ``timeouts`` CONSECUTIVE timeout windows (a congested broker
    delaying frames is a delay, not a death — the bytes already read stay
    accumulated, and any received chunk resets the window count, so a
    large response making steady slow progress never fails) before
    letting the timeout escape."""
    chunks = []
    waits = 0
    while n > 0:
        try:
            chunk = sock.recv(n)
        except TimeoutError:
            waits += 1
            if waits > timeouts:
                raise
            continue
        if not chunk:
            raise ConnectionError("broker closed the connection")
        waits = 0
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


class TcpBrokerClient:
    """Transport over one TCP connection to a cfk_broker server.

    Thread-safe: one lock serializes the request frames and the produce
    buffer, so threads that share a client (a serving fleet's replicas)
    take turns on the connection instead of interleaving frames on it.
    The JAX package's client has no lock, and its fleet shares one client
    between replica threads; open one client per thread for throughput.

    Connection setup retries with exponential backoff + jitter
    (``cfk_tpu_torch.resilience.retry``): each attempt dials under
    ``connect_timeout`` and then PINGs, so a listener whose accept loop is
    dead or dying (the half-up broker a fixed-interval poll hammers
    forever) is detected and retried instead of wedging the first real
    request.  ``read_timeout`` bounds every response read; up to
    ``read_retries`` consecutive timeout windows are tolerated per read
    (delayed frames — congestion — are waited out, a closed connection
    still fails fast).
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        batch_records: int = 4096,
        batch_bytes: int = 1 << 20,
        fetch_records: int = 8192,
        fetch_bytes: int = 4 << 20,
        connect_timeout: float = 5.0,
        connect_retries: int = 3,
        retry_base: float = 0.05,
        read_timeout: float | None = None,
        read_retries: int = 3,
    ) -> None:
        from cfk_tpu_torch.resilience.retry import retry_call

        def dial() -> socket.socket:
            sock = socket.create_connection(
                (host, port), timeout=connect_timeout
            )
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # Liveness handshake: a PING proves the broker's serving
                # loop (not just its accept backlog) is up — a dropped
                # connection surfaces here, inside the retry, instead of
                # poisoning the caller's first real request.
                sock.sendall(struct.pack(">I", 1) + bytes([_OP_PING]))
                (blen,) = struct.unpack(">I", _recv_exact(sock, 4))
                _recv_exact(sock, blen)
                return sock
            except BaseException:
                sock.close()
                raise
        self._sock = retry_call(
            dial,
            retries=connect_retries,
            retry_on=(OSError,),
            base=retry_base,
            describe=f"connect to broker {host}:{port}",
        )
        self._sock.settimeout(read_timeout)
        self._lock = threading.RLock()
        self._read_retries = read_retries
        self._batch_records = batch_records
        self._batch_bytes = batch_bytes
        self._fetch_records = fetch_records
        self._fetch_bytes = fetch_bytes
        # Pending PRODUCE buffer: topic → (list of encoded records, bytes).
        self._pending: dict[str, list[bytes]] = {}
        self._pending_count = 0
        self._pending_bytes = 0

    # -- request plumbing ---------------------------------------------------

    def _request(self, body: bytes) -> bytes:
        # A timeout or transport error that escapes mid-frame leaves the
        # stream desynced (a later read would parse leftover payload
        # bytes as a length header) — the connection is unusable, so
        # close it and fail every subsequent request loudly instead of
        # silently mis-framing.
        with self._lock:
            try:
                self._sock.sendall(struct.pack(">I", len(body)) + body)
                (blen,) = struct.unpack(
                    ">I", _recv_exact(self._sock, 4, self._read_retries)
                )
                resp = _recv_exact(self._sock, blen, self._read_retries)
            except (TimeoutError, ConnectionError, OSError):
                self._sock.close()
                raise
        if resp[0] == 0:
            return resp[1:]
        (mlen,) = struct.unpack(">H", resp[1:3])
        message = resp[3 : 3 + mlen].decode("utf-8", "replace")
        if "unknown topic" in message:
            # Same exception type as the in-process Transports, so callers'
            # provision-before-run handling is implementation-agnostic.
            raise KeyError(message)
        raise BrokerRequestError(message)

    @staticmethod
    def _name(topic: str) -> bytes:
        raw = topic.encode()
        if len(raw) > 249:  # Kafka's own topic-name limit; also keeps the
            # name framing inside _MAX_BATCH_BYTES's request-frame headroom.
            raise ValueError(f"topic name too long ({len(raw)} bytes, max 249)")
        return struct.pack(">H", len(raw)) + raw

    # -- Transport protocol -------------------------------------------------

    def create_topic(self, name: str, num_partitions: int) -> None:
        if num_partitions < 1:
            raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
        try:
            self._request(
                bytes([_OP_CREATE_TOPIC]) + self._name(name)
                + struct.pack(">I", num_partitions)
            )
        except BrokerRequestError as e:
            if "already exists" in str(e):
                raise ValueError(str(e)) from None
            raise

    def delete_topic(self, name: str) -> None:
        with self._lock:
            dropped = self._pending.pop(name, [])
            self._pending_count -= len(dropped)
            self._pending_bytes -= sum(len(r) for r in dropped)
            self._request(bytes([_OP_DELETE_TOPIC]) + self._name(name))

    def produce(
        self, topic: str, key: int, value: bytes, partition: int | None = None
    ) -> None:
        if partition is None and key < 0:
            # Fail on the client, matching mod_partition's contract; the
            # server enforces the same rule.
            raise ValueError(
                f"negative key {key} requires an explicit partition="
            )
        if len(value) > _MAX_BATCH_BYTES:
            # The server closes the connection on an oversized frame with no
            # error response — fail loudly here instead.
            raise ValueError(
                f"record of {len(value)} bytes exceeds the broker's "
                f"{_MAX_BATCH_BYTES}-byte frame budget"
            )
        # Validate the name before buffering: raising at flush time would
        # surface far from the faulty call and drop the sub-batch.
        self._name(topic)
        rec = struct.pack(
            ">iiI", -1 if partition is None else partition, key, len(value)
        ) + value
        with self._lock:
            self._pending.setdefault(topic, []).append(rec)
            self._pending_count += 1
            self._pending_bytes += len(rec)
            if (
                self._pending_count >= self._batch_records
                or self._pending_bytes >= self._batch_bytes
            ):
                self.flush()

    def flush(self) -> None:
        """Ship all buffered records (PRODUCE_BATCH requests per topic,
        split into sub-batches that fit the server's request frame cap).

        On a failed request the unsent records are restored to the buffer.
        The failing sub-batch itself is restored only for an unknown-topic
        rejection (KeyError) — the server validates the whole batch before
        appending anything, so "create the topic, flush again" loses
        nothing.  Other rejections (bad partition, malformed record) would
        fail identically on retry, so that sub-batch is dropped with the
        raised error as the caller's signal; a transport failure mid-request
        (ConnectionError) leaves it in doubt.
        """
        with self._lock:
            self._flush()

    def _flush(self) -> None:
        pending, self._pending = self._pending, {}
        self._pending_count = self._pending_bytes = 0

        def restore(topic, recs):
            if not recs:
                return
            restored = self._pending.setdefault(topic, [])
            restored[:0] = recs
            self._pending_count += len(recs)
            self._pending_bytes += sum(len(r) for r in recs)

        topics = list(pending)
        for i, topic in enumerate(topics):
            recs = pending[topic]
            done = 0
            while done < len(recs):
                end, size = done, 0
                while end < len(recs) and (
                    end == done or size + len(recs[end]) <= _MAX_BATCH_BYTES
                ):
                    size += len(recs[end])
                    end += 1
                chunk = recs[done:end]
                try:
                    self._request(
                        bytes([_OP_PRODUCE_BATCH]) + self._name(topic)
                        + struct.pack(">I", len(chunk)) + b"".join(chunk)
                    )
                except Exception as e:
                    tail = done if isinstance(e, KeyError) else end
                    restore(topic, recs[tail:])
                    for unsent in topics[i + 1:]:
                        restore(unsent, pending[unsent])
                    raise
                done = end

    def consume(
        self, topic: str, partition: int, start_offset: int = 0
    ) -> Iterator[Record]:
        self.flush()
        offset = start_offset
        # Snapshot semantics like the other Transports: stop at the log end
        # observed on the FIRST fetch — a concurrent producer must not turn
        # this iterator into an endless tail.
        snapshot_end: int | None = None
        while True:
            resp = self._request(
                bytes([_OP_FETCH]) + self._name(topic)
                + struct.pack(
                    ">IQII", partition, offset,
                    self._fetch_records, self._fetch_bytes,
                )
            )
            log_end, count = struct.unpack(">QI", resp[:12])
            if snapshot_end is None:
                snapshot_end = log_end
            pos = 12
            for _ in range(count):
                key, vlen = struct.unpack(">iI", resp[pos : pos + 8])
                pos += 8
                if offset >= snapshot_end:
                    return
                yield Record(key=key, value=resp[pos : pos + vlen], offset=offset)
                pos += vlen
                offset += 1
            if count == 0 or offset >= snapshot_end:
                return

    def num_partitions(self, topic: str) -> int:
        resp = self._request(bytes([_OP_NUM_PARTITIONS]) + self._name(topic))
        return struct.unpack(">I", resp)[0]

    def end_offset(self, topic: str, partition: int) -> int:
        self.flush()
        resp = self._request(
            bytes([_OP_END_OFFSET]) + self._name(topic)
            + struct.pack(">I", partition)
        )
        return struct.unpack(">Q", resp)[0]

    # -- extras -------------------------------------------------------------

    def ping(self) -> None:
        self._request(bytes([_OP_PING]))

    def topics(self) -> list[str]:
        resp = self._request(bytes([_OP_LIST_TOPICS]))
        (count,) = struct.unpack(">I", resp[:4])
        names, pos = [], 4
        for _ in range(count):
            (nlen,) = struct.unpack(">H", resp[pos : pos + 2])
            pos += 2
            names.append(resp[pos : pos + nlen].decode())
            pos += nlen
        return names

    def close(self, *, flush: bool = True) -> None:
        try:
            if flush:
                self.flush()
        finally:
            self._sock.close()

    def __enter__(self) -> "TcpBrokerClient":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        # Don't let a failing exit-time flush replace the body's exception.
        self.close(flush=exc_type is None)


def build_broker() -> str:
    """The broker executable's path, compiled from
    ``csrc/host/cfk_broker.cpp`` first if missing (a file named by the
    source's hash, so an edited source is rebuilt).  Raises with the
    compiler's output if it cannot be built."""
    from cfk_tpu_torch import _build

    return str(_build.build_broker())


class BrokerProcess:
    """Spawn a cfk_broker server subprocess and wait until it listens.

    ``port=0`` picks an ephemeral port (read back from the server's
    ``CFK_BROKER LISTENING <port>`` line).  ``data_dir=None`` runs the broker
    memory-only; with a directory, logs persist in the FileBroker on-disk
    format and survive restarts.
    """

    def __init__(
        self, port: int = 0, data_dir: str | None = None, *, timeout: float = 10.0
    ) -> None:
        argv = [build_broker(), str(port)] + ([data_dir] if data_dir else [])
        self.proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL
        )
        # Raw nonblocking reads under a select deadline: buffered readline()
        # would block past the timeout on a partial line (a wedged server),
        # and select() cannot see data already inside a stdio buffer.
        import select

        from cfk_tpu_torch.resilience.retry import backoff_delays

        # EOF-while-alive poll cadence: jittered exponential backoff
        # instead of the old fixed 0.05 s spin — many workers waiting on
        # one broker no longer wake in lockstep.
        delays = backoff_delays(base=0.02, max_delay=0.25)
        deadline = time.monotonic() + timeout
        fd = self.proc.stdout.fileno()
        os.set_blocking(fd, False)
        buf = b""
        while True:
            nl = buf.find(b"\n")
            if nl >= 0:
                line, buf = buf[:nl], buf[nl + 1:]
                if b"LISTENING" in line:
                    self.port = int(line.strip().rsplit(b" ", 1)[-1])
                    break
                continue
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"cfk_broker exited with {self.proc.returncode}"
                )
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.terminate()
                raise TimeoutError("cfk_broker did not start listening in time")
            ready, _, _ = select.select([fd], [], [], min(remaining, 0.5))
            if ready:
                try:
                    chunk = os.read(fd, 4096)
                except BlockingIOError:
                    chunk = b""
                if chunk:
                    buf += chunk
                else:
                    # EOF while still alive: don't spin on the always-ready
                    # fd; the poll() check above reports the exit.
                    time.sleep(min(next(delays), max(0.0, remaining)))

    def connect(self, **kwargs) -> TcpBrokerClient:
        return TcpBrokerClient("127.0.0.1", self.port, **kwargs)

    def terminate(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()

    def __enter__(self) -> "BrokerProcess":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()
