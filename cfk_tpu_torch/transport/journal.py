"""Factor journal: per-iteration factor checkpoints through the Transport.

The port's copy of ``cfk_tpu/transport/journal.py``, with its topics,
frames and commit markers, so a journal written by either package restores
in the other.  The factors are torch tensors (on any device) or host
arrays; bfloat16 factors travel as float32 frames and restore as torch
bfloat16 tensors, as ``transport.checkpoint`` stores them.

The reference journals every iteration's factors through per-iteration Kafka
topics — ``user-features-i`` / ``movie-features-i``, provisioned by
``setup.sh:18-21`` and written by the calculators every half-iteration
(``apps/ALSApp.java:115-151``) — but nothing ever reads them back; a crash
restarts from scratch (``apps/BaseKafkaApp.java:36``).  This module keeps the
"topics ARE the durable checkpoint" design and adds the missing half: resume.

``JournalCheckpointManager`` exposes the same surface as the npz-directory
``CheckpointManager`` (``save``/``restore``/``latest_iteration``/
``iterations``), so every trainer accepts either, and is backed by any
``Transport`` — ``FileBroker`` for a durable on-disk journal, a
TCP broker client (the serving-transport slice), or
``InMemoryBroker`` in tests.  Factor rows travel as ``FeatureRecord`` wire
frames (``cfk_tpu_torch.transport.serdes``, byte-compatible with the reference's
``FeatureMessage`` serde), mod-N partitioned by entity row — the
``PureModStreamPartitioner`` rule.  A commit marker written after both
topics makes an iteration resumable: a crash mid-journal leaves topics
without a marker, and they are ignored (and rewritten) on the next save.

The npz ``CheckpointManager`` remains the fast local default; the journal is
the durable/remote option, and the live consumer of the FeatureRecord codec.
"""

from __future__ import annotations

import json

import numpy as np

import torch

from cfk_tpu_torch.transport.checkpoint import CheckpointState, _host

_COMMITS = "checkpoint-commits"
# Frame layout of one journaled factor row (FeatureRecord with no dependents):
# int32 id | int32 ndep=0 | int32 k | float32[k] — all big-endian.
_ROW_HEADER_BYTES = 12


def encode_feature_rows(matrix: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Vectorized FeatureRecord frames: [n, 12 + 4k] uint8, one row each.

    Byte-identical to ``serdes.encode_feature(FeatureRecord(id=row,
    dependent_ids=(), features=matrix[i]))`` — the round-trip test asserts
    this — but built with bulk numpy ops so journaling 500k-row factor
    matrices never loops in Python.
    """
    n, k = matrix.shape
    buf = np.empty((n, _ROW_HEADER_BYTES + 4 * k), np.uint8)
    buf[:, 0:4] = (
        np.ascontiguousarray(rows.astype(">i4")).view(np.uint8).reshape(n, 4)
    )
    buf[:, 4:8] = np.frombuffer(np.array(0, ">i4").tobytes(), np.uint8)
    buf[:, 8:12] = np.frombuffer(np.array(k, ">i4").tobytes(), np.uint8)
    buf[:, 12:] = (
        np.ascontiguousarray(matrix.astype(">f4")).view(np.uint8).reshape(n, 4 * k)
    )
    return buf


def decode_feature_rows(
    blob: bytes, count: int, rank: int
) -> tuple[np.ndarray, np.ndarray]:
    """(row ids [n], factors [n, rank]) from ``count`` concatenated frames."""
    frame = _ROW_HEADER_BYTES + 4 * rank
    if count * frame != len(blob):
        raise ValueError(
            f"journal partition holds {len(blob)} bytes, expected "
            f"{count} × {frame}-byte FeatureRecord frames"
        )
    arr = np.frombuffer(blob, np.uint8).reshape(count, frame)
    ids = arr[:, 0:4].copy().view(">i4").astype(np.int32).reshape(count)
    feats = (
        arr[:, _ROW_HEADER_BYTES:].copy().view(">f4").astype(np.float32)
        .reshape(count, rank)
    )
    return ids, feats


class JournalCheckpointManager:
    """Factor checkpoints as FeatureRecord frames on Transport topics.

    Topic layout per saved iteration i (names mirror ``setup.sh:18-21``):
    ``user-features-<i>`` and ``movie-features-<i>`` with ``num_partitions``
    partitions, rows mod-N partitioned by entity index; plus one commit
    marker appended to the single-partition ``checkpoint-commits`` topic
    after both are fully written.  ``keep_last`` prunes older iterations'
    topics after each successful save (the commit log itself is never
    rewritten — pruned iterations are simply no longer restorable).
    """

    def __init__(
        self,
        transport,
        *,
        num_partitions: int = 1,
        keep_last: int | None = None,
    ) -> None:
        if num_partitions < 1:
            raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
        if keep_last is not None and keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self.transport = transport
        self.num_partitions = num_partitions
        self.keep_last = keep_last

    def _ensure_commits_topic(self) -> None:
        # Created lazily on first save so restore-only usage (predict /
        # recommend serving) never mutates the target — pointing serving at
        # a wrong path errors instead of scaffolding an empty journal there.
        try:
            self.transport.create_topic(_COMMITS, 1)
        except ValueError:
            pass  # existing journal: resume against it

    @staticmethod
    def _topic(side: str, iteration: int) -> str:
        return f"{side}-features-{iteration:07d}"

    # -- write --------------------------------------------------------------

    def _write_side(self, side: str, iteration: int, matrix: np.ndarray) -> None:
        topic = self._topic(side, iteration)
        try:
            self.transport.create_topic(topic, self.num_partitions)
        except ValueError:
            # Same iteration journaled before (a crash after topics were
            # written but before the commit marker, or an over-write of a
            # resumed step): replace wholesale.
            self.transport.delete_topic(topic)
            self.transport.create_topic(topic, self.num_partitions)
        rows = np.arange(matrix.shape[0], dtype=np.int64)
        for p in range(self.num_partitions):
            sel = rows[rows % self.num_partitions == p]
            frames = encode_feature_rows(matrix[sel], sel)
            produce_rows(self.transport, topic, sel, frames, p)

    def save(
        self,
        iteration: int,
        user_factors,
        movie_factors,
        meta: dict | None = None,
    ) -> None:
        u, stored_dtype = _host(user_factors)
        m, _ = _host(movie_factors)
        # The FeatureMessage wire format is float32
        # (serdes/FloatArray/FloatArraySerializer.java:14-25); bf16 factors
        # are upcast on the wire and re-cast at restore, like the npz store.
        u32 = u.astype(np.float32)
        m32 = m.astype(np.float32)
        self._ensure_commits_topic()
        self._write_side("user", iteration, u32)
        self._write_side("movie", iteration, m32)
        commit = {
            "iteration": iteration,
            "u_rows": int(u32.shape[0]),
            "m_rows": int(m32.shape[0]),
            "rank": int(u32.shape[1]),
            "dtype": stored_dtype,
            **(meta or {}),
        }
        self.transport.produce(
            _COMMITS, iteration, json.dumps(commit).encode(), 0
        )
        if hasattr(self.transport, "flush"):
            self.transport.flush()
        if self.keep_last is not None:
            for old in self.iterations()[: -self.keep_last]:
                self.transport.delete_topic(self._topic("user", old))
                self.transport.delete_topic(self._topic("movie", old))

    # -- read ---------------------------------------------------------------

    def _commits(self) -> dict[int, dict]:
        out: dict[int, dict] = {}
        try:
            self.transport.num_partitions(_COMMITS)
        except KeyError:
            raise FileNotFoundError(
                "no checkpoint journal here (the "
                f"{_COMMITS!r} topic does not exist) — is the path right?"
            ) from None
        for rec in self.transport.consume(_COMMITS, 0):
            commit = json.loads(rec.value.decode())
            out[int(commit["iteration"])] = commit  # later commit wins
        return out

    def _topic_exists(self, topic: str) -> bool:
        try:
            self.transport.num_partitions(topic)
        except KeyError:
            return False
        return True

    def iterations(self) -> list[int]:
        """Committed iterations whose topics still exist (not pruned)."""
        try:
            commits = self._commits()
        except FileNotFoundError:
            return []  # fresh journal: nothing saved yet
        return sorted(
            it
            for it in commits
            if self._topic_exists(self._topic("user", it))
            and self._topic_exists(self._topic("movie", it))
        )

    def latest_iteration(self) -> int | None:
        steps = self.iterations()
        return steps[-1] if steps else None

    def _read_side(self, side: str, iteration: int, rows: int, rank: int) -> np.ndarray:
        topic = self._topic(side, iteration)
        n = self.transport.num_partitions(topic)
        out = np.zeros((rows, rank), np.float32)
        seen = 0
        for p in range(n):
            blob = bytearray()
            count = 0
            for rec in self.transport.consume(topic, p):
                blob += rec.value
                count += 1
            ids, feats = decode_feature_rows(bytes(blob), count, rank)
            if ids.size and (ids.min() < 0 or ids.max() >= rows):
                raise ValueError(
                    f"journal {topic} partition {p} holds row {ids.max()} "
                    f"outside [0, {rows})"
                )
            out[ids] = feats
            seen += count
        if seen != rows:
            raise ValueError(
                f"journal {topic} holds {seen} rows, commit expects {rows}; "
                "the journal is corrupt — restore an earlier iteration"
            )
        return out

    def restore(self, iteration: int | None = None) -> CheckpointState:
        commits = self._commits()
        available = self.iterations()
        if iteration is None:
            if not available:
                raise FileNotFoundError("no committed iterations in the journal")
            iteration = available[-1]
        if iteration not in commits:
            raise FileNotFoundError(f"iteration {iteration} was never committed")
        if iteration not in available:
            raise FileNotFoundError(
                f"iteration {iteration} was pruned from the journal (keep_last)"
            )
        commit = commits[iteration]
        rank = int(commit["rank"])
        u = self._read_side("user", iteration, int(commit["u_rows"]), rank)
        m = self._read_side("movie", iteration, int(commit["m_rows"]), rank)
        want_dtype = commit.get("dtype", "float32")
        if want_dtype == "bfloat16":
            # numpy has no bfloat16: restored as torch bfloat16 tensors, as
            # the npz store restores them.
            u = torch.from_numpy(u).to(torch.bfloat16)
            m = torch.from_numpy(m).to(torch.bfloat16)
        elif want_dtype != "float32":
            u = u.astype(want_dtype)
            m = m.astype(u.dtype)
        meta = {
            k: v
            for k, v in commit.items()
            if k not in ("iteration", "u_rows", "m_rows", "rank", "dtype")
        }
        return CheckpointState(
            iteration=int(commit["iteration"]),
            user_factors=u,
            movie_factors=m,
            meta=meta,
        )


def produce_rows(
    transport, topic: str, keys: np.ndarray, frames: np.ndarray, partition: int
) -> None:
    """Append pre-encoded equal-size frames, using the transport's bulk path
    when it has one (``FileBroker.produce_frames``) and falling back to
    per-record ``produce`` otherwise."""
    fast = getattr(transport, "produce_frames", None)
    if fast is not None:
        fast(topic, keys, frames, partition)
        return
    for key, frame in zip(keys.tolist(), frames):
        transport.produce(topic, key, frame.tobytes(), partition)
