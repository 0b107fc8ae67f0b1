"""Pluggable transport: the partitioned, offset-addressed record log.

The port's copy of ``cfk_tpu/transport/broker.py``: the ``Transport``
protocol that ingest, the checkpoint journal, the streaming fold-in and the
request server run over, and ``InMemoryBroker``, its in-process
implementation (a dict of topic → append-only partitions).  ``FileBroker``
(``transport.filelog``) is the durable one.  Partitioning is deterministic
mod-N on the integer key (the reference's ``PureModPartitioner``,
``producers/PureModPartitioner.java:17``): no hashing, so a record's
partition is reproducible from its key alone.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Protocol


@dataclasses.dataclass(frozen=True)
class Record:
    key: int
    value: bytes
    offset: int


class Transport(Protocol):
    """Minimal partitioned-log protocol used by ingest and checkpointing."""

    def create_topic(self, name: str, num_partitions: int) -> None: ...

    def produce(self, topic: str, key: int, value: bytes,
                partition: int | None = None) -> None: ...

    def consume(self, topic: str, partition: int,
                start_offset: int = 0) -> Iterator[Record]: ...

    def num_partitions(self, topic: str) -> int: ...

    def end_offset(self, topic: str, partition: int) -> int: ...


def mod_partition(key: int, num_partitions: int) -> int:
    """Deterministic mod-N partitioning of a non-negative key."""
    if key < 0:
        raise ValueError(
            f"mod_partition requires a non-negative key, got {key}; produce "
            "control records with an explicit partition="
        )
    return key % num_partitions


class InMemoryBroker:
    """In-process transport: dict of topic → list of append-only partitions."""

    def __init__(self) -> None:
        self._topics: dict[str, list[list[Record]]] = {}

    def create_topic(self, name: str, num_partitions: int) -> None:
        if num_partitions < 1:
            raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
        if name in self._topics:
            raise ValueError(f"topic {name!r} already exists")
        self._topics[name] = [[] for _ in range(num_partitions)]

    def delete_topic(self, name: str) -> None:
        self._topics.pop(name, None)

    def _partitions(self, topic: str) -> list[list[Record]]:
        try:
            return self._topics[topic]
        except KeyError:
            raise KeyError(
                f"unknown topic {topic!r}; create_topic first (the reference "
                "had the same split: setup.sh provisions topics before the app runs)"
            ) from None

    def produce(self, topic: str, key: int, value: bytes,
                partition: int | None = None) -> None:
        parts = self._partitions(topic)
        if partition is None:
            partition = mod_partition(key, len(parts))
        if not 0 <= partition < len(parts):
            raise IndexError(f"partition {partition} out of range for {topic!r}")
        log = parts[partition]
        log.append(Record(key=key, value=value, offset=len(log)))

    def consume(self, topic: str, partition: int,
                start_offset: int = 0) -> Iterator[Record]:
        yield from self._partitions(topic)[partition][start_offset:]

    def num_partitions(self, topic: str) -> int:
        return len(self._partitions(topic))

    def end_offset(self, topic: str, partition: int) -> int:
        return len(self._partitions(topic)[partition])
