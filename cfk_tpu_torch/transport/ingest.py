"""Streaming ingest over a Transport, with the EOF-barrier protocol.

The port's copy of ``cfk_tpu/transport/ingest.py`` (same topic, same
frames, same errors), over any ``Transport``.  It mirrors the reference's
ingest contract (re-designed, not translated):

- ``produce_ratings_file`` is the analog of ``NetflixDataFormatProducer``
  (``producers/NetflixDataFormatProducer.java:38-75``): stream the Netflix
  file into a ratings topic keyed by movieId (mod-N partitioned), then send
  one EOF control record to *every* partition explicitly (``:64-74``).
- ``collect_ratings`` is the batch analog of the two *Ratings2Blocks
  processors plus their EOF barrier: a partition's data is complete if and
  only if its log contains the EOF record.  The reference learned this the
  hard way — its first version started ALS before all partitions were done
  (the race recounted in its README) and hangs forever when a message goes
  missing (SURVEY.md §5 failure modes).  Here incompleteness is a loud
  ``IncompleteIngestError`` naming the missing partitions, not a hang.
"""

from __future__ import annotations

import numpy as np

from cfk_tpu_torch.data.blocks import RatingsCOO
from cfk_tpu_torch.transport.broker import Transport, mod_partition
from cfk_tpu_torch.transport.serdes import (
    EOF_ID,
    IdRatingPair,
    decode_id_rating,
    encode_id_rating,
)

RATINGS_TOPIC = "movieIds-with-ratings"


class IncompleteIngestError(RuntimeError):
    """A partition's log has no EOF record — ingest did not finish."""


def produce_ratings_file(
    transport: Transport,
    path: str,
    *,
    topic: str = RATINGS_TOPIC,
    send_eof: bool = True,
    drop_eof_for: set[int] | None = None,
) -> int:
    """Stream a Netflix-format file into ``topic``, keyed by movieId.

    Returns the number of rating records produced.  ``send_eof=False`` skips
    the EOF fan-out so further files can be appended to the topic; the LAST
    produce must send EOF or ``collect_ratings`` refuses the topic (records
    after an EOF also fail the barrier — EOF means *end*, exactly as in the
    reference's protocol).  ``drop_eof_for`` is a fault-injection hook:
    partitions listed there do NOT receive their EOF record (simulating the
    reference's lost-message failure mode).
    """
    n = transport.num_partitions(topic)
    produced = 0
    current_movie = -1
    with open(path, "r") as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                if line.endswith(":"):
                    current_movie = int(line[:-1])
                    continue
                user_s, rating_s, _ = line.split(",", 2)
                user_id, rating = int(user_s), int(rating_s)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: malformed line {line!r}") from e
            if current_movie < 0:
                raise ValueError(
                    f"{path}:{lineno}: rating row before any 'movieId:' header"
                )
            # Value = (userId, rating) keyed by movieId — the reference's
            # record shape on movieIds-with-ratings.
            transport.produce(
                topic,
                key=current_movie,
                value=encode_id_rating(IdRatingPair(id=user_id, rating=rating)),
            )
            produced += 1
    if not send_eof:
        return produced
    drop = drop_eof_for or set()
    for p in range(n):
        if p in drop:
            continue
        transport.produce(
            topic,
            key=EOF_ID,
            value=encode_id_rating(IdRatingPair(id=EOF_ID, rating=p)),
            partition=p,
        )
    return produced


def collect_ratings(
    transport: Transport, *, topic: str = RATINGS_TOPIC
) -> RatingsCOO:
    """Drain all partitions into a RatingsCOO, enforcing the EOF barrier.

    Also validates partition placement: every rating record must sit on
    ``movieId mod N`` (PureModPartitioner invariant), so a mis-partitioned
    producer is caught at ingest rather than as silently wrong blocks.
    """
    n = transport.num_partitions(topic)
    movie_ids: list[int] = []
    user_ids: list[int] = []
    ratings: list[int] = []
    missing_eof = []
    for p in range(n):
        saw_eof = False
        for record in transport.consume(topic, p):
            msg = decode_id_rating(record.value)
            if record.key == EOF_ID or msg.is_eof:
                saw_eof = True
                continue
            if saw_eof:
                raise IncompleteIngestError(
                    f"partition {p}: record at offset {record.offset} arrived "
                    "after EOF — producer restarted without topic reset?"
                )
            if mod_partition(record.key, n) != p:
                raise IncompleteIngestError(
                    f"partition {p}: movieId {record.key} belongs on partition "
                    f"{mod_partition(record.key, n)} (mod-{n} invariant broken)"
                )
            movie_ids.append(record.key)
            user_ids.append(msg.id)
            ratings.append(msg.rating)
        if not saw_eof:
            missing_eof.append(p)
    if missing_eof:
        raise IncompleteIngestError(
            f"no EOF record on partition(s) {missing_eof}; ingest incomplete "
            "(the reference hangs forever in this state — we fail loudly)"
        )
    return RatingsCOO(
        movie_raw=np.asarray(movie_ids, dtype=np.int64),
        user_raw=np.asarray(user_ids, dtype=np.int64),
        rating=np.asarray(ratings, dtype=np.float32),
    )
