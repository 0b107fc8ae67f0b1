"""Exactly-once streaming fold-in: the rate → fold-in → resume loop.

The port of ``cfk_tpu.streaming``: the durable updates topic
(``producer``), the offset-cursor consumer with exactly-once micro-batch
assembly (``consumer``), the idempotent deduplicated rating state
(``state``), the restricted-half-iteration solve on the card (``foldin``:
K1, or K2 + K1 on the tiled layout), and the session that ties them to the
resilience stack and commits factors atomically with the cursor
(``session``).  The reference's ``fold_in_rows_windowed`` belongs to the
out-of-core slice.
"""

from cfk_tpu_torch.streaming.consumer import (
    StreamBatch,
    StreamConsumer,
    StreamGapError,
)
from cfk_tpu_torch.streaming.foldin import fold_in_rows
from cfk_tpu_torch.streaming.producer import (
    UPDATES_TOPIC,
    StreamProducer,
    ensure_updates_topic,
)
from cfk_tpu_torch.streaming.session import (
    PoisonedBatchError,
    StreamConfig,
    StreamSession,
)
from cfk_tpu_torch.streaming.state import ApplyStats, PendingApply, StreamState

__all__ = [
    "ApplyStats",
    "PendingApply",
    "PoisonedBatchError",
    "StreamBatch",
    "StreamConfig",
    "StreamConsumer",
    "StreamGapError",
    "StreamProducer",
    "StreamSession",
    "StreamState",
    "UPDATES_TOPIC",
    "ensure_updates_topic",
    "fold_in_rows",
]
