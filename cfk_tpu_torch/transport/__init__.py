"""The port's transport: the in-process log, score frames and checkpoints."""

from cfk_tpu_torch.transport.broker import InMemoryBroker, Record
from cfk_tpu_torch.transport.checkpoint import (
    CheckpointCorruptError,
    CheckpointManager,
    CheckpointState,
)

__all__ = [
    "CheckpointCorruptError",
    "CheckpointManager",
    "CheckpointState",
    "InMemoryBroker",
    "Record",
]
