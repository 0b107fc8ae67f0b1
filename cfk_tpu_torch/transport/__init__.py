"""The port's transport: the partitioned log (in memory, on disk, and over
TCP to the port's broker process), ingest, the wire codecs, and the two
checkpoint stores."""

from cfk_tpu_torch.transport.broker import (
    InMemoryBroker,
    Record,
    Transport,
    mod_partition,
)
from cfk_tpu_torch.transport.checkpoint import (
    CheckpointCorruptError,
    CheckpointManager,
    CheckpointState,
)
from cfk_tpu_torch.transport.filelog import FileBroker
from cfk_tpu_torch.transport.ingest import (
    RATINGS_TOPIC,
    IncompleteIngestError,
    collect_ratings,
    produce_ratings_file,
)
from cfk_tpu_torch.transport.journal import JournalCheckpointManager
from cfk_tpu_torch.transport.serdes import (
    EOF_ID,
    FeatureRecord,
    IdRatingPair,
    RatingUpdate,
    decode_feature,
    decode_float_array,
    decode_id_rating,
    decode_int_list,
    decode_rating_update,
    encode_feature,
    encode_float_array,
    encode_id_rating,
    encode_int_list,
    encode_rating_update,
)
from cfk_tpu_torch.transport.tcp import (
    BrokerProcess,
    BrokerRequestError,
    TcpBrokerClient,
)

__all__ = [
    "BrokerProcess",
    "BrokerRequestError",
    "CheckpointCorruptError",
    "CheckpointManager",
    "CheckpointState",
    "EOF_ID",
    "FeatureRecord",
    "FileBroker",
    "IdRatingPair",
    "InMemoryBroker",
    "IncompleteIngestError",
    "JournalCheckpointManager",
    "RATINGS_TOPIC",
    "RatingUpdate",
    "Record",
    "TcpBrokerClient",
    "Transport",
    "collect_ratings",
    "decode_feature",
    "decode_float_array",
    "decode_id_rating",
    "decode_int_list",
    "decode_rating_update",
    "encode_feature",
    "encode_float_array",
    "encode_id_rating",
    "encode_int_list",
    "encode_rating_update",
    "mod_partition",
    "produce_ratings_file",
]
