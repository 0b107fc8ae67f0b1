"""Score-request and score-response frames of the serving path.

Byte-identical to ``cfk_tpu/transport/serdes.py``'s frames, big-endian like
the reference's ``DataOutputStream`` serdes:

- ``ScoreRequest``: int64 req_id | int64 user | int32 k | int32
  reply_partition — 24 bytes;
- ``ScoreResponse``: int64 req_id | int32 n | uint16 error_len | uint8 flags
  | int32 epoch | int32 staleness — a 23-byte header, then the UTF-8 error
  text and the parallel >i4 movie rows / >f4 scores.  ``flags`` bit 0 marks
  a retriable refusal.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

_SCORE_REQUEST = struct.Struct(">qqii")
_SCORE_RESPONSE_HDR = struct.Struct(">qiHBii")
_FLAG_RETRIABLE = 0x01


@dataclasses.dataclass(frozen=True)
class ScoreRequest:
    """One top-K query: ``req_id`` is client-assigned and echoed back."""

    req_id: int
    user: int
    k: int
    reply_partition: int = 0


def encode_score_request(msg: ScoreRequest) -> bytes:
    return _SCORE_REQUEST.pack(msg.req_id, msg.user, msg.k,
                               msg.reply_partition)


def decode_score_request(data: bytes) -> ScoreRequest:
    if len(data) != _SCORE_REQUEST.size:
        raise ValueError(
            f"ScoreRequest frame must be {_SCORE_REQUEST.size} bytes, "
            f"got {len(data)}"
        )
    req_id, user, k, reply = _SCORE_REQUEST.unpack(data)
    return ScoreRequest(req_id=req_id, user=user, k=k, reply_partition=reply)


@dataclasses.dataclass(frozen=True)
class ScoreResponse:
    """Top-K answer: parallel (movie row, score) arrays, ids −1 where fewer
    than K candidates exist.  A non-empty ``error`` marks a refused request
    (arrays empty); ``epoch`` is the factor-table epoch that scored it."""

    req_id: int
    movie_rows: np.ndarray  # int32 [k]
    scores: np.ndarray  # float32 [k]
    error: str = ""
    retriable: bool = False
    epoch: int = 0
    staleness: int = 0


def encode_score_response(msg: ScoreResponse) -> bytes:
    ids = np.ascontiguousarray(msg.movie_rows, dtype=">i4")
    sc = np.ascontiguousarray(msg.scores, dtype=">f4")
    if ids.shape != sc.shape or ids.ndim != 1:
        raise ValueError(
            f"parallel 1-D arrays required, got {ids.shape}/{sc.shape}"
        )
    err = msg.error.encode()
    flags = _FLAG_RETRIABLE if msg.retriable else 0
    return (_SCORE_RESPONSE_HDR.pack(msg.req_id, ids.shape[0], len(err),
                                     flags, msg.epoch, msg.staleness)
            + err + ids.tobytes() + sc.tobytes())


def decode_score_response(data: bytes) -> ScoreResponse:
    hdr = _SCORE_RESPONSE_HDR.size
    if len(data) < hdr:
        raise ValueError(f"ScoreResponse frame truncated at {len(data)} bytes")
    req_id, n, elen, flags, epoch, staleness = _SCORE_RESPONSE_HDR.unpack_from(
        data, 0
    )
    off = hdr
    if n < 0 or off + elen + 8 * n != len(data):
        raise ValueError(
            f"corrupt ScoreResponse frame: count {n}, error len {elen}, "
            f"{len(data)} bytes"
        )
    err = data[off:off + elen].decode("utf-8", "replace")
    off += elen
    ids = np.frombuffer(data, dtype=">i4", count=n, offset=off).astype(np.int32)
    off += 4 * n
    sc = np.frombuffer(data, dtype=">f4", count=n, offset=off).astype(np.float32)
    return ScoreResponse(req_id=req_id, movie_rows=ids, scores=sc, error=err,
                         retriable=bool(flags & _FLAG_RETRIABLE),
                         epoch=epoch, staleness=staleness)
