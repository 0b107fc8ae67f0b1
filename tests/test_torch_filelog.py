"""The port's wire codecs, ``FileBroker`` and ingest against the JAX
package's (``cfk_tpu.transport``): the same bytes on the wire and on disk,
each package reading what the other wrote, the same refusals.

Every encoder of ``cfk_tpu_torch.transport.serdes`` must give the
reference's bytes for the same message, and every decoder must take the
reference's bytes and refuse what the reference refuses (one parametrised
test over the codecs and their malformed frames).  ``FileBroker`` must write
the reference's segment files byte for byte (``meta.json``, ``p%05d.log``,
``>iI`` frames), read a log the reference wrote and append to it, truncate a
torn tail on reopen, seek through its sparse index, and ``produce_frames``
must equal per-record appends.  Ingest (``produce_ratings_file``,
``collect_ratings``) must give the reference's COO and its EOF-barrier
errors.
"""

import os

import numpy as np
import pytest
import torch

import cfk_tpu.transport.serdes as ref_serdes
from cfk_tpu.transport import FileBroker as RefFileBroker
from cfk_tpu.transport import IncompleteIngestError as RefIncomplete
from cfk_tpu.transport import collect_ratings as ref_collect
from cfk_tpu.transport import produce_ratings_file as ref_produce

import cfk_tpu_torch.transport.serdes as serdes
from cfk_tpu_torch.transport import (
    FileBroker,
    IncompleteIngestError,
    InMemoryBroker,
    collect_ratings,
    produce_ratings_file,
)

torch.set_num_threads(1)


def _messages(mod):
    """One message of every frame kind, built from ``mod``'s classes."""
    rng = np.random.default_rng(0)
    return {
        "id_rating": (mod.IdRatingPair(id=123456, rating=4),
                      mod.encode_id_rating, mod.decode_id_rating),
        "id_rating_eof": (mod.IdRatingPair(id=mod.EOF_ID, rating=3),
                          mod.encode_id_rating, mod.decode_id_rating),
        "rating_update": (mod.RatingUpdate(seq=2**40 + 7, user=2**33,
                                           movie=17_770, rating=3.5),
                          mod.encode_rating_update,
                          mod.decode_rating_update),
        "score_request": (mod.ScoreRequest(req_id=99, user=5, k=10,
                                           reply_partition=2),
                          mod.encode_score_request,
                          mod.decode_score_request),
        "score_response": (mod.ScoreResponse(
            req_id=7, movie_rows=np.array([3, 1, -1], np.int32),
            scores=np.array([2.5, 1.0, -np.inf], np.float32),
            error="", retriable=True, epoch=4, staleness=2),
            mod.encode_score_response, mod.decode_score_response),
        "feature": (mod.FeatureRecord(
            id=11, dependent_ids=(1, 2, 3),
            features=rng.standard_normal(5).astype(np.float32)),
            mod.encode_feature, mod.decode_feature),
        "float_array": (rng.standard_normal(6).astype(np.float32),
                        mod.encode_float_array, mod.decode_float_array),
        "int_list": ([4, -2, 2**31 - 1], mod.encode_int_list,
                     mod.decode_int_list),
        "factor_delta": (mod.make_factor_delta(
            3, 41, "rows", num_users=9, user_rows=[1, 4],
            user_factors=rng.standard_normal((2, 3)),
            lazy_user_rows=[7], cells=[(1, 2), (4, 0)], movie_rows=[5],
            movie_factors=rng.standard_normal((1, 3))),
            mod.encode_factor_delta, mod.decode_factor_delta),
        "factor_delta_epoch": (mod.make_factor_delta(5, 42, "epoch",
                                                     num_users=9, rank=3),
                               mod.encode_factor_delta,
                               mod.decode_factor_delta),
    }


def _equal(a, b) -> bool:
    """Decoded messages equal field by field (arrays by value, NaN-free)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(np.asarray(a), np.asarray(b)))
    if hasattr(a, "__dataclass_fields__"):
        return type(a).__name__ == type(b).__name__ and all(
            _equal(getattr(a, f), getattr(b, f))
            for f in a.__dataclass_fields__)
    return a == b


def _malformed(kind: str, good: bytes) -> list[bytes]:
    """Frames the reference refuses: truncated, padded, corrupt counts."""
    out = [good[:-1], good + b"\0"]
    if kind in ("float_array", "int_list"):
        out.append(b"\xff\xff\xff\xff" + good[4:])  # negative count
        out.append(b"\0\0")  # shorter than a count
    if kind == "feature":
        out.append(good[:4] + b"\xff\xff\xff\xff" + good[8:])
        out.append(good[:6])  # inside the dependent count
    if kind.startswith("factor_delta"):
        out.append(good[:30])  # inside the header
        out.append(good[:12] + b"\x07" + good[13:])  # unknown kind
    if kind == "score_response":
        out.append(good[:10])
    return out


_KINDS = list(_messages(serdes))
_CASES = [(kind, "valid", -1) for kind in _KINDS] + [
    (kind, "malformed", i) for kind in _KINDS
    for i in range(len(_malformed(
        kind, _messages(ref_serdes)[kind][1](_messages(ref_serdes)[kind][0]))))
]


@pytest.mark.parametrize("kind,case,i", _CASES,
                         ids=[f"{k}-{c}{'' if i < 0 else i}"
                              for k, c, i in _CASES])
def test_codec_bytes_and_refusals_match_reference(kind, case, i):
    """A valid message encodes to the reference's bytes, and each package
    decodes the other's bytes to an equal message; a malformed frame is
    refused by both with ValueError."""
    ours_msg, ours_enc, ours_dec = _messages(serdes)[kind]
    ref_msg, ref_enc, ref_dec = _messages(ref_serdes)[kind]
    ref_bytes = ref_enc(ref_msg)
    if case == "valid":
        assert ours_enc(ours_msg) == ref_bytes
        assert _equal(ours_dec(ref_bytes), ref_dec(ref_bytes))
        assert _equal(ref_dec(ours_enc(ours_msg)), ref_dec(ref_bytes))
        return
    bad = _malformed(kind, ref_bytes)[i]
    with pytest.raises(ValueError):
        ref_dec(bad)
    with pytest.raises(ValueError):
        ours_dec(bad)


def test_encode_factor_delta_refuses_what_the_reference_refuses():
    for mod in (ref_serdes, serdes):
        d = mod.make_factor_delta(1, 1, "rows", user_rows=[1, 2],
                                  user_factors=np.zeros((2, 3)))
        bad_kind = d.__class__(**{**d.__dict__, "kind": "nope"})
        with pytest.raises(ValueError, match="unknown FactorDelta kind"):
            mod.encode_factor_delta(bad_kind)
        ragged = d.__class__(**{**d.__dict__,
                                "user_rows": np.array([1], np.int32)})
        with pytest.raises(ValueError, match="rows/factors mismatch"):
            mod.encode_factor_delta(ragged)


# -- FileBroker ----------------------------------------------------------------


def _drive(broker):
    """The same produce calls against either package's FileBroker: single
    records (keys placed mod-N and explicit), an EOF-style control record,
    and a bulk ``produce_frames`` run across the sparse-index boundary."""
    broker.create_topic("t", 3)
    for k in range(20):
        broker.produce("t", key=k, value=f"v{k}".encode() * (k % 4))
    broker.produce("t", key=-1, value=b"eof", partition=1)
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2500, 12), dtype=np.uint8)
    broker.produce_frames("t", np.arange(2500) * 7, frames, partition=2)
    broker.create_topic("u", 1)
    broker.produce("u", key=5, value=b"")


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_filebroker_bytes_equal_reference(tmp_path):
    with RefFileBroker(str(tmp_path / "ref"), fsync=False) as rb:
        _drive(rb)
    with FileBroker(str(tmp_path / "port"), fsync=False) as pb:
        _drive(pb)
    ref_files, port_files = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(ref_files) == sorted(port_files)
    assert "t/p00002.log" in port_files and "t/meta.json" in port_files
    for name in ref_files:
        assert ref_files[name] == port_files[name], name


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_log_written_by_one_package_reads_in_the_other(tmp_path, writer):
    """Each package reads the other's log record for record and appends
    to it; the first package then reads the appended records back."""
    first, second = ((RefFileBroker, FileBroker) if writer == "reference"
                     else (FileBroker, RefFileBroker))
    with first(str(tmp_path), fsync=False) as a:
        _drive(a)
        want = {(t, p): [(r.key, r.value, r.offset)
                         for r in a.consume(t, p)]
                for t, n in (("t", 3), ("u", 1)) for p in range(n)}
    with second(str(tmp_path), fsync=True) as b:
        assert b.topics() == ["t", "u"]
        got = {(t, p): [(r.key, r.value, r.offset)
                        for r in b.consume(t, p)] for t, p in want}
        assert got == want
        b.produce("t", key=4, value=b"appended")
        assert b.end_offset("t", 1) == len(want[("t", 1)]) + 1
    with first(str(tmp_path)) as a2:
        assert [r.value for r in a2.consume("t", 1)][-1] == b"appended"


@pytest.mark.parametrize("cut", [1, 5, 9])
def test_torn_tail_truncated_on_reopen(tmp_path, cut):
    """A crash mid-append (a partial header or a short value) leaves a torn
    final frame: both packages truncate the file to the same valid prefix
    and keep appending after it."""
    for name, cls in (("ref", RefFileBroker), ("port", FileBroker)):
        with cls(str(tmp_path / name)) as b:
            b.create_topic("t", 1)
            b.produce("t", key=1, value=b"aaaa")
            b.produce("t", key=2, value=b"bbbbbbbb")
        path = tmp_path / name / "t" / "p00000.log"
        data = path.read_bytes()
        path.write_bytes(data[: 12 + cut])  # frame 2 torn after `cut` bytes
        with cls(str(tmp_path / name)) as b:
            assert [r.value for r in b.consume("t", 0)] == [b"aaaa"]
            b.produce("t", key=3, value=b"c")
            assert [r.key for r in b.consume("t", 0)] == [1, 3]
    assert ((tmp_path / "ref" / "t" / "p00000.log").read_bytes()
            == (tmp_path / "port" / "t" / "p00000.log").read_bytes())


@pytest.mark.parametrize("reopen", [False, True])
def test_sparse_index_seek_matches_full_scan(tmp_path, reopen):
    """``consume(start_offset=...)`` through the sparse index (an entry
    every 1,024 records, rebuilt on reopen) returns exactly the tail a
    full scan returns, at and around every index boundary."""
    b = FileBroker(str(tmp_path), fsync=False)
    b.create_topic("t", 1)
    for k in range(1500):
        b.produce("t", key=k, value=k.to_bytes(4, "big"))
    b.produce_frames("t", np.arange(1500, 3100),
                     np.arange(1600 * 3, dtype=np.uint8).reshape(1600, 3), 0)
    if reopen:
        b.close()
        b = FileBroker(str(tmp_path))
    full = list(b.consume("t", 0))
    assert len(full) == b.end_offset("t", 0) == 3100
    for start in (0, 1, 1023, 1024, 1025, 2047, 2048, 3072, 3099, 3100, 5000):
        got = list(b.consume("t", 0, start_offset=start))
        assert got == full[start:], start
    b.close()


def test_produce_frames_equals_per_record_and_refuses_wide_keys(tmp_path):
    keys = np.array([0, 5, 2**31 - 1, -4])
    frames = np.arange(4 * 6, dtype=np.uint8).reshape(4, 6)
    with FileBroker(str(tmp_path / "bulk"), fsync=False) as a, \
            FileBroker(str(tmp_path / "single"), fsync=False) as s:
        for b in (a, s):
            b.create_topic("t", 2)
        a.produce_frames("t", keys, frames, partition=1)
        for key, frame in zip(keys.tolist(), frames):
            s.produce("t", key, frame.tobytes(), partition=1)
        assert list(a.consume("t", 1)) == list(s.consume("t", 1))
        with pytest.raises(OverflowError, match="fit int32"):
            a.produce_frames("t", np.array([2**31]), frames[:1], partition=0)
        with pytest.raises(IndexError):
            a.produce_frames("t", keys, frames, partition=2)
        assert a.end_offset("t", 0) == 0
    assert ((tmp_path / "bulk" / "t" / "p00001.log").read_bytes()
            == (tmp_path / "single" / "t" / "p00001.log").read_bytes())


def test_broker_errors_and_delete_topic(tmp_path):
    for b in (InMemoryBroker(), FileBroker(str(tmp_path))):
        b.create_topic("t", 2)
        with pytest.raises(ValueError, match="already exists"):
            b.create_topic("t", 2)
        with pytest.raises(ValueError, match="num_partitions"):
            b.create_topic("z", 0)
        with pytest.raises(KeyError, match="create_topic first"):
            b.num_partitions("missing")
        with pytest.raises(ValueError, match="non-negative key"):
            b.produce("t", key=-1, value=b"x")
        b.delete_topic("t")
        b.delete_topic("t")  # idempotent
        with pytest.raises(KeyError):
            b.end_offset("t", 0)
        b.create_topic("t", 1)
        assert b.end_offset("t", 0) == 0


# -- ingest --------------------------------------------------------------------


def _netflix_file(path):
    from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo

    coo = synthetic_netflix_coo(40, 12, 300, seed=4)
    with open(path, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            for uid, r in zip(coo.user_raw[sel], coo.rating[sel]):
                f.write(f"{uid},{int(r)},2005-01-01\n")
    return path


@pytest.mark.parametrize("transport", ["memory", "file"])
def test_ingest_matches_reference(tmp_path, transport):
    """``produce_ratings_file`` then ``collect_ratings`` give the
    reference's COO; the port's collector reads the reference's topic; a
    dropped EOF fails both barriers loudly."""
    data = _netflix_file(tmp_path / "r.txt")

    def make(name, ref):
        if transport == "memory":
            from cfk_tpu.transport import InMemoryBroker as RefMem

            b = RefMem() if ref else InMemoryBroker()
        else:
            b = (RefFileBroker if ref else FileBroker)(
                str(tmp_path / name), fsync=False)
        b.create_topic("movieIds-with-ratings", 3)
        return b

    rb, pb = make("ref", True), make("port", False)
    assert ref_produce(rb, str(data)) == produce_ratings_file(pb, str(data))
    want, got = ref_collect(rb), collect_ratings(pb)
    for field in ("movie_raw", "user_raw", "rating"):
        assert np.array_equal(getattr(want, field), getattr(got, field))
        assert getattr(want, field).dtype == getattr(got, field).dtype
    assert np.array_equal(collect_ratings(rb).user_raw, want.user_raw)
    rb2, pb2 = make("ref2", True), make("port2", False)
    ref_produce(rb2, str(data), drop_eof_for={1})
    produce_ratings_file(pb2, str(data), drop_eof_for={1})
    with pytest.raises(RefIncomplete, match=r"partition\(s\) \[1\]"):
        ref_collect(rb2)
    with pytest.raises(IncompleteIngestError, match=r"partition\(s\) \[1\]"):
        collect_ratings(pb2)
