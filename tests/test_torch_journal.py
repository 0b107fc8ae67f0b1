"""The port's checkpoint journal (``cfk_tpu_torch.transport.journal``)
against the JAX package's (``cfk_tpu.transport.journal``).

The journal keeps factor checkpoints as FeatureRecord frames on
per-iteration topics with a commit marker after both sides.  Held here: the
vectorized frames equal the serde's bytes in both packages; a run saved by
either package through a ``FileBroker`` restores in the other (float32 and
bfloat16); an uncommitted tail (topics written, no marker) is ignored and
rewritten; ``keep_last`` prunes; a restore-only store is never mutated; the
trainers resume through the journal to the uninterrupted result; and the
CLI's ``train --checkpoint-journal`` serves ``recommend`` / ``predict`` as
``--checkpoint-dir`` does, with the reference's exit codes.
"""

import json

import numpy as np
import pytest
import torch

from cfk_tpu.transport import FileBroker as RefFileBroker
from cfk_tpu.transport.journal import JournalCheckpointManager as RefJournal
from cfk_tpu.transport.journal import encode_feature_rows as ref_rows

from cfk_tpu_torch.transport import FileBroker, InMemoryBroker
from cfk_tpu_torch.transport.journal import (
    JournalCheckpointManager,
    decode_feature_rows,
    encode_feature_rows,
    produce_rows,
)
from cfk_tpu_torch.transport.serdes import FeatureRecord, encode_feature

torch.set_num_threads(1)


def _factors(seed=0, users=37, movies=11, k=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((users, k)).astype(np.float32),
            rng.standard_normal((movies, k)).astype(np.float32))


def test_vectorized_frames_equal_serde_and_reference():
    u, _ = _factors()
    rows = np.arange(u.shape[0], dtype=np.int64) * 3
    frames = encode_feature_rows(u, rows)
    assert np.array_equal(frames, ref_rows(u, rows))
    for i in (0, 7, 36):
        assert frames[i].tobytes() == encode_feature(FeatureRecord(
            id=int(rows[i]), dependent_ids=(), features=u[i]))
    ids, feats = decode_feature_rows(frames.tobytes(), u.shape[0], 5)
    assert np.array_equal(ids, rows.astype(np.int32))
    assert np.array_equal(feats, u)
    with pytest.raises(ValueError, match="FeatureRecord frames"):
        decode_feature_rows(frames.tobytes()[:-1], u.shape[0], 5)


@pytest.mark.parametrize("partitions", [1, 2, 3])
def test_save_restore_roundtrip(partitions):
    u, m = _factors()
    mgr = JournalCheckpointManager(InMemoryBroker(),
                                   num_partitions=partitions)
    mgr.save(3, torch.from_numpy(u), m, meta={"model": "als", "x": 1})
    st = mgr.restore()
    assert st.iteration == 3 and st.meta == {"model": "als", "x": 1}
    assert np.array_equal(st.user_factors, u)
    assert np.array_equal(st.movie_factors, m)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_restores_across_packages(tmp_path, writer, dtype):
    """Two iterations saved by one package through a FileBroker restore in
    the other, each with its meta; bfloat16 factors come back bfloat16 (a
    torch tensor in the port, an ml_dtypes array in the reference)."""
    import ml_dtypes

    u, m = _factors(1)
    if dtype == "bfloat16":
        u_t = torch.from_numpy(u).to(torch.bfloat16)
        m_t = torch.from_numpy(m).to(torch.bfloat16)
        u = u_t.float().numpy()
        m = m_t.float().numpy()
        ref_in = (u.astype(ml_dtypes.bfloat16), m.astype(ml_dtypes.bfloat16))
        port_in = (u_t, m_t)
    else:
        ref_in = port_in = (u, m)
    if writer == "reference":
        with RefFileBroker(str(tmp_path), fsync=False) as b:
            mgr = RefJournal(b, num_partitions=2)
            mgr.save(1, ref_in[0], ref_in[1])
            mgr.save(2, ref_in[0], ref_in[1], meta={"model": "als"})
        with FileBroker(str(tmp_path), fsync=False) as b:
            st = JournalCheckpointManager(b).restore()
            got_u = torch.as_tensor(st.user_factors)
            assert got_u.dtype == (torch.bfloat16 if dtype == "bfloat16"
                                   else torch.float32)
            got = (got_u.float().numpy(),
                   torch.as_tensor(st.movie_factors).float().numpy())
    else:
        with FileBroker(str(tmp_path), fsync=True) as b:
            mgr = JournalCheckpointManager(b, num_partitions=2)
            mgr.save(1, *port_in)
            mgr.save(2, *port_in, meta={"model": "als"})
        with RefFileBroker(str(tmp_path), fsync=False) as b:
            st = RefJournal(b).restore()
            assert str(st.user_factors.dtype) == dtype
            got = (st.user_factors.astype(np.float32),
                   st.movie_factors.astype(np.float32))
    assert st.iteration == 2 and st.meta == {"model": "als"}
    assert np.array_equal(got[0], u) and np.array_equal(got[1], m)


def test_uncommitted_tail_ignored_and_rewritten(tmp_path):
    """A crash between the topic writes and the commit marker leaves the
    journal at the previous iteration (in both packages' readers); the
    re-save replaces the torn topics."""
    u, m = _factors(2)
    with FileBroker(str(tmp_path), fsync=False) as b:
        mgr = JournalCheckpointManager(b)
        mgr.save(1, u, m)
        mgr._write_side("user", 2, u * 2)
        mgr._write_side("movie", 2, m * 2)
        assert mgr.latest_iteration() == 1
        assert np.array_equal(mgr.restore().user_factors, u)
    with RefFileBroker(str(tmp_path), fsync=False) as b:
        assert RefJournal(b).latest_iteration() == 1
    with FileBroker(str(tmp_path), fsync=False) as b:
        mgr = JournalCheckpointManager(b)
        mgr.save(2, u * 3, m * 3)
        st = mgr.restore()
        assert st.iteration == 2 and np.array_equal(st.user_factors, u * 3)


def test_commit_marker_follows_the_frames():
    """The marker is the last append of a save: every factor frame of the
    iteration is in the log before it."""
    order = []

    class Spy(InMemoryBroker):
        def produce(self, topic, key, value, partition=None):
            order.append(topic)
            super().produce(topic, key, value, partition)

    u, m = _factors(3, users=4, movies=3)
    JournalCheckpointManager(Spy(), num_partitions=2).save(5, u, m)
    assert order[-1] == "checkpoint-commits"
    assert order.count("checkpoint-commits") == 1
    assert order[:-1].count("user-features-0000005") == 4
    assert order[:-1].count("movie-features-0000005") == 3


def test_keep_last_and_restore_only_usage(tmp_path):
    u, m = _factors(4, users=4, movies=3, k=2)
    mgr = JournalCheckpointManager(InMemoryBroker(), keep_last=2)
    for i in range(1, 5):
        mgr.save(i, u * i, m * i)
    assert mgr.iterations() == [3, 4]
    with pytest.raises(FileNotFoundError, match="pruned"):
        mgr.restore(1)
    with pytest.raises(FileNotFoundError, match="never committed"):
        mgr.restore(9)
    assert np.array_equal(mgr.restore(3).user_factors, u * 3)
    with FileBroker(str(tmp_path / "empty")) as b:
        with pytest.raises(FileNotFoundError, match="no checkpoint journal"):
            JournalCheckpointManager(b).restore()
        assert b.topics() == []  # restore never scaffolds a journal
    with pytest.raises(ValueError, match="num_partitions"):
        JournalCheckpointManager(InMemoryBroker(), num_partitions=0)


def test_produce_rows_without_a_bulk_path():
    """A transport without ``produce_frames`` gets per-record appends."""
    b = InMemoryBroker()
    b.create_topic("t", 1)
    frames = np.arange(12, dtype=np.uint8).reshape(3, 4)
    produce_rows(b, "t", np.array([4, 5, 6]), frames, 0)
    assert [(r.key, r.value) for r in b.consume("t", 0)] == [
        (k, f.tobytes()) for k, f in zip([4, 5, 6], frames)]


def test_train_resumes_through_the_journal(tmp_path):
    """train 2 iterations → 'crash' → resume from the FileBroker journal to
    4: the uninterrupted 4-iteration run's factors."""
    from cfk_tpu_torch.config import ALSConfig
    from cfk_tpu_torch.data.blocks import Dataset
    from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
    from cfk_tpu_torch.models.als import train_als

    ds = Dataset.from_coo(synthetic_netflix_coo(60, 30, 900, seed=0))
    cfg4 = ALSConfig(rank=3, num_iterations=4, seed=5)
    cfg2 = ALSConfig(rank=3, num_iterations=2, seed=5)
    straight = train_als(ds, cfg4, device="cpu")
    with FileBroker(str(tmp_path), fsync=False) as b:
        train_als(ds, cfg2, device="cpu",
                  checkpoint_manager=JournalCheckpointManager(b))
    with FileBroker(str(tmp_path), fsync=False) as b:
        mgr = JournalCheckpointManager(b)
        assert mgr.latest_iteration() == 2
        resumed = train_als(ds, cfg4, device="cpu", checkpoint_manager=mgr)
    assert torch.equal(resumed.user_factors, straight.user_factors)
    assert torch.equal(resumed.movie_factors, straight.movie_factors)


def _netflix_file(path):
    from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo

    coo = synthetic_netflix_coo(60, 30, 900, seed=0)
    with open(path, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            for uid, r in zip(coo.user_raw[sel], coo.rating[sel]):
                f.write(f"{uid},{int(r)},2005-01-01\n")
    return str(path), [str(x) for x in np.unique(coo.user_raw)[:3]]


def test_cli_train_and_serve_from_the_journal(tmp_path, capsys):
    """``train --checkpoint-journal DIR --journal-partitions 2`` then
    ``recommend`` / ``predict --checkpoint-journal DIR``: the same output as
    the ``--checkpoint-dir`` run's; one store exactly (exit 2 otherwise),
    and a ``tcp://`` target with no broker behind it is a clean error with
    the reference's exit code (2 for a journal, 1 for ``--data``), naming
    the broker it could not reach."""
    from cfk_tpu_torch.cli import main

    data, users = _netflix_file(tmp_path / "r.txt")
    j, c = str(tmp_path / "journal"), str(tmp_path / "ckpt")
    common = ["train", "--data", data, "--rank", "3", "--iterations", "2",
              "--seed", "0", "--output", "none", "--device", "cpu"]
    assert main(common + ["--checkpoint-journal", j,
                          "--journal-partitions", "2"]) == 0
    assert main(common + ["--checkpoint-dir", c]) == 0
    capsys.readouterr()
    rec = ["recommend", "--data", data, "--users", ",".join(users), "-k", "3",
           "--device", "cpu"]
    assert main(rec + ["--checkpoint-journal", j]) == 0
    from_journal = capsys.readouterr().out
    assert main(rec + ["--checkpoint-dir", c]) == 0
    assert from_journal == capsys.readouterr().out
    assert [ln.split("\t")[0] for ln in from_journal.splitlines()] == users
    pj, pc = str(tmp_path / "pj.csv"), str(tmp_path / "pc.csv")
    assert main(["predict", "--checkpoint-journal", j, "--data", data,
                 "--output", pj, "--device", "cpu"]) == 0
    assert main(["predict", "--checkpoint-dir", c, "--data", data,
                 "--output", pc, "--device", "cpu"]) == 0
    assert open(pj).read() == open(pc).read()
    capsys.readouterr()
    assert main(rec) == 2
    assert main(rec + ["--checkpoint-dir", c, "--checkpoint-journal", j]) == 2
    assert main(common + ["--checkpoint-dir", c,
                          "--checkpoint-journal", j]) == 2
    assert "mutually exclusive" in capsys.readouterr().err
    for argv, rc in ((rec + ["--checkpoint-journal", "tcp://localhost:1"],
                      2),
                     (common + ["--checkpoint-journal", "tcp://localhost:1"],
                      2),
                     (["train", "--data", "tcp://localhost:1/ratings",
                       "--device", "cpu"], 1)):
        assert main(argv) == rc
        assert "connect to broker localhost:1" in capsys.readouterr().err


def test_journal_commit_metadata_matches_reference(tmp_path):
    """The commit marker's JSON has the reference's keys and values."""
    u, m = _factors(5)
    for name, broker_cls, mgr_cls in (("ref", RefFileBroker, RefJournal),
                                      ("port", FileBroker,
                                       JournalCheckpointManager)):
        with broker_cls(str(tmp_path / name), fsync=False) as b:
            mgr_cls(b, num_partitions=2).save(4, u, m, meta={"model": "als"})
    commits = {}
    for name in ("ref", "port"):
        with FileBroker(str(tmp_path / name), fsync=False) as b:
            commits[name] = [json.loads(r.value)
                             for r in b.consume("checkpoint-commits", 0)]
    assert commits["ref"] == commits["port"]
