"""The port's streaming fold-in (``cfk_tpu_torch.streaming``) against the
JAX package's (``cfk_tpu.streaming``), on the CPU through the plain
versions.

Fold-in is one ALS half-iteration restricted to the touched users: every
touched row must equal the direct numpy solve of its current normal
equations (``_expected_rows``, the reference test's oracle) at the
reference's atol 2e-4 / rtol 1e-4, and the port's ``fold_in_rows`` the
reference's, padded and tiled.  ``StreamState`` must equal the reference's
(CSR, neighbors, dedup, stale and unknown updates, new users).  Both
packages start a session from the same base model (the reference's factors
carried across by ``weights.factors_from_numpy``) and consume the same
stream: the final factors agree within 1e-4 of max|x| (1e-3 with a warm
retrain), untouched rows stay bit-equal to the base, and the commit
metadata has the reference's keys and values; a stream directory the
reference wrote resumes in the port.  Within the port, delivery faults, a
crash replay on a ``FileBroker``, a torn final commit, an eviction, a
changed ``batch_records``, a quarantined batch and escalated overrides each
end crc-equal to a clean run; the async commit's user-table snapshot is
isolated from the next batch's in-place update; ``prewarm`` leaves the
first real batch no new fold-in program; an attached ``ServeEngine``
serves every commit fresh; the ``stream`` verb drains, resumes and exits 2
on a ``tcp://`` broker it cannot reach; and the chaos lab's five new
scenarios pass.

Fixtures follow the reference's test (``synthetic_netflix_coo(60, 30,
900)``, rank 4), one PyTorch thread, reference sessions shared per module.
"""

import dataclasses
import warnings
import zlib

import numpy as np
import pytest
import torch

from cfk_tpu.config import ALSConfig as RefConfig
from cfk_tpu.data.blocks import Dataset as RefDataset
from cfk_tpu.data.synthetic import synthetic_netflix_coo as ref_coo
import cfk_tpu.streaming as R
import cfk_tpu.transport as RT
from cfk_tpu.transport.serdes import RatingUpdate as RefUpdate

from cfk_tpu_torch.config import ALSConfig
from cfk_tpu_torch.data.blocks import Dataset
from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
from cfk_tpu_torch.resilience.faults import FlakyPlan, FlakyTransport
from cfk_tpu_torch.streaming import (
    StreamConfig,
    StreamConsumer,
    StreamGapError,
    StreamProducer,
    StreamSession,
    StreamState,
    fold_in_rows,
)
from cfk_tpu_torch.streaming.foldin import fold_in_tensor, trace_count
from cfk_tpu_torch.transport import (
    CheckpointManager,
    FileBroker,
    InMemoryBroker,
)
from cfk_tpu_torch.transport.serdes import RatingUpdate
from cfk_tpu_torch.weights import factors_from_numpy

torch.set_num_threads(1)

BATCH = 8


@pytest.fixture(scope="module")
def ref_ds():
    return RefDataset.from_coo(ref_coo(60, 30, 900, seed=0))


@pytest.fixture(scope="module")
def ds():
    return Dataset.from_coo(synthetic_netflix_coo(60, 30, 900, seed=0))


@pytest.fixture(scope="module")
def cfg():
    return ALSConfig(rank=4, num_iterations=4, health_check_every=1)


@pytest.fixture(scope="module")
def ref_cfg():
    return RefConfig(rank=4, num_iterations=4, health_check_every=1)


@pytest.fixture(scope="module")
def ref_base(ref_ds, ref_cfg):
    from cfk_tpu.models.als import train_als

    return train_als(ref_ds, ref_cfg)


@pytest.fixture(scope="module")
def base(ref_base):
    """The reference's base model carried into the port."""
    return factors_from_numpy(np.asarray(ref_base.user_factors),
                              np.asarray(ref_base.movie_factors),
                              device="cpu")


def _produce(broker, producer_cls, ds, n=60, parts=2, seed=7,
             new_users=(4242,)):
    prod = producer_cls(broker, num_partitions=parts)
    rng = np.random.default_rng(seed)
    prod.send_many(rng.choice(ds.user_map.raw_ids, n),
                   rng.choice(ds.movie_map.raw_ids, n),
                   rng.integers(1, 6, n).astype(np.float32))
    for raw in new_users:
        prod.send(raw, int(ds.movie_map.raw_ids[0]), 4.0)
    return prod


def _session(ds, cfg, transport, mgr, *, batch_records=BATCH, stream=None,
             **kw):
    return StreamSession(
        ds, cfg, transport, mgr,
        stream=stream or StreamConfig(batch_records=batch_records),
        device="cpu", **kw)


def _run(ds, cfg, transport, mgr, **kw):
    sess = _session(ds, cfg, transport, mgr, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess.run()
    return sess


def _crc(sess) -> int:
    return zlib.crc32(np.ascontiguousarray(sess.user_factors).tobytes())


@pytest.fixture(scope="module")
def ref_run(ref_ds, ref_cfg, ref_base, tmp_path_factory):
    """The reference's session over the standard stream (2 partitions,
    one new user), drained."""
    broker = RT.InMemoryBroker()
    _produce(broker, R.StreamProducer, ref_ds)
    sess = R.StreamSession(
        ref_ds, ref_cfg, broker,
        RT.CheckpointManager(str(tmp_path_factory.mktemp("ref_run"))),
        stream=R.StreamConfig(batch_records=BATCH), base_model=ref_base)
    model = sess.run()
    return sess, np.asarray(model.user_factors)


@pytest.fixture(scope="module")
def port_run(ds, cfg, base, tmp_path_factory):
    broker = InMemoryBroker()
    _produce(broker, StreamProducer, ds)
    sess = _run(ds, cfg, broker,
                CheckpointManager(str(tmp_path_factory.mktemp("port_run"))),
                base_model=base)
    return sess, broker


# -- producer --------------------------------------------------------------------


def test_producer_matches_reference_and_resumes_past_the_log(ds, ref_ds,
                                                             tmp_path):
    """``send_many`` through ``produce_frames`` writes the reference's log
    bytes; a producer on an existing topic keeps its partition count and
    resumes past the highest seq in the log; ids must be non-negative."""
    import os

    for name, prod_cls, broker_cls in (
            ("ref", R.StreamProducer, RT.FileBroker),
            ("port", StreamProducer, FileBroker)):
        with broker_cls(str(tmp_path / name), fsync=False) as b:
            p1 = prod_cls(b, num_partitions=3)
            assert p1.send(10, 20, 3.0) == 0
            assert p1.send_many([11, 12, 13], [20, 21, 22],
                                [1.0, 2.0, 3.5]) == 1
            assert p1.send_many([], [], []) == 4
            p2 = prod_cls(b)
            assert p2.num_partitions == 3 and p2.next_seq == 4
            assert p2.send(14, 23, 5.0) == 4
    for part in range(3):
        name = os.path.join("rating-updates", f"p{part:05d}.log")
        with open(tmp_path / "ref" / name, "rb") as a, \
                open(tmp_path / "port" / name, "rb") as b:
            assert a.read() == b.read()
    # The per-record path (a transport without produce_frames) gives the
    # same records as the bulk one.
    mem = InMemoryBroker()
    StreamProducer(mem, num_partitions=3).send_many([11, 12, 13],
                                                    [20, 21, 22],
                                                    [1.0, 2.0, 3.5])
    with FileBroker(str(tmp_path / "bulk"), fsync=False) as b:
        StreamProducer(b, num_partitions=3).send_many([11, 12, 13],
                                                      [20, 21, 22],
                                                      [1.0, 2.0, 3.5])
        for part in range(3):
            assert list(mem.consume("rating-updates", part)) == \
                list(b.consume("rating-updates", part))
    with pytest.raises(ValueError, match="non-negative"):
        StreamProducer(mem).send(-1, 2, 3.0)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal where there is no card")
def test_session_defaults_to_the_card(ds, cfg, base, tmp_path):
    """The session runs on CUDA unless the caller asks for the CPU: with no
    card it raises instead of falling back."""
    with pytest.raises(RuntimeError, match="device='cuda'"):
        StreamSession(ds, cfg, InMemoryBroker(),
                      CheckpointManager(str(tmp_path)), base_model=base)


# -- StreamState ---------------------------------------------------------------


def _update_batches(ds):
    """Batches exercising dedup within a batch, stale and retried seqs,
    re-rates, unknown movies and new users (raw ids)."""
    u = [int(x) for x in ds.user_map.raw_ids[:4]]
    mv = [int(x) for x in ds.movie_map.raw_ids[:6]]
    return [
        [(2, u[0], mv[5], 5.0), (1, u[0], mv[5], 1.0), (3, u[1], mv[0], 2.0),
         (4, 999_999, 10**7, 3.0), (5, 999_999, mv[1], 3.0),
         (6, 888_888, mv[2], 4.0), (7, u[2], mv[3], 4.5)],
        [(2, u[0], mv[5], 5.0), (8, u[0], mv[5], 2.0), (0, u[1], mv[0], 1.0),
         (9, 999_999, mv[1], 1.0), (10, u[3], 10**7 + 1, 2.0)],
        [(6, 888_888, mv[2], 4.0)],
    ]


def test_stream_state_matches_reference(ref_ds, ds):
    """CSR, neighbors, staged writes, stats, new users, to_coo: equal to the
    reference's state after every batch."""
    ref, ours = R.StreamState(ref_ds), StreamState(ds)
    for name in ("_base_movies", "_base_ratings", "_base_indptr"):
        a, b = getattr(ref, name), getattr(ours, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for batch in _update_batches(ds):
        rp = ref.stage([RefUpdate(*x) for x in batch])
        op = ours.stage([RatingUpdate(*x) for x in batch])
        assert rp.touched_rows == op.touched_rows
        assert rp.new_user_raw == op.new_user_raw
        assert rp.cell_writes == op.cell_writes
        assert dataclasses.asdict(rp.stats) == dataclasses.asdict(op.stats)
        for row in op.touched_rows:
            a = ref.neighbors(row, rp.cell_writes.get(row))
            b = ours.neighbors(row, op.cell_writes.get(row))
            assert all(np.array_equal(x, y) and x.dtype == y.dtype
                       for x, y in zip(a, b))
        ref.commit(rp)
        ours.commit(op)
        assert ref.applied_seq_high == ours.applied_seq_high
        assert ref.num_users == ours.num_users
    for row in range(ours.num_users):
        a, b = ref.neighbors(row), ours.neighbors(row)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert ours.user_row(999_999) == ours.num_base_users
    assert ours.user_row(123_456_789) is None
    assert np.array_equal(ref.user_raw_ids(), ours.user_raw_ids())
    rc, oc = ref.to_coo(), ours.to_coo()
    for f in ("movie_raw", "user_raw", "rating"):
        assert np.array_equal(getattr(rc, f), getattr(oc, f))


def test_state_duplicate_base_cells_collapse_like_the_reference():
    """A base user's repeated (user, movie) pairs collapse to the last one
    in neighbors/to_coo (the dict semantics the reference keeps), while the
    trainer counts them as repeated observations."""
    from cfk_tpu.data.blocks import RatingsCOO as RefCOO

    from cfk_tpu_torch.data.blocks import RatingsCOO

    cols = dict(movie_raw=np.array([5, 7, 5, 9, 7, 5], np.int64),
                user_raw=np.array([1, 1, 1, 2, 2, 1], np.int64),
                rating=np.array([1, 2, 3, 4, 5, 4.5], np.float32))
    ref = R.StreamState(RefDataset.from_coo(RefCOO(**cols)))
    ours = StreamState(Dataset.from_coo(RatingsCOO(**cols)))
    for row in range(2):
        a, b = ref.neighbors(row), ours.neighbors(row)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert np.array_equal(ours.neighbors(0)[1], [4.5, 2.0])
    assert np.array_equal(ref.to_coo().rating, ours.to_coo().rating)


def test_states_share_the_index_csr(ds):
    """Every state over one index reads the index's ``user_csr``: built
    once, read-only, and equal to a fresh index's over the same ratings."""
    from cfk_tpu_torch.data.blocks import RatingsIndex

    a, b = StreamState(ds), StreamState(ds)
    assert a._base_movies is b._base_movies is ds.user_csr[0]
    with pytest.raises(ValueError, match="read-only"):
        a._base_ratings[0] = 0.0
    idx = RatingsIndex(ds.movie_map, ds.user_map, ds.coo_dense)
    assert all(np.array_equal(x, y)
               for x, y in zip(idx.user_csr, ds.user_csr))
    assert StreamState(idx)._base_indptr is idx.user_csr[2]


# -- fold-in --------------------------------------------------------------------


def _expected_rows(state, rows, m_host, lam):
    """The reference test's oracle: a direct solve of each row's current
    normal equations."""
    k = m_host.shape[1]
    out = np.zeros((len(rows), k), np.float32)
    for i, row in enumerate(rows):
        mv, rt = state.neighbors(row)
        f = m_host[mv]
        a = f.T @ f + lam * max(len(mv), 1) * np.eye(k, dtype=np.float32)
        out[i] = np.linalg.solve(a, f.T @ rt)
    return out


@pytest.mark.parametrize("layout", ["padded", "tiled"])
def test_fold_in_matches_reference_and_direct_solve(ds, layout):
    import jax.numpy as jnp

    from cfk_tpu.streaming.foldin import fold_in_rows as ref_fold

    state = StreamState(ds)
    rng = np.random.default_rng(0)
    m = rng.standard_normal((ds.movie_blocks.padded_entities, 4)).astype(
        np.float32)
    rows = [0, 3, 17, 59]
    nd = [state.neighbors(r) for r in rows]
    got = fold_in_rows(torch.from_numpy(m), nd, lam=0.05, layout=layout)
    np.testing.assert_allclose(got, _expected_rows(state, rows, m, 0.05),
                               atol=2e-4, rtol=1e-4)
    want = ref_fold(jnp.asarray(m), nd, lam=0.05, solver="cholesky",
                    layout=layout)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    assert fold_in_rows(torch.from_numpy(m), [], lam=0.05,
                        layout=layout).shape == (0, 4)


@pytest.mark.parametrize("layout", ["padded", "tiled"])
def test_fold_in_tensor_is_fold_in_rows(ds, layout):
    """The session's device-side entry gives fold_in_rows' rows, as a
    float32 tensor on the table's device."""
    state = StreamState(ds)
    m = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (ds.movie_blocks.padded_entities, 4)).astype(np.float32))
    nd = [state.neighbors(r) for r in range(5)]
    got = fold_in_tensor(m, nd, lam=0.05, layout=layout)
    assert got.dtype == torch.float32 and got.device == m.device
    assert np.array_equal(got.numpy(),
                          fold_in_rows(m, nd, lam=0.05, layout=layout))
    empty = fold_in_tensor(m, [], lam=0.05, layout=layout)
    assert empty.shape == (0, 4) and empty.dtype == torch.float32


def test_fold_in_tiled_padded_parity(ds):
    state = StreamState(ds)
    m = np.random.default_rng(1).standard_normal(
        (ds.movie_blocks.padded_entities, 4)).astype(np.float32)
    nd = [state.neighbors(r) for r in range(8)]
    m = torch.from_numpy(m)
    a = fold_in_rows(m, nd, lam=0.05, layout="padded")
    b = fold_in_rows(m, nd, lam=0.05, layout="tiled")
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="'padded' or 'tiled'"):
        fold_in_rows(m, nd, lam=0.05, layout="bucketed")


@pytest.mark.parametrize("field,value,match", [
    ("batch_records", 0, "batch_records must be >= 1"),
    ("foldin_layout", "segment", "foldin_layout must be auto/padded/tiled"),
    ("retrain_every", 0, "retrain_every must be >= 1"),
    ("grow_multiple", 0, "grow_multiple must be >= 1"),
])
def test_stream_config_validation_matches_reference(field, value, match):
    with pytest.raises(ValueError, match=match) as ours:
        StreamConfig(**{field: value})
    with pytest.raises(ValueError) as ref:
        R.StreamConfig(**{field: value})
    assert str(ours.value) == str(ref.value)


# -- session against session -----------------------------------------------------


_META_KEYS = ("model", "rank", "num_shards", "stream_step", "offsets",
              "batch_records", "seq_high", "base_users", "users", "new_users",
              "quarantined", "overrides")


def test_session_matches_reference_session(ref_run, port_run, base,
                                           ref_base):
    ref_sess, ref_u = ref_run
    sess, _ = port_run
    # The session folds into its own table, never into the base model's.
    assert np.array_equal(base.user_factors.numpy(),
                          np.asarray(ref_base.user_factors))
    u = sess.user_factors
    assert u.shape == ref_u.shape
    scale = np.abs(ref_u).max()
    assert np.abs(u - ref_u).max() <= 1e-4 * scale
    base_u = base.user_factors.numpy()
    untouched = sorted(set(range(sess.state.num_base_users))
                       - set(sess.state._delta))
    assert untouched and np.array_equal(u[untouched], base_u[untouched])
    assert sorted(sess.state._delta) == sorted(ref_sess.state._delta)
    ref_meta = ref_sess.manager.restore().meta
    meta = sess.manager.restore().meta
    assert sorted(meta) == sorted(ref_meta)
    for key in _META_KEYS:
        assert meta[key] == ref_meta[key], key


def test_session_rows_equal_direct_solve(port_run, base, cfg):
    """Every touched row is the direct solve of its current normal
    equations against the fixed movie factors."""
    sess, _ = port_run
    touched = sorted(sess.state._delta)
    m_host = base.movie_factors.numpy()
    np.testing.assert_allclose(
        sess.user_factors[touched],
        _expected_rows(sess.state, touched, m_host, cfg.lam),
        atol=2e-4, rtol=2e-4)


def test_warm_retrain_session_matches_reference(ref_ds, ds, ref_cfg, cfg,
                                                ref_base, base, tmp_path):
    """retrain_every=2 on both packages: the movie side moves, the final
    factors agree within 1e-3 of max|x|, and a resume after a retrain lines
    the rows up again."""
    rb, pb = RT.InMemoryBroker(), InMemoryBroker()
    _produce(rb, R.StreamProducer, ref_ds, n=40, parts=1, new_users=(5555,))
    _produce(pb, StreamProducer, ds, n=40, parts=1, new_users=(5555,))
    rs = R.StreamSession(
        ref_ds, ref_cfg, rb, RT.CheckpointManager(str(tmp_path / "r")),
        stream=R.StreamConfig(batch_records=16, retrain_every=2),
        base_model=ref_base)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rmodel = rs.run()
    stream = StreamConfig(batch_records=16, retrain_every=2)
    sess = _run(ds, cfg, pb, CheckpointManager(str(tmp_path / "p")),
                stream=stream, base_model=base)
    assert sess.metrics.counters.get("stream_retrains", 0) >= 1
    ru, rm = np.asarray(rmodel.user_factors), np.asarray(rmodel.movie_factors)
    m = sess.movie_factors.numpy()
    assert not np.array_equal(m, base.movie_factors.numpy())
    assert np.abs(sess.user_factors - ru).max() <= 1e-3 * np.abs(ru).max()
    assert np.abs(m[: rm.shape[0]] - rm[: m.shape[0]]).max() \
        <= 1e-3 * np.abs(rm).max()
    again = _session(ds, cfg, pb, CheckpointManager(str(tmp_path / "p")),
                     stream=stream)
    assert again.state.num_users == sess.state.num_users
    assert _crc(again) == _crc(sess)


def test_reference_stream_dir_resumes_in_the_port(ref_ds, ds, ref_cfg, cfg,
                                                  ref_base, ref_run,
                                                  tmp_path):
    """A stream directory and FileBroker log the reference wrote (3 batches
    of the standard stream) resume in the port, which ends within 1e-4 of
    the reference's uninterrupted run."""
    log = str(tmp_path / "log")
    with RT.FileBroker(log, fsync=False) as rb:
        _produce(rb, R.StreamProducer, ref_ds)
        rs = R.StreamSession(
            ref_ds, ref_cfg, rb, RT.CheckpointManager(str(tmp_path / "sd")),
            stream=R.StreamConfig(batch_records=BATCH), base_model=ref_base)
        rs.run(max_batches=3)
    with FileBroker(log, fsync=False) as pb:
        sess = _session(ds, cfg, pb, CheckpointManager(str(tmp_path / "sd")))
        assert sess.stream_step == 3
        assert "stream_resumed" in sess.metrics.notes
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sess.run()
    ref_u = ref_run[1]
    assert np.abs(sess.user_factors - ref_u).max() \
        <= 1e-4 * np.abs(ref_u).max()


# -- delivery, crash and poison, within the port ----------------------------------


def test_flaky_transport_matches_reference_and_assembly_is_exact(ref_ds, ds):
    """The same plan misdelivers the same records in both packages; the
    consumer's batches equal the clean delivery's."""
    rb, pb = RT.InMemoryBroker(), InMemoryBroker()
    _produce(rb, R.StreamProducer, ref_ds, n=40)
    _produce(pb, StreamProducer, ds, n=40)
    from cfk_tpu.resilience.faults import FlakyPlan as RefPlan
    from cfk_tpu.resilience.faults import FlakyTransport as RefFlaky

    rf = RefFlaky(rb, RefPlan(duplicate=2, reorder=4, drop=5, seed=3))
    pf = FlakyTransport(pb, FlakyPlan(duplicate=2, reorder=4, drop=5,
                                      seed=3))
    for p in range(2):
        assert [r.offset for r in rf.consume(R.UPDATES_TOPIC, p)] == \
            [r.offset for r in pf.consume(R.UPDATES_TOPIC, p)]
    clean = StreamConsumer(pb)
    faulty = StreamConsumer(pf, gap_wait_s=0.001)
    while True:
        a, b = clean.poll(8), faulty.poll(8)
        assert (a is None) == (b is None)
        if a is None:
            break
        assert a.updates == b.updates and a.cursors_after == b.cursors_after
    assert pf.duplicated and pf.reordered and pf.dropped
    black_hole = FlakyTransport(pb, FlakyPlan(drop=1, drop_passes=1 << 30))
    with pytest.raises(StreamGapError, match="never delivered"):
        StreamConsumer(black_hole, gap_retries=2, gap_wait_s=0.001).poll(4)


def test_delivery_faults_end_crc_equal(ds, cfg, base, port_run, tmp_path):
    _, broker = port_run
    flaky = FlakyTransport(broker, FlakyPlan(duplicate=3, reorder=5, drop=7,
                                             seed=1))
    sess = _run(ds, cfg, flaky, CheckpointManager(str(tmp_path)),
                base_model=base)
    assert flaky.duplicated and flaky.reordered and flaky.dropped
    assert sess.metrics.counters.get("delivery_duplicates", 0) > 0
    assert _crc(sess) == _crc(port_run[0])


def test_crash_replay_on_filebroker_crc_equal(ds, cfg, base, port_run,
                                              tmp_path):
    with FileBroker(str(tmp_path / "log"), fsync=False) as broker:
        _produce(broker, StreamProducer, ds)
        crashed = _session(ds, cfg, broker,
                           CheckpointManager(str(tmp_path / "b")),
                           base_model=base)
        crashed.run(max_batches=3)
        del crashed
        resumed = _run(ds, cfg, broker,
                       CheckpointManager(str(tmp_path / "b")))
        assert resumed.metrics.counters.get("replayed_updates", 0) > 0
    assert _crc(resumed) == _crc(port_run[0])


def test_torn_final_commit_falls_back_and_converges(ds, cfg, base, port_run,
                                                    tmp_path):
    from cfk_tpu_torch.resilience.faults import TornCheckpointManager

    _, broker = port_run
    final = port_run[0].stream_step
    torn = TornCheckpointManager(CheckpointManager(str(tmp_path)),
                                 tear_at=final)
    _run(ds, cfg, broker, torn, base_model=base)
    assert torn.torn
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        resumed = _session(ds, cfg, broker, CheckpointManager(str(tmp_path)))
    assert resumed.stream_step == final - 1
    resumed.run()
    assert resumed.stream_step == final
    assert _crc(resumed) == _crc(port_run[0])


def test_eviction_drains_and_commits_the_cursor(ds, cfg, base, port_run,
                                                tmp_path):
    from cfk_tpu_torch.resilience.preempt import PreemptionGuard

    _, broker = port_run
    guard = PreemptionGuard()
    sess = _session(ds, cfg, broker, CheckpointManager(str(tmp_path)),
                    base_model=base, preemption_guard=guard)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess.run(before_batch=lambda step: step >= 3 and guard.trigger())
    assert "preempted" in sess.metrics.notes
    st = CheckpointManager(str(tmp_path)).restore()
    assert {int(p): int(o) for p, o in st.meta["offsets"].items()} == \
        sess.consumer.cursors
    assert st.meta["stream_step"] == sess.stream_step == 3
    resumed = _run(ds, cfg, broker, CheckpointManager(str(tmp_path)))
    assert _crc(resumed) == _crc(port_run[0])


def test_committed_batch_records_win_on_resume(ds, cfg, base, port_run,
                                               tmp_path):
    _, broker = port_run
    first = _session(ds, cfg, broker, CheckpointManager(str(tmp_path)),
                     base_model=base)
    first.run(max_batches=2)
    assert first.backlog() > 0
    again = _session(ds, cfg, broker, CheckpointManager(str(tmp_path)),
                     batch_records=3)
    assert again.stream.batch_records == BATCH
    assert "batch_records_override" in again.metrics.notes
    again.run()
    assert _crc(again) == _crc(port_run[0])


def test_quarantined_batch_not_replayed_and_factors_untouched(ds, cfg, base,
                                                              tmp_path):
    broker = InMemoryBroker()
    prod = StreamProducer(broker)
    victim, other = (int(x) for x in ds.user_map.raw_ids[:2])
    prod.send(888, int(ds.movie_map.raw_ids[1]), float("nan"))
    prod.send(victim, int(ds.movie_map.raw_ids[2]), float("nan"))
    prod.send(other, int(ds.movie_map.raw_ids[3]), 5.0)
    sess = _session(ds, cfg, broker, CheckpointManager(str(tmp_path)),
                    base_model=base, batch_records=1)
    u_before = sess.user_factors.copy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess.run()
    assert len(sess.quarantined) == 2 and sess.backlog() == 0
    assert sess.metrics.counters.get("quarantined_batches") == 2
    vrow, orow = sess.state.user_row(victim), sess.state.user_row(other)
    assert np.array_equal(sess.user_factors[vrow], u_before[vrow])
    assert not np.array_equal(sess.user_factors[orow], u_before[orow])
    again = _session(ds, cfg, broker, CheckpointManager(str(tmp_path)))
    assert again.quarantined == sess.quarantined
    assert again.state.user_row(888) is None
    assert np.all(np.isfinite(again.state.neighbors(vrow)[1]))
    assert _crc(again) == _crc(sess)


def test_poison_batch_raises_when_configured(ds, base, tmp_path):
    from cfk_tpu_torch.streaming import PoisonedBatchError

    cfg = ALSConfig(rank=4, num_iterations=4, health_check_every=1,
                    on_unrecoverable="raise")
    broker = InMemoryBroker()
    StreamProducer(broker).send(int(ds.user_map.raw_ids[0]),
                                int(ds.movie_map.raw_ids[0]), float("nan"))
    sess = _session(ds, cfg, broker, CheckpointManager(str(tmp_path)),
                    base_model=base)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(PoisonedBatchError, match="quarantined"):
            sess.run()


def test_escalated_overrides_survive_a_resume(tmp_path):
    """λ = 0 and a new one-rating user: the singular batch escalates λ,
    the escalation is committed and restored on resume, so the replayed
    good batches solve as the uninterrupted run's did (crc-equal)."""
    from cfk_tpu_torch.models.als import train_als
    from cfk_tpu_torch.resilience.faults import blockstructured_coo

    ds = Dataset.from_coo(blockstructured_coo(seed=0))
    cfg = ALSConfig(rank=4, num_iterations=4, lam=0.0, health_check_every=1)
    base = train_als(ds, cfg, device="cpu")

    def produce(broker):
        prod = StreamProducer(broker)
        prod.send(777, int(ds.movie_map.raw_ids[0]), 5.0)
        for i in range(4):
            prod.send(int(ds.user_map.raw_ids[i]),
                      int(ds.movie_map.raw_ids[i + 1]), 4.0)

    clean = InMemoryBroker()
    produce(clean)
    s_clean = _run(ds, cfg, clean, CheckpointManager(str(tmp_path / "c")),
                   base_model=base, batch_records=1)
    assert s_clean._overrides.lam > 0
    assert s_clean.metrics.gauges.get("stream_escalation_level", 0) >= 1
    crash = InMemoryBroker()
    produce(crash)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s1 = _session(ds, cfg, crash, CheckpointManager(str(tmp_path / "x")),
                      base_model=base, batch_records=1)
        s1.run(max_batches=2)
    s2 = _session(ds, cfg, crash, CheckpointManager(str(tmp_path / "x")),
                  batch_records=1)
    assert s2._overrides == s1._overrides
    s2.run()
    assert _crc(s2) == _crc(s_clean)


# -- the commit snapshot, prewarm, serving ------------------------------------------


def test_user_table_snapshot_isolated_from_the_next_batch(ds, cfg, base,
                                                          port_run, tmp_path):
    """Each async commit snapshots the host user table at the call; a slow
    writer serializes it only after later batches have updated rows in
    place, and every step on disk still holds the table of its own
    commit."""
    from cfk_tpu_torch.resilience.faults import SlowDiskCheckpointManager

    _, broker = port_run
    mgr = SlowDiskCheckpointManager(str(tmp_path), delay_s=0.05,
                                    max_pending=64)
    sess = _session(ds, cfg, broker, mgr, base_model=base)
    tables = {sess.stream_step: sess.user_factors.copy()}
    while sess.step() is not None:
        tables[sess.stream_step] = sess.user_factors.copy()
    assert mgr.pending_count > 0  # the writer is behind the loop
    mgr.wait_pending()
    for step, table in tables.items():
        assert np.array_equal(mgr.restore(step).user_factors, table), step
    assert len(tables) >= 4


def test_prewarm_leaves_the_first_batch_no_new_program(ds, cfg, base,
                                                       tmp_path):
    broker = InMemoryBroker()
    _produce(broker, StreamProducer, ds, n=12, parts=1, new_users=())
    sess = _session(ds, cfg, broker, CheckpointManager(str(tmp_path / "a")),
                    base_model=base)
    warm = sess.prewarm()
    assert warm["programs"] > 0
    before = trace_count()
    assert sess.step() is not None
    assert trace_count() == before
    tiled = ALSConfig(rank=4, num_iterations=4, layout="tiled")
    tds = Dataset.from_coo(synthetic_netflix_coo(60, 30, 900, seed=0),
                           layout="tiled", chunk_elems=256)
    t = _session(tds, tiled, broker, CheckpointManager(str(tmp_path / "b")),
                 base_model=base)
    assert "skipped" in t.prewarm()


def test_attached_engine_serves_every_commit_fresh(ds, cfg, base, port_run,
                                                   tmp_path):
    from cfk_tpu_torch.serving import ServeEngine, engine_from_model

    _, broker = port_run
    sess = _session(ds, cfg, broker, CheckpointManager(str(tmp_path)),
                    base_model=base)
    eng = engine_from_model(base, ds)
    eng.attach_session(sess)
    sess.run()
    assert eng.invalidations >= len(sess.state._delta)
    rows = np.asarray(sorted(sess.state._delta))
    st = CheckpointManager(str(tmp_path)).restore()
    fresh = ServeEngine(st.user_factors, st.movie_factors,
                        num_users=sess.state.num_users,
                        num_movies=ds.movie_map.num_entities, device="cpu")
    a = eng.topk(rows, 5, exclude_seen=False)
    b = fresh.topk(rows, 5, exclude_seen=False)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_failing_listener_is_counted_not_raised(ds, cfg, base, port_run,
                                                tmp_path):
    _, broker = port_run
    sess = _session(ds, cfg, broker, CheckpointManager(str(tmp_path)),
                    base_model=base)
    got = []

    def broken(event):
        raise RuntimeError("listener down")

    sess.add_commit_listener(broken)
    sess.add_commit_listener(got.append)
    sess.run()
    assert got and sess.metrics.counters["commit_listener_errors"] == len(got)
    touched = got[0]["touched_rows"]
    got[0]["rows"][:] = np.nan  # a copy: the session's table is untouched
    assert np.all(np.isfinite(sess.user_factors[touched]))


# -- the stream verb and the chaos lab ----------------------------------------------


def test_stream_cli_drains_resumes_and_refuses_tcp(ds, tmp_path, capsys):
    from cfk_tpu_torch.cli import main

    coo = synthetic_netflix_coo(60, 30, 900, seed=0)
    data = tmp_path / "r.txt"
    with open(data, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            for uid, r in zip(coo.user_raw[sel], coo.rating[sel]):
                f.write(f"{uid},{int(r)},2005-01-01\n")
    rng = np.random.default_rng(1)
    csv = tmp_path / "u.csv"
    with open(csv, "w") as f:
        f.write("# user,movie,rating\n")
        for _ in range(40):
            f.write(f"{rng.choice(ds.user_map.raw_ids)},"
                    f"{rng.choice(ds.movie_map.raw_ids)},"
                    f"{rng.integers(1, 6)}\n")
        f.write(f"999999,{ds.movie_map.raw_ids[0]},4\n")
    argv = ["stream", "--data", str(data), "--updates", str(tmp_path / "log"),
            "--stream-dir", str(tmp_path / "sd"), "--rank", "4",
            "--batch-records", "8", "--device", "cpu"]
    assert main(argv + ["--produce-csv", str(csv), "--partitions", "2"]) == 0
    assert "produced 41 updates" in capsys.readouterr().err
    assert main(argv) == 0
    out = capsys.readouterr()
    first = dict(kv.split("=", 1) for kv in out.out.split() if "=" in kv)
    assert "merged-state MSE=" in out.err
    assert first["g.backlog"] == "0" and first["g.users"] == "61"
    assert main(argv + ["--prewarm", "--metrics", "json"]) == 0
    out = capsys.readouterr()
    import json

    row = json.loads(out.out.strip().splitlines()[-1])
    assert row["gauges"]["stream_step"] == float(first["g.stream_step"])
    assert "stream_commits" not in row["counters"]
    assert "prewarmed" in out.err
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2\n")
    assert main(argv + ["--produce-csv", str(bad)]) == 1
    tcp = list(argv)
    tcp[tcp.index("--updates") + 1] = "tcp://localhost:1"
    assert main(tcp) == 2
    assert "connect to broker localhost:1" in capsys.readouterr().err


@pytest.mark.parametrize("scenario", [
    "quantized_table", "stream_duplicates", "stream_crash_replay",
    "stream_poison_batch", "serve_under_foldin"])
def test_chaos_lab_new_scenarios_on_cpu(scenario, capsys):
    import json

    from cfk_tpu_torch.scripts import chaos_lab

    assert chaos_lab.main(["--device", "cpu", "--scenario", scenario]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rows[0]["ok"] and rows[0]["flight_recorder"]["named_fault"]
    assert rows[-1]["chaos_lab"] == "pass"
