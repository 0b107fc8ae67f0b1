"""The port's replicated serving fleet (``cfk_tpu_torch/serving/fleet.py``)
and the request server's fleet seams, on the CPU.

Against the JAX package's fleet on the same seeded factors (48 users x 64
movies, rank 6, ``tile_m`` 16, as the chaos lab's fixture) through the same
commit sequence: the delta frames are byte-equal (``encode_factor_delta``)
and so are the eager/lazy splits (``knee_hot_rows`` / ``select_hot_rows``,
bit-identical); ``table_crc`` is equal after commits, after a gap and its
resync, and after a rollover; the answers agree through ``compare_topk``
(scores within 1e-5 of max |score|, ids equal outside near-ties); admission
sheds the same requests as retriable rejections; a kill and its failover
re-serve from the committed cursor.  Within the port: the reference's
protocol tests (seq order, duplicates, undecodable frames, deferred deltas,
staleness stamps, /readyz, client retries, a commit listener that raises,
a stream session feeding the publisher).

Single-threaded where the protocol allows (``FleetReplica.pump()``); the
threaded kill and rollover paths also run in the chaos lab.  One PyTorch
thread.
"""

import os
import sys
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from cfk_tpu_torch.serving import (
    AdmissionController,
    DeltaPublisher,
    RecommendServer,
    ServeClient,
    ServeEngine,
    ServeFleet,
    ensure_serve_topics,
    table_crc,
)
from cfk_tpu_torch.transport import InMemoryBroker

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_topk import compare_topk  # noqa: E402

torch.set_num_threads(1)

U, M, K = 48, 64, 6
TOL = 1e-5  # of max |score|


def _factors(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((U, K)).astype(np.float32),
            rng.standard_normal((M, K)).astype(np.float32))


def _engine(u, m, **kw):
    return ServeEngine(u, m, num_users=U, num_movies=M, tile_m=16,
                       device="cpu", **kw)


def _wired(replicas=1, seed=0, transport=None, **fleet_kw):
    """(fleet, publisher, broker, (u, m)) with the store seeded."""
    u, m = _factors(seed)
    broker = InMemoryBroker()
    fleet = ServeFleet(lambda i: _engine(u, m), transport or broker,
                       replicas=replicas, **fleet_kw)
    fleet.seed_store(u, m, num_users=U)
    pub = DeltaPublisher(broker, fleet.store)
    return fleet, pub, broker, (u, m)


def _commit(rng, rows, *, num_users=U, cells=()):
    rows = np.asarray(rows, np.int64)
    return {"touched_rows": rows.tolist(),
            "rows": rng.standard_normal((rows.size, K)).astype(np.float32),
            "cells": list(cells), "retrain": False, "num_users": num_users}


def _commit_sequence(seed=11):
    """A skewed touch stream (rows 0-2 in every commit, a tail touched
    once), seen cells, a retrain epoch and commits after it."""
    rng = np.random.default_rng(seed)
    events = []
    for i in range(10):
        events.append(_commit(rng, [0, 1, 2, 10 + i],
                              cells=[(int(rng.integers(0, U)),
                                      int(rng.integers(0, M)))]))
        events.append(_commit(rng, [0, 1, 2]))
    events.append(_commit(rng, [0, 10, 11, 12, 13, 14]))
    u2, m2 = _factors(31)
    events.append({"retrain": True, "user_factors": u2, "movie_factors": m2,
                   "num_users": U})
    events.append(_commit(rng, [3, 4, 40]))
    return events


# -- against the JAX package's fleet ------------------------------------------


def _jax_wired(replicas=1, seed=0, transport=None, **fleet_kw):
    from cfk_tpu.serving import DeltaPublisher as JPublisher
    from cfk_tpu.serving import ServeEngine as JEngine
    from cfk_tpu.serving import ServeFleet as JFleet
    from cfk_tpu.transport import InMemoryBroker as JBroker

    u, m = _factors(seed)
    broker = JBroker()
    fleet = JFleet(lambda i: JEngine(u, m, num_users=U, num_movies=M,
                                     tile_m=16), transport or broker,
                   replicas=replicas, **fleet_kw)
    fleet.seed_store(u, m, num_users=U)
    return fleet, JPublisher(broker, fleet.store), broker


def test_delta_frames_byte_equal_to_jax_publisher():
    """The same commits through both publishers: the same frames, byte for
    byte, the same eager/lazy counts, and stores holding the same rows."""
    fleet, pub, broker, _ = _wired()
    jfleet, jpub, jbroker = _jax_wired()
    for ev in _commit_sequence():
        pub.on_commit(ev)
        jpub.on_commit(ev)
    got = [r.value for r in broker.consume("factor-deltas", 0)]
    want = [r.value for r in jbroker.consume("factor-deltas", 0)]
    assert len(got) == len(want) == 23
    assert got == want
    assert (pub.eager_rows, pub.lazy_rows, pub.seq) == (
        jpub.eager_rows, jpub.lazy_rows, jpub.seq)
    assert pub.lazy_rows > 0  # the split really sent a tail lazily
    s, js = fleet.store.state(), jfleet.store.state()
    assert (s["epoch"], s["seq"], s["num_users"], s["cells"]) == (
        js["epoch"], js["seq"], js["num_users"], js["cells"])
    assert sorted(s["overlay"]) == sorted(js["overlay"])
    for row, f in s["overlay"].items():
        assert np.array_equal(f, js["overlay"][row])


@pytest.mark.parametrize("kind", ["zipf", "uniform", "head", "empty"])
def test_hot_row_selection_bit_identical(kind):
    from cfk_tpu.offload.hot import coverage_curve as j_cov
    from cfk_tpu.offload.hot import knee_hot_rows as j_knee
    from cfk_tpu.offload.hot import select_hot_rows as j_select
    from cfk_tpu_torch.offload.hot import (
        coverage_curve,
        knee_hot_rows,
        select_hot_rows,
    )

    rng = np.random.default_rng(5)
    counts = {
        "zipf": np.minimum(rng.zipf(1.3, 5000), 10**6),
        "uniform": rng.integers(0, 4, 3000),
        "head": np.concatenate([np.full(3, 500), np.ones(200, np.int64),
                                np.zeros(50, np.int64)]),
        "empty": np.zeros(10, np.int64),
    }[kind]
    order, cov = coverage_curve(counts)
    jorder, jcov = j_cov(counts)
    assert np.array_equal(order, jorder) and np.array_equal(cov, jcov)
    f = knee_hot_rows(counts)
    assert f == j_knee(counts)
    for n in (f, 0, 7, counts.size + 3):
        assert np.array_equal(select_hot_rows(counts, n), j_select(counts, n))


def test_table_crc_matches_jax_after_commits_gap_and_rollover():
    """Both fleets behind a tamper that hides the same frame, fed the same
    commits: the replicas' tables crc-equal after the gap's resync, and
    again after the epoch rollover and the deferred commit it replays."""
    from cfk_tpu.resilience.faults import DeltaStreamTamper as JTamper
    from cfk_tpu.serving import table_crc as j_crc
    from cfk_tpu.transport import InMemoryBroker as JBroker
    from cfk_tpu_torch.resilience.faults import DeltaStreamTamper

    broker, jbroker = InMemoryBroker(), JBroker()
    fleet, _, _, _ = _wired(transport=DeltaStreamTamper(
        broker, topic="factor-deltas", hide=[3]))
    jfleet, _, _ = _jax_wired(transport=JTamper(
        jbroker, topic="factor-deltas", hide=[3]))
    pub = DeltaPublisher(broker, fleet.store)
    from cfk_tpu.serving import DeltaPublisher as JPublisher

    jpub = JPublisher(jbroker, jfleet.store)
    rep, jrep = fleet.replicas[0], jfleet.replicas[0]
    events = _commit_sequence()
    retrain = next(i for i, e in enumerate(events) if e.get("retrain"))
    for ev in events[:retrain]:
        pub.on_commit(ev)
        jpub.on_commit(ev)
    for r in (rep, jrep):
        r.apply_deltas()
        r.pull_lazy()
    assert rep.gaps_detected == jrep.gaps_detected == 1
    assert rep.resyncs == jrep.resyncs == 1
    assert rep.applied_seq == jrep.applied_seq == retrain
    assert table_crc(rep.engine) == j_crc(jrep.engine)
    for ev in events[retrain:]:
        pub.on_commit(ev)
        jpub.on_commit(ev)
    deadline = time.monotonic() + 60
    while (rep.rollovers == 0 or jrep.rollovers == 0) \
            and time.monotonic() < deadline:
        for r in (rep, jrep):
            if r.rollovers == 0:
                r.apply_deltas()
                r.maybe_flip()
        time.sleep(0.01)
    for r in (rep, jrep):
        r.apply_deltas()
        r.pull_lazy()
    assert rep.engine.epoch == jrep.engine.epoch == 1
    assert rep.applied_seq == jrep.applied_seq == len(events)
    assert table_crc(rep.engine) == j_crc(jrep.engine)


def test_answers_agree_with_jax_fleet():
    """Each user's answer from the port's two replicas against the JAX
    package's, after the same commits (and the lazy pulls)."""
    fleet, pub, broker, _ = _wired(replicas=2)
    jfleet, jpub, jbroker = _jax_wired(replicas=2)
    events = _commit_sequence()
    retrain = next(i for i, e in enumerate(events) if e.get("retrain"))
    for ev in events[:retrain]:
        pub.on_commit(ev)
        jpub.on_commit(ev)
    from cfk_tpu.serving import ServeClient as JClient

    client = ServeClient(broker, route_by_user=True)
    jclient = JClient(jbroker, route_by_user=True)
    users = list(range(U))
    got = {}
    for name, fl, cl in (("port", fleet, client), ("jax", jfleet, jclient)):
        for r in fl.replicas:
            r.apply_deltas()
            r.pull_lazy()
        ids = [cl.request(u, 5) for u in users]
        cl.flush()
        for r in fl.replicas:
            while r.server.step():
                pass
        by_id = {resp.req_id: resp for resp in cl.poll_responses()}
        got[name] = [by_id[i] for i in ids]
        assert sum(r.server.requests_served for r in fl.replicas) == U
        assert all(r.server.requests_served > 0 for r in fl.replicas)
    tv = np.stack([r.scores for r in got["port"]])
    ti = np.stack([r.movie_rows for r in got["port"]])
    jv = np.stack([np.asarray(r.scores) for r in got["jax"]])
    ji = np.stack([np.asarray(r.movie_rows) for r in got["jax"]])
    res = compare_topk(tv, ti, jv, ji, tol=TOL)
    assert res["ok"], res
    assert [r.epoch for r in got["port"]] == [r.epoch for r in got["jax"]]


def test_admission_sheds_the_same_requests_as_jax():
    from cfk_tpu.serving import AdmissionController as JAdmission
    from cfk_tpu.serving import RecommendServer as JServer
    from cfk_tpu.serving import ServeClient as JClient
    from cfk_tpu.serving import ServeEngine as JEngine
    from cfk_tpu.serving import ensure_serve_topics as j_ensure
    from cfk_tpu.transport import InMemoryBroker as JBroker

    u, m = _factors()
    outcome = {}
    for name, broker, ensure, server_cls, adm, client_cls, eng in (
            ("port", InMemoryBroker(), ensure_serve_topics, RecommendServer,
             AdmissionController, ServeClient, _engine(u, m)),
            ("jax", JBroker(), j_ensure, JServer, JAdmission, JClient,
             JEngine(u, m, num_users=U, num_movies=M, tile_m=16))):
        ensure(broker)
        server = server_cls(eng, broker, admission=adm(max_queue=3))
        client = client_cls(broker)
        ids = [client.request(user, 3) for user in (5, 9, 1, 7, 30, 2, 11)]
        client.flush()
        assert server.step() == 7
        by_id = {r.req_id: r for r in client.poll_responses()}
        outcome[name] = [(bool(by_id[i].retriable), by_id[i].error)
                         for i in ids]
        assert server.shed == 4
    assert outcome["port"] == outcome["jax"]
    assert [r for r, _ in outcome["port"]] == [False] * 3 + [True] * 4


def test_failover_reserves_from_the_committed_cursor_as_jax():
    """The victim polled a request and died before answering: in both
    packages the heir adopts the partition at the committed cursor and
    answers it, with the same answer."""
    from cfk_tpu.serving import ServeClient as JClient

    answers = {}
    for name, (fleet, _, broker) in (
            ("port", _wired(replicas=2)[:3]), ("jax", _jax_wired(replicas=2))):
        client = (ServeClient if name == "port" else JClient)(
            broker, route_by_user=True)
        victim, heir = fleet.replicas
        rid = client.request(4, 3)  # user 4 -> partition 0, the victim's
        client.flush()
        victim.server._poll_requests()
        assert victim.server._cursors[0] == 1
        assert victim.server.committed_cursors[0] == 0
        victim.kill()
        fleet.failover(0)
        assert fleet.failovers == [{"dead": 0, "heir": 1}]
        heir.pump()
        by_id = {r.req_id: r for r in client.poll_responses()}
        assert rid in by_id and not by_id[rid].error
        answers[name] = by_id[rid]
        assert heir.server.committed_cursors[0] == 1
    res = compare_topk(answers["port"].scores[None],
                       answers["port"].movie_rows[None],
                       np.asarray(answers["jax"].scores)[None],
                       np.asarray(answers["jax"].movie_rows)[None], tol=TOL)
    assert res["ok"], res


# -- the reference's protocol tests, in the port --------------------------------


def test_publisher_seq_monotonic_across_epochs():
    from cfk_tpu_torch.transport.serdes import decode_factor_delta

    fleet, pub, broker, _ = _wired()
    rng = np.random.default_rng(1)
    pub.on_commit(_commit(rng, [1, 2]))
    pub.on_commit(_commit(rng, [3]))
    u2, m2 = _factors(9)
    pub.on_commit({"retrain": True, "user_factors": u2,
                   "movie_factors": m2, "num_users": U})
    pub.on_commit(_commit(rng, [4]))
    frames = [decode_factor_delta(r.value)
              for r in broker.consume("factor-deltas", 0, 0)]
    assert [f.seq for f in frames] == [1, 2, 3, 4]
    assert [f.kind for f in frames] == ["rows", "rows", "epoch", "rows"]
    assert [f.epoch for f in frames] == [0, 0, 1, 1]
    assert frames[2].user_rows.size == 0  # the snapshot is in the store
    np.testing.assert_array_equal(fleet.store.state(1)["user_factors"], u2)
    assert fleet.store.state()["seq"] == 4  # the store never trails the log


def test_replica_apply_matches_direct_engine_crc():
    fleet, pub, broker, (u, m) = _wired()
    oracle = _engine(u, m)
    rng = np.random.default_rng(3)
    replica = fleet.replicas[0]
    for _ in range(8):
        ev = _commit(rng, rng.integers(0, U, size=4),
                     cells=[(int(rng.integers(0, U)),
                             int(rng.integers(0, M)))])
        pub.on_commit(ev)
        oracle.on_commit(ev)
    replica.apply_deltas()
    replica.pull_lazy()
    assert replica.applied_seq == 8 and replica.gaps_detected == 0
    assert table_crc(replica.engine) == table_crc(oracle)


@pytest.mark.parametrize("mode", ["hide", "truncate"])
def test_delta_gap_detected_and_resynced_crc_exact(mode):
    from cfk_tpu_torch.resilience.faults import DeltaStreamTamper

    broker = InMemoryBroker()
    tampered = DeltaStreamTamper(broker, topic="factor-deltas", hide=[2],
                                 mode=mode)
    fleet, _, _, (u, m) = _wired(transport=tampered)
    pub = DeltaPublisher(broker, fleet.store)  # the real log underneath
    oracle = _engine(u, m)
    rng = np.random.default_rng(4)
    replica = fleet.replicas[0]
    for _ in range(6):
        ev = _commit(rng, rng.integers(0, U, size=3))
        pub.on_commit(ev)
        oracle.on_commit(ev)
    replica.apply_deltas()
    replica.pull_lazy()
    assert (tampered.hidden if mode == "hide" else tampered.truncated) >= 1
    assert replica.gaps_detected >= 1 and replica.resyncs >= 1
    assert replica.applied_seq == 6
    assert table_crc(replica.engine) == table_crc(oracle)


def test_duplicate_delta_delivery_is_idempotent():
    fleet, pub, broker, (u, m) = _wired()
    oracle = _engine(u, m)
    rng = np.random.default_rng(6)
    replica = fleet.replicas[0]
    for i in range(3):
        ev = _commit(rng, [i, i + 10])
        pub.on_commit(ev)
        oracle.on_commit(ev)
    replica.apply_deltas()
    replica._delta_cursor = 0  # replay the whole log
    replica.apply_deltas()
    replica.pull_lazy()
    assert replica.applied_seq == 3 and replica.gaps_detected == 0
    assert table_crc(replica.engine) == table_crc(oracle)


def test_rollover_serves_old_epoch_until_flip_then_new():
    fleet, pub, broker, _ = _wired()
    ensure_serve_topics(broker)
    client = ServeClient(broker)
    replica = fleet.replicas[0]
    fleet.prewarm(3, max_batch=8)
    assert next(iter(client.ask([1], 3, server=replica.server)
                     .values())).epoch == 0
    u2, m2 = _factors(22)
    pub.on_commit({"retrain": True, "user_factors": u2,
                   "movie_factors": m2, "num_users": U})
    late = _commit(np.random.default_rng(7), [5, 6])
    pub.on_commit(late)  # rows for the new epoch before the flip: deferred
    replica.apply_deltas()  # starts the background build
    assert next(iter(client.ask([2], 3, server=replica.server)
                     .values())).epoch in (0, 1)
    deadline = time.monotonic() + 30
    while replica.rollovers == 0 and time.monotonic() < deadline:
        replica.pump()
        time.sleep(0.01)
    assert replica.rollovers == 1 and replica.engine.epoch == 1
    assert set(replica.rollover_times) == {"build_s", "prewarm_s"}
    resp = next(iter(client.ask([3], 3, server=replica.server).values()))
    assert resp.epoch == 1
    oracle = _engine(u2, m2)
    oracle.epoch = 1
    oracle.on_commit(late)
    s, i = oracle.topk(np.asarray([3]), 3)
    np.testing.assert_array_equal(resp.movie_rows, i[0])
    np.testing.assert_array_equal(resp.scores, s[0])
    assert table_crc(replica.engine) == table_crc(oracle)
    assert 1 not in replica.engine._u_hot  # no old-epoch overlay leaked


def test_admission_capacity_sizing_and_client_retries():
    a = AdmissionController(capacity_qps=1000.0, max_queue_s=0.05)
    assert a.max_queue == 50
    with pytest.raises(ValueError):
        AdmissionController()
    u, m = _factors()
    broker = InMemoryBroker()
    ensure_serve_topics(broker)
    server = RecommendServer(_engine(u, m), broker,
                             admission=AdmissionController(max_queue=2))
    client = ServeClient(broker)
    slept = []
    got = client.ask(list(range(6)), 3, server=server, retries=4,
                     rng=np.random.default_rng(0), sleep=slept.append)
    assert len(got) == 6 and all(not r.error for r in got.values())
    assert client.rejections >= 4 and client.retries >= 4
    assert server.shed >= 4
    assert server.metrics.counters["serve_shed"] == server.shed
    assert slept and all(s > 0 for s in slept)
    with pytest.raises(TimeoutError, match="attempts"):
        ServeClient(broker).ask([1], 3, timeout_s=0.2, retries=2,
                                rng=np.random.default_rng(0),
                                sleep=lambda s: None)


def test_fleet_user_keyed_routing_and_threaded_failover():
    from cfk_tpu_torch.transport.serdes import decode_score_request

    fleet, pub, broker, (u, m) = _wired(replicas=2)
    client = ServeClient(broker, route_by_user=True)
    for user in range(8):
        client.request(user, 3)
    client.flush()
    for part in (0, 1):
        users = [decode_score_request(r.value).user
                 for r in broker.consume("serve-requests", part, 0)]
        assert users == [x for x in range(8) if x % 2 == part]
    fleet.prewarm(3, max_batch=8)
    fleet.start()
    oracle = _engine(u, m)
    try:
        assert len(client.ask(list(range(16)), 3, timeout_s=20)) == 16
        fleet.kill_replica(0)
        assert not fleet.replicas[0].alive and fleet.replicas[1].alive
        got = client.ask(list(range(16)), 3, timeout_s=20)
    finally:
        fleet.stop()
    assert len(got) == 16 and fleet.counters()["failovers"] == 1
    for rid, resp in got.items():
        assert not resp.error
    s, i = oracle.topk(np.arange(16), 3)
    by_user = sorted(got.items())
    assert all(np.array_equal(r.movie_rows, i[n])
               for n, (_, r) in enumerate(by_user))


def test_responses_stamped_with_staleness_backlog():
    fleet, pub, broker, _ = _wired()
    ensure_serve_topics(broker)
    rng = np.random.default_rng(8)
    replica = fleet.replicas[0]
    client = ServeClient(broker)
    for _ in range(3):
        pub.on_commit(_commit(rng, [1]))
    client.request(2, 3)
    client.flush()
    replica.server.step()
    assert client.poll_responses()[0].staleness == 3
    replica.apply_deltas()
    client.request(2, 3)
    client.flush()
    replica.server.step()
    assert client.poll_responses()[0].staleness == 0


def test_readyz_gated_on_prewarm_and_labels():
    u, m = _factors()
    broker = InMemoryBroker()
    ensure_serve_topics(broker)
    server = RecommendServer(_engine(u, m), broker, metrics_port=0,
                             labels={"replica": 3})
    try:
        base = f"http://127.0.0.1:{server.metrics_server.port}"
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{base}/readyz", timeout=5)
        assert exc.value.code == 503
        with urllib.request.urlopen(f"{base}/healthz", timeout=5) as r:
            assert r.status == 200
        server.engine.prewarm(3, max_batch=8)
        with urllib.request.urlopen(f"{base}/readyz", timeout=5) as r:
            assert r.status == 200
        ServeClient(broker).ask([1], 3, server=server)
        with urllib.request.urlopen(f"{base}/metrics", timeout=5) as r:
            assert 'replica="3"' in r.read().decode()
    finally:
        server.close()
    fleet, _, _, _ = _wired(replicas=2)
    assert not fleet.ready
    fleet.prewarm(3, max_batch=8)
    assert fleet.ready


def test_publisher_end_to_end_with_stream_session(tmp_path):
    """StreamSession commit → DeltaPublisher frame → replica apply: the
    replica's table crc-equals an engine attached to the session, and a
    listener that raises neither stops the stream nor starves the others."""
    from cfk_tpu_torch.config import ALSConfig
    from cfk_tpu_torch.data.blocks import Dataset
    from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
    from cfk_tpu_torch.models.als import train_als
    from cfk_tpu_torch.streaming import (
        StreamConfig,
        StreamProducer,
        StreamSession,
    )
    from cfk_tpu_torch.transport.checkpoint import CheckpointManager

    ds = Dataset.from_coo(synthetic_netflix_coo(40, 20, 400, seed=2))
    cfg = ALSConfig(rank=4, num_iterations=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = train_als(ds, cfg, device="cpu")
    nu, nm = ds.user_map.num_entities, ds.movie_map.num_entities
    u, mv = model.host_factors()
    broker = InMemoryBroker()

    def engine(i=0):
        return ServeEngine(u, mv, num_users=nu, num_movies=nm, tile_m=16,
                           device="cpu")

    fleet = ServeFleet(engine, broker, replicas=1)
    fleet.seed_store(u, mv, num_users=nu)
    pub = DeltaPublisher(broker, fleet.store)
    prod = StreamProducer(broker)
    prod.send(int(ds.user_map.raw_ids[0]), int(ds.movie_map.raw_ids[1]), 5.0)
    prod.send(int(ds.user_map.raw_ids[3]), int(ds.movie_map.raw_ids[2]), 1.0)
    sess = StreamSession(ds, cfg, broker, CheckpointManager(str(tmp_path)),
                         stream=StreamConfig(batch_records=8),
                         base_model=model, device="cpu")
    attached = engine()
    attached.attach_session(sess)

    def bomb(event):
        raise RuntimeError("replica fell over")

    sess.add_commit_listener(bomb)
    pub.attach(sess)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess.run()
    assert sess.metrics.counters.get("commit_listener_errors", 0) >= 1
    replica = fleet.replicas[0]
    replica.pump()
    assert replica.applied_seq >= 1
    assert table_crc(replica.engine) == table_crc(attached)


# -- the chaos lab's serving scenarios ------------------------------------------


@pytest.mark.parametrize("scenario", [
    "two_stage_fallback", "flaky_broker", "serve_replica_kill",
    "serve_delta_gap", "serve_rollover"])
def test_chaos_lab_serving_scenarios_on_cpu(scenario, capsys):
    """Each serving scenario of the port's chaos lab through
    ``run_scenario``: fired, detected, recovered, and the flight recorder's
    dump names what its ``FLIGHT_EXPECT`` entry says."""
    import json

    from cfk_tpu_torch.scripts import chaos_lab

    assert chaos_lab.main(["--device", "cpu", "--scenario", scenario]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    row = rows[0]
    assert row["scenario"] == scenario
    assert row["fault_fired"] and row["detected"] and row["recovered"]
    assert row["ok"] and row["flight_recorder"]["named_fault"]
    assert rows[-1]["chaos_lab"] == "pass"
    assert len(chaos_lab.SCENARIOS) == 23
