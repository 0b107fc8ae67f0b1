"""The port's TCP transport (``cfk_tpu_torch/transport/tcp.py``) and its own
broker (``cfk_tpu_torch/csrc/host/cfk_broker.cpp``) on the CPU.

The port's client runs the contract of the JAX package's broker tests
against the port's broker (create, produce, consume, end offsets, delete,
list, batching limits, read-your-writes, errors, durability, torn tails,
the connect and read retries).  Across packages: the port's client against
the JAX package's broker and the JAX package's client against the port's
give identical records, the same produce sequence leaves byte-identical
segment files in both brokers' data directories, and each package's
``FileBroker`` reopens the port broker's directory.  The CLI's transport
verbs (``broker``, ``topics``, ``produce``) and ``tcp://`` targets: ``train
--data tcp://…`` prints the same MSE as ``train --data FILE``, and a
``tcp://`` target with no broker is a clean nonzero exit.

Every broker is a subprocess (``BrokerProcess``, with its start-up
timeout); payloads are small.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from cfk_tpu_torch.transport import (
    RATINGS_TOPIC,
    BrokerProcess,
    BrokerRequestError,
    FileBroker,
    IncompleteIngestError,
    collect_ratings,
    produce_ratings_file,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server():
    with BrokerProcess() as bp:
        yield bp


@pytest.fixture(scope="module")
def ratings_file(tmp_path_factory):
    from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo

    coo = synthetic_netflix_coo(120, 40, 1500, seed=5)
    path = tmp_path_factory.mktemp("tcp") / "ratings.txt"
    with open(path, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            for uid, r in zip(coo.user_raw[sel], coo.rating[sel]):
                f.write(f"{uid},{int(r)},2005-09-06\n")
    return str(path), int(coo.num_ratings)


def _fields(out: str) -> dict:
    return dict(kv.split("=", 1) for kv in out.split() if "=" in kv)


# -- the build --------------------------------------------------------------


def test_broker_builds_into_the_build_dir_once_under_concurrency():
    """The broker executable is built from the port's source into
    ``cfk_tpu_torch/_build`` under a name carrying the source's hash; calls
    that race the build all get the same complete file."""
    from cfk_tpu_torch import _build
    from cfk_tpu_torch.transport.tcp import build_broker

    out = _build.broker_binary_path()
    assert out.parent == _build.BUILD_DIR
    assert out.name.startswith("cfk_broker-")
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(build_broker()))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert set(paths) == {str(out)} and os.access(out, os.X_OK)
    assert not list(_build.BUILD_DIR.glob("cfk_broker-*.tmp"))
    src = (_build.CSRC_DIR / "host" / "cfk_broker.cpp").read_text()
    assert "CFK_BROKER LISTENING" in src


# -- the transport contract against the port's broker -------------------------


def test_roundtrip_and_mod_partitioning(server):
    with server.connect() as c:
        c.ping()
        c.create_topic("t-round", 4)
        for k in range(10):
            c.produce("t-round", key=k, value=bytes([k]))
        c.produce("t-round", key=-1, value=b"eof", partition=2)
        assert c.num_partitions("t-round") == 4
        for p in range(4):
            for r in c.consume("t-round", p):
                if r.key >= 0:
                    assert r.key % 4 == p
        assert [r.key for r in c.consume("t-round", 2)] == [2, 6, -1]
        assert [r.value for r in c.consume("t-round", 2)] == [
            bytes([2]), bytes([6]), b"eof"]
        assert c.end_offset("t-round", 2) == 3
        assert [r.key for r in c.consume("t-round", 2, start_offset=2)] == [-1]
        assert "t-round" in c.topics()
        c.delete_topic("t-round")
        assert "t-round" not in c.topics()


def test_read_your_writes_across_batching(server):
    with server.connect(batch_records=10_000) as c:
        c.create_topic("t-ryw", 2)
        for k in range(7):
            c.produce("t-ryw", key=k, value=b"x" * k)
        assert c.end_offset("t-ryw", 0) == 4  # 0, 2, 4, 6
        assert [len(r.value) for r in c.consume("t-ryw", 1)] == [1, 3, 5]


def test_two_clients_see_each_other(server):
    with server.connect() as a, server.connect() as b:
        a.create_topic("t-xc", 1)
        a.produce("t-xc", key=1, value=b"from-a")
        a.flush()
        assert [r.value for r in b.consume("t-xc", 0)] == [b"from-a"]


def test_errors(server):
    with server.connect() as c:
        with pytest.raises(KeyError):
            c.num_partitions("no-such-topic")
        with pytest.raises(KeyError):
            list(c.consume("no-such-topic", 0))
        c.create_topic("t-err", 2)
        with pytest.raises(ValueError):
            c.create_topic("t-err", 2)
        with pytest.raises(ValueError):
            c.produce("t-err", key=-1, value=b"")
        with pytest.raises(BrokerRequestError):
            c.end_offset("t-err", 99)
        with pytest.raises(ValueError):
            c.create_topic("t-zero", 0)
        with pytest.raises(ValueError, match="too long"):
            c.create_topic("x" * 250, 1)


def test_large_values_cross_fetch_batches(server):
    with server.connect(fetch_records=3, fetch_bytes=1 << 14) as c:
        c.create_topic("t-big", 1)
        values = [os.urandom(4000) for _ in range(10)]
        for i, v in enumerate(values):
            c.produce("t-big", key=i, value=v, partition=0)
        got = list(c.consume("t-big", 0))
        assert [r.value for r in got] == values
        assert [r.offset for r in got] == list(range(10))


def test_ingest_eof_barrier_over_tcp(server, ratings_file):
    path, n_file = ratings_file
    with server.connect() as c:
        c.create_topic("ratings-eof", 4)
        n = produce_ratings_file(c, path, topic="ratings-eof")
        coo = collect_ratings(c, topic="ratings-eof")
        assert coo.num_ratings == n == n_file
        c.create_topic("ratings-fault", 4)
        produce_ratings_file(c, path, topic="ratings-fault",
                             drop_eof_for={1, 3})
        with pytest.raises(IncompleteIngestError, match=r"\[1, 3\]"):
            collect_ratings(c, topic="ratings-fault")


def test_durability_across_restart(tmp_path):
    data_dir = str(tmp_path / "broker-data")
    with BrokerProcess(data_dir=data_dir) as bp:
        with bp.connect() as c:
            c.create_topic("t-dur", 2)
            for k in range(6):
                c.produce("t-dur", key=k, value=f"v{k}".encode())
    with BrokerProcess(data_dir=data_dir) as bp2:
        with bp2.connect() as c:
            assert c.num_partitions("t-dur") == 2
            assert [(r.key, r.value) for r in c.consume("t-dur", 0)] == [
                (0, b"v0"), (2, b"v2"), (4, b"v4")]
            c.produce("t-dur", key=6, value=b"v6")
            assert [r.key for r in c.consume("t-dur", 0)] == [0, 2, 4, 6]


def test_torn_tail_recovery(tmp_path):
    data_dir = str(tmp_path / "torn")
    with BrokerProcess(data_dir=data_dir) as bp:
        with bp.connect() as c:
            c.create_topic("t-torn", 1)
            c.produce("t-torn", key=1, value=b"aaaa", partition=0)
            c.produce("t-torn", key=2, value=b"bbbb", partition=0)
    log = os.path.join(data_dir, "t-torn", "p00000.log")
    with open(log, "r+b") as f:  # a crash mid-append: chop the last frame
        f.truncate(os.path.getsize(log) - 3)
    with BrokerProcess(data_dir=data_dir) as bp2:
        with bp2.connect() as c:
            assert [r.key for r in c.consume("t-torn", 0)] == [1]
            c.produce("t-torn", key=3, value=b"cccc", partition=0)
            assert [r.key for r in c.consume("t-torn", 0)] == [1, 3]


def test_consume_snapshots_log_end(server):
    with server.connect(fetch_records=2) as a, server.connect() as b:
        a.create_topic("t-snap", 1)
        for k in range(6):
            a.produce("t-snap", key=k, value=b"v", partition=0)
        a.flush()
        seen = []
        for r in a.consume("t-snap", 0):
            seen.append(r.key)
            if len(seen) == 2:  # an append from another client mid-iteration
                b.produce("t-snap", key=99, value=b"late", partition=0)
                b.flush()
        assert seen == [0, 1, 2, 3, 4, 5]
        assert [r.key for r in a.consume("t-snap", 0, start_offset=6)] == [99]


def test_flush_is_retriable_after_unknown_topic(server):
    with server.connect() as c:
        c.create_topic("t-keep", 1)
        c.produce("t-later", key=1, value=b"a", partition=0)
        c.produce("t-keep", key=2, value=b"b", partition=0)
        with pytest.raises(KeyError):
            c.flush()
        c.create_topic("t-later", 1)
        c.flush()
        assert [r.key for r in c.consume("t-keep", 0)] == [2]
        assert [r.key for r in c.consume("t-later", 0)] == [1]


def test_rejected_batch_appends_nothing(server):
    with server.connect() as c:
        c.create_topic("t-atomic", 2)
        c.produce("t-atomic", key=1, value=b"ok")
        c.produce("t-atomic", key=2, value=b"bad", partition=7)
        with pytest.raises(BrokerRequestError, match="out of range"):
            c.flush()
        with server.connect() as c2:
            assert c2.end_offset("t-atomic", 0) == 0
            assert c2.end_offset("t-atomic", 1) == 0


def test_delete_topic_releases_pending_counters(server):
    with server.connect(batch_records=50) as c:
        c.create_topic("counters-a", 2)
        c.create_topic("counters-b", 2)
        for i in range(40):
            c.produce("counters-a", i, b"v")
        c.delete_topic("counters-a")
        assert c._pending_count == 0 and c._pending_bytes == 0
        for i in range(40):
            c.produce("counters-b", i, b"w")
        assert c._pending_count == 40
        c.delete_topic("counters-b")


def test_oversized_record_rejected_on_client(server):
    from cfk_tpu_torch.transport.tcp import _MAX_BATCH_BYTES

    with server.connect() as c:
        c.create_topic("oversize", 1)
        with pytest.raises(ValueError, match="frame budget"):
            c.produce("oversize", 0, b"x" * (_MAX_BATCH_BYTES + 1))
        c.delete_topic("oversize")


def test_flush_splits_batches_under_frame_cap(server, monkeypatch):
    import cfk_tpu_torch.transport.tcp as tcp_mod

    monkeypatch.setattr(tcp_mod, "_MAX_BATCH_BYTES", 4096)
    sent = []
    with server.connect(batch_records=10_000, batch_bytes=1 << 30) as c:
        inner = c._request

        def spy(body):
            sent.append(len(body))
            return inner(body)

        c._request = spy
        c.create_topic("split", 2)
        for i in range(20):  # ~30 KiB buffered, far over the 4 KiB cap
            c.produce("split", i, b"p" * 1500)
        c.flush()
        assert sum(1 for _ in c.consume("split", 0)) \
            + sum(1 for _ in c.consume("split", 1)) == 20
        c.delete_topic("split")
    produce_frames = [n for n in sent if n > 1000]
    assert len(produce_frames) >= 7 and max(produce_frames) <= 4096 + 300


def test_exit_does_not_mask_body_exception(server):
    with pytest.raises(RuntimeError, match="the real error"):
        with server.connect() as c:
            c.create_topic("mask", 1)
            c.produce("nonexistent-topic", 0, b"v")  # would KeyError on flush
            raise RuntimeError("the real error")
    with server.connect() as c:
        c.delete_topic("mask")


def test_shared_client_across_threads(server):
    """One client shared by threads (a fleet's replicas) keeps its frames
    whole: every thread reads back exactly what it wrote."""
    with server.connect() as c:
        c.create_topic("t-threads", 4)
        errors = []

        def work(p):
            try:
                for i in range(50):
                    c.produce("t-threads", key=i, value=bytes([p, i]),
                              partition=p)
                    assert c.end_offset("t-threads", p) == i + 1
                got = [r.value for r in c.consume("t-threads", p)]
                assert got == [bytes([p, i]) for i in range(50)]
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(p,)) for p in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        c.delete_topic("t-threads")


# -- the byte-level faults ------------------------------------------------------


def test_connect_retry_survives_dropped_connections(server):
    from cfk_tpu_torch.resilience.faults import FlakyBrokerProxy, FlakyPlan
    from cfk_tpu_torch.transport.tcp import TcpBrokerClient

    with FlakyBrokerProxy(server.port,
                          FlakyPlan(drop_first_connects=2)) as proxy:
        with TcpBrokerClient("127.0.0.1", proxy.port, connect_retries=4,
                             retry_base=0.01) as c:
            c.create_topic("t-flaky", 2)
            c.produce("t-flaky", key=0, value=b"survived")
            assert [r.value for r in c.consume("t-flaky", 0)] == [b"survived"]
            c.delete_topic("t-flaky")
        assert proxy.dropped == 2


def test_delayed_frames_waited_out_by_read_retries(server):
    from cfk_tpu_torch.resilience.faults import FlakyBrokerProxy, FlakyPlan
    from cfk_tpu_torch.transport.tcp import TcpBrokerClient

    with FlakyBrokerProxy(server.port, FlakyPlan(delay_frames=3,
                                                 frame_delay=0.12)) as proxy:
        with TcpBrokerClient("127.0.0.1", proxy.port, read_timeout=0.05,
                             read_retries=20) as c:
            c.ping()
            c.create_topic("t-slow", 1)
            values = [bytes([i]) * 32 for i in range(16)]
            for i, v in enumerate(values):
                c.produce("t-slow", key=i, value=v)
            assert [r.value for r in c.consume("t-slow", 0)] == values
            c.delete_topic("t-slow")
        assert proxy.delayed >= 1


def test_connect_gives_up_after_bounded_retries():
    import socket

    from cfk_tpu_torch.transport.tcp import TcpBrokerClient

    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    with pytest.raises(OSError, match="after 2 attempts"):
        TcpBrokerClient("127.0.0.1", port, connect_retries=1, retry_base=0.01)


# -- across the two packages ----------------------------------------------------


def _jax_broker(**kw):
    from cfk_tpu.transport.tcp import BrokerProcess as JBrokerProcess
    from cfk_tpu.transport.tcp import build_broker as j_build

    if not j_build():
        pytest.skip("the JAX package's broker binary does not build here")
    return JBrokerProcess(**kw)


def _produce_sequence(client):
    client.create_topic("wire", 3)
    client.create_topic("wire-b", 1)
    for k in range(40):
        client.produce("wire", key=k, value=bytes([k % 256]) * (k + 1))
    client.produce("wire", key=-1, value=b"eof", partition=1)
    for k in range(5):
        client.produce("wire-b", key=7 * k, value=b"b" * k,
                       partition=0)
    client.flush()


def _read_all(client):
    return {t: [[(r.key, r.value, r.offset) for r in client.consume(t, p)]
                for p in range(client.num_partitions(t))]
            for t in sorted(client.topics())}


@pytest.mark.parametrize("direction", ["port_client_jax_broker",
                                       "jax_client_port_broker"])
def test_cross_wire_identical_records(direction):
    """Either package's client against the other package's broker gives the
    records the same client reads from its own package's broker."""
    from cfk_tpu.transport.tcp import TcpBrokerClient as JClient
    from cfk_tpu_torch.transport.tcp import TcpBrokerClient as TClient

    if direction == "port_client_jax_broker":
        other, same = _jax_broker(), BrokerProcess()
        client = TClient
    else:
        other, same = BrokerProcess(), _jax_broker()
        client = JClient
    got = {}
    with other, same:
        for name, bp in (("other", other), ("same", same)):
            with client("127.0.0.1", bp.port) as c:
                _produce_sequence(c)
                got[name] = _read_all(c)
                assert c.end_offset("wire", 1) == len(got[name]["wire"][1])
    assert got["other"] == got["same"]
    assert sum(len(p) for p in got["same"]["wire"]) == 41


def test_segment_files_byte_identical_to_jax_broker(tmp_path):
    """The same produce sequence through each package's broker with a data
    directory leaves byte-identical files (meta.json and every segment)."""
    from cfk_tpu_torch.transport.tcp import TcpBrokerClient

    dirs = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    for name, bp in (("port", BrokerProcess(data_dir=str(dirs["port"]))),
                     ("jax", _jax_broker(data_dir=str(dirs["jax"])))):
        with bp, TcpBrokerClient("127.0.0.1", bp.port) as c:
            _produce_sequence(c)

    def tree(root):
        return {str(p.relative_to(root)): p.read_bytes()
                for p in sorted(root.rglob("*")) if p.is_file()}

    port, jax = tree(dirs["port"]), tree(dirs["jax"])
    assert sorted(port) == sorted(jax)
    assert any(k.endswith(".log") for k in port)
    assert port == jax


def test_filebrokers_reopen_the_port_brokers_directory(tmp_path,
                                                       ratings_file):
    """The port broker's data directory opens as the port's FileBroker and
    as the JAX package's (the ingest barrier passes on both); the port's
    broker reopens a FileBroker directory."""
    from cfk_tpu.transport.filelog import FileBroker as JFileBroker

    path, n = ratings_file
    data_dir = str(tmp_path / "shared")
    with BrokerProcess(data_dir=data_dir) as bp:
        with bp.connect() as c:
            c.create_topic(RATINGS_TOPIC, 4)
            produce_ratings_file(c, path)
            want = collect_ratings(c)
    for fb in (FileBroker(data_dir), JFileBroker(data_dir)):
        with fb:
            coo = collect_ratings(fb)
            assert coo.num_ratings == n
            assert np.array_equal(coo.rating, want.rating)
            assert np.array_equal(coo.user_raw, want.user_raw)
    other = str(tmp_path / "from_filebroker")
    with FileBroker(other, fsync=False) as fb:
        fb.create_topic("t-interop", 3)
        for k in range(9):
            fb.produce("t-interop", key=k, value=bytes([100 + k]))
    with BrokerProcess(data_dir=other) as bp:
        with bp.connect() as c:
            assert c.num_partitions("t-interop") == 3
            assert [(r.key, r.value) for r in c.consume("t-interop", 1)] == [
                (1, bytes([101])), (4, bytes([104])), (7, bytes([107]))]


# -- the CLI ----------------------------------------------------------------


def test_bad_broker_urls():
    from cfk_tpu.cli import _parse_tcp_url as j_parse
    from cfk_tpu_torch.cli import _parse_tcp_url

    for bad in ("localhost:29092", "tcp://:12", "tcp://h:", "tcp://h:abc"):
        with pytest.raises(ValueError, match="expected tcp://"):
            _parse_tcp_url(bad)
    for url, opt in (("tcp://h:1/topic", False), ("tcp://h:1", False),
                     ("tcp://h:1", True), ("tcp://a.b:29092/x/y", False)):
        assert _parse_tcp_url(url, opt) == j_parse(url, opt)


def test_cli_produce_then_train_from_broker(server, ratings_file, capsys):
    """``produce`` then ``train --data tcp://…``: the same MSE as ``train
    --data FILE``; an un-flagged re-produce into the topic is refused."""
    from cfk_tpu_torch.cli import main

    path, n = ratings_file
    url = f"tcp://127.0.0.1:{server.port}/ratings-cli"
    assert main(["produce", "--broker", url, "--data", path,
                 "--partitions", "4"]) == 0
    assert f"produced {n} ratings" in capsys.readouterr().err
    train = ["--rank", "4", "--iterations", "3", "--seed", "0",
             "--output", "none", "--device", "cpu"]
    assert main(["train", "--data", url, *train]) == 0
    from_broker = _fields(capsys.readouterr().out)
    assert main(["train", "--data", path, *train]) == 0
    from_file = _fields(capsys.readouterr().out)
    assert from_broker["mse"] == from_file["mse"]
    assert from_broker["num_ratings"] == str(n)
    assert main(["produce", "--broker", url, "--data", path]) == 1
    assert "already exists" in capsys.readouterr().err


def test_cli_multi_file_produce_with_no_eof(server, ratings_file, capsys):
    from cfk_tpu_torch.cli import main

    path, n = ratings_file
    url = f"tcp://127.0.0.1:{server.port}/ratings-multi"
    assert main(["produce", "--broker", url, "--data", path,
                 "--partitions", "2", "--no-eof"]) == 0
    assert "open (no EOF yet)" in capsys.readouterr().err
    with server.connect() as c:
        with pytest.raises(IncompleteIngestError):
            collect_ratings(c, topic="ratings-multi")
    assert main(["produce", "--broker", url, "--data", path,
                 "--append"]) == 0
    with server.connect() as c:
        assert collect_ratings(c, topic="ratings-multi").num_ratings == 2 * n


def test_cli_tcp_dataset_cache(ratings_file, capsys, tmp_path):
    """A ``tcp://`` source's cache key holds the topic's end offsets: the
    same log hits, another log at the same URL rebuilds; with the broker
    down a matching cache still trains (with a warning) and a mismatched
    one is a clean error."""
    from cfk_tpu_torch.cli import main

    path, _ = ratings_file
    cache = str(tmp_path / "dscache")
    with BrokerProcess() as bp:
        url = f"tcp://127.0.0.1:{bp.port}/ratings-cache"
        train = ["train", "--data", url, "--rank", "3", "--iterations", "1",
                 "--seed", "0", "--dataset-cache", cache, "--output", "none",
                 "--device", "cpu"]
        assert main(["produce", "--broker", url, "--data", path,
                     "--partitions", "2"]) == 0
        assert main(train) == 0
        capsys.readouterr()
        assert main(train) == 0
        assert "# dataset cache hit" in capsys.readouterr().err
        with bp.connect() as c:
            c.delete_topic("ratings-cache")
        assert main(["produce", "--broker", url, "--data", path,
                     "--partitions", "4"]) == 0
        capsys.readouterr()
        assert main(train) == 0
        assert "ignoring dataset cache" in capsys.readouterr().err
    assert main(train) == 0  # the broker is gone: the cache serves
    assert "broker unreachable" in capsys.readouterr().err
    assert main(train + ["--layout", "segment"]) == 1
    assert "error:" in capsys.readouterr().err


def test_cli_topics_admin(server, capsys):
    from cfk_tpu_torch.cli import main

    base = f"tcp://127.0.0.1:{server.port}"
    assert main(["topics", "create", "--broker", f"{base}/adm",
                 "--partitions", "3"]) == 0
    assert main(["topics", "list", "--broker", base]) == 0
    assert "adm\tpartitions=3\tp0=0\tp1=0\tp2=0" in capsys.readouterr().out
    assert main(["topics", "recreate", "--broker", f"{base}/adm",
                 "--partitions", "5"]) == 0
    assert main(["topics", "list", "--broker", base]) == 0
    assert "adm\tpartitions=5" in capsys.readouterr().out
    assert main(["topics", "delete", "--broker", f"{base}/adm"]) == 0
    assert main(["topics", "list", "--broker", base]) == 0
    assert "adm\t" not in capsys.readouterr().out
    assert main(["topics", "create", "--broker", base]) == 1


def test_cli_broker_verb_serves_a_data_dir(tmp_path):
    """``python -m cfk_tpu_torch broker --port 0 --data-dir D`` prints its
    port, serves clients, and its directory reopens as a FileBroker."""
    from cfk_tpu_torch.transport.tcp import TcpBrokerClient

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data_dir = tmp_path / "verb"
    p = subprocess.Popen([sys.executable, "-m", "cfk_tpu_torch", "broker",
                          "--port", "0", "--data-dir", str(data_dir)],
                         cwd=root, stdout=subprocess.PIPE, text=True)
    try:
        line = p.stdout.readline()
        assert "CFK_BROKER LISTENING" in line, line
        port = int(line.split()[-1])
        with TcpBrokerClient("127.0.0.1", port) as c:
            c.create_topic("verb", 1)
            c.produce("verb", key=3, value=b"kept")
    finally:
        p.terminate()
        p.wait(timeout=10)
    with FileBroker(str(data_dir)) as fb:
        assert [r.value for r in fb.consume("verb", 0)] == [b"kept"]


def test_cli_tcp_targets_with_no_broker_exit_nonzero(ratings_file, tmp_path,
                                                     capsys):
    """Every ``tcp://`` target with nothing listening is a clean error with
    the reference's exit code; nothing falls back to a file broker."""
    from cfk_tpu_torch.cli import main

    path, _ = ratings_file
    dead = "tcp://127.0.0.1:1"
    cases = [
        (["train", "--data", dead + "/ratings", "--device", "cpu"], 1),
        (["train", "--data", path, "--checkpoint-journal", dead,
          "--device", "cpu", "--output", "none"], 2),
        (["stream", "--data", path, "--updates", dead, "--stream-dir",
          str(tmp_path / "sd"), "--device", "cpu"], 2),
        (["serve", "--broker", dead, "--checkpoint-dir",
          str(tmp_path / "none"), "--data", path, "--device", "cpu"], 1),
        (["topics", "list", "--broker", dead], 1),
        (["produce", "--broker", dead + "/r", "--data", path], 1),
    ]
    for argv, rc in cases:
        assert main(argv) == rc, argv
        assert "connect to broker 127.0.0.1:1" in capsys.readouterr().err
    assert not (tmp_path / "sd").exists()
