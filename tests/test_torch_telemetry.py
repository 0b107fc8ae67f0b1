"""The port's telemetry (``cfk_tpu_torch.telemetry``, ``utils.metrics.
maybe_profile``, the CLI's telemetry flags) against ``cfk_tpu.telemetry``,
on the CPU.

Both packages' telemetry is pure Python: on the same inputs the Prometheus
text, the span-tree validation, the staging-overlap recomputation and the
flight-recorder dump agree exactly (timestamps, thread names and process
ids aside).  The span and event names the port's ``train`` and ``serve``
emit are names the reference emits at the same places (read from its
sources).  Then the CLI: ``train --profile-dir --trace-dir --metrics-jsonl
--metrics json`` and ``serve --trace-dir --metrics-port`` on ``--device
cpu`` write what they promise, and ``maybe_profile`` writes a trace.
"""

import glob
import json
import os
import re
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from cfk_tpu import telemetry as jtel
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu_torch import telemetry as ttel
from cfk_tpu_torch.cli import main
from cfk_tpu_torch.utils.metrics import maybe_profile

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One PyTorch intra-op thread for these small products: the suite runs
    files in parallel workers, where each worker's spinning thread pool,
    oversubscribed across them, slowed this file a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(metrics):
    """The same registry contents in either package's registry."""
    metrics.incr("serve_requests", 7)
    metrics.incr("serve/two_stage_fallbacks")
    metrics.gauge("serve/bytes_scanned_per_batch", 1.5e6)
    metrics.gauge("mse", 0.25)
    metrics.gauge("provenance", "not a number")
    metrics.note("pipeline_route", "captured")
    metrics.phases["train"] += 1.25
    for v in (3.0, 1.0, 2.0, 10.0, 0.5):
        metrics.observe("serve_batch_ms", v)
    metrics.histogram("empty_hist")
    return metrics


def test_prometheus_text_matches_reference():
    got = ttel.prometheus_text(_fill(ttel.Metrics()))
    want = jtel.prometheus_text(_fill(jtel.Metrics()))
    assert got == want
    labelled = dict(labels={"process": 3, "host": 'a"b'})
    assert ttel.prometheus_text(_fill(ttel.Metrics()), **labelled) == \
        jtel.prometheus_text(_fill(jtel.Metrics()), **labelled)
    assert "cfk_serve_requests_total 7" in got
    for name in ("a-b.c", "9x", "ok_name"):
        assert ttel.sanitize_metric_name(name) == \
            jtel.sanitize_metric_name(name)


def _events():
    ev = [
        {"name": "train/fused_loop", "ph": "X", "ts": 0, "dur": 100,
         "tid": 1, "pid": 9, "args": {}},
        {"name": "serve/batch", "ph": "X", "ts": 10, "dur": 20, "tid": 1,
         "pid": 9, "args": {}},
        {"name": "serve/batch/compute", "ph": "X", "ts": 12, "dur": 5,
         "tid": 1, "pid": 9, "args": {}},
        {"name": "x/window_stage", "ph": "X", "ts": 0, "dur": 40, "tid": 2,
         "pid": 9, "args": {}},
        {"name": "x/window_wait", "ph": "X", "ts": 50, "dur": 10, "tid": 2,
         "pid": 9, "args": {}},
        {"name": "marker", "ph": "i", "ts": 3, "tid": 1, "pid": 9,
         "args": {}},
    ]
    torn = ev + [{"name": "torn", "ph": "X", "ts": 90, "dur": 30, "tid": 1,
                  "pid": 9, "args": {}}]
    return ev, torn


def test_span_tree_and_stage_overlap_match_reference():
    ev, torn = _events()
    assert ttel.validate_span_tree(ev) == jtel.validate_span_tree(ev)
    with pytest.raises(ValueError) as got:
        ttel.validate_span_tree(torn)
    with pytest.raises(ValueError) as want:
        jtel.validate_span_tree(torn)
    assert str(got.value) == str(want.value)
    assert ttel.stage_overlap_from_events(ev) == \
        jtel.stage_overlap_from_events(ev) == 0.75
    assert ttel.stage_overlap_from_events(ev[:3]) is None


def _dump(module, path):
    rec = module.FlightRecorder(capacity=3)
    for i in range(5):
        rec.record("train", "fused_loop_done", iters=i, route="captured")
    rec.record("checkpoint", "checkpoint_committed", iteration=2)
    out = rec.dump("corrupt_checkpoint", path=str(path))
    return json.loads(Path(out).read_text())


def test_flight_recorder_dump_format_matches_reference(tmp_path):
    got = _dump(ttel, tmp_path / "port.json")
    want = _dump(jtel, tmp_path / "ref.json")

    def shape(d):
        return {k: v for k, v in d.items() if k not in ("pid",
                                                        "dumped_at_unix")}

    def event(e):
        return {k: v for k, v in e.items() if k not in ("t", "thread")}

    assert set(got) == set(want)
    assert got["num_events"] == want["num_events"] == 3
    assert [event(e) for e in got["events"]] == \
        [event(e) for e in want["events"]]
    assert shape(got)["reason"] == shape(want)["reason"]
    assert ttel.FlightRecorder().dump("no dir configured") is None


def _reference_names(*relpaths):
    """Every span / event name literal in the reference's sources."""
    text = "".join((ROOT / p).read_text() for p in relpaths)
    spans = set(re.findall(r'span\(\s*"([^"]+)"', text))
    events = set(re.findall(r'record_event\(\s*"[^"]+",\s*"([^"]+)"', text))
    return spans, events


@pytest.fixture(scope="module")
def ratings_file(tmp_path_factory):
    coo = synthetic_netflix_coo(120, 40, 1200, seed=2)
    path = tmp_path_factory.mktemp("telemetry_cli") / "ratings.txt"
    with open(path, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            for u, r in zip(coo.user_raw[sel], coo.rating[sel]):
                f.write(f"{u},{int(r)},2005-01-01\n")
    return str(path)


@pytest.fixture
def recorder_restored():
    """The CLI points the process flight recorder at its trace directory;
    put it back so later tests find no stale dump directory."""
    rec = ttel.get_recorder()
    before = rec.dump_dir
    yield
    rec.configure(dump_dir=before)


def _host_trace(d):
    (path,) = glob.glob(os.path.join(d, "cfk_host_trace_*.json"))
    return json.loads(Path(path).read_text())["traceEvents"]


def test_train_telemetry_flags_write_their_files(ratings_file, tmp_path,
                                                 capsys, recorder_restored):
    """``train --profile-dir D --trace-dir D --metrics-jsonl F --metrics
    json`` on the CPU: a torch.profiler Chrome trace and a host span trace
    that parse, a span tree ``validate_span_tree`` accepts with the
    reference's ``train/fused_loop`` span, JSONL lines that parse, and the
    registry as the exit row."""
    d, jsonl = tmp_path / "trace", tmp_path / "m" / "metrics.jsonl"
    rc = main(["train", "--data", ratings_file, "--rank", "4",
               "--iterations", "2", "--layout", "tiled", "--chunk-elems",
               "256", "--device", "cpu", "--output", "none",
               "--profile-dir", str(d), "--trace-dir", str(d),
               "--metrics-jsonl", str(jsonl), "--metrics-interval-s",
               "0.05", "--metrics", "json"])
    out = capsys.readouterr().out
    assert rc == 0
    row = json.loads(out.strip().splitlines()[-1])
    assert row["counters"]["iterations"] == 2
    assert row["notes"]["pipeline_route"].startswith("prefetched")
    assert {"prep", "train", "eval_mse"} <= set(row["phase_seconds"])
    (device,) = glob.glob(str(d / "cfk_device_trace_*.json"))
    assert json.loads(Path(device).read_text())["traceEvents"]
    events = _host_trace(str(d))
    counts = ttel.validate_span_tree(events)
    assert sum(counts.values()) >= 1
    spans = {e["name"] for e in events if e.get("ph") == "X"}
    ref_spans, _ = _reference_names("cfk_tpu/models/als.py",
                                    "cfk_tpu/models/ials.py")
    assert spans == {"train/fused_loop"} <= ref_spans
    lines = [json.loads(x) for x in jsonl.read_text().splitlines()]
    assert lines and lines[-1]["counters"]["iterations"] == 2
    names = {e["name"] for e in ttel.get_recorder().events()}
    _, ref_events = _reference_names("cfk_tpu/models/als.py")
    assert "fused_loop_done" in names and "fused_loop_done" in ref_events
    # the logfmt row (the default) keeps its key=value form
    assert main(["train", "--data", ratings_file, "--rank", "4",
                 "--iterations", "1", "--device", "cpu", "--output", "none",
                 "--no-overlap"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("layout=padded ") and "s_per_iter=" in last


@pytest.mark.parametrize("mode", ["exact", "two_stage"])
def test_serve_spans_and_metrics_endpoint(ratings_file, tmp_path, capsys,
                                          monkeypatch, recorder_restored,
                                          mode):
    """``serve --trace-dir --metrics-port 0`` on the CPU: ``GET /metrics``
    answers Prometheus text while the server runs, the host trace holds
    the reference's serve spans at their places, the ``batch`` events are
    recorded, and the checkpoint commit is flight-recorded."""
    from cfk_tpu_torch.serving import server as server_mod

    ck = tmp_path / "ck"
    assert main(["train", "--data", ratings_file, "--rank", "4",
                 "--iterations", "2", "--device", "cpu", "--output", "none",
                 "--checkpoint-dir", str(ck)]) == 0
    names = {e["name"] for e in ttel.get_recorder().events()}
    assert "checkpoint_committed" in names
    scraped = []
    close = server_mod.RecommendServer.close

    def scrape_then_close(self):
        if self.metrics_server is not None:
            with urllib.request.urlopen(self.metrics_server.url,
                                        timeout=10) as r:
                scraped.append((r.status, r.headers["Content-Type"],
                                r.read().decode()))
        close(self)

    monkeypatch.setattr(server_mod.RecommendServer, "close",
                        scrape_then_close)
    d = tmp_path / "serve_trace"
    capsys.readouterr()
    argv = ["serve", "--checkpoint-dir", str(ck), "--data", ratings_file,
            "-k", "5", "--tile-m", "16", "--loadgen-qps", "400",
            "--loadgen-requests", "32", "--max-batch", "16", "--device",
            "cpu", "--trace-dir", str(d), "--metrics-port", "0",
            "--serve-mode", mode]
    if mode == "two_stage":
        argv += ["--clusters", "4", "--probe-clusters", "2"]
    assert main(argv) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["answered"] == row["requests"] == 32
    ((status, ctype, body),) = scraped
    assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
    assert "# TYPE cfk_serve_requests_total counter" in body
    assert "cfk_serve_batch_ms_count" in body
    events = _host_trace(str(d))
    ttel.validate_span_tree(events)
    spans = {e["name"] for e in events if e.get("ph") == "X"}
    ref_spans, ref_events = _reference_names(
        "cfk_tpu/serving/engine.py", "cfk_tpu/serving/server.py")
    want = {"serve/prewarm", "serve/batch", "serve/batch/validate",
            "serve/batch/assemble", "serve/batch/respond"}
    want |= ({"serve/candidate", "serve/rescore"} if mode == "two_stage"
             else {"serve/batch/compute"})
    assert want <= spans <= ref_spans
    names = {e["name"] for e in ttel.get_recorder().events()}
    assert "batch" in names and "batch" in ref_events


def test_two_stage_fault_is_recorded_and_dumped(tmp_path, recorder_restored):
    """A two-stage fault records the reference's ``two_stage_fault`` event
    and dumps the flight recorder."""
    import torch

    from cfk_tpu_torch.serving.engine import ServeEngine

    rng = np.random.default_rng(0)
    engine = ServeEngine(rng.standard_normal((20, 4)).astype(np.float32),
                         rng.standard_normal((50, 4)).astype(np.float32),
                         num_users=20, num_movies=50, tile_m=16,
                         serve_mode="two_stage", clusters=4,
                         probe_clusters=2, device=torch.device("cpu"))
    ttel.get_recorder().configure(dump_dir=str(tmp_path))
    engine._two_stage_fault("index checksum mismatch")
    last = ttel.get_recorder().events()[-1]
    assert last["name"] == "two_stage_fault"
    assert last["reason"] == "index checksum mismatch"
    (dump,) = glob.glob(str(tmp_path / "cfk_flight_*two_stage_fallback*"))
    assert json.loads(Path(dump).read_text())["events"][-1]["name"] == \
        "two_stage_fault"
    _, ref_events = _reference_names("cfk_tpu/serving/engine.py")
    assert "two_stage_fault" in ref_events


def test_corrupt_checkpoint_skipped_is_recorded(tmp_path, recorder_restored):
    from cfk_tpu_torch.transport.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, np.ones((3, 2), np.float32), np.ones((4, 2), np.float32))
    mgr.save(2, np.ones((3, 2), np.float32), np.ones((4, 2), np.float32))
    with open(tmp_path / "ck" / "step_0000002" / "user.npy", "r+b") as f:
        f.seek(-1, 2)
        f.write(b"\x01")
    ttel.get_recorder().configure(dump_dir=str(tmp_path / "dumps"))
    with pytest.warns(UserWarning, match="skipping corrupt checkpoint"):
        assert mgr.latest_valid_iteration() == 1
    ev = [e for e in ttel.get_recorder().events()
          if e["name"] == "corrupt_checkpoint_skipped"]
    assert ev and ev[-1]["iteration"] == 2
    assert glob.glob(str(tmp_path / "dumps" / "*corrupt_checkpoint*"))
    _, ref_events = _reference_names("cfk_tpu/transport/checkpoint.py")
    assert {"checkpoint_committed", "corrupt_checkpoint_skipped"} <= \
        ref_events


def test_maybe_profile_writes_a_trace_on_the_cpu(tmp_path):
    import torch

    with maybe_profile(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = glob.glob(str(tmp_path / "cfk_device_trace_*.json"))
    events = json.loads(Path(path).read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with maybe_profile(None):
        pass


def test_telemetry_off_is_the_null_span():
    assert ttel.get_tracer() is None
    assert ttel.span("train/fused_loop") is ttel.span("serve/batch")
    assert ttel.begin_span("x") is None
    ttel.end_span(None)
    ttel.instant("x")


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import cfk_tpu_torch.telemetry, cfk_tpu_torch.utils.metrics\n"
            "import cfk_tpu_torch.ops.pipeline, cfk_tpu_torch.cli\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'cfk_tpu.')) or m == 'cfk_tpu']\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
