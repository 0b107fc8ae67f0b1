"""Chaos lab of the port: inject each single-process fault class into a
small deterministic training or streaming run and report the outcome — the
port of ``scripts/chaos_lab.py``'s ``nan``, ``inf``, ``singular_chunk``,
``torn_checkpoint``, ``preemption``, ``slow_disk``, ``telemetry_overhead``,
``quantized_table``, ``stream_duplicates``, ``stream_crash_replay``,
``stream_poison_batch``, ``serve_under_foldin``, ``two_stage_fallback``,
``flaky_broker``, ``serve_replica_kill``, ``serve_delta_gap``,
``serve_rollover`` and ``worker_kill`` scenarios.  Run::

    python -m cfk_tpu_torch.scripts.chaos_lab --device cpu
    python -m cfk_tpu_torch.scripts.chaos_lab --device cuda \\
        --layout tiled bucketed segment
    python -m cfk_tpu_torch.scripts.chaos_lab --scenario nan preemption

Prints one JSON row per scenario and layout, then a summary row; exits
non-zero if any scenario misses its contract.  Each row records whether
the fault FIRED (a chaos run that injects nothing proves nothing), whether
it was DETECTED (the sentinel, the crc32 manifest, the preemption guard)
and whether the run RECOVERED — the reference's RMSE contract (within 15%
of the fault-free run) and, stronger, the final factors crc-equal to the
fault-free run of the port.  A persistent singular fault cannot end
fault-free: its recovery raises λ from the rollback point on, so that
scenario's factors are held crc-equal to the run that applies the same
rungs at the same iteration with no fault machinery (the fault-free
iterations before the rollback point, the fault's zeroed rows, then λ
bumped).  Every scenario also checks the flight recorder's dump names the
fault.  Datasets: the reference's synthetic 60 × 30 × 900 ratings (seed 0)
and its block-structured fixture for the singular scenario, rank 4,
6 iterations, the sentinel every iteration.

``quantized_table`` drives the recovery ladder through every rung (retry,
λ bump, split epilogue, "gj") on the tiled layout with a bfloat16 gather
table whatever ``--layout`` says; its λ bumps move the factors, so it is
held to the reference's RMSE contract and to the final overrides pinning
both the split and the "gj" rung, not to a crc.  The streaming scenarios
fold a seeded update log into a base model trained on the lab's layout
(rank 4, 4 iterations): delivery faults and a crash replay must end
crc-equal to the clean stream, a poison batch must be quarantined, and a
``ServeEngine`` attached to the session must serve each commit fresh and
never a torn row.  The serving scenarios use their own small factors
whatever ``--layout`` says: a corrupted two-stage index must degrade to
the exact scan bit for bit and recover at the next table swap; the TCP
client must survive dropped connections and delayed frames to the port's
broker; and a replicated fleet (48 users x 64 movies, rank 6) must answer
through a replica kill, resync crc-exact after a lost delta frame, and
roll an epoch over under traffic with no mixed-epoch answer.
``worker_kill`` SIGKILLs one of two ranks of a sharded run (the launch
harness of ``parallel.launch``): the survivor must exit bounded with the
store intact, and a restart must resume crc-equal to an uninterrupted run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings
import zlib

import numpy as np

RMSE_RTOL = 0.15  # the reference's: recovered RMSE within this of fault-free
LAYOUTS = ("padded", "tiled", "bucketed", "segment")
# Build-time chunk budget of the chunked layouts: small enough that the
# 900-rating fixture spans several chunks (and straddles entities).
CHUNK_ELEMS = 256


class Lab:
    """The scenarios on one device and layout."""

    def __init__(self, device: str, layout: str):
        self.device = device
        self.layout = layout

    def dataset(self, singular: bool = False):
        from cfk_tpu_torch.data.blocks import Dataset
        from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
        from cfk_tpu_torch.resilience.faults import blockstructured_coo

        coo = (blockstructured_coo(seed=0) if singular
               else synthetic_netflix_coo(60, 30, 900, seed=0))
        if self.layout == "padded":
            return Dataset.from_coo(coo)
        return Dataset.from_coo(coo, layout=self.layout,
                                chunk_elems=CHUNK_ELEMS,
                                dense_stream=self.layout == "tiled")

    def config(self, **kw):
        from cfk_tpu_torch.config import ALSConfig

        return ALSConfig(rank=4, num_iterations=6, health_check_every=1,
                         layout=self.layout, **kw)

    def train(self, ds, cfg, **kw):
        from cfk_tpu_torch.models.als import train_als

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return train_als(ds, cfg, device=self.device, **kw)

    @staticmethod
    def rmse(model, ds) -> float:
        from cfk_tpu_torch.eval.metrics import mse_rmse_from_model

        return mse_rmse_from_model(model, ds)[1]

    @staticmethod
    def crc(model) -> int:
        u, m = model.host_factors()
        return zlib.crc32(np.ascontiguousarray(u).tobytes()
                          + np.ascontiguousarray(m).tobytes())

    def row(self, name, *, fired, metrics, base, rec, ds, detected=None,
            ok_extra=True, crc=True, layout=None, **extra):
        """The scenario's row; ``crc=False`` holds the recovery to the RMSE
        contract alone (a run whose recovery moves λ cannot end crc-equal
        to the fault-free one)."""
        base_rmse, rec_rmse = self.rmse(base, ds), self.rmse(rec, ds)
        if detected is None:
            detected = metrics.counters.get("health_trips", 0) >= 1
        within = bool(np.isfinite(rec_rmse) and abs(rec_rmse - base_rmse)
                      <= RMSE_RTOL * max(base_rmse, 1e-9))
        crc_equal = self.crc(rec) == self.crc(base)
        crc_ok = crc_equal or not crc
        return {
            "scenario": name, "device": self.device,
            "layout": layout or self.layout,
            "fault_fired": bool(fired), "detected": bool(detected),
            "recovered": bool(within and crc_ok),
            "crc_equal": bool(crc_equal),
            "rollbacks": metrics.counters.get("rollbacks", 0),
            "escalation_level": metrics.gauges.get("escalation_level", 0),
            "fault_free_rmse": float(base_rmse),
            "recovered_rmse": float(rec_rmse),
            "notes": dict(metrics.notes), **extra,
            "ok": bool(fired and detected and within and crc_ok
                       and ok_extra),
        }

    # -- scenarios --------------------------------------------------------

    def corruption(self, name, value, iteration):
        from cfk_tpu_torch.resilience.faults import (
            FactorCorruption,
            FaultInjector,
        )
        from cfk_tpu_torch.telemetry import Metrics

        ds, cfg = self.dataset(), self.config()
        base = self.train(ds, cfg)
        inj = FaultInjector(FactorCorruption(iteration=iteration, side="u",
                                             value=value))
        metrics = Metrics()
        rec = self.train(ds, cfg, metrics=metrics, fault_injector=inj)
        return self.row(name, fired=inj.fired, metrics=metrics, base=base,
                        rec=rec, ds=ds)

    def nan(self):
        return self.corruption("nan", float("nan"), 2)

    def inf(self):
        return self.corruption("inf", float("inf"), 3)

    def singular_chunk(self):
        """λ = 0 and a persistent zeroed slice of the users before
        iteration 2: the ladder's λ bump (rung 2) is the designed fix."""
        import dataclasses

        from cfk_tpu_torch.resilience.faults import (
            FaultInjector,
            SingularChunk,
        )
        from cfk_tpu_torch.telemetry import Metrics

        ds = self.dataset(singular=True)
        cfg = self.config(lam=0.0)
        fault_free = self.train(ds, cfg)
        inj = FaultInjector(SingularChunk(iteration=2, side="u",
                                          rows=(0, 8), persistent=True))
        metrics = Metrics()
        rec = self.train(ds, cfg, metrics=metrics, fault_injector=inj)
        # The run the recovery should equal: two fault-free iterations, the
        # fault's zeroed rows, then the rest at the escalated λ (the floor
        # of a λ = 0 run), from the rollback point.
        head = self.train(ds, dataclasses.replace(cfg, num_iterations=2,
                                                  health_check_every=None))
        u2 = head.user_factors.clone()
        u2[0:8] = 0.0
        lam = float(metrics.notes.get("escalation_2", "lam=1e-4")
                    .split()[0].split("=")[1])
        want = self.train(ds, dataclasses.replace(
            cfg, lam=lam, num_iterations=4, health_check_every=None),
            warm_start=(u2, head.movie_factors))
        level = metrics.gauges.get("escalation_level", 0)
        row = self.row("singular_chunk", fired=inj.fired, metrics=metrics,
                       base=want, rec=rec, ds=ds, ok_extra=level >= 2,
                       escalated_lam=lam)
        # RMSE against the fault-free λ = 0 run, as the reference holds it.
        free = self.rmse(fault_free, ds)
        row["fault_free_rmse"] = float(free)
        within = abs(row["recovered_rmse"] - free) <= RMSE_RTOL * max(free,
                                                                        1e-9)
        row["recovered"] = bool(row["recovered"] and within)
        row["ok"] = bool(row["ok"] and within)
        return row

    def torn_checkpoint(self):
        import tempfile

        from cfk_tpu_torch.resilience.faults import TornCheckpointManager
        from cfk_tpu_torch.telemetry import Metrics
        from cfk_tpu_torch.transport.checkpoint import CheckpointManager

        ds, cfg = self.dataset(), self.config()
        base = self.train(ds, cfg)
        with tempfile.TemporaryDirectory() as d:
            torn = TornCheckpointManager(CheckpointManager(d),
                                         tear_at=cfg.num_iterations)
            self.train(ds, cfg, checkpoint_manager=torn)
            metrics = Metrics()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                from cfk_tpu_torch.models.als import train_als

                rec = train_als(ds, cfg, device=self.device,
                                checkpoint_manager=CheckpointManager(d),
                                metrics=metrics)
            skipped = any("skipping corrupt checkpoint" in str(w.message)
                          for w in caught)
        # Detection here is the crc32 verification, not the sentinel.
        return self.row("torn_checkpoint", fired=bool(torn.torn),
                        metrics=metrics, base=base, rec=rec, ds=ds,
                        detected=skipped)

    def preemption(self):
        """SIGTERM before iteration 3: the guard-armed loop commits step 4,
        drains the writer and returns resumable; the restart completes."""
        import tempfile

        from cfk_tpu_torch.resilience.faults import FaultInjector, PreemptAt
        from cfk_tpu_torch.resilience.preempt import PreemptionGuard
        from cfk_tpu_torch.telemetry import Metrics
        from cfk_tpu_torch.transport.checkpoint import CheckpointManager

        ds, cfg = self.dataset(), self.config()
        base = self.train(ds, cfg)
        with tempfile.TemporaryDirectory() as d:
            inj = FaultInjector(PreemptAt(iteration=3))
            metrics = Metrics()
            with PreemptionGuard() as guard:
                self.train(ds, cfg, checkpoint_manager=CheckpointManager(d),
                           metrics=metrics, fault_injector=inj,
                           preemption_guard=guard)
            evicted = bool(guard.triggered and "preempted" in metrics.notes)
            mgr = CheckpointManager(d)
            committed = mgr.latest_valid_iteration()
            for it in mgr.iterations():
                mgr.verify(it)  # every surviving step intact
            rec = self.train(ds, cfg, checkpoint_manager=CheckpointManager(d))
        return self.row("preemption", fired=inj.fired, metrics=metrics,
                        base=base, rec=rec, ds=ds, detected=evicted,
                        ok_extra=committed == 4,
                        committed_at_eviction=committed)

    def slow_disk(self):
        """Every step write sleeps 150 ms: the async writer absorbs it —
        every step intact after the drain, the factors bit-equal to the
        sync writer's and to the fault-free run, and the loop's checkpoint
        stall well under the sync writer's."""
        import tempfile

        from cfk_tpu_torch.resilience.faults import SlowDiskCheckpointManager
        from cfk_tpu_torch.telemetry import Metrics

        ds, cfg = self.dataset(), self.config()
        base = self.train(ds, cfg)
        delay = 0.15

        def run(async_write, d):
            # max_pending past the run's save count: the loop never waits
            # on the slow disk (the drain runs at loop exit).
            mgr = SlowDiskCheckpointManager(
                d, delay_s=delay, async_write=async_write,
                max_pending=cfg.num_iterations + 2)
            metrics = Metrics()
            model = self.train(ds, cfg, checkpoint_manager=mgr,
                               metrics=metrics)
            return mgr, metrics, model

        with tempfile.TemporaryDirectory() as d1, \
                tempfile.TemporaryDirectory() as d2:
            sync_mgr, sync_metrics, sync_model = run(False, d1)
            async_mgr, async_metrics, async_model = run(True, d2)
            intact = async_mgr.iterations() == sync_mgr.iterations()
            for it in async_mgr.iterations():
                async_mgr.verify(it)
        sync_stall = sync_metrics.phases.get("checkpoint", 0.0)
        async_stall = async_metrics.phases.get("checkpoint", 0.0)
        bit_exact = self.crc(sync_model) == self.crc(async_model)
        fired = (async_mgr.writes >= cfg.num_iterations
                 and sync_stall >= delay * cfg.num_iterations)
        return self.row(
            "slow_disk", fired=fired, metrics=async_metrics, base=base,
            rec=async_model, ds=ds, detected=True,
            ok_extra=bool(intact and bit_exact
                          and async_stall < max(0.5 * sync_stall, 0.2)),
            sync_ckpt_stall_s=sync_stall, async_ckpt_stall_s=async_stall,
            slow_writes=async_mgr.writes, steps_intact=bool(intact),
            sync_async_bit_exact=bool(bit_exact))

    def telemetry_overhead(self):
        """The same run with the span tracer off and on: crc-identical
        factors (spans observe the host only), spans recorded, the train
        span among them; the wall factor is informational."""
        import tempfile
        import time

        from cfk_tpu_torch import telemetry
        from cfk_tpu_torch.telemetry import Metrics

        ds, cfg = self.dataset(), self.config()
        base = self.train(ds, cfg)  # also warms the kernels
        t_off, t_on = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            off = self.train(ds, cfg)
            t_off.append(time.perf_counter() - t0)
        with tempfile.TemporaryDirectory() as td:
            tracer = telemetry.configure(trace_dir=td)
            try:
                for _ in range(3):
                    t0 = time.perf_counter()
                    on = self.train(ds, cfg)
                    t_on.append(time.perf_counter() - t0)
                spans = len(tracer.events())
            finally:
                trace_path = telemetry.shutdown(write=True)
            with open(trace_path) as f:
                trace = json.load(f)
            names = {e["name"] for e in trace["traceEvents"]
                     if e.get("ph") == "X"}
            telemetry.validate_span_tree(trace["traceEvents"])
        identical = self.crc(off) == self.crc(on)
        telemetry.record_event("train", "telemetry_overhead_drill",
                               crc_off=self.crc(off), crc_on=self.crc(on),
                               spans=spans)
        train_spans = bool({"train/fused_loop", "train/iter"} & names)
        return self.row(
            "telemetry_overhead", fired=True, metrics=Metrics(), base=base,
            rec=on, ds=ds, detected=spans > 0,
            ok_extra=bool(identical and train_spans),
            crc_identical=bool(identical), spans_recorded=spans,
            train_spans=train_spans,
            overhead_factor_wall=min(t_on) / max(min(t_off), 1e-9))

    def quantized_table(self):
        """The ladder's split-epilogue and "gj" rungs with a bfloat16
        gather table on the tiled layout: four one-shot NaN corruptions on
        consecutive iterations force retry, λ bump, split epilogue and
        "gj", so the run ends with the split schedule and the "gj" route
        pinned while every half-step gathers from the bf16 table; the
        recovered RMSE within the reference's bound of the fault-free
        run's proves those rungs solve correctly under quantization
        (``lam_escalation=1.5`` keeps the two λ bumps inside that bound, as
        the reference sets it)."""
        from cfk_tpu_torch.config import ALSConfig
        from cfk_tpu_torch.data.blocks import Dataset
        from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
        from cfk_tpu_torch.resilience.faults import (
            FactorCorruption,
            FaultInjector,
        )
        from cfk_tpu_torch.telemetry import Metrics

        ds = Dataset.from_coo(synthetic_netflix_coo(60, 30, 900, seed=0),
                              layout="tiled", chunk_elems=512, tile_rows=16)
        cfg = ALSConfig(rank=4, num_iterations=6, health_check_every=1,
                        layout="tiled", table_dtype="bfloat16",
                        max_recoveries=5, lam_escalation=1.5)
        base = self.train(ds, cfg)
        inj = FaultInjector(*[FactorCorruption(iteration=i, side="u")
                              for i in (1, 2, 3, 4)])
        metrics = Metrics()
        rec = self.train(ds, cfg, metrics=metrics, fault_injector=inj)
        level = metrics.gauges.get("escalation_level", 0)
        final = metrics.notes.get(f"escalation_{level}", "")
        pinned = "fused=False" in final and "algo=gj" in final
        # Level 4 = the "gj" rung was reached (3 = the split epilogue).
        return self.row("quantized_table", fired=inj.fired, metrics=metrics,
                        base=base, rec=rec, ds=ds, crc=False, layout="tiled",
                        ok_extra=level >= 4 and pinned,
                        final_overrides=final, split_and_gj_pinned=pinned)

    # -- streaming fold-in ------------------------------------------------

    def stream_fixture(self, parts=2, n=60, new_users=(4242,)):
        """(dataset, config, base model, in-memory broker holding a seeded
        update stream) — the reference's ``_stream_fixture``."""
        from cfk_tpu_torch.config import ALSConfig
        from cfk_tpu_torch.streaming import StreamProducer
        from cfk_tpu_torch.transport import InMemoryBroker

        ds = self.dataset()
        cfg = ALSConfig(rank=4, num_iterations=4, health_check_every=1,
                        layout=self.layout)
        base = self.train(ds, cfg)
        broker = InMemoryBroker()
        prod = StreamProducer(broker, num_partitions=parts)
        rng = np.random.default_rng(11)
        prod.send_many(
            rng.choice(ds.user_map.raw_ids, n),
            rng.choice(ds.movie_map.raw_ids, n),
            rng.integers(1, 6, n).astype(np.float32),
        )
        for raw in new_users:
            prod.send(raw, int(ds.movie_map.raw_ids[0]), 4.0)
        return ds, cfg, base, broker

    def session(self, ds, cfg, transport, manager, **kw):
        from cfk_tpu_torch.streaming import StreamConfig, StreamSession

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return StreamSession(
                ds, cfg, transport, manager,
                stream=StreamConfig(batch_records=kw.pop("batch_records", 8)),
                device=self.device, **kw)

    def stream_run(self, ds, cfg, transport, mgr_dir, base=None,
                   max_batches=None):
        from cfk_tpu_torch.transport import CheckpointManager

        sess = self.session(ds, cfg, transport, CheckpointManager(mgr_dir),
                            base_model=base)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sess.run(max_batches=max_batches)
        return sess, zlib.crc32(sess.user_factors.tobytes())

    def stream_row(self, name, **fields):
        return {"scenario": name, "device": self.device,
                "layout": self.layout, **fields}

    def stream_duplicates(self):
        """Duplicated + reordered + dropped delivery of the same update log
        folds in to factors crc-equal to clean delivery: the exactly-once
        assembly (dedup by offset, offset sort, gap re-poll) plus the seq
        dedup make misdelivery invisible to the math."""
        import tempfile

        from cfk_tpu_torch.resilience.faults import FlakyPlan, FlakyTransport

        ds, cfg, base, broker = self.stream_fixture()
        with tempfile.TemporaryDirectory() as da, \
                tempfile.TemporaryDirectory() as db:
            _, crc_clean = self.stream_run(ds, cfg, broker, da, base=base)
            flaky = FlakyTransport(
                broker, FlakyPlan(duplicate=3, reorder=5, drop=7, seed=1))
            sess, crc_flaky = self.stream_run(ds, cfg, flaky, db, base=base)
        fired = bool(flaky.duplicated and flaky.reordered and flaky.dropped)
        exact = crc_clean == crc_flaky
        detected = bool(
            sess.metrics.counters.get("delivery_duplicates", 0) > 0
            and sess.metrics.counters.get("delivery_gap_repolls", 0) > 0)
        return self.stream_row(
            "stream_duplicates", fault_fired=fired,
            duplicated=flaky.duplicated, reordered=flaky.reordered,
            dropped=flaky.dropped, detected=detected, recovered=exact,
            factors_bit_exact=exact, clean_crc32=crc_clean,
            faulty_crc32=crc_flaky, ok=bool(fired and detected and exact))

    def stream_crash_replay(self):
        """A crash mid-stream whose last commit is also torn: the resumed
        session falls back to the last intact factor+cursor step, replays
        the uncommitted log suffix and ends crc-equal to an uninterrupted
        run."""
        import tempfile

        from cfk_tpu_torch.resilience.faults import TornCheckpointManager
        from cfk_tpu_torch.transport import CheckpointManager

        ds, cfg, base, broker = self.stream_fixture()
        with tempfile.TemporaryDirectory() as da, \
                tempfile.TemporaryDirectory() as db:
            _, crc_clean = self.stream_run(ds, cfg, broker, da, base=base)
            # 2 batches commit, the 3rd commit is torn, the process "dies".
            torn = TornCheckpointManager(CheckpointManager(db), tear_at=3)
            crashed = self.session(ds, cfg, broker, torn, base_model=base)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                crashed.run(max_batches=3)
            del crashed
            resumed = self.session(ds, cfg, broker, CheckpointManager(db))
            resumed_from = resumed.stream_step
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                resumed.run()
            crc_replayed = zlib.crc32(resumed.user_factors.tobytes())
        exact = crc_clean == crc_replayed
        return self.stream_row(
            "stream_crash_replay", fault_fired=bool(torn.torn),
            detected=bool(resumed_from == 2), recovered=exact,
            resumed_from_step=resumed_from,
            replayed_updates=resumed.metrics.counters.get(
                "replayed_updates", 0),
            factors_bit_exact=exact, clean_crc32=crc_clean,
            replayed_crc32=crc_replayed,
            ok=bool(torn.torn and resumed_from == 2 and exact))

    def stream_poison_batch(self):
        """A singular micro-batch (λ = 0, a new one-rating user) that the
        ladder's λ bump fixes, then a NaN-rating batch that defeats every
        rung and is quarantined: the served factors untouched, its offsets
        consumed, the good batch after it applied."""
        import tempfile

        from cfk_tpu_torch.config import ALSConfig
        from cfk_tpu_torch.data.blocks import Dataset
        from cfk_tpu_torch.resilience.faults import blockstructured_coo
        from cfk_tpu_torch.streaming import StreamProducer
        from cfk_tpu_torch.transport import CheckpointManager, InMemoryBroker

        ds = Dataset.from_coo(blockstructured_coo(seed=0))
        cfg = ALSConfig(rank=4, num_iterations=4, lam=0.0,
                        health_check_every=1)
        base = self.train(ds, cfg)
        broker = InMemoryBroker()
        prod = StreamProducer(broker)
        victim = int(ds.user_map.raw_ids[0])
        good_user = int(ds.user_map.raw_ids[1])
        prod.send(777, int(ds.movie_map.raw_ids[0]), 5.0)  # singular batch
        prod.send(victim, int(ds.movie_map.raw_ids[1]), float("nan"))
        prod.send(good_user, int(ds.movie_map.raw_ids[2]), 4.0)
        with tempfile.TemporaryDirectory() as d:
            sess = self.session(ds, cfg, broker, CheckpointManager(d),
                                base_model=base, batch_records=1)
            u_before = np.array(sess.user_factors)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                sess.run()
        u_after = sess.user_factors
        vrow = sess.state.user_row(victim)
        grow = sess.state.user_row(good_user)
        trips = sess.metrics.counters.get("health_trips", 0)
        escalated = sess.metrics.gauges.get("stream_escalation_level", 0) >= 1
        quarantined = len(sess.quarantined) == 1
        intact = bool(np.array_equal(u_after[vrow], u_before[vrow]))
        applied = not np.array_equal(u_after[grow], u_before[grow])
        finite = bool(np.all(np.isfinite(u_after)))
        drained = sess.backlog() == 0
        return {
            "scenario": "stream_poison_batch", "device": self.device,
            "layout": "padded", "fault_fired": True,
            "detected": bool(trips >= 2),
            "recovered": bool(escalated and quarantined and intact
                              and finite),
            "health_trips": int(trips), "lambda_escalated": bool(escalated),
            "quarantined_batches": sess.quarantined,
            "served_factors_intact": intact,
            "good_batch_after_poison_applied": bool(applied),
            "stream_drained": bool(drained),
            "ok": bool(trips >= 2 and escalated and quarantined and intact
                       and applied and finite and drained),
        }

    def serve_under_foldin(self):
        """Serving stays correct while fold-in commits land: a
        ``RecommendServer`` thread answers a continuous request stream for
        a victim user while the main thread folds in batches that re-solve
        that user's row, the engine attached to the session.  FRESHNESS: a
        request issued after a commit scores exactly the committed row and
        excludes the just-rated movie; NO TORN READS: every response the
        hammering thread saw equals the answer of exactly one committed
        snapshot of the victim's row."""
        import tempfile
        import threading
        import time

        from cfk_tpu_torch.resilience.loop import drain_checkpoints
        from cfk_tpu_torch.serving import (
            RecommendServer,
            ServeClient,
            ServeEngine,
            engine_from_model,
            ensure_serve_topics,
        )
        from cfk_tpu_torch.streaming import StreamProducer
        from cfk_tpu_torch.transport import CheckpointManager

        ds, cfg, base, broker = self.stream_fixture(parts=1, n=24,
                                                    new_users=())
        victim = int(ds.user_map.raw_ids[0])
        prod = StreamProducer(broker)
        rated = [int(mv) for mv in ds.movie_map.raw_ids[3:6]]
        for mv in rated:  # three extra batches each re-solving the victim
            prod.send(victim, mv, 5.0)
        k = 5
        eng = engine_from_model(base, ds)
        vrow = int(ds.user_map.to_dense(np.asarray([victim]))[0])
        ensure_serve_topics(broker, response_partitions=2)
        server = RecommendServer(eng, broker, poll_wait_s=0.001)
        main_cli = ServeClient(broker, reply_partition=0)
        # Committed snapshots of the victim's (factor row, seen set): the
        # base first, then one per commit, through the engine's channel.
        snapshots = [(np.array(eng._gather_users(np.asarray([vrow]))[0]),
                      tuple())]

        def snap_listener(event):
            if event.get("retrain") or vrow not in (
                    event.get("touched_rows") or ()):
                return
            i = event["touched_rows"].index(vrow)
            extra = tuple(mv for row, mv in event["cells"] if row == vrow)
            snapshots.append((np.array(event["rows"][i]),
                              snapshots[-1][1] + extra))

        hammered: list = []
        post: list = []
        with tempfile.TemporaryDirectory() as d:
            sess = self.session(ds, cfg, broker, CheckpointManager(d),
                                base_model=base, batch_records=1)
            sess.add_commit_listener(snap_listener)
            eng.attach_session(sess)
            main_cli.ask([vrow], k, server=server)  # warm the serve path
            stop = threading.Event()

            def hammer():
                cli = ServeClient(broker, reply_partition=1)
                while not stop.is_set():
                    rid = cli.request(vrow, k)
                    deadline = time.monotonic() + 5.0
                    got = None
                    while got is None:
                        for resp in cli.poll_responses():
                            if resp.req_id == rid:
                                got = resp
                        if time.monotonic() > deadline:
                            return
                        time.sleep(0.0005)
                    hammered.append(got)

            threads = [
                threading.Thread(target=server.serve_forever,
                                 kwargs={"stop": stop.is_set}, daemon=True),
                threading.Thread(target=hammer, daemon=True)]
            for t in threads:
                t.start()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                while sess.step() is not None:
                    # A request issued strictly AFTER this commit returned.
                    post.append(next(iter(main_cli.ask([vrow], k).values())))
            stop.set()
            for t in threads:
                t.join(timeout=10)
            drain_checkpoints(sess.manager)
        commits = len(snapshots) - 1
        m_host = base.host_factors()[1]

        def expected_for(u_row, extra_seen):
            # A one-row engine scoring exactly this committed snapshot (the
            # victim's base seen list remapped onto row 0).
            lo = int(eng._seen_indptr[vrow])
            hi = int(eng._seen_indptr[vrow + 1])
            e2 = ServeEngine(
                u_row[None, :], m_host, num_users=1,
                num_movies=eng.num_movies,
                seen_movies=eng._seen_movies[lo:hi],
                seen_indptr=np.asarray([0, hi - lo], np.int64),
                device=eng.device)
            if extra_seen:
                e2._seen_hot[0] = list(extra_seen)
            sc, ids = e2.topk(np.asarray([0]), k)
            return np.asarray(sc)[0], np.asarray(ids)[0]

        expected = [expected_for(u, seen) for u, seen in snapshots]
        final_scores, final_ids = expected[-1]
        fresh = bool(
            post
            and np.array_equal(np.asarray(post[-1].scores), final_scores)
            and np.array_equal(np.asarray(post[-1].movie_rows), final_ids))
        rated_rows = {int(ds.movie_map.to_dense(np.asarray([mv]))[0])
                      for mv in rated}
        excluded = bool(post) and not (
            {int(x) for x in np.asarray(post[-1].movie_rows)} & rated_rows)
        torn = [
            resp.req_id for resp in hammered
            if not any(np.array_equal(np.asarray(resp.scores), ev)
                       and np.array_equal(np.asarray(resp.movie_rows), ei)
                       for ev, ei in expected)]
        return self.stream_row(
            "serve_under_foldin",
            fault_fired=bool(commits >= 3 and hammered),
            detected=bool(eng.invalidations >= 3),
            recovered=bool(fresh and excluded and not torn),
            commits=commits, cache_invalidations=int(eng.invalidations),
            concurrent_responses=len(hammered), post_commit_fresh=fresh,
            just_rated_excluded=excluded, torn_responses=torn,
            ok=bool(commits >= 3 and hammered and eng.invalidations >= 3
                    and fresh and excluded and not torn))

    # -- serving: the exact fallback, the broker, the fleet -----------------

    def two_stage_fallback(self):
        """A corrupted two-stage cluster index never corrupts answers: NaN
        in one centroid row under a two-stage engine (256 clusters, 32
        probed, pinned as the reference's plan resolves them).  Contract:
        DETECTED — the index probe trips before any shortlist is scored
        (one fallback, the batch ran exact); DEGRADED BIT-EXACTLY — the
        faulted batch equals a pure-exact engine's on the same factors;
        STABLE — the next batch is still exact, with no second firing;
        RECOVERED — a retrain commit rebuilds the index and two-stage
        resumes at or above the recall floor.  The reference also checks a
        plan-provenance transition naming the fault; the port has no
        planner yet, so that check waits for it."""
        from cfk_tpu_torch.serving import ServeEngine, recall_at_k
        from cfk_tpu_torch.serving.twostage import SERVE_MIN_RECALL

        rng = np.random.default_rng(7)
        users, movies, rank, k = 96, 1024, 16, 5
        uf = rng.standard_normal((users, rank)).astype(np.float32) * 0.3
        mf = rng.standard_normal((movies, rank)).astype(np.float32) * 0.3
        eng = ServeEngine(uf, mf, num_users=users, num_movies=movies,
                          serve_mode="two_stage", clusters=256,
                          probe_clusters=32, device=self.device)
        exact = ServeEngine(uf, mf, num_users=users, num_movies=movies,
                            table_dtype=eng.table_dtype, tile_m=eng.tile_m,
                            serve_mode="exact", device=self.device)
        rows = np.arange(8)
        eng.topk(rows, k)
        healthy_mode = eng.last_scan.get("serve_mode")
        eng._cluster[0].centroids[5, :] = np.nan  # the coarse stage's table
        fv, fi = eng.topk(rows, k)  # the faulted batch
        ev, ei = exact.topk(rows, k)
        bit_exact = bool(np.array_equal(fv, ev) and np.array_equal(fi, ei))
        detected = bool(eng.two_stage_fallbacks == 1
                        and eng.last_scan.get("serve_mode") == "exact")
        eng.topk(rows, k)
        degraded_stable = bool(eng.two_stage_fallbacks == 1
                               and eng.last_scan.get("serve_mode") == "exact")
        mf2 = mf + rng.standard_normal(mf.shape).astype(np.float32) * 0.01
        eng.on_commit({"retrain": True, "user_factors": uf,
                       "movie_factors": mf2})
        _, pi = eng.topk(rows, k)
        post_mode = eng.last_scan.get("serve_mode")
        _, oracle = eng.topk(rows, k, force_exact=True)
        post_recall = float(recall_at_k(pi, oracle))
        recovered = bool(post_mode == "two_stage"
                         and not eng._two_stage_disabled
                         and post_recall >= SERVE_MIN_RECALL)
        fired = healthy_mode == "two_stage"
        return self.stream_row(
            "two_stage_fallback", fault_fired=fired, detected=detected,
            recovered=recovered, fallbacks=int(eng.two_stage_fallbacks),
            last_fault=eng.last_fault, fallback_bit_exact=bit_exact,
            degraded_stable=degraded_stable,
            post_recovery_recall=round(post_recall, 4),
            ok=bool(fired and detected and bit_exact and degraded_stable
                    and recovered))

    def flaky_broker(self):
        """The TCP client against the port's broker behind a proxy that
        drops the first two connections and delays two response frames:
        the connect retries and the patient reads win, and every record
        arrives intact."""
        from cfk_tpu_torch.resilience.faults import FlakyBrokerProxy, FlakyPlan
        from cfk_tpu_torch.transport.tcp import BrokerProcess, TcpBrokerClient

        payload = [bytes([i]) * 64 for i in range(32)]
        with BrokerProcess() as bp, FlakyBrokerProxy(
                bp.port, FlakyPlan(drop_first_connects=2, delay_frames=2,
                                   frame_delay=0.1)) as proxy:
            with TcpBrokerClient("127.0.0.1", proxy.port, connect_retries=5,
                                 retry_base=0.02, read_timeout=0.05,
                                 read_retries=20) as c:
                c.create_topic("chaos", 1)
                for i, v in enumerate(payload):
                    c.produce("chaos", key=i, value=v)
                got = [r.value for r in c.consume("chaos", 0)]
            dropped, delayed = proxy.dropped, proxy.delayed
        intact = got == payload
        fired = bool(dropped and delayed)
        return self.stream_row(
            "flaky_broker", fault_fired=fired,
            detected=True,  # the retries are the detection
            recovered=intact, connections_dropped=dropped,
            frames_delayed=delayed, records_intact=intact,
            ok=bool(fired and intact))

    def fleet_fixture(self, replicas, transport=None, seed=0, users=48,
                      movies=64, rank=6, **fleet_kw):
        """(fleet, publisher, broker, (u, m), oracle engine): a prewarmed
        fleet over seeded factors with the store seeded; the oracle is a
        fresh engine over the same factors (the reference's
        ``_fleet_fixture``)."""
        from cfk_tpu_torch.serving import DeltaPublisher, ServeEngine, ServeFleet
        from cfk_tpu_torch.transport import InMemoryBroker

        rng = np.random.default_rng(seed)
        u = rng.standard_normal((users, rank)).astype(np.float32)
        m = rng.standard_normal((movies, rank)).astype(np.float32)

        def engine(i=0):
            return ServeEngine(u, m, num_users=users, num_movies=movies,
                               tile_m=16, device=self.device)

        broker = InMemoryBroker()
        fleet = ServeFleet(engine, transport if transport is not None
                           else broker, replicas=replicas, **fleet_kw)
        fleet.seed_store(u, m, num_users=users)
        fleet.prewarm(5, max_batch=16)
        pub = DeltaPublisher(broker, fleet.store)
        return fleet, pub, broker, (u, m), engine()

    def serve_replica_kill(self):
        """Killing a serving replica mid-traffic loses nothing: a
        2-replica fleet answers a user-keyed stream and replica 0 dies
        abruptly (no cursor commit) after wave 3.  Contract: every request
        answered (zero timeouts; rejections re-sent), every answer equal
        to the oracle engine's, every answer stamped, and the victim's
        partition moved to the survivor at the committed cursor."""
        from cfk_tpu_torch.serving import ServeClient

        fleet, _, broker, _, oracle = self.fleet_fixture(replicas=2)
        k = 5
        client = ServeClient(broker, route_by_user=True)
        answered, timeouts = [], 0
        fleet.start()
        try:
            for wave in range(6):
                if wave == 3:
                    fleet.kill_replica(0)
                for user in range(16):
                    try:
                        got = client.ask([user], k, timeout_s=20)
                        answered.append((user, next(iter(got.values()))))
                    except TimeoutError:
                        timeouts += 1
        finally:
            fleet.stop()
        torn, stamped = [], True
        for user, resp in answered:
            sc, ids = oracle.topk(np.asarray([user]), k)
            if not (np.array_equal(np.asarray(resp.scores), sc[0])
                    and np.array_equal(np.asarray(resp.movie_rows), ids[0])):
                torn.append(user)
            stamped &= resp.staleness >= 0
        c = fleet.counters()
        fired = bool(c["failovers"] == 1 and not fleet.replicas[0].alive)
        recovered = bool(timeouts == 0 and len(answered) == 96 and not torn)
        return self.stream_row(
            "serve_replica_kill", fault_fired=fired,
            detected=bool(c["failovers"] == 1), recovered=recovered,
            requests_answered=len(answered), timeouts=timeouts,
            torn_responses=torn, staleness_stamped=bool(stamped),
            client_retries=int(client.retries),
            client_rejections=int(client.rejections),
            survivor_served=int(fleet.replicas[1].server.requests_served),
            ok=bool(fired and recovered and stamped))

    def serve_delta_gap(self):
        """A lost factor-delta frame is detected loudly and recovered
        bit-exactly: a ``DeltaStreamTamper`` hides frame 2 of the deltas
        topic for good while the publisher ships six commits.  Contract:
        the seq hole fires the gap path; the snapshot resync leaves the
        user table crc-equal to a fresh engine that applied every commit
        (``table_crc``); a request after the resync for a row shipped
        only in the hidden frame gets the re-solved factors' answer."""
        from cfk_tpu_torch.resilience.faults import DeltaStreamTamper
        from cfk_tpu_torch.serving import (
            DeltaPublisher,
            ServeClient,
            ensure_serve_topics,
            table_crc,
        )
        from cfk_tpu_torch.transport import InMemoryBroker

        broker = InMemoryBroker()
        tampered = DeltaStreamTamper(broker, topic="factor-deltas", hide=[2])
        fleet, _, _, _, oracle = self.fleet_fixture(replicas=1,
                                                    transport=tampered)
        # the publisher writes to the real log under the tamper
        pub = DeltaPublisher(broker, fleet.store)
        ensure_serve_topics(broker)
        rng = np.random.default_rng(3)
        replica = fleet.replicas[0]
        victim_rows = None
        for i in range(6):
            rows = rng.integers(0, 48, size=3)
            ev = {"touched_rows": [int(r) for r in rows],
                  "rows": rng.standard_normal((3, 6)).astype(np.float32),
                  "cells": [], "retrain": False, "num_users": 48}
            if i == 2:
                victim_rows = [int(r) for r in rows]
            pub.on_commit(ev)
            oracle.on_commit(ev)
        replica.pump()
        crc_match = table_crc(replica.engine) == table_crc(oracle)
        got = ServeClient(broker).ask([victim_rows[0]], 5,
                                      server=replica.server)
        resp = next(iter(got.values()))
        sc, ids = oracle.topk(np.asarray([victim_rows[0]]), 5)
        fresh = bool(np.array_equal(np.asarray(resp.scores), sc[0])
                     and np.array_equal(np.asarray(resp.movie_rows), ids[0]))
        fired = bool(tampered.hidden >= 1)
        detected = bool(replica.gaps_detected >= 1)
        recovered = bool(replica.resyncs >= 1 and crc_match and fresh)
        return self.stream_row(
            "serve_delta_gap", fault_fired=fired, detected=detected,
            recovered=recovered, frames_hidden=int(tampered.hidden),
            gaps_detected=int(replica.gaps_detected),
            resyncs=int(replica.resyncs),
            applied_seq=int(replica.applied_seq),
            crc_exact_vs_fresh_engine=bool(crc_match),
            post_resync_fresh=fresh,
            ok=bool(fired and detected and recovered))

    def serve_rollover(self):
        """A warm-retrain epoch rollover under continuous traffic answers
        every request and never a mixed-epoch table: the publisher
        announces epoch 1 after ten asks; the replica builds and prewarms
        the new engine on a background thread and flips one reference at
        a batch boundary.  Contract: zero timeouts; every answer equals the
        epoch-0 or the epoch-1 oracle's, with the matching epoch stamp;
        after the flip, answers come from epoch 1."""
        import time

        from cfk_tpu_torch.serving import ServeClient, ServeEngine

        fleet, pub, broker, (u, m), oracle0 = self.fleet_fixture(replicas=1)
        rng = np.random.default_rng(9)
        u2 = rng.standard_normal(u.shape).astype(np.float32)
        m2 = rng.standard_normal(m.shape).astype(np.float32)
        oracle1 = ServeEngine(u2, m2, num_users=u.shape[0],
                              num_movies=m.shape[0], tile_m=16,
                              device=self.device)
        k = 5
        client = ServeClient(broker, route_by_user=True)
        answered, timeouts = [], 0
        fleet.start()
        replica = fleet.replicas[0]
        try:
            deadline = time.monotonic() + 60
            asks = post_flip = 0
            while time.monotonic() < deadline:
                user = asks % 16
                try:
                    got = client.ask([user], k, timeout_s=20)
                    answered.append((user, next(iter(got.values()))))
                except TimeoutError:
                    timeouts += 1
                asks += 1
                if asks == 10:
                    pub.on_commit({"retrain": True, "user_factors": u2,
                                   "movie_factors": m2, "num_users": 48})
                if replica.rollovers >= 1:
                    # a few post-flip asks, stopping before their batch
                    # events push the rollover out of the dump's tail
                    post_flip += 1
                    if post_flip >= 8:
                        break
        finally:
            fleet.stop()
        mixed, stamp_wrong, post_flip_new = [], [], False
        for user, resp in answered:
            s0, i0 = oracle0.topk(np.asarray([user]), k)
            s1, i1 = oracle1.topk(np.asarray([user]), k)
            got_s, got_i = np.asarray(resp.scores), np.asarray(resp.movie_rows)
            is0 = bool(np.array_equal(got_s, s0[0])
                       and np.array_equal(got_i, i0[0]))
            is1 = bool(np.array_equal(got_s, s1[0])
                       and np.array_equal(got_i, i1[0]))
            if not (is0 or is1):
                mixed.append(user)
            elif is1 and not is0:
                post_flip_new = True
                if resp.epoch != 1:
                    stamp_wrong.append(user)
            elif is0 and not is1 and resp.epoch != 0:
                stamp_wrong.append(user)
        fired = bool(replica.rollovers >= 1)
        detected = bool(replica.engine.epoch == 1)
        return self.stream_row(
            "serve_rollover", fault_fired=fired, detected=detected,
            recovered=bool(timeouts == 0 and not mixed and post_flip_new),
            requests_answered=len(answered), timeouts=timeouts,
            rollovers=int(replica.rollovers),
            rollover_times=replica.rollover_times,
            mixed_epoch_responses=mixed, epoch_stamp_mismatches=stamp_wrong,
            served_from_new_epoch=post_flip_new,
            ok=bool(fired and detected and timeouts == 0 and not mixed
                    and not stamp_wrong and post_flip_new))


    def worker_kill(self):
        """One of two ranks SIGKILLed mid-run (``cfk_tpu/scripts/
        chaos_lab.py:380-468``): the survivor must exit bounded (its next
        collective fails, or its watchdog expires) with the checkpoint
        store intact, and a restarted pair must resume to the factors — crc
        — and the MSE of an uninterrupted two-rank run.  The ranks are
        torchrun-style processes of the port's launch harness
        (``parallel.launch``) on the lab's device; its own dataset (64 × 32
        × 900 ratings, padded) whatever ``--layout`` says."""
        import re
        import signal
        import tempfile

        from cfk_tpu_torch.parallel.launch import (
            communicate_all,
            free_port,
            spawn_workers,
        )
        from cfk_tpu_torch.resilience.preempt import STALL_EXIT_CODE
        from cfk_tpu_torch.telemetry import record_event
        from cfk_tpu_torch.transport.checkpoint import CheckpointManager

        def pair(ckdir, drill, *extra):
            procs = spawn_workers(free_port(), 2, ckdir, "--drill", drill,
                                  "--device", self.device, *extra)
            return procs, "".join(communicate_all(procs, timeout=240))

        def resumed(out):
            m = re.search(r"DRILL_RESUME mse=([0-9.]+) .*crc=(\w+)", out)
            return (float(m.group(1)), m.group(2)) if m else (None, None)

        with tempfile.TemporaryDirectory() as ck, \
                tempfile.TemporaryDirectory() as ck_ref:
            procs, kout = pair(ck, "kill", "--kill-iteration", "4")
            killed = procs[1].returncode == -signal.SIGKILL
            survivor = procs[0].returncode
            mgr = CheckpointManager(ck)
            steps = mgr.iterations()
            intact = bool(steps)
            try:
                for it in steps:
                    mgr.verify(it)
            except Exception:
                intact = False
            rprocs, rout = pair(ck, "resume")
            uprocs, uout = pair(ck_ref, "resume")
        (mse, crc), (umse, ucrc) = resumed(rout), resumed(uout)
        record_event("fault", "worker_kill_observed",
                     victim_exit=procs[1].returncode, survivor_exit=survivor,
                     steps_intact=intact)
        ran = all(p.returncode == 0 for p in rprocs + uprocs)
        recovered = bool(ran and mse is not None and umse is not None
                         and abs(mse - umse) < 1e-4)
        ok = bool(killed and survivor not in (0, None) and intact
                  and recovered and crc == ucrc)
        tails = {} if ok else {"kill": kout[-2000:], "resume": rout[-2000:],
                               "uninterrupted": uout[-2000:]}
        return self.stream_row(
            "worker_kill", layout="padded", fault_fired=bool(killed),
            detected=survivor not in (0, None), recovered=recovered,
            crc_equal=bool(crc is not None and crc == ucrc),
            survivor_exit=survivor,
            survivor_graceful_stall_exit=survivor == STALL_EXIT_CODE,
            steps_committed=steps, checkpoints_intact=intact,
            resumed_mse=mse, uninterrupted_mse=umse,
            exits=dict(kill=[p.returncode for p in procs],
                       resume=[p.returncode for p in rprocs],
                       uninterrupted=[p.returncode for p in uprocs]),
            worker_output_tails=tails, ok=ok)


SCENARIOS = ("nan", "inf", "singular_chunk", "torn_checkpoint", "preemption",
             "slow_disk", "telemetry_overhead", "quantized_table",
             "stream_duplicates", "stream_crash_replay",
             "stream_poison_batch", "serve_under_foldin",
             "two_stage_fallback", "flaky_broker", "serve_replica_kill",
             "serve_delta_gap", "serve_rollover", "worker_kill")
# What the flight recorder's last dump must name, per scenario.
FLIGHT_EXPECT = {
    "nan": ("nonfinite",),
    "inf": ("nonfinite",),
    "singular_chunk": ("health_trip",),
    "torn_checkpoint": ("corrupt_checkpoint",),
    "preemption": ("preempt",),
    "slow_disk": ("checkpoint_committed",),
    "telemetry_overhead": ("telemetry_overhead",),
    "quantized_table": ("health_trip", "nonfinite"),
    "stream_duplicates": ("delivery_duplicates",),
    "stream_crash_replay": ("stream_resumed", "corrupt_checkpoint"),
    "stream_poison_batch": ("quarantine",),
    "serve_under_foldin": ("commit", "serve"),
    "two_stage_fallback": ("two_stage_fault",),
    "flaky_broker": ("retryable_failure",),
    "serve_replica_kill": ("replica_kill", "failover"),
    "serve_delta_gap": ("delta_gap", "resync"),
    "serve_rollover": ("rollover_begin", "rollover_flip"),
    "worker_kill": ("worker_kill",),
}
_FLIGHT_TAIL = 50  # events searched at the dump's tail
# Scenarios that build their own dataset whatever the layout: run once, on
# the first layout given.
LAYOUT_FREE = ("quantized_table", "stream_poison_batch",
               "two_stage_fallback", "flaky_broker", "serve_replica_kill",
               "serve_delta_gap", "serve_rollover", "worker_kill")


def run_scenario(lab: Lab, name: str) -> dict:
    """One scenario with the flight recorder dumping into a scratch
    directory, its dump contract folded into the row."""
    import glob
    import tempfile

    from cfk_tpu_torch.telemetry import get_recorder

    rec = get_recorder()
    with tempfile.TemporaryDirectory() as td:
        rec.configure(dump_dir=td)
        rec.clear()
        try:
            row = getattr(lab, name)()
        finally:
            rec.configure(dump_dir=None)
        dumps = sorted(glob.glob(os.path.join(td, "cfk_flight_*.json")),
                       key=os.path.getmtime)
        forced = False
        if not dumps:
            rec.configure(dump_dir=td)
            path = rec.dump(f"scenario_end_{name}")
            rec.configure(dump_dir=None)
            forced = True
            dumps = [path] if path else []
        named, last_reason = False, None
        if dumps:
            with open(dumps[-1]) as f:
                payload = json.load(f)
            last_reason = payload.get("reason")
            tail = json.dumps(payload.get("events", [])[-_FLIGHT_TAIL:])
            named = any(s in tail for s in FLIGHT_EXPECT[name])
    fr_ok = bool(dumps) and named
    row["flight_recorder"] = {"dumps": len(dumps), "forced_end_dump": forced,
                              "last_reason": last_reason,
                              "named_fault": named, "ok": fr_ok}
    row["ok"] = bool(row.get("ok")) and fr_ok
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scenario", nargs="*", default=list(SCENARIOS),
                   choices=list(SCENARIOS))
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                   help="cuda (default: the kernels) or cpu (the plain "
                   "versions)")
    p.add_argument("--layout", nargs="+", default=["padded"],
                   choices=list(LAYOUTS))
    args = p.parse_args(argv)
    import torch

    from cfk_tpu_torch.device import resolve_device

    resolve_device(args.device)  # a cuda run without a card fails here
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    ok, rows = True, []
    for i, layout in enumerate(args.layout):
        lab = Lab(args.device, layout)
        for name in args.scenario:
            if i and name in LAYOUT_FREE:
                continue
            row = run_scenario(lab, name)
            rows.append(row)
            print(json.dumps(row, default=repr), flush=True)
            ok &= bool(row.get("ok"))
    print(json.dumps({
        "chaos_lab": "pass" if ok else "FAIL",
        "scenarios": {f"{r['layout']}/{r['scenario']}": r.get("ok")
                      for r in rows},
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
