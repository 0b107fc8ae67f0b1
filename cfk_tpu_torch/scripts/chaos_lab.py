"""Chaos lab of the port: inject each single-process fault class into a
small deterministic training run and report the outcome — the port of
``scripts/chaos_lab.py``'s ``nan``, ``inf``, ``singular_chunk``,
``torn_checkpoint``, ``preemption``, ``slow_disk`` and
``telemetry_overhead`` scenarios.  Run::

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
            ok_extra=True, **extra):
        base_rmse, rec_rmse = self.rmse(base, ds), self.rmse(rec, ds)
        if detected is None:
            detected = metrics.counters.get("health_trips", 0) >= 1
        within = bool(np.isfinite(rec_rmse) and abs(rec_rmse - base_rmse)
                      <= RMSE_RTOL * max(base_rmse, 1e-9))
        crc_equal = self.crc(rec) == self.crc(base)
        return {
            "scenario": name, "device": self.device, "layout": self.layout,
            "fault_fired": bool(fired), "detected": bool(detected),
            "recovered": bool(within and crc_equal),
            "crc_equal": bool(crc_equal),
            "rollbacks": metrics.counters.get("rollbacks", 0),
            "escalation_level": metrics.gauges.get("escalation_level", 0),
            "fault_free_rmse": float(base_rmse),
            "recovered_rmse": float(rec_rmse),
            "notes": dict(metrics.notes), **extra,
            "ok": bool(fired and detected and within and crc_equal
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


SCENARIOS = ("nan", "inf", "singular_chunk", "torn_checkpoint", "preemption",
             "slow_disk", "telemetry_overhead")
# What the flight recorder's last dump must name, per scenario.
FLIGHT_EXPECT = {
    "nan": ("nonfinite",),
    "inf": ("nonfinite",),
    "singular_chunk": ("health_trip",),
    "torn_checkpoint": ("corrupt_checkpoint",),
    "preemption": ("preempt",),
    "slow_disk": ("checkpoint_committed",),
    "telemetry_overhead": ("telemetry_overhead",),
}
_FLIGHT_TAIL = 50  # events searched at the dump's tail


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
    for layout in args.layout:
        lab = Lab(args.device, layout)
        for name in args.scenario:
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
