"""The rate → fold-in loop: exactly-once streaming updates into live factors.

The port of ``cfk_tpu/streaming/session.py``: the same bootstrap and
resume, commit metadata (a stream directory written by either package
resumes in the other), probe, ladder, quarantine and warm retrain.  The
movie table lives on the session's device (the card by default) and every
fold-in solves there (``streaming.foldin``); the user table ``_u`` is a
host float32 table (a bfloat16 session rounds its rows to bfloat16, as the
reference's bf16 numpy table holds them), handed to the checkpoint store's
``save_async``, whose snapshot is taken at the call — so the next batch's
in-place row update never reaches a commit still being written.  The
reference's out-of-core branch (``offload_tier="host_window"``) belongs to
the out-of-core slice, and the port has no jit compile cache to enable.

``StreamSession`` closes the loop the reference only sketched: ratings
arrive continuously on a durable updates topic, micro-batches of touched
users are folded into the live factor state by one restricted ALS
half-iteration, and every commit persists the factors ATOMICALLY WITH the
consumer's offset cursor — the cursor rides the checkpoint manifest
(``CheckpointManager.save(meta=...)``), whose atomic directory rename plus
crc32 verification the checkpoint store already proves out.  There is no
instant at which the factors and the cursor can disagree on disk; a crash
replays exactly the uncommitted log suffix, and because micro-batch
boundaries are log offsets (``StreamConsumer``), the replayed batches —
and therefore the recovered factors — are bit-identical to an
uninterrupted run.

Delivery semantics, layer by layer:

- **transport** may drop / duplicate / reorder (at-least-once):
  ``StreamConsumer`` heals all three by offset — a batch is a pure
  function of the log.
- **log** may hold retried appends and re-rates: ``StreamState`` dedups by
  (user, movie) seq, last-seq-wins — application is idempotent.
- **math** may be poisoned (singular systems at λ=0, NaN ratings): every
  fold-in is probed by the health sentinel BEFORE commit; a tripped
  batch is rolled back (staged state discarded, factors untouched) and the
  recovery ladder escalates (λ bump → split epilogue → GJ) on retry;
  a batch that defeats the whole ladder is quarantined — its offsets are
  consumed (poison must not wedge the stream) but its writes never reach
  the served factors or the state.
- **process** may be evicted: the ``PreemptionGuard`` is polled at batch
  boundaries; eviction drains the async checkpoint writer so the last
  factor+cursor commit is durably on disk, then returns resumable.

Periodic warm-started full retrains (``retrain_every``) rebuild the full
dataset from the merged state and run the resilient stepped training loop
with the CURRENT factors as the starting checkpoint, folding the movie
side's staleness back in without ever serving a cold model.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from cfk_tpu_torch.config import ALSConfig
from cfk_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from cfk_tpu_torch.resilience import sentinel as _sentinel
from cfk_tpu_torch.resilience.loop import drain_checkpoints, save_checkpoint
from cfk_tpu_torch.resilience.policy import (
    Overrides,
    RecoveryPolicy,
    policy_from_config,
)
from cfk_tpu_torch.streaming.consumer import StreamConsumer
from cfk_tpu_torch.streaming.foldin import (
    _pow2_ceil, fold_in_rows, fold_in_tensor, trace_count)
from cfk_tpu_torch.streaming.producer import UPDATES_TOPIC
from cfk_tpu_torch.streaming.state import StreamState
from cfk_tpu_torch.telemetry import record_event, span
from cfk_tpu_torch.telemetry.recorder import dump_flight
from cfk_tpu_torch.transport.serdes import decode_rating_update

_STREAM_MODEL = "als-stream"
# The padded fold-in's width quantum and the warm retrain's padding: the
# config's ``pad_multiple`` default, which its datasets are built with.
_PAD_MULTIPLE = ALSConfig.pad_multiple


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Knobs of the streaming loop (model/solver knobs stay on ALSConfig)."""

    topic: str = UPDATES_TOPIC
    # Log records consumed per partition per micro-batch.  Batch boundaries
    # are offsets, so this value is part of the replay contract: it is
    # recorded in every commit and the committed value wins on resume (a
    # changed setting applies only to batches past the committed cursor).
    batch_records: int = 256
    # Fold-in solve layout: "padded" | "tiled" | "auto" (= tiled when the
    # training layout is tiled — the same kernels as training — else
    # padded).
    foldin_layout: str = "auto"
    # Warm full retrain every N stream commits (None = never): rebuild the
    # dataset from the merged state and run the resilient training loop
    # warm-started from the current factors.
    retrain_every: int | None = None
    # Re-poll budget for delivery gaps (dropped records must be redelivered
    # by the at-least-once transport; after this many re-polls the session
    # fails loudly instead of hanging like the reference).
    gap_retries: int = 20
    gap_wait_s: float = 0.05
    # Sleep between polls while following an idle topic.
    poll_wait_s: float = 0.05
    # User-table growth quantum: new streamed-in users extend the factor
    # table in chunks of this many rows (bounds reallocations).
    grow_multiple: int = 64

    def __post_init__(self) -> None:
        if self.batch_records < 1:
            raise ValueError(
                f"batch_records must be >= 1, got {self.batch_records}"
            )
        if self.foldin_layout not in ("auto", "padded", "tiled"):
            raise ValueError(
                f"foldin_layout must be auto/padded/tiled, got "
                f"{self.foldin_layout!r}"
            )
        if self.retrain_every is not None and self.retrain_every < 1:
            raise ValueError(
                f"retrain_every must be >= 1, got {self.retrain_every}"
            )
        if self.grow_multiple < 1:
            raise ValueError(
                f"grow_multiple must be >= 1, got {self.grow_multiple}"
            )


class PoisonedBatchError(RuntimeError):
    """Raised when ``on_unrecoverable='raise'`` and a batch defeats the
    whole recovery ladder."""


def _host_f32(x) -> np.ndarray:
    """A factor table (tensor on any device, or a host array — a JAX bf16
    one too) as a float32 host array of its own: never a view of the
    caller's memory, which the session's in-place row updates would
    otherwise write through."""
    from cfk_tpu_torch.models.als import as_tensor

    if not isinstance(x, torch.Tensor):
        x = as_tensor(np.asarray(x), "cpu")
    return np.array(x.detach().float().cpu().numpy(), copy=True)


class StreamSession:
    """Consume rating updates and fold them into live ALS factors.

    ``manager`` (a ``CheckpointManager``-shaped store) is the session's
    system of record: factors + offset cursor + stream metadata commit as
    one atomic step per micro-batch.  On construction the session either
    resumes from the store's newest intact step (rebuilding the rating
    state by replaying the log below the committed cursor) or bootstraps
    from ``base_model`` (committing step 0 with a zero cursor).  The
    fold-in runs on ``device`` (the card by default; ``"cpu"`` runs the
    plain versions).
    """

    def __init__(
        self,
        dataset,
        config,
        transport,
        manager,
        *,
        stream: StreamConfig | None = None,
        base_model=None,
        metrics=None,
        preemption_guard=None,
        policy: RecoveryPolicy | None = None,
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> None:
        from cfk_tpu_torch.models.als import _layout_of
        from cfk_tpu_torch.telemetry import Metrics

        if manager is None:
            raise ValueError(
                "StreamSession needs a checkpoint manager: the offset "
                "cursor commits atomically with the factors, so a durable "
                "store is not optional"
            )
        self.device = resolve_device(device)
        self.dataset = dataset
        self.config = config
        self.transport = transport
        self.manager = manager
        self.stream = stream or StreamConfig()
        self.metrics = metrics if metrics is not None else Metrics()
        self.guard = preemption_guard
        self.policy = policy or policy_from_config(config)
        self.health = _sentinel.health_from_config(config)
        self._train_layout = (_layout_of(dataset) if config.layout == "auto"
                              else config.layout)
        self._layout = (
            self.stream.foldin_layout if self.stream.foldin_layout != "auto"
            else ("tiled" if self._train_layout == "tiled" else "padded")
        )
        # Out-of-core sessions (``cfk_tpu/streaming/session.py:163-183``):
        # with offload_tier='host_window' the movie table lives in a host
        # ``HostFactorStore`` and every fold-in stages the batch's touched
        # movie rows as one window (``foldin.fold_in_rows_windowed`` — the
        # resident fold-in's bits).  The commit protocol, the ladder and
        # quarantine are unchanged: they see only the solved rows and the
        # tables at commit time.
        self._offload = getattr(config, "offload_tier",
                                "device") == "host_window"
        self._m_store = None
        self._foldin_stats: dict = {}
        if self._offload:
            if self.stream.foldin_layout == "tiled":
                raise ValueError(
                    "foldin_layout='tiled' needs the device-resident movie "
                    "table; an offload_tier='host_window' session stages "
                    "ad-hoc windows (foldin_layout 'auto'/'padded')")
            self._layout = "padded"
        self._overrides = Overrides(
            lam=config.lam, fused_epilogue=config.fused_epilogue,
            reg_solve_algo=(None if config.reg_solve_algo == "auto"
                            else config.reg_solve_algo),
        )
        self.state = StreamState(dataset)
        self.stream_step = 0
        self.quarantined: list[dict] = []
        self._m = None  # tensor [M_pad, k] on the device, fixed between retrains
        self._u = None  # host float32 [U_pad, k], row-mutated by fold-ins
        # Serving-side subscribers: fired AFTER each durable commit with
        # copies of the solved rows, so a hot-user factor cache
        # (serving.ServeEngine.attach_session) re-serves fold-in updates
        # without ever reading this session's mutable arrays.
        self._commit_listeners: list = []
        resumed = self._try_resume()
        if not resumed:
            self._bootstrap(base_model)

    # -- bootstrap / resume --------------------------------------------------

    def _factor_dtype(self) -> torch.dtype:
        from cfk_tpu_torch.models.als import storage_dtype

        return storage_dtype(self.config)

    def _stored(self, rows: np.ndarray) -> np.ndarray:
        """Host float32 rows as the factor dtype stores them (a bfloat16
        session rounds them to bfloat16)."""
        rows = np.asarray(rows, np.float32)
        if self._factor_dtype() == torch.float32:
            return rows
        return torch.from_numpy(np.ascontiguousarray(rows)).to(
            self._factor_dtype()).float().numpy()

    def _set_users(self, arr) -> None:
        self._u = self._stored(_host_f32(arr))

    def _set_movie(self, arr) -> None:
        """Install the fixed movie table on the device, in the config's
        factor dtype."""
        if isinstance(arr, torch.Tensor):
            m = arr.detach()
        else:
            from cfk_tpu_torch.models.als import as_tensor

            m = as_tensor(np.asarray(arr), "cpu")
        if self._offload:
            from cfk_tpu_torch.offload.store import HostFactorStore

            self._m_store = HostFactorStore.from_array(
                m.to(dtype=self._factor_dtype()), dtype=self.config.dtype)
            self._m = None
            return
        self._m = m.to(device=self.device, dtype=self._factor_dtype()).clone()

    def _movie_table(self) -> torch.Tensor:
        """The fixed movie table: on the device, or the host store's."""
        return self._m_store.as_tensor() if self._offload else self._m

    def _bootstrap(self, base_model) -> None:
        if base_model is None:
            raise ValueError(
                "no resumable stream state in the checkpoint store and no "
                "base_model given — train a base model first (train_als) "
                "or point the session at its existing stream directory"
            )
        self._set_users(base_model.user_factors)
        self._set_movie(base_model.movie_factors)
        nparts = self.transport.num_partitions(self.stream.topic)
        self.consumer = StreamConsumer(
            self.transport, topic=self.stream.topic,
            cursors={p: 0 for p in range(nparts)},
            gap_retries=self.stream.gap_retries,
            gap_wait_s=self.stream.gap_wait_s,
        )
        # Step 0 pins the zero cursor atomically with the base factors, so
        # even a crash before the first batch resumes cleanly.
        self._commit(note="bootstrap")

    def _try_resume(self) -> bool:
        latest = self.manager.latest_valid_iteration()
        if latest is None:
            return False
        st = self.manager.restore(latest)
        meta = st.meta
        if meta.get("model") != _STREAM_MODEL:
            raise ValueError(
                f"checkpoint store holds model={meta.get('model')!r}, not a "
                f"{_STREAM_MODEL} session — point the stream at its own "
                "directory"
            )
        if int(meta.get("rank", -1)) != self.config.rank:
            raise ValueError(
                f"stream checkpoint has rank {meta.get('rank')}, config "
                f"wants {self.config.rank}"
            )
        if int(meta.get("base_users", -1)) != self.state.num_base_users:
            raise ValueError(
                "stream checkpoint was committed against a base dataset "
                f"with {meta.get('base_users')} users; this dataset has "
                f"{self.state.num_base_users} — same --data required to "
                "resume (the rating state replays from it)"
            )
        self._set_users(st.user_factors)
        self._set_movie(st.movie_factors)
        self.stream_step = int(meta.get("stream_step", latest))
        self.quarantined = list(meta.get("quarantined", []))
        ov = meta.get("overrides")
        if ov is not None:
            # restore the sticky escalation ladder state committed with
            # the factors — resuming at the config's un-escalated knobs
            # would solve post-crash batches differently from the
            # uninterrupted run (bit-exact replay contract)
            self._overrides = Overrides(
                lam=float(ov["lam"]),
                fused_epilogue=ov.get("fused_epilogue"),
                reg_solve_algo=ov.get("reg_solve_algo"),
            )
        # Batch boundaries are part of the replay contract: the committed
        # batch_records wins over this session's setting, so post-cursor
        # batches are re-cut exactly as an uninterrupted run would have
        # cut them (batch composition moves the solved rows at the ulp
        # level — foldin.py's determinism contract).
        committed_br = int(meta.get("batch_records",
                                    self.stream.batch_records))
        if committed_br != self.stream.batch_records:
            self.metrics.note(
                "batch_records_override",
                f"resume uses the committed batch_records={committed_br} "
                f"(this session asked for {self.stream.batch_records}; the "
                "replay contract pins the committed value)",
            )
            self.stream = dataclasses.replace(
                self.stream, batch_records=committed_br
            )
        cursors = {int(p): int(o) for p, o in meta.get("offsets", {}).items()}
        self.consumer = StreamConsumer(
            self.transport, topic=self.stream.topic, cursors=cursors,
            gap_retries=self.stream.gap_retries,
            gap_wait_s=self.stream.gap_wait_s,
        )
        self._replay_state(cursors, meta)
        self.metrics.note(
            "stream_resumed",
            f"step {self.stream_step}, cursor {cursors}, "
            f"{len(meta.get('new_users', []))} streamed-in users",
        )
        record_event("stream", "stream_resumed", step=self.stream_step)
        return True

    def _replay_state(self, cursors: dict[int, int], meta: dict) -> None:
        """Rebuild the rating state = base + log[0, committed cursor).

        Only the STATE is replayed (dedup + upserts) — no solving; the
        factors came from the checkpoint.  New-user rows are pre-assigned
        from the committed order, so the rebuilt rows line up with the
        checkpointed factor rows regardless of how this replay chunks the
        log.  QUARANTINED offset ranges (poison batches whose offsets were
        consumed but whose writes never reached the state) are recorded in
        every commit and skipped here — the state must stay a pure function
        of the log MINUS the quarantine, or resume would re-apply the very
        writes the ladder rejected.
        """
        for i, raw in enumerate(meta.get("new_users", [])):
            self.state._new_user_rows[int(raw)] = self.state.num_base_users + i
            self.state._new_user_raw.append(int(raw))
        skip: dict[int, list[tuple[int, int]]] = {}
        for q in self.quarantined:
            for p, (qlo, qhi) in q.get("offsets", {}).items():
                skip.setdefault(int(p), []).append((int(qlo), int(qhi)))
        replay = StreamConsumer(
            self.transport, topic=self.stream.topic,
            cursors={p: 0 for p in cursors},
            gap_retries=self.stream.gap_retries,
            gap_wait_s=self.stream.gap_wait_s,
        )
        applied = 0
        for p, hi in sorted(cursors.items()):
            lo = 0
            while lo < hi:
                take = min(hi - lo, 1 << 14)
                values, _, _ = replay._collect_range(p, lo, lo + take)
                ranges = skip.get(p, ())
                values = [
                    v for i, v in enumerate(values)
                    if not any(qlo <= lo + i < qhi for qlo, qhi in ranges)
                ]
                pending = self.state.stage(
                    [decode_rating_update(v) for v in values]
                )
                if pending.new_user_raw:
                    raise ValueError(
                        "stream checkpoint's new-user list does not cover "
                        f"raw ids {pending.new_user_raw[:4]} found below "
                        "the committed cursor — store and log disagree"
                    )
                self.state.commit(pending)
                applied += pending.stats.fresh
                lo += take
        if self.state.num_users != int(meta.get("users",
                                                self.state.num_users)):
            raise ValueError(
                f"replayed state has {self.state.num_users} users, commit "
                f"recorded {meta.get('users')} — store and log disagree"
            )
        self.metrics.incr("replayed_updates", applied)

    # -- the loop ------------------------------------------------------------

    @property
    def user_factors(self) -> np.ndarray:
        return self._u

    @property
    def movie_factors(self) -> torch.Tensor:
        return self._movie_table()

    def model(self):
        """Current live factors as an ``ALSModel`` (serving view) on the
        session's device."""
        from cfk_tpu_torch.models.als import ALSModel

        return ALSModel(
            user_factors=torch.from_numpy(self._u.copy()).to(
                device=self.device, dtype=self._factor_dtype()),
            movie_factors=self._movie_table(),
            num_users=self.state.num_users,
            num_movies=self.state.num_movies,
        )

    def backlog(self) -> int:
        return self.consumer.backlog()

    def _grow_users(self, num_users: int) -> None:
        """Extend the user factor table for streamed-in new users."""
        need = num_users
        have = self._u.shape[0]
        if need <= have:
            return
        quantum = self.stream.grow_multiple
        target = ((need + quantum - 1) // quantum) * quantum
        grown = np.zeros((target, self._u.shape[1]), dtype=self._u.dtype)
        grown[:have] = self._u
        self._u = grown

    def _solve_pending(self, pending, overrides: Overrides):
        """Fold-in solve of one staged batch under the given overrides;
        returns (rows [T, k] f32, probe word int).  An out-of-core session
        solves against a staged window of its host movie store, and the
        probe reads that window (the rows the solve consumed)."""
        neighbor_data = [
            self.state.neighbors(row, pending.cell_writes.get(row))
            for row in pending.touched_rows
        ]
        with self.metrics.phase("foldin_solve"), \
                span("stream/batch/solve", touched=len(neighbor_data),
                     offload=int(self._offload)):
            if self._offload:
                from cfk_tpu_torch.streaming.foldin import (
                    fold_in_rows_windowed,
                )

                rows, m_probe = fold_in_rows_windowed(
                    self._m_store, neighbor_data, lam=overrides.lam,
                    solver=self.config.solver, pad_multiple=_PAD_MULTIPLE,
                    reg_solve_algo=overrides.reg_solve_algo,
                    stats=self._foldin_stats, return_staged=True,
                    device=self.device)
                solved = torch.from_numpy(rows).to(self.device)
                self.metrics.gauge(
                    "foldin_windows_staged",
                    self._foldin_stats.get("foldin_windows_staged", 0))
                self.metrics.gauge("foldin_staged_mb", round(
                    self._foldin_stats.get("foldin_staged_bytes", 0) / 1e6,
                    3))
            else:
                m_probe = self._m
                solved = fold_in_tensor(
                    self._m, neighbor_data,
                    lam=overrides.lam,
                    solver=self.config.solver,
                    layout=self._layout,
                    pad_multiple=_PAD_MULTIPLE,
                    fused_epilogue=overrides.fused_epilogue,
                    in_kernel_gather=self.config.in_kernel_gather,
                    reg_solve_algo=overrides.reg_solve_algo,
                )
                rows = solved.cpu().numpy()
        word = 0
        if self.health is not None and rows.shape[0]:
            with self.metrics.phase("health_check"), \
                    span("stream/batch/probe"):
                word = int(_sentinel.probe_word(solved, m_probe,
                                                self.health.norm_limit))
            self.metrics.incr("health_checks")
        return rows, word

    def prewarm(self, *, max_touched: int | None = None,
                max_width: int | None = None) -> dict:
        """Walk the padded fold-in's pow2 bucket grid up front.

        The solve shapes a live stream produces are bounded: touched users
        bucket to ``_pow2_ceil(t, 8)`` up to ``batch_records`` and
        rectangle widths to pow2 multiples of ``pad_multiple`` up to the
        heaviest neighbor list.  Walking that grid once with synthetic
        batches meets every fold-in program key (``foldin.trace_count``)
        a live stream would — the first build of a kernel and each shape's
        first allocations paid at startup, not against live updates.
        Results are discarded, so the stream's bits are untouched.

        Covers the PADDED fold layout (the micro-batch default).  Tiled
        fold-in block statics are data-dependent (chunk cuts follow the
        batch's actual neighbor lists), so a tiled-layout session returns
        ``{"skipped": ...}``.

        Returns ``{"programs", "new_traces", "prewarm_s"}``; a first real
        batch inside the warmed grid afterwards adds no program key."""
        with span("stream/prewarm"):
            return self._prewarm_impl(max_touched=max_touched,
                                      max_width=max_width)

    def _prewarm_impl(self, *, max_touched: int | None = None,
                      max_width: int | None = None) -> dict:
        t0 = time.time()
        if self._offload or self._layout != "padded":
            note = ("skipped: offload fold-in programs key on the staged "
                    "window's row count, which each batch sets"
                    if self._offload else
                    "skipped: tiled fold-in block statics are "
                    "data-dependent")
            self.metrics.note("prewarm", note)
            return {"programs": 0, "new_traces": 0, "prewarm_s": 0.0,
                    "skipped": note}
        mt = max(int(max_touched or self.stream.batch_records), 1)
        if max_width is None:
            counts = np.asarray(self.dataset.user_blocks.count)
            max_width = max(int(counts.max()) if counts.size else 1, 1)
        widths = []
        p = _pow2_ceil(1, _PAD_MULTIPLE)
        while True:
            widths.append(p)
            if p >= max_width:
                break
            p *= 2
        ents = []
        e = _pow2_ceil(1, 8)
        while True:
            ents.append(e)
            if e >= mt:
                break
            e *= 2
        before = trace_count()
        programs = 0
        num_m = int(self._m.shape[0])
        for e in ents:
            for p in widths:
                # One user at the full width pins the rectangle to
                # exactly (e, p); movie rows are valid table rows,
                # ratings zero — the solved values are discarded.
                wide = (np.minimum(np.arange(p), num_m - 1)
                        .astype(np.int32),
                        np.zeros(p, np.float32))
                thin = (np.zeros(1, np.int32), np.zeros(1, np.float32))
                fold_in_rows(
                    self._m, [wide] + [thin] * (e - 1),
                    lam=self._overrides.lam,
                    solver=self.config.solver,
                    layout="padded",
                    pad_multiple=_PAD_MULTIPLE,
                    fused_epilogue=self._overrides.fused_epilogue,
                    in_kernel_gather=self.config.in_kernel_gather,
                    reg_solve_algo=self._overrides.reg_solve_algo,
                )
                programs += 1
        out = {
            "programs": programs,
            "new_traces": trace_count() - before,
            "prewarm_s": round(time.time() - t0, 4),
        }
        self.metrics.gauge("prewarm_programs", programs)
        self.metrics.gauge("prewarm_new_traces", out["new_traces"])
        self.metrics.gauge("prewarm_s", out["prewarm_s"])
        return out

    def _user_table(self):
        """The user table as a commit stores it: the host float32 table,
        or a bfloat16 tensor of it for a bfloat16 session (the manifest
        then records bfloat16, as the reference's does)."""
        if self._factor_dtype() == torch.float32:
            return self._u
        return torch.from_numpy(self._u).to(self._factor_dtype())

    def _commit(self, note: str | None = None) -> None:
        meta = {
            "model": _STREAM_MODEL,
            "rank": int(self.config.rank),
            "num_shards": 1,
            "stream_step": self.stream_step,
            "offsets": {str(p): int(o)
                        for p, o in self.consumer.cursors.items()},
            "batch_records": self.stream.batch_records,
            "seq_high": int(self.state.applied_seq_high),
            "base_users": self.state.num_base_users,
            "users": self.state.num_users,
            "new_users": [int(r) for r in self.state._new_user_raw],
            # poison ranges whose offsets are consumed but whose writes
            # must never be re-applied — crash replay skips them
            "quarantined": self.quarantined,
            # the sticky escalation state: post-resume batches must solve
            # under the same overrides an uninterrupted run would have
            # used, or replay is no longer bit-identical (a stream that
            # needed λ·10 once needs it after the crash too)
            "overrides": {
                "lam": float(self._overrides.lam),
                "fused_epilogue": self._overrides.fused_epilogue,
                "reg_solve_algo": self._overrides.reg_solve_algo,
            },
        }
        if note:
            meta["note"] = note
        with self.metrics.phase("commit"), \
                span("stream/batch/commit", step=self.stream_step):
            save_checkpoint(self.manager, self.stream_step,
                            self._user_table(), self._movie_table(),
                            meta=meta)
        self.metrics.incr("stream_commits")
        record_event("stream", "commit", step=self.stream_step,
                     note=note or "")

    def add_commit_listener(self, fn) -> None:
        """Subscribe ``fn(event: dict)`` to every durable commit.

        The event carries COPIES (never views of this session's mutable
        state): ``touched_rows`` + ``rows`` [T, k] f32 (the freshly solved
        factor rows), ``cells`` [(user_row, movie_row), ...] (the rated
        cells the batch applied), ``num_users``, ``stream_step``; a warm
        retrain instead fires ``retrain=True`` with full ``user_factors``/
        ``movie_factors`` snapshots.  Fired AFTER the factor+cursor commit
        is handed to the (async) writer — a request served after the
        listener returns reflects the folded-in factors."""
        self._commit_listeners.append(fn)

    def _fire_commit(self, event: dict) -> None:
        event.setdefault("stream_step", self.stream_step)
        event.setdefault("num_users", self.state.num_users)
        for fn in self._commit_listeners:
            # A listener failure must not poison the commit that already
            # happened, nor starve the OTHER listeners (a broken serving
            # subscriber taking down the training stream would invert the
            # dependency) — record it loudly and keep going.
            try:
                fn(event)
            except Exception as e:
                self.metrics.incr("commit_listener_errors")
                record_event(
                    "stream", "commit_listener_error",
                    step=self.stream_step,
                    listener=getattr(fn, "__qualname__", repr(fn)),
                    error=f"{type(e).__name__}: {e}",
                )

    def step(self) -> dict | None:
        """Process ONE micro-batch; returns its summary, or None when
        caught up with the log."""
        batch = self.consumer.poll(self.stream.batch_records)
        if batch is None:
            return None
        with span("stream/batch", step=self.stream_step + 1,
                  records=batch.num_records):
            return self._step_batch(batch)

    def _step_batch(self, batch) -> dict:
        with self.metrics.phase("stage"), \
                span("stream/batch/stage", records=batch.num_records):
            pending = self.state.stage(batch.updates)
        self.metrics.incr("updates_fresh", pending.stats.fresh)
        self.metrics.incr("updates_stale", pending.stats.stale)
        self.metrics.incr("updates_unknown_movie", pending.stats.unknown_movie)
        if batch.duplicates_dropped:
            self.metrics.incr("delivery_duplicates", batch.duplicates_dropped)
            record_event("stream", "delivery_duplicates_dropped",
                         step=self.stream_step + 1,
                         duplicates=batch.duplicates_dropped)
        if batch.gap_repolls:
            self.metrics.incr("delivery_gap_repolls", batch.gap_repolls)
            record_event("stream", "delivery_gap_repolls",
                         step=self.stream_step + 1,
                         repolls=batch.gap_repolls)
        summary = {
            "records": batch.num_records,
            "fresh": pending.stats.fresh,
            "stale": pending.stats.stale,
            "touched_users": len(pending.touched_rows),
            "new_users": pending.stats.new_users,
            "quarantined": False,
            "trips": 0,
        }
        if pending.touched_rows:
            overrides = self._overrides
            trips = 0
            while True:
                rows, word = self._solve_pending(pending, overrides)
                if not word:
                    break
                trips += 1
                summary["trips"] = trips
                self.metrics.incr("health_trips")
                report = _sentinel.HealthReport(
                    iteration=self.stream_step + 1, word=word, stats={}
                )
                self.metrics.note(
                    f"stream_trip_{self.stream_step + 1}_{trips}",
                    report.summary(),
                )
                record_event("fault", "stream_trip",
                             step=self.stream_step + 1, trip=trips,
                             reason=report.summary())
                dump_flight(f"stream_trip_{self.stream_step + 1}_{trips}")
                if trips > self.policy.max_recoveries:
                    # The whole ladder lost: quarantine the batch — its
                    # offsets are consumed (a poison pill must not wedge
                    # the stream) but neither the factors nor the rating
                    # state ever see its writes.
                    msg = (
                        f"stream batch at step {self.stream_step + 1} "
                        f"defeated the recovery ladder ({report.summary()}); "
                        f"offsets {batch.cursors_before} → "
                        f"{batch.cursors_after} quarantined"
                    )
                    record_event("fault", "quarantine",
                                 step=self.stream_step + 1,
                                 reasons=report.reasons, detail=msg)
                    dump_flight("quarantine")
                    if self.policy.on_unrecoverable == "raise":
                        raise PoisonedBatchError(msg)
                    self.quarantined.append({
                        "stream_step": self.stream_step + 1,
                        "offsets": {str(p): [batch.cursors_before[p],
                                             batch.cursors_after[p]]
                                    for p in batch.cursors_after},
                        "reasons": report.reasons,
                    })
                    self.metrics.incr("quarantined_batches")
                    self.metrics.note("quarantined", msg)
                    warnings.warn(msg)
                    summary["quarantined"] = True
                    pending = None
                    break
                # Rollback is free — nothing was committed — so a retry is
                # one escalation rung up (λ bump → split epilogue → GJ),
                # sticky for the rest of the session exactly like the
                # training ladder (a stream that needed λ·10 once will
                # need it again).
                new_overrides = self.policy.escalate(self._overrides,
                                                     trips + 1)
                if new_overrides != overrides:
                    overrides = new_overrides
                    self._overrides = new_overrides
                    self.metrics.gauge("stream_escalation_level", trips)
                    self.metrics.note(
                        f"stream_escalation_{trips}",
                        f"lam={overrides.lam:g} "
                        f"fused={overrides.fused_epilogue} "
                        f"algo={overrides.reg_solve_algo}",
                    )
                    record_event("fault", "stream_escalation", rung=trips,
                                 lam=overrides.lam)
            if pending is not None:
                self.state.commit(pending)
                self._grow_users(self.state.num_users)
                if pending.touched_rows:
                    self._u[np.asarray(pending.touched_rows)] = (
                        self._stored(rows)
                    )
        self.stream_step += 1
        self._commit()
        if pending is not None and pending.touched_rows:
            # publish the COMMITTED representation — read back from the
            # factor table AFTER the dtype cast, so a bf16-dtype session's
            # listeners cache exactly what a post-crash engine would
            # restore from the checkpoint (not the pre-cast f32 solve)
            touched_idx = np.asarray(pending.touched_rows)
            self._fire_commit({
                "touched_rows": [int(r) for r in pending.touched_rows],
                "rows": np.array(self._u[touched_idx], np.float32),
                "cells": [
                    (int(row), int(mv))
                    for row, overlay in pending.cell_writes.items()
                    for mv in overlay
                ],
                "retrain": False,
            })
        summary["stream_step"] = self.stream_step
        if (self.stream.retrain_every is not None
                and self.stream_step % self.stream.retrain_every == 0):
            self.retrain()
        return summary

    def run(self, *, max_batches: int | None = None, follow: bool = False,
            before_batch=None):
        """Drain (or follow) the updates topic; returns the live model.

        ``follow=True`` keeps polling an idle topic until ``max_batches``
        or eviction; the default drains until caught up.  ``before_batch``
        (chaos/testing hook) is called with the upcoming stream step before
        every poll — fault injectors deliver signals or kill the process
        there, the boundary at which a real eviction lands.
        """
        batches = 0
        try:
            while True:
                if self.guard is not None and self.guard.triggered:
                    self._evict()
                    break
                if max_batches is not None and batches >= max_batches:
                    break
                if before_batch is not None:
                    before_batch(self.stream_step)
                    if self.guard is not None and self.guard.triggered:
                        self._evict()
                        break
                got = self.step()
                if got is None:
                    if not follow:
                        break
                    time.sleep(self.stream.poll_wait_s)
                    continue
                batches += 1
        finally:
            # Same exit contract as the training loop: only committed
            # steps are left behind for the next reader.
            drain_checkpoints(self.manager)
        return self.model()

    def _evict(self) -> None:
        """Eviction: the last commit already carries the cursor — drain
        the writer so it is durably on disk, then return resumable."""
        drain_checkpoints(self.manager)
        record_event("signal", "stream_evicted", step=self.stream_step,
                     signal=self.guard.signal_name)
        dump_flight("stream_eviction")
        self.metrics.gauge("preempted", 1)
        self.metrics.note(
            "preempted",
            f"{self.guard.signal_name} at stream step {self.stream_step}; "
            "offset cursor committed and drained — re-run to resume",
        )

    # -- warm retrain --------------------------------------------------------

    def retrain(self, num_iterations: int | None = None) -> None:
        """Warm full retrain on the merged state, current factors as seed.

        Rebuilds the dataset from base + every committed upsert and runs
        the resilient stepped training loop (``train_als(warm_start=...)``)
        — the movie side finally sees the streamed ratings.  The retrained
        factors are permuted back into the session's row order (streamed-in
        users keep their appended rows, so crash replay still lines up)
        and committed with the unchanged cursor.
        """
        from cfk_tpu_torch.data.blocks import Dataset
        from cfk_tpu_torch.models.als import train_als

        if self._offload:
            raise NotImplementedError(
                "warm full retrain in an offload_tier='host_window' session "
                "needs warm_start threading through the windowed trainer "
                "(cfk_tpu/streaming/session.py:869) — run the retrain "
                "offline and bootstrap a fresh session from its model")
        with self.metrics.phase("retrain_build"):
            coo = self.state.to_coo()
            ds2 = Dataset.from_coo(
                coo,
                pad_multiple=_PAD_MULTIPLE,
                layout=self._train_layout,
                chunk_elems=self.config.chunk_cells(),
                dense_stream=self._train_layout == "tiled",
            )
        if not np.array_equal(ds2.movie_map.raw_ids,
                              self.dataset.movie_map.raw_ids):
            raise RuntimeError(
                "merged state changed the movie universe — unknown movies "
                "are supposed to be rejected at apply time"
            )
        raw_users = self.state.user_raw_ids()
        perm = ds2.user_map.to_dense(raw_users)  # ds2 row per session row
        # Seed ds2's row order from the live factors.
        k = self.config.rank
        u_seed = np.zeros((ds2.user_blocks.padded_entities, k), np.float32)
        u_seed[perm] = self._u[: self.state.num_users]
        rows_m = ds2.movie_blocks.padded_entities
        m_seed = np.zeros((rows_m, k), np.float32)
        m_host = _host_f32(self._m)[:rows_m]
        m_seed[: m_host.shape[0]] = m_host
        cfg = self.config
        if num_iterations is not None:
            cfg = dataclasses.replace(cfg, num_iterations=num_iterations)
        with self.metrics.phase("retrain"):
            model = train_als(
                ds2, cfg, device=self.device, metrics=self.metrics,
                warm_start=(u_seed, m_seed),
                preemption_guard=self.guard,
            )
        # Back into session row order; new users keep their appended rows.
        u2 = _host_f32(model.user_factors)
        u_sess = np.zeros_like(self._u)
        u_sess[: self.state.num_users] = u2[perm]
        self._u = self._stored(u_sess)
        self._set_movie(model.movie_factors)
        self.metrics.incr("stream_retrains")
        self._commit(note=f"warm retrain at step {self.stream_step}")
        self._fire_commit({
            "retrain": True,
            "user_factors": np.array(self._u, np.float32),
            "movie_factors": _host_f32(self._m),
        })
