"""Run configuration: the subset of ``cfk_tpu.config.ALSConfig`` the port
trains with, with the same defaults and the same validation messages."""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    """Hyper-parameters + execution layout for an ALS-WR run.

    Mirrors the reference CLI surface (``apps/ALSAppRunner.java:16-28``):
    NUM_FEATURES → ``rank``, LAMBDA → ``lam``, NUM_ITERATIONS →
    ``num_iterations``; entity counts come from the data.
    """

    rank: int = 5
    lam: float = 0.05
    num_iterations: int = 7
    seed: int = 42
    # Sharded training (``parallel.spmd``): entity rows block-sharded over
    # ``num_shards`` ranks; ``exchange`` moves the fixed side between them —
    # "all_gather" (every rank receives the whole table), "ring" (blocks
    # rotate around the ranks, the block-to-block join), "hier_ring" (rings
    # of ``ici_group`` ranks inside one ring of groups, tiled layout) or
    # "auto" (per half, as the tiled blocks were built).
    num_shards: int = 1
    exchange: Literal["all_gather", "ring", "hier_ring", "auto"] = \
        "all_gather"
    ici_group: int | None = None
    # The row quantum of the padded layout's ring blocks, which the sharded
    # trainer builds itself (``cfk_tpu/config.py:314``, read at
    # ``cfk_tpu/parallel/spmd.py:1394``): the value the Dataset was built
    # with — the CLI passes its one ``--pad-multiple`` to both.
    pad_multiple: int = 8
    # Storage dtype of the factor matrices: "bfloat16" halves their memory;
    # each half-step's Gram and solve still run float32 (the solved rows are
    # rounded to bf16 when stored), and a bf16 table is gathered as bf16
    # operands with float32 sums (``ops.solve.gram_compute_dtype``).
    dtype: Literal["float32", "bfloat16"] = "float32"
    # Gather-table dtype (``ops.quant``): the fixed-side table each
    # half-iteration gathers from is stored "float32" (the identity),
    # "bfloat16" (half the gather bytes) or "int8" (a quarter, plus one f32
    # scale per row, folded into the kernels' premultiply weight).  Gram and
    # solve accumulate float32 for every choice, and the solved factors keep
    # ``dtype``.  int8 needs the per-row scale threaded through a weight
    # stream, which the tiled and bucketed layouts (and the subspace sweeps
    # on them) have; padded/segment take float32/bfloat16 only.
    table_dtype: Literal["float32", "bfloat16", "int8"] = "float32"
    # InBlock layout: "padded" (one rectangle per side), "bucketed"
    # (power-of-two width classes), "segment" (flat sorted runs in nnz
    # chunks, entities straddling chunks: exactly O(nnz) memory for any
    # skew), "tiled" (accum + dense stream), "auto" (resolved by whoever
    # builds the Dataset; the trainer follows the blocks).
    layout: Literal["auto", "padded", "bucketed", "segment", "tiled"] = \
        "padded"
    # "auto": the CUDA kernels on a GPU, their plain PyTorch versions on
    # the CPU.  "cholesky": the plain PyTorch route (torch.linalg.cholesky
    # solves, einsum Grams), CPU only — train_als raises for it on CUDA.
    solver: Literal["auto", "cholesky"] = "auto"
    # Gather-cell budget (rows × width ≈ ratings per chunk).  padded:
    # entities per solve chunk = hbm_chunk_elems // rectangle width; tiled:
    # consumed at build time (Dataset.from_coo(chunk_elems=...)).
    hbm_chunk_elems: int | None = None
    # DEPRECATED: entities per padded-layout solve chunk, overriding the
    # one derived from hbm_chunk_elems (the JAX package's alias).
    solve_chunk: int | None = None
    # The fused reg+solve route's name, as in cfk_tpu: "lu" (and "auto",
    # which means "lu" here) keeps every system up to k = 128 on the fused
    # kernels (K1, K3, K6, rows 6, 7); "gj" caps them at k = 64, so
    # 64 < k <= 128 takes the split schedule (the blocked Schur solve over
    # rows 11 and 12), as the reference's Gauss-Jordan cap routes it
    # (``ops.solve.fused_rank_cap``).  The port has one elimination, the
    # blocked Cholesky of ``csrc/spd_solve.cuh``, under both names: the
    # name picks the route, not an elimination order.
    reg_solve_algo: Literal["auto", "lu", "gj"] = "auto"
    # Per-entity optimizer.  "als" = the full k×k normal-equation solve
    # every half-iteration; "als++" = warm-started subspace block
    # coordinate descent (``ops.subspace``): ``sweeps`` passes over
    # rank/block_size coordinate blocks, each a b×b solve per entity.
    # padded/bucketed layouts only.
    algorithm: str = "als"
    block_size: int = 32
    sweeps: int = 1
    # Fused Gram+solve epilogue.  None = the process default (on: K3 per
    # dense-stream chunk, K6 per stream chunk and per bucketed width class,
    # K1 on the accum side's accumulator and in the subspace sweeps).
    # False pins the split schedule: each tiled chunk's (A, b) goes to
    # device memory (dense stream: the split Gram kernel; stream: K2) and
    # K1 solves it; the accum side's final solve becomes the ridge add +
    # split solve dispatch (``ops.solve.dispatch_spd_solve``); each
    # bucketed width class's (A, b) goes to memory through K2 (or K5 and
    # gram_tiles) and K1 solves it; the ALS++/iALS++ sweeps' b×b solves
    # become the ridge add + dispatch.  The padded ALS/iALS half-steps
    # always solve with K1, as the JAX package's do
    # (``cfk_tpu/models/als.py:251-276``, ``cfk_tpu/ops/bucketed.py:
    # 101-131``).
    fused_epilogue: bool | None = None
    # Neighbor gather of the tiled and bucketed half-steps.  None/True =
    # inside the Gram kernels (each reads the fixed table by index: K2, K3,
    # K6, gram_tiles_dense_gather).  False pins the materialized-stream
    # schedule (``ops.tiled.resolve_gather_mode``): K5 writes each chunk's
    # (or width class's) gathered stream [C, k] to device memory and the
    # stream twins read it (gram_tiles, gram_solve_tiles, gram_tiles_dense,
    # gram_solve_tiles_dense) — the other side of the JAX package's A/B
    # switch (``cfk_tpu/config.py:238-252``).  The subspace sweeps
    # materialize their rectangle with K5 on either setting.
    in_kernel_gather: bool | None = None
    # The chunk pipeline (``ops.pipeline``), the default: every chunk scan
    # and bucket walk is a ``prefetch_scan``, and with the gather off each
    # chunk's K5 stream is written on a side stream while the previous
    # chunk's Gram runs.  False pins the serial schedule (one stream, no
    # capture) — the A/B baseline of ``train --no-overlap``.  Factors are
    # bit-identical either way.
    # The reference's ring overlap, its ``apply_overlap_xla_flags`` and the
    # async collective permute have no counterpart until the port trains
    # on several cards.
    overlap: bool = True
    # With ``overlap`` on, on a card, for two or more iterations: replay
    # one captured iteration (a CUDA graph, ``ops.pipeline.CapturedStep``)
    # after an eager first one, so the host issues nothing per chunk.  Off
    # by default: on an H100 a replay saves at most 7% of an iteration
    # (iALS++, whose sweeps the host issues) and the capture costs 0.04-0.4
    # s (10 s on the segment layout), so no route gained at 7 iterations
    # and iALS++ broke even at 15 (PERF.md §6; ``tools/pipeline_ab.py``).
    capture: bool = False
    # --- self-healing (``cfk_tpu_torch.resilience``) ----------------------
    # Numerical-health sentinel cadence: probe the factor state (all
    # finite, max row norm; O(E·k)) every N completed iterations and at the
    # last.  None disables it.  The eager stepped loop fetches the probe
    # word on this cadence only; the other routes fold it into a device
    # word (inside the captured iteration too) read once after the loop.
    health_check_every: int | None = None
    # Factor-row 2-norm above which the watchdog trips although every value
    # is still finite (the slow blow-up that precedes overflow).
    health_norm_limit: float = 1e6
    # Recovery ladder bounds (``resilience.policy``): total sentinel trips
    # tolerated before the run stops retrying; each trip rolls back to the
    # last good state and climbs one rung (retry → λ×lam_escalation → split
    # epilogue → "gj" route; the default of 4 reaches the whole ladder).
    max_recoveries: int = 4
    lam_escalation: float = 10.0
    # When retries are exhausted: "degrade" returns the last-good factors
    # with a diagnostic report in the metrics, "raise" raises
    # ``TrainingDivergedError``.
    on_unrecoverable: Literal["degrade", "raise"] = "degrade"
    # --- out-of-core factor tables (``cfk_tpu_torch.offload``) ------------
    # Where the factor tables live during training
    # (``cfk_tpu/config.py:386-402``):
    #   "auto"        — resident while both tables + blocks fit the device
    #                   (``offload.budget.fits_device`` at the card's own
    #                   memory size), host_window past it;
    #   "device"      — pin the resident tables;
    #   "host_window" — pin the out-of-core path: host-RAM factor stores,
    #                   windows of the fixed side staged to the card
    #                   (``offload.windowed``: explicit ALS on the tiled
    #                   layout, iALS/iALS++ on the bucketed one; the same
    #                   bits as the resident trainers).
    offload_tier: Literal["auto", "device", "host_window"] = "auto"
    # The host staging engine of the host_window tier: "auto"/"pool" stages
    # every shard's windows ahead of consumption on a bounded thread pool,
    # "serial" is the one-thread double buffer (the A/B baseline).  The
    # same factors either way.
    staging: Literal["auto", "pool", "serial"] = "auto"
    # Windows staged ahead of consumption (pool mode); None =
    # ``offload.staging.DEFAULT_POOL_DEPTH``, always clamped so depth+1
    # worst-case windows fit the window budget.
    staging_pool_depth: int | None = None
    # The skew-aware hot-row device cache: None = auto (the coverage-curve
    # knee of the window plans' reference counts, clamped by the budget
    # headroom), 0 = off (full staging), >= 1 = the pinned total resident
    # rows of both sides (an impossible one raises).  The same factors
    # whatever the value; only the staged bytes change.
    hot_rows: int | None = None

    def _valid_algorithms(self) -> tuple[str, ...]:
        return ("als", "als++")

    def _check_host_window(self) -> None:
        """The explicit family's ``offload_tier='host_window'`` gate
        (``cfk_tpu/config.py:474-492``): explicit ALS on the tiled layout
        (the windowed stream and ring scans); ``IALSConfig`` overrides it
        for the bucketed width-class windows."""
        if self.layout != "tiled":
            raise ValueError(
                f"offload_tier='host_window' streams the tiled "
                f"stream-mode layout; layout={self.layout!r}"
            )
        if self.algorithm != "als":
            raise ValueError(
                "offload_tier='host_window' supports the explicit ALS "
                f"optimizer at layout='tiled'; algorithm="
                f"{self.algorithm!r} (the subspace als++ windowed walk "
                "is the documented follow-up — the implicit family's "
                "iALS/iALS++ run out-of-core via IALSConfig)"
            )

    def _check_offload(self) -> None:
        """The out-of-core fields' rules (``cfk_tpu/config.py:579-608``)."""
        if self.offload_tier not in ("auto", "device", "host_window"):
            raise ValueError(
                f"offload_tier must be 'auto', 'device' or 'host_window', "
                f"got {self.offload_tier!r}"
            )
        if self.staging not in ("auto", "pool", "serial"):
            raise ValueError(
                f"staging must be 'auto', 'pool' or 'serial', got "
                f"{self.staging!r}"
            )
        if self.staging_pool_depth is not None and \
                self.staging_pool_depth < 1:
            raise ValueError(
                f"staging_pool_depth must be >= 1 (windows staged ahead "
                f"of consumption), got {self.staging_pool_depth}; use "
                "staging='serial' for the unpooled baseline"
            )
        if self.hot_rows is not None and self.hot_rows < 0:
            raise ValueError(
                f"hot_rows must be None (auto), 0 (off) or a positive "
                f"total resident row count, got {self.hot_rows}"
            )
        if self.offload_tier == "host_window":
            self._check_host_window()

    def _check_sharding(self) -> None:
        """The exchange rules of ``cfk_tpu/config.py:556-620, :708``."""
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {self.num_shards}")
        if self.exchange not in ("all_gather", "ring", "hier_ring", "auto"):
            raise ValueError(f"unknown exchange {self.exchange!r}")
        if self.exchange == "hier_ring" and self.layout != "tiled":
            raise ValueError(
                f"exchange='hier_ring' is implemented for layout='tiled' "
                f"(the ring-built tiled blocks); layout={self.layout!r}")
        if self.ici_group is not None:
            if self.ici_group < 1:
                raise ValueError(
                    f"ici_group must be >= 1 (devices per inner ring), "
                    f"got {self.ici_group}")
            if self.num_shards % self.ici_group != 0:
                raise ValueError(
                    f"ici_group={self.ici_group} must divide "
                    f"num_shards={self.num_shards} (the outer ring walks "
                    "whole inner rings)")
        if self.layout not in ("auto", "padded", "tiled") and \
                self.exchange == "ring":
            raise ValueError(
                f"layout={self.layout!r} supports exchange='all_gather' only")
        if self.exchange == "auto" and self.layout not in ("auto", "tiled"):
            raise ValueError(
                "exchange='auto' (per-half ring/all_gather selection) "
                f"applies to layout='tiled'; layout={self.layout!r} should "
                "pick 'all_gather' or 'ring' explicitly")
        if self.algorithm not in ("als", "ials") and \
                self.exchange != "all_gather":
            raise ValueError(
                f"{self.algorithm} supports exchange='all_gather' only")

    def chunk_cells(self) -> int:
        """The build-time gather-cell budget (1M cells when unset)."""
        return 1 << 20 if self.hbm_chunk_elems is None else self.hbm_chunk_elems

    def padded_solve_chunk(self, width: int) -> int | None:
        """Entities per padded-layout solve chunk under the cell budget (the
        deprecated explicit ``solve_chunk`` wins when set); None = solve the
        whole side at once."""
        if self.solve_chunk is not None:
            return self.solve_chunk
        if self.hbm_chunk_elems is None:
            return None
        return max(1, self.hbm_chunk_elems // max(width, 1))

    def __post_init__(self) -> None:
        if self.fused_epilogue not in (None, True, False):
            raise ValueError(
                f"fused_epilogue must be None/True/False, got "
                f"{self.fused_epilogue!r}"
            )
        if self.in_kernel_gather not in (None, True, False):
            raise ValueError(
                f"in_kernel_gather must be None/True/False, got "
                f"{self.in_kernel_gather!r}"
            )
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"dtype must be 'float32' or 'bfloat16', got {self.dtype!r}")
        if self.table_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"table_dtype must be 'float32', 'bfloat16' or 'int8', "
                f"got {self.table_dtype!r}"
            )
        if self.table_dtype == "int8" and self.layout not in (
            "tiled", "bucketed"
        ):
            # ops.quant.validate_table_dtype_layout's refusal, kept inline
            # as in cfk_tpu/config.py.
            raise ValueError(
                f"table_dtype='int8' supports layout='tiled'/'bucketed' "
                f"(the per-row scale rides their weight streams); "
                f"layout={self.layout!r} should use 'bfloat16' or 'float32'"
            )
        if self.reg_solve_algo not in ("auto", "lu", "gj"):
            raise ValueError(
                f"reg_solve_algo must be 'auto', 'lu' or 'gj', got "
                f"{self.reg_solve_algo!r}"
            )
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        if self.num_iterations < 1:
            raise ValueError(f"num_iterations must be >= 1, got {self.num_iterations}")
        if self.lam < 0:
            raise ValueError(f"lam must be >= 0, got {self.lam}")
        self._check_sharding()
        self._check_offload()
        if self.solver not in ("auto", "cholesky"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.layout not in ("auto", "padded", "bucketed", "segment",
                               "tiled"):
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.hbm_chunk_elems is not None and self.hbm_chunk_elems < 1:
            raise ValueError(
                f"hbm_chunk_elems must be >= 1, got {self.hbm_chunk_elems}"
            )
        if self.layout not in ("auto", "padded") and \
                self.solve_chunk is not None:
            raise ValueError(
                f"solve_chunk (deprecated) applies to layout='padded' "
                f"only; use hbm_chunk_elems — one budget for every layout "
                f"(build-time layouts consume it via Dataset.from_coo(..., "
                "chunk_elems=cfg.chunk_cells()), which the CLI's "
                "--chunk-elems does)"
            )
        if self.health_check_every is not None and self.health_check_every < 1:
            raise ValueError(
                f"health_check_every must be >= 1 (iterations between "
                f"sentinel probes), got {self.health_check_every}; use "
                "health_check_every=None to disable the health sentinel"
            )
        if self.health_norm_limit <= 0:
            raise ValueError(
                f"health_norm_limit must be > 0 (a factor-row 2-norm "
                f"bound), got {self.health_norm_limit}"
            )
        if self.max_recoveries < 0:
            raise ValueError(
                f"max_recoveries must be >= 0, got {self.max_recoveries}"
            )
        if self.lam_escalation <= 1:
            raise ValueError(
                f"lam_escalation must be > 1 (it multiplies λ on "
                f"escalation), got {self.lam_escalation}"
            )
        if self.on_unrecoverable not in ("degrade", "raise"):
            raise ValueError(
                f"on_unrecoverable must be 'degrade' or 'raise', got "
                f"{self.on_unrecoverable!r}"
            )
        if self.algorithm not in self._valid_algorithms():
            raise ValueError(
                f"unknown algorithm {self.algorithm!r} for "
                f"{type(self).__name__}; valid: {self._valid_algorithms()}"
            )
        if self.algorithm != "als":
            if self.layout in ("segment", "tiled"):
                raise ValueError(
                    f"{self.algorithm} supports the padded and bucketed "
                    f"layouts (bucketed is the at-scale one); the "
                    f"{self.layout} layout's chunk-straddling entities "
                    "would need cross-chunk score updates — use "
                    "layout='bucketed'"
                )
            if self.rank % self.block_size != 0:
                raise ValueError(
                    f"rank {self.rank} not divisible by block_size "
                    f"{self.block_size}"
                )
            if self.sweeps < 1:
                raise ValueError(f"sweeps must be >= 1, got {self.sweeps}")
            if self.solve_chunk is not None:
                raise ValueError(
                    f"solve_chunk is not honored by {self.algorithm} (the "
                    "subspace sweep has no entity-chunked padded path); use "
                    "layout='bucketed' with chunk_elems to bound HBM"
                )
