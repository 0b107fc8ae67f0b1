"""Explicit-feedback ALS-WR — the flagship model, on one device.

The port of ``cfk_tpu/models/als.py``'s fused-loop route, with the
reference's semantics (``apps/ALSApp.java:115-151``):

  - init user factors: avg-rating + U(0,1) (``processors/UFeatureInitializer.java:50-56``)
  - per iteration: solve movies from users, then users from movies
  - prediction P = U·Mᵀ, rows = users ascending id, cols = movies ascending id.

``lax.fori_loop`` becomes the iteration loop of ``run_iterations``: a
Python loop, or, on a card with ``ALSConfig.capture``, iteration 1 eager
and one captured iteration (a CUDA graph, ``ops.pipeline.CapturedStep``)
replayed for the rest; the reference's stepped loop is ``resilience.loop``
(``train_loop`` routes between them).  Every half-step runs on ``device`` through the kernels of
``ops.kernels`` (CUDA) or their plain versions (CPU).  ``ALSConfig.dtype``
is the factors' storage dtype (bf16: each solved half rounded to bf16, the
next half gathering bf16 rows — ``cfk_tpu/models/als.py:452-476``),
``table_dtype`` the gather table's (``ops.quant``) and ``reg_solve_algo``
the fused route's rank cap; all three reach every half-step as in the
reference's ``_half``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cfk_tpu_torch.config import ALSConfig
from cfk_tpu_torch.data.blocks import (
    BucketedBlocks,
    Dataset,
    PaddedBlocks,
    SegmentBlocks,
    TiledBlocks,
)
from cfk_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from cfk_tpu_torch.ops.kernels.gram_units import (
    chunk_plan,
    derive_dense_units,
    derive_tile_units,
    stage_plans,
)
from cfk_tpu_torch.ops.quant import gather_operand_view
from cfk_tpu_torch.ops.solve import (
    als_half_step,
    als_half_step_bucketed,
    als_half_step_segment,
    init_factors,
    init_factors_stats,
    use_kernels,
)
from cfk_tpu_torch.ops.subspace import (
    als_pp_half_step,
    als_pp_half_step_bucketed,
)
from cfk_tpu_torch.ops.tiled import chunk_reg, tiled_half_step


@dataclasses.dataclass(frozen=True)
class ALSModel:
    """Trained factor matrices (rows = ascending external id order)."""

    user_factors: torch.Tensor  # [num_users, k]
    movie_factors: torch.Tensor  # [num_movies, k]
    num_users: int
    num_movies: int
    # How the trainer ran its iterations (``run_iterations``): the route
    # ("captured", "prefetched", "serial"), why, and a capture's seconds.
    pipeline: dict = dataclasses.field(default_factory=dict, compare=False)

    def host_factors(self) -> tuple[np.ndarray, np.ndarray]:
        """float32 host copies of (U, M), fetched from the device once."""
        return self._host_factors

    @functools.cached_property
    def _host_factors(self) -> tuple[np.ndarray, np.ndarray]:
        # float32 first: numpy has no bfloat16 (a bf16 model's values are
        # exact in float32).
        u = self.user_factors[: self.num_users].detach().float().cpu()
        m = self.movie_factors[: self.num_movies].detach().float().cpu()
        return u.numpy(), m.numpy()

    def predict_dense(self, *, allow_huge: bool = False) -> np.ndarray:
        """Dense prediction matrix P = U·Mᵀ, [num_users, num_movies].

        Refuses matrices over ~4e9 cells (16 GB float32) unless
        ``allow_huge``: at full-Netflix scale the dense matrix cannot be
        materialized (the reference's collector had the same ceiling).
        """
        cells = self.num_users * self.num_movies
        if cells > 4_000_000_000 and not allow_huge:
            raise ValueError(
                f"dense prediction matrix would be {self.num_users}×"
                f"{self.num_movies} = {cells:.2e} float32 cells; pass "
                "allow_huge=True if you really have the RAM"
            )
        u, m = self.host_factors()
        return u @ m.T

    def recommend_top_k(self, user_rows, k: int = 10, *, dataset=None,
                        chunk: int = 8192):
        """Top-K movie rows per user row; see ``eval.recommend``."""
        from cfk_tpu_torch.eval.recommend import recommend_top_k

        return recommend_top_k(self, user_rows, k, dataset=dataset,
                               chunk=chunk)


def _blocks_to_device(blocks: PaddedBlocks, device) -> dict[str, torch.Tensor]:
    return {
        "neighbor_idx": torch.as_tensor(blocks.neighbor_idx, device=device),
        "rating": torch.as_tensor(blocks.rating, device=device),
        "mask": torch.as_tensor(blocks.mask, device=device),
        "count": torch.as_tensor(blocks.count, device=device),
    }


def _class_plan(rows: int, width: int, device):
    """The Gram work-unit plan of ``rows`` entities of a width class, one
    tile per entity (``ops.bucketed``)."""
    seg = torch.arange(rows, dtype=torch.int32)
    return stage_plans(derive_tile_units(seg[None], width, rows), device)


def _bucketed_to_device(blocks: BucketedBlocks, device):
    """(tuple of per-bucket device dicts, per-bucket ``chunk_rows``).  Each
    dict also holds its width class's Gram work-unit plan (``units``,
    ``unit_splits``, ``unit_scratch``) and, for a class the blocks bound
    by ``chunk_rows``, the plan every ``chunk_rows`` piece shares
    (``piece_plan``, for the gather-off walk, ``ops.solve.bucket_plan``)."""
    trees, chunks = blocks.to_tree()
    out = []
    for tree, chunk in zip(trees, chunks):
        d = {key: torch.as_tensor(v, device=device)
             for key, v in tree.items()}
        rows, width = tree["neighbor"].shape
        d.update(_class_plan(rows, width, device))
        if chunk is not None and chunk < rows:
            d["piece_plan"] = chunk_plan(_class_plan(chunk, width, device), 0)
        out.append(d)
    return tuple(out), chunks


def _bucketed_device_setup(dataset: Dataset, device):
    """Device block trees of both bucketed halves and the static layout
    kwargs (``cfk_tpu/models/als.py:140``; one device, so no shard guard
    beyond the builder's default of one shard)."""
    mb, ub = dataset.movie_blocks, dataset.user_blocks
    mblocks, m_chunks = _bucketed_to_device(mb, device)
    ublocks, u_chunks = _bucketed_to_device(ub, device)
    layout_kw = dict(m_chunks=m_chunks, u_chunks=u_chunks,
                     m_entities=mb.padded_entities,
                     u_entities=ub.padded_entities)
    return mblocks, ublocks, layout_kw


SEGMENT_FIELDS = ("neighbor_idx", "rating", "mask", "seg_rel",
                  "chunk_entity", "chunk_count", "carry_in", "last_seg",
                  "group_sizes")


def _segment_to_device(blocks: SegmentBlocks, device) -> dict:
    """Device tensors of one segment half or of one rank's part of it
    (``parallel.spmd.shard_view``; ``cfk_tpu/models/als.py:116``) and every
    chunk's K2 work-unit plan over its flat run — one-row tiles
    owned by ``seg_rel`` (``ops.solve._segment_k2``); ``group_sizes`` (the
    entries of each chunk's segments) feeds only the bf16 iALS chunk Gram
    (``ops.solve.segment_gram_rounded``)."""
    d = {f: torch.as_tensor(getattr(blocks, f), device=device)
         for f in SEGMENT_FIELDS}
    nc, cap, e_c = blocks.statics
    d.update(stage_plans(derive_tile_units(d["seg_rel"].view(nc, cap), 1,
                                           e_c + 1), device))
    return d


def _segment_device_setup(dataset: Dataset, device):
    """Device dicts of both segment halves and the static layout kwargs
    (``cfk_tpu/models/als.py:222``)."""
    mb, ub = dataset.movie_blocks, dataset.user_blocks
    layout_kw = dict(m_chunks=mb.statics, u_chunks=ub.statics,
                     m_entities=mb.padded_entities,
                     u_entities=ub.padded_entities)
    return (_segment_to_device(mb, device), _segment_to_device(ub, device),
            layout_kw)


def _tiled_to_device(blocks: TiledBlocks, device, fixed_rows: int,
                     weighted: bool = False) -> dict[str, torch.Tensor]:
    """Device tensors of one tiled half.  accum and stream: the blocks'
    slice-local neighbor indices are rebased to absolute rows of the
    [fixed_rows, k] table once here (the slice's zero row h → the table's
    virtual zero row ``fixed_rows``; a stream side is one unsliced slice,
    so only its padding moves), which is what K2 and K6 read; stream mode
    also stages its per-chunk ridge counts, carry flags and carry rows.
    ``weighted`` (the iALS trainer) also stages the dense stream's
    tile-aligned ``weight`` and stream-aligned ``rating_dense`` — the
    channels the reparameterized weights are computed from; the explicit
    path never uploads them.  Every mode stages its chunks' Gram work-unit
    plans (``ops.kernels.gram_units``: ``units``, ``unit_splits``,
    ``unit_scratch``), which depend on the layout alone."""
    dev = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    if blocks.mode == "dstream":
        d = {
            "neighbor_idx": dev(blocks.neighbor_idx),
            "rating": dev(blocks.rating),
            "tile_meta": dev(blocks.tile_meta),
            "chunk_entity": dev(blocks.chunk_entity),
            "chunk_reg": chunk_reg(dev(blocks.chunk_count), blocks.num_chunks),
            "carry_in": dev(blocks.carry_in),
            "last_seg": dev(blocks.last_seg),
            "count": dev(blocks.count),
        }
        _, _, e_c, t, nt, ng, _ = blocks.statics
        meta = torch.as_tensor(blocks.tile_meta).view(blocks.num_chunks, -1)
        d.update(stage_plans(derive_dense_units(meta, t, nt, ng, e_c + 1),
                             device))
        if weighted:
            d["weight"] = dev(blocks.weight)
            d["rating_dense"] = dev(blocks.rating_dense)
        return d
    nb = dev(blocks.neighbor_idx)
    base = dev(blocks.chunk_base).repeat_interleave(blocks.chunk_cap)
    nb_abs = torch.where(nb < blocks.slice_rows, base + nb,
                         torch.full_like(nb, fixed_rows))
    d = {
        "neighbor_idx": nb_abs.to(torch.int32),
        "rating": dev(blocks.rating),
        "weight": dev(blocks.weight),
        "tile_seg": dev(blocks.tile_seg),
        "chunk_entity": dev(blocks.chunk_entity),
        "count": dev(blocks.count),
    }
    if blocks.mode == "stream":
        d.update(chunk_reg=chunk_reg(dev(blocks.chunk_count),
                                     blocks.num_chunks),
                 carry_in=dev(blocks.carry_in),
                 last_seg=dev(blocks.last_seg))
    t, e_c = blocks.tile_rows, blocks.chunk_entities
    seg = torch.as_tensor(blocks.tile_seg).view(blocks.num_chunks, -1)
    d.update(stage_plans(derive_tile_units(seg, t, e_c + 1), device))
    return d


def _tiled_device_setup(dataset: Dataset, device, weighted: bool = False):
    """Device dicts of both tiled halves and the static layout kwargs;
    ``weighted=True`` (iALS) stages the dense stream's weighted channels."""
    mb, ub = dataset.movie_blocks, dataset.user_blocks
    layout_kw = dict(
        m_chunks=("tiled", mb.mode) + mb.statics,
        u_chunks=("tiled", ub.mode) + ub.statics,
        m_entities=mb.padded_entities,
        u_entities=ub.padded_entities,
    )
    return (_tiled_to_device(mb, device, ub.padded_entities, weighted),
            _tiled_to_device(ub, device, mb.padded_entities, weighted),
            layout_kw)


def _layout_of(dataset: Dataset) -> str:
    return {BucketedBlocks: "bucketed", SegmentBlocks: "segment",
            TiledBlocks: "tiled"}.get(type(dataset.movie_blocks), "padded")


def device_setup(dataset: Dataset, config: ALSConfig, device, *,
                 weighted: bool = False):
    """Both halves' device blocks, the static layout kwargs and the padded
    layout's solve chunk, after checking that ``config.layout`` names the
    layout the dataset was built with — shared by both model families."""
    built = _layout_of(dataset)
    if config.layout not in ("auto", built):
        raise ValueError(f"config.layout={config.layout!r} but the dataset "
                         f"was built with the {built} layout")
    if config.algorithm != "als" and built in ("tiled", "segment"):
        raise ValueError(
            f"{config.algorithm} runs on the padded and bucketed layouts; "
            f"this dataset was built with the {built} layout")
    mb, ub = dataset.movie_blocks, dataset.user_blocks
    if built == "tiled":
        return (*_tiled_device_setup(dataset, device, weighted), None)
    if built == "segment":
        return (*_segment_device_setup(dataset, device), None)
    if built == "bucketed":
        return (*_bucketed_device_setup(dataset, device), None)
    return (_blocks_to_device(mb, device), _blocks_to_device(ub, device), {},
            config.padded_solve_chunk(max(mb.max_nnz, ub.max_nnz)))


def init_user_factors(dataset: Dataset, ublocks, config: ALSConfig, device,
                      warm_start):
    """(u, m_prev) in ``config.dtype``: the seeded factors of ``warm_start``
    (host arrays — bf16 ones too — or tensors, ascending-id rows, shorter
    ones zero-padded), else the avg-rating + U(0,1) init of the users and
    zero movies, cast as ``cfk_tpu/models/als.py:475`` casts them.
    ``m_prev`` is what a subspace optimizer's first movie half warm-starts
    from."""
    ub, mb = dataset.user_blocks, dataset.movie_blocks
    rank = config.rank
    dt = storage_dtype(config)
    if warm_start is not None:
        return (_padded_seed(warm_start[0], ub.padded_entities, rank, "user",
                             device, dt),
                _padded_seed(warm_start[1], mb.padded_entities, rank,
                             "movie", device, dt))
    gen = torch.Generator().manual_seed(config.seed)
    if isinstance(ub, PaddedBlocks):
        u = init_factors(gen, ublocks["rating"], ublocks["mask"],
                         ublocks["count"], rank)
    else:
        u = init_factors_stats(gen, torch.as_tensor(ub.rating_sum,
                                                    device=device),
                               torch.as_tensor(ub.count, device=device), rank)
    return (u.to(dt),
            torch.zeros((mb.padded_entities, rank), dtype=dt, device=device))


def storage_dtype(config: ALSConfig) -> torch.dtype:
    """The torch dtype of ``config.dtype``, the factors' storage."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[config.dtype]


def _half(fixed, blk, *, lam, solve_chunk, solver, chunks=None,
          entities=None, x_prev=None, algorithm="als", block_size=32,
          sweeps=1, fused_epilogue=None, in_kernel_gather=None,
          reg_solve_algo=None, table_dtype=None, overlap=None):
    """Solve one side against fixed factors; dispatches on the layout
    (tuple = width buckets, a dict with segment ids = the flat segment run,
    tiled statics, else one padded rectangle).
    ``algorithm="als++"`` runs warm-started subspace sweeps from
    ``x_prev`` (padded/bucketed layouts); ``fused_epilogue`` reaches the
    tiled and bucketed half-steps and the sweeps' b×b solves (the padded
    ALS half-step always solves with K1, as the JAX package's does),
    ``in_kernel_gather`` the tiled and bucketed ones (the sweeps
    materialize their rectangle with K5 on either setting,
    ``ops.subspace``; the padded rectangle is gathered by PyTorch, as the
    JAX package gathers it by XLA); ``reg_solve_algo`` every solve.
    ``table_dtype`` (``ops.quant``): the tiled, bucketed and subspace
    half-steps quantize and fold it themselves; the padded and segment ones
    take the bf16 view here (the config refuses int8 for them), as
    ``cfk_tpu/models/als.py:243-291`` does.  ``overlap`` reaches the tiled
    and bucketed walks, where it puts the gather-off K5 fetch on a side
    stream (``ops.pipeline``).  Returns float32 rows."""
    if algorithm == "als++":
        pp_kw = dict(block_size=block_size, sweeps=sweeps, solver=solver,
                     fused_epilogue=fused_epilogue,
                     reg_solve_algo=reg_solve_algo, table_dtype=table_dtype)
        if isinstance(blk, tuple):
            return als_pp_half_step_bucketed(fixed, x_prev, blk, chunks,
                                             entities, lam, **pp_kw)
        return als_pp_half_step(fixed, x_prev, blk["neighbor_idx"],
                                blk["rating"], blk["mask"], blk["count"],
                                lam, **pp_kw)
    if isinstance(blk, tuple):
        return als_half_step_bucketed(fixed, blk, entities, lam,
                                      chunk_rows=chunks, solver=solver,
                                      in_kernel_gather=in_kernel_gather,
                                      fused_epilogue=fused_epilogue,
                                      reg_solve_algo=reg_solve_algo,
                                      table_dtype=table_dtype,
                                      overlap=overlap)
    if chunks is not None and "seg_rel" not in blk:
        return tiled_half_step(fixed, blk, chunks, entities, lam,
                               solver=solver, fused_epilogue=fused_epilogue,
                               in_kernel_gather=in_kernel_gather,
                               reg_solve_algo=reg_solve_algo,
                               table_dtype=table_dtype, overlap=overlap)
    fixed = gather_operand_view(fixed, table_dtype)
    if "seg_rel" in blk:
        return als_half_step_segment(fixed, blk, chunks, entities, lam,
                                     solver=solver,
                                     reg_solve_algo=reg_solve_algo)
    return als_half_step(fixed, blk["neighbor_idx"], blk["rating"],
                         blk["mask"], blk["count"], lam,
                         solve_chunk=solve_chunk, solver=solver,
                         reg_solve_algo=reg_solve_algo)


def as_tensor(x, device) -> torch.Tensor:
    """A host array or tensor as a tensor on ``device``, its dtype kept —
    a numpy ``bfloat16`` array (ml_dtypes', what a JAX bf16 array converts
    to) through its uint16 view, so no ml_dtypes import is needed."""
    if isinstance(x, np.ndarray) and x.dtype.name == "bfloat16":
        x = torch.from_numpy(np.array(x).view(np.uint16)).view(
            torch.bfloat16)
    return torch.as_tensor(x, device=device)


def _padded_seed(x, rows: int, rank: int, what: str, device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A seed table (host array — bf16 too — or tensor on any device) as
    [rows, rank] ``dtype`` on ``device`` (a float32 seed rounded to bf16 as
    a cast rounds it), missing rows zero."""
    x = as_tensor(x, device).to(dtype)
    if x.ndim != 2 or x.shape[0] > rows or x.shape[1] != rank:
        raise ValueError(
            f"warm_start {what} factors have shape {tuple(x.shape)}; this "
            f"dataset solves [{rows}, {rank}] — rebuild the seed against the "
            "same entity universe"
        )
    out = torch.zeros((rows, rank), dtype=dtype, device=device)
    out[: x.shape[0]] = x
    return out


def pipeline_route(config: ALSConfig, device,
                   stepped_by: tuple[str, ...] = ()) -> tuple[str, str]:
    """How the trainer runs ``config``'s iterations on ``device``, decided
    from its arguments before anything is launched: ``(route, reason)``
    with route "stepped" (``stepped_by`` names the trainer arguments — a
    checkpoint manager, a fault injector, a preemption guard, a watchdog —
    that need iteration boundaries: the eager resilient loop,
    ``resilience.loop``), "captured" (``config.capture``: iteration 1
    eager, the rest replays of one captured iteration), "prefetched" (the
    pipelined chunk walks, every iteration eager) or "serial"
    (``overlap=False``) — the last three ``run_iterations``'s."""
    if stepped_by:
        return "stepped", (f"{', '.join(stepped_by)}: the eager resilient "
                           "loop")
    if not config.overlap:
        return "serial", "overlap off: the serial schedule"
    if torch.device(device).type != "cuda":
        return "prefetched", ("the CPU: the pipelined calls run in order on "
                              "one thread")
    if not config.capture:
        return "prefetched", "capture off (the default)"
    if config.num_iterations < 2:
        return "prefetched", "one iteration: nothing to replay"
    return "captured", "one iteration captured, replayed for the rest"


def iteration_step(half, mblocks, ublocks, layout_kw, dtype):
    """One training iteration — movies from users, then users from movies
    (each subspace half warm-started from its side's previous factors),
    each half's rows stored in ``dtype`` — as ``step(state, out)`` for
    ``run_iterations``: ``state = (u, m)``; ``out`` None returns new
    tensors, ``out`` a pair writes each half into it in place as soon as
    it is solved (the captured form; ``out`` may be ``state``)."""
    def step(state, out):
        u, m = state
        m_new = half(u, mblocks, chunks=layout_kw.get("m_chunks"),
                     entities=layout_kw.get("m_entities"),
                     x_prev=m).to(dtype)
        if out is not None:
            m_new = out[1].copy_(m_new)
        u_new = half(m_new, ublocks, chunks=layout_kw.get("u_chunks"),
                     entities=layout_kw.get("u_entities"),
                     x_prev=u).to(dtype)
        if out is not None:
            u_new = out[0].copy_(u_new)
        return u_new, m_new

    return step


def run_iterations(step, u, m, config: ALSConfig, device, health=None):
    """``config.num_iterations`` iterations of ``step`` from (u, m) on the
    route ``pipeline_route`` picks, under the ``train/fused_loop`` span.
    ``health`` (a ``resilience.sentinel.HealthConfig``) folds the probe
    into a device word after each iteration on its cadence
    (``resilience.loop.make_probed_step``; inside the captured iteration
    too), read once after the loop: the record's ``health`` is its summary
    ("healthy", or the first bad iteration and its reasons).  Records
    ``fused_loop_done`` (with a capture's seconds) when healthy.  Returns
    (u, m, the pipeline record)."""
    from cfk_tpu_torch.ops.pipeline import CapturedStep
    from cfk_tpu_torch.resilience import loop as rloop
    from cfk_tpu_torch.resilience.sentinel import report_from_carry
    from cfk_tpu_torch.telemetry import record_event, span

    route, reason = pipeline_route(config, device)
    n = config.num_iterations
    stats: dict = {}
    state = (u, m)
    if health is not None:
        step = rloop.make_probed_step(step, health, n)
        state = rloop.probed_state(u, m)
    with span("train/fused_loop", iters=n, route=route):
        if route == "captured":
            captured = CapturedStep(step)
            state = captured.run(state, n)
            stats = captured.stats
        else:
            for _ in range(n):
                state = step(state, None)
        if state[0].device.type == "cuda":
            torch.cuda.synchronize(state[0].device)
    u, m = state[:2]
    fields = {key: stats[key] for key in ("capture_s", "instantiate_s",
                                          "replays", "graph_pool_bytes")
              if key in stats}
    record = dict(route=route, reason=reason, **stats)
    if health is not None:
        record["health"] = report_from_carry(state[2].cpu()).summary()
    if record.get("health", "healthy") == "healthy":
        record_event("train", "fused_loop_done", iters=n, route=route,
                     **fields)
    return u, m, record


def _stepped_by(**resilience) -> tuple[str, ...]:
    """The trainer arguments that send a run to the eager stepped loop."""
    return tuple(name for name in ("checkpoint_manager", "fault_injector",
                                   "preemption_guard", "watchdog")
                 if resilience.get(name) is not None)


def train_loop(dataset: Dataset, config: ALSConfig, dev, make_step, u0, m0,
               *, model: str, checkpoint_manager=None,
               checkpoint_every: int = 1, metrics=None, fault_injector=None,
               preemption_guard=None, watchdog=None):
    """The iterations of both trainers from (u0, m0): ``run_iterations``
    on the route ``pipeline_route`` picks, or the eager resilient loop
    (``resilience.loop.resilient_train_loop``) when a checkpoint manager,
    a fault injector, a preemption guard or a watchdog needs iteration
    boundaries — ``cfk_tpu/models/als.py:617-684``'s routing.  With only
    the sentinel armed (``config.health_check_every``), the probe folds
    into a device word read after the loop (captured or not), and a trip
    discards that run and replays it through the resilient loop from the
    initial factors (the graph is never replayed after a rollback): the
    reference's fused-loop trip, with its ``fused_loop_trip`` note.
    ``make_step(Overrides)`` builds one iteration's ``step(state, out)``;
    λ and the fused epilogue come from ``config`` (then the ladder's
    rungs), so one ``make_step`` serves configs that differ in them.
    Returns (u, m, pipeline record)."""
    import warnings

    from cfk_tpu_torch.resilience.loop import (
        resilient_train_loop,
        validate_cadence,
    )
    from cfk_tpu_torch.resilience.policy import policy_from_config
    from cfk_tpu_torch.resilience.sentinel import health_from_config
    from cfk_tpu_torch.telemetry.metrics import Metrics

    health = health_from_config(config)
    validate_cadence(checkpoint_every, health)
    metrics = metrics if metrics is not None else Metrics()
    metrics.gauge("num_users", dataset.user_map.num_entities)
    metrics.gauge("num_movies", dataset.movie_map.num_entities)
    metrics.gauge("num_ratings", int(dataset.movie_blocks.count.sum()))
    stepped_by = _stepped_by(checkpoint_manager=checkpoint_manager,
                             fault_injector=fault_injector,
                             preemption_guard=preemption_guard,
                             watchdog=watchdog)
    base = base_overrides(config)
    if not stepped_by:
        train_s_before = metrics.phases.get("train", 0.0)
        with metrics.phase("train"):
            u, m, record = run_iterations(make_step(base), u0, m0, config,
                                          dev, health=health)
        trip = record.get("health", "healthy")
        if trip == "healthy":
            metrics.incr("iterations", config.num_iterations)
            return u, m, record
        # The tripped run is discarded and replayed: its wall time moves to
        # "train_discarded" and its iterations are not counted (the replay
        # re-detects the trip and does the rollback accounting once).
        del u, m
        discarded = metrics.phases.get("train", 0.0) - train_s_before
        metrics.phases["train"] = train_s_before
        metrics.phases["train_discarded"] += discarded
        metrics.note("fused_loop_trip", trip)
        warnings.warn(
            f"health sentinel tripped in the {record['route']} training "
            f"loop ({trip}); replaying through the resilient stepped loop")
        stepped_by = (f"a health trip on the {record['route']} route",)

    def make_stepped(ov):
        step = make_step(ov)
        return lambda u, m: step((u, m), None)

    u, m = resilient_train_loop(
        checkpoint_manager, model=model, rank=config.rank,
        num_iterations=config.num_iterations,
        u_shape=tuple(u0.shape), m_shape=tuple(m0.shape), dtype=u0.dtype,
        init_fn=lambda: (u0.clone(), m0.clone()), make_step=make_stepped,
        base_overrides=base,
        metrics=metrics, checkpoint_every=checkpoint_every, health=health,
        policy=policy_from_config(config), fault_injector=fault_injector,
        device=dev, preemption_guard=preemption_guard, watchdog=watchdog)
    if u.device.type == "cuda":
        torch.cuda.synchronize(u.device)
    route, reason = pipeline_route(config, dev, stepped_by)
    return u, m, dict(route=route, reason=reason)


def _half_kwargs(config: ALSConfig, ov) -> dict:
    """The half-step knobs of ``config`` under the escalation overrides
    ``ov`` (``base_overrides(config)`` before any rung): λ, the fused
    epilogue and the solve route (``Overrides.reg_solve_algo`` or the
    config's)."""
    return dict(lam=ov.lam, fused_epilogue=ov.fused_epilogue,
                reg_solve_algo=ov.reg_solve_algo or config.reg_solve_algo)


def base_overrides(config: ALSConfig):
    """The ladder's first ``Overrides``: the config's own λ and fused
    epilogue — what ``make_step`` builds the plain iteration with."""
    from cfk_tpu_torch.resilience.policy import Overrides

    return Overrides(lam=config.lam, fused_epilogue=config.fused_epilogue)


def timed_steps(steps, dataset, config, dev, warm_start, metrics):
    """``steps(dataset, config, dev, warm_start)`` (``als_steps`` or
    ``ials_steps``: the block upload, the work-unit plans, the initial
    factors) under ``metrics``' ``blocks_to_device`` phase, as the
    reference times it (``cfk_tpu/models/als.py:595``)."""
    with metrics.phase("blocks_to_device"):
        out = steps(dataset, config, dev, warm_start)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out


def als_steps(dataset: Dataset, config: ALSConfig, dev, warm_start):
    """(make_step, u, m): both halves' blocks uploaded to ``dev``, the
    initial factors, and ``make_step(Overrides)`` building one ALS
    iteration as ``iteration_step``'s ``step`` — what ``train_als`` runs
    and what the recovery ladder rebuilds with its overrides."""
    mblocks, ublocks, layout_kw, solve_chunk = device_setup(dataset, config,
                                                            dev)
    u, m = init_user_factors(dataset, ublocks, config, dev, warm_start)

    def make_step(ov):
        half = functools.partial(_half, solve_chunk=solve_chunk,
                                 solver=config.solver,
                                 algorithm=config.algorithm,
                                 block_size=config.block_size,
                                 sweeps=config.sweeps,
                                 in_kernel_gather=config.in_kernel_gather,
                                 table_dtype=config.table_dtype,
                                 overlap=config.overlap,
                                 **_half_kwargs(config, ov))
        return iteration_step(half, mblocks, ublocks, layout_kw,
                              storage_dtype(config))

    return make_step, u, m


def train_als(dataset: Dataset, config: ALSConfig, *,
              device: str | torch.device = DEFAULT_DEVICE,
              warm_start=None, checkpoint_manager=None,
              checkpoint_every: int = 1, metrics=None, fault_injector=None,
              preemption_guard=None, watchdog=None) -> ALSModel:
    """Train ALS-WR (or ALS++ with ``config.algorithm="als++"``) on one
    device; factors in ascending-id order.

    ``device`` defaults to CUDA and raises if there is none; pass
    ``device="cpu"`` for the plain PyTorch versions.  ``warm_start=(u0, m0)``
    (host arrays or tensors, ascending-id rows, shorter ones zero-padded)
    seeds the factors instead of the avg-rating + U(0,1) init — how the
    parity tests hand the JAX package's initial factors to the port.
    ``config.overlap`` and ``config.capture`` pick the pipelined (captured
    or not) or the serial schedule (``pipeline_route``; the model's
    ``pipeline`` says which ran).

    Resilience (``cfk_tpu_torch.resilience``, the reference's arguments):
    ``checkpoint_manager`` saves the factors every ``checkpoint_every``
    iterations and resumes from its newest intact step (which wins over
    ``warm_start``); ``config.health_check_every`` arms the sentinel,
    whose trip rolls back and climbs the escalation ladder;
    ``fault_injector`` (chaos testing), ``preemption_guard`` and
    ``watchdog`` act at iteration boundaries.  A manager, an injector, a
    guard or a watchdog sends the run to the eager stepped loop; ``metrics``
    (``telemetry.Metrics``) records phases, counters and the recovery
    notes.  See ``train_loop``.

    ``config.offload_tier`` ("host_window", or "auto" past the device's
    memory — ``offload.windowed.resolve_tier``) runs the out-of-core
    trainer ``offload.windowed.train_als_host_window`` instead, which
    refuses the resilience arguments and ``warm_start``.
    """
    from cfk_tpu_torch.telemetry.metrics import Metrics

    use_kernels(config.solver, torch.device(device))  # cholesky: CPU only
    dev = resolve_device(device)
    metrics = metrics if metrics is not None else Metrics()
    from cfk_tpu_torch.offload import windowed

    if windowed.resolve_tier(dataset, config, dev) == "host_window":
        # The out-of-core tier (``cfk_tpu/models/als.py:558-590``): the
        # budget predicate said the resident tables cannot fit (or the
        # config pinned the tier) — the windowed trainer, the same bits as
        # the resident path on the same stream blocks.
        windowed.refuse_unsupported(
            checkpoint_manager=checkpoint_manager,
            fault_injector=fault_injector,
            preemption_guard=preemption_guard, watchdog=watchdog,
            warm_start=warm_start)
        return windowed.train_als_host_window(dataset, config, device=dev,
                                              metrics=metrics)
    make_step, u, m = timed_steps(als_steps, dataset, config, dev,
                                  warm_start, metrics)
    u, m, pipeline = train_loop(
        dataset, config, dev, make_step, u, m, model="als",
        checkpoint_manager=checkpoint_manager,
        checkpoint_every=checkpoint_every, metrics=metrics,
        fault_injector=fault_injector, preemption_guard=preemption_guard,
        watchdog=watchdog)
    return ALSModel(
        user_factors=u,
        movie_factors=m,
        num_users=dataset.user_map.num_entities,
        num_movies=dataset.movie_map.num_entities,
        pipeline=pipeline,
    )
