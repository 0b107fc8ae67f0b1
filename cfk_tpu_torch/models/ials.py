"""Implicit-feedback ALS (iALS, Hu-Koren-Volinsky 2008) — the second model
family, on one device.

The port of ``cfk_tpu/models/ials.py``'s fused-loop route.  Same layouts as
the explicit model, different normal equations: per entity
A = YᵀY + Σ_obs (c−1)·f fᵀ + λI with confidence c = 1 + α·r and
preferences 1 at observed cells.  The global Gram YᵀY is computed once per
half-iteration.  ``algorithm="ials++"`` swaps the full k×k solves for
warm-started subspace sweeps (``ops.subspace``).

The checkpointed/resilient stepped loop, the health sentinel and the fault
hooks are ``models.als.train_loop``'s, shared with ``train_als``; the
out-of-core ``host_window`` tier is ``offload.windowed.
train_ials_host_window``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cfk_tpu_torch.config import ALSConfig
from cfk_tpu_torch.data.blocks import Dataset
from cfk_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from cfk_tpu_torch.models.als import (
    ALSModel,
    device_setup,
    _half_kwargs,
    init_user_factors,
    iteration_step,
    storage_dtype,
    timed_steps,
    train_loop,
)
from cfk_tpu_torch.ops.quant import gather_operand_view
from cfk_tpu_torch.ops.solve import (
    ials_half_step,
    ials_half_step_bucketed,
    ials_half_step_segment,
    use_kernels,
)
from cfk_tpu_torch.ops.subspace import (
    ials_pp_half_step,
    ials_pp_half_step_bucketed,
)
from cfk_tpu_torch.ops.tiled import ials_tiled_half_step


@dataclasses.dataclass(frozen=True)
class IALSConfig(ALSConfig):
    """iALS hyper-parameters; ``lam`` here is plain-λI regularization.

    ``algorithm="ials++"`` switches the per-entity solve from the full k×k
    normal equations to subspace block coordinate descent (Rendle et al.):
    ``sweeps`` passes over ``rank/block_size`` coordinate blocks per
    half-iteration, warm-started from the previous epoch's factors.  With
    ``block_size == rank`` one sweep equals the full solve.
    """

    alpha: float = 40.0
    lam: float = 0.1

    def _valid_algorithms(self) -> tuple[str, ...]:
        return ("als", "ials++")

    def _check_host_window(self) -> None:
        """The implicit family's ``offload_tier='host_window'`` gate
        (``cfk_tpu/models/ials.py:61-72``): the windowed trainer streams the
        bucketed width-class layout (the global-Gram reduction plus
        per-class windows), for iALS and iALS++ alike."""
        if self.layout != "bucketed":
            raise ValueError(
                "offload_tier='host_window' for the implicit family "
                "streams the bucketed width-class layout; layout="
                f"{self.layout!r}"
            )

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.alpha <= 0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")


def _ials_half(fixed, blk, *, lam, alpha, solver, chunks=None, entities=None,
               x_prev=None, algorithm="als", block_size=32, sweeps=1,
               fused_epilogue=None, in_kernel_gather=None,
               reg_solve_algo=None, table_dtype=None, overlap=None,
               gram=None):
    """Dispatch on the block layout (tuple = width buckets, a dict with
    segment ids = the flat segment run, tiled statics, else one padded
    rectangle); ``algorithm="ials++"`` runs warm-started
    subspace sweeps from ``x_prev`` (padded/bucketed layouts);
    ``fused_epilogue`` reaches the tiled and bucketed half-steps and the
    sweeps, ``in_kernel_gather`` the tiled and bucketed ones,
    ``reg_solve_algo`` every solve and ``table_dtype`` the gather table (the
    padded and segment layouts take its bf16 view here), ``overlap`` the
    tiled and bucketed walks' side stream (``ops.pipeline``) — as in ``models.als._half`` and
    ``cfk_tpu/models/ials.py:85-149``.  ``gram`` is the shared YᵀY when
    the caller has it (the sharded trainers' sum over ranks), else each
    half-step sums it over ``fixed``."""
    if algorithm == "ials++":
        pp_kw = dict(block_size=block_size, sweeps=sweeps, solver=solver,
                     fused_epilogue=fused_epilogue,
                     reg_solve_algo=reg_solve_algo, table_dtype=table_dtype)
        if isinstance(blk, tuple):
            return ials_pp_half_step_bucketed(fixed, x_prev, blk, chunks,
                                              entities, lam, alpha, gram=gram,
                                              **pp_kw)
        return ials_pp_half_step(fixed, x_prev, blk["neighbor_idx"],
                                 blk["rating"], blk["mask"], lam, alpha,
                                 gram=gram, **pp_kw)
    if isinstance(blk, tuple):
        return ials_half_step_bucketed(fixed, blk, entities, lam, alpha,
                                       chunk_rows=chunks, gram=gram,
                                       solver=solver,
                                       in_kernel_gather=in_kernel_gather,
                                       fused_epilogue=fused_epilogue,
                                       reg_solve_algo=reg_solve_algo,
                                       table_dtype=table_dtype,
                                       overlap=overlap)
    if chunks is not None and "seg_rel" not in blk:
        return ials_tiled_half_step(fixed, blk, chunks, entities, lam, alpha,
                                    gram=gram, solver=solver,
                                    fused_epilogue=fused_epilogue,
                                    in_kernel_gather=in_kernel_gather,
                                    reg_solve_algo=reg_solve_algo,
                                    table_dtype=table_dtype, overlap=overlap)
    fixed = gather_operand_view(fixed, table_dtype)
    if "seg_rel" in blk:
        return ials_half_step_segment(fixed, blk, chunks, entities, lam,
                                      alpha, gram=gram, solver=solver,
                                      reg_solve_algo=reg_solve_algo)
    return ials_half_step(fixed, blk["neighbor_idx"], blk["rating"],
                          blk["mask"], lam, alpha, gram=gram, solver=solver,
                          reg_solve_algo=reg_solve_algo)


def _check_nonnegative_strengths(dataset: Dataset) -> None:
    """iALS needs interaction strengths ≥ 0 (c = 1 + α·r ≥ 1, and the
    reparameterized weight stream takes √(α·r)): refuse negative ones at
    trainer entry instead of training an inconsistent normal equation."""
    r = dataset.coo_dense.rating
    if not r.size:
        return
    mn = float(np.min(r))
    if mn < 0:
        raise ValueError(
            "iALS requires non-negative interaction strengths "
            f"(min rating {mn}); rescale or clamp the data "
            "(see cfk_tpu.models.ials docstring)"
        )


def ials_steps(dataset: Dataset, config: IALSConfig, dev, warm_start):
    """(make_step, u, m): both halves' blocks (with the weighted channels)
    uploaded to ``dev``, the initial factors, and ``make_step(Overrides)``
    building one iALS iteration as ``models.als.iteration_step``'s
    ``step`` — the single-device ``make_step`` of
    ``cfk_tpu/models/ials.py:441-480``."""
    mblocks, ublocks, layout_kw, _ = device_setup(dataset, config, dev,
                                                  weighted=True)
    u, m = init_user_factors(dataset, ublocks, config, dev, warm_start)

    def make_step(ov):
        half = functools.partial(_ials_half, alpha=config.alpha,
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


def train_ials(dataset: Dataset, config: IALSConfig, *,
               device: str | torch.device = DEFAULT_DEVICE,
               warm_start=None, checkpoint_manager=None,
               checkpoint_every: int = 1, metrics=None, fault_injector=None,
               preemption_guard=None, watchdog=None) -> ALSModel:
    """Single-device implicit ALS; ratings are interaction strengths
    (counts, play time, stars — anything ≥ 0).  Factors in ascending-id
    order.

    ``device`` defaults to CUDA and raises if there is none (``"cpu"`` runs
    the plain PyTorch versions).  ``warm_start=(u0, m0)`` seeds the factors
    as in ``train_als`` — how the parity tests hand the JAX package's
    initial factors (drawn with jax's threefry) to the port; ``m0`` is the
    first movie half's warm start under ``ials++``.  ``config.overlap``
    picks the schedule, and the checkpoint, health, fault, preemption and
    watchdog arguments act, as in ``train_als`` (``models.als.train_loop``).
    ``config.offload_tier`` sends the run to ``offload.windowed.
    train_ials_host_window`` as ``train_als`` sends its own.
    """
    _check_nonnegative_strengths(dataset)
    from cfk_tpu_torch.telemetry.metrics import Metrics

    use_kernels(config.solver, torch.device(device))  # cholesky: CPU only
    dev = resolve_device(device)
    metrics = metrics if metrics is not None else Metrics()
    from cfk_tpu_torch.offload import windowed

    if windowed.resolve_tier(dataset, config, dev) == "host_window":
        # The out-of-core implicit tier (``cfk_tpu/models/ials.py:
        # 332-365``): the bucketed windowed trainer.
        windowed.refuse_unsupported(
            checkpoint_manager=checkpoint_manager,
            fault_injector=fault_injector,
            preemption_guard=preemption_guard, watchdog=watchdog)
        return windowed.train_ials_host_window(dataset, config, device=dev,
                                               metrics=metrics)
    make_step, u, m = timed_steps(ials_steps, dataset, config, dev,
                                  warm_start, metrics)
    u, m, pipeline = train_loop(
        dataset, config, dev, make_step, u, m, model="ials",
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


def make_ials_training_step(group, config: IALSConfig, sides, *,
                            health_probe: bool = False, overrides=None):
    """One sharded iALS iteration over a rank's device blocks
    (``cfk_tpu/models/ials.py:510-686``): per half, YᵀY summed over the
    ranks, the fixed table all-gathered, the local entities solved by the
    single-device half-step of their layout (``ials++``: warm-started
    sweeps from the side's own previous rows, no extra collective).  iALS
    needs the whole fixed side for its global Gram, so ring-built halves
    are refused (``parallel.spmd.train_sharded``)."""
    from cfk_tpu_torch.parallel.spmd import make_training_step

    return make_training_step(group, config, sides, implicit=True,
                              health_probe=health_probe, overrides=overrides)


def train_ials_sharded(dataset: Dataset, config: IALSConfig, mesh, *,
                       warm_start=None, checkpoint_manager=None,
                       checkpoint_every: int = 1, metrics=None,
                       fault_injector=None, preemption_guard=None,
                       watchdog=None) -> ALSModel:
    """Implicit ALS over ``config.num_shards`` ranks (``cfk_tpu/models/
    ials.py:687-``), with the resilience of ``train_als_sharded`` (the
    probe is the factor word: the all_gather exchange has no in-flight
    carry).  ``mesh``: a ``Mesh`` or this process's ``ShardGroup``."""
    from cfk_tpu_torch.parallel.spmd import train_sharded

    _check_nonnegative_strengths(dataset)
    return train_sharded(dataset, config, mesh, model="ials",
                         warm_start=warm_start,
                         checkpoint_manager=checkpoint_manager,
                         checkpoint_every=checkpoint_every, metrics=metrics,
                         fault_injector=fault_injector,
                         preemption_guard=preemption_guard,
                         watchdog=watchdog)
