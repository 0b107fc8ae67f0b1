"""Explicit-feedback ALS-WR — the flagship model, on one device.

The port of ``cfk_tpu/models/als.py``'s fused-loop route, with the
reference's semantics (``apps/ALSApp.java:115-151``):

  - init user factors: avg-rating + U(0,1) (``processors/UFeatureInitializer.java:50-56``)
  - per iteration: solve movies from users, then users from movies
  - prediction P = U·Mᵀ, rows = users ascending id, cols = movies ascending id.

``lax.fori_loop`` becomes a Python loop over iterations; every half-step
runs on ``device`` through the kernels of ``ops.kernels`` (CUDA) or their
plain versions (CPU).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cfk_tpu_torch.config import ALSConfig
from cfk_tpu_torch.data.blocks import Dataset, PaddedBlocks, TiledBlocks
from cfk_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from cfk_tpu_torch.ops.solve import (
    als_half_step,
    init_factors,
    init_factors_stats,
    use_kernels,
)
from cfk_tpu_torch.ops.tiled import chunk_reg, tiled_half_step


@dataclasses.dataclass(frozen=True)
class ALSModel:
    """Trained factor matrices (rows = ascending external id order)."""

    user_factors: torch.Tensor  # [num_users, k]
    movie_factors: torch.Tensor  # [num_movies, k]
    num_users: int
    num_movies: int

    def host_factors(self) -> tuple[np.ndarray, np.ndarray]:
        """float32 host copies of (U, M), fetched from the device once."""
        return self._host_factors

    @functools.cached_property
    def _host_factors(self) -> tuple[np.ndarray, np.ndarray]:
        u = self.user_factors[: self.num_users].detach().cpu().numpy()
        m = self.movie_factors[: self.num_movies].detach().cpu().numpy()
        return u.astype(np.float32), m.astype(np.float32)

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


def _tiled_to_device(blocks: TiledBlocks, device, fixed_rows: int
                     ) -> dict[str, torch.Tensor]:
    """Device tensors of one tiled half.  accum: the builder's slice-local
    neighbor indices are rebased to absolute rows of the [fixed_rows, k]
    table once here (the slice's zero row h → the table's virtual zero row
    ``fixed_rows``), which is what the gather kernel reads."""
    dev = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    if blocks.mode == "dstream":
        return {
            "neighbor_idx": dev(blocks.neighbor_idx),
            "rating": dev(blocks.rating),
            "tile_meta": dev(blocks.tile_meta),
            "chunk_entity": dev(blocks.chunk_entity),
            "chunk_reg": chunk_reg(dev(blocks.chunk_count), blocks.num_chunks),
            "carry_in": dev(blocks.carry_in),
            "last_seg": dev(blocks.last_seg),
            "count": dev(blocks.count),
        }
    nb = dev(blocks.neighbor_idx)
    base = dev(blocks.chunk_base).repeat_interleave(blocks.chunk_cap)
    nb_abs = torch.where(nb < blocks.slice_rows, base + nb,
                         torch.full_like(nb, fixed_rows))
    return {
        "neighbor_idx": nb_abs.to(torch.int32),
        "rating": dev(blocks.rating),
        "weight": dev(blocks.weight),
        "tile_seg": dev(blocks.tile_seg),
        "chunk_entity": dev(blocks.chunk_entity),
        "count": dev(blocks.count),
    }


def _tiled_device_setup(dataset: Dataset, device):
    """Device dicts of both tiled halves and the static layout kwargs."""
    mb, ub = dataset.movie_blocks, dataset.user_blocks
    layout_kw = dict(
        m_chunks=("tiled", mb.mode) + mb.statics,
        u_chunks=("tiled", ub.mode) + ub.statics,
        m_entities=mb.padded_entities,
        u_entities=ub.padded_entities,
    )
    return (_tiled_to_device(mb, device, ub.padded_entities),
            _tiled_to_device(ub, device, mb.padded_entities), layout_kw)


def _half(fixed, blk, *, lam, solve_chunk, solver, chunks=None,
          entities=None):
    """Solve one side against fixed factors (tiled dict or padded dict)."""
    if chunks is not None:
        return tiled_half_step(fixed, blk, chunks, entities, lam,
                               solver=solver)
    return als_half_step(fixed, blk["neighbor_idx"], blk["rating"],
                         blk["mask"], blk["count"], lam,
                         solve_chunk=solve_chunk, solver=solver)


def _padded_seed(x, rows: int, rank: int, what: str, device) -> torch.Tensor:
    x = np.asarray(x, dtype=np.float32)
    if x.ndim != 2 or x.shape[0] > rows or x.shape[1] != rank:
        raise ValueError(
            f"warm_start {what} factors have shape {x.shape}; this dataset "
            f"solves [{rows}, {rank}] — rebuild the seed against the same "
            "entity universe"
        )
    out = torch.zeros((rows, rank), dtype=torch.float32, device=device)
    out[: x.shape[0]] = torch.as_tensor(x, device=device)
    return out


def train_als(dataset: Dataset, config: ALSConfig, *,
              device: str | torch.device = DEFAULT_DEVICE,
              warm_start=None) -> ALSModel:
    """Train ALS-WR on one device; factors in ascending-id order.

    ``device`` defaults to CUDA and raises if there is none; pass
    ``device="cpu"`` for the plain PyTorch versions.  ``warm_start=(u0, m0)``
    (host arrays, ascending-id rows, shorter ones zero-padded) seeds the
    factors instead of the avg-rating + U(0,1) init — how the parity tests
    hand the JAX package's initial factors to the port.
    """
    use_kernels(config.solver, torch.device(device))  # cholesky: CPU only
    dev = resolve_device(device)
    mb, ub = dataset.movie_blocks, dataset.user_blocks
    tiled = isinstance(mb, TiledBlocks)
    built = "tiled" if tiled else "padded"
    if config.layout not in ("auto", built):
        raise ValueError(f"config.layout={config.layout!r} but the dataset "
                         f"was built with the {built} layout")
    if tiled:
        mblocks, ublocks, layout_kw = _tiled_device_setup(dataset, dev)
        solve_chunk = None
    else:
        mblocks = _blocks_to_device(mb, dev)
        ublocks = _blocks_to_device(ub, dev)
        layout_kw = {}
        solve_chunk = config.padded_solve_chunk(max(mb.max_nnz, ub.max_nnz))
    rank = config.rank
    if warm_start is not None:
        u = _padded_seed(warm_start[0], ub.padded_entities, rank, "user", dev)
        # Validated only: the first half-iteration overwrites the movies.
        _padded_seed(warm_start[1], mb.padded_entities, rank, "movie", dev)
    else:
        gen = torch.Generator().manual_seed(config.seed)
        if tiled:
            u = init_factors_stats(gen, torch.as_tensor(ub.rating_sum, device=dev),
                                   ublocks["count"], rank)
        else:
            u = init_factors(gen, ublocks["rating"], ublocks["mask"],
                             ublocks["count"], rank)
    half = functools.partial(_half, lam=config.lam, solve_chunk=solve_chunk,
                             solver=config.solver)
    m = None
    for _ in range(config.num_iterations):
        m = half(u, mblocks, chunks=layout_kw.get("m_chunks"),
                 entities=layout_kw.get("m_entities"))
        u = half(m, ublocks, chunks=layout_kw.get("u_chunks"),
                 entities=layout_kw.get("u_entities"))
    return ALSModel(
        user_factors=u,
        movie_factors=m,
        num_users=dataset.user_map.num_entities,
        num_movies=dataset.movie_map.num_entities,
    )
