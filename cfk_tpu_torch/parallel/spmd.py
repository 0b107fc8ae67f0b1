"""Sharded ALS over a rank group: the port of ``cfk_tpu/parallel/spmd.py``.

The reference's per-iteration feature exchange (``apps/ALSApp.java:115-151``)
becomes one collective pattern per half-iteration, run by every rank on its
own entity rows (``parallel.mesh``):

- ``all_gather`` — every rank receives the whole fixed-side table, then
  solves its local entities with the single-device half-steps (and, for
  iALS, the YᵀY summed over ranks).  A bf16 table is cast before the
  gather (half the bytes); an int8 one is quantized by the half-step after.
- ``ring`` — the fixed side's row blocks rotate around the ranks
  (``ShardGroup.shift``: one ``batch_isend_irecv`` to the ring neighbours a
  step, the block-to-block join of the reference's README:152-157); each
  rank adds the Grams of the block it holds and solves once at the end.
  With ``overlap`` the next block's send/recv is issued before the current
  block's Grams run (the double buffer of ``_ring_rotate``).  The rotating
  payload is quantized once before the ring; with the health sentinel on,
  every rotated block is probed and the flags feed the sentinel's
  ``RING_EXCHANGE`` bit.
- ``ring`` on the tiled layout — the ring-built blocks sort each rank's
  entries by the fixed shard that owns the neighbour, so at step r a rank
  walks exactly the chunks of the slice it holds, through kernel K2
  (``ops.tiled.accum_grams``) on the rotated block, into one [E+1, k, k]
  accumulator solved by K1 at the end; ``hier_ring`` runs rings of
  ``ici_group`` ranks inside a ring of groups, the same visits in another
  order (bit-identical to the flat ring when one ring is degenerate);
  ``auto`` takes each half's exchange from how its blocks were built.

Accumulation order differs from one rank's, so sharded factors agree with
one-rank factors to a float tolerance, not bit for bit.  ``serve_topk_sharded``
is the serving counterpart: the item table sharded, each rank's K4 at its
``row_offset``, one all_gather of the [B, K] selections merged in rank order
— bit-equal to the one-rank scan.

Entry points take a ``Mesh`` (``make_mesh``: the trainer ships each rank
its own rows and returns rank 0's gathered factors) or a ``ShardGroup``
(a torchrun-style process: it runs its rank itself).  JAX's
``use_check_vma`` (shard_map's varying-axes checker) has no counterpart:
every rank runs eager PyTorch on its own tensors.
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
    RingBlocks,
    SegmentBlocks,
    TiledBlocks,
    build_ring_blocks,
)
from cfk_tpu_torch.ops import quant
from cfk_tpu_torch.ops.solve import (
    gather_gram,
    global_gram,
    init_factors_stats,
    pad_rows_to_multiple,
    regularized_solve,
)
from cfk_tpu_torch.parallel.mesh import AXIS, Mesh, ShardGroup


# -- one rank's blocks -------------------------------------------------------


def _part(x, rank: int, num_shards: int):
    if not isinstance(x, np.ndarray) or x.size == 0:
        return x
    if x.shape[0] % num_shards:
        raise ValueError(f"an array of {x.shape[0]} rows does not split "
                         f"into {num_shards} shards")
    step = x.shape[0] // num_shards
    return x[rank * step:(rank + 1) * step]


def shard_view(blocks, rank: int, num_shards: int):
    """Rank ``rank``'s part of sharded blocks, as blocks of one shard: every
    array's ``rank``-th of ``num_shards`` equal row blocks (the builders'
    shard-major order — the ``P("shard")`` sharding of the JAX package),
    with shard-local entity rows and ``num_shards=1``."""
    part = functools.partial(_part, rank=rank, num_shards=num_shards)
    if isinstance(blocks, BucketedBlocks):
        buckets = tuple(dataclasses.replace(
            b, **{f.name: part(getattr(b, f.name))
                  for f in dataclasses.fields(b)
                  if isinstance(getattr(b, f.name), np.ndarray)})
            for b in blocks.buckets)
        return dataclasses.replace(blocks, buckets=buckets,
                                   count=part(blocks.count),
                                   rating_sum=part(blocks.rating_sum),
                                   num_shards=1)
    fields = {f.name: part(getattr(blocks, f.name))
              for f in dataclasses.fields(blocks)
              if isinstance(getattr(blocks, f.name), np.ndarray)}
    if any(f.name == "num_shards" for f in dataclasses.fields(blocks)):
        fields["num_shards"] = 1
    return dataclasses.replace(blocks, **fields)


def _ring_to_tree(blocks: RingBlocks) -> dict:
    """The ring rectangles under the keys ``half_step_ring`` reads (the
    reference's ``_ring_to_tree``; the other layouts keep their dataclass
    views and the single-device device setup)."""
    return {"neighbor": blocks.neighbor_local, "rating": blocks.rating,
            "mask": blocks.mask, "count": blocks.count}


def tree_specs(tree):
    """The row sharding of every leaf: ``("shard", None, ...)`` — axis 0
    split over the ranks, the rest whole (``shard_rows`` applies it)."""
    if isinstance(tree, dict):
        return {k: tree_specs(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_specs(v) for v in tree)
    return (AXIS,) + (None,) * (np.ndim(tree) - 1)


def _layout(blocks) -> str:
    return {BucketedBlocks: "bucketed", SegmentBlocks: "segment",
            TiledBlocks: "tiled", RingBlocks: "ring"}.get(type(blocks),
                                                          "padded")


def validate_sharded_dataset(dataset: Dataset, config: ALSConfig,
                             num_shards: int) -> None:
    """Layout mistakes, caught with actionable errors before any rank
    starts (``cfk_tpu/parallel/spmd.py:1134-1158``)."""
    s = config.num_shards
    if num_shards != s:
        raise ValueError(
            f"mesh has {num_shards} ranks, config.num_shards={s}")
    for name, blocks in (("movie", dataset.movie_blocks),
                         ("user", dataset.user_blocks)):
        if blocks.padded_entities % s != 0:
            raise ValueError(
                f"{name}_blocks padded to {blocks.padded_entities} entities, "
                f"not divisible by num_shards={s}; rebuild the Dataset with "
                f"Dataset.from_coo(..., num_shards={s})")
        if not isinstance(blocks, PaddedBlocks) and blocks.num_shards != s:
            raise ValueError(
                f"{name}_blocks were built for num_shards={blocks.num_shards} "
                f"but config.num_shards={s}; their row/segment indices are "
                f"shard-local, so rebuild with Dataset.from_coo(..., "
                f"num_shards={s}, layout='{_layout(blocks)}')")


def gathered_layout_trees(dataset: Dataset, config: ALSConfig):
    """Each half's exchange — ``"gather"``, ``"ring"`` (the padded layout's
    ``RingBlocks``, built here from the dataset's COO) or ``"tiled_ring"``
    — and its (unsharded) blocks, after the reference's layout checks
    (``cfk_tpu/parallel/spmd.py:807-872``): the bucketed and segment
    layouts gather only; tiled blocks must be built with the ring flag the
    exchange asks for (``auto`` takes each half's as built)."""
    mb, ub = dataset.movie_blocks, dataset.user_blocks
    ring = config.exchange in ("ring", "hier_ring")
    if isinstance(mb, TiledBlocks):
        if config.exchange != "auto":
            for name, blocks in (("movie", mb), ("user", ub)):
                if ring != blocks.ring:
                    raise ValueError(
                        f"config.exchange={config.exchange!r} but the tiled "
                        f"{name}_blocks were built with ring={blocks.ring}; "
                        "rebuild with Dataset.from_coo(..., layout='tiled', "
                        f"ring={ring})")
        return tuple(("tiled_ring" if b.ring else "gather", b)
                     for b in (mb, ub))
    if ring and isinstance(mb, (BucketedBlocks, SegmentBlocks)):
        raise ValueError(
            f"{_layout(mb)} layout supports exchange='all_gather' only — the "
            "ring join needs the owner-shard-sorted entry stream the padded "
            "and tiled layouts have; build the tiled dataset with "
            "Dataset.from_coo(..., ring=True) or ring='auto'")
    if not ring:
        return (("gather", mb), ("gather", ub))
    coo, s = dataset.coo_dense, config.num_shards
    nm, nu = dataset.movie_map.num_entities, dataset.user_map.num_entities
    return (("ring", build_ring_blocks(
                coo.movie_raw, coo.user_raw, coo.rating, nm, nu,
                num_shards=s, pad_multiple=config.pad_multiple)),
            ("ring", build_ring_blocks(
                coo.user_raw, coo.movie_raw, coo.rating, nu, nm,
                num_shards=s, pad_multiple=config.pad_multiple)))


# -- the exchanges -----------------------------------------------------------


def _nonfinite_flag(x: torch.Tensor) -> torch.Tensor:
    """int32 0/1 on the device: any NaN/Inf in ``x`` (no host sync)."""
    return (~torch.isfinite(x.float())).any().to(torch.int32)


def _payload_nonfinite_flag(tbl: tuple) -> torch.Tensor:
    """The ring payload's probe, over its LAST leaf: the factor block
    itself, or the int8 pair's per-row scales (the codes are finite by
    construction; ``quant.quantize_table`` carries a corrupt row's NaN/Inf
    into its scale)."""
    return _nonfinite_flag(tbl[-1])


def _ring_rotate(group: ShardGroup, blk: tuple, perm, compute, *,
                 overlap: bool):
    """One ring step: ``(compute(blk), the next block)``.  With ``overlap``
    the next block's send/recv is issued BEFORE the compute consumes the
    current one (two blocks alive — the double buffer); without, the
    compute drains first.  Both orders run the same kernels on the same
    values, so the factors are bit-equal either way."""
    if overlap:
        pending = group.shift(blk, perm)
        out = compute(blk)
        return out, pending.wait()
    out = compute(blk)
    return out, group.shift(blk, perm).wait()


def _gram_chunked(table, nb, rt, mk, solve_chunk):
    """``gather_gram`` over entity chunks of ``solve_chunk`` rows (an
    indivisible count padded with zero-mask rows, sliced off)."""
    if solve_chunk is None or solve_chunk >= nb.shape[0]:
        return gather_gram(table, nb, rt, mk)
    from cfk_tpu_torch.ops.pipeline import chunk_map

    e = nb.shape[0]
    arrs, _ = pad_rows_to_multiple((nb, rt, mk), solve_chunk)
    n = arrs[0].shape[0] // solve_chunk
    out = chunk_map(lambda ni, ri, mi: gather_gram(table, ni, ri, mi),
                    tuple(a.reshape(n, solve_chunk, *a.shape[1:])
                          for a in arrs), n)
    a = torch.cat([o[0] for o in out])[:e]
    b = torch.cat([o[1] for o in out])[:e]
    return a, b


def half_step_ring(group: ShardGroup, fixed_local, nb, rt, mk, cnt, *, lam,
                   solve_chunk=None, solver="auto", overlap=True,
                   fused_epilogue=None, health=False, reg_solve_algo=None,
                   table_dtype=None):
    """The padded layout's ring half-step (``cfk_tpu/parallel/spmd.py:
    121-249``): ``nb/rt/mk`` are this rank's ``RingBlocks`` rows [E, S, P]
    with neighbour indices local to the fixed shard that owns them; at step
    r this rank holds the block of fixed shard (rank − r) mod S.  S − 1
    transfers; the Grams sum across steps and one solve ends the half
    (K1, or the split route with ``fused_epilogue=False``).  ``health``
    returns ``(x, bad)`` with ``bad`` the in-flight non-finite flag."""
    s, my = group.size, group.rank
    table = quant.gather_operand_view(fixed_local, table_dtype)
    perm = [(i, (i + 1) % s) for i in range(s)]

    def gram_at(blk, t):
        return _gram_chunked(blk[0], nb[:, t], rt[:, t], mk[:, t],
                             solve_chunk)

    e, k = nb.shape[0], table.shape[-1]
    a = table.new_zeros((e, k, k), dtype=torch.float32)
    b = table.new_zeros((e, k), dtype=torch.float32)
    bad = torch.zeros((), dtype=torch.int32, device=table.device)
    blk = (table,)
    for r in range(s - 1):
        if health:
            bad = bad | _nonfinite_flag(blk[0])
        (ap, bp), blk = _ring_rotate(
            group, blk, perm, lambda cur, t=(my - r) % s: gram_at(cur, t),
            overlap=overlap)
        a, b = a + ap, b + bp
    if health:
        bad = bad | _nonfinite_flag(blk[0])
    ap, bp = gram_at(blk, (my - (s - 1)) % s)
    x = regularized_solve(a + ap, b + bp, cnt, lam, solver,
                          fused=fused_epilogue, algo=reg_solve_algo)
    return (x, bad) if health else x


def _make_tiled_slice_grams(blk: dict, statics, local_entities: int, *,
                            solver, in_kernel_gather, overlap, int8: bool):
    """The per-visit chunk walk both tiled rings share
    (``cfk_tpu/parallel/spmd.py:429-484``): the chunks of slice ``t``
    (``slice_starts``) against the rotated block ``tbl`` (data, or the int8
    (codes, scales) pair whose scale folds into the weight channel), added
    into the accumulator ``acc`` through K2 (``accum_grams``)."""
    from cfk_tpu_torch.ops.tiled import accum_grams

    starts = blk["slice_starts"]

    def slice_grams(acc, tbl, t):
        b = blk
        if int8:
            b = dict(blk, weight=quant.fold_scale(blk["weight"], tbl[1],
                                                  blk["neighbor_idx"]))
        accum_grams(tbl[0], b, local_entities, statics=statics,
                    solver=solver, in_kernel_gather=in_kernel_gather,
                    overlap=overlap, chunk_range=(starts[t], starts[t + 1]),
                    acc=acc)

    return slice_grams


def resolve_ici_group(config: ALSConfig) -> int:
    """The inner-ring size of ``hier_ring``: ``config.ici_group`` when set,
    else the ranks of one host (torchrun's ``LOCAL_WORLD_SIZE``) when that
    divides the shard count, else one flat ring (bit-identical to
    ``exchange='ring'``) — ``cfk_tpu/parallel/spmd.py:487-497``."""
    import os

    if config.ici_group is not None:
        return config.ici_group
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    if 0 < local <= config.num_shards and config.num_shards % local == 0:
        return local
    return config.num_shards


def hier_phase_count(num_shards: int, inner: int) -> int:
    """Outer phases of the hierarchical exchange (cross-group hops)."""
    if inner < 1 or num_shards % inner != 0:
        raise ValueError(
            f"inner ring size {inner} must divide num_shards={num_shards}")
    return num_shards // inner


def hier_phase_of_visit(visit_index: int, inner: int) -> int:
    """The outer phase a position of the visit order belongs to."""
    if inner < 1:
        raise ValueError(f"inner ring size {inner} must be >= 1")
    return visit_index // inner


def _tiled_ring_setup(fixed_local, blk, table_dtype):
    data, scale = quant.quantize_table(fixed_local, table_dtype)
    tbl0 = (data,) if scale is None else (data, scale)
    return tbl0, scale is not None


def half_step_tiled_ring(group: ShardGroup, fixed_local, blk: dict, chunks,
                         local_entities: int, *, lam, solver="auto",
                         overlap=True, fused_epilogue=None, health=False,
                         in_kernel_gather=None, reg_solve_algo=None,
                         table_dtype=None):
    """The tiled ring half-step (``cfk_tpu/parallel/spmd.py:676-806``): at
    step r this rank walks slice (rank − r) mod S's chunks against the
    block it holds (K2 per chunk into the persistent accumulator), with the
    next block's transfer in flight; one solve at the end."""
    s, my = group.size, group.rank
    statics = tuple(chunks[2:])
    tbl0, int8 = _tiled_ring_setup(fixed_local, blk, table_dtype)
    k = fixed_local.shape[-1]
    slice_grams = _make_tiled_slice_grams(
        blk, statics, local_entities, solver=solver,
        in_kernel_gather=in_kernel_gather, overlap=overlap, int8=int8)
    acc = (fixed_local.new_zeros((local_entities + 1, k, k),
                                 dtype=torch.float32),
           fixed_local.new_zeros((local_entities + 1, k),
                                 dtype=torch.float32))
    perm = [(i, (i + 1) % s) for i in range(s)]
    bad = torch.zeros((), dtype=torch.int32, device=fixed_local.device)
    tbl = tbl0
    for r in range(s - 1):
        if health:
            bad = bad | _payload_nonfinite_flag(tbl)
        _, tbl = _ring_rotate(
            group, tbl, perm,
            lambda cur, t=(my - r) % s: slice_grams(acc, cur, t),
            overlap=overlap)
    if health:
        bad = bad | _payload_nonfinite_flag(tbl)
    slice_grams(acc, tbl, (my - (s - 1)) % s)
    x = regularized_solve(acc[0][:local_entities], acc[1][:local_entities],
                          blk["count"], lam, solver, fused=fused_epilogue,
                          algo=reg_solve_algo)
    return (x, bad) if health else x


def half_step_tiled_ring_hier(group: ShardGroup, fixed_local, blk: dict,
                              chunks, local_entities: int, *, lam, inner,
                              solver="auto", overlap=True,
                              fused_epilogue=None, health=False,
                              in_kernel_gather=None, reg_solve_algo=None,
                              table_dtype=None):
    """The hierarchical tiled ring (``cfk_tpu/parallel/spmd.py:520-674``):
    ``S = outer·inner``; phase p rotates each group's blocks ``inner − 1``
    times over the inner ring, then one outer hop moves every held block
    to the same position of the next group.  Rank (g, i) at (phase p,
    inner step j) holds slice ((g − p) mod O)·I + (i + p − j) mod I.  The
    per-slice walk is the flat ring's; only the visit order differs, and
    with ``inner`` 1 or S the order — and every bit — is the flat ring's."""
    s, my = group.size, group.rank
    outer = hier_phase_count(s, inner)
    g, i_pos = my // inner, my % inner
    statics = tuple(chunks[2:])
    tbl0, int8 = _tiled_ring_setup(fixed_local, blk, table_dtype)
    k = fixed_local.shape[-1]
    inner_perm = [(q, (q // inner) * inner + (q % inner + 1) % inner)
                  for q in range(s)]
    outer_perm = [(q, ((q // inner + 1) % outer) * inner + q % inner)
                  for q in range(s)]
    slice_grams = _make_tiled_slice_grams(
        blk, statics, local_entities, solver=solver,
        in_kernel_gather=in_kernel_gather, overlap=overlap, int8=int8)
    acc = (fixed_local.new_zeros((local_entities + 1, k, k),
                                 dtype=torch.float32),
           fixed_local.new_zeros((local_entities + 1, k),
                                 dtype=torch.float32))
    bad = torch.zeros((), dtype=torch.int32, device=fixed_local.device)

    def held(p, j):
        return ((g - p) % outer) * inner + (i_pos + p - j) % inner

    tbl = tbl0
    for p in range(outer):
        for j in range(inner - 1):
            if health:
                bad = bad | _payload_nonfinite_flag(tbl)
            _, tbl = _ring_rotate(
                group, tbl, inner_perm,
                lambda cur, t=held(p, j): slice_grams(acc, cur, t),
                overlap=overlap)
        if health:
            bad = bad | _payload_nonfinite_flag(tbl)
        if p < outer - 1:
            _, tbl = _ring_rotate(
                group, tbl, outer_perm,
                lambda cur, t=held(p, inner - 1): slice_grams(acc, cur, t),
                overlap=overlap)
        else:
            slice_grams(acc, tbl, held(p, inner - 1))
    x = regularized_solve(acc[0][:local_entities], acc[1][:local_entities],
                          blk["count"], lam, solver, fused=fused_epilogue,
                          algo=reg_solve_algo)
    return (x, bad) if health else x


def gathered_half(group: ShardGroup, solve, *, with_gram=False,
                  with_prev=False, table_dtype=None):
    """The all_gather exchange every gathered layout shares
    (``cfk_tpu/parallel/spmd.py:314-365``): ``solve(fixed_full, blk, gram)``
    (``with_prev``: ``solve(fixed_full, prev_local, blk, gram)``) gets the
    whole fixed table — cast to bf16 before the gather for a bf16 table —
    and, ``with_gram`` (iALS), YᵀY of the rows the kernels read, summed
    over the ranks."""
    def prep(fixed_local):
        gram = None
        if with_gram:
            gram = group.all_reduce(global_gram(
                quant.gather_operand_view(fixed_local, table_dtype)))
        payload = fixed_local
        if quant.resolve_table_dtype(table_dtype) == "bfloat16":
            payload = payload.to(torch.bfloat16)
        return group.all_gather(payload), gram

    def half(fixed_local, blk):
        fixed_full, gram = prep(fixed_local)
        return solve(fixed_full, blk, gram)

    def half_prev(fixed_local, prev_local, blk):
        fixed_full, gram = prep(fixed_local)
        return solve(fixed_full, prev_local, blk, gram)

    return half_prev if with_prev else half


def wrap_step(group: ShardGroup, config: ALSConfig, half_m, half_u, mblk,
              ublk, *, carry_prev=False, ring_flags=False):
    """One iteration from two halves (``cfk_tpu/parallel/spmd.py:264-311``):
    movies from users, then users from movies, each cast to the storage
    dtype; ``carry_prev`` hands each half its side's previous factors
    (iALS++/ALS++).  With ``ring_flags`` every half returns ``(x, bad)``
    and the step returns ``(u, m, bad)``: the sum over both halves and all
    ranks of the exchange-corruption flags, a host int every rank agrees
    on."""
    from cfk_tpu_torch.models.als import storage_dtype

    dtype = storage_dtype(config)

    def solve_half(half, fixed, prev, blk):
        out = half(fixed, prev, blk) if carry_prev else half(fixed, blk)
        x, bad = out if isinstance(out, tuple) else (out, None)
        return x.to(dtype), bad

    def step(u, m):
        m_new, bad_m = solve_half(half_m, u, m, mblk)
        u_new, bad_u = solve_half(half_u, m_new, u, ublk)
        if not ring_flags:
            return u_new, m_new
        return u_new, m_new, int(group.all_reduce(bad_m + bad_u).item())

    return step


# -- the device side of one rank --------------------------------------------


def _side_to_device(kind: str, view, fixed_rows: int, device, *,
                    weighted: bool):
    """One half's device blocks and the static kwargs of its half-step:
    ``(blk, chunks, entities)``."""
    from cfk_tpu_torch.models import als as ma
    from cfk_tpu_torch.ops.kernels.gram_units import (
        derive_tile_units,
        stage_plans,
    )

    if kind == "ring":
        tree = _ring_to_tree(view)
        return ({k: torch.as_tensor(v, device=device)
                 for k, v in tree.items()}, None, int(view.count.shape[0]))
    if kind == "tiled_ring":
        dev = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
        blk = {key: dev(getattr(view, key)) for key in (
            "neighbor_idx", "rating", "weight", "tile_seg", "chunk_entity",
            "count")}
        blk["slice_starts"] = [int(x) for x in view.slice_starts]
        seg = torch.as_tensor(view.tile_seg).view(view.num_chunks, -1)
        blk.update(stage_plans(derive_tile_units(
            seg, view.tile_rows, view.chunk_entities + 1), device))
        return blk, ("tiled", view.mode) + view.statics, view.padded_entities
    if isinstance(view, TiledBlocks):
        return (ma._tiled_to_device(view, device, fixed_rows, weighted),
                ("tiled", view.mode) + view.statics, view.padded_entities)
    if isinstance(view, SegmentBlocks):
        return (ma._segment_to_device(view, device), view.statics,
                view.padded_entities)
    if isinstance(view, BucketedBlocks):
        blk, chunks = ma._bucketed_to_device(view, device)
        return blk, chunks, view.padded_entities
    return ma._blocks_to_device(view, device), None, view.padded_entities


def make_training_step(group: ShardGroup, config: ALSConfig, sides,
                       overrides=None, *, implicit: bool = False,
                       health_probe: bool = False):
    """``step(u, m)`` of one sharded iteration over this rank's device
    blocks (``cfk_tpu/parallel/spmd.py:899-1133``; iALS:
    ``cfk_tpu/models/ials.py:510-686``).  ``sides`` holds each half's
    ``(kind, blk, chunks, entities)``; ``overrides`` (the recovery
    ladder's λ, fused epilogue and solve route) default to the config's.
    With ``health_probe`` the step also returns the ring halves' agreed
    exchange flag."""
    from cfk_tpu_torch.models.als import _half, _half_kwargs, base_overrides

    ov = overrides or base_overrides(config)
    kw = _half_kwargs(config, ov)
    algo = config.algorithm
    pp = algo in ("als++", "ials++")
    common = dict(solver=config.solver, in_kernel_gather=config.in_kernel_gather,
                  table_dtype=config.table_dtype, overlap=config.overlap)
    if implicit:
        from cfk_tpu_torch.models.ials import _ials_half

        solve_fn = functools.partial(
            _ials_half, alpha=config.alpha, algorithm=algo,
            block_size=config.block_size, sweeps=config.sweeps,
            **common, **kw)
    else:
        solve_fn = functools.partial(
            _half, algorithm=algo, block_size=config.block_size,
            sweeps=config.sweeps, **common, **kw)
    ring_kw = dict(lam=kw["lam"], solver=config.solver,
                   overlap=config.overlap,
                   fused_epilogue=kw["fused_epilogue"], health=health_probe,
                   reg_solve_algo=kw["reg_solve_algo"],
                   table_dtype=config.table_dtype)

    def make_half(kind, blk, chunks, entities):
        if kind == "ring":
            solve_chunk = config.padded_solve_chunk(blk["neighbor"].shape[-1])
            return lambda fixed, b: half_step_ring(
                group, fixed, b["neighbor"], b["rating"], b["mask"],
                b["count"], solve_chunk=solve_chunk, **ring_kw)
        if kind == "tiled_ring":
            tiled_kw = dict(ring_kw, in_kernel_gather=config.in_kernel_gather)
            if config.exchange == "hier_ring":
                return lambda fixed, b: half_step_tiled_ring_hier(
                    group, fixed, b, chunks, entities,
                    inner=resolve_ici_group(config), **tiled_kw)
            return lambda fixed, b: half_step_tiled_ring(
                group, fixed, b, chunks, entities, **tiled_kw)
        extra = {}
        if not implicit:
            extra["solve_chunk"] = (
                config.padded_solve_chunk(blk["neighbor_idx"].shape[-1])
                if isinstance(blk, dict) and chunks is None else None)

        def solve(fixed_full, *rest):
            prev, b, gram = rest if pp else (None, *rest)
            if implicit:
                extra["gram"] = gram
            return solve_fn(fixed_full, b, chunks=chunks, entities=entities,
                            x_prev=prev, **extra)

        half = gathered_half(group, solve, with_gram=implicit, with_prev=pp,
                             table_dtype=config.table_dtype)
        if not health_probe:
            return half
        zero = torch.zeros((), dtype=torch.int32, device=group.device)
        if pp:
            return lambda fixed, prev, b: (half(fixed, prev, b), zero)
        return lambda fixed, b: (half(fixed, b), zero)

    (mk_, mblk, mch, me), (uk_, ublk, uch, ue) = sides
    return wrap_step(group, config, make_half(mk_, mblk, mch, me),
                     make_half(uk_, ublk, uch, ue), mblk, ublk,
                     carry_prev=pp, ring_flags=health_probe)


# -- the sharded trainers ------------------------------------------------------


def _rows(x: torch.Tensor, rank: int, num_shards: int) -> torch.Tensor:
    step = x.shape[0] // num_shards
    return x[rank * step:(rank + 1) * step]


def sharded_init(dataset: Dataset, config: ALSConfig, warm_start=None):
    """The whole initial (u, m) as CPU tensors in the storage dtype: the
    ``warm_start`` pair padded to the sharded row counts, else the
    avg-rating + U(0,1) users drawn at the REAL entity count and then
    padded, so the init does not depend on the shard count (it equals the
    one-rank trainer's — ``cfk_tpu/parallel/spmd.py:1412-1416``) — and zero
    movies."""
    from cfk_tpu_torch.models.als import _padded_seed, storage_dtype

    dt = storage_dtype(config)
    ub, mb = dataset.user_blocks, dataset.movie_blocks
    k = config.rank
    if warm_start is not None:
        return (_padded_seed(warm_start[0], ub.padded_entities, k, "user",
                             "cpu", dt),
                _padded_seed(warm_start[1], mb.padded_entities, k, "movie",
                             "cpu", dt))
    n = dataset.user_map.num_entities
    if isinstance(ub, PaddedBlocks):
        rsum = (torch.as_tensor(ub.rating) * torch.as_tensor(ub.mask)).sum(1)
    else:
        rsum = torch.as_tensor(ub.rating_sum)
    u = init_factors_stats(torch.Generator().manual_seed(config.seed),
                           rsum[:n], torch.as_tensor(ub.count)[:n], k)
    u = torch.cat([u, u.new_zeros((ub.padded_entities - n, k))])
    return u.to(dt), torch.zeros((mb.padded_entities, k), dtype=dt)


def _sharded_resilient_loop(group: ShardGroup, manager, *, model: str,
                            config: ALSConfig, u_shape, m_shape, init_fn,
                            make_step, metrics, checkpoint_every, health,
                            fault_injector, preemption_guard, watchdog,
                            save_meta):
    """The resilient loop bound to a rank group (``cfk_tpu/parallel/spmd.py:
    1193-1296``): resume read by rank 0 and broadcast, restores cut to this
    rank's rows, saves gathered on every rank (the collectives must pair)
    but written by rank 0 only, the probe word and the eviction agreed by
    every rank at the same iteration boundary."""
    from cfk_tpu_torch.models.als import (
        as_tensor,
        base_overrides,
        storage_dtype,
    )
    from cfk_tpu_torch.resilience import sentinel
    from cfk_tpu_torch.resilience.loop import (
        resilient_train_loop,
        save_checkpoint,
    )
    from cfk_tpu_torch.resilience.policy import policy_from_config
    from cfk_tpu_torch.transport.checkpoint import resume_state_synced

    dtype = storage_dtype(config)
    rank, size = group.rank, group.size

    def restore_fn(hu, hm):
        return tuple(_rows(as_tensor(h, "cpu"), rank, size).to(
            group.device, dtype) for h in (hu, hm))

    def save_fn(done, u, m):
        hu, hm = group.all_gather(u).cpu(), group.all_gather(m).cpu()
        if rank == 0:
            save_checkpoint(manager, done, hu, hm, meta=save_meta)

    def probe_fn(u, m):
        return group.agree_or(int(sentinel.probe_word(u, m,
                                                      health.norm_limit)))

    evict_sync_fn = (group.any if preemption_guard is not None and size > 1
                     else None)
    return resilient_train_loop(
        manager, model=model, rank=config.rank,
        num_iterations=config.num_iterations, u_shape=u_shape,
        m_shape=m_shape, dtype=dtype, init_fn=init_fn, make_step=make_step,
        base_overrides=base_overrides(config),
        metrics=metrics, checkpoint_every=checkpoint_every, health=health,
        policy=policy_from_config(config), fault_injector=fault_injector,
        device=group.device, preemption_guard=preemption_guard,
        watchdog=watchdog, num_shards=size,
        resume_fn=lambda: resume_state_synced(
            manager, group=group, rank=config.rank, model=model,
            num_iterations=config.num_iterations, u_shape=u_shape,
            m_shape=m_shape, num_shards=size),
        restore_fn=restore_fn, save_fn=save_fn,
        probe_fn=None if health is None else probe_fn,
        evict_sync_fn=evict_sync_fn)


def _rank_train(group: ShardGroup, sides, u0, m0, *, model: str,
                config: ALSConfig, fixed_rows, u_shape, m_shape,
                checkpoint_manager=None, checkpoint_every: int = 1,
                fault_injector=None, preemption_guard=None, watchdog=None,
                mesh_guard: bool = False, gather_to: str = "rank0"):
    """One rank's sharded training from its host blocks ``sides`` and its
    rows of the initial factors: (whole u, whole m, record) — on rank 0
    only (``gather_to="rank0"``, CPU tensors: a ``Mesh``'s result) or on
    every rank (``"all"``, device tensors: a torchrun-style process)."""
    from cfk_tpu_torch.models.als import as_tensor
    from cfk_tpu_torch.ops.solve import use_kernels
    from cfk_tpu_torch.parallel.mesh import evict_guard
    from cfk_tpu_torch.resilience.loop import validate_cadence
    from cfk_tpu_torch.resilience.sentinel import health_from_config
    from cfk_tpu_torch.telemetry.metrics import Metrics

    dev = group.device
    use_kernels(config.solver, dev)
    implicit = model == "ials"
    health = health_from_config(config)
    validate_cadence(checkpoint_every, health)
    metrics = Metrics()
    if mesh_guard:
        preemption_guard = evict_guard(group)
    with metrics.phase("blocks_to_device"):
        dsides = tuple((kind,) + _side_to_device(kind, view, rows, dev,
                                                 weighted=implicit)
                       for (kind, view), rows in zip(sides, fixed_rows))
        u0, m0 = as_tensor(u0, dev), as_tensor(m0, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    group.staged_bytes = 0

    make_step = functools.partial(
        make_training_step, group, config, dsides, implicit=implicit,
        health_probe=health is not None)
    u, m = _sharded_resilient_loop(
        group, checkpoint_manager, model=model, config=config,
        u_shape=u_shape, m_shape=m_shape,
        init_fn=lambda: (u0.clone(), m0.clone()), make_step=make_step,
        metrics=metrics, checkpoint_every=checkpoint_every, health=health,
        fault_injector=fault_injector, preemption_guard=preemption_guard,
        watchdog=watchdog,
        save_meta={"rank": config.rank, "model": model,
                   "exchange": config.exchange,
                   "num_shards": group.size})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    record = dict(
        route="sharded",
        reason=(f"{group.size} ranks, exchange {config.exchange} "
                f"({', '.join(k for k, *_ in dsides)}), backend "
                f"{group.backend}{' staged' if group.staged else ''}"),
        staged_bytes=group.staged_bytes,
        metrics=dict(counters=dict(metrics.counters), gauges=metrics.gauges,
                     phases=dict(metrics.phases), notes=metrics.notes))
    uu, mm = group.all_gather(u), group.all_gather(m)
    if gather_to == "all":
        return uu, mm, record
    return (uu.cpu(), mm.cpu(), record) if group.rank == 0 else None


def _merge_metrics(metrics, rec: dict) -> None:
    for k, v in rec["counters"].items():
        metrics.incr(k, v)
    for k, v in rec["gauges"].items():
        metrics.gauge(k, v)
    for k, v in rec["phases"].items():
        metrics.phases[k] += v
    for k, v in rec["notes"].items():
        metrics.note(k, v)


def sharded_payloads(dataset: Dataset, config: ALSConfig, num_shards: int,
                     *, model: str, warm_start=None):
    """The checks and the per-rank work of a sharded run: ``(payloads,
    kw)`` with ``payloads[r]`` rank r's host blocks and rows of the initial
    factors and ``kw`` the keywords every rank's ``_rank_train`` shares
    (``mesh.run(_rank_train, per_rank=payloads, **kw)`` is the run)."""
    from cfk_tpu_torch.models.als import _layout_of

    s = num_shards
    validate_sharded_dataset(dataset, config, s)
    built = _layout_of(dataset)
    if config.layout not in ("auto", built):
        raise ValueError(f"config.layout={config.layout!r} but the dataset "
                         f"was built with the {built} layout")
    if config.algorithm != "als" and built in ("tiled", "segment"):
        raise ValueError(
            f"{config.algorithm} runs on the padded and bucketed layouts; "
            f"this dataset was built with the {built} layout")
    halves = gathered_layout_trees(dataset, config)
    if model == "ials" and any(kind != "gather" for kind, _ in halves):
        raise ValueError(
            "iALS needs the full fixed side per shard (global-Gram trick): "
            "ring-built blocks are unusable — rebuild with "
            "Dataset.from_coo(..., ring=False)")
    u0, m0 = sharded_init(dataset, config, warm_start)
    kw = dict(model=model, config=config,
              fixed_rows=(dataset.user_blocks.padded_entities,
                          dataset.movie_blocks.padded_entities),
              u_shape=tuple(u0.shape), m_shape=tuple(m0.shape))
    payloads = [(tuple((kind, shard_view(b, r, s)) for kind, b in halves),
                 _rows(u0, r, s), _rows(m0, r, s)) for r in range(s)]
    return payloads, kw


def train_sharded(dataset: Dataset, config: ALSConfig, mesh, *, model: str,
                  warm_start=None, checkpoint_manager=None,
                  checkpoint_every: int = 1, metrics=None,
                  fault_injector=None, preemption_guard=None, watchdog=None):
    """The body both sharded trainers share: ``sharded_payloads``, then
    every rank's ``_rank_train`` — through ``mesh.run`` for a ``Mesh`` (the
    resilience arguments pickled to every rank, only rank 0 touching the
    checkpoint store; ``preemption_guard`` polled here and relayed), or in
    this process for a ``ShardGroup`` (every process holds the whole
    dataset; a rank's blocks are views of it)."""
    from cfk_tpu_torch.models.als import ALSModel
    from cfk_tpu_torch.telemetry.metrics import Metrics

    payloads, kw = sharded_payloads(dataset, config, mesh.size, model=model,
                                    warm_start=warm_start)
    metrics = metrics if metrics is not None else Metrics()
    metrics.gauge("num_users", dataset.user_map.num_entities)
    metrics.gauge("num_movies", dataset.movie_map.num_entities)
    metrics.gauge("num_ratings", int(dataset.movie_blocks.count.sum()))
    kw.update(checkpoint_manager=checkpoint_manager,
              checkpoint_every=checkpoint_every,
              fault_injector=fault_injector, watchdog=watchdog)
    if isinstance(mesh, Mesh):
        if checkpoint_manager is not None and \
                hasattr(checkpoint_manager, "wait_pending"):
            checkpoint_manager.wait_pending()
        out = mesh.run(_rank_train, per_rank=payloads,
                       guard=preemption_guard,
                       mesh_guard=preemption_guard is not None, **kw)
        u, m, record = out[0]
    else:
        u, m, record = _rank_train(mesh, *payloads[mesh.rank],
                                   preemption_guard=preemption_guard,
                                   gather_to="all", **kw)
    _merge_metrics(metrics, record.pop("metrics"))
    return ALSModel(user_factors=u, movie_factors=m,
                    num_users=dataset.user_map.num_entities,
                    num_movies=dataset.movie_map.num_entities,
                    pipeline=record)


def train_als_sharded(dataset: Dataset, config: ALSConfig, mesh, *,
                      warm_start=None, checkpoint_manager=None,
                      checkpoint_every: int = 1, metrics=None,
                      fault_injector=None, preemption_guard=None,
                      watchdog=None):
    """ALS-WR over ``config.num_shards`` ranks; semantics match
    ``train_als`` (``cfk_tpu/parallel/spmd.py:1297-1499``).

    ``mesh`` is a ``Mesh`` (``make_mesh``) or this process's ``ShardGroup``
    (``make_multihost_mesh``).  The exchange of each half follows
    ``config.exchange`` and how the blocks were built
    (``gathered_layout_trees``); ``warm_start=(u0, m0)`` seeds the factors
    as ``train_als`` does — how parity tests inject the JAX package's init.
    The checkpoint manager, health sentinel, fault injector, preemption
    guard and watchdog act as in ``train_als``, at the same iteration
    boundary on every rank; only rank 0 touches the store.  Returns the
    whole factors (a ``Mesh``: CPU tensors; a ``ShardGroup``: on its
    device); ``model.pipeline`` records the exchange, the backend and the
    bytes rank 0 staged through host memory.  ``config.offload_tier``
    ("host_window", or "auto" past one device's memory) runs every shard's
    windows from this process instead (``offload.windowed.
    train_als_host_window``)."""
    from cfk_tpu_torch.offload import windowed

    dev = torch.device(getattr(mesh, "device", None) or "cuda")
    if windowed.resolve_tier(dataset, config, dev) == "host_window":
        # The out-of-core tier, sharded (``cfk_tpu/parallel/spmd.py:
        # 1346-1383``): per-shard windows under the all_gather scan or the
        # ring/hier_ring visit orders, every shard driven from this process
        # on the mesh's device — the same bits as the resident exchange.
        windowed.refuse_unsupported(
            checkpoint_manager=checkpoint_manager,
            fault_injector=fault_injector,
            preemption_guard=preemption_guard, watchdog=watchdog)
        return windowed.train_als_host_window(dataset, config, device=dev,
                                              metrics=metrics)
    return train_sharded(dataset, config, mesh, model="als",
                         warm_start=warm_start,
                         checkpoint_manager=checkpoint_manager,
                         checkpoint_every=checkpoint_every, metrics=metrics,
                         fault_injector=fault_injector,
                         preemption_guard=preemption_guard,
                         watchdog=watchdog)


# -- per-rank kernel counters ------------------------------------------------


def _kernel_wrappers() -> dict:
    from cfk_tpu_torch.ops.kernels import gram_kernel as gk
    from cfk_tpu_torch.ops.kernels import solve_kernel as sk
    from cfk_tpu_torch.serving import topk_kernel as tk

    return {"reg_solve": sk.reg_solve, "gram_gather": gk.gram_gather,
            "gram_solve_dense": gk.gram_solve_dense,
            "topk_scores": tk.topk_scores, "gather_rows": gk.gather_rows,
            "gram_solve_gather": gk.gram_solve_gather,
            "gram_tiles_dense_gather": gk.gram_tiles_dense_gather,
            "gauss_solve": sk.gauss_solve,
            "gauss_solve_multi": sk.gauss_solve_multi}


def reset_kernel_launches(group: ShardGroup) -> None:
    """Zero this rank's kernel launch counters (they count per process)."""
    from cfk_tpu_torch.serving.topk_kernel import reset_launches

    for fn in _kernel_wrappers().values():
        fn.launches = 0
    reset_launches()


def kernel_launches(group: ShardGroup) -> dict:
    """This rank's kernel launch counts since the last reset."""
    return {name: int(getattr(fn, "launches", 0))
            for name, fn in _kernel_wrappers().items()}


# -- item-axis sharded top-K serving -----------------------------------------


def _serve_rank(group: ShardGroup, u, table, scale, seen_tiles, *, k_top,
                num_movies, tile_m, row_offset, gather_to="rank0"):
    """One rank's part of ``serve_topk_sharded``: K4 over its table slice at
    its ``row_offset``, then one all_gather of the [B, K] selections and the
    merge in rank order (a stable descending sort: equal scores keep the
    lower rank's, i.e. the lower id — the one-rank scan's order)."""
    from cfk_tpu_torch.models.als import as_tensor
    from cfk_tpu_torch.serving.topk_kernel import topk_scores

    dev = group.device
    put = lambda x: None if x is None else as_tensor(x, dev)  # noqa: E731
    v, ids = topk_scores(put(u), put(table), put(scale), put(seen_tiles),
                         k_top=k_top, num_movies=num_movies, tile_m=tile_m,
                         row_offset=row_offset)
    cat_v = group.all_gather_cols(v)
    cat_i = group.all_gather_cols(ids)
    mv, pos = torch.sort(cat_v, dim=1, descending=True, stable=True)
    out = mv[:, :k_top], torch.gather(cat_i, 1, pos[:, :k_top])
    if gather_to == "all":
        return out
    return tuple(x.cpu() for x in out) if group.rank == 0 else None


@dataclasses.dataclass(frozen=True)
class PlacedTable:
    """A serving table whose row slices already live on a ``Mesh``'s ranks
    (``place_table_sharded``): ``serve_topk_sharded`` then ships each rank
    only the [B, k] batch and its seen rectangles.  ``shape`` is the padded
    table's [M_pad, k]."""

    name: str
    version: int
    shape: tuple


# A Mesh rank's placed tables: name -> {version: (table, scale)}, the
# newest _PLACED_KEEP versions of each, so a batch that took its handle just
# before a rollover still finds its table.
_PLACED: dict = {}
_PLACED_KEEP = 2


def _place_rank(group, table, scale, *, name, version):
    from cfk_tpu_torch.models.als import as_tensor

    versions = _PLACED.setdefault(name, {})
    versions[version] = (as_tensor(table, group.device),
                         None if scale is None
                         else as_tensor(scale, group.device))
    for old in sorted(versions)[:-_PLACED_KEEP]:
        del versions[old]


def place_table_sharded(mesh, table, scale, *, tile_m: int, name: str,
                        version: int = 0):
    """Put each rank's row slice of the padded [M_pad, k] serving table (and
    its int8 ``scale``) on that rank once, under ``name`` and ``version``:
    the handle (a ``PlacedTable``) replaces the table in later
    ``serve_topk_sharded`` calls.  A ``ShardGroup`` holds the whole table in
    its own process, so there is nothing to place: None."""
    if not isinstance(mesh, Mesh):
        return None
    rows = _serve_rows(mesh.size, table.shape[0], tile_m)

    def cut(x, r):
        return None if x is None else x[r * rows:(r + 1) * rows].cpu()

    mesh.run(_place_rank, per_rank=[(cut(table, r), cut(scale, r))
                                    for r in range(mesh.size)],
             name=name, version=version)
    return PlacedTable(name, version, tuple(table.shape))


def _serve_rows(shards: int, m_pad: int, tile_m: int) -> int:
    if m_pad % (shards * tile_m) != 0:
        raise ValueError(
            f"table rows {m_pad} not divisible by shards×tile_m "
            f"({shards}×{tile_m}); pad with serving.engine.pad_table")
    return m_pad // shards


def serve_topk_sharded(mesh, u, table, scale, seen_tiles, *, k_top: int,
                       num_movies: int, tile_m: int = 512):
    """Item-axis sharded score + top-K: (scores [B, K], movie rows [B, K])
    (``cfk_tpu/parallel/spmd.py:1500-1579``).  The [M_pad, k] table (M_pad
    a multiple of ranks·tile_m), its int8 ``scale`` and the ``seen_tiles``
    rectangles split over the ranks, the [B, k] batch goes to every rank,
    each rank's K4 scans its slice at its ``row_offset``, and one
    all_gather of the per-rank [B, K] selections feeds the merge — no score
    block crosses a rank, and the result is bit-equal to the one-rank scan.
    A ``Mesh`` returns CPU tensors from rank 0; a ``ShardGroup`` (each
    process holding the whole table) returns them on its device.  With a
    ``Mesh``, ``table`` may be the ``PlacedTable`` of
    ``place_table_sharded`` (``scale`` is then the placed one): the table
    stays on the ranks between calls."""
    s = mesh.size
    placed = table if isinstance(table, PlacedTable) else None
    if placed is not None and not isinstance(mesh, Mesh):
        raise TypeError("a PlacedTable serves through the Mesh it was "
                        "placed on")
    rows = _serve_rows(s, table.shape[0], tile_m)
    tiles = rows // tile_m
    kw = dict(k_top=k_top, num_movies=num_movies, tile_m=tile_m)

    ship = isinstance(mesh, Mesh)

    def part(r):
        def cut(x, n=None):
            if x is None:
                return None
            x = x if n is None else x[r * n:(r + 1) * n]
            # A Mesh's ranks get host copies (spawned processes unpickle
            # them onto their own device).
            return x.cpu() if ship and torch.is_tensor(x) else x
        if placed is not None:
            return cut(u), None, None, cut(seen_tiles, tiles)
        return (cut(u), cut(table, rows), cut(scale, rows),
                cut(seen_tiles, tiles))

    if isinstance(mesh, Mesh):
        if placed is not None:
            kw["placed"] = (placed.name, placed.version)
        out = mesh.run(_serve_rank_entry,
                       per_rank=[part(r) + (r * rows,) for r in range(s)],
                       **kw)
        return out[0]
    return _serve_rank(mesh, *part(mesh.rank), row_offset=mesh.rank * rows,
                       gather_to="all", **kw)


def _serve_rank_entry(group, u, table, scale, seen_tiles, row_offset,
                      placed=None, **kw):
    if placed is not None:
        name, version = placed
        try:
            table, scale = _PLACED[name][version]
        except KeyError:
            raise KeyError(
                f"rank {group.rank} holds no placed table {name!r} version "
                f"{version} (it keeps the newest {_PLACED_KEEP}); place it "
                "again with place_table_sharded") from None
    return _serve_rank(group, u, table, scale, seen_tiles,
                       row_offset=row_offset, **kw)
