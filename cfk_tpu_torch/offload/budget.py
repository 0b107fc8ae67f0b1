"""The memory-budget predicate of the out-of-core tier.

The port's own copy of ``cfk_tpu/offload/budget.py`` (pure arithmetic, no
torch): the predicate that decides whether both factor tables and the block
arrays fit one device (``fits_device``) is the same arithmetic the windowed
trainer (``offload.windowed``) sizes its windows, its staging pool, its
hot-row partition and its Gram accumulator with, so ``offload_tier="auto"``
can never pick the resident tier for a shape the trainer would call too big.

What counts as resident for one training iteration (the ``device`` tier):

- both factor tables at the storage dtype (the half-steps read one side
  while writing the other; the gather paths keep a working copy of the
  fixed side at the table dtype, charged as one extra fixed-table copy);
- the block arrays: per rating per side, neighbor index + rating +
  weight/meta (int32/f32 each), inflated by the tiled layout's tile-padding
  share;
- the transient chunk working set rides the headroom fraction.

``RESIDENT_FRACTION`` leaves headroom for accumulators, carries and the
runtime.  The memory size it multiplies is the device's own:
``device_memory_bytes`` reads ``torch.cuda.get_device_properties(dev).
total_memory`` on a card, and on the CPU takes the reference's nominal host
figure (``cfk_tpu/plan/spec.py:231``, 32 GiB) — the one a caller overrides
with ``device_budget_bytes`` to force windows on a small problem.  The
planner's helpers (``shape_fits_device``, ``planner_hot_rows``) wait for the
port's planner.
"""

from __future__ import annotations

# The reference's nominal host memory (``cfk_tpu/plan/spec.py:231``): the
# budget a CPU run sizes against unless its caller passes one.
CPU_NOMINAL_BYTES = 32 * 1024**3

RESIDENT_FRACTION = 0.9
# Staged window double-buffer: two windows (current + prefetched) are alive
# at once, so the per-window budget is half the staging share.
WINDOW_BUFFERS = 2
# Tiled stream padding share (the measured tile-padding factor at the full
# Netflix build — cfk_tpu/plan/cost.py's _GATHER_PAD_FACTOR["tiled"]).
_TILE_PAD = 1.26
# Bytes per rating per side in the stream blocks: neighbor idx (4) +
# rating (4) + weight (4).
_BLOCK_BYTES_PER_CELL = 12.0


def dtype_bytes(name: str | None) -> int:
    """Itemsize of a factor-storage / table dtype name (None → float32)."""
    return {None: 4, "float32": 4, "bfloat16": 2, "int8": 1}[name]


def factor_table_bytes(entities: int, rank: int,
                       dtype: str | None = "float32") -> float:
    return float(entities) * rank * dtype_bytes(dtype)


def shard_entity_range(rows: int, num_shards: int, shard: int
                       ) -> tuple[int, int]:
    """Entity-range shard ``shard``'s [lo, hi) rows — the SAME clipped
    ceil-split ``HostFactorStore`` places shards with (a ceil-split can
    overshoot ``rows`` by more than one shard: rows=10 / 7 shards walks
    past 10 at shard 5, so both bounds clip and trailing shards are
    empty)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} outside [0, {num_shards})")
    per = -(-rows // num_shards)
    return min(shard * per, rows), min((shard + 1) * per, rows)


def train_resident_bytes(num_users: int, num_movies: int, nnz: int,
                         rank: int, *, dtype: str = "float32",
                         table_dtype: str | None = None,
                         num_shards: int = 1,
                         donation: bool = True) -> dict:
    """PER-SHARD resident bytes of one device-tier training iteration.

    Returns the breakdown dict (the scale lab records it per row); the
    ``total`` key is what ``fits_device`` compares against ONE device's
    budget.  Sharding divides what actually shards — each device holds
    its slice of the factor tables and its slice of the block arrays —
    but NOT the gather working copy: the all_gather exchange materializes
    the full fixed side on every device each half-iteration, which is
    exactly why an oversized table stays oversized at any shard count and
    the host_window tier remains the answer (the ring exchanges trade the
    copy for an [E_local, k, k] accumulator, bounded separately by the
    block build's ``accum_max_entities`` gate).

    ``donation``: the resident trainers donate their factor
    arguments through the iteration jit (``models/als.py`` /
    ``parallel/spmd.py`` ``donate_argnums=(0, 1)``), so a half-step's
    solved output ALIASES the side it replaces — input and output never
    coexist, which is the arithmetic the default charges (bit-identical
    to the totals without the credit).  ``donation=False`` is the un-donated
    accounting: the larger side's fresh output buffer coexists with its
    predecessor at the solve boundary, charged as one extra table side —
    the credit the scale-sweep rows record so a tier decision that only
    holds BECAUSE of donation is visible in provenance."""
    shards = max(int(num_shards), 1)
    tables = factor_table_bytes(num_users + num_movies, rank, dtype) / shards
    # The gather working copy of the fixed side (zero-row append / quantized
    # view); charge the LARGER side at the effective gather cell size.
    gather_copy = factor_table_bytes(
        max(num_users, num_movies), rank,
        table_dtype if table_dtype is not None else dtype,
    )
    blocks = 2.0 * nnz * _BLOCK_BYTES_PER_CELL * _TILE_PAD / shards
    solve_output = (
        0.0 if donation
        else factor_table_bytes(max(num_users, num_movies), rank, dtype)
        / shards
    )
    total = tables + gather_copy + blocks + solve_output
    return {
        "factor_tables_bytes": tables,
        "gather_copy_bytes": gather_copy,
        "block_arrays_bytes": blocks,
        "solve_output_bytes": solve_output,
        "num_shards": shards,
        "total": total,
    }


def fits_device(num_users: int, num_movies: int, nnz: int, rank: int, *,
                hbm_bytes: float, dtype: str = "float32",
                table_dtype: str | None = None,
                num_shards: int = 1, donation: bool = True) -> bool:
    """THE device-tier feasibility predicate (planner AND executor) —
    per-shard arithmetic against ONE device's budget.  ``donation=True``
    (the default — the trainers really do donate) credits the solved
    side's aliased output; False is the un-donated comparison arm."""
    return (
        train_resident_bytes(
            num_users, num_movies, nnz, rank,
            dtype=dtype, table_dtype=table_dtype, num_shards=num_shards,
            donation=donation,
        )["total"]
        <= hbm_bytes * RESIDENT_FRACTION
    )


def window_budget_bytes(hbm_bytes: float,
                        reserved_bytes: float = 0.0,
                        buffers: int = WINDOW_BUFFERS) -> float:
    """Per-window staging budget: the headroom fraction of the device
    MINUS any persistent device state the trainer holds alongside the
    windows (the ring modes' per-entity Gram accumulator — see
    ``ring_accumulator_reservation``), split across the ``buffers`` live
    windows.  ``buffers`` defaults to the classic double buffer (current
    + one prefetched); the pooled staging engine sizes its windows at the
    same 2 and then admits extra pool depth from the leftover share
    (``max_pool_depth``) — the "staging arena" term."""
    return max(
        hbm_bytes * RESIDENT_FRACTION - reserved_bytes, 0.0
    ) / max(int(buffers), 1)


def max_pool_depth(hbm_bytes: float, worst_window_bytes: float,
                   reserved_bytes: float = 0.0) -> int:
    """The deepest staging pool the budget admits: ``depth + 1`` windows
    (``depth`` staged ahead + one consuming) of the worst window must fit
    the staging share next to the reserved device state.  Never below 1
    (one window ahead == the classic double buffer's footprint)."""
    share = max(hbm_bytes * RESIDENT_FRACTION - reserved_bytes, 0.0)
    live = int(share // max(float(worst_window_bytes), 1.0))
    return max(live - 1, 1)


# --- hot-row device cache ---------------------------------------
#
# The skew-aware hot partition keeps the top-f fixed-table rows device-
# resident at the STAGING dtype, so windows stage only their cold
# residual.  Its bytes are a RESERVATION next to the ring-accumulator
# term: persistent device state the window double-buffer split must not
# promise away.  The planner (plan/resolver.py) and the executor
# (offload/windowed.py) consult the SAME arithmetic here — the planner
# with the fraction cap below (it sizes no windows), the executor with
# the exact residual after the accumulator + window + delta-arena terms.

# The planner-side cap: the hot partition may claim at most this share of
# the budget fraction — the remainder is the window double buffer +
# accumulator share the resolver cannot size without the real blocks.
# The executor's exact arithmetic usually admits more; this cap only has
# to guarantee the resolver never promises a reservation the window
# sizing cannot live beside.
HOT_BUDGET_FRACTION = 0.5

def stage_row_bytes(rank: int, stage_dtype: str | None) -> float:
    """Bytes one staged/hot-resident table row occupies at the staging
    dtype: ``rank`` cells plus the int8 scheme's per-row f32 scale."""
    cell = dtype_bytes(stage_dtype)
    overhead = 4.0 if stage_dtype == "int8" else 0.0
    return float(rank) * cell + overhead


def hot_reservation_bytes(hot_rows: int, rank: int,
                          stage_dtype: str | None) -> float:
    """Persistent device bytes of a ``hot_rows``-row hot partition (both
    sides' partitions sum — callers pass the total row count)."""
    return max(int(hot_rows), 0) * stage_row_bytes(rank, stage_dtype)


def delta_arena_bytes(window_rows: int, rank: int,
                      stage_dtype: str | None) -> float:
    """The delta-staging arena bound: ONE predecessor window's assembled
    table stays device-resident while its successor assembles (the
    device-to-device reuse source), on top of the classic double buffer —
    charged at the worst window's table share."""
    return float(window_rows) * stage_row_bytes(rank, stage_dtype)


def max_hot_rows(hbm_bytes: float, rank: int, stage_dtype: str | None,
                 reserved_bytes: float = 0.0) -> int:
    """The largest hot partition (total rows, both sides) the budget
    admits next to ``reserved_bytes`` of other persistent state.  The
    executor passes the exact reservation (ring accumulators + the live
    window buffers + the delta arena); the planner, which has not sized
    windows yet, passes 0 and the ``HOT_BUDGET_FRACTION`` cap holds the
    window share instead."""
    share = max(hbm_bytes * RESIDENT_FRACTION - reserved_bytes, 0.0)
    if reserved_bytes == 0.0:
        share *= HOT_BUDGET_FRACTION
    return int(share // stage_row_bytes(rank, stage_dtype))


def hot_reservation_fits(hot_rows: int, rank: int,
                         stage_dtype: str | None, hbm_bytes: float,
                         reserved_bytes: float = 0.0) -> bool:
    """THE hot-reservation predicate (planner AND executor): can a
    ``hot_rows``-row partition live beside ``reserved_bytes``?  The
    planner refuses a pinned-impossible reservation at resolution with
    this; the executor re-checks with its exact terms."""
    return (int(hot_rows)
            <= max_hot_rows(hbm_bytes, rank, stage_dtype,
                            reserved_bytes=reserved_bytes))


def ring_accumulator_bytes(local_entities: int, rank: int) -> float:
    """Persistent device bytes of one shard's ring-mode Gram accumulator:
    the f32 [E_local+1, k, k] + [E_local+1, k] carry pair the windowed
    ring trainer holds across every window of a half-step (the same
    structure the resident ring carries in-place)."""
    return float(local_entities + 1) * rank * (rank + 1) * 4.0


def gram_accumulator_bytes(rank: int) -> float:
    """Persistent device bytes of the implicit path's global-Gram
    accumulator: the f32 [k, k] YᵀY of one fixed side, held
    across a half-step's windows and rebuilt per half."""
    return float(rank) * rank * 4.0


def gram_reservation_bytes(rank: int, stage_dtype: str | None, *,
                           block_rows: int = 4096) -> float:
    """What windowed iALS/iALS++ must RESERVE for the global-Gram
    reduction: the [k, k] f32 accumulator itself plus the double-buffered
    streamed factor blocks it is reduced from (``block_rows`` rows of the
    fixed store crossing PCIe at the staging dtype per reduction step —
    the same block grid the resident ``global_gram_blocked`` scans, so
    the windowed reduction is bit-identical to the resident Gram).

    The default ``block_rows`` mirrors ``ops.solve.GRAM_BLOCK_ROWS``; it
    is a parameter here so this module needs no import of ``ops``."""
    return (gram_accumulator_bytes(rank)
            + WINDOW_BUFFERS * block_rows * stage_row_bytes(rank,
                                                            stage_dtype))


def ring_accumulator_reservation(local_entities: int, rank: int, *,
                                 donated: bool = True) -> float:
    """What the window sizing must RESERVE for the ring accumulator.

    With buffer donation through the per-window accumulation jit
    (``offload/windowed.py`` ``_ring_window_jit`` donates its carry pair,
    the in-place accumulation of the port's ring windows) the output
    accumulator ALIASES the input, so exactly one copy is live: ×1.
    Without donation the dispatch boundary keeps a window call's input
    AND output accumulators alive: ×2 — the undonated accounting, kept as
    the comparison arm so a shape that fits only because of donation is
    attributable to it."""
    return ((1.0 if donated else 2.0)
            * ring_accumulator_bytes(local_entities, rank))


def fleet_host_ram_bytes(num_users: int, num_movies: int, nnz: int,
                         rank: int, *, dtype: str = "float32",
                         processes: int = 1, armed: bool = True) -> dict:
    """PER-PROCESS host-RAM bytes of the FLEET out-of-core tier
   : what one host must hold when ``train_als_host_window``
    runs multi-process with per-process store slices and the distributed
    window exchange.

    - both factor-store SLICES at the storage dtype — the term that
      scales OUT with the fleet (the whole point: a table no single host
      fits splits across processes);
    - last-good snapshot copies of both slices when the sentinel is
      armed (the rollback ladder's in-RAM restore point — ×2 slices);
    - the residual mirror's worst case: every fixed-table row OUTSIDE
      the slice arrives over DCN for the larger side (value bytes + an
      int64 row id each).  The exchange manifests bound this exactly at
      plan time; this predicate prices shapes WITHOUT building plans, so
      it charges the all-remote-referenced ceiling;
    - this host's share of the block arrays (per-shard streams — the
      contiguous shard-block ownership splits them with the stores).

    Pure arithmetic, like the rest of this module."""
    p = max(int(processes), 1)
    row = rank * dtype_bytes(dtype)
    slices = float(num_users + num_movies) * row / p
    snapshots = slices if not armed else 2.0 * slices
    larger = float(max(num_users, num_movies))
    mirror = (larger - larger / p) * (row + 8.0)
    blocks = 2.0 * nnz * _BLOCK_BYTES_PER_CELL * _TILE_PAD / p
    total = slices + snapshots + mirror + blocks
    return {
        "store_slices_bytes": slices,
        "snapshot_bytes": snapshots,
        "mirror_bytes": mirror,
        "block_arrays_bytes": blocks,
        "processes": p,
        "total": total,
    }


def fits_fleet_host(num_users: int, num_movies: int, nnz: int, rank: int,
                    *, host_ram_bytes: float, dtype: str = "float32",
                    processes: int = 1, armed: bool = True) -> bool:
    """THE fleet host-RAM predicate: does one process's share of the
    out-of-core tier fit one host's RAM budget?  ``processes=1`` is the
    single-host question — the resolver's fleet provenance proves a
    shape that fails here at P=1 passes at the fleet size, which is the
    claim that makes multi-process training worth its DCN bytes."""
    need = fleet_host_ram_bytes(num_users, num_movies, nnz, rank,
                                dtype=dtype, processes=processes,
                                armed=armed)["total"]
    return need <= host_ram_bytes * RESIDENT_FRACTION


def device_memory_bytes(device) -> float:
    """The memory size the budget divides: the card's ``total_memory``
    (``torch.cuda.get_device_properties``), or ``CPU_NOMINAL_BYTES`` on the
    CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return float(torch.cuda.get_device_properties(dev).total_memory)
    return float(CPU_NOMINAL_BYTES)
