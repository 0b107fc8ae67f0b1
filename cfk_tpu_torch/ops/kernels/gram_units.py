"""Work units of the Gram kernels: how a chunk's segments are cut for the
card (``csrc/gram_kernels.cuh``).

A Gram kernel walks each owner segment's rows in passes of ``PASS_ROWS``
rows.  A work unit is at most ``UNIT_PASSES`` consecutive passes (1,024
rows) of one segment; the grid is units, so one hot segment is spread over
as many CTAs as it has units.  Each unit sums its passes into a register
partial from zero, and a segment's sum is its partials added in unit order
— the two-level sum the kernels use to stay accurate over a million-row
segment, made deterministic.

Segment s with P_s passes has ``max(1, ceil(P_s / 32))`` units, except
segment 0, which has ``P_0 // 32 + 1``: its last unit never holds a full 32
passes (it may hold none), so the carry of the previous chunk is always
folded into a partial that ends the segment, as a single CTA folds it into
the partial left after its last full block.  Every segment has a unit, so
a segment owning no row still writes its zeros (or x = 0).

A plan is ``UnitPlan(units, splits, scratch_rows)``:

- ``units`` [U, 4] int32, one record per unit ``(s, start, end, n | j <<
  16)``: segment s (-1: a surplus slot, which exits), where its walk
  starts and ends, the segment's unit count n and the unit's index j in
  it.  The tile walk: the rows [start,
  end) of the chunk's stream.  The dense walk: start = i·T + r, the
  tile-aligned position of the unit's first pass (tile i, window row r, r
  ≡ lo_i mod 32), end = the segment's end tile; a unit with no pass has
  start = end·T.  A segment's units are consecutive; split segments
  (n > 1) come first, so their partials fill scratch rows [0, scratch_rows).
- ``splits`` [Sp] int32: the first unit of each split segment (-1: surplus).
- ``scratch_rows``: the rows of [k² + k] float32 scratch the split units'
  partials need.

``derive_tile_units`` and ``derive_dense_units`` derive the plans of one
chunk, or of a stack of chunks at once, on the tensors' own device without
a host sync, padded to a bound fixed by the shapes alone — what the
wrappers do when called without a plan.  The device upload derives every
chunk's plan in one batch and trims the common padding (``stage_plans``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PASS_ROWS = 32  # csrc/common.cuh kRows
UNIT_PASSES = 32  # csrc/common.cuh kUnitPasses
UNIT_ROWS = PASS_ROWS * UNIT_PASSES


class UnitPlan(NamedTuple):
    units: torch.Tensor  # [U, 4] int32 (s, start, end, n | j << 16)
    splits: torch.Tensor  # [Sp] int32 first unit of each split segment
    scratch_rows: int


def _units_per_segment(passes):
    """[NC, S] unit counts: max(1, ceil(P/32)); segment 0: P // 32 + 1."""
    n = (passes + UNIT_PASSES - 1) // UNIT_PASSES
    n = n + (n == 0)
    n[:, 0] = passes[:, 0] // UNIT_PASSES + 1
    return n


def _check_rows(rows: int) -> None:
    # A record packs a segment's unit count and a unit's index in 16 bits
    # each: at most C/1,024 + 2 < 2^16 units a segment.
    if rows >= 2**26:
        raise ValueError(f"chunk of {rows} rows: the Gram kernels take < 2^26")


def _derive(n, bound: int):
    """Per chunk and unit slot u < bound: (segment, index j, valid), split
    segments first, and the split segments' first units."""
    nc, s = n.shape
    order = torch.argsort((n <= 1).to(torch.int8), dim=1, stable=True)
    n_o = n.gather(1, order)
    cum = torch.cumsum(n_o, 1)
    u = torch.arange(bound, device=n.device).expand(nc, bound)
    pos = torch.searchsorted(cum, u.contiguous(), right=True)
    valid = pos < s
    pos = pos.clamp(max=s - 1)
    seg_u = order.gather(1, pos)
    j = u - (cum.gather(1, pos) - n_o.gather(1, pos))
    nsp = min(s, bound - s)
    first = (cum - n_o)[:, :nsp]
    splits = torch.where(n_o[:, :nsp] > 1, first, -1).to(torch.int32)
    return seg_u, j, valid, splits


def _finish(seg_u, j, start, end, n, valid, splits, bound, num_segments,
            batched):
    units = torch.stack([seg_u, start, end, n.gather(1, seg_u) | (j << 16)],
                        dim=2)
    units = torch.where(valid[..., None], units, -1).to(torch.int32)
    # Each split segment has >= 2 units: its units number at most twice the
    # units beyond one per segment.
    scratch = max(1, min(bound, 2 * (bound - num_segments)))
    if not batched:
        return UnitPlan(units[0].contiguous(), splits[0].contiguous(),
                        scratch)
    return UnitPlan(units, splits, scratch)


def derive_tile_units(seg: torch.Tensor, tile_rows: int,
                      num_segments: int) -> UnitPlan:
    """The plan of a tile chunk, seg [NT] (sorted tile owners), or of a
    stack of them, seg [NC, NT] (units [NC, U, 4], splits [NC, Sp]), on
    seg's device: S + C/1,024 + 1 unit slots a chunk (C = NT·T rows; no
    host sync)."""
    batched = seg.dim() == 2
    seg = (seg if batched else seg[None]).long()
    nc, nt = seg.shape
    s_count, c = num_segments, nt * tile_rows
    _check_rows(c)
    rows = torch.zeros((nc, s_count), dtype=torch.int64,
                       device=seg.device).scatter_add_(
        1, seg, torch.full_like(seg, tile_rows))
    row0 = torch.cumsum(rows, 1) - rows
    n = _units_per_segment((rows + PASS_ROWS - 1) // PASS_ROWS)
    bound = s_count + c // UNIT_ROWS + 1
    seg_u, j, valid, splits = _derive(n, bound)
    row0_u = row0.gather(1, seg_u)
    row1 = row0_u + rows.gather(1, seg_u)
    start = torch.minimum(row0_u + UNIT_ROWS * j, row1)
    end = torch.minimum(start + UNIT_ROWS, row1)
    return _finish(seg_u, j, start, end, n, valid, splits, bound, s_count,
                   batched)


def derive_dense_units(meta: torch.Tensor, tile_rows: int, num_tiles: int,
                       num_groups: int, num_segments: int) -> UnitPlan:
    """The plan of a dense-stream chunk, meta [NG + 4·NT] (g_blk ‖ lb ‖ lo
    ‖ hi ‖ seg), or of a stack of them, meta [NC, NG + 4·NT], on meta's
    device: S + NT·ceil(T/32)/32 unit slots a chunk (no host sync)."""
    batched = meta.dim() == 2
    meta = (meta if batched else meta[None]).long()
    t, nt, ng, s_count = tile_rows, num_tiles, num_groups, num_segments
    _check_rows(nt * t)
    nc = meta.shape[0]
    lo = meta[:, ng + nt:ng + 2 * nt]
    hi = meta[:, ng + 2 * nt:ng + 3 * nt]
    seg = meta[:, ng + 3 * nt:ng + 4 * nt].contiguous()
    tile_passes = ((hi - lo).clamp_min(0) + PASS_ROWS - 1) // PASS_ROWS
    passes = torch.zeros((nc, s_count), dtype=torch.int64,
                         device=meta.device).scatter_add_(1, seg, tile_passes)
    cum = torch.cat([tile_passes.new_zeros(nc, 1),
                     torch.cumsum(tile_passes, 1)], dim=1)
    ids = torch.arange(s_count, device=meta.device).expand(nc, s_count)
    t0 = torch.searchsorted(seg, ids.contiguous())
    t1 = torch.searchsorted(seg, ids.contiguous(), right=True)
    n = _units_per_segment(passes)
    bound = s_count + nt * -(-t // PASS_ROWS) // UNIT_PASSES
    seg_u, j, valid, splits = _derive(n, bound)
    t1_u = t1.gather(1, seg_u)
    q = cum.gather(1, t0.gather(1, seg_u)) + UNIT_PASSES * j
    live = UNIT_PASSES * j < passes.gather(1, seg_u)
    i = (torch.searchsorted(cum, q, right=True) - 1).clamp(max=nt - 1)
    start = torch.where(
        live, i * t + lo.gather(1, i) + PASS_ROWS * (q - cum.gather(1, i)),
        t1_u * t)
    return _finish(seg_u, j, start, t1_u, n, valid, splits, bound, s_count,
                   batched)


def stage_plans(plan: UnitPlan, device) -> dict:
    """A stack of chunk plans (``derive_*`` on [NC, ...]) for the device
    upload: ``units`` [NC, Umax, 4] and ``unit_splits`` [NC, Spmax] trimmed
    to the widest chunk (a host sync), and ``unit_scratch``, the scratch
    rows the chunk with the most split units needs."""
    units, splits = plan.units, plan.splits
    n = units[..., 3] & 0xFFFF
    split_units = ((units[..., 0] >= 0) & (n > 1)).sum(1)
    nu = int((units[..., 0] >= 0).sum(1).max())
    nsp = int((splits >= 0).sum(1).max())
    return dict(units=units[:, :nu].contiguous().to(device),
                unit_splits=splits[:, :nsp].contiguous().to(device),
                unit_scratch=int(split_units.max()))


def chunk_plan(blk: dict, c: int) -> UnitPlan | None:
    """Chunk ``c``'s plan from a device dict ``stage_plans`` filled (None
    when the dict has none: the wrappers then derive it)."""
    if "units" not in blk:
        return None
    return UnitPlan(blk["units"][c], blk["unit_splits"][c],
                    blk["unit_scratch"])
