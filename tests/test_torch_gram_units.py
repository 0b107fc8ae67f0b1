"""The Gram kernels' work-unit planner (``cfk_tpu_torch.ops.kernels.gram_units``).

The kernels spread a segment's passes over CTAs by the plan, so the plan
decides what every Gram kernel sums.  Checked here on the CPU, on three
chunks: a tiled accum chunk with one 50k-row segment among small (and
empty) ones, a dense-stream chunk whose windows start inside tiles and
whose hot segment's unit boundaries fall inside tiles, and a bucketed width
class whose one tile holds 300k rows.  Per chunk:

- the units cover every pass of every segment exactly once, in order (the
  passes a single CTA walking the segment would make);
- each unit starts at a multiple of 32 passes from its segment's start;
- the padded plan a wrapper derives holds the exact plan, then only
  padding, within the bounds its launch sizes assume; the plans the device
  upload stages per chunk equal the wrappers' derivation;
- a float32 emulation of the schedule — per-unit partials, added in unit
  order from zero, the carry folded into segment 0's last partial — equals
  ``gram_tiles_plain`` / ``gram_tiles_dense_plain`` within 1e-5 of the
  largest |value| (float32 sums in two orders).
"""

import numpy as np
import pytest
import torch

from cfk_tpu_torch.data.blocks import build_tiled_blocks, index_entities
from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
from cfk_tpu_torch.models.als import _bucketed_to_device, _tiled_to_device
from cfk_tpu_torch.ops.kernels.gram_kernel import (
    gram_tiles_dense_plain,
    gram_tiles_plain,
)
from cfk_tpu_torch.ops.kernels.gram_units import (
    PASS_ROWS,
    UNIT_PASSES,
    UNIT_ROWS,
    chunk_plan,
    derive_dense_units,
    derive_tile_units,
)
from cfk_tpu_torch.ops.tiled import dense_chunk


# -- three chunks --------------------------------------------------------------

def _accum_chunk():
    """Tiles of 16 rows over 40 segments: segment 7 owns 50,000 rows,
    segment 0 exactly 1,024 (32 passes: its carry unit is empty), five own
    none."""
    rng = np.random.default_rng(0)
    s = 40
    tiles = rng.integers(1, 30, s)
    tiles[rng.choice(np.arange(8, s), 5, replace=False)] = 0
    tiles[7] = 50_000 // 16
    tiles[0] = 64
    seg = np.repeat(np.arange(s), tiles).astype(np.int32)
    return dict(walk="tile", seg=seg, tile_rows=16, num_segments=s)


def _dense_meta():
    """A hand-made dense chunk: 2 groups of 96 tiles of T = 128 rows, block
    rows BG = 1,024; segment 2 spans 120 tiles whose windows start at row
    3 and hold 67 rows (3 passes each, so unit boundaries fall inside
    tiles), the other segments short, segments 4 and 8 owning no tile, and
    empty windows (group padding) at the end."""
    t, ng, m, bg = 128, 2, 96, 1024
    nt = ng * m
    rng = np.random.default_rng(1)
    lo = np.zeros(nt, np.int64)
    hi = np.zeros(nt, np.int64)
    seg = np.zeros(nt, np.int64)
    owners = ([0] * 3 + [1] * 5 + [2] * 120 + [3] + [5] * 40 + [6] * 4
              + [7] * 5)
    owners += [owners[-1]] * (nt - len(owners))
    seg[:] = owners
    for i in range(len(owners)):
        if i >= 178:  # group padding: empty windows of the last segment
            continue
        if seg[i] == 2:
            lo[i], hi[i] = 3, 70
        else:
            lo[i] = rng.integers(0, t // 2)
            hi[i] = rng.integers(lo[i] + 1, t + 1)
    g_blk = np.arange(ng)
    lb = np.tile(np.arange(m) % (bg // t) * t, ng)
    meta = np.concatenate([g_blk, lb, lo, hi, seg]).astype(np.int32)
    return dict(walk="dense", meta=meta, tile_rows=t, num_tiles=nt,
                num_groups=ng, block_rows=bg, num_segments=9,
                stream_rows=ng * bg)


def _real_dense_chunk():
    """The middle dense-stream chunk `build_tiled_blocks` makes of a small
    synthetic dataset (windows starting inside tiles)."""
    coo = synthetic_netflix_coo(3000, 400, 60_000, seed=1)
    mm, m_dense = index_entities(coo.movie_raw)
    um, u_dense = index_entities(coo.user_raw)
    blocks = build_tiled_blocks(u_dense, m_dense, coo.rating,
                                um.num_entities, mm.num_entities,
                                tile_rows=16, chunk_elems=4096,
                                accum_max_entities=16, dense_stream=True)
    assert blocks.mode == "dstream"
    _nc, cap, e_c, t, nt, ng, bg = blocks.statics
    c = blocks.num_chunks // 2
    mw = ng + 4 * nt
    return dict(walk="dense", meta=blocks.tile_meta[c * mw:(c + 1) * mw],
                tile_rows=t, num_tiles=nt, num_groups=ng, block_rows=bg,
                num_segments=e_c + 1, stream_rows=cap)


def _bucket_class():
    """One width class of one row 300,000 entries wide (one tile)."""
    return dict(walk="tile", seg=np.zeros(1, np.int32), tile_rows=300_000,
                num_segments=1)


CHUNKS = {"accum_50k": _accum_chunk, "dense_hand": _dense_meta,
          "dense_built": _real_dense_chunk, "bucket_300k": _bucket_class}


@pytest.fixture(params=sorted(CHUNKS))
def chunk(request):
    return CHUNKS[request.param]()


def _derived(ch):
    if ch["walk"] == "tile":
        return derive_tile_units(torch.as_tensor(ch["seg"]), ch["tile_rows"],
                                 ch["num_segments"])
    return derive_dense_units(torch.as_tensor(ch["meta"]), ch["tile_rows"],
                              ch["num_tiles"], ch["num_groups"],
                              ch["num_segments"])


def _plan(ch):
    """The plan without its padding, as numpy: units [U, 4], splits, and
    the scratch rows its split units fill."""
    p = _derived(ch)
    units = p.units[p.units[:, 0] >= 0].numpy()
    return dict(units=units, splits=p.splits[p.splits >= 0].numpy(),
                scratch_rows=int(((units[:, 3] & 0xFFFF) > 1).sum()))


# -- the walks: a whole segment (one CTA, as before) and one unit -------------

def _dense_fields(ch):
    nt, ng = ch["num_tiles"], ch["num_groups"]
    meta = np.asarray(ch["meta"], np.int64)
    return (meta[:ng], meta[ng:ng + nt], meta[ng + nt:ng + 2 * nt],
            meta[ng + 2 * nt:ng + 3 * nt], meta[ng + 3 * nt:])


def _segment_passes(ch, s):
    """Each pass (stream row, rows, b-coefficient index) of segment s in
    the order a single CTA walks the segment."""
    t = ch["tile_rows"]
    if ch["walk"] == "tile":
        seg = ch["seg"]
        r0 = int(np.searchsorted(seg, s)) * t
        r1 = int(np.searchsorted(seg, s, side="right")) * t
        return [(p, min(PASS_ROWS, r1 - p), p)
                for p in range(r0, r1, PASS_ROWS)]
    g_blk, lb, lo, hi, seg = _dense_fields(ch)
    m = ch["num_tiles"] // ch["num_groups"]
    out = []
    for i in range(int(np.searchsorted(seg, s)),
                   int(np.searchsorted(seg, s, side="right"))):
        base = int(g_blk[i // m]) * ch["block_rows"] + int(lb[i])
        out += [(base + r, min(PASS_ROWS, int(hi[i]) - r), i * t + r)
                for r in range(int(lo[i]), int(hi[i]), PASS_ROWS)]
    return out


def _unit_passes(ch, unit):
    """The passes of one unit record, walked as csrc/gram_kernels.cuh
    walks them."""
    _s, start, end, _n = (int(x) for x in unit)
    t = ch["tile_rows"]
    if ch["walk"] == "tile":
        return [(p, min(PASS_ROWS, end - p), p)
                for p in range(start, end, PASS_ROWS)]
    g_blk, lb, lo, hi, _seg = _dense_fields(ch)
    m = ch["num_tiles"] // ch["num_groups"]
    out, i0 = [], start // t
    for i in range(i0, end):
        base = int(g_blk[i // m]) * ch["block_rows"] + int(lb[i])
        r = start - i0 * t if i == i0 else int(lo[i])
        while r < int(hi[i]) and len(out) < UNIT_PASSES:
            out.append((base + r, min(PASS_ROWS, int(hi[i]) - r), i * t + r))
            r += PASS_ROWS
        if len(out) == UNIT_PASSES:
            break
    return out


def _units_by_segment(units):
    by = {}
    for u in units:
        if u[0] >= 0:
            by.setdefault(int(u[0]), []).append(u)
    return by


# -- the checks ---------------------------------------------------------------

def test_units_cover_every_pass_once_in_order(chunk):
    plan = _plan(chunk)
    by = _units_by_segment(plan["units"])
    assert sorted(by) == list(range(chunk["num_segments"]))
    for s, units in by.items():
        walked = [p for u in units for p in _unit_passes(chunk, u)]
        assert walked == _segment_passes(chunk, s)
        # Each record packs the segment's unit count and the unit's index.
        assert [int(u[3]) for u in units] == [
            len(units) | j << 16 for j in range(len(units))]


def test_unit_boundaries_fall_on_32_pass_blocks(chunk):
    plan = _plan(chunk)
    split = 0
    for s, units in _units_by_segment(plan["units"]).items():
        passes = _segment_passes(chunk, s)
        for j, u in enumerate(units):
            walked = _unit_passes(chunk, u)
            assert len(walked) <= UNIT_PASSES
            if walked:
                assert walked[0] == passes[UNIT_PASSES * j]
        # The last unit never holds 32 passes in segment 0 (the carry's).
        if s == 0:
            assert len(_unit_passes(chunk, units[-1])) < UNIT_PASSES
        split += len(units) > 1
    assert len(plan["splits"]) == split
    # Split segments' units first, each split segment's first unit listed.
    n = plan["units"][:, 3] & 0xFFFF
    assert np.all(np.diff((n > 1).astype(int)) <= 0)
    assert np.array_equal(plan["splits"], np.flatnonzero(
        (n > 1) & np.r_[True, plan["units"][1:, 0] != plan["units"][:-1, 0]]))
    assert plan["scratch_rows"] == int((n > 1).sum())


def test_padded_plan_holds_the_exact_plan_within_its_bounds(chunk):
    plan = _plan(chunk)
    derived = _derived(chunk)
    units, splits = derived.units.numpy(), derived.splits.numpy()
    u, sp = len(plan["units"]), len(plan["splits"])
    assert np.array_equal(units[:u], plan["units"]) and np.all(units[u:] == -1)
    assert np.array_equal(splits[:sp], plan["splits"])
    assert np.all(splits[sp:] == -1)
    assert derived.scratch_rows >= plan["scratch_rows"]
    s, t = chunk["num_segments"], chunk["tile_rows"]
    if chunk["walk"] == "tile":  # S + C/1,024 + 1 slots
        assert len(units) == s + chunk["seg"].size * t // UNIT_ROWS + 1


def _live(x):
    """A plan table without its -1 padding."""
    return x[x[:, 0] >= 0] if x.dim() == 2 else x[x >= 0]


def test_device_upload_stages_the_host_plans():
    """The plans ``_tiled_to_device`` / ``_bucketed_to_device`` stage, per
    chunk (padded to the widest chunk), equal the wrappers' derivation."""
    coo = synthetic_netflix_coo(3000, 400, 60_000, seed=1)
    mm, m_dense = index_entities(coo.movie_raw)
    um, u_dense = index_entities(coo.user_raw)
    cpu = torch.device("cpu")
    accum = build_tiled_blocks(m_dense, u_dense, coo.rating, mm.num_entities,
                               um.num_entities, tile_rows=16,
                               chunk_elems=4096, slice_rows=1000)
    dense = build_tiled_blocks(u_dense, m_dense, coo.rating, um.num_entities,
                               mm.num_entities, tile_rows=16,
                               chunk_elems=4096, accum_max_entities=16,
                               dense_stream=True)
    assert accum.mode == "accum" and dense.mode == "dstream"
    for blocks in (accum, dense):
        blk = _tiled_to_device(blocks, cpu, 5000)
        for c in range(blocks.num_chunks):
            got = chunk_plan(blk, c)
            if blocks.mode == "dstream":
                a = dense_chunk(blk, blocks.statics, c)
                want = derive_dense_units(a["meta"], a["tile_rows"],
                                          a["num_tiles"], a["num_groups"],
                                          a["num_segments"])
            else:
                _nc, cap, t, _h, e_c = blocks.statics
                nt = cap // t
                want = derive_tile_units(
                    blk["tile_seg"][c * nt:(c + 1) * nt], t, e_c + 1)
            live = _live(want.units)
            assert torch.equal(got.units[:len(live)], live)
            assert torch.all(got.units[len(live):] == -1)
            assert torch.equal(_live(got.splits), _live(want.splits))
            assert int(((live[:, 3] & 0xFFFF) > 1).sum()) <= got.scratch_rows
    from cfk_tpu_torch import Dataset

    ds = Dataset.from_coo(coo, layout="bucketed", chunk_elems=256)
    trees, _ = _bucketed_to_device(ds.movie_blocks, cpu)
    for tree in trees:
        rows, width = tree["neighbor"].shape
        got = chunk_plan(tree, 0)
        want = derive_tile_units(torch.arange(rows, dtype=torch.int32),
                                 width, rows)
        assert torch.equal(got.units, _live(want.units))
        assert torch.equal(got.splits, _live(want.splits))


def _emulate(ch, plan, g, rt, carry):
    """float32 per-unit partials added in unit order (the kernels'
    schedule), the carry folded into segment 0's last partial."""
    k = g.shape[1]
    a = torch.zeros(ch["num_segments"], k, k)
    b = torch.zeros(ch["num_segments"], k)
    for s, units in _units_by_segment(plan["units"]).items():
        sa, sb = torch.zeros(k, k), torch.zeros(k)
        for j, u in enumerate(units):
            rows = [p + r for p, n, _ in _unit_passes(ch, u) for r in range(n)]
            cols = [q + r for _, n, q in _unit_passes(ch, u) for r in range(n)]
            gu = g[rows] if rows else torch.zeros(0, k)
            pa, pb = gu.T @ gu, gu.T @ rt[cols]
            if s == 0 and j == len(units) - 1:
                pa, pb = pa + carry[0], pb + carry[1]
            sa, sb = sa + pa, sb + pb
        a[s], b[s] = sa, sb
    return a, b


@pytest.mark.parametrize("k", [8, 64])
def test_unit_schedule_emulation_matches_plain(chunk, k):
    rng = np.random.default_rng(k)
    t = chunk["tile_rows"]
    if chunk["walk"] == "tile":
        c = chunk["seg"].size * t
        rt_len = c
    else:
        c = chunk["stream_rows"]
        rt_len = chunk["num_tiles"] * t
    g = torch.as_tensor(rng.standard_normal((c, k), dtype=np.float32))
    rt = rng.standard_normal(rt_len, dtype=np.float32)
    if chunk["walk"] == "dense":  # the layout's b-coefficients: 0 off-window
        _, _, lo, hi, _ = _dense_fields(chunk)
        r = np.arange(t)
        rt *= ((r >= lo[:, None]) & (r < hi[:, None])).reshape(-1)
    rt = torch.as_tensor(rt)
    z = rng.standard_normal((2 * k, k)).astype(np.float32)
    carry = (torch.as_tensor(z.T @ z),
             torch.as_tensor(rng.standard_normal(k).astype(np.float32)),
             torch.ones(1))
    got = _emulate(chunk, _plan(chunk), g, rt, carry)
    if chunk["walk"] == "tile":
        want = gram_tiles_plain(g, rt, torch.as_tensor(chunk["seg"]),
                                num_segments=chunk["num_segments"],
                                tile_rows=t, carry=carry)
    else:
        want = gram_tiles_dense_plain(
            g, rt, torch.as_tensor(chunk["meta"]),
            num_segments=chunk["num_segments"], tile_rows=t,
            num_tiles=chunk["num_tiles"], num_groups=chunk["num_groups"],
            block_rows=chunk["block_rows"], carry=carry)
    for x, y in zip(got, want):
        assert float((x - y).abs().max() / y.abs().max()) < 1e-5
