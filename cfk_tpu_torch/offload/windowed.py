"""Out-of-core training: host factor stores + windowed half-steps.

The port of ``cfk_tpu/offload/windowed.py`` for one process.  Factor tables
that exceed the card stay in host RAM (``HostFactorStore``), and WINDOWS of
the fixed side stream through the card while the solve walks the chunk
scan.  The execution per window is the resident code, unmodified, against
the staged window table with rebased indices — the gather kernels read a
table by index and take the index equal to its height as the zero row, so
they just point at the window:

- stream windows (the all_gather scan): ``ops.tiled.als_half_step_tiled``
  over the window's chunks — K6 per chunk (K2 then K1 split; K5 and the
  stream twins with the gather off), the carry threaded across chunks;
- ring windows (the ring / hier_ring exchanges): the per-slice chunk Grams
  of ``ops.tiled.accum_grams`` (K2 per chunk, ``index_add_`` into the
  shard's [E_local+1, k, k] accumulator), the windows in the visit order of
  the resident exchange (``hier_visit_order``), then one K1 solve;
- bucketed windows (iALS / iALS++): each width-class window through the
  resident bucket piece — K6 (row 8) for the full implicit solve, K5 then
  the subspace sweeps' K1 solves at k = b for iALS++ — against the shared
  YᵀY, reduced block by block from the host store (``windowed_store_gram``:
  the resident ``global_gram_blocked``'s blocks, in order, so the same
  bits).

Schedule per half-step (the ``ops/pipeline.py`` shape, one level up)::

    take(window 0)                       # staged by the WindowStager
    for w: compute(w) on the card        # kernels launched, not waited for
           take(w+1)                     # pooled: usually staged already
           copy w's solved rows to the host, scatter into the store buffer

Each staged window's tensors are held by the stream that reads them
(``StagedWindow.ready``: an event wait and ``record_stream``), so window
w+1's staging never reuses memory a kernel of window w still reads.

Staged bytes per dtype: f32 windows stage 4 B/cell, bf16 2 (the cast is
per element, host == device), int8 the (1-byte codes, one f32 per-row
scale) pair quantized on the host by ``store.quantize_rows_host`` with the
resident ``quant.quantize_table`` arithmetic — a quarter of the f32 bytes.

The hot-row cache (``offload.hot``): the most-referenced fixed-table rows
stay on the card at the staging dtype; each window then stages only its
cold delta and is assembled on the card from the delta, the previous
window's table and the hot partition (plain torch indexing — the
reference's XLA assembly), and solved hot rows scatter back into the
partition on the card.

The reference's jit machinery (``trace_count`` of XLA traces, the donation
arguments) has no counterpart; ``trace_count()`` counts the windowed
programs' keys — (kind, shapes, dtypes, knobs) seen for the first time in
this process — as ``streaming.foldin.trace_count`` does.  The multi-process
fleet mode (the residual exchange, elastic membership) is not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cfk_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from cfk_tpu_torch.offload import budget as _budget
from cfk_tpu_torch.offload import hot as _hotmod
from cfk_tpu_torch.offload.staging import (
    DEFAULT_POOL_DEPTH,
    StagingStats,
    WindowStager,
    pool_workers_for,
    put_window,
    resolve_staging,
    stats_add,
)
from cfk_tpu_torch.offload.store import (
    HostFactorStore,
    StoreIntegrityError,
    crc32_tensor,
    quantize_rows_host,
    torch_dtype,
)
from cfk_tpu_torch.offload.window import (
    BucketWindowPlan,
    RingWindowPlan,
    WindowPlan,
    build_bucket_window_plan,
    build_ring_window_plan,
    build_window_plan,
)
from cfk_tpu_torch.telemetry import dump_flight, record_event, span

# Windowed program keys seen by this process.
_PROGRAMS: set = set()


def trace_count() -> int:
    """Windowed program keys seen for the first time in this process — the
    port's count of the reference's jit traces."""
    return len(_PROGRAMS)


class WindowIntegrityError(RuntimeError):
    """A staged window's bytes no longer match the host store's (a torn or
    corrupted staging read, caught by the staging checksum)."""


def resolve_tier(dataset, config, device) -> str:
    """The tier a trainer runs ``config`` in: ``"host_window"`` when pinned,
    or, for ``offload_tier="auto"``, when ``budget.fits_device`` — the
    reference's predicate, at the device's own memory size and the
    config's shard count — says the resident tables and blocks do not fit
    and the family's windowed layout gate admits the config; else
    ``"device"``.  (The reference resolves "auto" through its planner,
    which also records provenance; the port has no planner yet.)"""
    tier = getattr(config, "offload_tier", "device")
    if tier != "auto":
        return tier
    fits = _budget.fits_device(
        dataset.user_map.num_entities, dataset.movie_map.num_entities,
        max(int(dataset.movie_blocks.count.sum()), 1), config.rank,
        hbm_bytes=_budget.device_memory_bytes(device), dtype=config.dtype,
        table_dtype=config.table_dtype, num_shards=config.num_shards)
    if fits:
        return "device"
    try:
        config._check_host_window()
    except ValueError:
        return "device"
    return "host_window"


def refuse_unsupported(**args) -> None:
    """The host_window exits' refusal of the trainer arguments the windowed
    trainers do not take (the reference's message)."""
    unsupported = [name for name, v in args.items() if v is not None]
    if unsupported:
        raise NotImplementedError(
            f"offload_tier='host_window' does not support {unsupported} yet "
            "— the windowed trainer keeps factors in host stores (see "
            "cfk_tpu_torch/offload/windowed.py; window-level fault "
            "injection uses its window_faults=)")


def _stage_dtype(store_dtype: str, table_dtype: str | None) -> str:
    """The dtype windows cross PCIe at: bf16 and int8 tables stage as
    themselves, f32 stages the storage dtype."""
    if table_dtype in ("bfloat16", "int8"):
        return table_dtype
    return store_dtype


def _stage_cell_bytes(stage_name: str) -> tuple[int, int]:
    """(bytes per staged table cell, per-row overhead bytes)."""
    if stage_name == "int8":
        return 1, 4  # codes + one f32 scale per row
    return torch_dtype(stage_name).itemsize, 0


def hier_visit_order(num_shards: int, inner: int, shard: int) -> list[int]:
    """The slice visit order of the resident hierarchical ring
    (``parallel.spmd.half_step_tiled_ring_hier``) for one shard: phases
    walk the outer ring, inner steps the inner one — ``held(p, j) =
    ((g−p)%O)·I + (i+p−j)%I``; ``inner == num_shards`` is the flat ring's
    ``(shard − r) % S``."""
    from cfk_tpu_torch.parallel.spmd import hier_phase_count

    outer = hier_phase_count(num_shards, inner)
    g, i_pos = shard // inner, shard % inner
    return [((g - p) % outer) * inner + (i_pos + p - j) % inner
            for p in range(outer) for j in range(inner)]


def _host(a) -> torch.Tensor:
    """A numpy view (or tensor) as a CPU tensor without a copy."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def _stage_table(fixed_store: HostFactorStore, rows, *, stage_name: str,
                 faults, iteration: int, side: str, window: int, shard: int,
                 verify_windows: bool, stats, ici_group: int, device):
    """Gather + (optionally) quantize one window's table rows on the host —
    the staging pipeline up to the copy to ``device`` (a card's window is
    gathered into a pinned buffer and quantized with the card's int8
    arithmetic, ``quantize_rows_host``).  The fault hooks
    and the integrity checksum see the gathered rows (before quantization,
    so a NaN fault poisons an int8 scale as the resident quantization
    would)."""
    rows = np.asarray(rows, dtype=np.int64)
    if faults is not None:
        faults.delay(iteration, side, window, shard=shard)
    buf = None
    if device.type == "cuda":
        buf = torch.empty((rows.shape[0], fixed_store.rank),
                          dtype=fixed_store.torch_dtype, pin_memory=True)
    tbl = fixed_store.gather(rows, out=buf)
    if stage_name != "int8" and tbl.dtype != torch_dtype(stage_name):
        tbl = tbl.to(torch_dtype(stage_name))
    src_crc = crc32_tensor(tbl) if verify_windows else None
    # The fault hook models in-flight staging corruption: between the
    # source checksum and the device copy.
    if faults is not None:
        tbl = faults.apply_window(iteration, side, window, tbl, shard=shard)
    if verify_windows and crc32_tensor(tbl) != src_crc:
        raise WindowIntegrityError(
            f"shard {shard} side {side!r} iteration {iteration} window "
            f"{window}: staged bytes diverge from the host store "
            "(torn/corrupt transfer)"
        )
    if stage_name == "int8":
        data, scale = quantize_rows_host(tbl, device=device)
    else:
        data, scale = tbl, None
    if stats is not None and fixed_store.num_shards > 1 and rows.size:
        owners = fixed_store.shard_of_rows(rows)
        home = owners == shard
        g = max(ici_group, 1)
        group = owners // g == shard // g
        stats_add(stats, "rows_local", int(home.sum()))
        stats_add(stats, "rows_ici", int((group & ~home).sum()))
        stats_add(stats, "rows_dcn", int((~group).sum()))
    return data, scale


def window_chunks(plan_obj, w: int) -> tuple:
    """Window ``w``'s chunk arrays over its REAL chunks only (views of the
    block arrays): stream plans (rating, weight, tile_seg, chunk_entity,
    chunk_count, carry_in, last_seg), ring plans (rating, weight,
    tile_seg, chunk_entity), bucket plans (rating, mask).  The reference
    pads a ragged window with all-trash chunks for its static jit shape;
    the port does not run them."""
    n = int(plan_obj.chunk_counts[w])
    lo = int(plan_obj.chunk_lo[w])
    s = plan_obj.src
    if isinstance(plan_obj, BucketWindowPlan):
        _ncw, chunk, width, whole = plan_obj.window_shape(w)
        b = s[int(plan_obj.bucket_of[w])]
        r0 = lo * chunk
        r1 = r0 + (chunk if whole else n * chunk)
        return (b["rating"][r0:r1].reshape(-1), b["mask"][r0:r1].reshape(-1))
    keys = ("rating", "weight", "tile_seg", "chunk_entity")
    out = tuple(s[key][lo:lo + n].reshape(-1) for key in keys)
    if isinstance(plan_obj, WindowPlan):
        out += (s["chunk_count"][lo:lo + n].reshape(-1),
                plan_obj.carry_in[w][:n], plan_obj.last_seg[w][:n])
    return out


def _window_nb(plan_obj, w: int) -> np.ndarray:
    """Window ``w``'s rebased neighbor indices over its real chunks."""
    if isinstance(plan_obj, BucketWindowPlan):
        _ncw, chunk, width, whole = plan_obj.window_shape(w)
        rows = chunk if whole else int(plan_obj.chunk_counts[w]) * chunk
        return plan_obj.neighbor_idx[w][: rows * width]
    cap = plan_obj.statics[1]
    return plan_obj.neighbor_idx[w][: int(plan_obj.chunk_counts[w]) * cap]


def _stage_window(fixed_store, plan_obj, w: int, *, hmap, stage_name,
                  faults, iteration, side, shard, verify_windows, stats,
                  ici_group, device, extra=()):
    """Stage window ``w`` of any plan kind: its table rows (the whole row
    set, or with ``hmap`` only the cold delta the hot partition and the
    predecessor window do not hold) through ``_stage_table``, then its
    rebased neighbor indices and chunk arrays, in one ``put_window``.
    ``extra`` host arrays ride along (iALS++'s warm-start rows)."""
    # Full staging ships all ``window_rows`` rows (the pad rows repeat row
    # 0): the table height is the rebased zero row's index.
    rows = plan_obj.rows[w] if hmap is None else hmap.delta_rows[w]
    data, scale = _stage_table(
        fixed_store, rows, stage_name=stage_name, faults=faults,
        iteration=iteration, side=side, window=w, shard=shard,
        verify_windows=verify_windows, stats=stats, ici_group=ici_group,
        device=device,
    )
    host = (data, scale, _host(_window_nb(plan_obj, w)),
            *(_host(a) for a in window_chunks(plan_obj, w)), *extra)
    staged = put_window(host, device)
    if stats is not None:
        stats_add(stats, "windows_staged", 1)
        stats_add(stats, "staged_bytes", staged.nbytes)
        stats_add(stats, "staged_cold_bytes",
                  data.numel() * data.element_size()
                  + (0 if scale is None else scale.numel() * 4))
        stats_add(stats, "rows_staged", int(
            plan_obj.row_counts[w] if hmap is None else len(rows)))
        if hmap is not None:
            stats_add(stats, "rows_delta_skipped", int(hmap.keep_dst[w].size))
            stats_add(stats, "rows_hot_device", int(hmap.hot_dst[w].size))
    return staged


def _stage_span_attrs(hmap, plan_obj, w: int) -> dict:
    """The ``window_stage`` span attrs: real (pre-pad) row counts."""
    if hmap is None:
        return {"rows_staged": int(plan_obj.row_counts[w])}
    return {"rows_staged": int(len(hmap.delta_rows[w])),
            "rows_delta_skipped": int(hmap.keep_dst[w].size),
            "rows_hot": int(hmap.hot_dst[w].size)}


class HotPartition:
    """One fixed side's device-resident hot rows at the STAGING dtype: f32
    or bf16 data, or the (int8 codes, f32 per-row scales) pair — the bytes
    full staging would have shipped for these rows.  ``rebuild`` gathers it
    from the host master (the initial build and the rollback path share
    it); steady-state updates come from the solve side's scatter-back."""

    def __init__(self, rows, stage_name: str, device) -> None:
        self.rows = np.asarray(rows, dtype=np.int64)
        self.stage_name = stage_name
        self.int8 = stage_name == "int8"
        self.device = device
        self.data = None
        self.scale = None

    @property
    def num_rows(self) -> int:
        return int(self.rows.shape[0])

    @property
    def nbytes(self) -> int:
        if self.data is None:
            return 0
        return int(self.data.numel() * self.data.element_size()
                   + (0 if self.scale is None else self.scale.numel() * 4))

    def rebuild(self, store: HostFactorStore) -> None:
        tbl = store.gather(self.rows)
        if tbl.shape[0] == 0:
            # A 0-row side keeps one zeros row so its gathers stay in bounds.
            tbl = torch.zeros((1, store.rank), dtype=tbl.dtype)
        if self.int8:
            data, scale = quantize_rows_host(tbl, device=self.device)
        else:
            data, scale = tbl.to(torch_dtype(self.stage_name)), None
        self.data = data.to(self.device)
        self.scale = None if scale is None else scale.to(self.device)

    def poison(self, rows) -> None:
        """Chaos seam: NaN the given partition positions on the card (an
        int8 partition poisons the scale); the host master is untouched."""
        idx = torch.as_tensor(np.asarray(rows, dtype=np.int64),
                              device=self.device)
        if self.int8:
            self.scale[idx] = float("nan")
        else:
            self.data[idx] = float("nan")

    def update(self, src, dst, solved: torch.Tensor) -> None:
        """Scatter solved rows (``solved[src]``, already in the storage
        dtype) into partition positions ``dst`` — the cast or quantization
        is the resident arithmetic, so a hot row's device copy equals what
        re-staging it from the host master gives."""
        rows = solved[src]
        if self.int8:
            from cfk_tpu_torch.ops.quant import quantize_table

            codes, scales = quantize_table(rows, "int8")
            self.data[dst] = codes
            self.scale[dst] = scales
        else:
            self.data[dst] = rows.to(self.data.dtype)


class _HotHalf:
    """One (side, shard)'s view of the hot/delta engine: the FIXED side's
    partition (read by window assembly), the SOLVE side's partition (the
    scatter-back target), the window split map, and its index tensors on
    the card (plan-time constants, put once)."""

    def __init__(self, fixed: HotPartition, solve: HotPartition, hmap,
                 sb_maps, device) -> None:
        self.fixed = fixed
        self.solve = solve
        self.hmap = hmap
        dev = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, dtype=np.int64), device=device)
        self._idx = {w: (dev(hmap.keep_dst[w]), dev(hmap.keep_src[w]),
                         dev(hmap.delta_dst[w]), dev(hmap.hot_dst[w]),
                         dev(hmap.hot_src[w]))
                     for w in hmap.prev_of}
        if isinstance(sb_maps, dict):
            self._sb = {w: (dev(src), dev(dst))
                        for w, (src, dst) in sb_maps.items() if src.size}
        else:
            self._sb = (dev(sb_maps[0]), dev(sb_maps[1])) \
                if sb_maps[0].size else None

    def idx(self, w):
        return self._idx[w]

    def sb_idx(self, w=None):
        return self._sb if w is None else self._sb.get(w)

    def assemble(self, w: int, delta, dscale, prev):
        """Window ``w``'s table from the staged cold delta, the previous
        window's table (``prev``, None for the schedule's first window) and
        the hot partition — every row a copy of the bytes full staging
        would have produced."""
        keep_dst, keep_src, new_dst, hot_dst, hot_src = self._idx[w]
        r = self.hmap.window_rows
        tbl = delta.new_zeros((r, delta.shape[-1]))
        sc = None if dscale is None else dscale.new_zeros((r,))
        if prev is not None and keep_dst.numel():
            tbl[keep_dst] = prev[0][keep_src]
            if sc is not None:
                sc[keep_dst] = prev[1][keep_src]
        tbl[new_dst] = delta
        if sc is not None:
            sc[new_dst] = dscale
        if hot_dst.numel():
            tbl[hot_dst] = self.fixed.data[hot_src]
            if sc is not None:
                sc[hot_dst] = self.fixed.scale[hot_src]
        return tbl, sc


def _fixed_rows_of(plan_obj) -> int:
    """The fixed-table row space a plan's windows gather from."""
    if hasattr(plan_obj, "table_rows"):
        return int(plan_obj.table_rows)
    return int(plan_obj.num_slices * plan_obj.statics[3])


class _Pending:
    """Window ``w``'s solved rows on their way to the host: a pinned copy
    issued on the current stream with an event, scattered into ``out`` at
    ``finish`` (the next window's kernels are launched in between)."""

    __slots__ = ("rows", "ent", "event")

    def __init__(self, xs: torch.Tensor, ent: np.ndarray) -> None:
        self.ent = ent
        self.event = None
        if xs.device.type == "cuda":
            self.rows = torch.empty(xs.shape, dtype=xs.dtype,
                                    pin_memory=True)
            self.rows.copy_(xs, non_blocking=True)
            self.event = torch.cuda.current_stream(xs.device).record_event()
        else:
            self.rows = xs

    def finish(self, out: torch.Tensor, local: int) -> None:
        if self.event is not None:
            self.event.synchronize()
        real = self.ent < local
        out[torch.from_numpy(self.ent[real].astype(np.int64))] = self.rows[
            torch.from_numpy(np.nonzero(real)[0])].to(out.dtype)


def _own_stager(fixed_store, plan_obj, schedule, *, table_dtype, device,
                faults, iteration, side, shard, verify_windows, stats,
                ici_group, hot=None, extra_of=None, mode="serial",
                depth=1) -> WindowStager:
    """The stager of one shard's half (serial by default — the double
    buffer — for direct half-step callers); with ``hot`` tasks stage the
    cold delta.  ``extra_of(w)`` adds host arrays to a window (iALS++)."""
    stage_name = _stage_dtype(fixed_store.dtype, table_dtype)
    hmap = None if hot is None else hot.hmap

    def stage_task(d, w):
        return _stage_window(
            fixed_store, plan_obj, w, hmap=hmap, stage_name=stage_name,
            faults=faults, iteration=iteration, side=side, shard=d,
            verify_windows=verify_windows, stats=stats, ici_group=ici_group,
            device=device, extra=() if extra_of is None else extra_of(w))

    return WindowStager([(shard, w) for w in schedule], stage_task,
                        mode=mode, depth=depth, stats=stats,
                        span_attrs=lambda d, w: _stage_span_attrs(
                            hmap, plan_obj, w))


def _meter_copies(stats, consumed) -> None:
    """Add the consumed windows' host-to-device copy bytes and device
    seconds (their events, complete once the half has synchronized) to
    ``h2d_bytes`` / ``h2d_s`` — the staging copies' rate."""
    if stats is None:
        return
    for staged in consumed:
        if staged.event is not None:
            stats_add(stats, "h2d_bytes", staged.nbytes)
            stats_add(stats, "h2d_s", staged.copy_seconds())


def _window_table(staged, hot, w, prev):
    """(tbl, scale, rest) of a taken window: assembled under the hot
    engine, else the staged pair."""
    arrays = staged.ready()
    if hot is None:
        return arrays[0], arrays[1], arrays[2:]
    tbl, scale = hot.assemble(w, arrays[0], arrays[1], prev)
    return tbl, scale, arrays[2:]


def windowed_half_step(
    fixed_store: HostFactorStore, wplan: WindowPlan, *, lam: float,
    device=DEFAULT_DEVICE, out_dtype: str = "float32",
    solver: str = "auto", overlap=None, fused_epilogue=None,
    in_kernel_gather=None, reg_solve_algo=None,
    table_dtype: str | None = None, faults=None, iteration: int = 0,
    side: str = "", stats=None, verify_windows: bool = False,
    shard: int = 0, ici_group: int = 1, stager: WindowStager | None = None,
    hot: _HotHalf | None = None,
) -> torch.Tensor:
    """Solve one shard's entities against a host-resident fixed table,
    window by window (the stream scan).  Returns the solved
    [local_entities, rank] CPU tensor in ``out_dtype`` (untouched rows
    zero, as the resident scatter leaves them).  ``stager`` is the staging
    engine serving this shard's windows (the trainer's pooled one); None
    builds a private serial stager from ``faults``/``verify_windows``/
    ``stats``.  ``verify_windows`` checksums each staged window at the
    store against what is about to ship and raises
    ``WindowIntegrityError`` on a mismatch."""
    from cfk_tpu_torch.ops import quant
    from cfk_tpu_torch.ops.tiled import als_half_step_tiled, chunk_reg

    dev = resolve_device(device)
    k = fixed_store.rank
    out_dt = torch_dtype(out_dtype)
    local = wplan.local_entities
    out = torch.zeros((local, k), dtype=out_dt)
    _nc, cap, e_c, t = wplan.statics
    own = stager is None
    if own:
        stager = _own_stager(
            fixed_store, wplan, wplan.schedule(), table_dtype=table_dtype,
            device=dev, faults=faults, iteration=iteration, side=side,
            shard=shard, verify_windows=verify_windows, stats=stats,
            ici_group=ici_group, hot=hot)
    prev = pending = None
    consumed = []
    n_w = wplan.num_windows
    try:
        staged = stager.take() if n_w else None
        for w in range(n_w):
            consumed.append(staged)
            with span("train/iter/half_step/window_compute", side=side,
                      shard=shard, window=w):
                tbl, scale, rest = _window_table(staged, hot, w, prev)
                nb, rt, wt, ts, ent, cnt, cin, lseg = rest
                n = int(wplan.chunk_counts[w])
                _PROGRAMS.add(("stream", n, cap, e_c, t, k, tbl.dtype,
                               scale is not None, fused_epilogue,
                               in_kernel_gather, solver, str(dev)))
                blk = dict(neighbor_idx=nb, rating=rt,
                           weight=quant.fold_scale(wt, scale, nb),
                           tile_seg=ts, chunk_entity=ent,
                           chunk_reg=chunk_reg(cnt, n), carry_in=cin,
                           last_seg=lseg)
                xs = als_half_step_tiled(
                    tbl, blk, local, lam, statics=(n, cap, e_c, t),
                    solver=solver, fused_epilogue=fused_epilogue,
                    in_kernel_gather=in_kernel_gather,
                    reg_solve_algo=reg_solve_algo, overlap=overlap,
                    return_chunk_rows=True).to(out_dt)
                if hot is not None:
                    prev = (tbl, scale)
                    sb = hot.sb_idx(w)
                    if sb is not None:
                        hot.solve.update(sb[0], sb[1], xs)
                nxt = stager.take() if w + 1 < n_w else None
                if pending is not None:
                    pending.finish(out, local)
                pending = _Pending(xs, wplan.chunk_entity_of(w)[: n * e_c])
            staged = nxt
        if pending is not None:
            pending.finish(out, local)
        _meter_copies(stats, consumed)
    finally:
        if own:
            stager.close()
    return out


def ring_windowed_half_step(
    fixed_store: HostFactorStore, rplan: RingWindowPlan, *, lam: float,
    visits: list[int], count_local, device=DEFAULT_DEVICE,
    out_dtype: str = "float32", solver: str = "auto", overlap=None,
    fused_epilogue=None, in_kernel_gather=None, reg_solve_algo=None,
    table_dtype: str | None = None, faults=None, iteration: int = 0,
    side: str = "", stats=None, verify_windows: bool = False,
    shard: int = 0, ici_group: int = 1, stager: WindowStager | None = None,
    hot: _HotHalf | None = None,
) -> torch.Tensor:
    """One shard's ring/hier-ring half-iteration against staged windows:
    the slices in ``visits`` order (the resident exchange's block order),
    each slice's windows' chunk Grams added into the shard's persistent
    [E_local+1, k, k] / [E_local+1, k] accumulator by ``accum_grams`` (K2
    per chunk), one solve at the end.  Only the slice rows this shard's
    chunks reference are staged — never the whole block."""
    from cfk_tpu_torch.ops import quant
    from cfk_tpu_torch.ops.solve import regularized_solve
    from cfk_tpu_torch.ops.tiled import accum_grams

    dev = resolve_device(device)
    k = fixed_store.rank
    _nc, cap, t, h, e_c = rplan.statics
    local = rplan.local_entities
    schedule = rplan.schedule(visits)
    own = stager is None
    if own:
        stager = _own_stager(
            fixed_store, rplan, schedule, table_dtype=table_dtype,
            device=dev, faults=faults, iteration=iteration, side=side,
            shard=shard, verify_windows=verify_windows, stats=stats,
            ici_group=ici_group, hot=hot)
    acc = (torch.zeros((local + 1, k, k), dtype=torch.float32, device=dev),
           torch.zeros((local + 1, k), dtype=torch.float32, device=dev))
    prev = None
    consumed = []
    try:
        staged = stager.take() if schedule else None
        for i, w in enumerate(schedule):
            consumed.append(staged)
            with span("train/iter/half_step/ring_visit", side=side,
                      shard=shard, visit=i, window=w):
                tbl, scale, rest = _window_table(staged, hot, w, prev)
                nb, rt, wt, ts, ent = rest
                n = int(rplan.chunk_counts[w])
                _PROGRAMS.add(("ring", n, cap, t, e_c, k, tbl.dtype,
                               scale is not None, in_kernel_gather, solver,
                               str(dev)))
                blk = dict(neighbor_idx=nb, rating=rt,
                           weight=quant.fold_scale(wt, scale, nb),
                           tile_seg=ts, chunk_entity=ent)
                accum_grams(tbl, blk, local, statics=(n, cap, t, h, e_c),
                            solver=solver, in_kernel_gather=in_kernel_gather,
                            overlap=overlap, acc=acc)
                if hot is not None:
                    prev = (tbl, scale)
                staged = stager.take() if i + 1 < len(schedule) else None
    finally:
        if own:
            stager.close()
    with span("train/iter/half_step/ring_solve", side=side, shard=shard):
        cnt = torch.as_tensor(np.asarray(count_local), device=dev)
        x = regularized_solve(acc[0][:local], acc[1][:local], cnt, lam,
                              solver, fused=fused_epilogue,
                              algo=reg_solve_algo).to(torch_dtype(out_dtype))
        if hot is not None and hot.sb_idx() is not None:
            src, dst = hot.sb_idx()
            hot.solve.update(src, dst, x)
        x = x.cpu()
    _meter_copies(stats, consumed)
    return x


def _resolve_side_modes(dataset, config) -> tuple[bool, bool]:
    """(movie_side_ring, user_side_ring), as the resident trainer resolves
    them: rings only at num_shards > 1, ``exchange='auto'`` per half as the
    blocks were built."""
    from cfk_tpu_torch.data.blocks import TiledBlocks

    if config.num_shards == 1 or config.exchange == "all_gather":
        return False, False
    if config.exchange in ("ring", "hier_ring"):
        return True, True
    mb, ub = dataset.movie_blocks, dataset.user_blocks
    return (bool(isinstance(mb, TiledBlocks) and mb.ring),
            bool(isinstance(ub, TiledBlocks) and ub.ring))


def _blocks_for(dataset, config, tile_rows: int | None, ring_m: bool,
                ring_u: bool):
    """The tiled blocks each half runs on: a stream side needs stream-mode
    blocks at the config's shard count — the dataset's own when they
    qualify, else one rebuild of every stream side from the dense COO with
    accum mode off; a ring side needs the dataset's ring-built accum
    blocks as they are.  Mismatches raise with the resident trainer's
    remedies (``cfk_tpu/offload/windowed.py:968-1053``)."""
    from cfk_tpu_torch.data.blocks import TiledBlocks, build_tiled_blocks

    s = config.num_shards
    mb, ub = dataset.movie_blocks, dataset.user_blocks

    def side_ok(blocks, ring):
        if not isinstance(blocks, TiledBlocks) or blocks.num_shards != s:
            return False
        if ring:
            return blocks.mode == "accum" and blocks.ring
        return blocks.mode == "stream" and not blocks.ring

    sides = (("movie", mb, ring_m), ("user", ub, ring_u))
    for name, blocks, ring in sides:
        if ring and not side_ok(blocks, True):
            raise ValueError(
                f"exchange={config.exchange!r} windowed training runs "
                f"the {name} half on ring-built tiled blocks at "
                f"num_shards={s}; rebuild with Dataset.from_coo(..., "
                f"layout='tiled', num_shards={s}, ring=True)")
        if not ring and isinstance(blocks, TiledBlocks) and blocks.ring:
            raise ValueError(
                f"exchange={config.exchange!r} runs the {name} half as "
                "a stream scan, but its blocks were ring-built; pass "
                "exchange='ring'/'hier_ring' (the windowed ring trainer) "
                "or rebuild with ring=False")
    if not any(not ring and not side_ok(blocks, False)
               for _, blocks, ring in sides):
        return mb, ub
    coo = dataset.coo_dense
    t = tile_rows or (mb.tile_rows if isinstance(mb, TiledBlocks) else 128)
    m_dense = coo.movie_raw.astype(np.int64)
    u_dense = coo.user_raw.astype(np.int64)
    nm, nu = dataset.movie_map.num_entities, dataset.user_map.num_entities
    kw = dict(num_shards=s, tile_rows=t, chunk_elems=config.chunk_cells(),
              accum_max_entities=0)
    rebuilt = (build_tiled_blocks(m_dense, u_dense, coo.rating, nm, nu, **kw),
               build_tiled_blocks(u_dense, m_dense, coo.rating, nu, nm, **kw))
    return (mb if ring_m else rebuilt[0]), (ub if ring_u else rebuilt[1])


def _probe(u, m, norm_limit: float | None) -> str | None:
    """Host-side sentinel over the solved tables: NaN/Inf anywhere, or a
    factor-row 2-norm past the limit (``resilience.sentinel``'s
    vocabulary)."""
    for name, x in (("user", u), ("movie", m)):
        xf = x.float()
        if not bool(torch.isfinite(xf).all()):
            return f"nonfinite {name} factors"
        if norm_limit is not None and xf.numel():
            n = float(torch.sqrt((xf * xf).sum(dim=1)).max())
            if n > norm_limit:
                return f"{name} row norm {n:.3g} > {norm_limit:.3g}"
    return None


def resolve_window_inner(config) -> int:
    """The windowed ring's inner size: the resident hier ring's
    (``parallel.spmd.resolve_ici_group``) for ``hier_ring``, one flat ring
    otherwise."""
    if config.exchange == "hier_ring":
        from cfk_tpu_torch.parallel.spmd import resolve_ici_group

        return resolve_ici_group(config)
    return config.num_shards


def _size_windows(make_plans, rank, cell_bytes, row_overhead,
                  per_window_budget, cpw, reserve_note):
    """Build the plans at ``cpw`` chunks per window, halving until the worst
    window fits the per-window budget; refuses loudly when one chunk does
    not.  Returns (plans, worst window bytes, cpw)."""
    while True:
        plans = make_plans(cpw)
        worst = max(p.staged_bytes_per_window(rank, cell_bytes,
                                              row_overhead_bytes=row_overhead)
                    for p in plans)
        if worst <= per_window_budget or cpw == 1:
            break
        cpw = max(1, cpw // 2)
    if worst > per_window_budget:
        raise ValueError(
            f"one staged window needs {worst / 1e6:.1f} MB but the "
            f"per-window budget is {per_window_budget / 1e6:.1f} MB "
            f"((device_budget · RESIDENT_FRACTION − {reserve_note}) / "
            "WINDOW_BUFFERS) — lower hbm_chunk_elems so single chunks fit "
            "the budget, or raise the device budget")
    return plans, worst, cpw


def _resolve_hot(requested, *, m_plans, u_plans, solved_u, solved_m,
                 rank, stage_name, budget_bytes, reserved, worst, pool_depth,
                 staging):
    """The hot-row cache's resolution from the plans' own per-window row
    sets: (f_u, f_m, counts_u, counts_m, note).  ``None`` = the
    coverage-curve knee clamped by the headroom the accumulator, window and
    delta-arena terms leave; ``0`` = off; ``>= 1`` = pinned total rows,
    split by each side's reference mass, refused when it cannot fit."""
    row_b = _budget.stage_row_bytes(rank, stage_name)
    arena = max(p.window_rows * row_b for p in (*m_plans, *u_plans))
    live = max(pool_depth + 1 if staging == "pool"
               else _budget.WINDOW_BUFFERS, _budget.WINDOW_BUFFERS)
    hot_reserved = reserved + live * worst + arena
    admit = _budget.max_hot_rows(budget_bytes, rank, stage_name,
                                 reserved_bytes=hot_reserved)
    # Reference counts over the FIXED table each side's windows gather,
    # zeroed outside the rows the other half re-solves (so the device copy
    # can never go stale against the host master).
    counts_u = _hotmod.reference_counts(m_plans, _fixed_rows_of(m_plans[0]))
    counts_m = _hotmod.reference_counts(u_plans, _fixed_rows_of(u_plans[0]))
    for counts, solved in ((counts_u, solved_u), (counts_m, solved_m)):
        mask = np.zeros(counts.shape, bool)
        mask[solved] = True
        counts[~mask] = 0
    slots_u, slots_m = int(counts_u.sum()), int(counts_m.sum())
    if requested is None:
        f_u = _hotmod.knee_hot_rows(counts_u)
        f_m = _hotmod.knee_hot_rows(counts_m)
        total = f_u + f_m
        if total > admit:
            f_u = f_u * admit // max(total, 1)
            f_m = min(admit - f_u, f_m)
            note = f"knee clamped by budget headroom ({admit} rows admitted)"
        else:
            note = "coverage-curve knee within headroom"
    else:
        req = int(requested)
        if not _budget.hot_reservation_fits(req, rank, stage_name,
                                            budget_bytes,
                                            reserved_bytes=hot_reserved):
            need = _budget.hot_reservation_bytes(req, rank, stage_name)
            raise ValueError(
                f"hot_rows={req} pinned but its reservation "
                f"({need / 1e6:.2f} MB at the {stage_name!r} staging dtype) "
                f"exceeds the headroom left by the accumulator/window/"
                f"delta-arena terms ({admit * row_b / 1e6:.2f} MB ≈ {admit} "
                "rows) — lower hot_rows, raise the device budget, or use "
                "hot_rows=0 (the full-staging engine)")
        f_u = req * slots_u // max(slots_u + slots_m, 1)
        f_m = req - f_u
        note = f"pinned total {req}"
    f_u = min(f_u, int((counts_u > 0).sum()))
    f_m = min(f_m, int((counts_m > 0).sum()))
    if f_u + f_m == 0:
        note += "; resolved 0 (off)"
    return f_u, f_m, counts_u, counts_m, note


def _staging_gauges(metrics, stats, staging) -> None:
    """The staging engine's gauges, read from host-side counters."""
    metrics.gauge("offload_windows_staged", stats.get("windows_staged", 0))
    metrics.gauge("offload_staged_mb",
                  round(stats.get("staged_bytes", 0) / 1e6, 3))
    metrics.gauge("offload_staged_cold_mb",
                  round(stats.get("staged_cold_bytes", 0) / 1e6, 3))
    for key in ("rows_staged", "rows_delta_skipped", "rows_hot_device",
                "rows_local", "rows_ici", "rows_dcn", "gram_blocks_staged"):
        if key in stats:
            metrics.gauge(f"offload_{key}", stats[key])
    if "gram_staged_bytes" in stats:
        metrics.gauge("offload_gram_staged_mb",
                      round(stats["gram_staged_bytes"] / 1e6, 3))
    busy = float(stats.get("stage_busy_s", 0.0))
    stall = float(stats.get("stage_stall_s", 0.0))
    metrics.gauge("offload_stage_busy_s", round(busy, 4))
    metrics.gauge("offload_stage_stall_s", round(stall, 4))
    if busy > 0:
        metrics.gauge("offload_stage_hidden_frac",
                      round(max(0.0, 1.0 - stall / busy), 4))
        metrics.gauge("offload_staged_mb_per_s",
                      round(stats.get("staged_bytes", 0) / 1e6 / busy, 2))
    if stats.get("h2d_s", 0.0) > 0:
        metrics.gauge("offload_h2d_gb_per_s",
                      stats["h2d_bytes"] / stats["h2d_s"] / 1e9)
    if staging == "pool":
        metrics.gauge("offload_pool_peak_inflight",
                      stats.get("pool_peak_inflight", 0))
        metrics.gauge("offload_pool_worker_stagings",
                      stats.get("pool_worker_stagings", 0))


def _plan_gauges(metrics, m_plans, u_plans, cpw, s, staging, pool_depth,
                 f_u, f_m, hot_note, hot_maps) -> None:
    metrics.gauge("offload_windows_m", sum(p.num_windows for p in m_plans))
    metrics.gauge("offload_windows_u", sum(p.num_windows for p in u_plans))
    metrics.gauge("offload_window_rows_m", max(p.window_rows for p in m_plans))
    metrics.gauge("offload_window_rows_u", max(p.window_rows for p in u_plans))
    metrics.gauge("offload_chunks_per_window", cpw)
    metrics.gauge("offload_shards", s)
    metrics.gauge("offload_plan_held_mb", round(
        sum(p.plan_held_bytes() for p in (*m_plans, *u_plans)) / 1e6, 3))
    metrics.note("offload_staging", staging)
    if staging == "pool":
        metrics.gauge("offload_pool_depth", pool_depth)
        metrics.gauge("offload_pool_workers", pool_workers_for(pool_depth))
    metrics.note("offload_hot", "on" if hot_maps else "off")
    if hot_note:
        metrics.note("offload_hot_decision", hot_note)
    if hot_maps:
        maps = list(hot_maps.values())
        total = sum(m.slots_total for m in maps)
        metrics.gauge("offload_hot_rows", f_u + f_m)
        metrics.gauge("offload_hot_rows_u", f_u)
        metrics.gauge("offload_hot_rows_m", f_m)
        if total:
            metrics.gauge("offload_hot_coverage", round(
                sum(m.slots_hot for m in maps) / total, 4))
            metrics.gauge("offload_delta_coverage", round(
                sum(m.slots_kept for m in maps) / total, 4))


class _Ladder:
    """The recovery ladder both trainers share: rollback to the last-good
    snapshot of the host stores, then one rung up (``resilience.policy``),
    the partitions rebuilt from the restored masters."""

    def __init__(self, config, metrics, rebuild_hot) -> None:
        from cfk_tpu_torch.resilience.policy import (
            Overrides,
            policy_from_config,
        )

        self.config = config
        self.metrics = metrics
        self.policy = policy_from_config(config)
        self.ov = Overrides(lam=config.lam,
                            fused_epilogue=config.fused_epilogue)
        self.trips = 0
        self.rebuild_hot = rebuild_hot

    def trip(self, reason: str, it: int, snap, snap_iter: int):
        """Returns (u_store, m_store, iteration, keep_going)."""
        from cfk_tpu_torch.resilience.policy import TrainingDivergedError

        m = self.metrics
        self.trips += 1
        m.incr("health_trips")
        m.note(f"health_trip_{self.trips}", f"iteration {it}: {reason}")
        record_event("fault", "health_trip", iteration=it, trip=self.trips,
                     reason=reason)
        dump_flight(f"health_trip_{self.trips}")
        if self.trips > self.policy.max_recoveries:
            detail = (f"recovery exhausted after {self.policy.max_recoveries}"
                      f" trips; last: {reason}")
            if self.policy.on_unrecoverable == "raise":
                record_event("fault", "unrecoverable", detail=detail)
                dump_flight("unrecoverable")
                raise TrainingDivergedError(detail)
            m.note("degraded", detail)
            record_event("fault", "degraded", detail=detail)
            dump_flight("degraded")
            u, mm = snap
            u.seal()
            mm.seal()
            self.rebuild_hot(u, mm)
            return u, mm, snap_iter, False
        u, mm = snap[0].copy(), snap[1].copy()
        u.seal()
        mm.seal()
        self.rebuild_hot(u, mm)
        m.incr("rollbacks")
        new = self.policy.escalate(self.ov, self.trips)
        algo = new.reg_solve_algo or self.config.reg_solve_algo
        detail = (f"rung {self.trips}: rollback to iter {snap_iter}, "
                  f"lam={new.lam}, fused={new.fused_epilogue}, algo={algo}")
        if new != self.ov:
            m.gauge("escalation_level", self.trips)
            m.note(f"escalation_{self.trips}", detail)
            record_event("fault", "escalation", rung=self.trips,
                         detail=detail)
        self.ov = new
        return u, mm, snap_iter, True


def _init_stores(ub, mb, config, warm_start):
    """(user store, movie store): the resident trainers' init on the CPU —
    ``init_factors_stats`` from the seed (count-0 rows zero, so the padded
    and the real-count draws agree) and zero movies, in the storage dtype —
    or the ``warm_start`` pair, padded as ``train_als`` pads it."""
    from cfk_tpu_torch.models.als import _padded_seed
    from cfk_tpu_torch.ops.solve import init_factors_stats

    dt = torch_dtype(config.dtype)
    s, k = config.num_shards, config.rank
    if warm_start is not None:
        u = _padded_seed(warm_start[0], ub.padded_entities, k, "user", "cpu",
                         dt)
        m = _padded_seed(warm_start[1], mb.padded_entities, k, "movie",
                         "cpu", dt)
        return (HostFactorStore.from_array(u, dtype=config.dtype,
                                           num_shards=s),
                HostFactorStore.from_array(m, dtype=config.dtype,
                                           num_shards=s))
    u = init_factors_stats(torch.Generator().manual_seed(config.seed),
                           torch.as_tensor(ub.rating_sum),
                           torch.as_tensor(ub.count), k).to(dt)
    return (HostFactorStore.from_array(u, dtype=config.dtype, num_shards=s),
            HostFactorStore(mb.padded_entities, k, dtype=config.dtype,
                            num_shards=s))


def _build_hot_halves(keys, hot_maps, rows_u, rows_m, stage_name,
                      u_store, m_store, device, sb_of):
    """The hot partitions (gathered from the masters) and every (side,
    shard)'s ``_HotHalf``; ``sb_of(side, d, partition)`` gives the solve
    side's scatter-back maps."""
    u_part = HotPartition(rows_u, stage_name, device)
    m_part = HotPartition(rows_m, stage_name, device)
    u_part.rebuild(u_store)
    m_part.rebuild(m_store)
    halves = {}
    for side, d in keys:
        fixed, solve = (u_part, m_part) if side == "m" else (m_part, u_part)
        halves[(side, d)] = _HotHalf(fixed, solve, hot_maps[(side, d)],
                                     sb_of(side, d, solve), device)
    return halves, u_part, m_part


def train_als_host_window(
    dataset,
    config,
    *,
    device=DEFAULT_DEVICE,
    metrics=None,
    window_faults=None,
    tile_rows: int | None = None,
    chunks_per_window: int | None = None,
    device_budget_bytes: float | None = None,
    verify_windows: bool | None = None,
    staging: str | None = None,
    pool_depth: int | None = None,
    hot_rows: int | None = None,
    checkpoint_manager=None,
    checkpoint_every: int = 1,
    watchdog=None,
    warm_start=None,
):
    """ALS-WR with host-resident factor tables and windowed half-steps, in
    one process (``cfk_tpu/offload/windowed.py:1083``, ``fleet=None``).

    Same math, init and iteration order as ``train_als`` (one shard) or
    ``parallel.spmd.train_als_sharded`` (S shards — all_gather, ring or
    hier_ring exchange) on the same tiled blocks, and the same bits at
    every knob (``tests/test_torch_offload.py``).  Explicit ALS,
    ``layout='tiled'``; the kernels run on ``device`` (the card unless the
    caller asks for the CPU) and the factors stay in host stores.

    ``device_budget_bytes`` bounds the staged working set PER SHARD
    (default: the device's own memory, ``budget.device_memory_bytes``);
    ``chunks_per_window`` overrides the derived window size.  ``hot_rows``
    (default ``config.hot_rows``): None = auto (the coverage-curve knee),
    0 = off, >= 1 = pinned total resident rows.  ``staging`` /
    ``pool_depth`` (defaults from the config): the pooled or serial
    staging engine, the depth clamped by ``budget.max_pool_depth``.
    ``window_faults`` (a ``resilience.faults.WindowFaultInjector``) arms
    the chaos hooks; ``verify_windows`` (default: on when faults are
    armed) checksums every staged window.  ``checkpoint_manager`` saves
    the stores every ``checkpoint_every`` iterations and resumes from its
    newest intact step; ``watchdog`` is ticked at iteration boundaries.
    ``warm_start=(u0, m0)`` (host arrays or tensors, ascending-id rows,
    shorter ones zero-padded) seeds the stores instead of the resident
    init — how the parity tests hand the JAX package's init to the port.
    Returns an ``ALSModel`` whose factors are CPU tensors."""
    from cfk_tpu_torch.models.als import ALSModel
    from cfk_tpu_torch.ops.solve import use_kernels
    from cfk_tpu_torch.telemetry.metrics import Metrics
    from cfk_tpu_torch.transport.checkpoint import should_save

    if config.algorithm != "als":
        raise ValueError(
            f"host-window offload supports the explicit ALS optimizer; "
            f"algorithm={config.algorithm!r} (the implicit family runs "
            "out-of-core through train_ials_host_window)")
    if config.layout != "tiled":
        raise ValueError(f"host-window offload streams the tiled layout; "
                         f"layout={config.layout!r}")
    dev = resolve_device(device)
    use_kernels(config.solver, dev)
    metrics = metrics if metrics is not None else Metrics()
    s = config.num_shards
    k = config.rank
    ring_m, ring_u = _resolve_side_modes(dataset, config)
    any_ring = ring_m or ring_u
    inner = resolve_window_inner(config) if any_ring else max(s, 1)
    with metrics.phase("window_plan"):
        mb, ub = _blocks_for(dataset, config, tile_rows, ring_m, ring_u)
        stage_name = _stage_dtype(config.dtype, config.table_dtype)
        cell_bytes, row_overhead = _stage_cell_bytes(stage_name)
        if device_budget_bytes is None:
            device_budget_bytes = _budget.device_memory_bytes(dev)
        acc_reserved = max([_budget.ring_accumulator_reservation(
            b.local_entities, k, donated=True)
            for b, ring in ((mb, ring_m), (ub, ring_u)) if ring], default=0.0)
        per_window_budget = _budget.window_budget_bytes(
            device_budget_bytes, reserved_bytes=acc_reserved)

        def side_plans(blocks, fixed, ring, cpw):
            if ring:
                return [build_ring_window_plan(blocks, shard=d,
                                               chunks_per_window=cpw)
                        for d in range(s)]
            return [build_window_plan(blocks, fixed.padded_entities,
                                      chunks_per_window=cpw, shard=d)
                    for d in range(s)]

        plans, worst, cpw = _size_windows(
            lambda cpw: (side_plans(mb, ub, ring_m, cpw)
                         + side_plans(ub, mb, ring_u, cpw)),
            k, cell_bytes, row_overhead, per_window_budget,
            chunks_per_window or 4, "ring accumulator reserve")
        m_plans, u_plans = plans[:s], plans[s:]
        staging = resolve_staging(staging if staging is not None
                                  else config.staging)
        pool_depth = max(1, min(
            int(pool_depth or config.staging_pool_depth
                or DEFAULT_POOL_DEPTH),
            _budget.max_pool_depth(device_budget_bytes, worst,
                                   reserved_bytes=acc_reserved)))
        visits = [hier_visit_order(s, inner, d) for d in range(s)]
        schedules = {}
        for side, ps, ring in (("m", m_plans, ring_m),
                               ("u", u_plans, ring_u)):
            for d in range(s):
                schedules[(side, d)] = (ps[d].schedule(visits[d]) if ring
                                        else ps[d].schedule())
        requested = hot_rows if hot_rows is not None else config.hot_rows
        f_u = f_m = 0
        hot_note = None
        hot_maps = {}
        if requested != 0:
            solved_u = np.concatenate([
                _hotmod.solved_rows_of(u_plans[d], d, ub.local_entities)
                for d in range(s)])
            solved_m = np.concatenate([
                _hotmod.solved_rows_of(m_plans[d], d, mb.local_entities)
                for d in range(s)])
            f_u, f_m, counts_u, counts_m, hot_note = _resolve_hot(
                requested, m_plans=m_plans, u_plans=u_plans,
                solved_u=solved_u, solved_m=solved_m, rank=k,
                stage_name=stage_name, budget_bytes=device_budget_bytes,
                reserved=acc_reserved, worst=worst, pool_depth=pool_depth,
                staging=staging)
        if f_u + f_m > 0:
            rows_hot_u = _hotmod.select_hot_rows(counts_u, f_u)
            rows_hot_m = _hotmod.select_hot_rows(counts_m, f_m)
            for d in range(s):
                hot_maps[("m", d)] = _hotmod.build_hot_map(
                    m_plans[d], schedules[("m", d)], rows_hot_u)
                hot_maps[("u", d)] = _hotmod.build_hot_map(
                    u_plans[d], schedules[("u", d)], rows_hot_m)
    _plan_gauges(metrics, m_plans, u_plans, cpw, s, staging, pool_depth,
                 f_u, f_m, hot_note, hot_maps)
    if any_ring:
        metrics.gauge("offload_ici_group", inner)
        metrics.gauge("offload_acc_reserved_mb", round(acc_reserved / 1e6, 3))
        metrics.note("offload_exchange", config.exchange)

    u_store, m_store = _init_stores(ub, mb, config, warm_start)
    start_it = 0
    if checkpoint_manager is not None:
        latest = checkpoint_manager.latest_valid_iteration()
        if latest is not None and latest > 0:
            st = checkpoint_manager.restore(iteration=int(latest))
            u_store.write_range(0, st.user_factors)
            m_store.write_range(0, st.movie_factors)
            start_it = int(latest)
            metrics.gauge("offload_resumed_from", start_it)
            record_event("train", "offload_resume", iteration=start_it)

    hot_halves: dict = {}

    def sb_of(side, d, solve):
        blocks, ring, ps = ((mb, ring_m, m_plans) if side == "m"
                            else (ub, ring_u, u_plans))
        if ring:
            return _hotmod.ring_scatter_back(d, blocks.local_entities,
                                             solve.rows)
        return _hotmod.scatter_back_maps(ps[d], d, blocks.local_entities,
                                         solve.rows)

    def rebuild_hot(u, m):
        nonlocal hot_halves
        if hot_maps:
            hot_halves, u_part, m_part = _build_hot_halves(
                list(hot_maps), hot_maps, rows_hot_u, rows_hot_m,
                stage_name, u, m, dev, sb_of)
            metrics.gauge("offload_hot_resident_mb", round(
                (u_part.nbytes + m_part.nbytes) / 1e6, 3))

    rebuild_hot(u_store, m_store)
    ladder = _Ladder(config, metrics, rebuild_hot)
    norm_limit = (config.health_norm_limit
                  if config.health_check_every is not None else None)
    probe_every = config.health_check_every or 1
    stats = StagingStats()
    if verify_windows is None:
        verify_windows = window_faults is not None
    # Probes and last-good snapshots cost a host pass and a copy of both
    # stores, so they arm only when something can trip.
    armed = (config.health_check_every is not None or verify_windows
             or window_faults is not None)
    count_m = mb.count.reshape(s, -1)
    count_u = ub.count.reshape(s, -1)

    def half(side, fixed_store, plans_, local, counts, it, ring):
        ov = ladder.ov
        algo = ov.reg_solve_algo or config.reg_solve_algo
        if armed:
            # The gather boundary: verify the fixed table's sealed shards
            # before any rotten byte can reach a window.
            fixed_store.scrub()
        hot_on = bool(hot_halves)
        if hot_on and window_faults is not None and \
                hasattr(window_faults, "apply_hot"):
            part = hot_halves[(side, 0)].fixed
            pois = window_faults.apply_hot(it, side, part.num_rows)
            if pois is not None:
                record_event("fault", "hot_cache_corruption", iteration=it,
                             side=side, rows=len(pois))
                part.poison(pois)

        def stage_task(d, w):
            hmap = hot_halves[(side, d)].hmap if hot_on else None
            return _stage_window(
                fixed_store, plans_[d], w, hmap=hmap, stage_name=stage_name,
                faults=window_faults, iteration=it, side=side, shard=d,
                verify_windows=verify_windows, stats=stats,
                ici_group=inner, device=dev)

        tasks = [(d, w) for d in range(s) for w in schedules[(side, d)]]
        stager = WindowStager(
            tasks, stage_task, mode=staging, depth=pool_depth, stats=stats,
            span_attrs=lambda d, w: _stage_span_attrs(
                hot_halves[(side, d)].hmap if hot_on else None,
                plans_[d], w))
        out = torch.empty((local * s, k), dtype=torch_dtype(config.dtype))
        kw = dict(lam=ov.lam, device=dev, out_dtype=config.dtype,
                  solver=config.solver, overlap=config.overlap,
                  fused_epilogue=ov.fused_epilogue,
                  in_kernel_gather=config.in_kernel_gather,
                  reg_solve_algo=algo, table_dtype=config.table_dtype,
                  iteration=it, side=side, stats=stats, ici_group=inner,
                  stager=stager)
        try:
            for d in range(s):
                with span("train/iter/half_step", side=side, shard=d,
                          ring=bool(ring), iteration=it):
                    if ring:
                        rows = ring_windowed_half_step(
                            fixed_store, plans_[d], visits=visits[d],
                            count_local=counts[d], shard=d,
                            hot=hot_halves.get((side, d)), **kw)
                    else:
                        rows = windowed_half_step(
                            fixed_store, plans_[d], shard=d,
                            hot=hot_halves.get((side, d)), **kw)
                out[d * local:(d + 1) * local] = rows
        finally:
            stager.close()
        return out

    snap = (u_store.copy(), m_store.copy()) if armed else (None, None)
    snap_iter = start_it
    it = start_it
    degraded = False
    programs0 = trace_count()
    t0 = time.perf_counter()
    first_step_s = None
    if watchdog is not None:
        watchdog.arm()
    try:
        with metrics.phase("train"):
            while it < config.num_iterations:
                try:
                    with span("train/iter", i=it, tier="host_window"):
                        m_new = half("m", u_store, m_plans, mb.local_entities,
                                     count_m, it, ring_m)
                        m_store.write_range(0, m_new)
                        if armed:
                            m_store.seal()
                        u_new = half("u", m_store, u_plans, ub.local_entities,
                                     count_u, it, ring_u)
                        u_store.write_range(0, u_new)
                        if armed:
                            u_store.seal()
                    record_event("train", "iter", i=it, tier="host_window")
                    it += 1
                    metrics.incr("iterations")
                    if checkpoint_manager is not None and should_save(
                            it, checkpoint_every, config.num_iterations):
                        checkpoint_manager.save(
                            it, u_store.as_tensor(), m_store.as_tensor(),
                            meta={"tier": "host_window"})
                    if window_faults is not None and \
                            hasattr(window_faults, "apply_store"):
                        # Master-store bit-rot lands after the seal and the
                        # checkpoint commit: the committed bytes stay clean.
                        window_faults.apply_store(it - 1, "u", u_store)
                        window_faults.apply_store(it - 1, "m", m_store)
                    if watchdog is not None:
                        watchdog.tick(it)
                    if first_step_s is None:
                        first_step_s = time.perf_counter() - t0
                    if not armed:
                        continue
                    if it % probe_every != 0 and it < config.num_iterations:
                        continue
                    reason = _probe(u_new, m_new, norm_limit)
                    if reason is None:
                        u_store.scrub()
                        m_store.scrub()
                        snap = (u_store.copy(), m_store.copy())
                        snap_iter = it
                        continue
                    u_store, m_store, it, go = ladder.trip(reason, it, snap,
                                                           snap_iter)
                    if not go:
                        degraded = True
                        break
                except WindowIntegrityError as e:
                    # Caught before any kernel read the window: the stores
                    # are intact, so rollback + replay is exact.
                    u_store, m_store, it, go = ladder.trip(
                        f"window integrity: {e}", it, snap, snap_iter)
                    if not go:
                        degraded = True
                        break
                except StoreIntegrityError as e:
                    # Bit-rot in a master table: the committed checkpoint
                    # bytes are the repair source (the snapshot may hold
                    # the rot too).
                    record_event("fault", "store_integrity", iteration=it,
                                 shard=e.shard, detail=str(e))
                    metrics.incr("store_integrity_detected")
                    step = (checkpoint_manager.latest_valid_iteration()
                            if checkpoint_manager is not None else None)
                    if step is None:
                        dump_flight("store_integrity")
                        u_store, m_store, it, go = ladder.trip(
                            f"store integrity: {e}", it, snap, snap_iter)
                        if not go:
                            degraded = True
                            break
                        continue
                    st = checkpoint_manager.restore(iteration=int(step))
                    u_store = HostFactorStore.from_array(
                        st.user_factors, dtype=config.dtype, num_shards=s)
                    m_store = HostFactorStore.from_array(
                        st.movie_factors, dtype=config.dtype, num_shards=s)
                    it = int(step)
                    u_store.seal()
                    m_store.seal()
                    snap = (u_store.copy(), m_store.copy())
                    snap_iter = it
                    rebuild_hot(u_store, m_store)
                    metrics.incr("store_repairs")
                    record_event("fault", "store_repair", iteration=it,
                                 step=int(step))
                    dump_flight("store_integrity_repair")
    finally:
        if watchdog is not None:
            watchdog.disarm()
    _staging_gauges(metrics, stats, staging)
    metrics.gauge("offload_trace_count", trace_count() - programs0)
    if first_step_s is not None:
        metrics.gauge("time_to_first_step_s", round(first_step_s, 4))
    if degraded:
        metrics.gauge("iterations_completed", snap_iter)
    return ALSModel(
        user_factors=u_store.as_tensor(), movie_factors=m_store.as_tensor(),
        num_users=dataset.user_map.num_entities,
        num_movies=dataset.movie_map.num_entities,
        pipeline=dict(route="host_window",
                      reason=f"out-of-core tier: {staging} staging, hot "
                             f"cache {'on' if hot_maps else 'off'}"),
    )


# ---------------------------------------------------------------------------
# Out-of-core iALS / iALS++: the global-Gram reduction over the host store,
# the bucketed width-class windows, and the implicit trainer.
# ---------------------------------------------------------------------------


def windowed_store_gram(store: HostFactorStore, *, device=DEFAULT_DEVICE,
                        table_dtype: str | None = None, stats=None,
                        block_rows: int | None = None) -> torch.Tensor:
    """Global YᵀY of a host-resident factor table, reduced block by block
    into a [k, k] f32 accumulator on ``device``: the store streams through
    in ``ops.solve.GRAM_BLOCK_ROWS`` blocks at the staging dtype, each
    block dequantized as the kernels read it and added by the resident
    ``gram_block_add`` — the blocks and the order of
    ``global_gram_blocked``, so the same bits.  Block i+1 is staged while
    block i's product runs."""
    from cfk_tpu_torch.ops.quant import dequantize_table
    from cfk_tpu_torch.ops.solve import GRAM_BLOCK_ROWS, gram_block_add

    dev = resolve_device(device)
    br = int(block_rows) if block_rows else GRAM_BLOCK_ROWS
    stage_name = _stage_dtype(store.dtype, table_dtype)
    k = store.rank

    def stage(lo):
        hi = min(lo + br, store.rows)
        tbl = store.gather(np.arange(lo, hi, dtype=np.int64))
        if stage_name == "int8":
            data, scale = quantize_rows_host(tbl, device=dev)
        else:
            data, scale = tbl.to(torch_dtype(stage_name)), None
        staged = put_window((data, scale), dev)
        if stats is not None:
            stats_add(stats, "gram_staged_bytes", staged.nbytes)
            stats_add(stats, "gram_blocks_staged", 1)
        return staged

    acc = torch.zeros((k, k), dtype=torch.float32, device=dev)
    starts = list(range(0, store.rows, br))
    nxt = stage(starts[0]) if starts else None
    for i in range(len(starts)):
        cur = nxt
        nxt = stage(starts[i + 1]) if i + 1 < len(starts) else None
        data, scale = cur.ready()
        acc = gram_block_add(acc, dequantize_table(data, scale))
    return acc


def bucket_windowed_half_step(
    fixed_store: HostFactorStore, bplan: BucketWindowPlan, *, gram,
    lam: float, alpha: float, algorithm: str = "als", block_size: int = 32,
    sweeps: int = 1, x_prev=None, device=DEFAULT_DEVICE,
    out_dtype: str = "float32", solver: str = "auto", overlap=None,
    fused_epilogue=None, in_kernel_gather=None, reg_solve_algo=None,
    table_dtype: str | None = None, faults=None, iteration: int = 0,
    side: str = "", stats=None, verify_windows: bool = False,
    shard: int = 0, stager: WindowStager | None = None,
    hot: _HotHalf | None = None,
) -> torch.Tensor:
    """Solve one side's bucketed entities against a host-resident fixed
    table, width-class window by window.  ``gram`` is the device [k, k]
    YᵀY of the fixed table (``windowed_store_gram``).  ``algorithm='als'``
    runs the full implicit solve — K6 per window (K2 + K1 split; K5 and the
    stream twin with the gather off, in the blocks' ``chunk_rows`` pieces
    as the resident walk), the legacy schedule for the classes the
    reference's gate refuses; ``'ials++'`` runs ``sweeps`` subspace passes
    warm-started from ``x_prev`` (the solve side's previous factors,
    required; untouched entities keep them).  Returns the solved
    [padded_entities, rank] CPU tensor in ``out_dtype``."""
    from cfk_tpu_torch.ops.bucketed import (
        bucket_gram_solve,
        bucket_port_supported,
        ials_reparam,
    )
    from cfk_tpu_torch.ops.quant import dequantize_table
    from cfk_tpu_torch.ops.solve import (
        gather_gram_implicit,
        implicit_reg,
        regularized_solve_matrix,
        resolve_fused_chunk,
    )
    from cfk_tpu_torch.ops.subspace import _sweep_rect
    from cfk_tpu_torch.ops.tiled import resolve_gather_mode

    dev = resolve_device(device)
    k = fixed_store.rank
    pp = algorithm == "ials++"
    out_dt = torch_dtype(out_dtype)
    local = bplan.local_entities
    extra_of = None
    if pp:
        if x_prev is None:
            raise ValueError(
                "algorithm='ials++' needs x_prev (the solve side's previous "
                "factors) for the warm-started subspace sweeps")
        x_prev = torch.as_tensor(x_prev)
        out = x_prev[:local].to(out_dt).clone()
        extra_of = warm_rows_of(bplan, x_prev)
    else:
        out = torch.zeros((local, k), dtype=out_dt)
    own = stager is None
    if own:
        stager = _own_stager(
            fixed_store, bplan, bplan.schedule(), table_dtype=table_dtype,
            device=dev, faults=faults, iteration=iteration, side=side,
            shard=shard, verify_windows=verify_windows, stats=stats,
            ici_group=1, hot=hot, extra_of=extra_of)
    gather = resolve_gather_mode(in_kernel_gather)
    fused = resolve_fused_chunk(fused_epilogue, k, reg_solve_algo)
    reg_m = implicit_reg(gram, lam)

    def solve_piece(tbl, scale, ni, rt, mk):
        rows, width = ni.shape
        if not bucket_port_supported(rows, width, k):
            a_obs, b = gather_gram_implicit(dequantize_table(tbl, scale), ni,
                                            alpha * rt, mk)
            a_obs = (a_obs + a_obs.mT) * 0.5
            return regularized_solve_matrix(a_obs, b, reg_m, solver,
                                            algo=reg_solve_algo)
        wt, rt_b = ials_reparam(rt, mk, alpha)
        return bucket_gram_solve(tbl, ni, wt, rt_b, reg_m, lam=0.0,
                                 reg_mode="matrix", solver=solver,
                                 gather=gather, fused=fused, scale=scale,
                                 algo=reg_solve_algo)

    def sweep_piece(tbl, scale, xb, ni, rt, mk):
        for _ in range(sweeps):
            xb = _sweep_rect(tbl, xb, ni, rt, mk, lam, alpha, gram,
                             block_size, solver, fused_epilogue=fused_epilogue,
                             scale=scale, reg_solve_algo=reg_solve_algo)
        return xb

    prev = pending = None
    consumed = []
    n_w = bplan.num_windows
    try:
        staged = stager.take() if n_w else None
        for w in range(n_w):
            consumed.append(staged)
            _ncw, chunk, width, whole = bplan.window_shape(w)
            rows = _window_rows_of(bplan, w)
            with span("train/iter/half_step/window_compute", side=side,
                      shard=shard, window=w):
                tbl, scale, rest = _window_table(staged, hot, w, prev)
                nb, rt, mk = (a.view(rows, width) for a in rest[:3])
                # The resident walk's pieces: the blocks' chunk_rows for
                # the sweeps and for a streamed (gather-off) kernel-route
                # class; one piece per window otherwise (the kernels solve
                # each entity on its own, the legacy classes stage whole).
                step = rows
                if not whole and (pp or (
                        gather == "xla"
                        and bucket_port_supported(rows, width, k))):
                    step = chunk
                _PROGRAMS.add(("bucket", pp, rows, step, width, k, tbl.dtype,
                               scale is not None, fused, gather, solver,
                               str(dev)))
                pieces = []
                for lo in range(0, rows, step):
                    sl = slice(lo, lo + step)
                    if pp:
                        pieces.append(sweep_piece(tbl, scale,
                                                  rest[3][sl], nb[sl],
                                                  rt[sl], mk[sl]))
                    else:
                        pieces.append(solve_piece(tbl, scale, nb[sl], rt[sl],
                                                  mk[sl]))
                xs = (pieces[0] if len(pieces) == 1
                      else torch.cat(pieces)).to(out_dt)
                if hot is not None:
                    prev = (tbl, scale)
                    sb = hot.sb_idx(w)
                    if sb is not None:
                        hot.solve.update(sb[0], sb[1], xs)
                nxt = stager.take() if w + 1 < n_w else None
                if pending is not None:
                    pending.finish(out, local)
                pending = _Pending(xs, bplan.chunk_entity_of(w)[:rows])
            staged = nxt
        if pending is not None:
            pending.finish(out, local)
        _meter_copies(stats, consumed)
    finally:
        if own:
            stager.close()
    return out


def warm_rows_of(bplan: BucketWindowPlan, x_prev):
    """iALS++'s per-window staged extra: each window slot's warm-start row
    ``x_prev[entity]`` in float32, trash slots zero (the resident walk's
    zero scratch row), gathered from a frozen copy (pool workers read
    it)."""
    local = bplan.local_entities
    x_prev = torch.as_tensor(x_prev)
    x_pad = torch.zeros((local + 1, x_prev.shape[-1]), dtype=torch.float32)
    x_pad[:local] = x_prev[:local].float()

    def extra_of(w):
        ent = bplan.chunk_entity_of(w)[: _window_rows_of(bplan, w)]
        return (x_pad[torch.from_numpy(ent.astype(np.int64))],)

    return extra_of


def _window_rows_of(bplan: BucketWindowPlan, w: int) -> int:
    """The real rows of bucket window ``w`` (pad chunks excluded)."""
    _ncw, chunk, _width, whole = bplan.window_shape(w)
    return chunk if whole else int(bplan.chunk_counts[w]) * chunk


def train_ials_host_window(
    dataset,
    config,
    *,
    device=DEFAULT_DEVICE,
    metrics=None,
    window_faults=None,
    chunks_per_window: int | None = None,
    device_budget_bytes: float | None = None,
    verify_windows: bool | None = None,
    staging: str | None = None,
    pool_depth: int | None = None,
    hot_rows: int | None = None,
    warm_start=None,
):
    """Implicit ALS / iALS++ with host-resident factor tables and windowed
    width-class half-steps (``cfk_tpu/offload/windowed.py:2789``).

    Same math, init and iteration order as ``models.ials.train_ials`` on
    the same bucketed blocks, and the same bits.  Per half-iteration::

        gram  = windowed_store_gram(fixed store)   # streamed YᵀY
        solve = width-class windows through the resident bucket pieces
        commit = store.write_range

    The [k, k] Gram accumulator and its double-buffered staged block are
    reserved (``budget.gram_reservation_bytes``) before window sizing.
    Divergence recovery runs the ladder against in-RAM last-good snapshots;
    the Gram needs none (recomputed from the restored masters each half)
    and the hot partitions rebuild from them.  One process.
    ``warm_start`` as in ``train_als_host_window``."""
    from cfk_tpu_torch.data.blocks import BucketedBlocks
    from cfk_tpu_torch.models.als import ALSModel
    from cfk_tpu_torch.ops.bucketed import bucket_port_supported
    from cfk_tpu_torch.ops.solve import use_kernels
    from cfk_tpu_torch.telemetry.metrics import Metrics

    if getattr(config, "alpha", None) is None:
        raise ValueError(
            "host-window iALS needs an implicit-feedback config (IALSConfig "
            "— the confidence weight alpha drives the solve)")
    if config.algorithm not in ("als", "ials++"):
        raise ValueError(
            f"host-window iALS supports algorithm in ('als', 'ials++'); "
            f"got {config.algorithm!r}")
    if config.layout != "bucketed":
        raise ValueError(
            f"host-window iALS streams the bucketed width-class layout; "
            f"layout={config.layout!r}")
    mb, ub = dataset.movie_blocks, dataset.user_blocks
    if not isinstance(mb, BucketedBlocks) or not isinstance(
            ub, BucketedBlocks):
        raise ValueError(
            "host-window iALS needs BucketedBlocks on both sides — build "
            "the dataset with layout='bucketed'")
    s = config.num_shards
    if mb.num_shards != s or ub.num_shards != s:
        raise ValueError(
            f"blocks built at num_shards={mb.num_shards}/{ub.num_shards} "
            f"but config.num_shards={s} — rebuild the dataset")
    from cfk_tpu_torch.models.ials import _check_nonnegative_strengths

    _check_nonnegative_strengths(dataset)
    dev = resolve_device(device)
    use_kernels(config.solver, dev)
    pp = config.algorithm == "ials++"
    k = config.rank
    metrics = metrics if metrics is not None else Metrics()
    with metrics.phase("window_plan"):
        stage_name = _stage_dtype(config.dtype, config.table_dtype)
        cell_bytes, row_overhead = _stage_cell_bytes(stage_name)
        if device_budget_bytes is None:
            device_budget_bytes = _budget.device_memory_bytes(dev)
        gram_reserved = _budget.gram_reservation_bytes(k, stage_name)
        per_window_budget = _budget.window_budget_bytes(
            device_budget_bytes, reserved_bytes=gram_reserved)

        def whole(blocks):
            # Classes on the legacy schedule solve in one batched call on
            # the resident walk: their windows stage the whole class.
            if pp:
                return ()
            return tuple(j for j, b in enumerate(blocks.buckets)
                         if not bucket_port_supported(
                             b.neighbor_idx.shape[0], b.width, k))

        plans, worst, cpw = _size_windows(
            lambda cpw: [
                build_bucket_window_plan(mb, ub.padded_entities,
                                         chunks_per_window=cpw,
                                         whole_buckets=whole(mb)),
                build_bucket_window_plan(ub, mb.padded_entities,
                                         chunks_per_window=cpw,
                                         whole_buckets=whole(ub))],
            k, cell_bytes, row_overhead, per_window_budget,
            chunks_per_window or 4,
            f"{gram_reserved / 1e6:.2f} MB global-Gram accumulator reserve")
        m_plan, u_plan = plans
        staging = resolve_staging(staging if staging is not None
                                  else config.staging)
        pool_depth = max(1, min(
            int(pool_depth or config.staging_pool_depth
                or DEFAULT_POOL_DEPTH),
            _budget.max_pool_depth(device_budget_bytes, worst,
                                   reserved_bytes=gram_reserved)))
        requested = hot_rows if hot_rows is not None else config.hot_rows
        f_u = f_m = 0
        hot_note = None
        hot_maps = {}
        if requested != 0:
            f_u, f_m, counts_u, counts_m, hot_note = _resolve_hot(
                requested, m_plans=[m_plan], u_plans=[u_plan],
                solved_u=_hotmod.solved_rows_of(u_plan, 0,
                                                ub.padded_entities),
                solved_m=_hotmod.solved_rows_of(m_plan, 0,
                                                mb.padded_entities),
                rank=k, stage_name=stage_name,
                budget_bytes=device_budget_bytes, reserved=gram_reserved,
                worst=worst, pool_depth=pool_depth, staging=staging)
        if f_u + f_m > 0:
            rows_hot_u = _hotmod.select_hot_rows(counts_u, f_u)
            rows_hot_m = _hotmod.select_hot_rows(counts_m, f_m)
            hot_maps[("m", 0)] = _hotmod.build_hot_map(
                m_plan, m_plan.schedule(), rows_hot_u)
            hot_maps[("u", 0)] = _hotmod.build_hot_map(
                u_plan, u_plan.schedule(), rows_hot_m)
    _plan_gauges(metrics, [m_plan], [u_plan], cpw, s, staging, pool_depth,
                 f_u, f_m, hot_note, hot_maps)
    metrics.gauge("offload_gram_reserved_mb", round(gram_reserved / 1e6, 3))
    metrics.note("offload_optimizer", "ials++" if pp else "ials")

    u_store, m_store = _init_stores(ub, mb, config, warm_start)
    hot_halves: dict = {}

    def sb_of(side, d, solve):
        plan, blocks = (m_plan, mb) if side == "m" else (u_plan, ub)
        return _hotmod.scatter_back_maps(plan, 0, blocks.padded_entities,
                                         solve.rows)

    def rebuild_hot(u, m):
        nonlocal hot_halves
        if hot_maps:
            hot_halves, u_part, m_part = _build_hot_halves(
                list(hot_maps), hot_maps, rows_hot_u, rows_hot_m,
                stage_name, u, m, dev, sb_of)
            metrics.gauge("offload_hot_resident_mb", round(
                (u_part.nbytes + m_part.nbytes) / 1e6, 3))

    rebuild_hot(u_store, m_store)
    ladder = _Ladder(config, metrics, rebuild_hot)
    norm_limit = (config.health_norm_limit
                  if config.health_check_every is not None else None)
    probe_every = config.health_check_every or 1
    stats = StagingStats()
    if verify_windows is None:
        verify_windows = window_faults is not None
    armed = (config.health_check_every is not None or verify_windows
             or window_faults is not None)

    def half(side, fixed_store, solve_store, plan, it, gram):
        ov = ladder.ov
        algo = ov.reg_solve_algo or config.reg_solve_algo
        hot_half = hot_halves.get((side, 0))
        if hot_half is not None and window_faults is not None and \
                hasattr(window_faults, "apply_hot"):
            pois = window_faults.apply_hot(it, side, hot_half.fixed.num_rows)
            if pois is not None:
                record_event("fault", "hot_cache_corruption", iteration=it,
                             side=side, rows=len(pois))
                hot_half.fixed.poison(pois)
        x_prev = solve_store.as_tensor() if pp else None
        kw = dict(gram=gram, lam=ov.lam, alpha=config.alpha,
                  algorithm=config.algorithm, block_size=config.block_size,
                  sweeps=config.sweeps, x_prev=x_prev, device=dev,
                  out_dtype=config.dtype, solver=config.solver,
                  overlap=config.overlap, fused_epilogue=ov.fused_epilogue,
                  in_kernel_gather=config.in_kernel_gather,
                  reg_solve_algo=algo, table_dtype=config.table_dtype,
                  faults=window_faults, iteration=it, side=side,
                  stats=stats, verify_windows=verify_windows, hot=hot_half)
        # The half's stager in the configured mode; iALS++'s warm rows
        # ride each window.
        stager = _own_stager(
            fixed_store, plan, plan.schedule(),
            table_dtype=config.table_dtype, device=dev, faults=window_faults,
            iteration=it, side=side, shard=0, verify_windows=verify_windows,
            stats=stats, ici_group=1, hot=hot_half,
            extra_of=warm_rows_of(plan, x_prev) if pp else None,
            mode=staging, depth=pool_depth)
        try:
            with span("train/iter/half_step", side=side, iteration=it,
                      tier="host_window"):
                return bucket_windowed_half_step(fixed_store, plan,
                                                 stager=stager, **kw)
        finally:
            stager.close()

    snap = (u_store.copy(), m_store.copy()) if armed else (None, None)
    snap_iter = 0
    it = 0
    degraded = False
    programs0 = trace_count()
    with metrics.phase("train"):
        while it < config.num_iterations:
            try:
                with span("train/iter", i=it, tier="host_window",
                          optimizer="ials++" if pp else "ials"):
                    gram_u = windowed_store_gram(
                        u_store, device=dev, table_dtype=config.table_dtype,
                        stats=stats)
                    m_new = half("m", u_store, m_store, m_plan, it, gram_u)
                    m_store.write_range(0, m_new)
                    gram_m = windowed_store_gram(
                        m_store, device=dev, table_dtype=config.table_dtype,
                        stats=stats)
                    u_new = half("u", m_store, u_store, u_plan, it, gram_m)
                    u_store.write_range(0, u_new)
                record_event("train", "iter", i=it, tier="host_window")
            except WindowIntegrityError as e:
                u_store, m_store, it, go = ladder.trip(
                    f"window integrity: {e}", it, snap, snap_iter)
                if not go:
                    degraded = True
                    break
                continue
            it += 1
            metrics.incr("iterations")
            if not armed:
                continue
            if it % probe_every != 0 and it < config.num_iterations:
                continue
            reason = _probe(u_new, m_new, norm_limit)
            if reason is None:
                snap = (u_store.copy(), m_store.copy())
                snap_iter = it
                continue
            u_store, m_store, it, go = ladder.trip(reason, it, snap,
                                                   snap_iter)
            if not go:
                degraded = True
                break
    _staging_gauges(metrics, stats, staging)
    metrics.gauge("offload_trace_count", trace_count() - programs0)
    if degraded:
        metrics.gauge("iterations_completed", snap_iter)
    return ALSModel(
        user_factors=u_store.as_tensor(), movie_factors=m_store.as_tensor(),
        num_users=dataset.user_map.num_entities,
        num_movies=dataset.movie_map.num_entities,
        pipeline=dict(route="host_window",
                      reason=f"out-of-core tier ({'ials++' if pp else 'ials'}"
                             f"): {staging} staging, hot cache "
                             f"{'on' if hot_maps else 'off'}"),
    )
