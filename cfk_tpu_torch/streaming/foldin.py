"""Incremental fold-in: solve ONLY the touched users against fixed movies.

The port of ``cfk_tpu/streaming/foldin.py``'s ``fold_in_rows``: exactly one
ALS half-iteration restricted to the touched rows — each touched user's
normal equations

    (Σ m mᵀ + λ·n·I) u = Σ r·m        over that user's CURRENT ratings

solved against the fixed movie factors, through the half-steps training
runs.  Two layouts:

- ``"padded"`` — one [E, P] rectangle built directly from the touched
  users' neighbor lists and solved by ``ops.solve.als_half_step`` (the
  masked gather and Gram by PyTorch, the ridge + solve by K1 on a card);
- ``"tiled"`` — ``data.blocks.build_tiled_blocks`` over the touched set
  (at most 65,536 users, so accum mode), staged by ``models.als.
  _tiled_to_device`` and solved by ``ops.tiled.tiled_half_step``: K2 per
  chunk, then K1 on the accumulator (the split epilogue and the "gj" route
  under the recovery ladder's overrides, as in training).

Shapes keep the reference's power-of-two buckets: E = ``_pow2_ceil(t, 8)``
touched rows and P the power-of-two multiple of ``pad_multiple`` above the
widest neighbor list, so a long stream converges onto a handful of
shapes.  The port has no jit to trace; ``trace_count()`` counts the fold-in
program keys — (layout, E, P or the tiled statics, the solve
configuration, the table) — seen for the first time in this process.  On a
card a first key may build a kernel or stage a plan, and ``StreamSession.
prewarm``'s contract (no new key on the first real batch) is stated in
these keys.

Determinism contract (the reference's): the solved rows are a
deterministic function of (neighbor lists, movie factors, solve
configuration) — neighbor lists arrive sorted by movie row
(``StreamState.neighbors``), so the same batch always produces
bit-identical rows.  Rows ARE sensitive at the last-ulp level to the
batch's composition (co-members set the padded width and the batch
shapes), which is why the exactly-once pipeline pins batch boundaries to
log offsets (``cfk_tpu_torch.streaming.consumer``).

``fold_in_rows_windowed`` is the fold-in against a host-resident movie
store (``offload.store.HostFactorStore``, the out-of-core session): the
batch's touched movie rows stage as one window and the padded program
solves the same rectangle, so its rows are the resident fold-in's bits.
"""

from __future__ import annotations

import numpy as np
import torch

from cfk_tpu_torch.ops.solve import als_half_step
from cfk_tpu_torch.ops.tiled import tiled_half_step

def _pow2_ceil(x: int, floor: int) -> int:
    out = floor
    while out < x:
        out *= 2
    return out


# Fold-in program keys seen by this process (both layouts).
_PROGRAMS: set = set()


def trace_count() -> int:
    """Fold-in program keys seen for the first time in this process (both
    layouts) — the port's count of the reference's jit traces."""
    return len(_PROGRAMS)


def fold_in_rows(movie_factors: torch.Tensor, neighbor_data, **kw
                 ) -> np.ndarray:
    """Solve the touched users' rows against fixed ``movie_factors``.

    ``neighbor_data`` is a sequence of ``(movie_rows int32, ratings f32)``
    pairs, one per touched user, each sorted by movie row.  Returns the
    solved float32 rows ``[len(neighbor_data), k]`` in the same order, on
    the host; the solve runs on ``movie_factors``' device.  Keywords as
    ``fold_in_tensor``'s."""
    return fold_in_tensor(movie_factors, neighbor_data, **kw).cpu().numpy()


def fold_in_tensor(
    movie_factors: torch.Tensor,
    neighbor_data,
    *,
    lam: float,
    solver: str = "auto",
    layout: str = "padded",
    pad_multiple: int = 8,
    fused_epilogue: bool | None = None,
    in_kernel_gather: bool | None = None,
    reg_solve_algo: str | None = None,
) -> torch.Tensor:
    """``fold_in_rows``' solved rows as a float32 tensor on
    ``movie_factors``' device, for a caller that reads them there (the
    session's probe) before it copies them to the host."""
    table = movie_factors  # [M, k], float32 or bfloat16
    t = len(neighbor_data)
    if t == 0:
        return table.new_zeros((0, table.shape[-1]), dtype=torch.float32)
    if layout == "tiled":
        return _fold_tiled(
            table, neighbor_data, lam=lam, solver=solver,
            fused_epilogue=fused_epilogue, in_kernel_gather=in_kernel_gather,
            reg_solve_algo=reg_solve_algo,
        )
    if layout != "padded":
        raise ValueError(
            f"fold-in layout must be 'padded' or 'tiled', got {layout!r}"
        )
    neighbor_idx, rating, mask, count = _padded_rectangle(neighbor_data,
                                                         pad_multiple)
    e, p = neighbor_idx.shape
    _PROGRAMS.add(("padded", e, p, float(lam), solver, reg_solve_algo,
                   tuple(table.shape), str(table.dtype), str(table.device)))
    dev = table.device
    out = als_half_step(
        table, torch.as_tensor(neighbor_idx, device=dev),
        torch.as_tensor(rating, device=dev), torch.as_tensor(mask, device=dev),
        torch.as_tensor(count, device=dev), float(lam),
        solver=solver, reg_solve_algo=reg_solve_algo,
    )
    return out[:t].float()


def _padded_rectangle(neighbor_data, pad_multiple: int, col_of=None):
    """The padded fold-in's (neighbor_idx, rating, mask, count) host
    rectangle [E, P] of the touched users (E and P the power-of-two
    buckets); ``col_of`` maps the concatenated movie rows to the indices
    stored (the windowed fold-in's rebase)."""
    t = len(neighbor_data)
    width = max(int(mv.shape[0]) for mv, _ in neighbor_data)
    p = _pow2_ceil(max(width, 1), max(pad_multiple, 1))
    e = _pow2_ceil(t, 8)
    lengths = np.fromiter((mv.shape[0] for mv, _ in neighbor_data),
                          np.int64, t)
    rows = np.repeat(np.arange(t, dtype=np.int64), lengths)
    cols = np.arange(rows.shape[0], dtype=np.int64) - np.repeat(
        np.cumsum(lengths) - lengths, lengths)
    neighbor_idx = np.zeros((e, p), np.int32)
    rating = np.zeros((e, p), np.float32)
    mask = np.zeros((e, p), np.float32)
    count = np.zeros((e,), np.float32)
    if rows.shape[0]:
        mv = np.concatenate([mv for mv, _ in neighbor_data])
        neighbor_idx[rows, cols] = mv if col_of is None else col_of(mv)
        rating[rows, cols] = np.concatenate([rt for _, rt in neighbor_data])
        mask[rows, cols] = 1.0
    count[:t] = lengths
    return neighbor_idx, rating, mask, count


def fold_in_rows_windowed(
    movie_store,
    neighbor_data,
    *,
    lam: float,
    solver: str = "auto",
    pad_multiple: int = 8,
    reg_solve_algo: str | None = None,
    stats: dict | None = None,
    return_staged: bool = False,
    device="cuda",
):
    """Restricted fold-in against an OUT-OF-CORE movie table
    (``cfk_tpu/streaming/foldin.py:146``).

    ``movie_store`` is a host-resident ``offload.store.HostFactorStore``;
    the batch's touched movie rows stage to ``device`` as ONE window
    (unique rows gathered on the host, one copy), the neighbor indices
    rebase into it (``searchsorted``) and the padded fold-in solves the
    identical pow2 rectangle — the same gathered values, mask-0 cells
    exact zeros, the same shape — so the rows are the resident
    ``fold_in_rows``' bits.  The window's row count buckets to a power of
    two (min 8); its pad slots repeat window row 0 (masked out).
    ``return_staged=True`` also returns the staged window (what the
    session's probe reads); ``stats`` receives ``foldin_windows_staged`` /
    ``foldin_staged_bytes``.  Returns float32 host rows."""
    from cfk_tpu_torch.device import resolve_device
    from cfk_tpu_torch.offload.staging import put_window

    t = len(neighbor_data)
    k = movie_store.rank
    if t == 0:
        empty = np.zeros((0, k), np.float32)
        return (empty, None) if return_staged else empty
    parts = [mv.astype(np.int64) for mv, _ in neighbor_data if mv.shape[0]]
    touched = (np.unique(np.concatenate(parts)) if parts
               else np.zeros((1,), np.int64))
    w = _pow2_ceil(int(touched.size), 8)
    rows = np.concatenate([touched,
                           np.full(w - touched.size, touched[0], np.int64)])
    window = movie_store.gather(rows)
    if stats is not None:
        stats["foldin_windows_staged"] = (
            stats.get("foldin_windows_staged", 0) + 1)
        stats["foldin_staged_bytes"] = (
            stats.get("foldin_staged_bytes", 0)
            + window.numel() * window.element_size())
    dev = resolve_device(device)
    (staged,) = put_window((window,), dev).ready()
    neighbor_idx, rating, mask, count = _padded_rectangle(
        neighbor_data, pad_multiple,
        col_of=lambda mv: np.searchsorted(touched, mv.astype(np.int64)))
    e, p = neighbor_idx.shape
    _PROGRAMS.add(("padded_window", e, p, w, float(lam), solver,
                   reg_solve_algo, str(staged.dtype), str(dev)))
    out = als_half_step(
        staged, torch.as_tensor(neighbor_idx, device=dev),
        torch.as_tensor(rating, device=dev), torch.as_tensor(mask, device=dev),
        torch.as_tensor(count, device=dev), float(lam),
        solver=solver, reg_solve_algo=reg_solve_algo,
    )
    solved = out[:t].float().cpu().numpy()
    return (solved, staged) if return_staged else solved


def tiled_blocks(neighbor_data, movie_rows: int):
    """The tiled fold-in's blocks of the touched users (``neighbor_data``
    as ``fold_in_rows`` takes it) over a ``movie_rows``-row table."""
    from cfk_tpu_torch.data.blocks import build_tiled_blocks

    t = len(neighbor_data)
    lengths = np.fromiter((mv.shape[0] for mv, _ in neighbor_data),
                          np.int64, t)
    solve_dense = np.repeat(np.arange(t, dtype=np.int64), lengths)
    fixed_dense = np.concatenate(
        [mv.astype(np.int64) for mv, _ in neighbor_data]
    )
    rating = np.concatenate([rt for _, rt in neighbor_data])
    return build_tiled_blocks(solve_dense, fixed_dense, rating, t,
                              movie_rows)


def _fold_tiled(table, neighbor_data, *, lam, solver, fused_epilogue,
                in_kernel_gather, reg_solve_algo):
    from cfk_tpu_torch.models.als import _tiled_to_device

    t = len(neighbor_data)
    movie_rows = int(table.shape[0])
    blocks = tiled_blocks(neighbor_data, movie_rows)
    chunks = ("tiled", blocks.mode) + tuple(blocks.statics)
    _PROGRAMS.add(("tiled", chunks, blocks.padded_entities, float(lam),
                   solver, fused_epilogue, in_kernel_gather, reg_solve_algo,
                   tuple(table.shape), str(table.dtype), str(table.device)))
    blk = _tiled_to_device(blocks, table.device, movie_rows)
    out = tiled_half_step(
        table, blk, chunks, blocks.padded_entities, float(lam),
        solver=solver, fused_epilogue=fused_epilogue,
        in_kernel_gather=in_kernel_gather, reg_solve_algo=reg_solve_algo,
    )
    return out[:t].float()
