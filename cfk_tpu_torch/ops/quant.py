"""Quantized factor tables: float32, bfloat16, or int8 codes + per-row scale.

The port of ``cfk_tpu/ops/quant.py``: the tables the serving engine scores
against, and the gather tables of training (``ALSConfig.table_dtype``: the
fixed side each half-iteration gathers from, stored bf16 — half the bytes
of every gathered row — or int8 plus one f32 scale per row — a quarter;
Gram and solve stay float32).  Codes and scales are bit-identical to the
JAX package's for the same float32 table:

- ``bfloat16`` is the round-to-nearest-even cast (torch's and XLA's cast);
- ``int8`` is symmetric per row: s = max|row| / 127 (1.0 for an all-zero
  row, NaN for a row holding NaN), q = clip(round_half_even(f / s), ±127).

Consumers dequantize element by element, ``code · scale`` in float32, before
any product (the canonical placement the JAX kernels pin).  In training the
int8 scale rides the gather's per-entry weight: ``fold_scale`` first
(wt' = wt·scale[nb], float32), then the one premultiply g = code·wt' — the
order every gather route (the kernels, K5's stream, their plain versions,
the subspace sweeps) shares, so they agree bit for bit.
"""

from __future__ import annotations

import torch

TABLE_DTYPES = ("float32", "bfloat16", "int8")

# 127 (not 128) keeps the grid symmetric, so -f quantizes to -q exactly.
_INT8_LEVELS = 127.0


def resolve_table_dtype(table_dtype: str | None) -> str:
    """None → the f32 identity; otherwise validate the name."""
    if table_dtype is None:
        return "float32"
    if table_dtype not in TABLE_DTYPES:
        raise ValueError(
            f"table_dtype must be one of {TABLE_DTYPES}, got {table_dtype!r}"
        )
    return table_dtype


def table_itemsize(table_dtype: str | None) -> int:
    """Bytes per table element."""
    return {"float32": 4, "bfloat16": 2, "int8": 1}[
        resolve_table_dtype(table_dtype)
    ]


def quantize_table(table: torch.Tensor, table_dtype: str | None
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(data, scale) on ``table``'s device.

    ``float32`` → (table, None); ``bfloat16`` → (bf16 cast, None); ``int8``
    → (int8 codes [F, k], float32 scales [F]).  ``amax == 0`` (not
    ``amax > 0``) picks the unit scale, so a NaN row keeps a NaN scale that
    downstream finiteness checks can see.
    """
    td = resolve_table_dtype(table_dtype)
    if td == "float32":
        return table, None
    if td == "bfloat16":
        return table.to(torch.bfloat16), None
    f = table.to(torch.float32)
    amax = f.abs().amax(dim=-1)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / _INT8_LEVELS)
    q = torch.clamp(torch.round(f / scale[:, None]), -_INT8_LEVELS,
                    _INT8_LEVELS).to(torch.int8)
    return q, scale


def dequantize_table(data: torch.Tensor, scale: torch.Tensor | None
                     ) -> torch.Tensor:
    """The values consumers read: f32 ``code · scale`` for int8, else the
    data as it is."""
    if scale is None:
        return data
    return data.to(torch.float32) * scale[:, None]


def scale_with_zero_row(scale: torch.Tensor) -> torch.Tensor:
    """[F+1] scales with the virtual zero row appended: index F (the gather
    kernels' padding row) reads scale 0, so a folded weight at a padding
    slot is exactly 0 whatever its mask."""
    return torch.cat([scale, scale.new_zeros(1)])


def fold_scale(wt: torch.Tensor, scale: torch.Tensor | None,
               nb: torch.Tensor) -> torch.Tensor:
    """The canonical scale fold: the per-entry weight times the indexed
    row's dequant scale, in float32 (the identity when the table carries no
    scale).  ``nb`` may index F, the virtual zero row (scale 0)."""
    if scale is None:
        return wt
    return wt * scale_with_zero_row(scale)[nb.long()].to(wt.dtype)


def gather_operand_view(table: torch.Tensor, table_dtype: str | None
                        ) -> torch.Tensor:
    """The values the gather kernels read, as a whole table — for the
    consumers of the full matrix (the iALS global Gram YᵀY, the padded and
    segment layouts): the bf16 cast for bfloat16, the f32 dequantized rows
    for int8, the table itself for float32."""
    data, scale = quantize_table(table, table_dtype)
    return dequantize_table(data, scale)


def validate_table_dtype_layout(table_dtype: str | None, layout: str) -> None:
    """int8 needs the per-row scale threaded through a half-step's weight
    stream, which the tiled chunks, the bucketed walk and the subspace
    sweeps carry; the padded and segment layouts have none to fold it into,
    so int8 is refused there (dequantizing up front would give up the bytes
    it saves).  bf16 is a plain cast and works on every layout."""
    td = resolve_table_dtype(table_dtype)
    if td == "int8" and layout not in ("tiled", "bucketed"):
        raise ValueError(
            f"table_dtype='int8' supports layout='tiled'/'bucketed' (the "
            f"per-row scale rides their weight streams); layout={layout!r} "
            "should use 'bfloat16' or 'float32'"
        )
