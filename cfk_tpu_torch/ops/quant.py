"""Quantized item tables: float32, bfloat16, or int8 codes + per-row scale.

The port's copy of the table-quantization half of ``cfk_tpu/ops/quant.py``
(the serving slice needs only that half; the training-side scale fold waits
for the quantized-training slice).  Codes and scales are bit-identical to
the JAX package's for the same float32 table:

- ``bfloat16`` is the round-to-nearest-even cast (torch's and XLA's cast);
- ``int8`` is symmetric per row: s = max|row| / 127 (1.0 for an all-zero
  row, NaN for a row holding NaN), q = clip(round_half_even(f / s), ±127).

Consumers dequantize element by element, ``code · scale`` in float32, before
any product (the canonical placement the JAX kernels pin).
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
