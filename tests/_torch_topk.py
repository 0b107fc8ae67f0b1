"""Top-K agreement check shared by the port's serving tests and ``chip_smoke.py``.

``compare_topk`` holds a top-K result against a reference under the rule the
port's K4 ``topk_scores`` is held to: scores within a relative tolerance,
ids equal except at near-ties of the reference.  ``split_bounds`` states the
kernel's row partition for the plan tests.  It lives with the tests, not
in ``cfk_tpu_torch.serving``, because only checks use it; ``chip_smoke.py``
imports it from here.
"""

from __future__ import annotations

import numpy as np
import torch


def compare_topk(got_v, got_i, want_v, want_i, want_v_ext=None, *,
                 tol: float = 1e-5) -> dict:
    """How a top-K result (got) agrees with a reference (want).

    Scores must match within ``tol`` of the largest finite |score| and
    share their −inf slots; ids must be equal except where the reference's
    adjacent scores differ by less than that — near-ties, whose order a
    different float32 summation order may flip.  ``want_v_ext``, the
    reference's K+1 scores, lets the last position's tie be seen.  Returns
    ``{"ok", "max_abs_err", "rel_err", "id_mismatches"}``.
    """
    got_v, got_i, want_v, want_i = (
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in (got_v, got_i, want_v, want_i))
    fin = np.isfinite(want_v)
    inf_ok = (got_v.shape == want_v.shape
              and np.array_equal(np.isfinite(got_v), fin)
              and np.array_equal(got_v[~fin], want_v[~fin]))
    scale = max(float(np.abs(want_v[fin]).max(initial=0.0)), 1e-30)
    err = (float(np.abs(got_v[fin] - want_v[fin]).max())
           if inf_ok and fin.any() else 0.0)
    ext = want_v if want_v_ext is None else want_v_ext
    ext = ext.cpu().numpy() if isinstance(ext, torch.Tensor) else np.asarray(ext)
    with np.errstate(invalid="ignore"):
        close = np.abs(np.diff(ext, axis=1)) < tol * scale
    kk = want_v.shape[1]
    tied = np.zeros(want_v.shape, bool)
    tied[:, 1:] |= close[:, : kk - 1]
    tied[:, : close.shape[1]] |= close[:, :kk]
    bad = int(((got_i != want_i) & ~tied).sum())
    return {"ok": bool(inf_ok and err <= tol * scale and bad == 0),
            "max_abs_err": err, "rel_err": err / scale, "id_mismatches": bad}


def split_bounds(splits: int, m_pad: int, tile_rows: int = 256
                 ) -> list[tuple[int, int]]:
    """Each pass-1 split's table rows [lo, hi), as K4's kernel derives them
    (``topk_kernel.split_plan``): split s takes tiles [s·T // splits,
    (s + 1)·T // splits) of the T 256-row tiles, the last one cut at
    ``m_pad``."""
    tiles = -(-m_pad // tile_rows)
    return [(s * tiles // splits * tile_rows,
             min((s + 1) * tiles // splits * tile_rows, m_pad))
            for s in range(splits)]
