"""Factor matrices from numpy into the port's model.

``cfk_tpu.models.als.ALSModel.host_factors()`` returns the JAX package's
trained factors as float32 numpy arrays (rows in ascending external-id
order, padding trimmed); ``factors_from_numpy`` turns such a pair into the
port's ``ALSModel`` so that both packages can be held to the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from cfk_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from cfk_tpu_torch.models.als import ALSModel


def factors_from_numpy(u: np.ndarray, m: np.ndarray, *,
                       device: str | torch.device = DEFAULT_DEVICE) -> ALSModel:
    """(U [num_users, k], M [num_movies, k]) float32 → ``ALSModel``."""
    u = np.asarray(u, dtype=np.float32)
    m = np.asarray(m, dtype=np.float32)
    if u.ndim != 2 or m.ndim != 2 or u.shape[1] != m.shape[1]:
        raise ValueError(
            f"factor shapes {u.shape} and {m.shape} are not [*, k] of one rank")
    dev = resolve_device(device)
    return ALSModel(
        user_factors=torch.as_tensor(u, device=dev),
        movie_factors=torch.as_tensor(m, device=dev),
        num_users=u.shape[0],
        num_movies=m.shape[0],
    )
