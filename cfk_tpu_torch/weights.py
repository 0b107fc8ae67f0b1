"""Factor matrices into the port's model: from numpy, or from a checkpoint.

``cfk_tpu.models.als.ALSModel.host_factors()`` returns the JAX package's
trained factors as float32 numpy arrays (rows in ascending external-id
order, padding trimmed); ``factors_from_numpy`` turns such a pair into the
port's ``ALSModel`` so that both packages can be held to the same state.
``model_from_checkpoint`` restores a step of a checkpoint directory written
by either package's ``CheckpointManager`` (the JAX package's ``train
--checkpoint-dir`` or the port's).
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


def model_from_checkpoint(directory: str, *, num_users: int, num_movies: int,
                          device: str | torch.device = DEFAULT_DEVICE
                          ) -> ALSModel:
    """``ALSModel`` over the float32 factors of the newest valid step of
    ``directory``; its factor rows may be padded beyond ``num_users`` /
    ``num_movies`` (the trainers store their padded tables) but not
    fewer."""
    from cfk_tpu_torch.transport.checkpoint import CheckpointManager

    state = CheckpointManager(directory).restore()
    return model_from_state(state, num_users=num_users,
                            num_movies=num_movies, device=device)


def model_from_state(state, *, num_users: int, num_movies: int,
                     device: str | torch.device = DEFAULT_DEVICE) -> ALSModel:
    """``ALSModel`` over a restored ``CheckpointState``'s factors."""
    rows = (state.user_factors.shape[0], state.movie_factors.shape[0])
    if rows[0] < num_users or rows[1] < num_movies:
        raise ValueError(
            f"checkpoint factors ({rows[0]} users, {rows[1]} movies) are "
            f"smaller than the data implies ({num_users}, {num_movies}); "
            "wrong --data for this checkpoint?"
        )
    dev = resolve_device(device)
    return ALSModel(
        user_factors=torch.as_tensor(state.user_factors).to(
            device=dev, dtype=torch.float32),
        movie_factors=torch.as_tensor(state.movie_factors).to(
            device=dev, dtype=torch.float32),
        num_users=int(num_users),
        num_movies=int(num_movies),
    )
