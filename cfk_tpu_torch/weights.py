"""Factor matrices into the port's model: from numpy, or from a checkpoint.

``cfk_tpu.models.als.ALSModel.host_factors()`` returns the JAX package's
trained factors as float32 numpy arrays (rows in ascending external-id
order, padding trimmed); ``factors_from_numpy`` turns such a pair — or a
padded pair with the real entity counts — into the port's ``ALSModel`` so
that both packages can be held to the same state.
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
                       num_users: int | None = None,
                       num_movies: int | None = None,
                       device: str | torch.device = DEFAULT_DEVICE) -> ALSModel:
    """(U [num_users, k], M [num_movies, k]) float32 → ``ALSModel``.

    ``num_users`` / ``num_movies`` take factor tables with padded rows
    beyond the real entities (each layout pads its own way: a trainer's raw
    [padded_entities, k] output, or the JAX package's ``_one_iteration``'s)
    and keep only the real ones; by default every row is real."""
    u = np.asarray(u, dtype=np.float32)
    m = np.asarray(m, dtype=np.float32)
    if u.ndim != 2 or m.ndim != 2 or u.shape[1] != m.shape[1]:
        raise ValueError(
            f"factor shapes {u.shape} and {m.shape} are not [*, k] of one rank")
    nu = u.shape[0] if num_users is None else num_users
    nm = m.shape[0] if num_movies is None else num_movies
    if nu > u.shape[0] or nm > m.shape[0]:
        raise ValueError(
            f"factor tables ({u.shape[0]} users, {m.shape[0]} movies) are "
            f"smaller than the entity counts ({nu}, {nm})")
    dev = resolve_device(device)
    return ALSModel(
        user_factors=torch.tensor(u[:nu], device=dev),
        movie_factors=torch.tensor(m[:nm], device=dev),
        num_users=nu,
        num_movies=nm,
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
