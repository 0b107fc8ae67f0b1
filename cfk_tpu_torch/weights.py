"""Factor matrices into the port's model: from numpy, or from a checkpoint.

``cfk_tpu.models.als.ALSModel.host_factors()`` returns the JAX package's
trained factors as float32 numpy arrays (rows in ascending external-id
order, padding trimmed); ``factors_from_numpy`` turns such a pair — or a
padded pair with the real entity counts, or a bfloat16 pair (a
``dtype="bfloat16"`` run's raw factors, which numpy holds in ml_dtypes'
``bfloat16``, read here through a uint16 view) — into the port's
``ALSModel`` so that both packages can be held to the same state.
``model_from_checkpoint`` restores a step of a checkpoint directory written
by either package's ``CheckpointManager`` (the JAX package's ``train
--checkpoint-dir`` or the port's).
"""

from __future__ import annotations

import numpy as np
import torch

from cfk_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from cfk_tpu_torch.models.als import ALSModel, as_tensor


def factors_from_numpy(u: np.ndarray, m: np.ndarray, *,
                       num_users: int | None = None,
                       num_movies: int | None = None,
                       device: str | torch.device = DEFAULT_DEVICE) -> ALSModel:
    """(U [num_users, k], M [num_movies, k]) float32 or bfloat16 →
    ``ALSModel`` (a bfloat16 pair stays bfloat16, as a bf16 run's factors
    are stored; anything else becomes float32).

    ``num_users`` / ``num_movies`` take factor tables with padded rows
    beyond the real entities (each layout pads its own way: a trainer's raw
    [padded_entities, k] output, or the JAX package's ``_one_iteration``'s)
    and keep only the real ones; by default every row is real."""
    u, m = np.asarray(u), np.asarray(m)
    if u.dtype.name != "bfloat16" or m.dtype.name != "bfloat16":
        u = u.astype(np.float32, copy=False)
        m = m.astype(np.float32, copy=False)
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
        user_factors=as_tensor(np.array(u[:nu]), dev),
        movie_factors=as_tensor(np.array(m[:nm]), dev),
        num_users=nu,
        num_movies=nm,
    )


def model_from_checkpoint(directory: str, *, num_users: int, num_movies: int,
                          device: str | torch.device = DEFAULT_DEVICE
                          ) -> ALSModel:
    """``ALSModel`` over the factors of the newest valid step of
    ``directory`` (float32, or bfloat16 for a ``--dtype bfloat16`` run);
    its factor rows may be padded beyond ``num_users`` / ``num_movies``
    (the trainers store their padded tables) but not fewer."""
    from cfk_tpu_torch.transport.checkpoint import CheckpointManager

    state = CheckpointManager(directory).restore()
    return model_from_state(state, num_users=num_users,
                            num_movies=num_movies, device=device)


def model_from_state(state, *, num_users: int, num_movies: int,
                     device: str | torch.device = DEFAULT_DEVICE) -> ALSModel:
    """``ALSModel`` over a restored ``CheckpointState``'s factors: bfloat16
    ones (the manifest's dtype, ``transport.checkpoint``) stay bfloat16,
    anything else becomes float32; the consumers (predict, recommend, the
    serving engine) read them in float32."""
    rows = (state.user_factors.shape[0], state.movie_factors.shape[0])
    if rows[0] < num_users or rows[1] < num_movies:
        raise ValueError(
            f"checkpoint factors ({rows[0]} users, {rows[1]} movies) are "
            f"smaller than the data implies ({num_users}, {num_movies}); "
            "wrong --data for this checkpoint?"
        )
    dev = resolve_device(device)

    def restored(x):
        x = torch.as_tensor(x)
        dt = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
        return x.to(device=dev, dtype=dt)

    return ALSModel(
        user_factors=restored(state.user_factors),
        movie_factors=restored(state.movie_factors),
        num_users=int(num_users),
        num_movies=int(num_movies),
    )
