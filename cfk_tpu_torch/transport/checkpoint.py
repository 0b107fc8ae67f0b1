"""Factor checkpoints: a directory of atomically committed steps.

The port's copy of the synchronous half of ``cfk_tpu/transport/checkpoint.py``
with the same on-disk layout, so a step written by either package restores
in the other — the way trained factors cross between them:

    <dir>/step_0000007/{manifest.json, user.npy, movie.npy}

A step is written to a temporary directory, fsync'd and renamed into place,
so a crash never leaves half a step; the manifest records each payload's
crc32, and ``verify``/``restore`` refuse a payload that no longer matches.
Factors are stored as float32 (or float64); bfloat16 factors are stored as
float32 with ``"dtype": "bfloat16"`` in the manifest and restored as torch
bfloat16 tensors (numpy has no bfloat16).  The background writer, pinning,
retention and the journal store belong to a later slice.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import warnings
import zlib

import numpy as np
import torch

from cfk_tpu_torch.telemetry.recorder import dump_flight, record_event

_MANIFEST = "manifest.json"
_STEP_PREFIX = "step_"
_PAYLOADS = ("user.npy", "movie.npy")
_RESERVED = ("iteration", "user_shape", "movie_shape", "dtype", "crc32")


class CheckpointCorruptError(ValueError):
    """A step failed integrity verification."""


@dataclasses.dataclass(frozen=True)
class CheckpointState:
    iteration: int  # iterations fully completed
    user_factors: np.ndarray | torch.Tensor
    movie_factors: np.ndarray | torch.Tensor
    meta: dict


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _fsync(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - fsync on directories unsupported
        pass
    finally:
        os.close(fd)


def _host(x) -> tuple[np.ndarray, str]:
    """(host array as stored, the dtype name the manifest records)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.to(torch.float32).numpy(), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype not in (np.float32, np.float64):
        return x.astype(np.float32), str(x.dtype)
    return x, str(x.dtype)


class CheckpointManager:
    """Directory-of-steps checkpoint store with atomic per-step commits."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, iteration: int) -> str:
        return os.path.join(self.directory, f"{_STEP_PREFIX}{iteration:07d}")

    def save(self, iteration: int, user_factors, movie_factors,
             meta: dict | None = None) -> str:
        """Write one step (numpy arrays or torch tensors); returns its path."""
        u, stored_dtype = _host(user_factors)
        m, _ = _host(movie_factors)
        if u.dtype != m.dtype:
            m = m.astype(u.dtype)
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_")
        try:
            np.save(os.path.join(tmp, "user.npy"), u)
            np.save(os.path.join(tmp, "movie.npy"), m)
            manifest = {
                "iteration": iteration,
                "user_shape": list(u.shape),
                "movie_shape": list(m.shape),
                "dtype": stored_dtype,
                "crc32": {name: _crc32_file(os.path.join(tmp, name))
                          for name in _PAYLOADS},
                **(meta or {}),
            }
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            for name in _PAYLOADS:
                _fsync(os.path.join(tmp, name))
            _fsync(tmp)
            final = self._step_dir(iteration)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _fsync(self.directory)
            # Flight-record the commit after the rename: the event means
            # "this step is durably on disk".
            record_event("checkpoint", "checkpoint_committed",
                         iteration=iteration)
            return final
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def iterations(self) -> list[int]:
        """Committed steps, ascending (a step without a manifest is not one)."""
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith(_STEP_PREFIX) and os.path.exists(
                    os.path.join(self.directory, name, _MANIFEST)):
                steps.append(int(name[len(_STEP_PREFIX):]))
        return sorted(steps)

    def latest_iteration(self) -> int | None:
        steps = self.iterations()
        return steps[-1] if steps else None

    def _manifest(self, iteration: int) -> dict:
        step = self._step_dir(iteration)
        try:
            with open(os.path.join(step, _MANIFEST)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"checkpoint step {iteration} in {self.directory} has an "
                f"unreadable manifest ({e}); the write was torn — delete "
                f"{step} or restore an earlier step"
            ) from None

    def verify(self, iteration: int) -> None:
        """Raise ``CheckpointCorruptError`` unless the manifest parses and
        every payload matches its recorded crc32."""
        step = self._step_dir(iteration)
        for name, want in (self._manifest(iteration).get("crc32") or {}).items():
            try:
                got = _crc32_file(os.path.join(step, name))
            except OSError as e:
                raise CheckpointCorruptError(
                    f"checkpoint step {iteration} is missing payload "
                    f"{name!r} ({e})"
                ) from None
            if got != want:
                raise CheckpointCorruptError(
                    f"checkpoint step {iteration} payload {name!r} fails its "
                    f"manifest checksum (crc32 {got:#010x} != recorded "
                    f"{want:#010x}); delete {step} or restore an earlier step"
                )

    def latest_valid_iteration(self) -> int | None:
        """Newest step that verifies; corrupt steps are skipped with a
        warning."""
        for it in reversed(self.iterations()):
            try:
                self.verify(it)
            except CheckpointCorruptError as e:
                warnings.warn(f"skipping corrupt checkpoint: {e}")
                # Falling back past a corrupt step leaves a forensic trail.
                record_event("checkpoint", "corrupt_checkpoint_skipped",
                             iteration=it, error=str(e))
                dump_flight("corrupt_checkpoint")
                continue
            return it
        return None

    def manifest_meta(self, iteration: int) -> dict:
        """The caller's ``meta`` of one verified step, without the payloads."""
        self.verify(iteration)
        return {k: v for k, v in self._manifest(iteration).items()
                if k not in _RESERVED}

    def restore(self, iteration: int | None = None) -> CheckpointState:
        """The given step (verified), or the newest valid one."""
        if iteration is None:
            iteration = self.latest_valid_iteration()
            if iteration is None:
                raise FileNotFoundError(
                    f"no intact checkpoints in {self.directory}"
                )
        else:
            self.verify(iteration)
        step = self._step_dir(iteration)
        manifest = self._manifest(iteration)
        u = np.load(os.path.join(step, "user.npy"))
        m = np.load(os.path.join(step, "movie.npy"))
        want = manifest.get("dtype", "float32")
        if str(u.dtype) != want:
            if want != "bfloat16":
                raise CheckpointCorruptError(
                    f"checkpoint step {iteration} stores {u.dtype} for "
                    f"dtype {want!r}; the port restores float32, float64 "
                    "and bfloat16 factors"
                )
            u = torch.from_numpy(u).to(torch.bfloat16)
            m = torch.from_numpy(m).to(torch.bfloat16)
        return CheckpointState(
            iteration=manifest["iteration"], user_factors=u, movie_factors=m,
            meta={k: v for k, v in manifest.items() if k not in _RESERVED},
        )
