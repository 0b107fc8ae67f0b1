"""Host-RAM factor tables, sharded by entity range.

The port of ``cfk_tpu/offload/store.py``: the out-of-core tier's ground
truth.  The full factor matrix lives in host memory as contiguous
entity-range shards (each shard is what one host would own; a one-process
run holds them all), and the device only ever sees gathered WINDOWS of it
(``offload.windowed``).  Shards are CPU tensors at the storage dtype —
float32, or bfloat16 by torch's round-to-nearest-even cast, whose bits are
the reference's ``ml_dtypes`` rows — pinned (page-locked) when a card is
present, so the staging copies can run asynchronously.  A sealed shard
carries the crc32 (``zlib``) of its raw bytes.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class StoreIntegrityError(RuntimeError):
    """A sealed shard's bytes no longer match their crc32 — host-RAM
    bit-rot (or an unsanctioned in-place write).  ``shard`` names the block
    so the repair path can be surgical."""

    def __init__(self, msg: str, *, shard: int = -1) -> None:
        super().__init__(msg)
        self.shard = int(shard)


def torch_dtype(name: str | None) -> torch.dtype:
    """The storage dtype of a store dtype name (None → float32); anything
    but float32/bfloat16 raises, as the reference's ``_np_dtype`` does."""
    name = "float32" if name is None else name
    if name not in _DTYPES:
        raise ValueError(
            f"HostFactorStore stores master factors as 'float32' or "
            f"'bfloat16', got {name!r}"
        )
    return _DTYPES[name]


def tensor_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of a CPU tensor (bf16 through its 16-bit view)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def crc32_tensor(t: torch.Tensor) -> int:
    """crc32 of a CPU tensor's raw bytes."""
    return zlib.crc32(tensor_bytes(t))


def quantize_rows_host(rows, *, device="cpu"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8-quantize factor rows on the host — (codes, per-row f32 scales),
    the arithmetic of ``ops.quant.quantize_table`` row by row (the per-row
    scheme makes any subset of rows quantize independently), so a staged
    int8 window carries exactly the codes and scales the resident path
    quantizes.  NaN rows poison their scale, as there.

    ``quantize_table`` computes ``amax / 127`` as its device does: on a
    card PyTorch multiplies by the reciprocal rounded once to float32, as
    the reference's host quantizer (``cfk_tpu/offload/store.py:52-84``) and
    its jitted ``quantize_table`` do; on the CPU it divides, as the
    reference's ``quantize_table`` run eagerly (its serving engine) does.
    So rows bound for a CUDA ``device`` take the product — bit-equal to the
    reference's host quantizer — and others ``quantize_table`` itself, and
    a staged int8 window equals the resident quantization on either
    device."""
    from cfk_tpu_torch.ops.quant import quantize_table

    rows = torch.as_tensor(rows)
    if rows.shape[0] == 0:
        return (torch.zeros(rows.shape, dtype=torch.int8),
                torch.zeros((0,), dtype=torch.float32))
    if torch.device(device).type != "cuda":
        return quantize_table(rows, "int8")
    f = rows.to(torch.float32)
    amax = f.abs().amax(dim=-1)
    inv = torch.tensor(1.0, dtype=torch.float32) / 127.0
    scale = torch.where(amax == 0, torch.ones_like(amax), amax * inv)
    q = torch.clamp(torch.round(f / scale[:, None]), -127.0,
                    127.0).to(torch.int8)
    return q, scale


def _pin(t: torch.Tensor, pin: bool) -> torch.Tensor:
    return t.pin_memory() if pin else t


class HostFactorStore:
    """[rows, rank] factor table in host RAM, entity-range sharded.

    ``pin`` (None: when a card is present) allocates the shards in
    page-locked memory."""

    def __init__(self, rows: int, rank: int, *, dtype: str = "float32",
                 num_shards: int = 1, pin: bool | None = None) -> None:
        if rows < 1 or rank < 1:
            raise ValueError(f"rows/rank must be >= 1, got {rows}/{rank}")
        if num_shards < 1 or num_shards > rows:
            raise ValueError(
                f"num_shards must be in [1, rows={rows}], got {num_shards}"
            )
        self.rows, self.rank = int(rows), int(rank)
        self.dtype = "float32" if dtype is None else dtype
        self.torch_dtype = torch_dtype(dtype)
        self.pinned = (torch.cuda.is_available() if pin is None
                       else bool(pin))
        per = -(-rows // num_shards)
        # Clipped ceil-split (rows=10, shards=7 walks past 10 at shard 5:
        # trailing shards are then empty), as the reference places them.
        self.bounds = np.minimum(np.arange(0, num_shards + 1) * per, rows)
        self._shards = [
            _pin(torch.zeros((int(self.bounds[s + 1] - self.bounds[s]),
                              rank), dtype=self.torch_dtype), self.pinned)
            for s in range(num_shards)
        ]
        # Per-shard seals: crc32 of the bytes at the last ``seal()``, or
        # None while the shard is dirty.
        self._crcs: list = [None] * num_shards

    @classmethod
    def from_array(cls, arr, *, dtype: str | None = None,
                   num_shards: int = 1,
                   pin: bool | None = None) -> "HostFactorStore":
        """Wrap a host array or tensor (copied into the shard layout and
        cast to ``dtype``, which defaults to the array's own)."""
        t = _as_cpu(arr)
        name = dtype or ("bfloat16" if t.dtype == torch.bfloat16
                         else "float32")
        store = cls(t.shape[0], t.shape[1], dtype=name,
                    num_shards=num_shards, pin=pin)
        store.write_range(0, t)
        return store

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    @property
    def nbytes(self) -> int:
        return sum(s.numel() * s.element_size() for s in self._shards)

    def shard(self, s: int) -> torch.Tensor:
        """Direct (mutable) view of shard ``s``."""
        return self._shards[s]

    def shard_of_rows(self, rows) -> np.ndarray:
        """Which store shard owns each row (the staging path's fabric
        attribution)."""
        rows = np.asarray(rows, dtype=np.int64)
        return np.searchsorted(self.bounds, rows, side="right") - 1

    def gather(self, rows, out: torch.Tensor | None = None) -> torch.Tensor:
        """[len(rows), rank] window of the table (any order, repeats OK),
        into ``out`` when given (a pinned staging buffer) — the staging
        read.  ``index_select`` releases the GIL, so pooled staging threads
        gather concurrently."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size and (rows.min() < 0 or rows.max() >= self.rows):
            raise IndexError(
                f"window rows outside [0, {self.rows}): "
                f"[{rows.min()}, {rows.max()}]"
            )
        idx = torch.from_numpy(rows)
        if out is None:
            out = torch.empty((rows.shape[0], self.rank),
                              dtype=self.torch_dtype)
        if self.num_shards == 1:
            return torch.index_select(self._shards[0], 0, idx, out=out)
        sh = np.searchsorted(self.bounds, rows, side="right") - 1
        for s in range(self.num_shards):
            m = sh == s
            if m.any():
                sel = torch.from_numpy(np.nonzero(m)[0])
                out[sel] = torch.index_select(
                    self._shards[s], 0,
                    torch.from_numpy(rows[m] - self.bounds[s]))
        return out

    def write_range(self, start: int, values) -> None:
        """Write a contiguous [n, rank] row block at ``start`` (the solved
        rows streaming back; cast to the store dtype)."""
        values = _as_cpu(values)
        stop = start + values.shape[0]
        if start < 0 or stop > self.rows:
            raise IndexError(
                f"write [{start}, {stop}) outside [0, {self.rows})"
            )
        pos = start
        s = int(np.searchsorted(self.bounds, start, side="right") - 1)
        while pos < stop:
            while self.bounds[s + 1] <= pos:
                s += 1
            hi = min(stop, int(self.bounds[s + 1]))
            lo_s = int(self.bounds[s])
            self._shards[s][pos - lo_s:hi - lo_s] = values[
                pos - start:hi - start].to(self.torch_dtype)
            self._crcs[s] = None
            pos = hi

    def write_rows(self, rows, values) -> None:
        """Scatter [n, rank] values at arbitrary row ids."""
        rows = np.asarray(rows, dtype=np.int64)
        values = _as_cpu(values).to(self.torch_dtype)
        sh = np.searchsorted(self.bounds, rows, side="right") - 1
        for s in range(self.num_shards):
            m = sh == s
            if m.any():
                self._shards[s][torch.from_numpy(rows[m] - self.bounds[s])] \
                    = values[torch.from_numpy(np.nonzero(m)[0])]
                self._crcs[s] = None

    def as_tensor(self) -> torch.Tensor:
        """The whole table as one CPU tensor (a copy when sharded)."""
        if self.num_shards == 1:
            return self._shards[0]
        return torch.cat(self._shards, dim=0)

    def as_array(self) -> np.ndarray:
        """The whole table as a float32 host array (exact for bf16)."""
        return self.as_tensor().float().numpy()

    def copy(self) -> "HostFactorStore":
        """Deep copy (the last-good snapshot); starts unsealed."""
        out = HostFactorStore(self.rows, self.rank, dtype=self.dtype,
                              num_shards=self.num_shards, pin=self.pinned)
        for s in range(self.num_shards):
            out._shards[s].copy_(self._shards[s])
        return out

    # --- integrity seals ---------------------------------------------------

    def seal(self) -> None:
        """Checksum every dirty shard (crc32 of its raw bytes) — at write
        boundaries, after a half's solved rows are committed."""
        for s in range(self.num_shards):
            if self._crcs[s] is None:
                self._crcs[s] = crc32_tensor(self._shards[s])

    def scrub(self) -> None:
        """Verify every sealed shard against its crc32 (dirty ones are
        skipped); raises ``StoreIntegrityError`` naming the first corrupt
        shard."""
        for s in range(self.num_shards):
            want = self._crcs[s]
            if want is None:
                continue
            got = crc32_tensor(self._shards[s])
            if got != want:
                raise StoreIntegrityError(
                    f"factor store shard {s} fails its integrity seal "
                    f"(crc32 {got:#010x} != sealed {want:#010x}): host-RAM "
                    f"bit-rot in rows [{int(self.bounds[s])}, "
                    f"{int(self.bounds[s + 1])}) — repair from the last "
                    "committed checkpoint",
                    shard=s,
                )


def _as_cpu(x) -> torch.Tensor:
    """A host array (a numpy bfloat16 one too) or tensor as a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(x).view(np.uint16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))
