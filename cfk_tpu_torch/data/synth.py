"""Counter-based synthetic power-law ratings — the port's copy of
``cfk_tpu/data/synth.py`` (numpy only; the same spec gives the same stream,
bit for bit, and the same ``crc32()``).

``data/synthetic.py`` materializes the whole COO through a sequential RNG,
which has two problems at the ALX regime (~1B ratings / 10M users,
arXiv 2112.02194): the full arrays are ~16 GB of host RAM before a single
block is built, and the draw is stateful — generating the stream in chunks
(or per shard) changes every value after the first boundary.  This module
makes the stream a PURE FUNCTION of ``(seed, index)``:

- every rating entry ``i`` is derived from a splitmix64-style counter hash
  (one stream per field: user draw, movie draw, rating), so entry ``i`` has
  the same bits no matter which chunk, process, or shard materializes it —
  "deterministic by construction", pinned by ``crc32()``;
- popularity is Zipf on both axes (the property that stresses the block
  layouts), realized by inverse-CDF lookup into an O(num_entities) float64
  cumulative table — the only materialized state, ~160 MB at 10M users;
  nothing dense in the interaction space ever exists;
- entity ids are scattered through the id space by a seeded permutation
  (like ``synthetic.py``) so contiguous-range sharding stays load-balanced.

``chunk(lo, hi)`` yields any index range independently; ``coo()`` is the
small-shape convenience that materializes one ``RatingsCOO`` (tests, the
offload parity suite); ``iter_chunks`` / ``crc32`` stream without ever
holding more than one chunk.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from cfk_tpu_torch.data.blocks import RatingsCOO

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
# Field streams: the per-entry draws must be independent across fields, so
# each field hashes a distinct stream constant into the counter.
_STREAM_USER = np.uint64(0x243F6A8885A308D3)
_STREAM_MOVIE = np.uint64(0x13198A2E03707344)
_STREAM_RATING = np.uint64(0xA4093822299F31D0)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over a uint64 array (vectorized, stateless)."""
    z = x.astype(np.uint64, copy=True)
    z ^= z >> np.uint64(30)
    z *= _MIX1
    z ^= z >> np.uint64(27)
    z *= _MIX2
    z ^= z >> np.uint64(31)
    return z


def _counter_uniform(seed: int, stream: np.uint64, lo: int, hi: int
                     ) -> np.ndarray:
    """U[0, 1) float64 for indices [lo, hi): ``mix(seed·φ ^ stream + i·φ)``
    — pure in (seed, stream, i), so any chunking of the index range
    produces identical values."""
    idx = np.arange(lo, hi, dtype=np.uint64)
    # 0-d array keeps the deliberate mod-2^64 wrap silent (numpy warns on
    # overflowing SCALAR uint ops only).
    base = (np.asarray(seed & 0xFFFFFFFFFFFFFFFF, np.uint64) * _GOLDEN
            ) ^ stream
    z = _mix64(base + (idx + np.uint64(1)) * _GOLDEN)
    # 53-bit mantissa path: exactly representable, bit-stable.
    return (z >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


def zipf_cdf(n: int, skew: float) -> np.ndarray:
    """Cumulative Zipf(skew) over ranks 1..n (float64; the inverse-CDF
    lookup table — O(n) memory, the module's only materialized state)."""
    p = (1.0 / np.arange(1, n + 1, dtype=np.float64)) ** skew
    cdf = np.cumsum(p / p.sum())
    cdf[-1] = 1.0  # guard searchsorted against cumsum rounding
    return cdf


@dataclasses.dataclass(frozen=True)
class SynthSpec:
    """Shape + seed of one synthetic power-law corpus.  Two specs with the
    same fields generate bit-identical streams on any machine."""

    num_users: int
    num_movies: int
    nnz: int
    seed: int = 0
    user_skew: float = 0.7
    movie_skew: float = 0.9

    def __post_init__(self) -> None:
        for f in ("num_users", "num_movies", "nnz"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1, got {getattr(self, f)}")

    def shard_range(self, shard: int, num_shards: int) -> tuple[int, int]:
        """Contiguous index range of ``shard``'s entries (balanced split;
        the union over shards tiles [0, nnz) exactly — both bounds clamp,
        so a ceil-split overshooting nnz by more than one shard leaves
        trailing shards EMPTY instead of inverted)."""
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} not in [0, {num_shards})")
        per = -(-self.nnz // num_shards)
        return min(shard * per, self.nnz), min((shard + 1) * per, self.nnz)


class PowerLawSynth:
    """Chunk-addressable generator for a ``SynthSpec`` (see module doc)."""

    def __init__(self, spec: SynthSpec) -> None:
        self.spec = spec
        # The permutations and CDF tables come from ONE seeded generator in
        # a fixed draw order; per-entry values never touch it (they are
        # counter-hashed), so chunk boundaries cannot perturb anything.
        rng = np.random.default_rng(spec.seed)
        self._m_ids = rng.permutation(spec.num_movies).astype(np.int64) + 1
        self._u_ids = rng.permutation(spec.num_users).astype(np.int64) + 1
        self._m_cdf = zipf_cdf(spec.num_movies, spec.movie_skew)
        self._u_cdf = zipf_cdf(spec.num_users, spec.user_skew)

    def chunk(self, lo: int, hi: int
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(user_raw, movie_raw, rating) for entries [lo, hi) — bit-equal
        to the same slice of any other chunking."""
        s = self.spec
        if not 0 <= lo <= hi <= s.nnz:
            raise ValueError(f"chunk [{lo}, {hi}) outside [0, {s.nnz})")
        uu = _counter_uniform(s.seed, _STREAM_USER, lo, hi)
        um = _counter_uniform(s.seed, _STREAM_MOVIE, lo, hi)
        ur = _counter_uniform(s.seed, _STREAM_RATING, lo, hi)
        u_idx = np.searchsorted(self._u_cdf, uu, side="right")
        m_idx = np.searchsorted(self._m_cdf, um, side="right")
        # searchsorted can return n when u lands exactly on the guarded 1.0
        np.clip(u_idx, 0, s.num_users - 1, out=u_idx)
        np.clip(m_idx, 0, s.num_movies - 1, out=m_idx)
        rating = (1.0 + np.floor(ur * 5.0)).astype(np.float32)
        return self._u_ids[u_idx], self._m_ids[m_idx], rating

    def iter_chunks(self, chunk_elems: int = 1 << 22):
        """Yield ``(lo, hi, user_raw, movie_raw, rating)`` over the whole
        stream without ever materializing more than one chunk."""
        if chunk_elems < 1:
            raise ValueError(f"chunk_elems must be >= 1, got {chunk_elems}")
        for lo in range(0, self.spec.nnz, chunk_elems):
            hi = min(lo + chunk_elems, self.spec.nnz)
            u, m, r = self.chunk(lo, hi)
            yield lo, hi, u, m, r

    def coo(self, lo: int = 0, hi: int | None = None) -> RatingsCOO:
        """Materialize entries [lo, hi) as a ``RatingsCOO`` (small shapes:
        tests, block builds, the offload parity suite)."""
        u, m, r = self.chunk(lo, self.spec.nnz if hi is None else hi)
        return RatingsCOO(movie_raw=m, user_raw=u, rating=r)

    def crc32(self, chunk_elems: int = 1 << 22) -> int:
        """Checksum of the record stream, chunking-invariant: each entry
        contributes its (user, movie, rating) record bytes in index order
        regardless of how the stream is chunked."""
        rec_t = np.dtype(
            [("u", "<i8"), ("m", "<i8"), ("r", "<f4")]
        )
        crc = 0
        for _, _, u, m, r in self.iter_chunks(chunk_elems):
            rec = np.empty(u.shape[0], dtype=rec_t)
            rec["u"], rec["m"], rec["r"] = u, m, r
            crc = zlib.crc32(rec.tobytes(), crc)
        return crc & 0xFFFFFFFF


def synth_coo(num_users: int, num_movies: int, nnz: int, *, seed: int = 0,
              user_skew: float = 0.7, movie_skew: float = 0.9) -> RatingsCOO:
    """One-call convenience: the whole spec as a ``RatingsCOO``."""
    return PowerLawSynth(SynthSpec(
        num_users=num_users, num_movies=num_movies, nnz=nnz, seed=seed,
        user_skew=user_skew, movie_skew=movie_skew,
    )).coo()
