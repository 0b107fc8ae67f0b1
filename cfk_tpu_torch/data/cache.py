"""On-disk dataset cache: skip the host-side block build on repeat runs.

The port's copy of ``cfk_tpu/data/cache.py``, in the same on-disk format
(format version 3, the same class names), so a cache the JAX package wrote
for the padded, bucketed, tiled or segment layout loads here too.

At full-Netflix scale parsing + indexing + block building costs minutes of
host time per process start while the result is fully deterministic for a
given (data, layout, chunking) tuple.  ``save_dataset`` serializes a built
``Dataset`` — every block layout, both sides, id maps, and the dense COO —
into one uncompressed ``.npz`` (arrays) plus a JSON skeleton (dataclass
structure and scalars); ``load_dataset`` rebuilds it with zero
recomputation.

Format: the object tree is walked generically — any frozen dataclass whose
fields are ndarrays / scalars / None / tuples of dataclasses round-trips —
so new block layouts serialize without touching this module (they only need
registering in ``_CLASSES``).  Caches of either package load in the other,
sharded and ring-built ones too; a class field the port does not know is
refused.  Nothing the port derives from
the blocks at upload (the Gram kernels' work-unit plans) is stored, so a
loaded dataset recomputes it as a built one does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
import uuid

import numpy as np

from cfk_tpu_torch.data.blocks import (
    Bucket,
    BucketedBlocks,
    Dataset,
    IdMap,
    PaddedBlocks,
    RatingsCOO,
    SegmentBlocks,
    TiledBlocks,
)

# 1: arrays always in "arrays.npz". 2: uniquely-named arrays file recorded in
# meta.json "arrays" (meta is the atomic commit point pairing the two).
# 3: tiled-layout padding entries index the appended zero row of the fixed
#    table (neighbor = slice height) instead of row 0 — pre-3 TILED caches
#    would silently compute garbage under the unit-weight fast path, so
#    those specifically are refused (other layouts are unchanged and stay
#    readable).
_FORMAT_VERSION = 3
_READABLE_VERSIONS = (1, 2, 3)

_CLASSES = {
    cls.__name__: cls
    for cls in (
        Bucket,
        BucketedBlocks,
        Dataset,
        IdMap,
        PaddedBlocks,
        RatingsCOO,
        SegmentBlocks,
        TiledBlocks,
    )
}


def _flatten(obj, prefix: str, arrays: dict):
    if isinstance(obj, np.ndarray):
        arrays[prefix] = obj
        return {"__array__": prefix}
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    if isinstance(obj, tuple):
        return {
            "__tuple__": [
                _flatten(x, f"{prefix}.{i}", arrays) for i, x in enumerate(obj)
            ]
        }
    if dataclasses.is_dataclass(obj):
        name = type(obj).__name__
        if name not in _CLASSES:
            raise TypeError(f"unregistered dataclass in dataset tree: {name}")
        return {
            "__class__": name,
            "fields": {
                f.name: _flatten(getattr(obj, f.name), f"{prefix}.{f.name}", arrays)
                for f in dataclasses.fields(obj)
            },
        }
    raise TypeError(f"cannot serialize {type(obj).__name__} at {prefix!r}")


def _unflatten(spec, arrays):
    if isinstance(spec, dict):
        if "__array__" in spec:
            return arrays[spec["__array__"]]
        if "__tuple__" in spec:
            return tuple(_unflatten(x, arrays) for x in spec["__tuple__"])
        name = spec["__class__"]
        if name not in _CLASSES:
            raise ValueError(f"dataset cache holds a {name}, which the port "
                             "does not build")
        cls = _CLASSES[name]
        own = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(spec["fields"]) - own)
        if unknown:
            raise ValueError(f"dataset cache holds a {name} with fields "
                             f"{unknown} the port does not know")
        return cls(**{k: _unflatten(v, arrays)
                      for k, v in spec["fields"].items()})
    return spec


# A concurrent save may still be mid-write to its own uniquely-named arrays
# file when another save's cleanup pass runs; only unlink files at least this
# stale so cleanup never races an in-flight writer.
_CLEANUP_AGE_S = 600.0


def save_dataset(dataset: Dataset, path: str, build_key: dict | None = None) -> None:
    """Write ``dataset`` under directory ``path`` (created if missing).

    Crash- and concurrency-safe: arrays go to a uniquely-named file first and
    ``meta.json`` — the single commit point, written by atomic rename — is
    what pairs a skeleton with its arrays file.  A crash mid-save leaves the
    previous cache fully intact; two concurrent saves each publish a
    self-consistent (meta, arrays) pair and the last rename wins.

    ``build_key`` (any JSON-serializable dict — e.g. data path + layout
    flags) is stored verbatim; ``load_dataset`` can require it to match so a
    cache built under different flags is never silently reused.
    """
    os.makedirs(path, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    skeleton = _flatten(dataset, "ds", arrays)
    arrays_name = f"arrays-{uuid.uuid4().hex}.npz"
    tmp = os.path.join(path, f".{arrays_name}.tmp")
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, os.path.join(path, arrays_name))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    meta = {
        "format_version": _FORMAT_VERSION,
        "skeleton": skeleton,
        "arrays": arrays_name,
        "build_key": build_key,
    }
    fd, tmp = tempfile.mkstemp(dir=path, prefix=".meta.json.")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(path, "meta.json"))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _cleanup_stale(path, keep=arrays_name)


def _cleanup_stale(path: str, keep: str) -> None:
    """Remove files orphaned by earlier saves: superseded arrays files and
    temp files left by hard-crashed writers (SIGKILL during np.savez never
    runs the except-cleanup — at full-Netflix scale each such .tmp is
    multi-GB).  Never touches the live pair or anything recent enough to be
    a concurrent save in flight."""
    now = time.time()
    # Protect whatever arrays file the current meta.json references, not
    # just ``keep``: a loader that stalled past the age guard would
    # otherwise unlink the pair a concurrent rebuild published meanwhile.
    live = {keep, "meta.json"}
    try:
        with open(os.path.join(path, "meta.json")) as f:
            live.add(json.load(f).get("arrays", "arrays.npz"))
    except (OSError, ValueError):
        pass
    for name in os.listdir(path):
        if name in live:
            continue
        orphan = (
            (name.startswith("arrays") or name.startswith(".arrays"))
            and (name.endswith(".npz") or name.endswith(".npz.tmp"))
        ) or name.startswith(".meta.json.")
        if not orphan:
            continue
        full = os.path.join(path, name)
        try:
            if now - os.path.getmtime(full) > _CLEANUP_AGE_S:
                os.unlink(full)
        except OSError:
            pass


def read_build_key(path: str) -> dict | None:
    """The build key stored with the cache at ``path`` (None if the cache
    predates build keys or none was given).  Lets callers make their own
    freshness decision when parts of the key cannot be recomputed — e.g. a
    broker-offset fingerprint while the broker is unreachable."""
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f).get("build_key")


def load_dataset(path: str, expect_build_key: dict | None = None) -> Dataset:
    """Load a dataset previously written by ``save_dataset``.

    With ``expect_build_key``, the stored build key must equal it exactly —
    a cache written from different data or layout flags (or one predating
    build keys) raises instead of silently training on the wrong blocks.
    """
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format_version") not in _READABLE_VERSIONS:
        raise ValueError(
            f"dataset cache at {path!r} has format_version "
            f"{meta.get('format_version')!r}; this build reads "
            f"{_READABLE_VERSIONS}"
        )
    if expect_build_key is not None and meta.get("build_key") != expect_build_key:
        raise ValueError(
            f"dataset cache at {path!r} was built with "
            f"{meta.get('build_key')!r}, which does not match the requested "
            f"{expect_build_key!r}; rebuild (or delete the cache dir)"
        )
    if meta.get("format_version") < 3 and "TiledBlocks" in json.dumps(
        meta["skeleton"]
    ):
        raise ValueError(
            f"dataset cache at {path!r} holds format-"
            f"{meta.get('format_version')} tiled blocks, whose padding "
            "entries index row 0 instead of the appended zero row; this "
            "build would compute garbage from them — delete the cache dir "
            "and rebuild"
        )
    arrays_file = meta.get("arrays", "arrays.npz")
    with np.load(os.path.join(path, arrays_file)) as z:
        arrays = {k: z[k] for k in z.files}
    ds = _unflatten(meta["skeleton"], arrays)
    # Sweep superseded files here too: the common steady state is hit-only
    # (save never runs again), which would otherwise retain a multi-GB
    # arrays file orphaned by the last rebuild forever.
    _cleanup_stale(path, keep=arrays_file)
    return ds


def cached_scale_dataset(
    *,
    users: int,
    movies: int,
    nnz: int,
    seed: int = 0,
    layout: str = "tiled",
    chunk_elems: int = 1 << 19,
    tile_rows: int = 128,
    slice_rows: int | None = None,
    accum_chunk_elems: int | None = None,
    dense_stream: bool = False,
    cache_root: str,
    log=print,
) -> Dataset:
    """Build-or-load a synthetic Netflix-shaped dataset, disk-cached under
    ``cache_root`` (one directory per key, tagged as the JAX package tags
    it, so a cache root it filled also hits here).

    At full-corpus shapes the host-side block build costs minutes while
    being fully deterministic for the key below.
    """
    from cfk_tpu_torch.data.blocks import TILED_SLICE_ROWS_DEFAULT
    from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo

    if slice_rows is None:
        slice_rows = TILED_SLICE_ROWS_DEFAULT
    key = {
        "users": users, "movies": movies, "nnz": nnz,
        "seed": seed, "layout": layout,
        "chunk_elems": chunk_elems,
    }
    if layout == "tiled":
        key["tile_rows"] = tile_rows
        if slice_rows != TILED_SLICE_ROWS_DEFAULT:
            key["slice_rows"] = slice_rows
        if accum_chunk_elems is not None:
            key["accum_chunk_elems"] = accum_chunk_elems
        if dense_stream:
            key["dense"] = 1
    tag = "_".join(f"{k}{v}" for k, v in key.items())
    path = os.path.join(cache_root, tag)
    if os.path.exists(path):
        t0 = time.time()
        try:
            ds = Dataset.load(path, expect_build_key=key)
        except (FileNotFoundError, ValueError, TypeError):
            pass  # torn/mismatched/stale-format cache: rebuild below
        else:
            log(f"# dataset cache hit ({time.time()-t0:.1f}s load)",
                flush=True)
            return ds
    t0 = time.time()
    coo = synthetic_netflix_coo(users, movies, nnz, seed=seed)
    if layout == "tiled":
        from cfk_tpu_torch.data.blocks import (
            build_tiled_blocks,
            index_entities,
        )

        movie_map, m_dense = index_entities(coo.movie_raw)
        user_map, u_dense = index_entities(coo.user_raw)
        mb = build_tiled_blocks(
            m_dense, u_dense, coo.rating,
            movie_map.num_entities, user_map.num_entities,
            tile_rows=tile_rows,
            chunk_elems=(chunk_elems if accum_chunk_elems is None
                         else accum_chunk_elems),
            slice_rows=slice_rows,
        )
        ub = build_tiled_blocks(
            u_dense, m_dense, coo.rating,
            user_map.num_entities, movie_map.num_entities,
            tile_rows=tile_rows, chunk_elems=chunk_elems,
            slice_rows=slice_rows, dense_stream=dense_stream,
        )
        ds = Dataset(
            movie_map=movie_map, user_map=user_map,
            movie_blocks=mb, user_blocks=ub,
            coo_dense=RatingsCOO(
                movie_raw=m_dense.astype(np.int64),
                user_raw=u_dense.astype(np.int64),
                rating=coo.rating.astype(np.float32),
            ),
        )
    else:
        ds = Dataset.from_coo(coo, layout=layout, chunk_elems=chunk_elems)
    log(f"# dataset built in {time.time()-t0:.1f}s", flush=True)
    os.makedirs(cache_root, exist_ok=True)
    ds.save(path, build_key=key)
    return ds
