"""Host ingest of the port (cfk_tpu_torch) against cfk_tpu, on the CPU.

The port's host library (``csrc/host/cfk_native.cpp``, built by
``_build.py`` with the host C++ compiler) against its own plain versions
(the pure-Python parsers, numpy's stable argsort, the numpy presence table)
and the JAX package's: parsers, ``group_by``, ``index_dense`` and every
layout's blocks are bit-identical either way.  Also the rebuild of a stale
or ABI-mismatched library, the dataset cache (both packages write the same
format) and the counter-based generator.
"""

import dataclasses
import os
import subprocess

import numpy as np
import pytest

from cfk_tpu.data import blocks as jblocks
from cfk_tpu.data import cache as jcache
from cfk_tpu.data import synth as jsynth
from cfk_tpu.data.movielens import parse_movielens_csv as j_parse_ml
from cfk_tpu.data.movielens import parse_movielens_csv_python as j_parse_ml_py
from cfk_tpu.data.netflix import parse_netflix as j_parse_nf
from cfk_tpu.data.netflix import parse_netflix_python as j_parse_nf_py
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu_torch import _build
from cfk_tpu_torch.cli import main
from cfk_tpu_torch.data import _native
from cfk_tpu_torch.data import blocks as tblocks
from cfk_tpu_torch.data import cache as tcache
from cfk_tpu_torch.data import synth as tsynth
from cfk_tpu_torch.data.movielens import (
    parse_movielens_csv,
    parse_movielens_csv_python,
)
from cfk_tpu_torch.data.netflix import parse_netflix, parse_netflix_python

COO_FIELDS = ("movie_raw", "user_raw", "rating")
I64_MAX = 2**63 - 1


def _same_coo(a, b):
    for f in COO_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _same_tree(a, b, path="ds"):
    """Two dataclass trees (one from each package, or two builds) with equal
    fields: arrays bit-equal with equal dtypes, scalars equal."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, tuple):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}.{i}")
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(b):
            _same_tree(getattr(a, f.name), getattr(b, f.name),
                       f"{path}.{f.name}")
    else:
        assert a == b, (path, a, b)


def _line_of(err: ValueError) -> int:
    """The line number of a parser's ``path:lineno: ...`` message."""
    return int(str(err).split(":")[1])


NETFLIX = {
    "ok": "3:\n7,4,2005-01-01\n2,1,2005-01-02\n\n1:\r\n7,5,2004-03-03\n"
          " 9:\n\t12,3,2005-01-01,extra\n",
    "ids near int64 max": f"{I64_MAX}:\n{I64_MAX - 8},5,2005-01-01\n"
                          f"{I64_MAX},1,2005-01-01\n",
    "rating row before any header": "1,4,2005-01-01\n2:\n",
    "id above int64": f"1:\n{I64_MAX + 1},4,2005-01-01\n",
    "no date": "1:\n5,4\n",
    "signed user": "1:\n-3,5,2005-01-01\n",
    "header with text": "1:\n2,3,2005-01-01\n1,5,2005:\n",
    "non-numeric rating": "1:\n2,3,2005-01-01\n\n4,x,2005-01-01\n",
}
MOVIELENS = {
    "ok": "userId,movieId,rating,timestamp\n1,10,4.0,100\n1,20,2.5,101\n"
          "\n2,10,5.0,102\n3,7,.5,1\n4,7,3.125,9\n5,8,0.001,1\n6,9,4.75\n",
    "no header, ids near int64 max": f"{I64_MAX},{I64_MAX - 1},3.5,0\n"
                                     "1,2,1.0,0\n",
    "id above int64": f"1,2,3.0,0\n{I64_MAX + 1},2,3.0,0\n",
    "signed rating": "userId,movieId,rating,timestamp\n1,2,-3.0,0\n",
    "scientific rating": "userId,movieId,rating,timestamp\n1,2,3e1,0\n",
    "trailing garbage": "1,2,3.0,0\n1,2,3.5abc,0\n",
    "non-numeric id": "userId,movieId,rating,timestamp\n1,xx,4.0,100\n",
}


@pytest.mark.parametrize("case", list(NETFLIX))
def test_netflix_parsers_identical(tmp_path, case):
    """The port's native parser, its Python parser and the JAX package's
    parsers agree: the same arrays, or a ValueError at the same line.  The
    JAX package's native parser rejects the top eight int64 ids (its
    overflow guard stops at 922337203685477579·10 + 9), which its Python
    parser accepts; the port's native parser accepts them, as both Python
    parsers do, so that case is held to the Python parsers only."""
    path = tmp_path / "ratings.txt"
    path.write_text(NETFLIX[case])
    assert _native.available()
    parsers = [_native.parse_netflix, parse_netflix, parse_netflix_python,
               j_parse_nf_py]
    if case != "ids near int64 max":
        parsers.append(j_parse_nf)
    if case in ("ok", "ids near int64 max"):
        out = [p(str(path)) for p in parsers]
        for o in out[1:]:
            _same_coo(out[0], o)
        assert out[0].num_ratings == (4 if case == "ok" else 2)
        return
    lines = set()
    for p in parsers:
        with pytest.raises(ValueError, match=f"^{path}:") as e:
            p(str(path))
        lines.add(_line_of(e.value))
    assert len(lines) == 1


@pytest.mark.parametrize("case", list(MOVIELENS))
@pytest.mark.parametrize("min_rating", [0.0, 3.0])
def test_movielens_parsers_identical(tmp_path, case, min_rating):
    path = tmp_path / "ratings.csv"
    path.write_text(MOVIELENS[case])
    parsers = [lambda p: _native.parse_movielens(p, min_rating),
               lambda p: parse_movielens_csv(p, min_rating=min_rating),
               lambda p: parse_movielens_csv_python(p, min_rating=min_rating),
               lambda p: j_parse_ml_py(p, min_rating=min_rating)]
    if "int64 max" not in case:
        parsers.append(lambda p: j_parse_ml(p, min_rating=min_rating))
    if case == "ok" or "int64 max" in case:
        out = [p(str(path)) for p in parsers]
        for o in out[1:]:
            _same_coo(out[0], o)
        assert out[0].num_ratings > 0
        return
    lines = set()
    for p in parsers:
        with pytest.raises(ValueError, match=f"^{path}:") as e:
            p(str(path))
        lines.add(_line_of(e.value))
    assert len(lines) == 1


def test_parse_io_errors(tmp_path):
    for fn in (_native.parse_netflix, _native.parse_movielens):
        with pytest.raises(OSError, match="cannot read"):
            fn(str(tmp_path / "missing.txt"))
        with pytest.raises(OSError, match="cannot read"):
            fn(str(tmp_path))  # a directory
    (tmp_path / "empty.txt").write_text("")
    assert parse_netflix(str(tmp_path / "empty.txt")).num_ratings == 0


KEYS = {
    "random": (np.random.default_rng(0).integers(0, 997, 50_000), 997),
    "empty": (np.zeros(0, np.int64), 5),
    "one key": (np.array([3]), 4),
    "all equal": (np.full(1000, 7), 8),
    "keys without occurrences": (np.array([1, 1, 5, 3, 1, 5]), 20),
}


@pytest.mark.parametrize("case", list(KEYS))
def test_group_by_identical(case):
    keys, num_keys = KEYS[case]
    keys = keys.astype(np.int64)
    native = _native.group_by(keys, num_keys)
    plain = tblocks.group_by_dense_numpy(keys, num_keys)
    routed = tblocks.group_by_dense(keys, num_keys)
    ref = jblocks.group_by_dense(keys, num_keys)
    for got in (plain, routed, ref):
        for x, y in zip(native, got):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="outside"):
        _native.group_by(np.array([0, num_keys], np.int64), num_keys)


RAW = {
    "random": np.random.default_rng(1).integers(1, 50_000, 20_000),
    "one id": np.array([5]),
    "all equal": np.full(100, 42),
    "zero and gaps": np.array([0, 9, 9, 3, 0, 100]),
    "sparse huge ids (sort path)": np.array([10**12, 7, 10**12, 3]),
    "negative ids (sort path)": np.array([-4, 2, -4, 9]),
    "empty": np.zeros(0, np.int64),
}


@pytest.mark.parametrize("case", list(RAW))
def test_index_dense_identical(case):
    raw = RAW[case].astype(np.int64)
    tm, td = tblocks.index_entities(raw)
    pm, pd = tblocks.index_entities_numpy(raw)
    jm, jd = jblocks.index_entities(raw)
    for m, d in ((pm, pd), (jm, jd)):
        np.testing.assert_array_equal(tm.raw_ids, m.raw_ids)
        np.testing.assert_array_equal(td, d)
        assert m.raw_ids.dtype == tm.raw_ids.dtype
        assert d.dtype == td.dtype == np.int32
    if raw.size and raw.min() >= 0 and raw.max() < 1 << 20:
        unique, dense = _native.index_dense(raw)
        np.testing.assert_array_equal(unique, tm.raw_ids)
        np.testing.assert_array_equal(dense, td)


def test_stale_or_mismatched_library_is_rebuilt(tmp_path, monkeypatch):
    """A file under the library's name that does not load, or reports
    another ABI version, is rebuilt and replaced — never used."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    path = _build.host_library_path()
    assert path.parent == tmp_path
    path.write_bytes(b"not a shared library")
    lib = _native.load_library()
    assert lib.cfk_native_abi_version() == _native.ABI_VERSION
    good = path.read_bytes()
    assert good.startswith(b"\x7fELF")
    other = tmp_path / "other_abi.cpp"
    other.write_text('extern "C" int cfk_native_abi_version() '
                     '{ return 99; }\n')
    subprocess.run([_build.host_compiler(), "-shared", "-fPIC", "-o",
                    str(path), str(other)], check=True)
    lib = _native.load_library()
    assert lib.cfk_native_abi_version() == _native.ABI_VERSION
    assert path.read_bytes() == good
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [path.name, other.name])  # no temporary file left behind


@pytest.fixture(scope="module")
def coo():
    return synthetic_netflix_coo(500, 120, 8000, seed=3)


LAYOUTS = {
    "padded": {},
    "bucketed": dict(chunk_elems=512),
    "tiled": dict(chunk_elems=512, accum_max_entities=100, tile_rows=16,
                  dense_stream=True),
    "segment": dict(chunk_elems=64 * 300),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_native_route_blocks_identical_to_plain_route(coo, layout,
                                                      monkeypatch):
    kw = dict(layout=layout, **LAYOUTS[layout])
    native = tblocks.Dataset.from_coo(coo, **kw)
    monkeypatch.setattr(_native, "available", lambda: False)
    plain = tblocks.Dataset.from_coo(coo, **kw)
    _same_tree(native, plain)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cache_round_trip_and_reference_cache(coo, tmp_path, layout):
    """The port's cache round-trips every layout; a cache the JAX package
    wrote for the same build loads into the port and equals the port's own
    build; a different build key is refused."""
    kw = dict(layout=layout, **LAYOUTS[layout])
    ds = tblocks.Dataset.from_coo(coo, **kw)
    key = {"layout": layout, "n": 1}
    ds.save(str(tmp_path / "port"), build_key=key)
    _same_tree(tblocks.Dataset.load(str(tmp_path / "port"),
                                    expect_build_key=key), ds)
    assert tcache.read_build_key(str(tmp_path / "port")) == key
    with pytest.raises(ValueError, match="does not match"):
        tblocks.Dataset.load(str(tmp_path / "port"),
                             expect_build_key={**key, "n": 2})
    jkw = dict(kw)
    if layout == "segment":  # the JAX package's own chunk rule differs
        jkw["chunk_elems"] = kw["chunk_elems"] // 64
    jds = jblocks.Dataset.from_coo(coo, **jkw)
    jcache.save_dataset(jds, str(tmp_path / "jax"), build_key=key)
    _same_tree(tcache.load_dataset(str(tmp_path / "jax"),
                                   expect_build_key=key), ds)


def test_cache_refuses_sharded_reference_blocks(coo, tmp_path):
    jds = jblocks.Dataset.from_coo(coo, layout="tiled", num_shards=2,
                                   chunk_elems=512, tile_rows=16)
    jcache.save_dataset(jds, str(tmp_path))
    with pytest.raises(ValueError, match="num_shards=2"):
        tcache.load_dataset(str(tmp_path))


def test_cli_dataset_cache_rebuilds_on_a_changed_key(coo, tmp_path, capsys):
    data = tmp_path / "ratings.txt"
    with open(data, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            f.writelines(f"{u},{int(r)},2005-01-01\n"
                         for u, r in zip(coo.user_raw[sel], coo.rating[sel]))
    cache = str(tmp_path / "cache")
    base = ["train", "--data", str(data), "--rank", "4", "--iterations", "1",
            "--device", "cpu", "--output", "none", "--dataset-cache", cache]
    for argv, hit in ((base, False), (base, True),
                      (base + ["--pad-multiple", "16"], False),
                      (base + ["--pad-multiple", "16"], True)):
        assert main(argv) == 0
        err = capsys.readouterr().err
        assert ("# dataset cache hit" in err) == hit, (argv, err)
        assert ("ignoring dataset cache" in err) == (argv is not base
                                                     and not hit), err
    assert tcache.read_build_key(cache)["pad_multiple"] == 16
    os.remove(data)  # the source gone: a cache matching all else serves
    assert main(base + ["--pad-multiple", "16"]) == 0
    assert "not found; using dataset cache" in capsys.readouterr().err


def test_power_law_synth_identical():
    spec = dict(num_users=3000, num_movies=500, nnz=40_000, seed=7)
    t = tsynth.PowerLawSynth(tsynth.SynthSpec(**spec))
    j = jsynth.PowerLawSynth(jsynth.SynthSpec(**spec))
    assert t.crc32() == j.crc32() == t.crc32(chunk_elems=999)
    _same_coo(t.coo(100, 5000), j.coo(100, 5000))
    _same_coo(tsynth.synth_coo(200, 50, 1000, seed=2),
              jsynth.synth_coo(200, 50, 1000, seed=2))
    assert t.spec.shard_range(3, 4) == j.spec.shard_range(3, 4)
