"""Host-side data of the port (cfk_tpu_torch.data) against cfk_tpu's.

The port keeps its own copy of the parsers, generators and block builders;
the same ratings must give bit-identical arrays in both packages.
"""

import numpy as np
import pytest

from cfk_tpu.data import blocks as jblocks
from cfk_tpu.data import synthetic as jsyn
from cfk_tpu.data.netflix import parse_netflix_python as j_parse
from cfk_tpu_torch.data import blocks as tblocks
from cfk_tpu_torch.data import synthetic as tsyn
from cfk_tpu_torch.data.netflix import parse_netflix_python as t_parse

TILED_FIELDS = (
    "neighbor_idx", "rating", "weight", "tile_seg", "chunk_base",
    "chunk_entity", "chunk_count", "carry_in", "last_seg", "slice_starts",
    "count", "rating_sum", "tile_meta", "rating_dense",
)
SCALARS = ("mode", "num_entities", "num_chunks", "chunk_cap",
           "chunk_entities", "tile_rows", "slice_rows", "num_slices",
           "num_tiles", "num_groups", "block_rows")


def _assert_same(jb, tb, fields):
    for f in fields:
        a, b = getattr(jb, f), getattr(tb, f)
        if a is None:
            assert b is None, f
            continue
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(scope="module")
def coo():
    return jsyn.synthetic_netflix_coo(600, 150, 9000, seed=5)


def test_synthetic_generators_identical():
    a = jsyn.synthetic_netflix_coo(500, 90, 4000, seed=7)
    b = tsyn.synthetic_netflix_coo(500, 90, 4000, seed=7)
    for f in ("movie_raw", "user_raw", "rating"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    ja, jh = jsyn.planted_factor_coo(300, 80, 3000, rank=4, heldout=200,
                                     seed=3)
    ta, th = tsyn.planted_factor_coo(300, 80, 3000, rank=4, heldout=200,
                                     seed=3)
    for x, y in ((ja, ta), (jh, th)):
        for f in ("movie_raw", "user_raw", "rating"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


@pytest.mark.parametrize("raw", [
    np.array([5, 3, 3, 9, 0, 5], np.int64),  # dense presence-table path
    np.array([10**12, 7, 10**12, 3], np.int64),  # sparse huge ids: sort path
])
def test_index_entities_identical(raw):
    jm, jd = jblocks.index_entities(raw)
    tm, td = tblocks.index_entities(raw)
    np.testing.assert_array_equal(jm.raw_ids, tm.raw_ids)
    np.testing.assert_array_equal(jd, td)
    assert td.dtype == np.int32


def test_netflix_parser_identical(tmp_path):
    path = tmp_path / "ratings.txt"
    path.write_text("3:\n7,4,2005-01-01\n2,1,2005-01-02\n\n1:\n7,5,2004-03-03\n"
                    "9:\n")
    a, b = j_parse(str(path)), t_parse(str(path))
    for f in ("movie_raw", "user_raw", "rating"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    path.write_text("1,4,2005-01-01\n")
    with pytest.raises(ValueError, match="before any 'movieId:' header"):
        t_parse(str(path))


def test_padded_dataset_identical(coo):
    jd = jblocks.Dataset.from_coo(coo)
    td = tblocks.Dataset.from_coo(coo)
    np.testing.assert_array_equal(jd.movie_map.raw_ids, td.movie_map.raw_ids)
    np.testing.assert_array_equal(jd.user_map.raw_ids, td.user_map.raw_ids)
    for side in ("movie_blocks", "user_blocks"):
        _assert_same(getattr(jd, side), getattr(td, side),
                     ("neighbor_idx", "rating", "mask", "count"))
    for f in ("movie_raw", "user_raw", "rating"):
        np.testing.assert_array_equal(getattr(jd.coo_dense, f),
                                      getattr(td.coo_dense, f))


@pytest.mark.parametrize("kw", [
    dict(chunk_elems=512, accum_max_entities=200, tile_rows=16),
    dict(chunk_elems=4096, accum_max_entities=200, tile_rows=32),
    dict(chunk_elems=1 << 20, accum_max_entities=1 << 16, tile_rows=128),
])
def test_tiled_dataset_identical(coo, kw):
    jd = jblocks.Dataset.from_coo(coo, layout="tiled", dense_stream=True,
                                  **kw)
    td = tblocks.Dataset.from_coo(coo, layout="tiled", dense_stream=True,
                                  **kw)
    for side in ("movie_blocks", "user_blocks"):
        jb, tb = getattr(jd, side), getattr(td, side)
        _assert_same(jb, tb, TILED_FIELDS)
        for f in SCALARS:
            assert getattr(jb, f) == getattr(tb, f), f
        assert jb.statics == tb.statics


@pytest.mark.parametrize("slice_rows,chunk_elems", [(128, 2048), (200, 512)])
def test_sliced_accum_blocks_identical(coo, slice_rows, chunk_elems):
    d = jblocks.Dataset.from_coo(coo).coo_dense
    args = (d.movie_raw, d.user_raw, d.rating, 150, 600)
    jb = jblocks.build_tiled_blocks(*args, slice_rows=slice_rows,
                                    chunk_elems=chunk_elems, tile_rows=16)
    tb = tblocks.build_tiled_blocks(*args, slice_rows=slice_rows,
                                    chunk_elems=chunk_elems, tile_rows=16)
    assert tb.mode == "accum" and tb.num_slices > 1
    _assert_same(jb, tb, TILED_FIELDS)
    assert jb.statics == tb.statics


SEGMENT_FIELDS = ("neighbor_idx", "rating", "mask", "seg_rel",
                  "chunk_entity", "chunk_count", "group_sizes", "carry_in",
                  "last_seg", "chunk_first", "count", "rating_sum")


def test_padded_stream_mode_not_ported(coo):
    # The padded stream mode was refused here until it was ported; the same
    # call now builds it, identical to the JAX package's.  So does the
    # segment layout, refused here until it was ported too: the port sizes
    # its chunks for the segment-sum Gram (chunk_elems // 64 ratings), so
    # it is held to the JAX package's builder at that chunk_nnz.
    jd = jblocks.Dataset.from_coo(coo, layout="tiled", dense_stream=False,
                                  accum_max_entities=200)
    td = tblocks.Dataset.from_coo(coo, layout="tiled", dense_stream=False,
                                  accum_max_entities=200)
    assert td.user_blocks.mode == "stream"
    _assert_same(jd.user_blocks, td.user_blocks, TILED_FIELDS)
    assert jd.user_blocks.statics == td.user_blocks.statics
    sd = tblocks.Dataset.from_coo(coo, layout="segment", chunk_elems=64 * 256)
    d = jd.coo_dense
    nm, nu = jd.movie_map.num_entities, jd.user_map.num_entities
    for tb, args in ((sd.movie_blocks, (d.movie_raw, d.user_raw, d.rating,
                                        nm)),
                     (sd.user_blocks, (d.user_raw, d.movie_raw, d.rating,
                                       nu))):
        jb = jblocks.build_segment_blocks(*args, chunk_nnz=256)
        _assert_same(jb, tb, SEGMENT_FIELDS)
        assert jb.statics == tb.statics and tb.num_chunks > 1
    assert sd.movie_blocks.carry_in.sum() > 0
