"""The port's rank groups and sharded block builds against cfk_tpu, on the CPU.

The sharded builders (padded, bucketed, segment, tiled accum / stream /
dense stream, ring-built tiled halves and ``build_ring_blocks``) must give
arrays bit-identical to the JAX package's at S = 2 and 4; ``shard_view``
must cut each rank's rows as the JAX package's ``P("shard")`` row sharding
does.  The mesh helpers follow ``tests/test_mesh.py:25-82``; the rank
processes (``make_mesh``, the torchrun-style launch harness) run gloo on the
CPU with one PyTorch thread each.
"""

import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cfk_tpu.data import blocks as jblocks
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu.parallel import mesh as jmesh
from cfk_tpu_torch.data import blocks as tblocks
from cfk_tpu_torch.parallel import mesh as tmesh
from cfk_tpu_torch.parallel.launch import (
    communicate_all,
    free_port,
    spawn_workers,
)
from cfk_tpu_torch.parallel.spmd import shard_view, tree_specs

ROOT = __file__.rsplit("/tests/", 1)[0]


def _same_tree(a, b, path="ds"):
    """A JAX-package tree ``a`` and a port tree ``b``: the same fields,
    arrays bit-equal with equal dtypes, scalars equal."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, tuple):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}.{i}")
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        fa = {f.name for f in dataclasses.fields(a)}
        assert fa == {f.name for f in dataclasses.fields(b)}, path
        for name in sorted(fa):
            _same_tree(getattr(a, name), getattr(b, name), f"{path}.{name}")
    else:
        assert a == b, (path, a, b)


@pytest.fixture(scope="module")
def coo():
    return synthetic_netflix_coo(300, 90, 5000, seed=11)


TILED = dict(layout="tiled", chunk_elems=512, tile_rows=16)
BUILDS = {
    "padded": dict(layout="padded"),
    "bucketed": dict(layout="bucketed", chunk_elems=256),
    "tiled_accum": dict(TILED, accum_max_entities=1 << 16),
    "tiled_stream": dict(TILED, accum_max_entities=20),
    "tiled_dense": dict(TILED, accum_max_entities=20, dense_stream=True),
    "tiled_ring": dict(TILED, ring=True, ring_warn=False),
    "tiled_auto": dict(TILED, ring="auto", rank_hint=4,
                       accum_max_entities=60, dense_stream=True),
    "tiled_mixed": dict(TILED, ring=(True, False), ring_warn=False,
                        accum_max_entities=60, dense_stream=True),
}


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", sorted(BUILDS))
def test_sharded_dataset_bit_identical(coo, name, shards):
    kw = BUILDS[name]
    _same_tree(jblocks.Dataset.from_coo(coo, num_shards=shards, **kw),
               tblocks.Dataset.from_coo(coo, num_shards=shards, **kw))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("chunk_nnz", [None, 300])
def test_sharded_segment_blocks_bit_identical(coo, shards, chunk_nnz):
    ds = tblocks.Dataset.from_coo(coo)
    d = ds.coo_dense
    args = (d.user_raw, d.movie_raw, d.rating, ds.user_map.num_entities)
    kw = dict(num_shards=shards, chunk_nnz=chunk_nnz)
    _same_tree(jblocks.build_segment_blocks(*args, **kw),
               tblocks.build_segment_blocks(*args, **kw))


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_ring_blocks_bit_identical(coo, shards):
    ds = tblocks.Dataset.from_coo(coo)
    d = ds.coo_dense
    nm, nu = ds.movie_map.num_entities, ds.user_map.num_entities
    for args in ((d.movie_raw, d.user_raw, d.rating, nm, nu),
                 (d.user_raw, d.movie_raw, d.rating, nu, nm)):
        _same_tree(jblocks.build_ring_blocks(*args, num_shards=shards),
                   tblocks.build_ring_blocks(*args, num_shards=shards))


def test_tiled_ring_refuses_an_oversized_accumulator(coo):
    for pkg in (jblocks, tblocks):
        with pytest.raises(ValueError, match="accum_max_entities"):
            pkg.Dataset.from_coo(coo, num_shards=2, layout="tiled",
                                 ring=True, accum_max_entities=10)


@pytest.mark.parametrize("name", ["tiled_dense", "tiled_ring", "bucketed",
                                  "padded"])
def test_shard_view_is_the_reference_row_sharding(coo, name):
    """Each rank's view equals its shard of the JAX package's ``P("shard")``
    placement of the same arrays on the virtual CPU devices."""
    s = 4
    kw = BUILDS[name]
    tds = tblocks.Dataset.from_coo(coo, num_shards=s, **kw)
    jds = jblocks.Dataset.from_coo(coo, num_shards=s, **kw)
    mesh = jmesh.make_mesh(s)
    for tb, jb in ((tds.movie_blocks, jds.movie_blocks),
                   (tds.user_blocks, jds.user_blocks)):
        if isinstance(jb, jblocks.BucketedBlocks):
            leaves = {f"b{i}.{f}": getattr(b, f) for i, b in
                      enumerate(jb.buckets) for f in
                      ("neighbor_idx", "rating", "mask", "entity_local")}
        else:
            leaves = {f.name: getattr(jb, f.name)
                      for f in dataclasses.fields(jb)
                      if isinstance(getattr(jb, f.name), np.ndarray)
                      and getattr(jb, f.name).size}
        placed = jmesh.shard_rows(mesh, leaves)
        for r in range(s):
            view = shard_view(tb, r, s)
            for key, arr in placed.items():
                shard = next(x for x in arr.addressable_shards
                             if x.device == mesh.devices[r])
                if key.startswith("b"):
                    i, f = key[1:].split(".")
                    got = getattr(view.buckets[int(i)], f)
                else:
                    got = getattr(view, key)
                np.testing.assert_array_equal(np.asarray(shard.data), got,
                                              err_msg=f"{name} r{r} {key}")
            assert getattr(view, "num_shards", 1) == 1


@dataclasses.dataclass
class FakeRank:
    process_index: int
    id: int


def test_ring_order_groups_hosts_contiguously():
    ranks = [FakeRank(1, 5), FakeRank(0, 2), FakeRank(1, 4), FakeRank(0, 0),
             FakeRank(2, 9), FakeRank(0, 1)]
    got = [(d.process_index, d.id) for d in tmesh.ring_order(ranks)]
    want = [(d.process_index, d.id) for d in jmesh.ring_order(ranks)]
    assert got == want == [(0, 0), (0, 1), (0, 2), (1, 4), (1, 5), (2, 9)]


def test_shard_rows_global_equals_shard_rows():
    tree = {"a": np.arange(64, dtype=np.float32).reshape(16, 4),
            "b": np.arange(16, dtype=np.int32)}
    mesh = jmesh.make_mesh(8)
    ref = jmesh.shard_rows(mesh, tree)
    for r in range(8):
        g = tmesh.ShardGroup(rank=r, size=8, device="cpu")
        via_put = tmesh.shard_rows(g, tree)
        via_cb = tmesh.shard_rows_global(g, tree)
        for k in tree:
            torch.testing.assert_close(via_put[k], via_cb[k], rtol=0, atol=0)
            shard = next(x for x in ref[k].addressable_shards
                         if x.device == mesh.devices[r])
            np.testing.assert_array_equal(np.asarray(shard.data),
                                          via_put[k].numpy())
    assert tree_specs(tree) == {"a": ("shard", None), "b": ("shard",)}
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.shard_rows(tmesh.ShardGroup(rank=0, size=3, device="cpu"),
                         tree)


def test_multihost_mesh_single_process_and_mismatch():
    g = tmesh.make_multihost_mesh(device="cpu")
    assert (g.rank, g.size, g.AXIS) == (0, 1, jmesh.AXIS)
    x = torch.arange(6.0).reshape(3, 2)
    assert g.all_gather(x) is x and torch.equal(g.all_reduce(x), x)
    assert g.agree_or(5) == 5 and g.any(True) and not g.any(False)
    with pytest.raises(ValueError, match="process count"):
        tmesh.make_multihost_mesh(3)


def test_initialize_distributed_single_process_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.initialize_distributed() == 1
    assert jmesh.initialize_distributed() == 1


def test_init_timeout_message_matches_reference():
    args = ("127.0.0.1:1234", 3, 1, 6.0)
    assert tmesh._init_timeout_message(*args) == \
        jmesh._init_timeout_message(*args)
    assert tmesh.INIT_TIMEOUT_EXIT_CODE == jmesh.INIT_TIMEOUT_EXIT_CODE


def test_lone_rank_exits_with_the_actionable_timeout():
    """One process of a declared pair: the bounded init names the missing
    peer and exits ``INIT_TIMEOUT_EXIT_CODE`` instead of hanging."""
    procs = spawn_workers(free_port(), 2, None, "--drill", "init-timeout",
                          "--init-timeout", "3", "--device", "cpu", pids=[0])
    out = communicate_all(procs, timeout=120)[0]
    assert procs[0].returncode == tmesh.INIT_TIMEOUT_EXIT_CODE, out
    assert "missing peer(s) are among process ids [1]" in out


def test_torchrun_style_processes_rendezvous_and_agree():
    procs = spawn_workers(free_port(), 2, None, "--drill", "agree",
                          "--device", "cpu")
    outs = communicate_all(procs, timeout=120)
    assert [p.returncode for p in procs] == [0, 0], outs
    for r, out in enumerate(outs):
        assert (f"DRILL_AGREE rank={r} size=2 backend=gloo ids=[0, 1]"
                in out), out


@pytest.mark.parametrize("count,size,want", [
    (0, 2, None), (1, 2, ("cuda:0", "gloo", True)),
    (2, 2, ("cuda:1", "nccl", False)), (4, 2, ("cuda:1", "nccl", False)),
    (3, 4, ("cuda:1", "gloo", True))])
def test_placement_and_backend_follow_the_topology(monkeypatch, count, size,
                                                   want):
    """nccl when every rank has its own card, gloo staged through host
    memory when ranks share one (round-robin), an error without a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    if want is None:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.placement(1, size, "cuda")
        return
    assert tmesh.placement(1, size, "cuda") == want
    assert tmesh.placement(1, size, "cpu") == ("cpu", "gloo", False)
    assert ("staged through pinned host memory" in tmesh.describe(size,
                                                                  "cuda")) \
        == want[2]


def test_make_mesh_collectives_and_a_failing_rank():
    """Two spawned ranks: the collectives agree across ranks; a rank's
    exception raises here with its traceback and closes the mesh."""
    with tmesh.make_mesh(2, "cpu") as mesh:
        assert mesh.backend == "gloo" and not mesh.staged
        assert mesh.run(getattr, "rank") == [0, 1]
        assert mesh.run(tmesh.to_host, per_rank=[
            (torch.full((2, 3), 1.0),), (torch.full((2, 3), 2.0),)])[1] \
            .tolist() == [[1.0] * 3] * 2 + [[2.0] * 3] * 2
        with pytest.raises(tmesh.RankError, match="no_such_attr"):
            mesh.run(getattr, per_rank=[("rank",), ("no_such_attr",)])
        assert mesh.closed


def test_import_of_the_mesh_modules_pulls_in_no_jax():
    code = ("import sys, cfk_tpu_torch.parallel.mesh, "
            "cfk_tpu_torch.parallel.spmd, cfk_tpu_torch.parallel.launch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'cfk_tpu')]\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert jax.__name__ == "jax"
