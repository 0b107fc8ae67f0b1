"""K4's plan and selection schedule on the CPU.

The CUDA kernel cannot run here, so this file holds what it decides on the
host — the pass-1 plan (``split_plan`` and the row partition the kernel
derives from it, ``split_bounds``) — and a numpy
emulation of its selection schedule on the plain version's scores: per
split, each 256-row tile's survivors of a user's running K-th best
(padding, ``num_movies`` and seen rows out) are bitonic-sorted and merged
into the user's sorted top-pow2(K) list (the larger of each list's i-th and
the other's (n-1-i)-th, then one bitonic merge; lists of up to 128 keys as
128 wide, the registers' width), which sets the next threshold; then pass
2's merge of every split's list by 16 warps and a tree.  The bitonic
networks use the kernel's index arithmetic.  The emulation must equal
``topk_scores_plain`` exactly, ties and −1 tails included.
"""

import numpy as np
import pytest
import torch

from cfk_tpu_torch.serving import topk_kernel as tk

from _torch_topk import split_bounds

TILE, MERGE_WARPS, REG_LIST = 256, 16, 128
NEG_INF_KEY = np.uint64((0x007FFFFF << 32) | 0xFFFFFFFF)


def keys_of(scores: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """The kernel's 64-bit key: order-preserving score bits (−0 folded
    into +0) over 0x7FFFFFFF − id, so a larger key is (score desc, id
    asc)."""
    b = (scores.astype(np.float32) + np.float32(0)).view(np.uint32).astype(
        np.uint64)
    b ^= np.where(b & 0x80000000, 0xFFFFFFFF, 0x80000000).astype(np.uint64)
    lo = (np.uint64(0x7FFFFFFF) - ids.astype(np.int64).astype(np.uint64)
          ) & np.uint64(0xFFFFFFFF)
    return (b << np.uint64(32)) | lo


def split_keys(keys: np.ndarray):
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    hi ^= np.where(hi & 0x80000000, 0x80000000, 0xFFFFFFFF).astype(np.uint32)
    vals = hi.view(np.float32).copy()
    ids = (np.uint32(0x7FFFFFFF) - (keys & np.uint64(0xFFFFFFFF)).astype(
        np.uint32)).astype(np.int32)
    empty = keys == 0
    vals[empty], ids[empty] = -np.inf, -1
    return vals, ids


def _pairs(n: int, stride: int):
    p = np.arange(n // 2)
    i = 2 * p - (p & (stride - 1))
    return i, i + stride


def bitonic_sort_desc(a: np.ndarray) -> None:
    n = a.shape[0]
    size = 2
    while size <= n:
        stride = size // 2
        while stride > 0:
            i, j = _pairs(n, stride)
            x, y = a[i].copy(), a[j].copy()
            swap = np.where((i & size) == 0, x < y, x > y)
            a[i], a[j] = np.where(swap, y, x), np.where(swap, x, y)
            stride //= 2
        size *= 2


def bitonic_merge_desc(a: np.ndarray) -> None:
    stride = a.shape[0] // 2
    while stride > 0:
        i, j = _pairs(a.shape[0], stride)
        x, y = a[i].copy(), a[j].copy()
        swap = x < y
        a[i], a[j] = np.where(swap, y, x), np.where(swap, x, y)
        stride //= 2


def merge_into(lst: np.ndarray, c: np.ndarray) -> None:
    """lst (kp, sorted desc) becomes the best kp of lst and c (sorted
    desc), sorted: max(lst[i], c[kp-1-i]) is bitonic, one merge sorts it."""
    kp = lst.shape[0]
    j = kp - 1 - np.arange(kp)
    ok = j < c.shape[0]
    lst[ok] = np.maximum(lst[ok], c[j[ok]])
    bitonic_merge_desc(lst)


def merge_list(lst, sorted_keys):
    """The best len(lst) of lst and sorted_keys, as the kernel merges them:
    lists of up to 128 keys 128 wide (in registers), longer ones as they
    are (in shared memory)."""
    n = lst.shape[0]
    wide = np.zeros(max(n, REG_LIST), np.uint64)
    wide[:n] = lst
    merge_into(wide, sorted_keys[:wide.shape[0]])
    lst[:] = wide[:n]


def merge_tile(lst, surv, k_top, stats):
    """One tile's survivors into the user's list; the new threshold."""
    n = 32
    while n < len(surv):
        n *= 2
    c = np.zeros(n, np.uint64)
    c[:len(surv)] = surv
    bitonic_sort_desc(c)
    merge_list(lst, c)
    if stats is not None:
        stats["merges"] += 1
    return max(lst[k_top - 1], NEG_INF_KEY)


def emulate(scores, live, row_offset, k_top, b, m_pad, num_sms, stats=None):
    """The kernel's schedule on [B, M_pad] scores with their live mask
    (padding, num_movies and seen rows False): (vals, ids) [B, K]."""
    bu, splits = tk.split_plan(b, m_pad, k_top, num_sms)
    kp = tk._pow2_ceil(k_top)
    part = np.zeros((b, splits, k_top), np.uint64)
    gid = row_offset + np.arange(m_pad)
    for s, (lo, hi) in enumerate(split_bounds(splits, m_pad)):
        for user in range(b):  # the user's warp, over the split's tiles
            lst, thr = np.zeros(kp, np.uint64), NEG_INF_KEY
            for r0 in range(lo, hi, TILE):
                rows = np.arange(r0, min(r0 + TILE, m_pad))
                key = keys_of(scores[user, rows], gid[rows])
                surv = key[live[user, rows] & (key > thr)]
                if stats is not None:
                    stats["survivors"] += surv.size
                if surv.size:
                    thr = merge_tile(lst, surv, k_top, stats)
            part[user, s] = lst[:k_top]
    vals = np.empty((b, k_top), np.float32)
    ids = np.empty((b, k_top), np.int32)
    for user in range(b):  # pass 2: one CTA of 16 warps
        acc = np.zeros((MERGE_WARPS, max(kp, REG_LIST)), np.uint64)
        for s in range(splits):
            merge_into(acc[s % MERGE_WARPS], part[user, s])
        half = MERGE_WARPS // 2
        while half > 0:
            for w in range(half):
                merge_into(acc[w], acc[w + half])
            half //= 2
        vals[user], ids[user] = split_keys(acc[0, :k_top])
    return vals, ids


def plain_scores(u, table, scale, seen_tiles, *, num_movies, tile_m,
                 row_offset=0):
    """The plain version's [B, M_pad] scores and live mask."""
    m_pad = table.shape[0]
    sc = torch.cat([tk._score_block(
        u, table[lo:lo + tile_m],
        None if scale is None else scale[lo:lo + tile_m])
        for lo in range(0, m_pad, tile_m)], dim=1).numpy()
    live = np.broadcast_to(row_offset + np.arange(m_pad) < num_movies,
                           sc.shape).copy()
    if seen_tiles is not None:
        st = seen_tiles.numpy()
        for t in range(st.shape[0]):
            bb, ww = np.nonzero(st[t] < tile_m)
            live[bb, t * tile_m + st[t][bb, ww]] = False
    return sc, live


def _problem(seed, b, m, k, tile, seen_max, integer, table_dtype):
    from cfk_tpu_torch.ops.quant import quantize_table

    rng = np.random.default_rng(seed)
    if integer:
        u = rng.integers(-3, 4, (b, k)).astype(np.float32)
        mf = rng.integers(-3, 4, (m, k)).astype(np.float32)
        mf[:, 0] = 127.0
    else:
        u = rng.standard_normal((b, k)).astype(np.float32)
        mf = rng.standard_normal((m, k)).astype(np.float32)
    m_pad = -(-m // tile) * tile
    tbl = np.zeros((m_pad, k), np.float32)
    tbl[:m] = mf
    seen = [np.sort(rng.choice(m, size=int(rng.integers(0, seen_max)),
                               replace=False)) for _ in range(b)]
    indptr = np.zeros(b + 1, np.int64)
    indptr[1:] = np.cumsum([s.size for s in seen])
    st = tk.build_seen_tiles(np.concatenate(seen).astype(np.int32), indptr,
                             np.arange(b), num_movies=m_pad, tile_m=tile)
    data, scale = quantize_table(torch.as_tensor(tbl), table_dtype)
    return torch.as_tensor(u), data, scale, torch.as_tensor(st)


@pytest.mark.parametrize("b,m_pad,k_top", [
    (16, 59392, 100), (64, 59392, 100), (256, 59392, 100), (1, 256, 1),
    (8, 64, 5), (300, 4096, 1024), (33, 32768, 257), (40, 1000, 30)])
@pytest.mark.parametrize("num_sms", [1, 3, 132])
def test_split_plan_covers_every_row_once(b, m_pad, k_top, num_sms):
    bu, splits = tk.split_plan(b, m_pad, k_top, num_sms)
    assert bu == (16 if b <= 32 or tk._pow2_ceil(k_top) > 512 else 32)
    bounds = split_bounds(splits, m_pad)
    assert len(bounds) == splits >= 1
    owner = np.zeros(m_pad, np.int64)
    for lo, hi in bounds:  # no split is empty, each holds whole tiles
        assert lo < hi and lo % TILE == 0 and (hi % TILE == 0 or hi == m_pad)
        owner[lo:hi] += 1
    assert (owner == 1).all()
    # pass 2's per-user merge stays within its limit, and a user's partial
    # (8-byte keys) within half its row of a [B, M_pad] f32 score matrix
    assert splits * tk._pow2_ceil(k_top) <= tk._MERGE_ENTRIES
    assert splits == 1 or splits * k_top * 8 <= m_pad * 4 // 2
    # one wave of two CTAs per SM at most
    assert -(-b // bu) * splits <= max(2 * num_sms, -(-b // bu))


def test_split_plan_fills_every_sm_at_small_batches():
    # the serving table (59,047 movies padded to tile_m 2048): B = 16 puts
    # one CTA or more on each of the H100's 132 SMs, as do B = 64 and 256
    for b in (16, 64, 256):
        bu, splits = tk.split_plan(b, 59392, 100, 132)
        assert -(-b // bu) * splits >= 132


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", ["random", "ties", "offset_tail", "short"])
def test_emulated_schedule_equals_plain(table_dtype, case):
    kw = dict(k_top=40, num_movies=1400, tile_m=256)
    if case == "ties":  # integer tables: exact sums, many equal scores
        args = _problem(3, 40, 1500, 16, 256, 30, True, table_dtype)
    elif case == "offset_tail":  # a two-stage shortlist's masked tail
        args = _problem(5, 20, 1000, 8, 128, 20, False, table_dtype)
        kw = dict(k_top=100, num_movies=1024, tile_m=128, row_offset=300)
    elif case == "short":  # fewer live rows than K: a −1 tail
        args = _problem(7, 17, 60, 5, 16, 12, False, table_dtype)
        kw = dict(k_top=70, num_movies=50, tile_m=16, row_offset=3)
    else:
        args = _problem(9, 40, 1500, 16, 256, 30, False, table_dtype)
    u, data, scale, st = args
    want_v, want_i = tk.topk_scores_plain(u, data, scale, st, **kw)
    sc, live = plain_scores(u, data, scale, st, num_movies=kw["num_movies"],
                            tile_m=kw["tile_m"],
                            row_offset=kw.get("row_offset", 0))
    for num_sms in (1, 4):  # one split per user block, and several
        vals, ids = emulate(sc, live, kw.get("row_offset", 0), kw["k_top"],
                            u.shape[0], data.shape[0], num_sms)
        np.testing.assert_array_equal(vals, want_v.numpy())
        np.testing.assert_array_equal(ids, want_i.numpy())


def test_keys_order_scores_then_ids():
    s = np.array([1.5, 1.5, -2.0, 0.0, -0.0, np.inf, 3.0], np.float32)
    i = np.array([7, 3, 0, 5, 4, 9, -6], np.int32)
    k = keys_of(s, i)
    want = sorted(range(len(s)), key=lambda n: (-s[n], i[n]))
    assert [int(x) for x in np.argsort(k)[::-1]] == want
    v, d = split_keys(k)
    np.testing.assert_array_equal(v, s)
    np.testing.assert_array_equal(d, i)
    assert (keys_of(np.array([-np.inf], np.float32), np.array([0]))
            <= NEG_INF_KEY).all()
