"""K4's large-K route (K above 1,024) on the CPU.

The CUDA kernels cannot run here, so this file holds a torch model of what
they do, with their index arithmetic, and holds it to
``topk_scores_plain`` exactly — values and ids, ties and −1 tails
included:

- the score pass's key: the score's bits made order-preserving (−0 folded
  into +0) over 0x7FFFFFFF − id, so a larger key is (score desc, id asc);
  0 for a padding, ``num_movies``, seen or −inf row;
- the select pass: an MSB-first radix select of a user's K-th key over
  8-bit digits (a histogram of the keys under the prefix found so far, a
  scan from the top digit), then the keys at or above it — every nonzero
  key when the K-th is 0 — compacted and zero-filled to pow2(K);
- the sort pass: the bitonic network over pow2(K) keys, chunks sorted
  first, longer strides over the whole buffer, then each chunk's shorter
  strides (``topk_sort_kernel``), with a small chunk here so that both
  kinds of stage run; then the decode.

Keys are int64 here, biased by −2⁶³ so that signed order is the kernel's
unsigned order.  One small case also holds ``topk_scores_plain`` to the
JAX reference's ``topk_scores_pallas`` (interpret mode) at K = 1,100.
"""

import numpy as np
import pytest
import torch

from cfk_tpu_torch.serving import topk_kernel as tk

BIAS = -(1 << 63)  # the biased key of unsigned key 0: an empty slot


def make_keys(scores, live, gid):
    """[B, M] biased keys of float32 scores with their live mask and ids."""
    bits = (scores + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits ^ 0x80000000)
    key = ((hi - (1 << 31)) << 32) | (0x7FFFFFFF - gid.to(torch.int64))
    return torch.where(live & (scores > float("-inf")), key,
                       torch.full_like(key, BIAS))


def decode(keys):
    """(vals f32, ids int32) of biased keys; an empty slot is (−inf, −1)."""
    hi = (keys >> 32) + (1 << 31)
    hi = torch.where(hi >= 0x80000000, hi ^ 0x80000000, hi ^ 0xFFFFFFFF)
    vals = torch.where(hi >= 0x80000000, hi - (1 << 32), hi).to(
        torch.int32).view(torch.float32)
    ids = (0x7FFFFFFF - (keys & 0xFFFFFFFF)).to(torch.int32)
    empty = keys == BIAS
    return (vals.masked_fill(empty, float("-inf")),
            ids.masked_fill(empty, -1))


def radix_select(keys, k_top):
    """The K-th largest of one user's keys (unsigned), digit by digit."""
    if k_top >= keys.numel():
        return 0
    u = keys ^ BIAS  # the unsigned key's bit pattern
    prefix = mask = 0
    remaining = k_top
    for shift in range(56, -1, -8):
        m64 = mask - (1 << 64) if mask >= 1 << 63 else mask
        p64 = prefix - (1 << 64) if prefix >= 1 << 63 else prefix
        under = (u & m64) == p64
        hist = torch.bincount(((u[under] >> shift) & 0xFF), minlength=256)
        above, d = 0, 255
        while d > 0 and above + int(hist[d]) < remaining:
            above += int(hist[d])
            d -= 1
        prefix |= d << shift
        remaining -= above
        mask |= 0xFF << shift
    return prefix


def select(keys, k_top, kp):
    """The select pass for one user: the compacted candidates, pow2(K)."""
    t = max(radix_select(keys, k_top), 1) + BIAS
    cand = keys[keys >= t]
    assert cand.numel() == min(k_top, int((keys != BIAS).sum()))
    return torch.cat([cand, torch.full((kp - cand.numel(),), BIAS,
                                       dtype=torch.int64)])


def sort_stage(a, base, size, stride):
    p = torch.arange(a.numel() // 2)
    i = 2 * p - (p & (stride - 1))
    j = i + stride
    x, y = a[i].clone(), a[j].clone()
    swap = torch.where(((base + i) & size) == 0, x < y, x > y)
    a[i], a[j] = torch.where(swap, y, x), torch.where(swap, x, y)


def kernel_sort(g, chunk):
    """topk_sort_kernel's schedule on one user's buffer, in place."""
    kp = g.numel()
    c = min(kp, chunk)
    for c0 in range(0, kp, c):
        size = 2
        while size <= c:
            s = size // 2
            while s > 0:
                sort_stage(g[c0:c0 + c], c0, size, s)
                s //= 2
            size *= 2
    size = 2 * c
    while size <= kp:
        s = size // 2
        while s >= c:
            sort_stage(g, 0, size, s)
            s //= 2
        for c0 in range(0, kp, c):
            s2 = s
            while s2 > 0:
                sort_stage(g[c0:c0 + c], c0, size, s2)
                s2 //= 2
        size *= 2


def plain_scores(u, table, scale, seen_tiles, *, num_movies, tile_m,
                 row_offset=0):
    """[B, M_pad] scores (the plain version's per-tile products), their
    live mask (padding, num_movies and seen rows False) and the ids."""
    m_pad = table.shape[0]
    sc = torch.cat([tk._score_block(
        u, table[lo:lo + tile_m],
        None if scale is None else scale[lo:lo + tile_m])
        for lo in range(0, m_pad, tile_m)], dim=1)
    gid = row_offset + torch.arange(m_pad)
    live = (gid < num_movies)[None, :].expand_as(sc).clone()
    if seen_tiles is not None:
        for t in range(seen_tiles.shape[0]):
            bb, ww = torch.nonzero(seen_tiles[t] < tile_m, as_tuple=True)
            live[bb, t * tile_m + seen_tiles[t][bb, ww].long()] = False
    return sc, live, gid


def model(u, table, scale, seen_tiles, *, k_top, num_movies, tile_m,
          row_offset=0, chunk=512):
    sc, live, gid = plain_scores(u, table, scale, seen_tiles,
                                 num_movies=num_movies, tile_m=tile_m,
                                 row_offset=row_offset)
    keys = make_keys(sc, live, gid)
    kp = tk._pow2_ceil(k_top)
    out = []
    for user in range(keys.shape[0]):
        g = select(keys[user], k_top, kp)
        kernel_sort(g, chunk)
        out.append(g[:k_top])
    return decode(torch.stack(out))


def _problem(seed, b, m, k, tile, seen_max, table_dtype, dup=0, zero=0):
    from cfk_tpu_torch.ops.quant import quantize_table

    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, k)).astype(np.float32)
    mf = rng.standard_normal((m, k)).astype(np.float32)
    if dup:  # duplicated rows: equal scores for every user, other ids
        mf[rng.choice(m, dup, replace=False)] = mf[rng.choice(m, dup)]
    if zero:  # zero rows: ±0.0 scores, tied
        mf[rng.choice(m, zero, replace=False)] = 0.0
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


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("with_seen", [False, True])
@pytest.mark.parametrize("k_top", [1025, 1500, 2048, "num_movies",
                                   "num_movies+37"])
def test_model_equals_plain(table_dtype, with_seen, k_top):
    u, data, scale, st = _problem(3, 4, 2900, 8, 256, 400, table_dtype,
                                  dup=300, zero=40)
    nm = 2890  # 10 rows of table above num_movies, then 172 of padding
    kt = {"num_movies": nm, "num_movies+37": nm + 37}.get(k_top, k_top)
    kw = dict(k_top=kt, num_movies=nm, tile_m=256)
    st = st if with_seen else None
    got = model(u, data, scale, st, **kw)
    want = tk.topk_scores_plain(u, data, scale, st, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_model_on_the_two_stage_shape():
    # the rescore's padded shortlist: row_offset masks its tail; the CPU
    # entry points answer K > 1,024 with the plain version
    u, data, scale, st = _problem(5, 4, 3000, 8, 256, 50, "float32", dup=100)
    kw = dict(k_top=1300, num_movies=3072, tile_m=256, row_offset=600)
    got = model(u, data, scale, st, **kw)
    want = tk.topk_scores_plain(u, data, scale, st, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for fn in (tk.topk_scores, tk.topk_scores_large_k):
        v, i = fn(u, data, scale, st, **kw)
        assert torch.equal(v, want[0]) and torch.equal(i, want[1])


def test_keys_fold_signed_zero_and_order():
    s = torch.tensor([[0.0, -0.0, 1.5, -2.0, float("-inf"), 1.5, -0.0]])
    gid = torch.arange(7)
    keys = make_keys(s, torch.ones_like(s, dtype=torch.bool), gid)
    # ±0 share the high word; the −inf row is empty
    assert int(keys[0, 0] >> 32) == int(keys[0, 1] >> 32)
    assert int(keys[0, 4]) == BIAS
    order = torch.sort(keys[0], descending=True).indices.tolist()
    assert order == [2, 5, 0, 1, 6, 3, 4]
    v, i = decode(keys[0][order])
    assert v.tolist()[:6] == [1.5, 1.5, 0.0, 0.0, 0.0, -2.0]
    assert i.tolist() == [2, 5, 0, 1, 6, 3, -1]


@pytest.mark.parametrize("kp,chunk", [(2048, 2048), (2048, 256),
                                      (4096, 512)])
def test_sort_schedule_sorts_any_keys(kp, chunk):
    g = torch.as_tensor(np.random.default_rng(kp + chunk).integers(
        -(1 << 62), 1 << 62, kp))
    want = torch.sort(g, descending=True).values
    kernel_sort(g, chunk)
    assert torch.equal(g, want)


def test_plain_equals_jax_reference_above_1024():
    import jax.numpy as jnp

    from cfk_tpu.serving.topk_kernel import topk_scores_pallas

    u, data, scale, st = _problem(7, 3, 1500, 8, 512, 200, "float32", dup=60)
    kw = dict(k_top=1100, num_movies=1490, tile_m=512)
    want = topk_scores_pallas(jnp.asarray(u.numpy()),
                              jnp.asarray(data.numpy()), None,
                              jnp.asarray(st.numpy()), **kw)
    got = tk.topk_scores_plain(u, data, scale, st, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
