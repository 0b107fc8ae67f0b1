"""ServeEngine: live factors + seen lists behind K4 ``topk_scores``.

The port of ``cfk_tpu/serving/engine.py`` on one device — everything between
"a batch of user rows" and "[B, K] ids + scores":

- the item table, padded to the tile grid, quantized per ``table_dtype``
  (``ops.quant``) and held on the device (it is read by every batch);
- the user side on the host: a base snapshot plus a HOT-ROW overlay of rows
  re-solved by commits (``on_commit``), and the seen-list CSR plus a seen
  overlay, so a just-rated movie drops out of that user's next answer;
- pow2 batch bucketing: a batch pads to a power of two (padding rows score a
  zero vector and are sliced off), as the JAX engine does to bound its
  compiled programs; here it bounds the distinct (B, W, K) launch shapes,
  which ``trace_count`` counts in place of jit traces;
- two-stage retrieval (``serve_mode="two_stage"``): a k-means index
  (``serving.cluster``) rebuilt on every table swap, a centroid probe, and
  an exact K4 rescore of the probed clusters' rows (``serving.twostage``).
  A corrupt index or a staleness overrun degrades the engine to the exact
  scan — the same table through the same kernel — counts
  ``two_stage_fallbacks``, and re-arms at the next table swap.

Every swap of device state is one reference assignment under the engine
lock, so a batch in flight keeps the table it captured.  Item-table deltas
copy before they write (``apply_movie_deltas``) for the same reason.
"""

from __future__ import annotations

import threading
import time
import uuid

import numpy as np
import torch

from cfk_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from cfk_tpu_torch.ops.quant import quantize_table, resolve_table_dtype
from cfk_tpu_torch.serving.topk_kernel import (
    _pow2_ceil,
    build_seen_tiles,
    topk_scores,
)
from cfk_tpu_torch.telemetry import dump_flight, record_event, span

# The smallest pow2 batch bucket, the k-means seed of the two-stage index,
# and the share of in-place-updated index rows past which two-stage degrades
# to the exact scan — the JAX engine's defaults (a planner may set them there;
# the port has no planner yet).
_BATCH_QUANTUM = 8
_CLUSTER_SEED = 0
_MAX_STALE_FRACTION = 0.25

# Distinct launch shapes served this process — the counterpart of the JAX
# engine's jit-trace counter, so ``prewarm`` can report what it covered.
_SHAPES: set = set()


def trace_count() -> int:
    """Distinct (mode, B, table rows, W, K) shapes served this process."""
    return len(_SHAPES)


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


def pad_table(table: np.ndarray, tile_m: int, shards: int = 1) -> np.ndarray:
    """Zero-pad item rows to a multiple of ``shards × tile_m`` (the padding
    rows are masked by the kernel's global ``num_movies`` bound)."""
    quantum = tile_m * max(shards, 1)
    m_pad = -(-table.shape[0] // quantum) * quantum
    if m_pad == table.shape[0]:
        return table
    out = np.zeros((m_pad, table.shape[1]), table.dtype)
    out[: table.shape[0]] = table
    return out


class ServeEngine:
    """Score top-K requests against live factors on one device.

    ``seen_movies``/``seen_indptr`` (per-user-row CSR of rated movie rows,
    ascending per user) enables exclude-seen; None serves without it.
    """

    def __init__(
        self,
        user_factors,  # [U, k] numpy or torch (a host snapshot is taken)
        movie_factors,  # [M0, k]
        *,
        num_users: int,
        num_movies: int,
        seen_movies=None,
        seen_indptr=None,
        table_dtype: str | None = None,
        tile_m: int = 512,
        serve_mode: str | None = None,
        clusters: int | None = None,
        probe_clusters: int | None = None,
        metrics=None,
        device: str | torch.device = DEFAULT_DEVICE,
        mesh=None,
    ) -> None:
        self.device = resolve_device(device)
        # Item-axis sharding (``cfk_tpu/serving/engine.py:448-455``): with a
        # ``Mesh`` or ``ShardGroup`` the exact scan runs
        # ``parallel.spmd.serve_topk_sharded`` over the ranks.  A ``Mesh``'s
        # ranks hold their table slices between batches (placed at every
        # table change), so a batch ships only its users and seen tiles.
        self.mesh = mesh
        self._placed = None
        self._table_name = f"engine-{uuid.uuid4().hex}"
        self._table_version = 0
        self._shards = 1 if mesh is None else int(mesh.size)
        self.serve_mode = serve_mode or "exact"
        if self.serve_mode not in ("exact", "two_stage"):
            raise ValueError(
                f"serve_mode must be 'exact' or 'two_stage', "
                f"got {self.serve_mode!r}"
            )
        self.num_movies = int(num_movies)
        self.num_users = int(num_users)
        if self.serve_mode == "two_stage":
            from cfk_tpu_torch.serving.twostage import default_two_stage_params

            dc, dp = default_two_stage_params(self.num_movies)
            clusters = int(clusters or dc)
            probe_clusters = int(probe_clusters or dp)
        self.clusters = int(clusters or 0)
        self.probe_clusters = int(probe_clusters or 0)
        self.metrics = metrics
        self.table_dtype = resolve_table_dtype(table_dtype)
        self.tile_m = int(tile_m)
        self._lock = threading.RLock()
        # (ClusterIndex, cluster-major table, its scales, quantized
        # centroids, their scales): one tuple, swapped as one reference.
        self._cluster = None
        self._two_stage_disabled = False
        self.two_stage_fallbacks = 0
        self.last_fault: str | None = None
        self.last_scan: dict = {}
        self._u_base = _host_f32(user_factors)[:num_users]
        self._u_hot: dict[int, np.ndarray] = {}
        if (seen_movies is None) != (seen_indptr is None):
            raise ValueError("pass both of seen_movies/seen_indptr or neither")
        self._seen_movies = (None if seen_movies is None
                             else np.asarray(seen_movies, np.int32))
        self._seen_indptr = (None if seen_indptr is None
                             else np.asarray(seen_indptr, np.int64))
        self._seen_hot: dict[int, list[int]] = {}
        self._set_table(_host_f32(movie_factors)[:num_movies])
        self.invalidations = 0
        self.table_swaps = 0
        self.epoch = 0
        self.prewarmed = False

    @property
    def ready(self) -> bool:
        """Prewarmed and a table loaded."""
        return bool(self.prewarmed and getattr(self, "_table", None)
                    is not None)

    def load_state(self, user_factors, movie_factors=None, *, hot_rows=None,
                   seen_cells=None, num_users=None, epoch=None) -> None:
        """Atomically replace the user-side state (base snapshot, hot rows,
        seen overlay) and optionally the item table and epoch."""
        with self._lock:
            self._u_base = _host_f32(user_factors)
            self._u_hot = ({int(r): _host_f32(f) for r, f in hot_rows.items()}
                           if hot_rows else {})
            self._seen_hot = {}
            for row, movie in seen_cells or ():
                self._seen_hot.setdefault(int(row), []).append(int(movie))
            if num_users is not None:
                self.num_users = int(num_users)
            if movie_factors is not None:
                self._set_table(_host_f32(movie_factors)[: self.num_movies])
                self.table_swaps += 1
            if epoch is not None:
                self.epoch = int(epoch)

    # -- table ---------------------------------------------------------------

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _publish(self, data, scale) -> None:
        """The exact scan's table, and with a mesh its slices on the ranks
        (a new version: the ranks keep the one before for batches already
        under way)."""
        self._table = (data, scale)
        if self.mesh is not None:
            from cfk_tpu_torch.parallel.spmd import place_table_sharded

            self._table_version += 1
            self._placed = place_table_sharded(
                self.mesh, data, scale, tile_m=self.tile_m,
                name=self._table_name, version=self._table_version)

    def _set_table(self, movie_factors_host: np.ndarray) -> None:
        padded = pad_table(movie_factors_host.astype(np.float32), self.tile_m,
                           self._shards)
        self._publish(*quantize_table(self._to_device(padded),
                                      self.table_dtype))
        if self.serve_mode == "two_stage":
            from cfk_tpu_torch.serving.cluster import build_cluster_index

            host = movie_factors_host
            index = build_cluster_index(
                host, min(self.clusters, max(host.shape[0], 1)),
                seed=_CLUSTER_SEED,
            )
            cpad = pad_table(host[index.perm], self.tile_m)
            cdata, cscale = quantize_table(self._to_device(cpad),
                                           self.table_dtype)
            qc, qcs = quantize_table(self._to_device(index.centroids),
                                     self.table_dtype)
            self._cluster = (index, cdata, cscale, qc, qcs)
            self._two_stage_disabled = False  # a fresh index is healthy

    @property
    def table_rows(self) -> int:
        return int(self._table[0].shape[0])

    # -- live updates --------------------------------------------------------

    def attach_session(self, session) -> None:
        """Subscribe to a ``StreamSession``'s commits: fold-in rows refresh
        the hot-row overlay, rated cells extend the seen overlay, retrains
        swap the whole table.  Fired AFTER each durable commit, so a
        request served after the commit returns reflects it."""
        session.add_commit_listener(self.on_commit)

    def on_commit(self, event: dict) -> None:
        """Apply one commit event: ``rows``/``touched_rows`` refresh the
        hot-row overlay, ``cells`` extend the seen overlay, ``movie_rows``/
        ``movie_row_factors`` update item rows in place, and ``retrain``
        swaps both sides (``user_factors``, ``movie_factors``)."""
        with self._lock:
            rows = event.get("rows")
            touched = event.get("touched_rows") or ()
            if rows is not None:
                for i, row in enumerate(touched):
                    self._u_hot[int(row)] = np.array(rows[i], np.float32)
                self.invalidations += len(touched)
            for row, movie in event.get("cells") or ():
                self._seen_hot.setdefault(int(row), []).append(int(movie))
            self.num_users = max(self.num_users,
                                 int(event.get("num_users", self.num_users)))
            mrows = event.get("movie_rows")
            if mrows is not None and not event.get("retrain"):
                self.apply_movie_deltas(mrows, event["movie_row_factors"])
            if event.get("retrain"):
                self._u_base = _host_f32(event["user_factors"])[: self.num_users]
                self._u_hot.clear()
                self._set_table(
                    _host_f32(event["movie_factors"])[: self.num_movies])
                self.table_swaps += 1
                self.epoch += 1

    def apply_movie_deltas(self, rows, factors) -> int:
        """Update item rows in both table views; the cluster-major view
        updates at each row's existing position (counted as stale, no
        re-clustering).  Quantization is per row, so a delta row's codes
        equal a full requantization's.  Returns the rows applied."""
        rows = np.asarray(rows, np.int64)
        f = _host_f32(factors)
        keep = (rows >= 0) & (rows < self.num_movies)
        rows, f = rows[keep], f[keep]
        if rows.size == 0:
            return 0
        qd, qs = quantize_table(self._to_device(f), self.table_dtype)
        with self._lock:
            data, scale = self._table
            idx = self._to_device(rows)
            data = data.clone()
            data[idx] = qd
            if scale is not None:
                scale = scale.clone()
                scale[idx] = qs
            self._publish(data, scale)
            if self._cluster is not None:
                index, ctable, cscale, qc, qcs = self._cluster
                pos = self._to_device(index.positions_of(rows))
                ctable = ctable.clone()
                ctable[pos] = qd
                if cscale is not None:
                    cscale = cscale.clone()
                    cscale[pos] = qs
                index.note_stale(rows.size)
                self._cluster = (index, ctable, cscale, qc, qcs)
                if self.metrics is not None:
                    self.metrics.gauge("serve/index_stale_rows",
                                       index.stale_rows)
        return int(rows.size)

    # -- request path --------------------------------------------------------

    def _gather_users(self, user_rows: np.ndarray) -> np.ndarray:
        u = np.zeros((user_rows.shape[0], self._u_base.shape[1]), np.float32)
        base_n = self._u_base.shape[0]
        for i, row in enumerate(user_rows):
            hot = self._u_hot.get(int(row))
            if hot is not None:
                u[i] = hot
            elif row < base_n:
                u[i] = self._u_base[row]
            # else: a user with no factors yet scores a zero row
        return u

    def _batch_seen(self, user_rows: np.ndarray):
        """Per-batch CSR = base slice ⊕ seen overlay, sorted per user."""
        if self._seen_movies is None and not self._seen_hot:
            return None
        per_user = []
        base_n = (0 if self._seen_indptr is None
                  else self._seen_indptr.shape[0] - 1)
        for row in user_rows:
            row = int(row)
            if self._seen_movies is not None and row < base_n:
                base = self._seen_movies[
                    self._seen_indptr[row]: self._seen_indptr[row + 1]]
            else:
                base = np.zeros(0, np.int32)
            extra = self._seen_hot.get(row)
            if extra:
                base = np.unique(np.concatenate(
                    [base, np.asarray(extra, np.int32)]))
            per_user.append(base)
        indptr = np.zeros(len(per_user) + 1, np.int64)
        indptr[1:] = np.cumsum([a.size for a in per_user])
        movies = (np.concatenate(per_user) if indptr[-1]
                  else np.zeros(0, np.int32))
        return movies, indptr

    def topk(self, user_rows, k: int, *, exclude_seen: bool = True,
             force_exact: bool = False):
        """(scores [n, k] f32, movie rows [n, k] int32) as numpy arrays.

        ``force_exact`` skips the two-stage path for this batch (same
        table, same masks, same kernel): the oracle recall is measured
        against."""
        user_rows = np.asarray(user_rows, dtype=np.int64)
        n = user_rows.shape[0]
        if n == 0:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int32))
        bad = (user_rows < 0) | (user_rows >= self.num_users)
        if np.any(bad):
            raise ValueError(
                f"user rows out of range [0, {self.num_users}): "
                f"{user_rows[bad][:5]}"
            )
        if not 1 <= k <= self.num_movies:
            raise ValueError(f"k must be in [1, {self.num_movies}], got {k}")
        b = _pow2_ceil(n, _BATCH_QUANTUM)
        with span("serve/batch/assemble", n=n, b=b):
            with self._lock:
                table, scale = self._table
                placed = self._placed
                cluster = self._cluster
                u = np.zeros((b, self._u_base.shape[1]), np.float32)
                u[:n] = self._gather_users(user_rows)
                seen = self._batch_seen(user_rows) if exclude_seen else None
            seen_pad = None
            if seen is not None:
                movies, indptr = seen
                # padding slots carry EMPTY seen lists, so they do not
                # widen W
                seen_pad = (movies, np.concatenate(
                    [indptr, np.full(b - n, indptr[-1], np.int64)]))
            u_dev = self._to_device(u)
        if (self.serve_mode == "two_stage" and not force_exact
                and not self._two_stage_disabled):
            out = self._topk_two_stage(cluster, u_dev, n, b, k, seen_pad)
            if out is not None:
                return out
            # a detected fault: the exact scan below is the fallback
        seen_tiles = None
        if seen_pad is not None:
            seen_tiles = self._to_device(build_seen_tiles(
                seen_pad[0], seen_pad[1], np.arange(b),
                num_movies=self.num_movies, tile_m=self.tile_m,
                num_tiles=self.table_rows // self.tile_m,
            ))
        with span("serve/batch/compute", n=n, b=b, k=k):
            if self.mesh is not None:
                from cfk_tpu_torch.parallel.spmd import serve_topk_sharded

                vals, ids = serve_topk_sharded(
                    self.mesh, u_dev, placed or table, scale, seen_tiles,
                    k_top=k, num_movies=self.num_movies, tile_m=self.tile_m)
            else:
                vals, ids = topk_scores(u_dev, table, scale, seen_tiles,
                                        k_top=k, num_movies=self.num_movies,
                                        tile_m=self.tile_m)
            _SHAPES.add(("exact", b, table.shape[0],
                         0 if seen_tiles is None else seen_tiles.shape[2], k))
            vals, ids = vals[:n].cpu().numpy(), ids[:n].cpu().numpy()
        self._record_scan(mode="exact", b=b, k=k)
        return vals, ids

    def _topk_two_stage(self, cluster, u_dev, n, b, k, seen_pad):
        """Centroid probe → batch-union shortlist → exact K4 rescore.
        Returns (vals, ids) sliced to n, or None after recording a fault."""
        from cfk_tpu_torch.serving.twostage import (
            build_shortlist,
            coarse,
            map_shortlist_ids,
            rescore,
            shortlist_seen_tiles,
        )

        if cluster is None:
            self._two_stage_fault("cluster index missing")
            return None
        index, ctable, cscale, qc, qcs = cluster
        reason = index.quick_check()
        if reason is not None:
            self._two_stage_fault(reason)
            return None
        if index.stale_fraction > _MAX_STALE_FRACTION:
            self._two_stage_fault(
                f"index staleness {index.stale_fraction:.3f} over the "
                f"{_MAX_STALE_FRACTION} bound (awaiting table swap)")
            return None
        probe = min(max(self.probe_clusters, 1), index.num_clusters)
        with span("serve/candidate", n=n, b=b, probe=probe):
            cvals, cids = coarse(u_dev, qc, qcs, probe=probe)
            if not bool(torch.isfinite(cvals[:n]).all()):
                self._two_stage_fault("non-finite coarse scores")
                return None
            # the union over the REAL rows only: padding rows would vote
            # junk
            shortlist = build_shortlist(index,
                                        cids[:n].cpu().numpy().ravel(),
                                        tile_m=self.tile_m, min_rows=k)
            seen_tiles = None
            if seen_pad is not None:
                seen_tiles = self._to_device(shortlist_seen_tiles(
                    index, shortlist, seen_pad[0], seen_pad[1], b,
                    tile_m=self.tile_m))
        with span("serve/rescore", n=n, b=b, k=k, rows=shortlist.rows,
                  rows_padded=shortlist.rows_padded):
            indices = self._to_device(shortlist.indices.astype(np.int64))
            vals, ids = rescore(u_dev, indices, ctable, cscale, seen_tiles,
                                shortlist.offset, k_top=k,
                                tile_m=self.tile_m)
            _SHAPES.add(("two_stage", b, shortlist.rows_padded,
                         0 if seen_tiles is None else seen_tiles.shape[2],
                         k))
            vals = vals[:n].cpu().numpy()
            ids = map_shortlist_ids(ids[:n].cpu().numpy(), shortlist)
        self._record_scan(mode="two_stage", b=b, k=k, shortlist=shortlist,
                          probe=probe, index=index)
        return vals, ids

    def _two_stage_fault(self, reason: str) -> None:
        """Degrade to the exact scan until the next table swap; the fault is
        recorded (flight-recorder event and dump, the fallback counter)."""
        self._two_stage_disabled = True
        self.two_stage_fallbacks += 1
        self.last_fault = reason
        record_event("serve", "two_stage_fault", reason=reason,
                     fallbacks=self.two_stage_fallbacks)
        dump_flight(f"two_stage_fallback: {reason}")
        if self.metrics is not None:
            self.metrics.incr("serve/two_stage_fallbacks")

    def _record_scan(self, *, mode, b, k, shortlist=None, probe=0,
                     index=None) -> None:
        """``last_scan``: the executed mode's modeled bytes per batch
        (``utils.roofline.serve_batch_cost``, over the real shortlist for
        two_stage)."""
        from cfk_tpu_torch.utils.roofline import serve_batch_cost

        rank = int(self._u_base.shape[1])
        if mode == "two_stage":
            cost = serve_batch_cost(
                self.num_movies, rank, b, k, table_dtype=self.table_dtype,
                serve_mode="two_stage", clusters=index.num_clusters,
                probe_clusters=probe, shortlist_rows=shortlist.rows_padded)
            self.last_scan = {
                "serve_mode": "two_stage",
                "clusters": index.num_clusters,
                "probe_clusters": probe,
                "shortlist_rows": shortlist.rows,
                "shortlist_rows_padded": shortlist.rows_padded,
                "index_stale_rows": index.stale_rows,
                "bytes_scanned_per_batch": round(cost.hbm_bytes),
            }
        else:
            cost = serve_batch_cost(self.num_movies, rank, b, k,
                                    table_dtype=self.table_dtype,
                                    m_pad=self.table_rows)
            self.last_scan = {"serve_mode": "exact",
                              "bytes_scanned_per_batch": round(cost.hbm_bytes)}
        if self.metrics is not None:
            self.metrics.gauge("serve/bytes_scanned_per_batch",
                               self.last_scan["bytes_scanned_per_batch"])

    @property
    def trace_count(self) -> int:
        return trace_count()

    def prewarm(self, k: int, *, max_batch: int | None = None,
                user_rows=None, exclude_seen: bool = True) -> dict:
        """Serve one batch at each pow2 size ``q, 2q, … pow2(max_batch)``
        (``user_rows`` when given — a workload sample — else the first
        users), so the kernels are built and the device warm before real
        traffic; flips ``ready``.  Returns ``{"programs", "new_traces",
        "prewarm_s"}`` (new_traces: launch shapes not served before)."""
        with span("serve/prewarm", k=k, max_batch=max_batch):
            return self._prewarm(k, max_batch, user_rows, exclude_seen)

    def _prewarm(self, k, max_batch, user_rows, exclude_seen) -> dict:
        t0 = time.time()
        top = _pow2_ceil(max(max_batch or _BATCH_QUANTUM, 1), _BATCH_QUANTUM)
        rows = (np.arange(min(top, self.num_users), dtype=np.int64)
                if user_rows is None else np.asarray(user_rows, np.int64))
        if rows.size == 0:
            return {"programs": 0, "new_traces": 0, "prewarm_s": 0.0}
        before = trace_count()
        programs = 0
        b = _BATCH_QUANTUM
        while b <= top:
            take = rows[: min(b, rows.size)]
            if take.size < b:
                take = np.resize(take, b)
            self.topk(take, k, exclude_seen=exclude_seen)
            programs += 1
            if self.serve_mode == "two_stage" and rows.size > b:
                alt = rows[b:2 * b]
                if alt.size < b:
                    alt = np.resize(alt, b)
                self.topk(alt, k, exclude_seen=exclude_seen)
            b *= 2
        self.prewarmed = True
        return {"programs": programs, "new_traces": trace_count() - before,
                "prewarm_s": round(time.time() - t0, 4)}


def seen_csr(dataset) -> tuple[np.ndarray, np.ndarray]:
    """(seen movie rows, indptr) per user row of a ``Dataset`` or
    ``RatingsIndex``, movie rows ascending within each user."""
    coo = dataset.coo_dense
    order = np.argsort(
        coo.user_raw * (dataset.movie_map.num_entities + 1) + coo.movie_raw,
        kind="stable",
    )
    counts = np.bincount(coo.user_raw.astype(np.int64),
                         minlength=dataset.user_map.num_entities)
    indptr = np.zeros(dataset.user_map.num_entities + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return coo.movie_raw[order].astype(np.int32), indptr


def engine_from_model(model, dataset=None, *, table_dtype=None, tile_m=512,
                      serve_mode=None, clusters=None, probe_clusters=None,
                      metrics=None, device=None) -> ServeEngine:
    """An engine over an ``ALSModel`` (+ an optional ``Dataset`` /
    ``RatingsIndex`` whose ratings are excluded), on ``device`` — by default
    the device the model's factors lie on."""
    seen_movies = seen_indptr = None
    if dataset is not None:
        seen_movies, seen_indptr = seen_csr(dataset)
    return ServeEngine(
        model.user_factors, model.movie_factors,
        num_users=model.num_users, num_movies=model.num_movies,
        seen_movies=seen_movies, seen_indptr=seen_indptr,
        table_dtype=table_dtype, tile_m=tile_m, serve_mode=serve_mode, clusters=clusters,
        probe_clusters=probe_clusters, metrics=metrics,
        device=model.user_factors.device if device is None else device,
    )
