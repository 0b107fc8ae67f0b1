"""Command-line interface of the port: ``python -m cfk_tpu_torch <verb>``.

- ``run`` — the reference's positional form (``apps/ALSAppRunner.java:16-28``):
  ``NUM_PARTITIONS NUM_FEATURES LAMBDA NUM_ITERATIONS PATH NUM_MOVIES
  NUM_USERS``.  Entity counts come from the data (the passed ones are
  cross-checked and warned about); NUM_PARTITIONS > 1 trains that many
  ranks (``parallel.spmd``; ranks may share one card, so there is no
  fall-back to one shard).
- ``train`` — full-flag training on a Netflix-format or MovieLens CSV file:
  explicit ALS-WR, or implicit iALS with ``--implicit`` (``--alpha``,
  leave-one-out Recall@K / MPR with ``--eval-ranking K``); the full solves
  or the subspace sweeps (``--algorithm als++`` / ``ials++``); layout
  (``auto`` = padded below 2M ratings, above it tiled — bucketed for a
  subspace optimizer — as ``cfk_tpu/cli.py:66-79``), rank, λ, iterations,
  seed, chunk budget, solver route, device and prediction-CSV output;
  ``--no-overlap`` pins the serial chunk schedule (``ALSConfig.overlap``);
  ``--profile-dir`` (a torch.profiler trace), ``--trace-dir`` (the host
  span trace), ``--metrics-jsonl`` (periodic registry snapshots) and
  ``--metrics`` (the exit row's format) are its telemetry;
  ``--checkpoint-dir`` checkpoints every ``--checkpoint-every`` iterations
  (``--keep-last-n``) and resumes, with a preemption guard armed unless
  ``--no-preempt-save``, and ``--health-check-every``,
  ``--health-norm-limit``, ``--max-recoveries``, ``--lam-escalation`` and
  ``--on-unrecoverable`` arm the sentinel and the recovery ladder;
  ``--checkpoint-journal DIR|URL --journal-partitions N`` journals the
  factors as FeatureRecord frames through a FileBroker directory or a
  ``tcp://`` broker instead (the reference's topics-as-checkpoint store;
  exclusive with ``--checkpoint-dir``); ``--data tcp://HOST:PORT/TOPIC``
  collects the ratings a ``produce`` wrote.
- ``evaluate`` — offline MSE/RMSE of a prediction CSV against a ratings file.
- ``recommend`` — top-K movies for given users from checkpointed factors
  (``--checkpoint-dir``: ``train --checkpoint-dir``, or the JAX package's
  checkpoint directory; or ``--checkpoint-journal``: a journal either
  package wrote).
- ``predict`` — the prediction CSV from checkpointed factors, no training.
- ``serve`` — the top-K request server: over an in-memory log driven by
  the built-in open-loop load generator (prints one JSON row: QPS, p50,
  p99), or with ``--broker tcp://HOST:PORT`` over the broker's serve
  topics until ^C; ``--replicas N`` serves through the replicated fleet
  (user-keyed routing, ``--admission-queue``, per-replica /metrics);
  ``--metrics-port`` serves ``GET /metrics`` (Prometheus text) while it
  runs, ``--trace-dir`` writes its host span trace.
- ``stream`` — exactly-once streaming fold-in: consume rating updates from
  a FileBroker directory or a ``tcp://`` broker (``--updates``), fold each
  micro-batch into the live factors on the card, commit factors + offset
  cursor atomically in ``--stream-dir``; re-running resumes.
  ``--produce-csv`` is the producer side.
- ``broker`` — the port's TCP log broker (``csrc/host/cfk_broker.cpp``,
  built on first use), memory-only or over ``--data-dir``; ``topics``
  (list/create/delete/recreate) and ``produce`` (a ratings file into a
  topic, for ``train --data tcp://HOST:PORT/TOPIC``) act on it.

Everything runs on CUDA unless ``--device cpu`` is given.  Every
``tcp://HOST:PORT`` target (``train --data``, ``--checkpoint-journal``,
``stream --updates``, ``serve --broker``) needs a running broker: an
unreachable one is a clean error with a nonzero exit, and nothing falls
back to another transport.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import sys
import time
import zipfile

AUTO_LAYOUT_TILED_NNZ = 2_000_000  # at and above this, the tiled layout


def _eprint(*args) -> None:
    print(*args, file=sys.stderr)


def _parse_tcp_url(url: str, topic_optional: bool = False):
    """``tcp://HOST:PORT[/TOPIC]`` → (host, port, topic).  Without a /TOPIC
    segment: the ratings topic, or None when ``topic_optional`` (commands
    that act on the whole broker)."""
    from cfk_tpu_torch.transport.ingest import RATINGS_TOPIC

    bad = f"bad broker url {url!r}; expected tcp://HOST:PORT[/TOPIC]"
    if not url.startswith("tcp://"):
        raise ValueError(bad)
    addr, _, topic = url[len("tcp://"):].partition("/")
    host, _, port_s = addr.rpartition(":")
    if not host or not port_s.isdigit():
        raise ValueError(bad)
    return host, int(port_s), topic or (None if topic_optional
                                        else RATINGS_TOPIC)


def _log_transport(target: str, *, fsync: bool):
    """The transport of a --checkpoint-journal or --updates target: a
    ``tcp://HOST:PORT`` broker or a FileBroker directory.  Raises
    ValueError on a malformed URL and OSError when the broker is
    unreachable (nothing falls back to a file broker); callers turn both
    into clean CLI errors."""
    if target.startswith("tcp://"):
        from cfk_tpu_torch.transport.tcp import TcpBrokerClient

        host, port, _ = _parse_tcp_url(target, topic_optional=True)
        return TcpBrokerClient(host, port)
    from cfk_tpu_torch.transport.filelog import FileBroker

    return FileBroker(target, fsync=fsync)


def _make_checkpoint_manager(args):
    """The checkpoint store the train flags select: the npz directory
    (``--checkpoint-dir``, the fast local default), the transport journal
    (``--checkpoint-journal``, factors as FeatureRecord frames through a
    FileBroker directory or a ``tcp://`` broker — the reference's
    topics-as-durable-checkpoint design, ``setup.sh:18-21``), or None.  Returns an int exit code on
    flag errors."""
    journal = args.checkpoint_journal
    if args.checkpoint_dir and journal:
        _eprint("error: --checkpoint-dir and --checkpoint-journal are "
                "mutually exclusive")
        return 2
    if args.checkpoint_dir:
        from cfk_tpu_torch.transport.checkpoint import CheckpointManager

        return CheckpointManager(args.checkpoint_dir,
                                 keep_last_n=args.keep_last_n)
    if journal:
        from cfk_tpu_torch.transport.journal import JournalCheckpointManager

        try:
            # fsync per append for the training journal: the commit marker
            # must never reach disk before the factor frames it commits.
            transport = _log_transport(journal, fsync=True)
        except (ValueError, OSError) as e:
            _eprint(f"error: {e}")
            return 2
        return JournalCheckpointManager(
            transport, num_partitions=args.journal_partitions)
    return None


def resolve_auto_layout(num_ratings: int, algorithm: str = "als",
                        solve_chunk: int | None = None) -> str:
    """layout='auto': one padded rectangle for small data; once the data is
    big enough for it to matter, the tiled layout (accum + dense stream),
    or for a subspace optimizer (als++/ials++), which needs padded or
    bucketed, the bucketed layout.  An explicit (deprecated) --solve-chunk
    means something on the padded layout only, so it resolves to padded
    (``cfk_tpu/cli.py:66-80``)."""
    if solve_chunk is not None or num_ratings < AUTO_LAYOUT_TILED_NNZ:
        return "padded"
    return "tiled" if algorithm == "als" else "bucketed"


def _parse_ratings(path: str, fmt: str, min_rating: float):
    """The COO of a Netflix-format file or a MovieLens CSV (``min_rating``
    drops MovieLens rows below it; Netflix files take every row)."""
    if fmt == "movielens":
        from cfk_tpu_torch.data.movielens import parse_movielens_csv

        return parse_movielens_csv(path, min_rating=min_rating)
    from cfk_tpu_torch.data.netflix import parse_netflix

    return parse_netflix(path)


_CACHE_ERRORS = (ValueError, KeyError, OSError, zipfile.BadZipFile)


def _load_dataset(path, fmt, min_rating, build, *, cache_dir=None,
                  auto_key=None, auto_resolver=None):
    """Parse ``path`` — a ratings file, or ``tcp://HOST:PORT/TOPIC`` on the
    broker — and build its ``Dataset`` (``build``: the ``Dataset.from_coo``
    keywords, ``layout`` possibly "auto", ``auto_resolver(coo)`` resolving
    it), or load it from the dataset cache ``cache_dir``.  The port of
    ``cfk_tpu/cli.py:82-283`` ``_load_dataset``: the cache's
    build key is the JAX package's (the data path, or the broker URL, the
    format, the layout flags, and a content fingerprint: the file's size
    and mtime, or the topic's per-partition end offsets), so a cache either
    package wrote for the same data and flags serves both; a key that does
    not match is rebuilt and overwritten, and a cache whose fingerprint
    cannot be read (the file gone, the broker down) still serves a key that
    matches on everything else."""
    from cfk_tpu_torch.data.blocks import Dataset, TiledBlocks

    tcp = path.startswith("tcp://")
    layout, dense_stream = build["layout"], build.get("dense_stream", False)
    build_key = {
        "data": path if tcp else os.path.abspath(path),
        "format": fmt,
        "min_rating": min_rating,
        "num_shards": build.get("num_shards", 1),
        "pad_multiple": build["pad_multiple"],
        "layout": layout,
        "chunk_elems": build["chunk_elems"],
    }
    if build.get("ring"):  # absent for non-ring keys, as in the JAX CLI
        build_key["ring"] = build["ring"]
    if dense_stream and layout == "tiled":
        build_key["dense_stream"] = True
    if "accum_max_entities" in build:  # --tiled-mode stream
        build_key["accum_max_entities"] = build["accum_max_entities"]
    if layout == "auto" and auto_key:
        build_key.update(auto_key)
    # For layout='auto' the dense flag changes the blocks only when the
    # resolution lands on tiled: saves record it iff the resolved build
    # consumed it, loads accept the flagless key too unless that cache is
    # tiled (a flagless tiled cache is a padded-stream build).
    auto_dense = dense_stream and layout == "auto"

    def cache_or_build(parse):
        if cache_dir and os.path.exists(os.path.join(cache_dir,
                                                     "meta.json")):
            keys = ([{**build_key, "dense_stream": True}, build_key]
                    if auto_dense else [build_key])
            err = None
            for key in keys:
                t0 = time.time()
                try:
                    ds = Dataset.load(cache_dir, expect_build_key=key)
                except _CACHE_ERRORS as e:
                    err = e  # a mismatched key or a broken cache: rebuild
                    continue
                if (auto_dense and "dense_stream" not in key
                        and isinstance(ds.user_blocks, TiledBlocks)):
                    err = ValueError("cached auto-layout dataset resolved "
                                     "to tiled without the dense stream; "
                                     "dense run rebuilds")
                    continue
                _eprint(f"# dataset cache hit ({time.time() - t0:.1f}s "
                        "load)")
                return ds
            _eprint(f"warning: ignoring dataset cache: {err}")
        coo = parse()
        resolved = auto_resolver(coo) if layout == "auto" else layout
        use_dense = dense_stream and resolved == "tiled"
        ds = Dataset.from_coo(coo, **{**build, "layout": resolved,
                                      "dense_stream": use_dense})
        if cache_dir:
            key = ({**build_key, "dense_stream": True}
                   if auto_dense and use_dense else build_key)
            ds.save(cache_dir, build_key=key)
        return ds

    def offline(ignore, why):
        ds = _cache_sans_fingerprint(cache_dir, build_key, ignore, auto_dense)
        if ds is not None:
            _eprint(f"warning: {why}; using dataset cache without the "
                    "freshness check")
        return ds

    if tcp:
        from cfk_tpu_torch.transport.ingest import collect_ratings
        from cfk_tpu_torch.transport.tcp import (
            BrokerRequestError,
            TcpBrokerClient,
        )

        if fmt != "netflix" or min_rating:
            # Broker records are already-parsed (movie, user, rating)
            # frames: the file-parse flags have nothing to apply to.
            _eprint("warning: --format/--min-rating are ignored for tcp:// "
                    "ingest (records on the broker are already parsed)")
        host, port, topic = _parse_tcp_url(path)
        try:
            client = TcpBrokerClient(host, port)
        except OSError as e:
            ds = offline(("end_offsets",), f"broker unreachable ({e})")
            if ds is not None:
                return ds
            raise
        with client:
            if cache_dir:
                try:
                    build_key["end_offsets"] = [
                        client.end_offset(topic, p)
                        for p in range(client.num_partitions(topic))]
                except (BrokerRequestError, KeyError) as e:
                    ds = offline(("end_offsets",),
                                 f"topic unavailable ({e})")
                    if ds is not None:
                        return ds
                    raise
            return cache_or_build(lambda: collect_ratings(client,
                                                          topic=topic))
    if os.path.exists(path):
        st = os.stat(path)
        build_key["data_size"] = st.st_size
        build_key["data_mtime_ns"] = st.st_mtime_ns
    else:
        ds = offline(("data_size", "data_mtime_ns"),
                     f"data file {path!r} not found")
        if ds is not None:
            return ds
    return cache_or_build(lambda: _parse_ratings(path, fmt, min_rating))


def _cache_sans_fingerprint(cache_dir, build_key, ignore, auto_dense=False):
    """The cache at ``cache_dir`` when the content fingerprint of its data
    cannot be read (the file gone, the broker down), if its stored build
    key matches ``build_key`` on every field outside ``ignore``
    (``cfk_tpu/cli.py:245-283``); else None."""
    from cfk_tpu_torch.data.blocks import Dataset, TiledBlocks
    from cfk_tpu_torch.data.cache import read_build_key

    if not cache_dir or not os.path.exists(os.path.join(cache_dir,
                                                        "meta.json")):
        return None
    try:
        stored = read_build_key(cache_dir)
        if stored is None:
            return None
        strip = lambda k: {x: v for x, v in k.items() if x not in ignore}  # noqa: E731
        sk, bk = strip(stored), strip(build_key)
        flagged_ok = auto_dense and sk == {**bk, "dense_stream": True}
        if sk != bk and not flagged_ok:
            return None
        ds = Dataset.load(cache_dir, expect_build_key=stored)
        if (auto_dense and not flagged_ok
                and isinstance(ds.user_blocks, TiledBlocks)):
            return None
        return ds
    except _CACHE_ERRORS:
        return None


def _save_predictions(model, output) -> str | None:
    from cfk_tpu_torch.eval.predict import save_prediction_csv

    try:
        preds = model.predict_dense()
    except ValueError as e:
        # At full-Netflix scale the trained model is the deliverable; the
        # dense CSV is the one unmaterializable side product.
        _eprint(f"warning: skipping the prediction CSV dump: {e}")
        return None
    return save_prediction_csv(preds, output)


def _run_reference_form(args) -> int:
    from cfk_tpu_torch.config import ALSConfig
    from cfk_tpu_torch.data.blocks import Dataset
    from cfk_tpu_torch.data.netflix import parse_netflix
    from cfk_tpu_torch.eval.metrics import mse_rmse_from_model
    from cfk_tpu_torch.models.als import train_als

    _eprint(f"app started: {time.strftime('%Y-%m-%d %H:%M:%S')}")
    coo = parse_netflix(args.path)
    _eprint(f"producer finished: {time.strftime('%Y-%m-%d %H:%M:%S')}")
    num_shards = args.num_partitions
    ds = Dataset.from_coo(coo, num_shards=num_shards)
    if ds.movie_map.num_entities != args.num_movies:
        _eprint(f"warning: NUM_MOVIES={args.num_movies} but data has "
                f"{ds.movie_map.num_entities} rated movies (using the data)")
    if ds.user_map.num_entities != args.num_users:
        _eprint(f"warning: NUM_USERS={args.num_users} but data has "
                f"{ds.user_map.num_entities} rated users (using the data)")
    config = ALSConfig(rank=args.num_features, lam=args.lam,
                       num_iterations=args.num_iterations,
                       num_shards=num_shards)
    if num_shards > 1:
        # NUM_PARTITIONS → ranks (cfk_tpu/cli.py:629-662); ranks share a
        # card when there are fewer cards, so no fall-back to one shard.
        from cfk_tpu_torch.parallel.mesh import make_mesh
        from cfk_tpu_torch.parallel.spmd import train_als_sharded

        with make_mesh(num_shards, args.device) as mesh:
            model = train_als_sharded(ds, config, mesh)
    else:
        model = train_als(ds, config, device=args.device)
    mse, rmse = mse_rmse_from_model(model, ds)
    path = _save_predictions(model, None)
    if path is not None:
        _eprint(f"prediction matrix written: {time.strftime('%Y-%m-%d %H:%M:%S')}")
    print(f"MSE: {mse}")
    print(f"RMSE: {rmse}")
    if path is not None:
        print(path)
    return 0


@contextlib.contextmanager
def _telemetry_session(args, metrics=None):
    """The telemetry of one CLI command, as ``cfk_tpu/cli.py``'s: ``--trace-
    dir`` installs the host span tracer (its Chrome-trace JSON written at
    exit); the flight recorder dumps into the trace directory, else the
    checkpoint directory, and an uncaught exception dumps it;
    ``--metrics-jsonl`` streams periodic snapshots of ``metrics``."""
    from cfk_tpu_torch import telemetry

    trace_dir = getattr(args, "trace_dir", None)
    dump_dir = trace_dir or getattr(args, "checkpoint_dir", None)
    tracer = telemetry.configure(trace_dir=trace_dir) if trace_dir else None
    if dump_dir:
        telemetry.get_recorder().configure(dump_dir=dump_dir)
        telemetry.install_crash_hooks()
    emitter = None
    jsonl = getattr(args, "metrics_jsonl", None)
    if jsonl and metrics is not None:
        emitter = telemetry.MetricsEmitter(
            metrics, jsonl,
            interval_s=getattr(args, "metrics_interval_s", 10.0)).start()
    try:
        yield
    finally:
        if emitter is not None:
            emitter.stop()
        if tracer is not None:
            path = telemetry.shutdown(write=True)
            if path:
                _eprint(f"host span trace written to {path}")


def _train(args) -> int:
    from cfk_tpu_torch.telemetry import Metrics

    metrics = Metrics()
    with _telemetry_session(args, metrics):
        return _train_impl(args, metrics)


def _train_impl(args, metrics) -> int:
    import torch

    from cfk_tpu_torch.config import ALSConfig
    from cfk_tpu_torch.data.blocks import Dataset
    from cfk_tpu_torch.device import resolve_device
    from cfk_tpu_torch.eval.metrics import mse_rmse_from_model
    from cfk_tpu_torch.models.als import _layout_of, train_als
    from cfk_tpu_torch.models.ials import IALSConfig, train_ials
    from cfk_tpu_torch.resilience.loop import validate_cadence
    from cfk_tpu_torch.utils.metrics import maybe_profile

    # The store's flags are checked before the (possibly long) block build.
    manager = _make_checkpoint_manager(args)
    if isinstance(manager, int):
        return manager
    if args.eval_ranking and not args.implicit:
        _eprint("error: --eval-ranking requires --implicit (it is a "
                "top-K ranking protocol, not a rating-error one)")
        return 1
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    if args.layout == "auto" and args.exchange in ("auto", "hier_ring"):
        # The per-half and hierarchical exchanges run on the tiled ring
        # blocks only; resolve up front so they are built.
        args.layout = "tiled"
    if args.layout == "auto" and args.exchange == "ring":
        # Both ring layouts work; padded builds its ring blocks in the
        # trainer and has no per-shard accumulator cap (cfk_tpu/cli.py:352).
        args.layout = "padded"
    if args.layout == "auto" and args.offload_tier == "host_window":
        # The windowed trainers stream the tiled layout (explicit ALS) and
        # the bucketed one (the implicit family): resolve up front so the
        # config never refuses a flag combination the parser accepted
        # (cfk_tpu/cli.py:360-363).
        args.layout = "bucketed" if args.implicit else "tiled"
    if args.tiled_mode == "stream" and (
            args.layout != "tiled"
            or args.exchange in ("ring", "hier_ring")):
        _eprint("error: --tiled-mode stream builds the tiled layout's "
                "stream blocks: it needs --layout tiled and no ring "
                "exchange (ring blocks carry the accumulator on both "
                "halves)")
        return 1
    common = dict(rank=args.rank, lam=args.lam,
                  num_shards=args.shards, exchange=args.exchange,
                  ici_group=args.ici_group, pad_multiple=args.pad_multiple,
                  num_iterations=args.iterations, seed=args.seed,
                  solver=args.solver, hbm_chunk_elems=args.chunk_elems,
                  solve_chunk=args.solve_chunk, algorithm=args.algorithm,
                  block_size=args.block_size, sweeps=args.sweeps,
                  in_kernel_gather=(None if args.in_kernel_gather == "auto"
                                    else args.in_kernel_gather == "on"),
                  dtype=args.dtype, table_dtype=args.table_dtype,
                  reg_solve_algo=args.reg_solve_algo,
                  overlap=not args.no_overlap,
                  health_check_every=args.health_check_every,
                  health_norm_limit=args.health_norm_limit,
                  max_recoveries=args.max_recoveries,
                  lam_escalation=args.lam_escalation,
                  on_unrecoverable=args.on_unrecoverable,
                  offload_tier=args.offload_tier, staging=args.staging,
                  staging_pool_depth=args.staging_pool_depth,
                  hot_rows=args.hot_rows)
    make_config = functools.partial(
        IALSConfig, alpha=args.alpha) if args.implicit else ALSConfig
    # Validate the flags before the (possibly long) block build; an
    # explicit --solve-chunk resolves 'auto' to padded.  The table dtype's
    # layout rule waits for the layout 'auto' resolves to (int8 needs
    # tiled or bucketed), as in the JAX CLI, which builds its config after
    # the blocks.
    early = dict(common, table_dtype="float32") if (
        args.layout == "auto" and args.solve_chunk is None) else common
    make_config(layout=("padded" if args.layout == "auto"
                        and args.solve_chunk is not None else args.layout),
                **early)
    # The tiled layout's many-entity side as the unpadded dense stream, as
    # the JAX CLI asks (cfk_tpu/cli.py:395); the subspace optimizers run on
    # the padded and bucketed layouts, where the flag has no side to reach.
    # A ring build carries the accum machinery on both halves, so it asks
    # for no dense stream (cfk_tpu/cli.py:372-395).
    ring = args.exchange in ("ring", "hier_ring")
    build = dict(layout=args.layout, chunk_elems=args.chunk_elems,
                 pad_multiple=args.pad_multiple, num_shards=args.shards,
                 dense_stream=args.algorithm not in ("als++", "ials++")
                 and not ring)
    if args.layout == "tiled":
        build["ring"] = "auto" if args.exchange == "auto" else ring
        if args.tiled_mode == "stream":
            # The padded stream on both halves, no accumulator: the blocks
            # the host_window tier trains on (it rebuilds them otherwise).
            build.update(dense_stream=False, accum_max_entities=0)
    ds = _load_dataset(
        args.data, args.format, args.min_rating, build,
        cache_dir=args.dataset_cache,
        auto_key={"algorithm": args.algorithm,
                  "solve_chunk": args.solve_chunk},
        auto_resolver=lambda coo: resolve_auto_layout(
            coo.num_ratings, args.algorithm, args.solve_chunk))
    layout, num_ratings = _layout_of(ds), ds.coo_dense.num_ratings
    build.update(layout=layout, dense_stream=build["dense_stream"]
                 and layout == "tiled")
    config = make_config(layout=layout, **common)
    heldout = train_coo = None
    if args.eval_ranking:
        from cfk_tpu_torch.eval.ranking import leave_one_out_split

        d = ds.coo_dense
        train_coo, heldout = leave_one_out_split(
            d.movie_raw, d.user_raw, d.rating, seed=args.seed)
        before = (ds.movie_map.num_entities, ds.user_map.num_entities)
        ds = Dataset.from_coo(train_coo, **build)
        if (ds.movie_map.num_entities, ds.user_map.num_entities) != before:
            _eprint(
                "error: the leave-one-out split removed some entity's only "
                "interaction; ranking eval needs every movie to keep >= 1 — "
                "use a denser dataset"
            )
            return 1
    prep_s = time.perf_counter() - t0
    metrics.phases["prep"] += prep_s
    validate_cadence(args.checkpoint_every)
    # Preemption tolerance is on whenever a checkpoint store exists: an
    # eviction SIGTERM (or Ctrl-C) commits one final checkpoint, drains the
    # writer and the process exits resumable — re-run the same command to
    # continue (``resilience.preempt``).
    guard_cm = contextlib.nullcontext(None)
    if manager is not None and not args.no_preempt_save:
        from cfk_tpu_torch.resilience.preempt import PreemptionGuard

        guard_cm = PreemptionGuard()
    t0 = time.perf_counter()
    trainer = train_ials if args.implicit else train_als
    with maybe_profile(args.profile_dir), guard_cm as guard:
        if args.shards > 1 and args.offload_tier != "host_window":
            from cfk_tpu_torch.models.ials import train_ials_sharded
            from cfk_tpu_torch.parallel.mesh import make_mesh
            from cfk_tpu_torch.parallel.spmd import train_als_sharded

            trainer = train_ials_sharded if args.implicit \
                else train_als_sharded
            with make_mesh(args.shards, args.device) as mesh:
                model = trainer(ds, config, mesh, metrics=metrics,
                                checkpoint_manager=manager,
                                checkpoint_every=args.checkpoint_every,
                                preemption_guard=guard)
        else:
            model = trainer(ds, config, device=dev, metrics=metrics,
                            checkpoint_manager=manager,
                            checkpoint_every=args.checkpoint_every,
                            preemption_guard=guard)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    if guard is not None and guard.triggered:
        # Exit inside the platform's grace window: the checkpoint is
        # committed and drained, so evaluation and the CSV dump of the
        # partial model would only risk a SIGKILL.  The metrics row still
        # goes out, with its "preempted" note.
        _eprint(
            f"preempted ({guard.signal_name}): a final checkpoint was "
            "committed — re-run this command to resume; skipping "
            "evaluation and output for the partial run"
        )
        print(metrics.json_line() if args.metrics == "json"
              else metrics.logfmt())
        return 0
    pipe = model.pipeline
    metrics.note("pipeline_route", f"{pipe['route']}: {pipe['reason']}")
    for key in ("capture_s", "instantiate_s"):
        if pipe.get(key) is not None:
            metrics.gauge(key, round(pipe[key], 6))
    _eprint(f"# pipeline: {pipe['route']} ({pipe['reason']})")
    gauges = []
    if not args.implicit:
        with metrics.phase("eval_mse"):
            mse, rmse = mse_rmse_from_model(model, ds)
        metrics.gauge("mse", round(mse, 6))
        metrics.gauge("rmse", round(rmse, 6))
        _eprint(f"train MSE={mse:.4f} RMSE={rmse:.4f}")
        gauges += [f"mse={mse:.6f}", f"rmse={rmse:.6f}"]
    if heldout is not None:
        from cfk_tpu_torch.eval.ranking import ranking_metrics_from_model

        with metrics.phase("eval_ranking"):
            rec, mpr = ranking_metrics_from_model(model, train_coo, heldout,
                                                  k=args.eval_ranking)
        metrics.gauge(f"recall_at_{args.eval_ranking}", round(rec, 6))
        metrics.gauge("mpr", round(mpr, 6))
        _eprint(f"leave-one-out Recall@{args.eval_ranking}={rec:.4f} "
                f"MPR={mpr:.4f}")
        gauges += [f"recall_at_{args.eval_ranking}={rec:.6f}",
                   f"mpr={mpr:.6f}"]
    if manager is not None:
        _eprint(f"factors checkpointed to "
                f"{args.checkpoint_dir or args.checkpoint_journal} (step "
                f"{manager.latest_iteration()})")
    if args.output != "none":
        path = _save_predictions(
            model, None if args.output == "auto" else args.output)
        if path is not None:
            _eprint(f"predictions written to {path}")
    metrics.gauge("s_per_iter", round(train_s / args.iterations, 6))
    metrics.note("layout", layout)
    metrics.note("device", str(dev))
    if args.metrics == "json":
        print(metrics.json_line())
        return 0
    print(" ".join([f"layout={layout}", f"device={dev}",
                    f"num_ratings={num_ratings}",
                    f"prep_s={prep_s:.3f}",
                    f"train_s={train_s:.3f}",
                    f"s_per_iter={train_s / args.iterations:.4f}", *gauges]))
    return 0


def _evaluate(args) -> int:
    from cfk_tpu_torch.data.blocks import Dataset
    from cfk_tpu_torch.data.netflix import parse_netflix
    from cfk_tpu_torch.eval.metrics import mse_rmse_from_blocks
    from cfk_tpu_torch.eval.predict import load_prediction_csv

    ds = Dataset.from_coo(parse_netflix(args.ratings_file))
    preds = load_prediction_csv(args.prediction_csv)
    want = (ds.user_map.num_entities, ds.movie_map.num_entities)
    if preds.shape != want:
        _eprint(
            f"error: prediction matrix is {preds.shape}, ratings imply {want} "
            "(rows = users ascending id, cols = movies ascending id)"
        )
        return 2
    print(f"#users in ratings_matrix:  {want[0]}")
    print(f"#movies in ratings_matrix:  {want[1]}")
    mse, rmse = mse_rmse_from_blocks(preds, ds)
    print(f"MSE: {mse}")
    print(f"RMSE: {rmse}")
    return 0


def _serving_state(args):
    """Restore factors for the serving verbs from either store:
    --checkpoint-dir (npz directory; a missing or torn one raises, which
    ``main`` turns into exit 1) or --checkpoint-journal (a FileBroker
    journal directory or a ``tcp://`` broker; an empty or uncommitted one,
    or an unreachable broker, prints the error and gives None, exit 2, as
    the reference's does)."""
    if bool(args.checkpoint_dir) == bool(args.checkpoint_journal):
        _eprint("error: pass exactly one of --checkpoint-dir / "
                "--checkpoint-journal")
        return None
    if args.checkpoint_dir:
        from cfk_tpu_torch.transport.checkpoint import CheckpointManager

        return CheckpointManager(args.checkpoint_dir).restore()
    from cfk_tpu_torch.transport.journal import JournalCheckpointManager

    try:
        transport = _log_transport(args.checkpoint_journal, fsync=False)
        return JournalCheckpointManager(transport).restore()
    except (ValueError, OSError) as e:
        # A malformed URL, an unreachable broker, or an empty or
        # uncommitted journal: a clean error beats a traceback.
        _eprint(f"error: {e}")
        return None


def _serving_model(args):
    """(RatingsIndex of --data, ALSModel from the checkpoint store on
    --device, the step's iteration), or None after an error was printed.
    Only the id maps and seen lists are built — never training blocks."""
    from cfk_tpu_torch.data.blocks import RatingsIndex
    from cfk_tpu_torch.weights import model_from_state

    state = _serving_state(args)
    if state is None:
        return None
    ds = RatingsIndex.from_coo(
        _parse_ratings(args.data, args.format, args.min_rating))
    model = model_from_state(state, num_users=ds.user_map.num_entities,
                             num_movies=ds.movie_map.num_entities,
                             device=args.device)
    return ds, model, state.iteration


def _recommend(args) -> int:
    """Top-K from checkpointed factors, printing raw ids:
    ``<user>\\t<movie>:<score>,...``."""
    import numpy as np

    served = _serving_model(args)
    if served is None:
        return 2
    ds, model, _ = served
    if args.users == "all":
        rows = np.arange(ds.user_map.num_entities)
    else:
        raw = np.asarray([int(u) for u in args.users.split(",")], np.int64)
        rows = ds.user_map.to_dense(raw).astype(np.int64)
    scores, movie_rows = model.recommend_top_k(
        rows, args.k, dataset=None if args.include_seen else ds)
    raw_movies = ds.movie_map.raw_ids[movie_rows]
    for i, u in enumerate(ds.user_map.raw_ids[rows]):
        pairs = ",".join(f"{mid}:{s:.3f}"
                         for mid, s in zip(raw_movies[i], scores[i]))
        print(f"{u}\t{pairs}")
    return 0


def _predict(args) -> int:
    """The prediction CSV from checkpointed factors, without training (the
    reference's final collection, ``processors/FeatureCollector.java``)."""
    served = _serving_model(args)
    if served is None:
        return 2
    ds, model, iteration = served
    path = _save_predictions(
        model, None if args.output == "auto" else args.output)
    if path is None:
        return 1
    _eprint(f"predictions from iteration-{iteration} checkpoint written to "
            f"{path}")
    return 0


def _serve(args) -> int:
    """The request server.  Without --broker: over an in-memory log, driven
    by the open-loop load generator at --loadgen-qps for --loadgen-requests
    requests; prints one JSON row of the measured QPS and latency (with
    --replicas N, through a fleet of N replicas, user-keyed, plus the
    fleet's shed, retry and batch counts).  With --broker tcp://HOST:PORT:
    joins the broker's serve topics and answers until ^C (SIGINT), one
    server or --replicas N, then prints what was served.  ``--metrics-port``
    serves each server's registry on ``GET /metrics`` (and ``/readyz``)
    while it runs; ``--trace-dir`` writes the host span trace."""
    with _telemetry_session(args):
        return _serve_impl(args)


def _serve_fleet(args, transport, engine, make_engine, model):
    """A prewarmed ``ServeFleet`` of --replicas engines over ``transport``
    (replica 0 serves ``engine``), its snapshot store seeded with the
    model's factors."""
    from cfk_tpu_torch.serving import ServeFleet

    fleet = ServeFleet(
        lambda i: engine if i == 0 else make_engine(), transport,
        replicas=args.replicas, max_batch=args.max_batch,
        response_partitions=args.response_partitions,
        admission_max_queue=args.admission_queue or None,
        metrics_ports=args.metrics_port is not None)
    u, m = model.host_factors()
    fleet.seed_store(u, m, num_users=model.num_users)
    fleet.prewarm(args.k, max_batch=args.max_batch)
    for r in fleet.replicas:
        ms = r.server.metrics_server
        if ms is not None:
            _eprint(f"replica {r.index} metrics endpoint: {ms.url}")
    return fleet


def _serve_impl(args) -> int:
    import json

    from cfk_tpu_torch.serving import (
        RecommendServer,
        ServeClient,
        engine_from_model,
        ensure_serve_topics,
        run_open_loop,
        warm_serve_programs,
        zipf_user_rows,
    )
    from cfk_tpu_torch.transport.broker import InMemoryBroker

    if args.replicas < 1:
        _eprint(f"error: --replicas must be >= 1, got {args.replicas}")
        return 2
    transport = None
    if args.broker:
        # The broker first: an unreachable one fails before the (possibly
        # long) restore and prewarm.
        from cfk_tpu_torch.transport.tcp import TcpBrokerClient

        host, port, _ = _parse_tcp_url(args.broker, topic_optional=True)
        transport = TcpBrokerClient(host, port)
    served = _serving_model(args)
    if served is None:
        return 2
    ds, model, _ = served

    def make_engine():
        return engine_from_model(
            model, None if args.include_seen else ds,
            table_dtype=args.table_dtype, tile_m=args.tile_m,
            serve_mode=args.serve_mode, clusters=args.clusters or None,
            probe_clusters=args.probe_clusters or None)

    engine = make_engine()
    if engine.serve_mode == "two_stage":
        _eprint(f"two-stage retrieval: {engine.clusters} clusters, "
                f"{engine.probe_clusters} probed per user (the exact scan "
                "stays the fault fallback)")
    warm = engine.prewarm(args.k, max_batch=args.max_batch)
    _eprint(f"prewarmed {warm['programs']} batch sizes in "
            f"{warm['prewarm_s']:.2f}s")
    shape = {"users": ds.user_map.num_entities,
             "movies": ds.movie_map.num_entities, "k": args.k,
             "table_dtype": engine.table_dtype,
             "serve_mode": engine.serve_mode, "device": str(engine.device)}
    if transport is not None:
        if args.replicas > 1:
            fleet = _serve_fleet(args, transport, engine, make_engine, model)
            fleet.start()
            _eprint(f"serving fleet: {args.replicas} replicas over broker "
                    f"{host}:{port} (user-keyed routing; ^C to stop)")
            try:
                while True:
                    time.sleep(1.0)
            except KeyboardInterrupt:
                pass
            finally:
                fleet.stop()
            c = fleet.counters()
            _eprint(f"fleet served {c['served']} requests ({c['shed']} "
                    f"shed) in {c['batches']} batches")
            return 0
        ensure_serve_topics(transport,
                            request_partitions=args.request_partitions,
                            response_partitions=args.response_partitions)
        server = RecommendServer(engine, transport, max_batch=args.max_batch,
                                 metrics_port=args.metrics_port)
        if server.metrics_server is not None:
            _eprint(f"metrics endpoint: {server.metrics_server.url}")
        _eprint(f"serving {shape['users']} users x {shape['movies']} movies "
                f"(rank {model.user_factors.shape[-1]}, table "
                f"{engine.table_dtype}) from broker {host}:{port}; ^C to "
                "stop")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.close()
        _eprint(f"served {server.requests_served} requests in "
                f"{server.batches} batches")
        return 0
    transport = InMemoryBroker()
    pool = zipf_user_rows(ds.user_map.num_entities, args.loadgen_requests,
                          seed=args.seed)
    if args.replicas > 1:
        fleet = _serve_fleet(args, transport, engine, make_engine, model)
        client = ServeClient(transport, route_by_user=True)
        fleet.start()
        try:
            report = run_open_loop(
                client, rate_qps=args.loadgen_qps,
                num_requests=args.loadgen_requests, user_rows=pool, k=args.k)
        finally:
            fleet.stop()
        c = fleet.counters()
        print(json.dumps({
            **shape, "replicas": args.replicas, "shed": c["shed"],
            "client_retries": client.retries, **report.as_row(),
            # the load generator cannot see the fleet's servers: batch
            # accounting comes from the fleet's counters
            "batches": c["batches"],
            "mean_batch": (round(c["served"] / c["batches"], 1)
                           if c["batches"] else 0.0)}))
        return 0
    ensure_serve_topics(transport)
    server = RecommendServer(engine, transport, max_batch=args.max_batch,
                             metrics_port=args.metrics_port)
    if server.metrics_server is not None:
        _eprint(f"metrics endpoint: {server.metrics_server.url}")
    try:
        client = ServeClient(transport)
        warm_serve_programs(client, server, pool, args.k,
                            min(args.max_batch, pool.shape[0]))
        report = run_open_loop(
            client, rate_qps=args.loadgen_qps,
            num_requests=args.loadgen_requests, user_rows=pool, k=args.k,
            server=server, drive_server=True)
    finally:
        server.close()
    print(json.dumps({**shape, **report.as_row()}))
    return 0


def _broker(args) -> int:
    """Run the port's log broker in the foreground (built from
    ``csrc/host/cfk_broker.cpp`` first if needed): this process becomes
    the broker, so ^C or SIGTERM stops it and nothing is left behind."""
    from cfk_tpu_torch.transport.tcp import build_broker

    path = build_broker()
    argv = [path, str(args.port)]
    if args.data_dir or args.bind != "127.0.0.1":
        argv.append(args.data_dir or "")
    if args.bind != "127.0.0.1":
        argv.append(args.bind)
    sys.stdout.flush()
    os.execv(path, argv)


def _topics(args) -> int:
    """Topic administration against a running broker (the reference's
    ``setup.sh`` role): list, create, delete, recreate."""
    from cfk_tpu_torch.transport.tcp import TcpBrokerClient

    host, port, topic = _parse_tcp_url(args.broker, topic_optional=True)
    with TcpBrokerClient(host, port) as client:
        if args.action == "list":
            for name in client.topics():
                nparts = client.num_partitions(name)
                print(f"{name}\tpartitions={nparts}\t" + "\t".join(
                    f"p{p}={client.end_offset(name, p)}"
                    for p in range(nparts)))
            return 0
        if topic is None:
            _eprint(f"error: {args.action} needs tcp://HOST:PORT/TOPIC")
            return 1
        if args.action in ("delete", "recreate"):
            client.delete_topic(topic)
        if args.action in ("create", "recreate"):
            client.create_topic(topic, args.partitions)
    return 0


def _produce(args) -> int:
    """Stream a Netflix-format ratings file into a broker topic (the
    reference's producer, ``apps/ALSAppRunner.java:30-33``, as a process
    of its own; ``train --data tcp://…`` is the consumer)."""
    from cfk_tpu_torch.transport.ingest import produce_ratings_file
    from cfk_tpu_torch.transport.tcp import TcpBrokerClient

    host, port, topic = _parse_tcp_url(args.broker)
    if args.partitions < 1:
        _eprint(f"error: --partitions must be >= 1, got {args.partitions}")
        return 1
    with TcpBrokerClient(host, port) as client:
        try:
            client.create_topic(topic, args.partitions)
        except ValueError as e:
            if "already exists" not in str(e):
                raise
            if not args.append:
                _eprint(f"error: topic {topic!r} already exists (use "
                        "--append to add to a topic produced with --no-eof; "
                        "a finalized topic's EOF records would fail the "
                        "ingest barrier)")
                return 1
        n = produce_ratings_file(client, args.data, topic=topic,
                                 send_eof=not args.no_eof)
    state = "open (no EOF yet)" if args.no_eof else "finalized"
    _eprint(f"produced {n} ratings to {topic!r} on {host}:{port} [{state}]")
    return 0


def _stream(args) -> int:
    """Streaming fold-in: consume rating updates, fold them into live
    factors, commit factors + offset cursor atomically per micro-batch.

    Bootstrap: with no resumable state in --stream-dir, a base model is
    trained from --data first (same config), then streaming starts from
    offset 0.  Re-running the identical command resumes from the committed
    cursor — including after a crash or an eviction SIGTERM.
    ``--produce-csv`` instead appends "user,movie,rating" lines to the
    updates topic and exits (the producer side of the loop).
    ``--metrics-port`` serves the live registry as Prometheus text on
    ``GET /metrics`` for the duration of the stream."""
    from cfk_tpu_torch.telemetry import Metrics

    metrics = Metrics()
    with _telemetry_session(args, metrics):
        http = None
        if args.metrics_port is not None:
            from cfk_tpu_torch.telemetry import MetricsHTTPServer

            http = MetricsHTTPServer(metrics, port=args.metrics_port).start()
            _eprint(f"metrics endpoint: {http.url}")
        try:
            return _stream_impl(args, metrics)
        finally:
            if http is not None:
                http.stop()


def _produce_csv(args, transport) -> int:
    """``stream --produce-csv``: parse the whole file first, then one bulk
    append per partition (``send_many`` → ``FileBroker.produce_frames``) —
    per-line sends would pay one fsync'd append each, and parsing first
    makes a malformed line all-or-nothing instead of leaving a
    half-produced file in the log."""
    from cfk_tpu_torch.streaming import StreamProducer

    prod = StreamProducer(transport, num_partitions=args.partitions)
    users: list[int] = []
    movies: list[int] = []
    ratings: list[float] = []
    with open(args.produce_csv) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                user_s, movie_s, rating_s = line.split(",", 2)
                users.append(int(user_s))
                movies.append(int(movie_s))
                ratings.append(float(rating_s))
            except ValueError as e:
                _eprint(f"error: {args.produce_csv}:{lineno}: malformed "
                        f"update {line!r} ({e})")
                return 1
    prod.send_many(users, movies, ratings)
    transport.flush()
    _eprint(f"produced {len(users)} updates (next seq {prod.next_seq})")
    return 0


def _stream_impl(args, metrics) -> int:
    import numpy as np

    from cfk_tpu_torch.config import ALSConfig
    from cfk_tpu_torch.device import resolve_device

    try:
        # fsync'd appends: the updates topic is the system of record the
        # crash replay consumes.
        transport = _log_transport(args.updates, fsync=True)
    except (ValueError, OSError) as e:
        _eprint(f"error: {e}")
        return 2
    if args.produce_csv:
        return _produce_csv(args, transport)

    from cfk_tpu_torch.streaming import (
        StreamConfig,
        StreamSession,
        ensure_updates_topic,
    )
    from cfk_tpu_torch.transport.checkpoint import CheckpointManager

    dev = resolve_device(args.device)
    config = ALSConfig(
        rank=args.rank,
        lam=args.lam,
        num_iterations=args.iterations,
        seed=args.seed,
        layout=args.layout,
        solver=args.solver,
        dtype=args.dtype,
        # threaded so retrain()'s merged-dataset rebuild honors the same
        # chunk budget as the base dataset built below
        hbm_chunk_elems=args.chunk_elems,
        health_check_every=args.health_check_every,
        health_norm_limit=args.health_norm_limit,
        max_recoveries=args.max_recoveries,
        lam_escalation=args.lam_escalation,
        on_unrecoverable=args.on_unrecoverable,
    )
    # Ensure the topic BEFORE the (possibly long) base train: a fresh topic
    # is created empty and followed, instead of training a base model only
    # to crash on an unknown-topic lookup afterwards.
    ensure_updates_topic(transport, num_partitions=args.partitions)
    with metrics.phase("ingest"):
        ds = _load_dataset(
            args.data, args.format, args.min_rating,
            dict(layout=args.layout, chunk_elems=args.chunk_elems,
                 pad_multiple=8, dense_stream=args.layout == "tiled"),
            cache_dir=args.dataset_cache)
    manager = CheckpointManager(args.stream_dir,
                                keep_last_n=args.keep_last_n)
    base_model = None
    if manager.latest_valid_iteration() is None:
        _eprint("no stream state yet: training the base model first")
        from cfk_tpu_torch.models.als import train_als

        with metrics.phase("base_train"):
            base_model = train_als(ds, config, device=dev, metrics=metrics)
    stream = StreamConfig(
        batch_records=args.batch_records,
        foldin_layout=args.foldin_layout,
        retrain_every=args.retrain_every,
    )
    guard_cm = contextlib.nullcontext(None)
    if not args.no_preempt_save:
        from cfk_tpu_torch.resilience.preempt import PreemptionGuard

        guard_cm = PreemptionGuard()
    with guard_cm as guard:
        session = StreamSession(
            ds, config, transport, manager, stream=stream,
            base_model=base_model, metrics=metrics,
            preemption_guard=guard, device=dev,
        )
        if args.prewarm:
            warm = session.prewarm()
            _eprint(
                f"prewarmed {warm['programs']} fold-in programs "
                f"({warm['new_traces']} new program keys) in "
                f"{warm['prewarm_s']:.2f}s"
            )
        model = session.run(max_batches=args.max_batches, follow=args.follow)
    metrics.gauge("stream_step", session.stream_step)
    metrics.gauge("users", session.state.num_users)
    metrics.gauge("backlog", session.backlog())
    if guard is not None and guard.triggered:
        _eprint(
            f"preempted ({guard.signal_name}): factor+cursor step "
            f"{session.stream_step} is committed — re-run to resume"
        )
    elif not args.no_eval:
        import dataclasses

        import torch

        from cfk_tpu_torch.data.blocks import Dataset
        from cfk_tpu_torch.eval.metrics import mse_rmse_from_model

        with metrics.phase("eval_mse"):
            # Against the merged (base + committed upserts) rating state;
            # the merged dataset re-sorts ALL users ascending by raw id
            # while session rows are base-ascending THEN appended new
            # users, so the factors are permuted into the merged row order
            # (the permutation the warm retrain applies) or every user past
            # a new user's insertion point would score against the wrong
            # row.
            merged = Dataset.from_coo(session.state.to_coo())
            perm = merged.user_map.to_dense(session.state.user_raw_ids())
            u_sess = session.user_factors
            u_eval = np.zeros((merged.user_blocks.padded_entities,
                               u_sess.shape[1]), np.float32)
            u_eval[perm] = u_sess[: session.state.num_users]
            eval_model = dataclasses.replace(
                model, user_factors=torch.as_tensor(u_eval, device=dev),
                movie_factors=model.movie_factors.float(),
                num_users=merged.user_map.num_entities,
            )
            mse, rmse = mse_rmse_from_model(eval_model, merged)
        metrics.gauge("mse", round(mse, 6))
        metrics.gauge("rmse", round(rmse, 6))
        _eprint(f"merged-state MSE={mse:.4f} RMSE={rmse:.4f}")
    print(metrics.json_line() if args.metrics == "json"
          else metrics.logfmt())
    return 0


def _serving_args(p, *, data_help: str) -> None:
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint directory (train --checkpoint-dir, or "
                   "the JAX package's); its newest valid step is served")
    p.add_argument("--checkpoint-journal", default=None, metavar="DIR|URL",
                   help="serve from a transport journal instead "
                   "(train --checkpoint-journal: a FileBroker directory or "
                   "a tcp://HOST:PORT broker either package wrote); "
                   "exactly one of the two stores")
    p.add_argument("--data", required=True, help=data_help)
    p.add_argument("--format", choices=["netflix", "movielens"],
                   default="netflix")
    p.add_argument("--min-rating", type=float, default=0.0,
                   help="(movielens) drop rows rated below this")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cfk_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("run", help="reference-compatible positional form")
    r.add_argument("num_partitions", type=int)
    r.add_argument("num_features", type=int)
    r.add_argument("lam", type=float)
    r.add_argument("num_iterations", type=int)
    r.add_argument("path")
    r.add_argument("num_movies", type=int)
    r.add_argument("num_users", type=int)
    r.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    r.set_defaults(fn=_run_reference_form)

    t = sub.add_parser("train", help="full-flag training")
    t.add_argument("--data", required=True,
                   help="a ratings file, or tcp://HOST:PORT[/TOPIC] to "
                   "collect a produced topic from the broker")
    t.add_argument("--format", choices=["netflix", "movielens"],
                   default="netflix")
    t.add_argument("--implicit", action="store_true",
                   help="confidence-weighted iALS")
    t.add_argument("--min-rating", type=float, default=0.0,
                   help="(movielens) drop rows rated below this")
    t.add_argument("--rank", type=int, default=5)
    t.add_argument("--lam", type=float, default=0.05)
    t.add_argument("--alpha", type=float, default=40.0,
                   help="iALS confidence weight")
    t.add_argument(
        "--algorithm", choices=["als", "als++", "ials++"], default="als",
        help="per-entity optimizer: 'als' = full k-by-k normal-equation "
        "solves; 'als++' (explicit) / 'ials++' (implicit) = warm-started "
        "subspace block coordinate descent; padded/bucketed layouts",
    )
    t.add_argument(
        "--eval-ranking", type=int, default=None, metavar="K",
        help="(implicit only) hold one interaction per user out before "
        "training and report leave-one-out Recall@K and mean percentile "
        "rank after",
    )
    t.add_argument("--block-size", type=int, default=32,
                   help="als++/ials++ coordinate block size (must divide rank)")
    t.add_argument("--sweeps", type=int, default=1,
                   help="als++/ials++ sweeps over all blocks per half-iteration")
    t.add_argument("--iterations", type=int, default=7)
    t.add_argument("--seed", type=int, default=42)
    t.add_argument(
        "--layout", choices=["auto", "padded", "bucketed", "segment",
                             "tiled"],
        default="auto",
        help="InBlock layout: one rectangle per side (padded), power-of-two "
        "width classes (bucketed), flat sorted runs in nnz chunks with "
        "entities straddling chunks (segment; exactly O(nnz) memory for "
        "any skew) or accum + dense-stream tiles (tiled). Default 'auto': "
        "padded below 2M ratings, tiled above (bucketed for als++/ials++)",
    )
    t.add_argument("--shards", type=int, default=1,
                   help="ranks to shard the entity rows over "
                   "(parallel.spmd; ranks share a card when there are "
                   "fewer cards, the exchanges then staged through host "
                   "memory)")
    t.add_argument("--exchange",
                   choices=["all_gather", "ring", "hier_ring", "auto"],
                   default="all_gather",
                   help="fixed-factor exchange between ranks; 'auto' "
                   "(tiled layout) picks per half: ring where the Gram "
                   "accumulator fits, all_gather elsewhere")
    t.add_argument("--ici-group", type=int, default=None, metavar="I",
                   help="inner-ring size of --exchange hier_ring; default: "
                   "LOCAL_WORLD_SIZE when it divides --shards, else one "
                   "flat ring")
    t.add_argument(
        "--offload-tier", choices=["auto", "device", "host_window"],
        default="auto",
        help="where the factor tables live: 'auto' = resident while both "
        "tables and the blocks fit the device's memory "
        "(offload.budget.fits_device), host_window past it; 'device' pins "
        "the resident tables; 'host_window' pins the out-of-core tier — "
        "host-RAM factor stores, windows staged to the card (explicit ALS "
        "on the tiled layout, sharded too with --shards in one process; "
        "iALS/iALS++ on the bucketed layout).  The tier changes no "
        "block: host_window rebuilds the stream blocks it needs from the "
        "dataset unless --tiled-mode stream built them",
    )
    t.add_argument(
        "--tiled-mode", choices=["auto", "stream"], default="auto",
        help="block mode of --layout tiled: 'auto' = the builder's choice "
        "per half (the accumulator while the half's entities fit it, else "
        "the unpadded dense stream); 'stream' = the padded stream on both "
        "halves, no accumulator — the blocks the host_window tier trains "
        "on, so the resident and windowed tiers train the same blocks to "
        "the same bits",
    )
    t.add_argument(
        "--staging", choices=["auto", "pool", "serial"], default="auto",
        help="host staging engine of the host_window tier: 'pool' (= "
        "'auto') stages every shard's windows ahead on a thread pool; "
        "'serial' the one-thread double buffer.  The same factors either "
        "way",
    )
    t.add_argument(
        "--hot-rows", type=int, default=None, metavar="F",
        help="hot-row device cache of the host_window tier: keep the top-F "
        "most-referenced fixed-table rows (both sides) on the card so "
        "windows stage only their cold delta.  Default: the coverage-"
        "curve knee, clamped by the budget headroom; 0 = off; an "
        "impossible F raises.  The same factors whatever F",
    )
    t.add_argument(
        "--staging-pool-depth", type=int, default=None, metavar="D",
        help="windows staged ahead of consumption in pool mode (default "
        "4), clamped so D+1 worst-case windows fit the window budget",
    )
    t.add_argument("--pad-multiple", type=int, default=8,
                   help="pad ragged neighbor lists to a multiple of this "
                   "(padded/bucketed widths, segment chunk capacity)")
    t.add_argument("--solve-chunk", type=int, default=None,
                   help="DEPRECATED: explicit entities per padded-layout "
                   "solve chunk; --chunk-elems is the one budget for every "
                   "layout")
    t.add_argument(
        "--chunk-elems", type=int, default=1 << 20,
        help="gather-cell budget per chunk: the tiled, bucketed and segment "
        "layouts' chunk size at build time (segment: chunk-elems // 64 "
        "ratings, for its [C, k, k] Gram); padded derives entities per "
        "solve chunk from it",
    )
    t.add_argument(
        "--dataset-cache", default=None, metavar="DIR",
        help="directory for the built-blocks cache: loaded if present and "
        "its stored build key (data path/size/mtime + layout flags) matches, "
        "rebuilt and overwritten otherwise",
    )
    t.add_argument(
        "--solver", choices=["auto", "cholesky"], default="auto",
        help="auto = the CUDA kernels on a GPU (their plain PyTorch "
        "versions on the CPU); cholesky = the plain PyTorch route "
        "(torch.linalg.cholesky), with --device cpu only",
    )
    t.add_argument(
        "--in-kernel-gather", choices=["auto", "on", "off"], default="auto",
        help="where the tiled and bucketed half-steps gather the neighbor "
        "factors: 'auto'/'on' (default) inside the Gram kernels, which read "
        "the factor table by index; 'off' pins the materialized-stream "
        "schedule — each chunk's gathered [C, k] stream is written to "
        "device memory first and read back by the stream Gram kernels (A/B "
        "measurement; the factors agree either way)",
    )
    t.add_argument(
        "--table-dtype", choices=["float32", "bfloat16", "int8"],
        default="float32",
        help="gather-table dtype (cfk_tpu_torch.ops.quant): quantize the "
        "fixed-side table each half-iteration gathers from — bfloat16 "
        "halves the gather bytes, int8 (+ one f32 scale per row, folded "
        "into the kernels' premultiply) quarters them; Gram/solve "
        "accumulation stays float32 and the solved factors keep --dtype. "
        "float32 (default) is the unquantized path. "
        "int8 needs the tiled/bucketed layouts' weight streams",
    )
    t.add_argument(
        "--reg-solve-algo", choices=["auto", "lu", "gj"], default="auto",
        help="the fused reg+solve route's name, as in cfk_tpu: 'lu' (and "
        "'auto') keeps ranks up to 128 on the fused kernels, 'gj' caps "
        "them at 64 (64 < rank <= 128 takes the split schedule's blocked "
        "solve); the port eliminates by one blocked Cholesky under both",
    )
    t.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="storage dtype of the factor matrices (bfloat16 "
                   "halves their memory; Gram and solve stay float32)")
    t.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    t.add_argument(
        "--output", default="auto",
        help="'auto' = predictions/prediction_matrix_<ts>, 'none', or a path",
    )
    t.add_argument(
        "--health-check-every", type=int, default=None, metavar="N",
        help="arm the numerical-health sentinel: probe the factor state "
        "(isfinite + norm watchdogs) every N iterations; a tripped probe "
        "rolls back to the last good checkpoint and escalates (retry, then "
        "lam x LAM_ESCALATION, then split epilogue, then the GJ route).  "
        "Default: off",
    )
    t.add_argument(
        "--health-norm-limit", type=float, default=1e6,
        help="factor-row 2-norm above which the sentinel's watchdog trips "
        "even while values are still finite (catches slow divergence "
        "before overflow)",
    )
    t.add_argument(
        "--max-recoveries", type=int, default=4,
        help="total sentinel trips tolerated before the run stops "
        "retrying (see --on-unrecoverable)",
    )
    t.add_argument(
        "--lam-escalation", type=float, default=10.0,
        help="multiplier applied to lam on the recovery ladder's "
        "regularization rung",
    )
    t.add_argument(
        "--on-unrecoverable", choices=["degrade", "raise"],
        default="degrade",
        help="after max-recoveries trips: 'degrade' returns the last-good "
        "factors with a diagnostic report in the metrics (a stale model "
        "beats no model); 'raise' fails the run",
    )
    t.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint the factors here every "
                   "--checkpoint-every iterations and at the end (for "
                   "recommend / predict / serve), resuming from its newest "
                   "intact step")
    t.add_argument(
        "--checkpoint-journal", default=None, metavar="DIR|URL",
        help="journal factors as FeatureRecord frames through a FileBroker "
        "directory or a tcp://HOST:PORT broker (the reference's "
        "topics-as-checkpoint design); mutually exclusive with "
        "--checkpoint-dir")
    t.add_argument("--journal-partitions", type=int, default=1,
                   help="partitions per factor topic in the journal")
    t.add_argument("--checkpoint-every", type=int, default=1)
    t.add_argument(
        "--keep-last-n", type=int, default=None,
        help="garbage-collect checkpoint steps beyond the newest N after "
        "each save (the last verified-good step the recovery ladder "
        "points at is always pinned); default keeps every step",
    )
    t.add_argument(
        "--no-preempt-save", action="store_true",
        help="disable the SIGTERM/SIGINT preemption guard that is armed "
        "whenever --checkpoint-dir is set: by default an eviction signal "
        "drains the async checkpoint writer, commits one final "
        "checkpoint, and exits resumable instead of dying mid-iteration",
    )
    t.add_argument(
        "--no-overlap", action="store_true",
        help="pin the serial chunk schedule instead of the default "
        "pipelined one (side-stream prefetch of the gather-off streams); "
        "A/B measurement — the factors are bit-identical either way",
    )
    t.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the training loop "
                   "(Chrome-trace JSON) here")
    t.add_argument(
        "--trace-dir", default=None, metavar="DIR",
        help="write the host span trace (Chrome-trace JSON) here at exit; "
        "pass the same directory as --profile-dir to line the host "
        "timeline up with the device trace",
    )
    t.add_argument(
        "--metrics-jsonl", default=None, metavar="PATH",
        help="stream periodic metrics-registry snapshots (one JSON line "
        "per interval, and one at exit) for live dashboards",
    )
    t.add_argument("--metrics-interval-s", type=float, default=10.0,
                   help="seconds between --metrics-jsonl snapshots")
    t.add_argument(
        "--metrics", choices=["json", "logfmt"], default="logfmt",
        help="the exit row: 'logfmt' (default) the key=value row, 'json' "
        "the metrics registry as one JSON line",
    )
    t.set_defaults(fn=_train)

    e = sub.add_parser("evaluate", help="offline MSE/RMSE of a prediction CSV")
    e.add_argument("ratings_file")
    e.add_argument("prediction_csv")
    e.set_defaults(fn=_evaluate)

    rc = sub.add_parser(
        "recommend", help="top-K recommendations from checkpointed factors")
    _serving_args(rc, data_help="training data file (raw-id mapping + "
                  "exclude-seen)")
    rc.add_argument("--users", required=True,
                    help="comma-separated raw user ids, or 'all'")
    rc.add_argument("-k", type=int, default=10)
    rc.add_argument("--include-seen", action="store_true",
                    help="do not exclude already-rated movies")
    rc.set_defaults(fn=_recommend)

    pd = sub.add_parser(
        "predict", help="the prediction CSV from checkpointed factors")
    _serving_args(pd, data_help="training data file (raw-id mapping / "
                  "matrix shape)")
    pd.add_argument(
        "--output", default="auto",
        help="'auto' = predictions/prediction_matrix_<ts>, or a path")
    pd.set_defaults(fn=_predict)

    sv = sub.add_parser(
        "serve", help="top-K request server (score + top-K kernel): over a "
        "broker until ^C, or over an in-memory log measured by the "
        "open-loop load generator")
    _serving_args(sv, data_help="training data file (raw-id mapping + "
                  "exclude-seen)")
    sv.add_argument("--broker", default=None, metavar="tcp://HOST:PORT",
                    help="join this broker's serve topics and answer until "
                    "^C; omit for the built-in open-loop load generator "
                    "against an in-memory log")
    sv.add_argument("--replicas", type=int, default=1,
                    help="serving fleet size: N replicas behind the request "
                    "log with user-keyed routing, per-replica /metrics and "
                    "/readyz, admission control, and kill/failover at the "
                    "committed cursor")
    sv.add_argument("--admission-queue", type=int, default=0,
                    help="fleet admission-control queue depth per poll (0 = "
                    "unbounded); backlog beyond it is answered with explicit "
                    "retriable rejections, never dropped")
    sv.add_argument("--request-partitions", type=int, default=1,
                    help="(--broker, one server) request-topic partitions "
                    "when creating it")
    sv.add_argument("--response-partitions", type=int, default=1,
                    help="response-topic partitions when creating it (one "
                    "per client)")
    sv.add_argument("-k", type=int, default=10, help="top-K per request")
    sv.add_argument("--include-seen", action="store_true",
                    help="do not exclude already-rated movies")
    sv.add_argument("--table-dtype", choices=["float32", "bfloat16", "int8"],
                    default="float32",
                    help="item-table quantization: bf16 halves the bytes "
                    "read per batch, int8 + per-row scale quarters them")
    sv.add_argument("--tile-m", type=int, default=2048,
                    help="movie rows per tile of the seen-mask rectangle")
    sv.add_argument("--serve-mode", choices=["exact", "two_stage"],
                    default="exact",
                    help="two_stage probes a k-means centroid index and "
                    "rescores only the probed clusters' rows exactly")
    sv.add_argument("--clusters", type=int, default=0,
                    help="two_stage cluster count (0 = ~sqrt(movies))")
    sv.add_argument("--probe-clusters", type=int, default=0,
                    help="clusters probed per user (0 = the smallest count "
                    "the recall model puts at 0.95)")
    sv.add_argument("--max-batch", type=int, default=256,
                    help="max requests coalesced into one scoring batch")
    sv.add_argument("--loadgen-qps", type=float, default=100.0)
    sv.add_argument("--loadgen-requests", type=int, default=256)
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--metrics-port", type=int, default=None,
                    help="serve GET /metrics (Prometheus text) on this "
                    "port while the server runs (0 = ephemeral)")
    sv.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="write the host span trace (batch assemble/"
                    "compute/respond timeline) here at exit")
    sv.set_defaults(fn=_serve)

    b = sub.add_parser(
        "broker", help="run the port's TCP log broker "
        "(csrc/host/cfk_broker.cpp, built on first use)")
    b.add_argument("--port", type=int, default=29092,
                   help="0 picks an ephemeral port (printed on stdout)")
    b.add_argument("--data-dir", default=None,
                   help="persist logs here (the FileBroker format); default "
                   "is memory-only")
    b.add_argument("--bind", default="127.0.0.1",
                   help="listen address; 0.0.0.0 accepts other hosts")
    b.set_defaults(fn=_broker)

    tp = sub.add_parser(
        "topics", help="broker topic admin (the reference's setup.sh role)")
    tp.add_argument("action", choices=["list", "create", "delete", "recreate"])
    tp.add_argument("--broker", required=True,
                    help="tcp://HOST:PORT (list) or tcp://HOST:PORT/TOPIC")
    tp.add_argument("--partitions", type=int, default=4)
    tp.set_defaults(fn=_topics)

    pr = sub.add_parser(
        "produce", help="stream a Netflix-format ratings file into a broker")
    pr.add_argument("--broker", required=True, help="tcp://HOST:PORT[/TOPIC]")
    pr.add_argument("--data", required=True)
    pr.add_argument("--partitions", type=int, default=4)
    pr.add_argument("--append", action="store_true",
                    help="produce into an existing topic (only sound if "
                    "every earlier produce used --no-eof; EOF means "
                    "end-of-ingest)")
    pr.add_argument("--no-eof", action="store_true",
                    help="skip the EOF fan-out, leaving the topic open for "
                    "more files; the final produce must omit this flag")
    pr.set_defaults(fn=_produce)

    st = sub.add_parser(
        "stream",
        help="exactly-once streaming fold-in: consume rating updates and "
        "fold them into live factors (rate → fold-in → resume)",
    )
    st.add_argument("--data", required=True,
                    help="base ratings (the training corpus the stream "
                    "updates; also the crash replay's state seed)")
    st.add_argument("--format", choices=["netflix", "movielens"],
                    default="netflix")
    st.add_argument("--min-rating", type=float, default=0.0)
    st.add_argument("--updates", required=True,
                    help="the durable updates topic's home: a FileBroker "
                    "directory or tcp://HOST:PORT (the port's broker)")
    st.add_argument("--stream-dir", required=True,
                    help="checkpoint store for the atomic factor+cursor "
                    "commits; re-run with the same dir to resume")
    st.add_argument("--produce-csv", default=None, metavar="FILE",
                    help="producer mode: append 'user,movie,rating' lines "
                    "from FILE to the updates topic and exit")
    st.add_argument("--partitions", type=int, default=1,
                    help="updates-topic partitions when creating it "
                    "(--produce-csv on a fresh topic)")
    st.add_argument("--rank", type=int, default=5)
    st.add_argument("--lam", type=float, default=0.05)
    st.add_argument("--iterations", type=int, default=7,
                    help="base-train / warm-retrain iteration count")
    st.add_argument("--seed", type=int, default=42)
    st.add_argument("--layout", choices=["padded", "tiled"],
                    default="padded",
                    help="base dataset layout; also the fold-in default "
                    "(tiled runs the at-scale kernels, K2 + K1)")
    st.add_argument("--foldin-layout", choices=["auto", "padded", "tiled"],
                    default="auto",
                    help="fold-in solve layout ('auto' follows --layout)")
    st.add_argument("--solver", choices=["auto", "cholesky"],
                    default="auto",
                    help="auto = the CUDA kernels on a GPU (their plain "
                    "PyTorch versions on the CPU); cholesky = the plain "
                    "PyTorch route, with --device cpu only")
    st.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32")
    st.add_argument("--chunk-elems", type=int, default=1 << 20)
    st.add_argument("--batch-records", type=int, default=256,
                    help="log records per partition per micro-batch; part "
                    "of the replay contract (committed with the cursor)")
    st.add_argument("--max-batches", type=int, default=None,
                    help="stop after N micro-batches (default: drain)")
    st.add_argument("--follow", action="store_true",
                    help="keep polling an idle topic instead of exiting "
                    "when caught up")
    st.add_argument("--retrain-every", type=int, default=None, metavar="N",
                    help="warm full retrain (movie side included) every N "
                    "stream commits, current factors as the seed")
    st.add_argument("--health-check-every", type=int, default=1,
                    help="probe every fold-in batch before commit "
                    "(default 1; the ladder escalates on trips and "
                    "quarantines batches that defeat it)")
    st.add_argument("--health-norm-limit", type=float, default=1e6)
    st.add_argument("--max-recoveries", type=int, default=4)
    st.add_argument("--lam-escalation", type=float, default=10.0)
    st.add_argument("--on-unrecoverable", choices=["degrade", "raise"],
                    default="degrade")
    st.add_argument("--keep-last-n", type=int, default=8,
                    help="stream commits retained (per-batch commits grow "
                    "fast; default 8, None-like large values keep more)")
    st.add_argument("--no-preempt-save", action="store_true")
    st.add_argument("--prewarm", action="store_true",
                    help="walk the padded fold-in's pow2 bucket grid before "
                    "the first batch: the first real micro-batch then meets "
                    "no new fold-in program (padded fold layout)")
    st.add_argument("--metrics-port", type=int, default=None,
                    help="serve GET /metrics (Prometheus text) on this "
                    "port while the stream runs (0 = ephemeral)")
    st.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="write the host span trace (stream batch stage/"
                    "solve/probe/commit timeline) here at exit")
    st.add_argument("--no-eval", action="store_true",
                    help="skip the merged-state RMSE evaluation at exit")
    st.add_argument("--dataset-cache", default=None)
    st.add_argument("--metrics", choices=["json", "logfmt"],
                    default="logfmt")
    st.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    st.set_defaults(fn=_stream)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, OSError, KeyError, RuntimeError) as e:
        # Input, device and kernel errors end the command with one line.
        _eprint(f"error: {type(e).__name__}: {e}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
