"""Command-line interface of the port: ``python -m cfk_tpu_torch <verb>``.

- ``run`` — the reference's positional form (``apps/ALSAppRunner.java:16-28``):
  ``NUM_PARTITIONS NUM_FEATURES LAMBDA NUM_ITERATIONS PATH NUM_MOVIES
  NUM_USERS``.  Entity counts come from the data (the passed ones are
  cross-checked and warned about); NUM_PARTITIONS has no meaning on one
  device and is ignored with a warning.
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
  ``--checkpoint-journal DIR --journal-partitions N`` journals the factors
  as FeatureRecord frames through a FileBroker directory instead (the
  reference's topics-as-checkpoint store; exclusive with
  ``--checkpoint-dir``).
- ``evaluate`` — offline MSE/RMSE of a prediction CSV against a ratings file.
- ``recommend`` — top-K movies for given users from checkpointed factors
  (``--checkpoint-dir``: ``train --checkpoint-dir``, or the JAX package's
  checkpoint directory; or ``--checkpoint-journal``: a journal either
  package wrote).
- ``predict`` — the prediction CSV from checkpointed factors, no training.
- ``serve`` — the top-K request server over an in-memory log, driven by the
  built-in open-loop load generator; prints one JSON row (QPS, p50, p99);
  ``--metrics-port`` serves ``GET /metrics`` (Prometheus text) while it
  runs, ``--trace-dir`` writes its host span trace.
- ``stream`` — exactly-once streaming fold-in: consume rating updates from
  a FileBroker directory (``--updates``), fold each micro-batch into the
  live factors on the card, commit factors + offset cursor atomically in
  ``--stream-dir``; re-running resumes.  ``--produce-csv`` is the producer
  side.

Everything runs on CUDA unless ``--device cpu`` is given.  The reference's
``tcp://HOST:PORT`` targets (``--updates``, ``--checkpoint-journal``,
``train --data``) need its TCP broker transport, which the port does not
have yet: they exit 2 and nothing falls back.
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


_TCP_MISSING = (
    "{what} {url!r}: tcp:// targets need the TCP broker transport "
    "(cfk_tpu's transport/tcp.py), which the port does not have yet; "
    "use a FileBroker directory"
)


def _refuse_tcp(what: str, url: str | None) -> bool:
    """True (after printing the error) when ``url`` is a ``tcp://`` target:
    the caller exits 2 — nothing falls back to another transport."""
    if url and url.startswith("tcp://"):
        _eprint("error: " + _TCP_MISSING.format(what=what, url=url))
        return True
    return False


def _file_broker(directory: str, *, fsync: bool):
    """The FileBroker of a --checkpoint-journal or --updates directory (the
    caller has refused ``tcp://`` targets)."""
    from cfk_tpu_torch.transport.filelog import FileBroker

    return FileBroker(directory, fsync=fsync)


def _make_checkpoint_manager(args):
    """The checkpoint store the train flags select: the npz directory
    (``--checkpoint-dir``, the fast local default), the transport journal
    (``--checkpoint-journal``, factors as FeatureRecord frames through a
    FileBroker directory — the reference's topics-as-durable-checkpoint
    design, ``setup.sh:18-21``), or None.  Returns an int exit code on
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

        if _refuse_tcp("--checkpoint-journal", journal):
            return 2
        try:
            # fsync per append for the training journal: the commit marker
            # must never reach disk before the factor frames it commits.
            transport = _file_broker(journal, fsync=True)
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
    """Parse ``path`` and build its ``Dataset`` (``build``: the
    ``Dataset.from_coo`` keywords, ``layout`` possibly "auto",
    ``auto_resolver(coo)`` resolving it) — or load it from the dataset
    cache ``cache_dir``.  The port of ``cfk_tpu/cli.py:82-242``
    ``_load_dataset`` for file data, one shard: the cache's build key is
    the JAX package's (the data path, size and mtime, the format, the
    layout flags), so a cache either package wrote for the same file and
    flags serves both; a key that does not match is rebuilt and
    overwritten, and a cache whose source file is gone still serves a key
    that matches on everything else."""
    from cfk_tpu_torch.data.blocks import Dataset, TiledBlocks

    layout, dense_stream = build["layout"], build.get("dense_stream", False)
    build_key = {
        "data": os.path.abspath(path),
        "format": fmt,
        "min_rating": min_rating,
        "num_shards": 1,
        "pad_multiple": build["pad_multiple"],
        "layout": layout,
        "chunk_elems": build["chunk_elems"],
    }
    if dense_stream and layout == "tiled":
        build_key["dense_stream"] = True
    if layout == "auto" and auto_key:
        build_key.update(auto_key)
    # For layout='auto' the dense flag changes the blocks only when the
    # resolution lands on tiled: saves record it iff the resolved build
    # consumed it, loads accept the flagless key too unless that cache is
    # tiled (a flagless tiled cache is a padded-stream build).
    auto_dense = dense_stream and layout == "auto"
    if os.path.exists(path):
        st = os.stat(path)
        build_key["data_size"] = st.st_size
        build_key["data_mtime_ns"] = st.st_mtime_ns
    else:
        ds = _cache_sans_fingerprint(cache_dir, build_key, auto_dense)
        if ds is not None:
            _eprint(f"warning: data file {path!r} not found; using dataset "
                    "cache without the size/mtime freshness check")
            return ds
    if cache_dir and os.path.exists(os.path.join(cache_dir, "meta.json")):
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
                err = ValueError("cached auto-layout dataset resolved to "
                                 "tiled without the dense stream; dense run "
                                 "rebuilds")
                continue
            _eprint(f"# dataset cache hit ({time.time() - t0:.1f}s load)")
            return ds
        _eprint(f"warning: ignoring dataset cache: {err}")
    coo = _parse_ratings(path, fmt, min_rating)
    resolved = auto_resolver(coo) if layout == "auto" else layout
    use_dense = dense_stream and resolved == "tiled"
    ds = Dataset.from_coo(coo, **{**build, "layout": resolved,
                                  "dense_stream": use_dense})
    if cache_dir:
        key = ({**build_key, "dense_stream": True}
               if auto_dense and use_dense else build_key)
        ds.save(cache_dir, build_key=key)
    return ds


def _cache_sans_fingerprint(cache_dir, build_key, auto_dense=False):
    """The cache at ``cache_dir`` when the data file it was built from is
    gone, if its stored build key matches ``build_key`` on every field but
    the file's size and mtime (``cfk_tpu/cli.py:245-283``); else None."""
    from cfk_tpu_torch.data.blocks import Dataset, TiledBlocks
    from cfk_tpu_torch.data.cache import read_build_key

    if not cache_dir or not os.path.exists(os.path.join(cache_dir,
                                                        "meta.json")):
        return None
    try:
        stored = read_build_key(cache_dir)
        if stored is None:
            return None
        ignore = ("data_size", "data_mtime_ns")
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
    if args.num_partitions > 1:
        _eprint(f"warning: NUM_PARTITIONS={args.num_partitions} ignored "
                "(the port trains on one device)")
    ds = Dataset.from_coo(coo)
    if ds.movie_map.num_entities != args.num_movies:
        _eprint(f"warning: NUM_MOVIES={args.num_movies} but data has "
                f"{ds.movie_map.num_entities} rated movies (using the data)")
    if ds.user_map.num_entities != args.num_users:
        _eprint(f"warning: NUM_USERS={args.num_users} but data has "
                f"{ds.user_map.num_entities} rated users (using the data)")
    config = ALSConfig(rank=args.num_features, lam=args.lam,
                       num_iterations=args.num_iterations)
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

    if _refuse_tcp("--data", args.data):
        return 2
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
    common = dict(rank=args.rank, lam=args.lam,
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
                  on_unrecoverable=args.on_unrecoverable)
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
    build = dict(layout=args.layout, chunk_elems=args.chunk_elems,
                 pad_multiple=args.pad_multiple,
                 dense_stream=args.algorithm not in ("als++", "ials++"))
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
    journal directory; an empty or uncommitted one prints the error and
    gives None, exit 2, as the reference's does)."""
    if bool(args.checkpoint_dir) == bool(args.checkpoint_journal):
        _eprint("error: pass exactly one of --checkpoint-dir / "
                "--checkpoint-journal")
        return None
    if args.checkpoint_dir:
        from cfk_tpu_torch.transport.checkpoint import CheckpointManager

        return CheckpointManager(args.checkpoint_dir).restore()
    if _refuse_tcp("--checkpoint-journal", args.checkpoint_journal):
        return None
    from cfk_tpu_torch.transport.journal import JournalCheckpointManager

    try:
        transport = _file_broker(args.checkpoint_journal, fsync=False)
        return JournalCheckpointManager(transport).restore()
    except (ValueError, OSError) as e:
        # An empty or uncommitted journal is a common operator mistake; a
        # clean error beats a traceback.
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
    """The request server over an in-memory log, driven by the open-loop
    load generator at --loadgen-qps for --loadgen-requests requests; prints
    one JSON row of the measured QPS and latency.  ``--metrics-port``
    serves the server's registry on ``GET /metrics`` while it runs;
    ``--trace-dir`` writes the host span trace."""
    with _telemetry_session(args):
        return _serve_impl(args)


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

    served = _serving_model(args)
    if served is None:
        return 2
    ds, model, _ = served
    engine = engine_from_model(
        model, None if args.include_seen else ds,
        table_dtype=args.table_dtype, tile_m=args.tile_m,
        serve_mode=args.serve_mode, clusters=args.clusters or None,
        probe_clusters=args.probe_clusters or None)
    if engine.serve_mode == "two_stage":
        _eprint(f"two-stage retrieval: {engine.clusters} clusters, "
                f"{engine.probe_clusters} probed per user (the exact scan "
                "stays the fault fallback)")
    warm = engine.prewarm(args.k, max_batch=args.max_batch)
    _eprint(f"prewarmed {warm['programs']} batch sizes in "
            f"{warm['prewarm_s']:.2f}s")
    transport = InMemoryBroker()
    ensure_serve_topics(transport)
    server = RecommendServer(engine, transport, max_batch=args.max_batch,
                             metrics_port=args.metrics_port)
    if server.metrics_server is not None:
        _eprint(f"metrics endpoint: {server.metrics_server.url}")
    try:
        client = ServeClient(transport)
        pool = zipf_user_rows(ds.user_map.num_entities,
                              args.loadgen_requests, seed=args.seed)
        warm_serve_programs(client, server, pool, args.k,
                            min(args.max_batch, pool.shape[0]))
        report = run_open_loop(
            client, rate_qps=args.loadgen_qps,
            num_requests=args.loadgen_requests, user_rows=pool, k=args.k,
            server=server, drive_server=True)
    finally:
        server.close()
    print(json.dumps({
        "users": ds.user_map.num_entities,
        "movies": ds.movie_map.num_entities,
        "k": args.k,
        "table_dtype": engine.table_dtype,
        "serve_mode": engine.serve_mode,
        "device": str(engine.device),
        **report.as_row(),
    }))
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

    if _refuse_tcp("--updates", args.updates):
        return 2
    try:
        # fsync'd appends: the updates topic is the system of record the
        # crash replay consumes.
        transport = _file_broker(args.updates, fsync=True)
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
    p.add_argument("--checkpoint-journal", default=None, metavar="DIR",
                   help="serve from a transport journal instead "
                   "(train --checkpoint-journal: a FileBroker directory "
                   "either package wrote); exactly one of the two stores")
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
    t.add_argument("--data", required=True)
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
        "--checkpoint-journal", default=None, metavar="DIR",
        help="journal factors as FeatureRecord frames through a FileBroker "
        "directory (the reference's topics-as-checkpoint design); "
        "mutually exclusive with --checkpoint-dir")
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
        "serve", help="top-K request server (score + top-K kernel) over an "
        "in-memory log, measured by the open-loop load generator")
    _serving_args(sv, data_help="training data file (raw-id mapping + "
                  "exclude-seen)")
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
                    "directory (tcp://HOST:PORT needs the TCP broker "
                    "transport, which the port does not have yet)")
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
