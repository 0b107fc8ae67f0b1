"""Command-line interface of the port: ``python -m cfk_tpu_torch <verb>``.

- ``run`` — the reference's positional form (``apps/ALSAppRunner.java:16-28``):
  ``NUM_PARTITIONS NUM_FEATURES LAMBDA NUM_ITERATIONS PATH NUM_MOVIES
  NUM_USERS``.  Entity counts come from the data (the passed ones are
  cross-checked and warned about); NUM_PARTITIONS has no meaning on one
  device and is ignored with a warning.
- ``train`` — full-flag training of explicit ALS-WR on a Netflix-format
  file: layout (``auto`` = padded below 2M ratings, tiled above, as
  ``cfk_tpu/cli.py:63-79``), rank, λ, iterations, seed, chunk budget,
  solver route, device and prediction-CSV output.
- ``evaluate`` — offline MSE/RMSE of a prediction CSV against a ratings file.

Training runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

AUTO_LAYOUT_TILED_NNZ = 2_000_000  # at and above this, the tiled layout


def _eprint(*args) -> None:
    print(*args, file=sys.stderr)


def resolve_auto_layout(num_ratings: int) -> str:
    """layout='auto': one padded rectangle for small data, the tiled layout
    (accum + dense stream) once the data is big enough for it to matter."""
    return "tiled" if num_ratings >= AUTO_LAYOUT_TILED_NNZ else "padded"


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


def _train(args) -> int:
    import torch

    from cfk_tpu_torch.config import ALSConfig
    from cfk_tpu_torch.data.blocks import Dataset
    from cfk_tpu_torch.data.netflix import parse_netflix
    from cfk_tpu_torch.device import resolve_device
    from cfk_tpu_torch.eval.metrics import mse_rmse_from_model
    from cfk_tpu_torch.models.als import train_als

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    coo = parse_netflix(args.data)
    layout = (resolve_auto_layout(coo.num_ratings) if args.layout == "auto"
              else args.layout)
    ds = Dataset.from_coo(coo, layout=layout, chunk_elems=args.chunk_elems)
    prep_s = time.perf_counter() - t0
    config = ALSConfig(rank=args.rank, lam=args.lam,
                       num_iterations=args.iterations, seed=args.seed,
                       layout=layout, solver=args.solver,
                       hbm_chunk_elems=args.chunk_elems)
    t0 = time.perf_counter()
    model = train_als(ds, config, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    mse, rmse = mse_rmse_from_model(model, ds)
    _eprint(f"train MSE={mse:.4f} RMSE={rmse:.4f}")
    if args.output != "none":
        path = _save_predictions(
            model, None if args.output == "auto" else args.output)
        if path is not None:
            _eprint(f"predictions written to {path}")
    print(f"layout={layout} device={dev} num_ratings={coo.num_ratings} "
          f"prep_s={prep_s:.3f} train_s={train_s:.3f} "
          f"s_per_iter={train_s / args.iterations:.4f} mse={mse:.6f} "
          f"rmse={rmse:.6f}")
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
    t.add_argument("--format", choices=["netflix"], default="netflix")
    t.add_argument("--rank", type=int, default=5)
    t.add_argument("--lam", type=float, default=0.05)
    t.add_argument("--iterations", type=int, default=7)
    t.add_argument("--seed", type=int, default=42)
    t.add_argument(
        "--layout", choices=["auto", "padded", "tiled"], default="auto",
        help="InBlock layout: one rectangle per side (padded) or accum + "
        "dense-stream tiles (tiled). Default 'auto': padded below 2M "
        "ratings, tiled above",
    )
    t.add_argument(
        "--chunk-elems", type=int, default=1 << 20,
        help="gather-cell budget per chunk: the tiled layout's chunk size "
        "at build time; padded derives entities per solve chunk from it",
    )
    t.add_argument(
        "--solver", choices=["auto", "cholesky"], default="auto",
        help="auto = the CUDA kernels on a GPU (their plain PyTorch "
        "versions on the CPU); cholesky = the plain PyTorch route "
        "(torch.linalg.cholesky), with --device cpu only",
    )
    t.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    t.add_argument(
        "--output", default="auto",
        help="'auto' = predictions/prediction_matrix_<ts>, 'none', or a path",
    )
    t.set_defaults(fn=_train)

    e = sub.add_parser("evaluate", help="offline MSE/RMSE of a prediction CSV")
    e.add_argument("ratings_file")
    e.add_argument("prediction_csv")
    e.set_defaults(fn=_evaluate)
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
