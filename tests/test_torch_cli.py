"""The port's CLI (``python -m cfk_tpu_torch``) on the CPU, against cfk_tpu's
evaluator on the same prediction CSV."""

import numpy as np
import pytest

from cfk_tpu.cli import main as j_main
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu_torch.cli import main, resolve_auto_layout


@pytest.fixture(scope="module")
def ratings_file(tmp_path_factory):
    coo = synthetic_netflix_coo(300, 60, 3000, seed=4)
    path = tmp_path_factory.mktemp("cli") / "ratings.txt"
    with open(path, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            for uid, r in zip(coo.user_raw[sel], coo.rating[sel]):
                f.write(f"{uid},{int(r)},2005-09-06\n")
    return str(path)


def _fields(out: str) -> dict:
    return dict(kv.split("=", 1) for kv in out.split() if "=" in kv)


def test_train_then_evaluate(ratings_file, tmp_path, capsys):
    preds = str(tmp_path / "preds.csv")
    assert main(["train", "--data", ratings_file, "--rank", "4",
                 "--iterations", "3", "--device", "cpu", "--output",
                 preds]) == 0
    fields = _fields(capsys.readouterr().out)
    assert fields["layout"] == "padded"  # auto: below 2M ratings
    assert main(["evaluate", ratings_file, preds]) == 0
    out = capsys.readouterr().out
    mse = float(out.split("MSE:")[1].split()[0])
    assert abs(mse - float(fields["mse"])) <= 1e-5 * mse
    # cfk_tpu's evaluator reads the port's CSV to the same number.
    assert j_main(["evaluate", ratings_file, preds]) == 0
    jmse = float(capsys.readouterr().out.split("MSE:")[1].split()[0])
    assert abs(jmse - mse) <= 1e-12 * mse


def test_tiled_train(ratings_file, capsys):
    assert main(["train", "--data", ratings_file, "--rank", "4",
                 "--iterations", "2", "--layout", "tiled", "--chunk-elems",
                 "512", "--device", "cpu", "--output", "none"]) == 0
    fields = _fields(capsys.readouterr().out)
    assert fields["layout"] == "tiled" and float(fields["rmse"]) < 1.5


def test_reference_positional_form(ratings_file, tmp_path, monkeypatch,
                                   capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["run", "4", "4", "0.05", "2", ratings_file, "1", "1",
                 "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    assert "MSE:" in cap.out and "RMSE:" in cap.out
    # NUM_PARTITIONS trains that many ranks (no longer ignored).
    assert "# mesh: 4 ranks" in cap.err and "ignored" not in cap.err
    assert "NUM_MOVIES=1 but data has 60" in cap.err
    assert (tmp_path / "predictions").is_dir()


def test_cuda_without_cuda_is_an_error(ratings_file, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["train", "--data", ratings_file, "--output", "none"]) == 1
    assert "is_available() is False" in capsys.readouterr().err


def test_auto_layout_threshold():
    assert resolve_auto_layout(1_999_999) == "padded"
    assert resolve_auto_layout(2_000_000) == "tiled"
