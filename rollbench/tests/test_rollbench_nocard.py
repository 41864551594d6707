"""Without a card the command fails and prints no result, and it finds no
program in a directory that holds only BENCHMARK.json and rollbench/:
there is no fallback."""

import os
import shutil
import subprocess
import sys

import pytest

from rollbench import harness

ARGS = ["--workload", "tx_b2_d6.prove", "--seed", "4294967311",
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "rollbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_no_card_no_result(no_card):
    out = _run(harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "rollbench"),
                    tmp_path / "rollbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
