"""The command's refusals: no result without the program beside the
benchmark, and none without a card."""
import shutil
import subprocess
import sys

import pytest
import torch

from bench.common import BENCH, ROOT

ARGS = ["--workload", "train-stablelm-ps-4k", "--seed", str(2 ** 31 + 3),
        "--seconds", "1", "--trace", "0"]


def run(cwd):
    return subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin"})


def test_no_result_with_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = run(tmp_path)
    assert res.returncode != 0 and "{" not in res.stdout, res


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    res = run(ROOT)
    assert res.returncode != 0 and "{" not in res.stdout, res
    assert "CUDA" in res.stderr
