"""The command's refusals: no result line and a non-zero exit without a
card, and in a directory that holds only the benchmark."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import harness

ARGS = ['--workload', 'transformer.eval_beam5', '--seed', '2147483653',
        '--seconds', '1', '--trace', '0']


def _run(root):
    return subprocess.run([sys.executable, 'perfbench/run.py'] + ARGS,
                          cwd=root, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    p = _run(harness.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ''
    assert 'CUDA device' in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / 'perfbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(harness.ROOT, 'BENCHMARK.json'), tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ''
