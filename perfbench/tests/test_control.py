"""The control of each cell's check comes out not correct: the plain
reference one precision step below the configuration's (float8 e4m3 for
bfloat16) in the program's place (``control.py``).

On the card, at the cell's own size, on three seeds: every seed fails
at least one number of the cell's limits.  On the CPU, at tiny widths,
the control reads far above a sound run of the program on the same
seed (the full-size limits do not apply there)."""

import pytest
import torch

from perfbench import control, harness
from perfbench.run import compare
from perfbench.tests import tiny

CELLS = [w['name'] for w in harness.manifest()['workloads']]
SEEDS = (4000000001, 4000000002, 4000000003)


@pytest.mark.chip
@pytest.mark.parametrize('name', CELLS)
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: run on the card')
    cell = harness.Cell(name)
    for seed, numbers in control.readings(cell, SEEDS):
        ok, checked = compare(numbers, cell.limits)
        assert not ok, (seed, checked)


@pytest.mark.parametrize('name', CELLS)
def test_control_reads_above_the_program_on_the_cpu(name):
    c = tiny.cell(name)
    seed = 2 ** 31 + 21
    sound = c.loop().run(tiny.context(c, seed))['check']
    (_, low), = control.readings(c, [seed], device='cpu')
    assert any(low[k] > 100 * max(sound[k], 1e-6) for k in low), (low,
                                                                    sound)
