"""The port's bench (``captioning_tpu_torch/tools/bench.py``) on the CPU at
small widths and 2 iterations: the headline JSON line with its keys and
the six suite rows (the train rows in float32 and, since bf16 training
with float32 masters is ported, in bf16); a failing row is printed with its error and makes
the exit code non-zero; an unknown card has no peak.  Speeds come only
from the card (``chip_smoke.py`` phase 12)."""

import json

import pytest

from captioning_tpu_torch.tools import bench

ARGS = ['--device', 'cpu', '--small', '--batch', '4', '--iters', '2']
HEAD_KEYS = {'metric', 'value', 'unit', 'mfu_pct', 'capture_s', 'batch',
             'dtype', 'device', 'card', 'batch_s_median', 'batch_s_min',
             'batch_s_max', 'iters', 'device_ms_median'}
ROWS = ('greedy_cap_s', 'updown_beam5_cap_s', 'xe_img_s',
        'scst_fused_s_iter', 'xe_img_s_bf16', 'scst_fused_s_iter_bf16')


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{')]


def test_bench_prints_the_headline_and_the_suite(capsys):
    head, rows, rc = bench.main(ARGS)
    lines = _lines(capsys)
    assert rc == 0
    assert lines[0] == head and set(head) == HEAD_KEYS
    assert head['metric'] == 'captions_per_sec_per_chip_beam5_transformer'
    assert head['unit'] == 'captions/s' and head['value'] > 0
    # no device on the CPU: no MFU, no device time, no card
    assert head['mfu_pct'] is None and head['device_ms_median'] is None
    assert head['device'] == 'cpu' and head['card'] is None
    assert (head['batch_s_min'] <= head['batch_s_median']
            <= head['batch_s_max'])
    assert [r['row'] for r in lines[1:]] == list(ROWS) == list(rows)
    for r in lines[1:]:
        assert r['value'] > 0 and r['iters'] == 2
        assert r['batch_s_min'] <= r['batch_s_median'] <= r['batch_s_max']
    assert rows['xe_img_s']['dtype'] == 'float32'
    assert rows['scst_fused_s_iter']['dtype'] == 'float32'
    assert rows['scst_fused_s_iter']['unit'] == 's/iter'
    assert rows['xe_img_s']['batch'] == [4, 5, bench.XE_LEN]
    assert rows['xe_img_s_bf16']['dtype'] == 'bfloat16'
    assert rows['scst_fused_s_iter_bf16']['dtype'] == 'bfloat16'
    assert rows['xe_img_s_bf16']['batch'] == rows['xe_img_s']['batch']
    assert set(rows['xe_img_s_bf16']) == set(rows['xe_img_s'])


def test_a_failing_row_is_printed_and_fails_the_bench(capsys, monkeypatch):
    from captioning_tpu_torch.modules.trainer import Trainer

    def broken(*a, **kw):
        raise RuntimeError('broken step')
    monkeypatch.setattr(Trainer, 'sc_fused_step', broken)
    _, rows, rc = bench.main(ARGS)
    assert rc == 1
    assert 'broken step' in rows['scst_fused_s_iter']['error']
    assert 'broken step' in rows['scst_fused_s_iter_bf16']['error']
    printed = {r['row']: r for r in _lines(capsys)[1:]}
    assert printed['scst_fused_s_iter'] == dict(
        row='scst_fused_s_iter', **rows['scst_fused_s_iter'])
    assert 'error' not in rows['xe_img_s']


def test_suite_off(capsys):
    _, rows, rc = bench.main(ARGS + ['--suite', '0'])
    assert rc == 0 and rows == {} and len(_lines(capsys)) == 1


def test_unknown_card_has_no_peak():
    assert bench.peak_bf16_tflops('NVIDIA H100 80GB HBM3') == 989.4
    with pytest.raises(KeyError, match='no published bf16 peak'):
        bench.peak_bf16_tflops('Some Other Card')
