"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names."""

import json
import os
import re

import pytest

from perfbench import harness

MAN = harness.manifest()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
KEYS = {
    'top': {'command', 'paths', 'run_seconds', 'configs', 'workloads',
            'end_to_end', 'per_layer'},
    'configs': {'name', 'source', 'file', 'reduced', 'why'},
    'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}
WIDTH = re.compile(r'(_dim|_rank)$|size|hidden|d_model|d_ff|heads|width')


def _line(text):
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_keys_and_sizes():
    assert set(MAN) == KEYS['top']
    assert len(json.dumps(MAN)) <= 64 * 1024
    for kind in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        allowed = KEYS[kind] | ({'workloads'} if kind in (
            'end_to_end', 'per_layer') else set())
        for e in MAN[kind]:
            assert KEYS[kind] <= set(e) <= allowed, e
    assert 1 <= len(MAN['configs']) <= 24
    assert 1 <= len(MAN['workloads']) <= 24
    assert 1 <= len(MAN['end_to_end']) <= 16
    assert 1 <= len(MAN['per_layer']) <= 128
    assert 1 <= MAN['run_seconds'] <= 51
    assert isinstance(MAN['run_seconds'], int)


def test_command_and_paths():
    cmd, paths = MAN['command'], MAN['paths']
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    for w in cmd:
        if '/' in w:
            assert not w.startswith('/') and '..' not in w
            assert any(w.startswith(p + '/') for p in paths), w


def test_names_units_and_text():
    names = []
    for kind in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for e in MAN[kind]:
            assert NAME.match(e['name']), e['name']
            names.append((kind, e['name']))
            if 'unit' in e:
                assert UNIT.match(e['unit']), e['unit']
                assert e['better'] in ('lower', 'higher')
            for key in ('why', 'layer'):
                if key in e:
                    assert _line(e[key]), (e['name'], key)
    for kind in ('configs', 'workloads'):
        got = [n for k, n in names if k == kind]
        assert len(got) == len(set(got))
    metrics = [n for k, n in names if k in ('end_to_end', 'per_layer')]
    assert len(metrics) == len(set(metrics))
    for c in MAN['configs']:
        assert _line(c['source']) and c['source'].startswith('https://')
        assert len(c['reduced']) <= 16
        for key in c['reduced']:
            assert NAME.match(key) and not WIDTH.search(key), key


def test_cells_and_their_files():
    configs = {c['name']: c for c in MAN['configs']}
    pairs = set()
    files = set()
    for c in MAN['configs']:
        assert c['file'].startswith(MAN['paths'][0] + '/')
        assert c['file'] not in files
        files.add(c['file'])
        cfg = json.load(open(os.path.join(harness.ROOT, c['file'])))
        assert cfg['name'] == c['name']
        assert os.path.isfile(os.path.join(
            harness.HERE, 'reference', cfg['reference'] + '.py'))
        assert os.path.isfile(os.path.join(
            harness.HERE, 'flops', cfg['reference'] + '.py'))
        assert set(c['reduced']) <= set(cfg['options'])
    used = set()
    for w in MAN['workloads']:
        assert w['config'] in configs and NAME.match(w['traffic'])
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))
        used.add(w['config'])
        assert w['chips'] in (1, 4)
        assert _line(w['why'])
        cell = harness.Cell(w['name'], MAN)
        for kind, name in (('loops', cell.traffic['loop']),
                           ('checks', cell.traffic['check'])):
            assert os.path.isfile(os.path.join(harness.HERE, kind,
                                               name + '.py'))
    assert used == set(configs)
    four = sum(w['chips'] == 4 for w in MAN['workloads'])
    assert four <= max(1, len(MAN['workloads']) // 4)


def test_metrics_and_what_they_move():
    e2e = {m['name']: m for m in MAN['end_to_end']}
    assert 'setup_s' in e2e
    for m in MAN['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    cells = [w['name'] for w in MAN['workloads']]
    for m in MAN['per_layer']:
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert m['moves'] in e2e and _line(m['layer'])
        assert m['workloads']
        for cell in m['workloads']:
            assert cell in cells
            assert harness.reported(e2e[m['moves']], cell), \
                (m['name'], cell)
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'
    for kind in ('end_to_end', 'per_layer'):
        for m in MAN[kind]:
            assert os.path.isfile(os.path.join(harness.HERE, 'metrics',
                                               m['name'] + '.py'))


@pytest.mark.parametrize('cell', [w['name'] for w in MAN['workloads']])
def test_every_cell_reports_what_it_must(cell):
    c = harness.Cell(cell, MAN)
    names = {m['name'] for m in c.e2e}
    assert 'setup_s' in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m['moves'] in names
    # each layer's name is spelt the same wherever it appears
    layers = {}
    for m in MAN['per_layer']:
        layers.setdefault(m['name'].split('.')[0], set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize('cell', [w['name'] for w in MAN['workloads']])
def test_limits_exist(cell):
    c = harness.Cell(cell, MAN)
    assert c.limits and all(v > 0 for v in c.limits.values())


def test_check_length_fits():
    """2 + 14 runs a cell at 24 cells, each run_seconds + 60 s, 2 x 90 s
    of compile a cell and 1200 s spare fit in 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (MAN['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200
