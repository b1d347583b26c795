"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration
(``configs/<name>.json``: the options the program runs, its weights'
init, its plain reference ``reference/<reference>.py`` and its FLOP model
``flops/<reference>.py``) and a traffic mix (``traffic/<name>.json``:
the loop that drives the program, ``loops/<loop>.py``, its parameters and
the check that decides ``correct``, ``checks/<check>.py``).  A cell's
limits are ``limits/<cell>.json``.  Each metric is read by
``metrics/<metric name>.py``.  Nothing here knows a cell, a configuration
or a metric by name: a later change adds one by adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the modules no process of the benchmark may hold, compared by their
# whole top-level names
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'captioning_tpu')


def manifest(root=ROOT):
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        return json.load(f)


def module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` (a name may hold dots)."""
    path = os.path.join(HERE, kind, name + '.py')
    spec = importlib.util.spec_from_file_location(
        'perfbench.%s.%s' % (kind, name.replace('.', '_')), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reported(metric, cell_name: str) -> bool:
    """Whether a metric entry is reported in a cell: in the cells of its
    ``workloads``, or in every cell without one."""
    return cell_name in metric.get('workloads', (cell_name,))


class Cell:
    """One workload of the manifest with its files loaded."""

    def __init__(self, name: str, man=None):
        man = man or manifest()
        cells = {w['name']: w for w in man['workloads']}
        if name not in cells:
            raise KeyError('no workload %r in BENCHMARK.json (%s)'
                           % (name, ', '.join(sorted(cells))))
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry['chips'])
        configs = {c['name']: c for c in man['configs']}
        cfg = configs[self.entry['config']]
        with open(os.path.join(ROOT, cfg['file'])) as f:
            self.config = json.load(f)
        with open(os.path.join(HERE, 'traffic',
                               self.entry['traffic'] + '.json')) as f:
            self.traffic = json.load(f)
        self.e2e = [m for m in man['end_to_end'] if reported(m, name)]
        self.per_layer = [m for m in man['per_layer'] if reported(m, name)]
        path = os.path.join(HERE, 'limits', name + '.json')
        self.limits = None
        if os.path.isfile(path):
            with open(path) as f:
                self.limits = json.load(f)

    @property
    def options(self):
        return dict(self.config['options'])

    def reference(self):
        return importlib.import_module('perfbench.reference.'
                                       + self.config['reference'])

    def flops(self):
        return module('flops', self.config['reference'])

    def loop(self):
        return module('loops', self.traffic['loop'])

    def check(self):
        return module('checks', self.traffic['check'])


def read_metrics(entries, record):
    """{name: {'value', 'unit'}} of the metrics whose readers find
    something to read in the run's ``record``."""
    out = {}
    for m in entries:
        value = module('metrics', m['name']).read(record)
        if value is not None:
            out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out


def forbidden_modules(modules):
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(n for n in modules if n.split('.')[0] in FORBIDDEN)
