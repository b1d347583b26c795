"""Run one cell of the benchmark once, from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell is an entry of ``BENCHMARK.json``'s ``workloads``
(``harness.py``).  Set-up (weights and inputs from the seed, the warm-up
of the cell's own shapes) is timed from the process start; then the
window runs for ``--seconds``; with ``--trace 1`` the per-layer metrics
are read (spans, the program's counters, a profiled sub-window after the
window).  Then the check judges what the window produced against the
plain reference.  The last line of standard output is the result: one
JSON object with ``correct``, ``attempted``, ``failed``, ``metrics``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``: each number compared with its limit, also printed as the last
lines of standard error.

Without a CUDA device, with fewer than the cell asks for, without the
program beside this directory, or with JAX or the JAX package loaded
once the window has closed, the run exits non-zero and prints no result.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = 'captioning_tpu_torch'
# every build and kernel cache inside the checkout, at fixed paths (the
# program's nvcc libraries go to build/kernels by its own rule)
os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, 'build', 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(ROOT, 'build',
                                                  'torch_extensions')
os.environ['USE_FLAX'] = '0'
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class Context:
    """What a loop reads of the run: the cell, the arguments, the device
    and its helpers (a CPU context serves the tests)."""

    def __init__(self, cell, seed, seconds, trace, device='cuda', t0=None):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.T0 = T0 if t0 is None else t0
        self.options = cell.options
        self.traffic = cell.traffic
        self.tmpdir = tempfile.gettempdir()

    @property
    def cuda(self):
        return self.device != 'cpu'

    def sync(self):
        import torch
        if self.cuda:
            torch.cuda.synchronize()

    def memory_peak(self):
        import torch
        return torch.cuda.max_memory_allocated() if self.cuda else 0

    def empty_cache(self):
        import torch
        if self.cuda:
            torch.cuda.empty_cache()

    def profile(self, fn):
        from perfbench import trace
        return trace.profile(fn, self.tmpdir)


def card_power_limit():
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return 'unknown'


def compare(check, limits):
    """(correct, {name: {'value', 'limit'}}): every number the limits name
    at or under its limit; no limits at all is not correct.  The check's
    other numbers are readings, given beside and never compared."""
    if not limits:
        return False, {k: {'value': v, 'limit': None}
                       for k, v in check.items()}
    out = {k: {'value': check[k], 'limit': limits[k]} for k in limits}
    ok = all(v['value'] <= v['limit'] for v in out.values())
    return ok, out


def result(cell, ctx, rec, device_name, count):
    """The result line of a finished run."""
    from perfbench import harness
    entries = cell.per_layer if ctx.trace else cell.e2e
    correct, checked = compare(rec['check'], cell.limits)
    line = {'correct': correct, 'attempted': int(rec['attempted']),
            'failed': int(rec['failed']),
            'metrics': harness.read_metrics(entries, rec),
            'device': {'platform': 'gpu', 'kind': device_name,
                       'count': count,
                       'memory_peak_bytes': int(rec['memory_peak_bytes']),
                       'power_limit': card_power_limit()}}
    if ctx.trace:
        tr = rec['trace']
        line['device'].update(busy_s=tr['busy_s'], window_s=tr['window_s'])
        line['breakdown'] = {'device_ops': tr['device_ops'],
                             'idle_gaps': tr['idle_gaps']}
    line['check'] = checked
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, PROGRAM)):
        print('perfbench: the program (%s) is not beside %s'
              % (PROGRAM, os.path.join(ROOT, 'perfbench')), file=sys.stderr)
        return 2
    from perfbench import harness
    cell = harness.Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print('perfbench: %s needs %d CUDA device(s), %d available'
              % (cell.name, cell.chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    ctx = Context(cell, args.seed, args.seconds, args.trace)
    rec = cell.loop().run(ctx)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print('perfbench: loaded in the benchmark process: %s'
              % ', '.join(bad), file=sys.stderr)
        return 3
    name = torch.cuda.get_device_name(0)
    from perfbench import peaks
    rec['peak_flops'] = peaks.bf16_flops(name)
    line = result(cell, ctx, rec, name, cell.chips)
    for k, v in rec['check'].items():
        if k not in line['check']:
            print('reading %s %r (not compared)' % (k, v), file=sys.stderr)
    for k, v in line['check'].items():
        print('check %s %r limit %r' % (k, v['value'], v['limit']),
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
