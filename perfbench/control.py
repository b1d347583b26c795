"""The control of a cell's check: the plain reference one precision step
below the configuration's (float8 e4m3 for bfloat16) put in the
program's place, judged by the cell's check on the images a run of the
same seed would sample.  It must come out not correct.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line a seed: the numbers, their limits and whether they
pass.  ``--fault <name>`` plants one of the check's faults in the float32
reference in the program's place instead: a reading of that fault.  The
benchmark's own runs never run it; ``tests/test_control.py`` does, on
the card at the cell's size.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402
from perfbench.run import Context, compare  # noqa: E402


def readings(cell, seeds, device='cuda', fault=None):
    """[(seed, numbers)] of the control, or with ``fault`` (one of the
    check's ``FAULTS``) of the plain reference in the program's place
    with that fault planted."""
    out = []
    for seed in seeds:
        ctx = Context(cell, seed, 0, 0, device=device, t0=time.time())
        wdev, args, kw = cell.loop().control_sample(ctx)
        out.append((seed, cell.check().control(ctx, wdev, *args,
                                               fault=fault, **kw)))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--fault', default=None,
                   help="a fault of the cell's check (its FAULTS) planted "
                        'in the float32 reference instead of the control')
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    for seed, numbers in readings(cell, args.seeds, fault=args.fault):
        ok, checked = compare(numbers, cell.limits)
        print(json.dumps({'workload': cell.name, 'seed': seed,
                          'fault': args.fault, 'correct': ok,
                          'check': checked, 'readings': numbers}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
