"""Microbench: the exact top-k kernel (``ops/topk.py:topk_lastdim``,
``csrc/topk.cu``) on the GPU, on the row kinds that stress it.

    python -m captioning_tpu_torch.tools.bench_topk [--k 1 5 16] \\
        [--table FILE] [--save-table FILE] [--ptxas]

For each row kind at [1024, 5 x 9488] (the UpDown beam-5 candidate
table) and [1024, 9488] and each k, it checks the kernel bit-identical to
its twin (the stable sort; ``AssertionError`` otherwise) and times it by
CUDA-graph replay and by a loop of launches between CUDA events.  Row
kinds (``rows``): random normal; integer ties; the beam's bos table (NEG
lanes); ascending rows, where every element beats the block's threshold
(the kernel's worst case); descending rows; a plateau of equal values
with k - 1 larger ones.

``--save-table FILE`` captures the candidate table of a middle step of a
full-width UpDown beam-5 decode (B = 1024, bf16, random weights from a
seed, as ``chip_smoke.py`` builds it) and saves it; ``--table FILE`` times
a saved table as one more kind.  ``--ptxas`` compiles ``csrc/topk.cu``
once more with ``-Xptxas -v`` and adds what ptxas says of each kernel
(registers, spills).  Prints one JSON object.

The imports are absolute, so the same file times another checkout's
kernel: ``cd OTHER && PYTHONPATH=$PWD python3 /path/to/bench_topk.py``
(the JSON names the ``ops/topk.py`` it loaded).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile

import torch

KINDS = ('random', 'ties', 'lanes', 'ascending', 'descending', 'plateau')
WIDTHS = (5 * 9488, 9488)
NEG = -1e30
CAPTURE_STEP = 10


def rows(B, C, kind, k, seed, device='cuda'):
    """float32 [B, C] candidate rows of ``kind`` (``KINDS``): 'random'
    normal; 'ties' (integers in [-3, 3], each value repeated ~C/7 times);
    'lanes' (the beam's bos table: 5 lanes of C/5 log-probs, lanes 1..
    plus NEG, which rounds to exactly NEG: runs of thousands of ties);
    'ascending' / 'descending' (sorted normal rows); 'plateau' (all equal
    but k - 1 larger values, so the k-th entry is a tie that resolves to
    the lowest index)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == 'ties':
        return torch.randint(-3, 4, (B, C), generator=g,
                             device=device).float()
    if kind == 'lanes':
        V1 = C // 5
        lp = torch.log_softmax(torch.randn(B, V1, generator=g,
                                           device=device), -1)
        lane = torch.tensor([0.0] + [NEG] * 4, device=device)
        x = (lp[:, None] + lane[None, :, None]).reshape(B, 5 * V1)
        return torch.nn.functional.pad(x, (0, C - 5 * V1), value=NEG)
    x = torch.randn(B, C, generator=g, device=device)
    if kind in ('ascending', 'descending'):
        return x.sort(-1, descending=kind == 'descending')[0].contiguous()
    if kind == 'plateau':
        x = torch.full((B, C), 0.5, device=device)
        hot = torch.rand(B, C, generator=g, device=device).argsort(
            -1)[:, :k - 1]
        return x.scatter_(1, hot, 2.0)
    if kind != 'random':
        raise ValueError('rows: unknown kind %r' % kind)
    return x


def check(tk, x, k, what):
    """Kernel vs twin: values and indices bit-identical."""
    got_v, got_i = tk.topk_lastdim(x, k)
    want_v, want_i = tk.top_k(x, k)
    if not (torch.equal(got_v, want_v) and torch.equal(got_i, want_i)):
        bad = (got_i != want_i).any(1).nonzero()[:3, 0].tolist()
        raise AssertionError('topk_lastdim %s k=%d: differs from the twin on '
                             'rows %s' % (what, k, bad))


def replay_ms(fn, iters=20):
    """Mean device time of ``fn`` with the host taken out: ``iters`` calls
    in one CUDA graph, replayed between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def capture_table(cap, fc, att, am, step=CAPTURE_STEP, mode='beam5'):
    """The [B, 5 V1] candidate table that the plain beam route (or the
    general body, mode 'general5') hands to ``topk_lastdim`` at loop step
    ``step`` of one beam-5 decode of ``cap`` (a copy)."""
    from captioning_tpu_torch.engine import decoding
    from captioning_tpu_torch.tools import profile_decode as pd
    real, seen = decoding.topk_lastdim, []

    def keep(x, k):
        if len(seen) == step:
            seen.append(x.clone())
        else:
            seen.append(None)
        return real(x, k)
    decoding.topk_lastdim = keep
    try:
        pd.decode(cap, mode, fc, att, am)
    finally:
        decoding.topk_lastdim = real
    return seen[step]


def save_updown_table(path):
    from captioning_tpu_torch.tools import profile_decode as pd
    cap = pd.make_captioner('updown', 'bfloat16', 'cuda')
    fc, att, am = pd.features(pd.BATCH, 'cuda', seed=1)
    x = capture_table(cap, fc, att, am)
    torch.save(x.cpu(), path)
    return x


def ptxas_report(build):
    """ptxas's lines on each kernel of csrc/topk.cu (registers, spills),
    from the flags ``build`` (``ops/_build``) compiles it with."""
    with tempfile.TemporaryDirectory() as d:
        proc = subprocess.run(
            [build._nvcc()] + build.NVCC_FLAGS + ['-Xptxas', '-v', '-o',
                                                  os.path.join(d, 'a.so'),
                                                  os.path.join(build.CSRC,
                                                               'topk.cu')]
            + build.NVCC_LIBS, capture_output=True, text=True, check=True)
    return [line.strip() for line in proc.stderr.splitlines()
            if 'Compiling entry' in line or 'registers' in line
            or 'spill' in line]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--k', type=int, nargs='+', default=[1, 5, 16])
    p.add_argument('--table', help='time a saved candidate table too')
    p.add_argument('--save-table', help='capture the UpDown beam table '
                   'of step %d into this file first' % CAPTURE_STEP)
    p.add_argument('--ptxas', action='store_true',
                   help="add ptxas's register report")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('bench_topk: needs a CUDA device')
    from captioning_tpu_torch.ops import _build
    from captioning_tpu_torch.ops import topk as tk
    from captioning_tpu_torch.tools.bench_beam_attend import timer
    loop_ms = timer(torch.device('cuda'), 50)
    cases = [('%s [1024, %d]' % (kind, C),
              lambda k, kind=kind, C=C: rows(1024, C, kind, k, seed=C + k))
             for C in WIDTHS for kind in KINDS]
    table = None
    if a.save_table:
        table = save_updown_table(a.save_table)
    elif a.table:
        table = torch.load(a.table).cuda()
    if table is not None:
        cases.append(('UpDown beam table, step %d %s'
                      % (CAPTURE_STEP, list(table.shape)),
                      lambda k: table))
    out = {'topk_py': tk.__file__,
           'device': torch.cuda.get_device_name(0), 'ms': {}}
    if a.ptxas:
        out['ptxas'] = ptxas_report(_build)
    for name, make in cases:
        for k in a.k:
            x = make(k)
            check(tk, x, k, name)
            out['ms']['%s k %d' % (name, k)] = {
                'replay': replay_ms(lambda: tk.topk_lastdim(x, k)),
                'loop': loop_ms(lambda: tk.topk_lastdim(x, k))}
    print(json.dumps(out, indent=1))
    return out


if __name__ == '__main__':
    main()
