"""Start the ranks of a mesh on this host, one process each.

``tools/train_torch.py --mesh_shape data:N[,model:M]`` (and
``tools/train_pl_torch.py`` over several GPUs) runs the script again as
N * M processes that join one group through ``--dist_coordinator
127.0.0.1:<free port> --dist_nproc N*M --dist_pid i``, and waits for
them; ``tools/eval_torch.py`` / ``tools/eval_ensemble_torch.py
--device_mesh 1`` start one rank a visible GPU the same way
(``eval_ranks_to_start``).  A rank that fails fails the run: the
others are stopped, never left waiting in a collective."""

from __future__ import annotations

import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from .mesh import init_distributed, mesh_ranks, world_size


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def ranks_to_start(opt, device: str) -> int:
    """How many rank processes a launch of the train script starts: 1 (this
    process trains) under ``--dist_*`` or on one device; data x model of
    ``--mesh_shape``; else, on several GPUs, the largest count that
    divides ``batch_size`` (tools/train.py ``_maybe_mesh``)."""
    if getattr(opt, 'dist_coordinator', '') or int(
            getattr(opt, 'dist_auto', 0) or 0):
        return 1
    cuda = torch.device(device).type == 'cuda'
    n_gpus = torch.cuda.device_count() if cuda else 0
    mesh_shape = getattr(opt, 'mesh_shape', '') or ''
    n = mesh_ranks(mesh_shape)
    if n:
        if cuda and n > n_gpus:
            raise ValueError('mesh_shape %r: %d ranks, one a GPU, but %d '
                             'GPUs are visible' % (mesh_shape, n, n_gpus))
        return n
    d = n_gpus
    while d > 1 and opt.batch_size % d:
        d -= 1
    return max(d, 1)


def eval_ranks_to_start(opt, device: str, n_devices: int = None) -> int:
    """How many rank processes a launch of an eval tool starts: 1 (this
    process evaluates) under ``--dist_*`` or without ``--device_mesh 1``;
    else one a visible GPU (``--device cpu``: none, so 1), as the JAX eval
    shards each batch over ``jax.device_count()`` devices: no
    divisibility rule, the cooperative ``eval_split`` pads each batch to a
    multiple of the ranks.  ``n_devices`` stands in for the visible GPUs
    (the CPU tests start 2 gloo ranks)."""
    if getattr(opt, 'dist_coordinator', '') or int(
            getattr(opt, 'dist_auto', 0) or 0):
        return 1
    if not int(getattr(opt, 'device_mesh', 0) or 0):
        return 1
    if n_devices is None:
        n_devices = (torch.cuda.device_count()
                     if torch.device(device).type == 'cuda' else 0)
    return max(int(n_devices), 1)


def run_eval(script: str, argv, opt, evaluate, n_devices: int = None):
    """An eval tool's run after its options are parsed: start
    ``eval_ranks_to_start`` rank processes of ``script argv`` and wait for
    them, or (one) join the group ``--dist_*`` names, if any, and call
    ``evaluate(device)`` with this process's device."""
    n = eval_ranks_to_start(opt, opt.device, n_devices)
    if n > 1:
        rc = run_ranks(script, argv, n)
        if rc:
            raise SystemExit('a rank of %d failed (exit code %d)' % (n, rc))
        return
    device = init_distributed(opt, opt.device)
    try:
        evaluate(device)
    finally:
        if world_size() > 1:
            dist.destroy_process_group()


def run_ranks(script: str, argv, n: int, poll: float = 0.2) -> int:
    """Run ``script argv`` as ranks 0..n-1 of one group; 0 when every rank
    exits 0, else the first failing rank's code after the others are
    stopped."""
    coord = '127.0.0.1:%d' % free_port()
    procs = [subprocess.Popen(
        [sys.executable, script] + list(argv) +
        ['--dist_coordinator', coord, '--dist_nproc', str(n),
         '--dist_pid', str(i)]) for i in range(n)]
    print('launched %d ranks (coordinator %s)' % (n, coord), flush=True)
    try:
        while True:
            codes = [p.poll() for p in procs]
            rc = next((c for c in codes if c not in (None, 0)), 0)
            if rc or None not in codes:
                break
            time.sleep(poll)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return rc
