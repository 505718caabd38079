"""Launcher of the port's multi-process tests: ``world`` gloo processes on
the CPU, one per rank, each running a job of ``_torch_dist_jobs.py`` on the
inputs the test hands over (a ``torch.save`` file).  A job has its own time
limit, so a deadlock fails the test instead of eating the run's clock.

Importing it also sets the port tests' CPU-thread rule.  Under pytest-xdist
each worker runs torch on its share of the cores, ``cpu_count // workers``
intra-op threads (at least one): with a thread per core in every worker, a
test of many small calls (``gradcheck``) waits on threads that the other
workers have descheduled.  Every ``tests/test_torch_*.py`` imports this
module, and an xdist worker collects every test module before it runs a
test, so the rule holds from a worker's first test.  Outside xdist nothing
changes: a run of one file keeps every core."""

import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JOBS = os.path.join(HERE, '_torch_dist_jobs.py')

if 'PYTEST_XDIST_WORKER_COUNT' in os.environ:
    torch.set_num_threads(max(
        1, os.cpu_count() // int(os.environ['PYTEST_XDIST_WORKER_COUNT'])))


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def worker_env():
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
    env['OMP_NUM_THREADS'] = '1'
    return env


def wait_all(procs, logs, timeout):
    """Wait for every process; on the time limit kill them all.  Raises
    with the logs' tails when one failed or the limit was hit."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            raise AssertionError(f'timed out after {timeout} s (a deadlock?)\n'
                                 + tails(logs))
        time.sleep(0.05)
    if any(p.returncode for p in procs):
        raise AssertionError('a rank failed: rcs '
                             f'{[p.returncode for p in procs]}\n' + tails(logs))


def tails(logs, n=4000):
    out = []
    for i, path in enumerate(logs):
        with open(path, errors='replace') as f:
            out.append(f'--- rank {i} ---\n' + f.read()[-n:])
    return '\n'.join(out)


def run(job, world, inputs, *, model_parallel=1, timeout=240):
    """Run ``job`` on ``world`` ranks over a (world/model_parallel,
    model_parallel) mesh; returns each rank's output, in rank order."""
    with tempfile.TemporaryDirectory() as d:
        torch.save(inputs, os.path.join(d, 'in.pt'))
        port = free_port()
        logs = [os.path.join(d, f'log_{r}.txt') for r in range(world)]
        procs = []
        for r in range(world):
            with open(logs[r], 'w') as log:
                procs.append(subprocess.Popen(
                    [sys.executable, JOBS, job, str(r), str(world), str(port),
                     d, str(model_parallel)],
                    stdout=log, stderr=subprocess.STDOUT, env=worker_env(),
                    cwd=d))
        wait_all(procs, logs, timeout)
        return [torch.load(os.path.join(d, f'out_{r}.pt'), weights_only=False)
                for r in range(world)]
