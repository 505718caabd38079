"""The port's multi-process runs on the CPU (gloo): a trainer's state saved
under one mesh and resumed under others, the engine over two ranks, and the
``torchrun`` launch of ``train_paintmind`` (the counterpart of
``tests/test_multiprocess.py``).

Every multi-process job has its own time limit (``_torch_dist``).  The
one-process runs these are held against run here, in this process, on the
same seeded weights and batches.  Tolerances as each test states.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import paintmind_tpu_torch as pt
from paintmind_tpu_torch.convert.from_jax import to_state_dict
from paintmind_tpu_torch.utils.checkpoint import load_flat

import _torch_dist_jobs as jobs
from _torch_dist import ROOT, free_port, run, tails, wait_all, worker_env

TINY_VQ = {
    'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
    'enc': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'in_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
    'dec': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'out_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
}
VQ_NAME = 'torch-mp-vqgan'
PIPE_KW = dict(stage1=VQ_NAME, t5='t5-l', dim=32, dim_head=16, mlp_dim=64,
               num_head=2, depth=2, dropout=0.0, t5_dim=48)
TINY_PIPE = {k: v for k, v in PIPE_KW.items() if k != 't5_dim'}
VERSIONS = {VQ_NAME: TINY_VQ, 'torch-mp-pipeline': TINY_PIPE}
for _name, _cfg in VERSIONS.items():
    pt.register_version(_name, _cfg)
BASE = {'register': VERSIONS, 'vq': TINY_VQ, 'pipe_kw': PIPE_KW, 'seed': 3}


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# ---------------------------------------------------------------------------
# resume across meshes
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def resume_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp('resume')
    saved = run('resume', 4, {**BASE, 'phase': 'save22', 'dir': str(d / 'a')},
                model_parallel=2)
    path = saved[0]['path']
    staged = run('resume', 2, {**BASE, 'phase': 'resume_pp', 'path': path,
                               'dir': str(d / 'b')}, model_parallel=2)
    # one process, no mesh: the run uninterrupted, and resumed from the file
    pipe = jobs.make_pipe(BASE, flat_key=None)
    t = jobs.trainer(pipe, str(d / 'c'), ema_decay=0.9)
    batches = jobs.first_batches(t, 4)
    plain = [float(t.train_step(b)['loss']) for b in batches]
    want = {'losses': plain, 'weights': jobs._trainable_state(pipe),
            'ema': [jobs._np(e) for e in t.state['ema']]}
    pipe2 = jobs.make_pipe(BASE, flat_key=None)
    t2 = jobs.trainer(pipe2, str(d / 'd'), ema_decay=0.9).resume(path)
    steps = t2.steps
    resumed = [float(t2.train_step(b)['loss']) for b in batches[2:]]
    one = {'losses': resumed, 'weights': jobs._trainable_state(pipe2),
           'ema': [jobs._np(e) for e in t2.state['ema']], 'steps': steps}
    return saved, staged, one, want


def _check(got, want, losses, tol):
    for a, b in zip(got['losses'], want['losses'][-len(got['losses']):]):
        assert abs(a - b) < 1e-4, (got['losses'], want['losses'])
    assert got['weights'].keys() == want['weights'].keys()
    for k in want['weights']:
        assert _maxabs(got['weights'][k], want['weights'][k]) < tol, k
    for a, b in zip(got['ema'], want['ema']):
        assert _maxabs(a, b) < tol


def test_save_under_dp2_tp2_matches_uninterrupted(resume_runs):
    """(data 2, model 2), the stage-2 transformer carved: four AdamW steps
    (EMA 0.9), saved after two; losses within 1e-4 and weights and averages
    within 1e-5 max abs of the one-process run (the row-parallel sums change
    the rounding)."""
    saved, _, _, want = resume_runs
    for o in saved:
        _check(o, want, 4, 1e-5)
        assert o['counts']['all_gather'] > 0


def test_state_file_is_the_unplaced_layout(resume_runs):
    """The state file a (2, 2) run writes holds whole tensors under the
    unplaced names: the one-process trainer's layout, key for key and shape
    for shape (optimizer moments and EMA included)."""
    saved, _, _, _ = resume_runs
    state = torch.load(saved[0]['path'], weights_only=False)
    pipe = jobs.make_pipe(BASE, flat_key=None)
    t = jobs.trainer(pipe, os.path.dirname(saved[0]['path']), ema_decay=0.9)
    ref = t._state_dict()
    assert state.keys() == ref.keys() and state['step'] == 2
    for k, v in ref['model'].items():
        assert state['model'][k].shape == v.shape, k
    params = t.model.trainable_parameters()
    assert len(state['opt']['state']) == len(params)
    for i, p in enumerate(params):
        assert state['opt']['state'][i]['exp_avg'].shape == p.shape
    assert [e.shape for e in state['ema']] == [p.shape for p in params]


def test_resume_at_world_one(resume_runs):
    """The (2, 2) state resumed by a one-process trainer: its next two
    steps within 1e-4 (losses) and 1e-5 (weights) of the uninterrupted
    run."""
    _, _, one, want = resume_runs
    assert one['steps'] == 2
    _check(one, want, 2, 1e-5)


def test_resume_under_two_pipeline_stages(resume_runs):
    """The same state resumed under (data 1, model 2) with
    ``pp_microbatches=2`` (each stage loads its layers): its next two steps
    within 1e-4 / 1e-5 of the uninterrupted run."""
    _, staged, _, want = resume_runs
    for o in staged:
        assert o['steps'] == 2
        _check(o, want, 2, 1e-5)


# ---------------------------------------------------------------------------
# the engine over two ranks
# ---------------------------------------------------------------------------

def test_two_rank_engine_answers_like_one_process(tmp_path):
    """``GenerationEngine(pipe, mesh=...)`` over (data 1, model 2): rank 0
    batches three seeded guided requests into one bucket and broadcasts it,
    rank 1 follows in lockstep until ``close()`` stops it; the images equal
    a one-process engine's within 1e-5."""
    from paintmind_tpu_torch.serving.engine import (GenerateRequest,
                                                    GenerationEngine)
    rng = np.random.default_rng(4)
    pipe = jobs.make_pipe(BASE, flat_key=None)  # the same seeded weights
    ctx = rng.standard_normal((3, 5, 48)).astype(np.float32)
    outs = run('engine', 2, {**BASE, 'ctx': ctx}, model_parallel=2)
    lead, follower = outs
    assert lead['batches'] == 1 and follower['followed'] == 1
    assert not lead['thread_alive']
    assert lead['counts']['broadcast'] >= 2
    with GenerationEngine(pipe, max_batch=4, max_wait_ms=500) as eng:
        futs = [eng.submit(GenerateRequest(context=ctx[i], seed=i,
                                           guidance_scale=2.0, timesteps=3,
                                           topk=3)) for i in range(3)]
        want = [f.result(timeout=200) for f in futs]
    for a, b in zip(lead['imgs'], want):
        assert _maxabs(a, b) < 1e-5


# ---------------------------------------------------------------------------
# torchrun
# ---------------------------------------------------------------------------

def _jpegs(folder, n=40):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        low = rng.integers(0, 255, (4, 4, 3), dtype=np.uint8)
        Image.fromarray(low).resize((40, 40), Image.BICUBIC).save(
            os.path.join(folder, f'img_{i:02d}.jpg'), quality=92)
    return folder


def _files(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, fs in os.walk(folder) for f in fs)


def test_torchrun_train_paintmind_matches_one_process(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 ...
    train_paintmind --device-cache --device cpu``: the script builds the
    pure data-parallel mesh over both ranks, each rank keeps the corpus and
    takes its rows of the seeded crops; the exported weights within 1e-5 of
    the one-process run's, and rank 1 writes no file."""
    data = _jpegs(str(tmp_path / 'imgs'))
    argv = ['--dataset', f'folder:{data}', '--version', 'torch-mp-pipeline',
            '--stage1-random', '--epochs', '1', '--batch-size', '4',
            '--grad-accum', '1', '--lr', '1e-3', '--warmup-steps', '1',
            '--decay-steps', '10', '--mixed-precision', 'no',
            '--save-every', '1000', '--sample-every', '1000',
            '--num-workers', '1', '--cfg-p', '0', '--valid-size', '4',
            '--result-folder', 'results', '--log-dir', 'log',
            '--device-cache', '--device', 'cpu']
    env = worker_env()
    env['PM_TEST_VERSIONS'] = json.dumps(VERSIONS)
    work = tmp_path / 'launch'
    work.mkdir()
    log = str(tmp_path / 'torchrun.txt')
    with open(log, 'w') as f:
        proc = subprocess.Popen(
            [sys.executable, '-m', 'torch.distributed.run',
             '--nproc_per_node', '2', '--master_addr', '127.0.0.1',
             '--master_port', str(free_port()),
             os.path.join(ROOT, 'tests', '_torch_dist_jobs.py'),
             'torchrun-train', *argv],
            stdout=f, stderr=subprocess.STDOUT, env=env, cwd=str(work))
    wait_all([proc], [log], 240)

    here = tmp_path / 'one'
    here.mkdir()
    cwd = os.getcwd()
    os.chdir(here)
    try:
        from paintmind_tpu_torch.scripts import train_paintmind
        t = train_paintmind.main(argv)
    finally:
        os.chdir(cwd)
    name = f'paintmind_step_{t.steps}.npz'
    assert t.steps > 0
    assert _files(str(work / 'rank1')) == [], tails([log])
    got = _files(str(work / 'rank0'))
    assert f'results/models/{name}' in got
    assert f'results/models/paintmind_state_{t.steps}.pt' in got
    a = load_flat(str(work / 'rank0' / 'results' / 'models' / name))
    b = load_flat(str(here / 'results' / 'models' / name))
    assert a.keys() == b.keys()
    for k in b:
        assert _maxabs(a[k], b[k]) < 1e-5, k
    assert to_state_dict(a).keys() == to_state_dict(b).keys()
