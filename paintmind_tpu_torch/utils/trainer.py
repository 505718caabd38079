"""Training harnesses: VQGANTrainer (stage 1) and PaintMindTrainer (stage
2), with the signatures and the defaults of ``paintmind_tpu/utils/trainer.py``
(reference paintmind/utils/trainer.py:61-283 and :291-437).

  reference                         ->  here
  ---------------------------------------------------------------------
  autocast bf16/fp16                ->  bf16 activations + fp32 master params
  accumulate() context              ->  a loop over microbatches in the step
  clip_grad_norm_ at sync           ->  clipping inside the optimizer's step
  timm CosineLRScheduler            ->  optim.build_scheduler (same piecewise)
  torch Adam / AdamW / Lion         ->  optim.adam / optim.adamw / optim.lion
  state_dict .pt snapshots          ->  one file of full train state (model,
                                        optimizer, EMA, step and every random
                                        generator: a true resume) plus a
                                        .npz model export that both packages
                                        load with from_pretrained
  tensorboard via accelerator.log   ->  MetricWriter (same metric names)
  make_grid eval dumps              ->  utils.image_grid (nrow=6, (-1,1))

With ``ema_decay`` the model holds the averaged weights after ``save()``,
``evaluate()``, ``resume()`` and the end of ``train()``, as the JAX
package's ``_sync_model`` leaves them in ``model.params``; the raw weights
wait in the trainer (and in the saved state) and go back into the model at
the next training step, so syncing changes no later update.

Batches may come from any loader: host arrays, or device tensors from
``utils.device_cache.DeviceCacheLoader``.  ``train_step`` hands a batch to
the step function through ``torch.as_tensor(..., dtype=torch.float32,
device=self.device)``, which returns a tensor already on the trainer's
device and in fp32 as it is, so a cached batch never goes through the
host; ``evaluate`` brings the images to the host only for its image grids
and metrics.

``VQGANTrainer(eval_rfid=True)`` adds the validation set's rFID
(``utils.metrics.rfid``, InceptionV3 features on the trainer's device) to
``evaluate()``'s log, under ``val rfid-inception`` or ``val rfid-rand``.

Multi-GPU (``mesh=``, a ``parallel.mesh.make_mesh`` over the ranks of a
``torchrun`` job): ``batch_size`` is the global batch, and each rank loads
only its rows of it (of every microbatch, its data rank's slice).  The
gradients are averaged over 'data'; ``zero_sharding`` slices the optimizer
state over 'data' (ZeRO-1); a 'model' axis of more than one rank carves the
model (tensor parallelism for the transformer stacks and the VQGAN, expert
parallelism for an MoE transformer), or with ``pp_microbatches`` stages the
stage-2 stack over it (GPipe).  Only rank 0 logs, writes image grids and
writes checkpoints; every rank takes part in gathering what rank 0 writes
and waits at a barrier after.  A state file holds whole tensors in the
unplaced names and order, whatever the mesh, so a run saved under any
(dp, tp, pp) resumes under any other, or in one process.
"""

from __future__ import annotations

import os
import random as pyrandom
import re
import signal

import numpy as np
import torch

from .. import optim
from ..models import discriminator as disc_mod
from ..models import lpips as lpips_mod
from ..parallel import multihost
from ..train import steps as train_steps
from .data import DataLoader, random_split
from .image_grid import save_image_grid
from .logging import Log, MetricWriter
from .metrics import codebook_stats, psnr


def _dtype_of(mixed_precision):
    if mixed_precision in ('bf16', 'fp16'):  # fp16 -> bf16: no loss scaling
        return torch.bfloat16
    return None


def _micro_schedule(base, grad_accum):
    """Rescale an LR schedule from optimizer-update counts to the
    reference's microbatch timeline.

    The reference steps its scheduler once per DataLoader iteration
    (trainer.py:200,224,397) while the optimizer updates every
    ``grad_accum`` iterations; the optimizer here counts *updates*, so the
    schedule must advance ``grad_accum`` microbatch ticks per update to
    keep the warmup/decay timeline identical."""
    if grad_accum == 1:
        return base
    return lambda count: base(count * grad_accum)


def masked_p_generator(rng=None):
    """arccos-distributed mask ratio (reference trainer.py:286-288), from
    ``rng`` (a ``numpy.random.Generator``) or numpy's global state."""
    u = np.random.rand() if rng is None else rng.random()
    return float(np.cos(0.5 * np.pi * u))


def _first_images(batch):
    return batch[0] if isinstance(batch, (tuple, list)) else batch


def _host(imgs):
    """Images (numpy, or a tensor on any device) -> fp32 numpy."""
    if isinstance(imgs, torch.Tensor):
        return imgs.detach().float().cpu().numpy()
    return np.asarray(imgs, np.float32)


class _NoWriter:
    """The metric writer of a rank other than 0."""

    def log(self, metrics, step):
        pass

    def close(self):
        pass


class _TrainerBase:
    _ckpt_prefix = 'state'
    _preempted = False
    keep_last = None  # retention policy: None = keep every checkpoint
    _raw = None  # the raw weights while the model holds their averages
    mesh = None
    _rows = None  # this rank's rows of each global batch (None: all)

    @property
    def is_main(self):
        return self.mesh is None or multihost.is_main_process()

    def _barrier(self):
        if self.mesh is not None:
            multihost.barrier()

    def _setup_mesh(self, mesh, batch_size, grad_accum, options):
        """Checks of the multi-GPU options; the per-rank rows of a global
        batch."""
        if mesh is None:
            for name, value in options.items():
                if value:
                    raise ValueError(f'{name} needs mesh= (a '
                                     'parallel.mesh.make_mesh over the ranks)')
            return
        from ..parallel.mesh import check_mesh
        check_mesh(mesh, type(self).__name__)
        dp = mesh.size('data')
        if batch_size % dp:
            raise ValueError(f'batch_size {batch_size} must be divisible by '
                             f'dp={dp}')
        self.mesh = mesh
        m = batch_size // dp
        r = mesh.rank('data')
        self._rows = [i * batch_size + r * m + j for i in range(grad_accum)
                      for j in range(m)]

    def _local_batch(self, batch):
        """This rank's rows of a batch from an external loader (one this
        trainer built loads only them)."""
        if self.mesh is None or self._own_loader:
            return batch
        from ..parallel.mesh import shard_batch
        return shard_batch(batch, self.mesh, self.grad_accum)

    _own_loader = False

    def _metric_writer(self, name):
        return MetricWriter(self.log_dir, name) if self.is_main else _NoWriter()

    def _full_model_state(self, module):
        """The raw weights' state dict, whole (gathered over the mesh)."""
        from ..parallel.mesh import full_state_dict
        if self._raw is None:
            return full_state_dict(module)
        params, _ = self._ema_pairs()
        held = [p.detach().clone() for p in params]
        with torch.no_grad():
            for p, r in zip(params, self._raw):
                p.copy_(r)
            try:
                return full_state_dict(module)
            finally:
                for p, h in zip(params, held):
                    p.copy_(h)

    def _gather_list(self, module, tensors, names):
        """Tensors shaped like ``names``' parameters -> whole, in
        ``self._full_names`` order."""
        from ..parallel.data_parallel import gather_named
        full = gather_named(module, dict(zip(names, tensors)))
        return [full[n] for n in self._full_names]

    def _carve_list(self, module, tensors, names):
        from ..parallel.mesh import carve_like
        index = {n: i for i, n in enumerate(self._full_names)}
        return [carve_like(module, n, tensors[index[n]]) for n in names]

    # subclasses with EMA: (the model's trained parameters, their averages)
    def _ema_pairs(self):
        return None

    @torch.no_grad()
    def _sync_model(self):
        """With EMA on, put the averaged weights into the model (the JAX
        package's ``_sync_model``) and keep the raw ones for training."""
        pairs = self._ema_pairs()
        if pairs is None or self._raw is not None:
            return
        params, ema = pairs
        self._raw = [p.detach().clone() for p in params]
        for p, e in zip(params, ema):
            p.copy_(e)

    @torch.no_grad()
    def _unsync_model(self):
        """The raw weights back into the model, before a training step."""
        if self._raw is None:
            return
        params, _ = self._ema_pairs()
        for p, r in zip(params, self._raw):
            p.copy_(r)
        self._raw = None

    def _raw_state_dict(self, module):
        """``module.state_dict()`` with the raw weights where the model
        holds their averages: what a resume must train on."""
        sd = module.state_dict()
        if self._raw is not None:
            names = {id(p): n for n, p in module.named_parameters()}
            sd = dict(sd)
            for p, r in zip(self._ema_pairs()[0], self._raw):
                sd[names[id(p)]] = r
        return sd

    def _setup_dirs(self, result_folder):
        self.result_folder = result_folder or './results'
        self.model_saved_dir = os.path.join(self.result_folder, 'models')
        self.image_saved_dir = os.path.join(self.result_folder, 'images')
        os.makedirs(self.model_saved_dir, exist_ok=True)
        os.makedirs(self.image_saved_dir, exist_ok=True)

    # subclasses: everything a resume needs, and its way back in
    def _state_dict(self):
        raise NotImplementedError

    def _load_state_dict(self, state):
        raise NotImplementedError

    def _save_state(self, name):
        """One ``torch.save`` file, written under a temporary name and then
        renamed: a file that is there is a complete generation.  Under a
        mesh every rank gathers, rank 0 writes, all wait."""
        path = os.path.abspath(os.path.join(self.model_saved_dir, name))
        state = self._state_dict()
        if self.is_main:
            tmp = f'{path}.tmp-{os.getpid()}'
            torch.save(state, tmp)
            os.replace(tmp, path)
        self._barrier()
        return path

    def finalize_checkpoints(self):
        """Wait for the checkpoints in flight: none, since ``save()`` writes
        its files before it returns (the JAX package's orbax writes in the
        background).  Any rank may call it."""
        return None

    def _restore_state(self, path):
        # a train state holds optimizer and generator states besides
        # tensors, so it is a full pickle: load only files a trainer wrote
        state = torch.load(path, map_location='cpu', weights_only=False)
        self._load_state_dict(state)
        return self

    def _prune_checkpoints(self, prefix):
        """Retention: keep only the newest ``keep_last`` checkpoint
        generations (a generation is ``<prefix>_state_<N>.pt`` plus the
        ``<prefix>_step_<N>.npz`` model export)."""
        if not self.keep_last or not self.is_main:
            return
        pat = re.compile(re.escape(prefix)
                         + r'_(state|step)_(\d+)\.(pt|npz)$')
        gens = {}
        for name in os.listdir(self.model_saved_dir):
            m = pat.match(name)
            if m:
                gens.setdefault(int(m.group(2)), []).append(name)
        for step in sorted(gens)[:-self.keep_last]:
            for name in gens[step]:
                os.remove(os.path.join(self.model_saved_dir, name))

    # -- preemption safety ----------------------------------------------

    def _install_preemption_handler(self):
        """SIGTERM -> set a flag the train loop checks at the next step
        boundary (a save from inside a signal handler could interrupt a
        write in flight).  Returns a restore-callback for ``finally``."""
        self._preempted = False

        def handler(signum, frame):
            self._preempted = True

        try:
            prev = signal.signal(signal.SIGTERM, handler)
        except ValueError:      # not the main thread: no handler possible
            return lambda: None
        return lambda: signal.signal(signal.SIGTERM, prev)

    def _handle_preemption(self):
        """Step-boundary check: on SIGTERM, save the full train state and
        tell the loops to exit."""
        if not self._preempted:
            return False
        print(f'SIGTERM received at step {self.steps}: saving state for a '
              "resume (resume('auto') picks it up)")
        self.save()
        return True

    def _auto_resume_path(self):
        """Newest complete ``<prefix>_state_<N>.pt``, or None."""
        pat = re.compile(re.escape(self._ckpt_prefix) + r'_state_(\d+)\.pt$')
        gens = [(int(m.group(1)), name)
                for name in os.listdir(self.model_saved_dir)
                if (m := pat.match(name))]
        if not gens:
            return None
        return os.path.join(self.model_saved_dir, max(gens)[1])

    def resume(self, path='auto'):
        """Resume assumes the same grad_accum_steps as the saving run: the
        state counts optimizer updates, ``self.steps`` microbatches.
        ``path='auto'`` picks the newest complete state file under the
        trainer's result folder (preemption recovery)."""
        if path == 'auto':
            path = self._auto_resume_path()
            if path is None:
                raise FileNotFoundError(
                    f'no {self._ckpt_prefix}_state_* checkpoint under '
                    f'{self.model_saved_dir} to auto-resume from')
        self._raw = None  # the loaded model holds raw weights
        self._restore_state(path)
        self.steps = self.state['step'] * self.grad_accum
        self._sync_model()
        return self


class VQGANTrainer(_TrainerBase):
    """(reference trainer.py:61-283).  ``vqvae`` is a ``VQModel`` with fp32
    parameters; it is trained in place, beside a PatchGAN discriminator
    (``disc_config``, default the reference's ``(3, 64, 3)``).
    ``perceptual_weights``: 'auto' (the converted LPIPS VGG ``.npz`` at
    ``assets/lpips_vgg.npz`` beside this package, and a hard error without
    it), 'random' (a seeded random-VGG perceptual loss: a training signal,
    not the reference objective), 'none' (no perceptual term), a path to
    such an ``.npz``, or an ``LPIPS`` module."""

    _ckpt_prefix = 'vit_vq'

    def __init__(self, vqvae, dataset, num_epoch, valid_size=32, lr=1e-4,
                 lr_min=5e-5, warmup_steps=50000, warmup_lr_init=1e-6,
                 decay_steps=None, batch_size=32, num_workers=8,
                 pin_memory=False, max_grad_norm=1.0, grad_accum_steps=1,
                 mixed_precision='bf16', save_every=10000, sample_every=1000,
                 result_folder=None, log_dir='./log', seed=42, mesh=None,
                 perceptual_weights='auto', d_weight=0.1, log_every=1,
                 disc_config=None, remat=False, zero_sharding=False,
                 eval_rfid=False, ema_decay=None,
                 codebook_restart_every=None, train_loader=None,
                 valid_loader=None, share_forward=True, keep_last=None):
        del pin_memory
        self.grad_accum = grad_accum_steps
        self._setup_mesh(mesh, batch_size, grad_accum_steps,
                         {'zero_sharding': zero_sharding})
        if mesh is not None and mesh.size('model') > 1:
            from ..parallel.mesh import shard_params
            shard_params(vqvae, mesh)
        self._full_names = [n for n, _ in vqvae.named_parameters()]
        self._syncs = {}
        self.eval_rfid = eval_rfid
        self.vqvae = vqvae
        self.device = vqvae.device
        self.num_epoch = num_epoch
        self.save_every = save_every
        self.keep_last = keep_last
        self.samp_every = sample_every
        self.grad_accum = grad_accum_steps
        self.log_dir = log_dir
        self.log_every = log_every
        self._setup_dirs(result_folder)

        if train_loader is not None:
            # externally built loaders; the train loader must yield
            # batch_size·grad_accum images per host step
            if valid_loader is None:
                raise ValueError('train_loader also requires valid_loader')
            self.train_dl, self.valid_dl = train_loader, valid_loader
        else:
            train_size = len(dataset) - valid_size
            self.train_ds, self.valid_ds = random_split(
                dataset, [train_size, valid_size], seed=seed)
            print(f'train dataset size: {train_size}, '
                  f'valid dataset size: {valid_size}')
            # one host step = one optimizer update over grad_accum
            # microbatches of batch_size each: the reference's effective batch
            self.train_dl = DataLoader(self.train_ds,
                                       batch_size * grad_accum_steps,
                                       shuffle=True, seed=seed,
                                       num_workers=num_workers,
                                       rows=self._rows)
            self._own_loader = True
            self.valid_dl = DataLoader(self.valid_ds,
                                       min(batch_size, valid_size),
                                       shuffle=False, num_workers=num_workers)

        # scheduler horizon and self.steps in reference microbatch units
        iters = max(len(self.train_dl), 1) * grad_accum_steps
        self.g_sched = optim.build_scheduler(
            num_epoch, iters, lr, lr_min, warmup_steps, warmup_lr_init,
            decay_steps)
        self.d_sched = optim.build_scheduler(
            num_epoch, iters, lr, lr_min, warmup_steps, warmup_lr_init,
            decay_steps)

        def tx(sched, which):
            rate = _micro_schedule(sched, grad_accum_steps)

            def build(params):
                if mesh is None:
                    return optim.adam(params, rate, (0.9, 0.99),
                                      max_grad_norm)
                from ..parallel.data_parallel import GradSync
                sync = self._syncs[which] = GradSync(params, mesh,
                                                     zero=zero_sharding)
                return sync.install(optim.adam(sync.opt_params, rate,
                                               (0.9, 0.99), max_grad_norm))
            return build

        self.lpips = self._load_perceptual(perceptual_weights)
        # reference config: NLayerDiscriminator(3, 64, 3) (trainer.py:94)
        self.dcfg = disc_config or disc_mod.DiscriminatorConfig(
            input_nc=3, ndf=64, n_layers=3)
        self.ema_decay = ema_decay
        self.state = train_steps.init_vqgan_train_state(
            vqvae, tx(self.g_sched, 'g'), tx(self.d_sched, 'd'), self.dcfg,
            ema_decay=ema_decay,
            codebook_restart_every=codebook_restart_every, seed=seed)
        self._step = train_steps.make_vqgan_train_step(
            vqvae, None, None, dcfg=self.dcfg, lpips=self.lpips,
            d_weight=d_weight, grad_accum=grad_accum_steps,
            compute_dtype=_dtype_of(mixed_precision), remat=remat,
            ema_decay=ema_decay,
            codebook_restart_every=codebook_restart_every,
            share_forward=share_forward, state=self.state, mesh=mesh,
            g_sync=self._syncs.get('g'), d_sync=self._syncs.get('d'))
        self.steps = 0
        self.log = Log()  # train() starts a fresh one

        n_params = vqvae.num_params + sum(
            p.numel() for p in self.state['d'].parameters())
        print(f'number of learnable parameters: {n_params // int(1e6)}M')

    def _load_perceptual(self, spec):
        """'auto' = the converted LPIPS ``.npz`` in ``assets/``, and a hard
        error when it is missing: training silently against a random-VGG
        perceptual loss is not the reference objective.  Opt out with
        'none' (drop the term) or 'random' (random-feature perceptual
        loss)."""
        if spec in (None, 'none'):
            return None
        if spec == 'random':
            print("NOTE: perceptual_weights='random': random-VGG perceptual "
                  'loss; a real training signal, but NOT the reference LPIPS '
                  'objective.')
            return lpips_mod.LPIPS(seed=0, device=self.device)
        default = os.path.join(os.path.dirname(__file__), '..', 'assets',
                               'lpips_vgg.npz')
        if spec == 'auto':
            if os.path.exists(default):
                return lpips_mod.load_lpips(default, device=self.device)
            raise FileNotFoundError(
                f'no pretrained LPIPS weights at {os.path.abspath(default)}. '
                'Reference-parity stage-1 training needs the converted lpips '
                "VGG weights (the JAX package's lpips_vgg.npz, made by its "
                'tools/make_lpips_npz.py), or pass perceptual_weights=<npz '
                "path>. To train WITHOUT parity, pass perceptual_weights="
                "'random' (random-VGG perceptual term) or 'none' (drop the "
                'term).')
        if isinstance(spec, str):
            return lpips_mod.load_lpips(spec, device=self.device)
        return spec  # already a module

    # -- state for save / resume ----------------------------------------

    def _ema_pairs(self):
        if 'g_ema' not in self.state:
            return None
        return list(self.vqvae.parameters()), self.state['g_ema']

    def _state_dict(self):
        if self.mesh is None:
            state = {
                'model': self._raw_state_dict(self.vqvae),
                'g_opt': self.state['g_opt'].state_dict(),
                'd': self.state['d'].state_dict(),
                'd_opt': self.state['d_opt'].state_dict(),
            }
        else:  # whole tensors, the unplaced layout
            names, d = self._full_names, self.state['d']
            d_names = [n for n, _ in d.named_parameters()]
            state = {
                'model': self._full_model_state(self.vqvae),
                'g_opt': self._syncs['g'].full_state(
                    self.state['g_opt'], self.vqvae, names, names),
                'd': {k: v.cpu() for k, v in d.state_dict().items()},
                'd_opt': self._syncs['d'].full_state(
                    self.state['d_opt'], d, d_names, d_names),
            }
        state['step'] = self.state['step']
        state['generator'] = self.state['generator'].get_state()
        for key in ('g_ema', 'code_usage'):
            if key in self.state:
                state[key] = self.state[key]
        if self.mesh is not None and 'g_ema' in self.state:
            state['g_ema'] = self._gather_list(
                self.vqvae, self.state['g_ema'], self._full_names)
        return state

    @torch.no_grad()
    def _load_state_dict(self, state):
        for key in ('g_ema', 'code_usage'):
            if (key in state) != (key in self.state):
                raise ValueError(f'the checkpoint and this trainer disagree '
                                 f'on {key}')
        d = self.state['d']
        if self.mesh is None:
            self.vqvae.load_state_dict(state['model'])
            self.state['g_opt'].load_state_dict(state['g_opt'])
            d.load_state_dict(state['d'])
            self.state['d_opt'].load_state_dict(state['d_opt'])
            ema = state.get('g_ema', ())
        else:
            from ..parallel.mesh import local_state_dict
            names = self._full_names
            d_names = [n for n, _ in d.named_parameters()]
            self.vqvae.load_state_dict(local_state_dict(self.vqvae,
                                                        state['model']))
            d.load_state_dict(state['d'])
            for key, module, ns in (('g', self.vqvae, names),
                                    ('d', d, d_names)):
                sync = self._syncs[key]
                sync.load_full_state(self.state[f'{key}_opt'],
                                     state[f'{key}_opt'], module, ns, ns)
                sync.refresh()
            ema = (self._carve_list(self.vqvae, state['g_ema'], names)
                   if 'g_ema' in state else ())
        self.state['step'] = state['step']
        self.state['generator'].set_state(state['generator'])
        for e, saved in zip(self.state.get('g_ema', ()), ema):
            e.copy_(saved)
        if 'code_usage' in state:
            self.state['code_usage'].copy_(state['code_usage'])

    # -- training -------------------------------------------------------

    def train_step(self, batch):
        """One optimizer update on ``batch`` (batch_size · grad_accum_steps
        images, or (images, ...)); returns the step's metrics, 0-d tensors
        on the device."""
        self._unsync_model()
        imgs = torch.as_tensor(_first_images(self._local_batch(batch)),
                               dtype=torch.float32, device=self.device)
        metrics = self._step(imgs)
        self.steps += self.grad_accum
        return metrics

    def train(self):
        self.log = Log()
        writer = self._writer = self._metric_writer('vqgan')
        restore_sig = self._install_preemption_handler()
        try:
            self._train_loop(writer)
        finally:
            restore_sig()
            writer.close()
            self._writer = None
        if self.steps != getattr(self, '_last_saved_steps', None):
            self.save()  # final partial save interval
        self._sync_model()
        self.finalize_checkpoints()
        print('Train finished!'
              if not self._preempted else 'Train preempted: state saved.')

    def _train_loop(self, writer):
        for epoch in range(self.num_epoch):
            for batch in self.train_dl:
                if self._handle_preemption():
                    return
                prev = self.steps
                metrics = self.train_step(batch)

                if self.steps // self.log_every > prev // self.log_every:
                    m = {k: float(v) for k, v in metrics.items()}
                    if not np.isfinite(m['loss']):  # failure detection (ext.)
                        raise FloatingPointError(
                            f'non-finite loss at step {self.steps}: {m}: '
                            'resume from the last checkpoint with .resume()')
                    m['g lr'] = float(self.g_sched(self.steps))
                    m['d lr'] = float(self.d_sched(self.steps))
                    self.log.update(m)
                    writer.log({
                        'reconstruct loss': m['rec loss'],
                        'perceptual loss': m['per loss'],
                        'g_loss': m['g loss'],
                        'd_loss': m['d loss'],
                        'g_lr': m['g lr'],
                        'd_lr': m['d lr'],
                    }, self.steps)

                if self.steps // self.save_every > prev // self.save_every:
                    self.save()
                if self.steps // self.samp_every > prev // self.samp_every:
                    self.evaluate()

    # -- export and evaluation ------------------------------------------

    def save(self):
        """Model-only ``.npz`` (the averaged weights when EMA is on, which
        the model then keeps) plus the full train state (reference saves
        the model's state_dict only, trainer.py:261-264)."""
        self._sync_model()
        self._last_saved_steps = self.steps
        self.vqvae.save_pretrained(os.path.join(
            self.model_saved_dir, f'vit_vq_step_{self.steps}.npz'))
        path = self._save_state(f'vit_vq_state_{self.steps}.pt')
        self._prune_checkpoints('vit_vq')
        return path

    def evaluate(self):
        """Reconstruct the validation set (one encode per batch): PSNR,
        codebook usage and perplexity into the log (and, with
        ``eval_rfid``, the rFID of reconstructions against inputs), an
        image grid of (input, reconstruction) pairs per batch."""
        self._sync_model()
        all_ids, psnrs, reals, recs = [], [], [], []
        for i, batch in enumerate(self.valid_dl):
            imgs = torch.as_tensor(_first_images(batch), dtype=torch.float32,
                                   device=self.device)
            z, _, ids = self.vqvae.encode(imgs)
            rec = _host(self.vqvae.decode(z))
            imgs = _host(imgs)
            all_ids.append(ids.cpu().numpy())
            psnrs.append(psnr(rec, imgs))
            if self.eval_rfid:
                reals.append(imgs)
                recs.append(rec)
            pairs = np.stack([imgs, rec], axis=1).reshape(-1, *imgs.shape[1:])
            if self.is_main:
                save_image_grid(pairs, os.path.join(
                    self.image_saved_dir, f'step_{self.steps}_{i}.png'))
        if all_ids:  # reconstruction quality and codebook health
            stats = codebook_stats(np.concatenate(all_ids),
                                   self.vqvae.config.n_embed)
            evals = {'codebook usage': stats['usage'],
                     'codebook perplexity': stats['perplexity'],
                     'val psnr': float(np.mean(psnrs))}
            self.log.update(evals)
            if getattr(self, '_writer', None) is not None:
                self._writer.log(evals, self.steps)
        if self.eval_rfid and reals:
            from .metrics import rfid
            val, variant = rfid(np.concatenate(reals), np.concatenate(recs),
                                device=self.device)
            self.log.update({f'val {variant}': val})
            if getattr(self, '_writer', None) is not None:
                self._writer.log({f'val {variant}': val}, self.steps)


class PaintMindTrainer(_TrainerBase):
    """(reference trainer.py:291-437).  ``model`` is a ``Pipeline`` built
    with ``compute_dtype=None`` (fp32 master weights); it is trained in
    place.  With ``ema_decay`` the model holds the averaged trainable
    weights after ``save()``, ``evaluate()``, ``resume()`` and the end of
    ``train()`` (the JAX package's ``_sync_model``); the next
    ``train_step`` puts the raw weights back first."""

    _ckpt_prefix = 'paintmind'

    def __init__(self, model, dataset, num_epoch, valid_size=10,
                 optim_name=None, lr=6e-5, lr_min=1e-5, warmup_steps=5000,
                 warmup_lr_init=1e-6, decay_steps=80000, weight_decay=0.05,
                 batch_size=32, num_workers=8, pin_memory=False,
                 grad_accum_steps=1, mixed_precision='bf16',
                 max_grad_norm=1.0, save_every=10000, sample_every=1000,
                 result_folder=None, log_dir='./log', seed=42, mesh=None,
                 cfg_p=0.1, log_every=1, text_embedder=None, remat=False,
                 zero_sharding=False, ema_decay=None, keep_last=None,
                 pp_microbatches=None, **kwargs):
        # reference kwarg is `optim`; shadowed by the optim module import
        optim_name = optim_name or kwargs.pop('optim', 'lion')
        del pin_memory
        self.grad_accum = grad_accum_steps
        self._setup_mesh(mesh, batch_size, grad_accum_steps,
                         {'zero_sharding': zero_sharding,
                          'pp_microbatches': pp_microbatches})
        # the trainable tensors' names, in trainable_parameters() order
        self._full_names = ['mask_token'] + [
            'transformer.' + n for n, _ in model.transformer.named_parameters()]
        transformer_apply = self._place(model, mesh, batch_size,
                                        pp_microbatches)
        self.model = model
        self.device = model.device
        self.num_epoch = num_epoch
        self.save_every = save_every
        self.keep_last = keep_last
        self.sample_every = sample_every
        self.cfg_p = cfg_p
        self.log_dir = log_dir
        self.log_every = log_every
        self.grad_accum = grad_accum_steps
        self._setup_dirs(result_folder)
        self._text_embedder = text_embedder

        train_loader = kwargs.pop('train_loader', None)
        valid_loader = kwargs.pop('valid_loader', None)
        if kwargs:
            raise TypeError(f'unexpected arguments {sorted(kwargs)}')
        if train_loader is not None:
            # externally built loaders; the train loader must yield
            # batch_size·grad_accum items per host step
            if valid_loader is None:
                raise ValueError('train_loader also requires valid_loader')
            self.train_dl, self.valid_dl = train_loader, valid_loader
        else:
            train_size = len(dataset) - valid_size
            self.train_ds, self.valid_ds = random_split(
                dataset, [train_size, valid_size], seed=seed)
            print(f'train dataset size: {train_size}, '
                  f'valid dataset size: {valid_size}')
            # batch_size·accum images per host step -> one update sees the
            # same effective batch as the reference's accumulate() recipe.
            self.train_dl = DataLoader(self.train_ds,
                                       batch_size * grad_accum_steps,
                                       shuffle=True, seed=seed,
                                       num_workers=num_workers,
                                       rows=self._rows)
            self._own_loader = True
            self.valid_dl = DataLoader(self.valid_ds, 6, shuffle=False,
                                       num_workers=num_workers)

        # microbatch-unit horizon; see _micro_schedule
        iters = max(len(self.train_dl), 1) * grad_accum_steps
        self.scheduler = optim.build_scheduler(
            num_epoch, iters, lr, lr_min, warmup_steps, warmup_lr_init,
            decay_steps)
        tx_sched = _micro_schedule(self.scheduler, grad_accum_steps)
        params = model.trainable_parameters()  # the VQGAN is frozen
        self._sync = None
        opt_params = params
        if mesh is not None:
            from ..parallel.data_parallel import GradSync
            from ..parallel.pipeline_parallel import pp_input_params
            train_steps._fp32_trainable(params, 'Pipeline')
            self._sync = GradSync(
                params, mesh, zero=zero_sharding,
                pipe_sum=pp_input_params(model) if pp_microbatches else ())
            opt_params = self._sync.opt_params
        if optim_name == 'lion':
            opt = optim.lion(opt_params, tx_sched, (0.9, 0.99),
                             weight_decay=weight_decay,
                             max_grad_norm=max_grad_norm)
        elif optim_name == 'adamw':
            opt = optim.adamw(opt_params, tx_sched, (0.9, 0.96),
                              weight_decay=weight_decay,
                              max_grad_norm=max_grad_norm)
        else:
            raise NotImplementedError(optim_name)

        self.ema_decay = ema_decay
        self.state = train_steps.init_pipeline_train_state(
            model, opt, ema_decay=ema_decay, seed=seed)
        self._step = train_steps.make_pipeline_train_step(
            model, opt, grad_accum=grad_accum_steps,
            compute_dtype=_dtype_of(mixed_precision), remat=remat,
            ema_decay=ema_decay, state=self.state,
            transformer_apply=transformer_apply, mesh=mesh,
            grad_sync=self._sync)
        # the host-side draws (CFG text dropout, mask ratio) have their own
        # generators so that a resumed run repeats them
        self._py_rng = pyrandom.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self.steps = 0

        n_train = sum(p.numel() for p in params)
        print(f'number of learnable parameters: {n_train // int(1e6)}M')

    @staticmethod
    def _place(model, mesh, batch_size, pp_microbatches):
        """Place ``model`` on ``mesh`` (the JAX package's checks first);
        returns the pipelined transformer apply, or None."""
        if mesh is None:
            return None
        from ..parallel import pipeline_parallel as ppar
        from ..parallel.mesh import shard_params
        stages, dp = mesh.size('model'), mesh.size('data')
        if pp_microbatches:
            if stages < 2:
                raise ValueError(
                    f"mesh 'model' axis is {stages} — pipeline parallelism "
                    'needs >= 2 stages (make_mesh(model_parallel=N))')
            if model.config.depth % stages:
                raise ValueError(f'depth {model.config.depth} must be '
                                 f'divisible by {stages} pipeline stages')
            if batch_size % (dp * pp_microbatches):
                raise ValueError(
                    f'batch_size {batch_size} must be divisible by '
                    f'dp={dp} × pp_microbatches={pp_microbatches}')
            ppar.shard_for_pp(model.transformer, mesh, pp_microbatches)
            return ppar.transformer_apply_for(model.transformer, mesh,
                                              pp_microbatches)
        if stages > 1:
            shard_params(model, mesh)
        return None

    def _local_names(self):
        names = {id(p): n for n, p in self.model.named_parameters()}
        return [names[id(p)] for p in self.model.trainable_parameters()]

    # -- state for save / resume ----------------------------------------

    def _state_dict(self):
        if self.mesh is not None:
            return self._mesh_state_dict()
        state = {
            'model': self._raw_state_dict(self.model),
            'opt': self.state['opt'].state_dict(),
            'step': self.state['step'],
            'generator': self.state['generator'].get_state(),
            'sample_generator': self.model._generator.get_state(),
            'py_rng': self._py_rng.getstate(),
            'np_rng': self._np_rng.bit_generator.state,
        }
        if 'ema' in self.state:
            state['ema'] = self.state['ema']
        return state

    @torch.no_grad()
    def _load_state_dict(self, state):
        if ('ema' in state) != ('ema' in self.state):
            raise ValueError('the checkpoint and this trainer disagree on '
                             'ema_decay')
        ema = state.get('ema', ())
        if self.mesh is None:
            self.model.load_state_dict(state['model'])
            self.state['opt'].load_state_dict(state['opt'])
        else:
            from ..parallel.mesh import local_state_dict
            names = self._local_names()
            self.model.load_state_dict(local_state_dict(self.model,
                                                        state['model']))
            self._sync.load_full_state(self.state['opt'], state['opt'],
                                       self.model, names, self._full_names)
            self._sync.refresh()
            if ema:
                ema = self._carve_list(self.model, ema, names)
        self.state['step'] = state['step']
        self.state['generator'].set_state(state['generator'])
        self.model._generator.set_state(state['sample_generator'])
        self._py_rng.setstate(state['py_rng'])
        self._np_rng.bit_generator.state = state['np_rng']
        for e, saved in zip(self.state.get('ema', ()), ema):
            e.copy_(saved)

    def _mesh_state_dict(self):
        """The unplaced trainer's state, gathered whole over the mesh."""
        names = self._local_names()
        state = {
            'model': self._full_model_state(self.model),
            'opt': self._sync.full_state(self.state['opt'], self.model, names,
                                         self._full_names),
            'step': self.state['step'],
            'generator': self.state['generator'].get_state(),
            'sample_generator': self.model._generator.get_state(),
            'py_rng': self._py_rng.getstate(),
            'np_rng': self._np_rng.bit_generator.state,
        }
        if 'ema' in self.state:
            state['ema'] = self._gather_list(self.model, self.state['ema'],
                                             names)
        return state

    def _ema_pairs(self):
        if 'ema' not in self.state:
            return None
        return self.model.trainable_parameters(), self.state['ema']

    # -- one host step --------------------------------------------------

    def _embed(self, text):
        """captions -> (B, 77, t5_dim) embeddings on the device, or None."""
        if text is None:
            return None
        if isinstance(text, (np.ndarray, torch.Tensor)) and text.ndim == 3:
            ctx = text
        elif self._text_embedder is not None:
            ctx = self._text_embedder(text)
        else:
            return self.model.embed_text(list(text))
        return torch.as_tensor(ctx, dtype=torch.float32, device=self.device)

    def train_step(self, batch):
        """One optimizer update on ``batch`` (images or (images, captions),
        batch_size · grad_accum_steps of them); returns the step's metrics
        with ``loss`` still on the device."""
        self._unsync_model()
        batch = self._local_batch(batch)
        imgs, text = batch if isinstance(batch, (tuple, list)) else (batch, None)
        if self._py_rng.random() < self.cfg_p:  # CFG dropout (ref :387-388)
            text = None
        context = self._embed(text)
        imgs = torch.as_tensor(imgs, dtype=torch.float32, device=self.device)
        mask_ratio = masked_p_generator(self._np_rng)
        metrics = self._step(imgs, context, mask_ratio)
        self.steps += self.grad_accum
        return metrics

    def train(self):
        self.log = Log()
        writer = self._writer = self._metric_writer('paintmind')
        restore_sig = self._install_preemption_handler()
        try:
            self._train_loop(writer)
        finally:
            restore_sig()
            writer.close()
        if self.steps != getattr(self, '_last_saved_steps', None):
            self.save()  # final partial save interval
        self._sync_model()
        self.finalize_checkpoints()
        self.model.eval()
        print('Train finished!'
              if not self._preempted else 'Train preempted: state saved.')

    def _train_loop(self, writer):
        for epoch in range(self.num_epoch):
            for batch in self.train_dl:
                if self._handle_preemption():
                    return
                prev = self.steps
                metrics = self.train_step(batch)

                if self.steps // self.log_every > prev // self.log_every:
                    m = {'loss': float(metrics['loss']),
                         'lr': float(self.scheduler(self.steps))}
                    # the MoE versions' routing health: a collapsing router
                    # (expert load max -> 1) or tokens over capacity
                    for k in ('lb loss', 'router z', 'dropped'):
                        if k in metrics:
                            m[k] = float(metrics[k])
                    if 'expert load' in metrics:
                        load = metrics['expert load']
                        m['expert load max'] = float(load.max())
                        m['expert load min'] = float(load.min())
                    if not np.isfinite(m['loss']):  # failure detection (ext.)
                        raise FloatingPointError(
                            f'non-finite loss at step {self.steps}: '
                            'resume from the last checkpoint with .resume()')
                    self.log.update(m)
                    writer.log(m, self.steps)

                if self.steps // self.sample_every > prev // self.sample_every:
                    self.evaluate()
                if self.steps // self.save_every > prev // self.save_every:
                    self.save()

    # -- export and evaluation ------------------------------------------

    def save(self):
        """Model-only ``.npz`` (the averaged weights when EMA is on, which
        the model then keeps) plus the full train state (raw weights and
        averages)."""
        self._sync_model()
        self._last_saved_steps = self.steps
        self.model.save_pretrained(os.path.join(
            self.model_saved_dir, f'paintmind_step_{self.steps}.npz'))
        path = self._save_state(f'paintmind_state_{self.steps}.pt')
        self._prune_checkpoints('paintmind')
        return path

    def evaluate(self):
        self.model.eval()
        self._sync_model()
        for i, batch in enumerate(self.valid_dl):
            imgs, text = (batch if isinstance(batch, (tuple, list))
                          else (batch, None))
            context = self._embed(text)
            # caption-less datasets eval unconditionally: still sample a
            # full batch (generate defaults to ONE sample with no context)
            gens = self.model.generate(text=context, timesteps=18,
                                       temperature=1.0, topk=5,
                                       save_interval=2,
                                       num_samples=len(imgs))
            all_imgs = np.concatenate([_host(imgs)]
                                      + [_host(g) for g in gens], axis=0)
            if self.is_main:
                save_image_grid(all_imgs, os.path.join(
                    self.image_saved_dir, f'step_{self.steps}_{i}.png'))
