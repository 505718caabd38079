"""Stage-2 MaskGIT training on one card (README recipe defaults:
reference README.md:168-191 — adamw/lion, lr 1e-4→1e-5, warmup 10k,
wd 0.05, decay 80k, batch 16, accum 8, bf16).  The JAX package's
``scripts/train_paintmind.py`` with ``--device``.  Under ``torchrun --nproc_per_node N`` it
trains data-parallel over the N ranks (one pure-DP mesh, as the JAX
script builds over every device); run alone, on one card.
The port downloads nothing: without ``--stage1-checkpoint`` it needs
``--stage1-random``."""

import argparse


def build_parser():
    p = argparse.ArgumentParser(
        prog='python -m paintmind_tpu_torch.scripts.train_paintmind',
        description=__doc__)
    p.add_argument('--dataset', required=True,
                   help='coco:<root> | imagenet:<root> | diffusiondb:<ver> '
                        '| folder:<dir> (captionless → unconditional)')
    p.add_argument('--version', default='paintmindv1')
    p.add_argument('--stage1-checkpoint', default=None,
                   help='local stage-1 weights (.npz/.pt); the port '
                        'downloads nothing, so without it pass '
                        '--stage1-random')
    p.add_argument('--stage1-random', action='store_true',
                   help='train against a RANDOM frozen tokenizer '
                        '(debug/smoke only — generated images will be '
                        'garbage)')
    p.add_argument('--epochs', type=int, default=40)
    p.add_argument('--optim', default='lion', choices=['lion', 'adamw'])
    p.add_argument('--batch-size', type=int, default=16)
    p.add_argument('--grad-accum', type=int, default=8)
    p.add_argument('--lr', type=float, default=1e-4)
    p.add_argument('--lr-min', type=float, default=1e-5)
    p.add_argument('--warmup-steps', type=int, default=10000)
    p.add_argument('--decay-steps', type=int, default=80000)
    p.add_argument('--weight-decay', type=float, default=0.05)
    p.add_argument('--mixed-precision', default='bf16')
    p.add_argument('--result-folder', default='./results/paintmind')
    p.add_argument('--log-dir', default='./log')
    p.add_argument('--save-every', type=int, default=10000)
    p.add_argument('--keep-last', type=int, default=None,
                   help='retention: keep only the newest N '
                        'checkpoint generations')
    p.add_argument('--sample-every', type=int, default=1000)
    p.add_argument('--resume', default=None)
    p.add_argument('--num-workers', type=int, default=8)
    p.add_argument('--remat', action='store_true',
                   help='recompute the transformer blocks in the backward '
                        'pass (less activation memory)')
    p.add_argument('--ema-decay', type=float, default=None)
    p.add_argument('--cfg-p', type=float, default=0.1,
                   help='caption-dropout probability (CFG training)')
    p.add_argument('--valid-size', type=int, default=10)
    p.add_argument('--native-loader', action='store_true',
                   help='use the C++ pipelined loader (folder:<dir> of '
                        'JPEGs only; unconditional)')
    p.add_argument('--device-cache', action='store_true',
                   help='cache the whole corpus in device memory and '
                        'augment there (folder:<dir> only)')
    p.add_argument('--device', default='cuda',
                   help="device to train on ('cuda', 'cuda:1', or 'cpu')")
    return p


def main(argv=None):
    """Train; returns the trainer."""
    args = build_parser().parse_args(argv)
    from ..parallel.mesh import launch_mesh
    mesh = launch_mesh(args.device)
    if mesh is not None:
        args.device = str(mesh.device)

    from ..config import ver2cfg
    from ..factory import create_pipeline_for_train
    from ..utils.trainer import PaintMindTrainer
    from ..utils.transform import stage2_transform

    # image size follows the version's stage-1 tokenizer config
    stage1_version = ver2cfg[args.version]['stage1']
    img_size = ver2cfg[stage1_version]['enc']['image_size']
    transform = stage2_transform(img_size=img_size, is_train=True)
    kind, _, root = args.dataset.partition(':')
    if kind == 'coco':
        from ..utils.datasets import CoCo
        dataset = CoCo(root, transform=transform)
    elif kind == 'imagenet':
        from ..utils.datasets import ImageNet
        dataset = ImageNet(root, transform=transform)
    elif kind == 'diffusiondb':
        from ..utils.datasets import DiffusionDB
        dataset = DiffusionDB(root or 'large_random_100k',
                              transform=transform)
    elif kind == 'folder':
        from ..utils.datasets import ImageFolder
        dataset = ImageFolder(root, transform=transform)
    else:
        raise SystemExit(f'unknown dataset spec {args.dataset!r}')

    train_loader = valid_loader = None
    # hflip=False in both fast paths: stage-2 transform parity (no flip;
    # reference transform.py:23-34 — flips would break text-image alignment)
    if args.device_cache:
        if kind != 'folder':
            raise SystemExit('--device-cache needs a folder:<dir> dataset')
        from ..utils.device_cache import make_split_cache_loaders
        train_loader, valid_loader = make_split_cache_loaders(
            dataset.paths, args.batch_size * args.grad_accum,
            args.batch_size, valid_size=args.valid_size, hflip=False,
            img_size=img_size, device=args.device)
    elif args.native_loader:
        if kind != 'folder':
            raise SystemExit('--native-loader needs a folder:<dir> dataset')
        from ..native.fastloader import make_split_loaders
        train_loader, valid_loader = make_split_loaders(
            dataset.paths, args.batch_size * args.grad_accum,
            args.batch_size, valid_size=args.valid_size, hflip=False,
            img_size=img_size, num_workers=args.num_workers)

    model = create_pipeline_for_train(
        version=args.version,
        stage1_pretrained=not args.stage1_random,
        stage1_checkpoint_path=args.stage1_checkpoint, device=args.device)
    trainer = PaintMindTrainer(
        model, dataset, num_epoch=args.epochs, optim_name=args.optim,
        lr=args.lr, lr_min=args.lr_min, warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps, weight_decay=args.weight_decay,
        batch_size=args.batch_size, grad_accum_steps=args.grad_accum,
        mixed_precision=args.mixed_precision, save_every=args.save_every,
        keep_last=args.keep_last, sample_every=args.sample_every,
        result_folder=args.result_folder, log_dir=args.log_dir,
        num_workers=args.num_workers, remat=args.remat,
        ema_decay=args.ema_decay, cfg_p=args.cfg_p,
        valid_size=args.valid_size, train_loader=train_loader,
        valid_loader=valid_loader, mesh=mesh)
    if args.resume:
        trainer.resume(args.resume)
    trainer.train()
    if mesh is not None:
        from ..parallel.multihost import shutdown
        shutdown()
    return trainer


if __name__ == '__main__':
    main()
