"""Stage-1 ViT-VQGAN training on one card (README recipe defaults:
reference README.md:81-101 — lr 1e-4→5e-5, warmup 50k from 1e-6, decay 100k,
batch 16, accum 8, bf16, clip 1.0).  The JAX package's
``scripts/train_vqgan.py`` with ``--device``; one card needs no mesh."""

import argparse


def build_parser():
    p = argparse.ArgumentParser(
        prog='python -m paintmind_tpu_torch.scripts.train_vqgan',
        description=__doc__)
    p.add_argument('--dataset', required=True,
                   help='imagenet:<root> | coco:<root> | folder:<dir>')
    p.add_argument('--version', default='vit-s-vqgan')
    p.add_argument('--epochs', type=int, default=100)
    p.add_argument('--batch-size', type=int, default=16)
    p.add_argument('--grad-accum', type=int, default=8)
    p.add_argument('--lr', type=float, default=1e-4)
    p.add_argument('--lr-min', type=float, default=5e-5)
    p.add_argument('--warmup-steps', type=int, default=50000)
    p.add_argument('--warmup-lr-init', type=float, default=1e-6)
    p.add_argument('--decay-steps', type=int, default=100000)
    p.add_argument('--mixed-precision', default='bf16')
    p.add_argument('--result-folder', default='./results/vqgan')
    p.add_argument('--log-dir', default='./log')
    p.add_argument('--save-every', type=int, default=10000)
    p.add_argument('--keep-last', type=int, default=None,
                   help='retention: keep only the newest N '
                        'checkpoint generations')
    p.add_argument('--sample-every', type=int, default=1000)
    p.add_argument('--resume', default=None)
    p.add_argument('--num-workers', type=int, default=8)
    p.add_argument('--perceptual', default='auto',
                   help="LPIPS weights: 'auto' (converted npz; errors if "
                        "absent), a path, 'random', or 'none'")
    p.add_argument('--d-weight', type=float, default=0.1,
                   help='adversarial (non-saturating G) loss weight')
    p.add_argument('--init-checkpoint', default=None,
                   help='model weights (.npz/.pt) to fine-tune FROM '
                        '(fresh optimizer state; --resume restores a full '
                        'train state instead)')
    p.add_argument('--ema-decay', type=float, default=None,
                   help='EMA decay for eval/export weights (e.g. 0.999)')
    p.add_argument('--codebook-restart-every', type=int, default=None,
                   help='re-seed dead codebook entries every N steps')
    p.add_argument('--log-every', type=int, default=1,
                   help='metric-fetch cadence in steps (higher = fewer '
                        'device->host syncs)')
    p.add_argument('--eval-rfid', action='store_true',
                   help='also compute rFID on the validation set each eval '
                        '(not ported)')
    p.add_argument('--native-loader', action='store_true',
                   help='use the C++ pipelined loader (folder:<dir> of '
                        'JPEGs only) instead of the threaded-PIL DataLoader')
    p.add_argument('--device-cache', action='store_true',
                   help='cache the whole corpus in device memory and '
                        'augment there (not ported)')
    p.add_argument('--device', default='cuda',
                   help="device to train on ('cuda', 'cuda:1', or 'cpu')")
    return p


def main(argv=None):
    """Train; returns the trainer."""
    args = build_parser().parse_args(argv)

    from ..config import ver2cfg
    from ..factory import create_model
    from ..models.pipeline import _not_ported
    from ..utils.trainer import VQGANTrainer
    from ..utils.transform import stage1_transform

    # refuse before building anything
    if args.device_cache:
        raise _not_ported('--device-cache (device-side data)', 11)
    if args.eval_rfid:
        raise _not_ported('--eval-rfid (rFID)', 11)

    # image size follows the version config (e.g. vit-s-vqgan-512)
    img_size = ver2cfg[args.version]['enc']['image_size']
    transform = stage1_transform(img_size=img_size, is_train=True)
    kind, _, root = args.dataset.partition(':')
    if kind == 'imagenet':
        from ..utils.datasets import ImageNet
        dataset = ImageNet(root, transform=transform)
    elif kind == 'coco':
        from ..utils.datasets import CoCo
        dataset = CoCo(root, transform=transform)
    elif kind == 'folder':
        from ..utils.datasets import ImageFolder
        dataset = ImageFolder(root, transform=transform)
    else:
        raise SystemExit(f'unknown dataset spec {args.dataset!r}')

    train_loader = valid_loader = None
    if args.native_loader:
        if kind != 'folder':
            raise SystemExit('--native-loader needs a folder:<dir> dataset')
        from ..native.fastloader import make_split_loaders
        train_loader, valid_loader = make_split_loaders(
            dataset.paths, args.batch_size * args.grad_accum,
            args.batch_size, img_size=img_size,
            num_workers=args.num_workers)

    model = create_model(arch='vqgan', version=args.version,
                         pretrained=False,
                         checkpoint_path=args.init_checkpoint,
                         device=args.device)
    trainer = VQGANTrainer(
        model, dataset, num_epoch=args.epochs, lr=args.lr,
        lr_min=args.lr_min, warmup_steps=args.warmup_steps,
        warmup_lr_init=args.warmup_lr_init, decay_steps=args.decay_steps,
        batch_size=args.batch_size, grad_accum_steps=args.grad_accum,
        mixed_precision=args.mixed_precision, save_every=args.save_every,
        keep_last=args.keep_last, sample_every=args.sample_every,
        result_folder=args.result_folder, log_dir=args.log_dir,
        num_workers=args.num_workers, perceptual_weights=args.perceptual,
        d_weight=args.d_weight, ema_decay=args.ema_decay,
        log_every=args.log_every,
        codebook_restart_every=args.codebook_restart_every,
        train_loader=train_loader, valid_loader=valid_loader)
    if args.resume:
        trainer.resume(args.resume)
    trainer.train()
    return trainer


if __name__ == '__main__':
    main()
