"""Text-to-image / inpaint / outpaint on a trained pipeline, on one card.
The JAX package's ``scripts/generate.py`` with ``--device``; the samples
are drawn from a ``torch.Generator`` on the device seeded with ``--seed``.
The port downloads nothing: ``--checkpoint`` is required in practice."""

import argparse


def build_parser():
    p = argparse.ArgumentParser(
        prog='python -m paintmind_tpu_torch.scripts.generate',
        description=__doc__)
    p.add_argument('prompts', nargs='*', help='text prompts')
    p.add_argument('--checkpoint', default=None,
                   help='pipeline checkpoint (.npz or reference .pt); the '
                        'port downloads nothing, so there is no default')
    p.add_argument('--version', default='paintmindv1')
    p.add_argument('--timesteps', type=int, default=18)
    p.add_argument('--temperature', type=float, default=1.0)
    p.add_argument('--topk', type=int, default=5)
    p.add_argument('--guidance-scale', type=float, default=None)
    p.add_argument('--negative', default=None,
                   help='negative prompt (guidance pushes away from it)')
    p.add_argument('--cfg-warmup', type=float, default=0.0,
                   help='fraction of early steps run unguided (throughput '
                        'lever; 0 = guidance on every step)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--out', default='samples.png')
    p.add_argument('--mode', default='generate',
                   choices=['generate', 'inpaint', 'outpaint'])
    p.add_argument('--image', default=None, help='input image for in/outpaint')
    p.add_argument('--rect', default='64,64,128,128',
                   help='x,y,h,w pixel rect for in/outpaint')
    p.add_argument('--device', default='cuda',
                   help="device to sample on ('cuda', 'cuda:1', or 'cpu')")
    return p


def main(argv=None):
    """Sample and write ``--out``; returns the images written, (B, H, W, 3)
    float32 in [-1, 1]."""
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..factory import create_model
    from ..utils.image_grid import save_image_grid

    # pretrained=True: without --checkpoint the factory raises (the port
    # downloads nothing) instead of sampling from random weights
    model = create_model(arch='pipeline', version=args.version,
                         pretrained=True, checkpoint_path=args.checkpoint,
                         device=args.device)
    generator = torch.Generator(device=model.device).manual_seed(args.seed)

    if args.mode == 'generate':
        imgs = model.generate(text=list(args.prompts) or None,
                              timesteps=args.timesteps,
                              temperature=args.temperature, topk=args.topk,
                              guidance_scale=args.guidance_scale,
                              generator=generator, cfg_warmup=args.cfg_warmup,
                              negative_text=([args.negative]
                                             if args.negative else None),
                              num_samples=max(len(args.prompts), 1),
                              decode_steps='final')[-1]
    else:
        if args.image is None:
            raise SystemExit(f'--mode {args.mode} needs --image')
        from PIL import Image

        from ..utils.transform import stage2_transform
        img = stage2_transform(img_size=model.image_size, is_train=False)(
            Image.open(args.image).convert('RGB'))[None]
        coord = tuple(int(v) for v in args.rect.split(','))
        fn = model.inpaint if args.mode == 'inpaint' else model.outpaint
        imgs = fn(img, coord, text=list(args.prompts) or None,
                  timesteps=args.timesteps, topk=args.topk,
                  temperature=args.temperature, generator=generator,
                  guidance_scale=args.guidance_scale)
    imgs = imgs.float().cpu().numpy()
    save_image_grid(imgs, args.out)
    print(f'wrote {args.out}')
    return imgs


if __name__ == '__main__':
    main()
