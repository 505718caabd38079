"""Convert reference PyTorch checkpoints (.pt state_dicts, e.g. the
published RootYuan/vit-s-vqgan.pt) to the JAX package's .npz layout, which
both packages load, and optionally LPIPS weights from the torch `lpips`
package.  The JAX package's ``scripts/convert_checkpoint.py``: the same
keys and values in the archive."""

import argparse


def build_parser():
    p = argparse.ArgumentParser(
        prog='python -m paintmind_tpu_torch.scripts.convert_checkpoint',
        description=__doc__)
    p.add_argument('src', help='.pt path, or "lpips" to convert LPIPS-VGG')
    p.add_argument('dst', help='output .npz path')
    p.add_argument('--model', default='vqgan',
                   choices=['vqgan', 'pipeline', 'cond_transformer'])
    p.add_argument('--device', default='cuda',
                   help='taken by every command of the port; a conversion '
                        'reads and writes host memory only')
    return p


def main(argv=None):
    """Convert; returns the path written."""
    args = build_parser().parse_args(argv)

    import numpy as np

    from ..convert.from_jax import flatten_tree
    from ..utils.checkpoint import load_reference, to_numpy

    if args.src == 'lpips':
        try:
            import lpips as torch_lpips  # the pip package + its VGG weights
        except ImportError as e:
            raise SystemExit(
                "convert_checkpoint lpips needs the 'lpips' package (and "
                'the torchvision VGG16 weights it loads), which is not '
                f'installed here: {e}') from e
        from ..models.lpips import convert_lpips
        flat = flatten_tree(convert_lpips(torch_lpips.LPIPS(net='vgg')))
    else:
        flat = load_reference(args.src, args.model)  # refuses a trainer state
    np.savez(args.dst, **dict(to_numpy(k, v) for k, v in flat.items()))
    print(f'wrote {args.dst}')
    return args.dst


if __name__ == '__main__':
    main()
