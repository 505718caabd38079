"""Serve text-to-image generation, paint and reconstruction over HTTP on the
card (``scripts/serve.py`` of the JAX package, with ``--device``).

Example:
  python -m paintmind_tpu_torch.serving --checkpoint ./results/pipeline.npz \\
      --stage1-checkpoint paintmind_tpu/assets/vit_vq_photo.npz --port 8000
  curl -s localhost:8000/generate -d '{"timesteps": 16, "seed": 0}'

On N GPUs of one host, under torchrun, the pipeline is tensor-parallel over
the N ranks (rank 0 serves HTTP, the others run its batches in lockstep):
  torchrun --nproc_per_node N -m paintmind_tpu_torch.serving \\
      --stage1-checkpoint ...
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m paintmind_tpu_torch.serving', description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--version', default='paintmindv1')
    p.add_argument('--checkpoint', default=None,
                   help='pipeline checkpoint (.npz, the JAX package layout)')
    p.add_argument('--stage1-checkpoint', default=None,
                   help='stage-1 VQGAN checkpoint when serving without a '
                        'full pipeline checkpoint')
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=8000)
    p.add_argument('--max-batch', type=int, default=16)
    p.add_argument('--max-wait-ms', type=float, default=20.0)
    p.add_argument('--max-queue', type=int, default=None,
                   help='bound the request queue; full queue returns 503')
    p.add_argument('--timesteps', type=int, default=16)
    p.add_argument('--topk', type=int, default=5)
    p.add_argument('--no-text-encoder', action='store_true',
                   help='serve unconditional / precomputed-context requests '
                        'only (no T5 is built)')
    p.add_argument('--tower-checkpoint', default=None,
                   help='conditioning-tower params (.npz), e.g. the tower.npz '
                        'of an image-variations pipeline (/variations)')
    p.add_argument('--quantize', choices=('w8', 'w8a8'), default=None,
                   help='int8-quantize the stage-2 transformer after '
                        'loading (nn/quant.py): w8a8 = int8 products '
                        '(cuBLASLt on the card), w8 = weight-only (int8 '
                        'weights cast to bf16 per product)')
    p.add_argument('--device', default='cuda',
                   help="device to serve on ('cuda', 'cuda:1', or 'cpu')")
    args = p.parse_args(argv)

    import torch

    from ..config import Config, ver2cfg
    from ..parallel import multihost
    from ..models.pipeline import Pipeline
    from .server import serve

    if args.tower_checkpoint:
        from ..models.clip import load_image_tower
        text_encoder = load_image_tower(args.tower_checkpoint,
                                        dtype=torch.bfloat16,
                                        device=args.device)
    else:
        text_encoder = None if args.no_text_encoder else 'auto'
    engine_kw = {}
    if multihost.launched():  # every rank on the 'model' axis
        multihost.initialize(device='cpu' if args.device == 'cpu' else 'cuda')
        from ..parallel.mesh import make_mesh
        mesh = make_mesh(model_parallel=multihost.world_size())
        args.device = str(mesh.device)
        engine_kw = dict(mesh=mesh)
    pipe = Pipeline(config=Config(ver2cfg[args.version]),
                    stage1_pretrained=False,
                    stage1_checkpoint_path=args.stage1_checkpoint,
                    text_encoder=text_encoder, compute_dtype=torch.bfloat16,
                    device=args.device)
    if args.checkpoint:
        pipe.from_pretrained(args.checkpoint)
    if args.quantize:
        pipe.quantize(args.quantize)
    serve(pipe, args.host, args.port, max_batch=args.max_batch,
          max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
          defaults={'timesteps': args.timesteps, 'topk': args.topk},
          **engine_kw)
    multihost.shutdown()


if __name__ == '__main__':
    main()
