"""The command lines of the port: the JAX package's ``scripts/`` with the
same options and defaults, plus ``--device`` (default ``cuda``).

    python -m paintmind_tpu_torch.scripts.train_vqgan --dataset folder:<dir>
    python -m paintmind_tpu_torch.scripts.train_paintmind --dataset ...
    python -m paintmind_tpu_torch.scripts.generate "a prompt" --checkpoint ...
    python -m paintmind_tpu_torch.scripts.convert_checkpoint in.pt out.npz

Each module has ``main(argv=None)``.  One card needs no device mesh: the
multi-GPU options wait for ROADMAP queue A item 10.
"""
