"""The system under test: the PyTorch port, built from a configuration file
and loaded with the benchmark's weights.  Only the traffic generators import this."""

from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def build_pipeline(config, weights, device, text_encoder=None, train=False):
    """A ``Pipeline`` of ``config`` holding a copy of ``weights``: in its
    compute type, or with fp32 master weights to ``train``;
    ``text_encoder`` its tower (None: the traffic brings contexts)."""
    import paintmind_tpu_torch as pt
    name = 'bench-' + config['name']
    pt.register_version(name + '-stage1', config['stage1'])
    pt.register_version(name, dict(config['pipeline'], stage1=name + '-stage1'))
    pipe = pt.create_model('pipeline', name, pretrained=False, device=device,
                           text_encoder=text_encoder,
                           compute_dtype=None if train else
                           DTYPES[config['compute_dtype']])
    pipe.load_state_dict(weights, strict=True)
    return pipe


def kernel_counters():
    """The port's kernel launch counters: K1 forward, K4 backward, K3 and
    K3r sampling."""
    from paintmind_tpu_torch.ops import flash_attention as fa
    from paintmind_tpu_torch.ops import sampling as sm
    return {'K1': fa.launches, 'K4': fa.launches_bwd, 'K3': sm.launches,
            'K3r': sm.launches_radix}


def routed_layers(pipe):
    """The routed FFN modules of an MoE pipeline (none for a dense one)."""
    return [blk.ffnet for blk in pipe.transformer.layers
            if hasattr(blk.ffnet, 'router')]
