"""Configuration system: the port's own copy of ``paintmind_tpu/config.py``.

A mutable attribute container with dict/JSON round-trip, plus the static
model registry ``ver2cfg``.  The hyperparameter values are identical to the
JAX package's, so its parameter trees load one-to-one.
"""

from __future__ import annotations

import json
from copy import deepcopy


class Config:
    """Attribute-bag configuration with dict/JSON round trip.

    Mirrors the public surface of the reference Config
    (paintmind/config.py:4-37): ``to_dict``, ``to_json``, ``to_json_string``,
    ``from_dict``, ``from_json``, ``clear``.
    """

    def __init__(self, config=None):
        if config is not None:
            self.from_dict(config)

    def __repr__(self):
        return self.to_json_string()

    def to_dict(self):
        return deepcopy(vars(self))

    def to_json(self, path):
        with open(path, 'w') as f:
            json.dump(self.to_dict(), f, indent=2)

    def to_json_string(self):
        return json.dumps(self.to_dict(), indent=2)

    def from_dict(self, dct):
        self.clear()
        for key, value in dct.items():
            setattr(self, key, value)
        return self.to_dict()

    def from_json(self, json_path):
        with open(json_path, 'r') as f:
            self.from_dict(json.load(f))
        return self.to_dict()

    def clear(self):
        self.__dict__.clear()

    def get(self, key, default=None):
        return self.__dict__.get(key, default)


# Model hyperparameters — identical values to the reference so converted
# checkpoints are drop-in (reference: paintmind/config.py:40-66).
vit_s_vqgan_config = {
    'n_embed': 8192,
    'embed_dim': 32,
    'beta': 0.25,
    'enc': {
        'image_size': 256,
        'patch_size': 8,
        'dim': 512,
        'depth': 8,
        'num_head': 8,
        'mlp_dim': 2048,
        'in_channels': 3,
        'dim_head': 64,
        'dropout': 0.0,
    },
    'dec': {
        'image_size': 256,
        'patch_size': 8,
        'dim': 512,
        'depth': 8,
        'num_head': 8,
        'mlp_dim': 2048,
        'out_channels': 3,
        'dim_head': 64,
        'dropout': 0.0,
    },
}

# (reference: paintmind/config.py:68-77)
pipeline_v1_config = {
    'stage1': 'vit-s-vqgan',
    't5': 't5-l',
    'dim': 1024,
    'dim_head': 64,
    'mlp_dim': 4096,
    'num_head': 16,
    'depth': 12,
    'dropout': 0.1,
}

# Extension beyond the reference: a 512² variant (4096 latent tokens); the
# kernels and the sampler take any token count, so scaling resolution only
# changes the registry entry.
vit_s_vqgan_512_config = {
    **vit_s_vqgan_config,
    'enc': {**vit_s_vqgan_config['enc'], 'image_size': 512},
    'dec': {**vit_s_vqgan_config['dec'], 'image_size': 512},
}

pipeline_v1_512_config = {
    **pipeline_v1_config,
    'stage1': 'vit-s-vqgan-512',
}

# Extensions beyond the reference: the reference defines CLIP text/image
# embedders but never wires them into a pipeline (dead code,
# paintmind/modules/encoder.py:45-151).  Here they are usable conditioning
# towers: the registry's ``t5`` field names ANY context tower (see
# models/pipeline.CONTEXT_TOWERS).  ``paintmindv1-clip`` conditions on
# CLIP ViT-L-14 text tokens (77×768); ``paintmindv1-imgvar`` conditions on
# CLIP ViT-L-14 *image* patch tokens (256×1024) — an image-variations
# pipeline (generate takes reference images instead of captions).
pipeline_v1_clip_config = {
    **pipeline_v1_config,
    't5': 'clip-l',
}

pipeline_v1_imgvar_config = {
    **pipeline_v1_config,
    't5': 'clip-img-l',
}

# Extension beyond the reference: an expert-parallel MoE stage-2 variant
# — paintmindv1 dims with every block's SwiGLU replaced by an 8-expert top-2
# routed pool (models/moe_transformer.py).
pipeline_v1_moe_config = {
    **pipeline_v1_config,
    'num_experts': 8,
    'num_selected': 2,
    'capacity_factor': 1.25,
}

# The 4-expert MoE variant: same top-2 routing and capacity discipline.
pipeline_v1_moe_4e_config = {
    **pipeline_v1_moe_config,
    'num_experts': 4,
}

# Extension beyond the reference: SDAR-30B-A3B-Chat's decoder stack
# (JetLM, https://huggingface.co/JetLM/SDAR-30B-A3B-Chat, config.json) at its
# published widths as the stage-2 transformer, decoding the image codes by
# block diffusion over a KV cache (models/sdar_transformer.py,
# models/pipeline.generate_blocks).  Its text vocabulary is replaced by the
# VQGAN's 8192 codes; block_len and block_steps are not published.
pipeline_sdar_30b_a3b_config = {
    'stage1': 'vit-s-vqgan',
    't5': 't5-l',
    'block': 'sdar',
    'dim': 2048,
    'dim_head': 128,
    'num_head': 32,
    'kv_heads': 4,
    'depth': 48,
    'mlp_dim': 6144,        # intermediate_size: no dense layer uses it
    'dropout': 0.0,
    'num_experts': 128,
    'num_selected': 8,
    'expert_hidden': 768,
    'capacity_factor': None,  # dropless
    'rope_theta': 1e6,
    'rms_eps': 1e-6,
    'block_len': 64,
    'block_steps': 4,
}

ver2cfg = {
    'vit-s-vqgan': vit_s_vqgan_config,
    'vit-s-vqgan-512': vit_s_vqgan_512_config,
    'paintmindv1': pipeline_v1_config,
    'paintmindv1-512': pipeline_v1_512_config,
    'paintmindv1-clip': pipeline_v1_clip_config,
    'paintmindv1-imgvar': pipeline_v1_imgvar_config,
    'paintmindv1-moe': pipeline_v1_moe_config,
    'paintmindv1-moe-4e': pipeline_v1_moe_4e_config,
    'sdar-30b-a3b': pipeline_sdar_30b_a3b_config,
}


def register_version(name, config):
    """Register a new model version in the ``ver2cfg`` registry so
    ``create_model(version=name)`` and pipeline ``stage1`` references
    resolve it (extension over the reference's static registry)."""
    ver2cfg[name] = dict(config)
    return name
