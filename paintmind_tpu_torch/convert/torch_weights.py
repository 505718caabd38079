"""Reference (PyTorch) checkpoint -> the JAX package's parameter layout: the
port's own copy of ``paintmind_tpu/convert/torch_weights.py``.

The reference publishes ``RootYuan/vit-s-vqgan`` as a torch ``state_dict``
(.pt); loading is ``load_state_dict(torch.load(path))``
(reference paintmind/stage1/vqmodel.py:43-44, paintmind/factory.py:16-19).
This module maps those state dicts onto the JAX package's trees, which
``convert/from_jax.load_jax_params`` then carries into the port's modules
(one bridge, not two):

  * Linear:  torch (out, in) weight  ->  'kernel' (in, out)
  * patch-embed Conv2d: (out, c, kh, kw) -> (kh·kw·c, out) matmul kernel,
    matching models/vqmodel.patchify's (p1, p2, c) flatten order
  * transformer layers i = 0..depth-1 -> stacked along a leading depth axis
  * SwiGLU: fused 'w12' or split 'w1'/'w2' (xformers packed vs unpacked)
    both accepted; the tree's layout is always fused (in, 2·hidden)

Leaves stay torch tensors on the CPU (a bf16 checkpoint stays bf16).
``to_reference`` is the inverse: a JAX-layout tree written back in the
reference's state-dict layout.
"""

from __future__ import annotations

import torch

from .from_jax import flatten_tree


def _t(t):
    # a copy: the state dict's tensors may be changed in place later
    return t.detach().cpu().clone()


def _linear(sd, prefix, bias=True):
    p = {'kernel': _t(sd[prefix + '.weight']).t().contiguous()}
    if bias and prefix + '.bias' in sd:
        p['bias'] = _t(sd[prefix + '.bias'])
    return p


def _layernorm(sd, prefix):
    return {'scale': _t(sd[prefix + '.weight']), 'bias': _t(sd[prefix + '.bias'])}


def _swiglu(sd, prefix):
    if prefix + '.w12.weight' in sd:
        w12 = _linear(sd, prefix + '.w12')
    else:  # unpacked xformers SwiGLU: w1 / w2
        k = torch.cat([_t(sd[prefix + '.w1.weight']).t(),
                       _t(sd[prefix + '.w2.weight']).t()], dim=-1)
        b = torch.cat([_t(sd[prefix + '.w1.bias']),
                       _t(sd[prefix + '.w2.bias'])], dim=-1)
        w12 = {'kernel': k.contiguous(), 'bias': b}
    return {'w12': w12, 'w3': _linear(sd, prefix + '.w3')}


def _attention(sd, prefix):
    return {
        'to_q': _linear(sd, prefix + '.to_q', bias=False),
        'to_k': _linear(sd, prefix + '.to_k', bias=False),
        'to_v': _linear(sd, prefix + '.to_v', bias=False),
        'to_out': _linear(sd, prefix + '.to_out.0'),
    }


def _stack(per_layer):
    """List of per-layer param dicts -> one dict whose leaves carry a
    leading depth axis."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _stack([p[k] for p in per_layer]) for k in first}
    return torch.stack(per_layer)


def _block(sd, prefix, cross=False):
    p = {
        'norm1': _layernorm(sd, prefix + '.norm1'),
        'attn1': _attention(sd, prefix + '.attn1'),
        'norm2': _layernorm(sd, prefix + '.norm2'),
        'ffnet': _swiglu(sd, prefix + '.ffnet'),
    }
    if cross:
        p['attn2'] = _attention(sd, prefix + '.attn2')
        p['norm3'] = _layernorm(sd, prefix + '.norm3')
    return p


def _depth_of(sd, prefix):
    i = 0
    while f'{prefix}.{i}.norm1.weight' in sd:
        i += 1
    return i


def convert_vqmodel(sd):
    """Reference VQModel state_dict -> the JAX package's VQModel tree
    (layout: paintmind_tpu/models/vqmodel.init_vqmodel)."""
    conv_w = _t(sd['encoder.to_patch_embedding.0.weight'])  # (out,c,kh,kw)
    out_dim = conv_w.shape[0]
    patch_kernel = conv_w.permute(2, 3, 1, 0).reshape(-1, out_dim).contiguous()

    enc_depth = _depth_of(sd, 'encoder.transformer.layers')
    dec_depth = _depth_of(sd, 'decoder.transformer.layers')
    return {
        'encoder': {
            'patch_embed': {'kernel': patch_kernel},
            'pos_embed': _t(sd['encoder.position_embedding']),
            'norm_pre': _layernorm(sd, 'encoder.norm_pre'),
            'layers': _stack([_block(sd, f'encoder.transformer.layers.{i}')
                              for i in range(enc_depth)]),
        },
        'decoder': {
            'pos_embed': _t(sd['decoder.position_embedding']),
            'layers': _stack([_block(sd, f'decoder.transformer.layers.{i}')
                              for i in range(dec_depth)]),
            'norm': _layernorm(sd, 'decoder.norm'),
            'proj': _linear(sd, 'decoder.proj'),
        },
        'quantize': {'codebook': _t(sd['quantize.embedding.weight'])},
        'prev_quant': _linear(sd, 'prev_quant'),
        'post_quant': _linear(sd, 'post_quant'),
    }


def convert_cond_transformer(sd, prefix=''):
    """Reference CondTransformer state_dict -> the JAX package's tree
    (layout: paintmind_tpu/models/transformer.init_cond_transformer)."""
    pre = prefix
    depth = 0
    while f'{pre}layers.layer{depth}.norm1.weight' in sd:
        depth += 1
    p = {
        'token_proj': _linear(sd, pre + 'token_proj'),
        'pos_embed': _t(sd[pre + 'position_embedding']),
        'layers': _stack([_block(sd, f'{pre}layers.layer{i}', cross=True)
                          for i in range(depth)]),
        'norm': _layernorm(sd, pre + 'norm'),
        'to_logits': _linear(sd, pre + 'to_logits'),
    }
    if pre + 'context_proj.weight' in sd:
        p['context_proj'] = _linear(sd, pre + 'context_proj', bias=False)
    return p


def convert_pipeline(sd):
    """Reference Pipeline state_dict (includes the frozen vqgan; T5 weights
    are skipped: the text tower loads from its own files) -> the JAX
    package's Pipeline tree."""
    vq_sd = {k[len('vqgan.'):]: v for k, v in sd.items() if k.startswith('vqgan.')}
    return {
        'vqgan': convert_vqmodel(vq_sd),
        'transformer': convert_cond_transformer(sd, 'transformer.'),
        'mask_token': _t(sd['mask_token']),
    }


CONVERTERS = {'vqgan': convert_vqmodel, 'pipeline': convert_pipeline,
              'cond_transformer': convert_cond_transformer}


def load_torch_state_dict(path):
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if hasattr(sd, 'state_dict'):
        sd = sd.state_dict()
    return sd


# ---------------------------------------------------------------------------
# the inverse: a JAX-layout tree in the reference's state-dict layout
# ---------------------------------------------------------------------------

# stacked layer nodes of the tree -> the reference's per-layer module name
_LAYER_STACKS = {'encoder/layers': 'encoder.transformer.layers.{}',
                 'decoder/layers': 'decoder.transformer.layers.{}',
                 'transformer/layers': 'transformer.layers.layer{}'}
_RENAMED = {'encoder/pos_embed': 'encoder.position_embedding',
            'decoder/pos_embed': 'decoder.position_embedding',
            'transformer/pos_embed': 'transformer.position_embedding',
            'quantize/codebook': 'quantize.embedding.weight'}


def _reference_entries(path, value, split_swiglu):
    """One leaf of the tree ('/'-path inside its module) -> [(dotted
    reference name, tensor)]."""
    *mods, leaf = path.split('/')
    if mods[-1] == 'to_out':
        mods.append('0')  # the reference's to_out is Sequential(Linear, ...)
    if leaf == 'kernel':
        leaf, value = 'weight', value.t()
    elif leaf == 'scale':
        leaf = 'weight'
    if split_swiglu and mods[-1] == 'w12':
        h = value.shape[0] // 2
        base = '.'.join(mods[:-1])
        return [(f'{base}.w1.{leaf}', value[:h]), (f'{base}.w2.{leaf}', value[h:])]
    return [('.'.join(mods + [leaf]), value)]


def to_reference(tree, *, split_swiglu=False):
    """A VQModel or Pipeline tree of the JAX package (nested or flat, keys
    '/'-joined) -> a state dict in the reference's layout, the inverse of
    ``convert_vqmodel`` / ``convert_pipeline``.  ``split_swiglu`` writes
    the feed-forward's fused ``w12`` as xformers' unpacked ``w1`` / ``w2``."""
    sd = {}
    for key, v in flatten_tree(tree).items():
        prefix = ''
        if key.startswith('vqgan/'):
            prefix, key = 'vqgan.', key[len('vqgan/'):]
        if key == 'encoder/patch_embed/kernel':  # (p·p·3, out), RGB input
            out = v.shape[1]
            p = int(round((v.shape[0] // 3) ** 0.5))
            sd[prefix + 'encoder.to_patch_embedding.0.weight'] = \
                v.reshape(p, p, 3, out).permute(3, 2, 0, 1).contiguous()
            continue
        if key in _RENAMED or key == 'mask_token':
            sd[prefix + _RENAMED.get(key, key)] = v
            continue
        stack = next((s for s in _LAYER_STACKS if key.startswith(s + '/')), None)
        layers = ([(_LAYER_STACKS[stack].format(i) + '.', key[len(stack) + 1:],
                    v[i]) for i in range(v.shape[0])] if stack
                  else [('', key, v)])
        for head, path, value in layers:
            for name, t in _reference_entries(path, value, split_swiglu):
                sd[prefix + head + name] = t.contiguous()
    return sd
