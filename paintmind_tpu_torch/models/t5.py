"""T5 text encoder, the frozen conditioning tower (``paintmind_tpu/models/t5.py``).

The flan-T5 encoder of the reference's T5TextEmbedder
(paintmind/modules/encoder.py:18-42): max_length 77, padded to the maximum,
frozen, no attention mask (padding positions are attended and embedded, as
the reference passes only ``input_ids``), the last hidden state out.

Architecture (T5 v1.1 / flan): RMSNorm pre-norm with fp32 statistics, a
relative-position-bucket attention bias computed once from layer 0's table
and added in every layer, no 1/sqrt(d) attention scale, a gated feed-forward
with tanh-approximated GELU, the input embedding shared with the output
side, a final RMSNorm.  The attention is plain PyTorch products and softmax,
as the JAX package computes it outside any Pallas kernel (K1 takes no bias).

Weights come from a local Hugging Face flan-t5 directory
(``convert_t5_encoder`` maps a ``T5EncoderModel`` state dict onto
``T5Encoder``), or from the JAX package's parameter tree through
``convert.from_jax.load_tower_params``.  Nothing is downloaded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import Linear
from .vqmodel import make_generator, resolve_device


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6

    @classmethod
    def flan_t5_large(cls):
        return cls()

    @classmethod
    def from_hf(cls, hf_cfg):
        return cls(vocab_size=hf_cfg.vocab_size, d_model=hf_cfg.d_model,
                   d_kv=hf_cfg.d_kv, d_ff=hf_cfg.d_ff,
                   num_layers=hf_cfg.num_layers, num_heads=hf_cfg.num_heads,
                   rel_buckets=hf_cfg.relative_attention_num_buckets,
                   rel_max_distance=hf_cfg.relative_attention_max_distance)


T5_VERSIONS = {  # reference generate.py:52-53
    't5-l': ('google/flan-t5-large', 1024),
    't5-xl': ('google/flan-t5-xl', 2048),
    't5-xxl': ('google/flan-t5-xxl', 4096),
}


def relative_position_bucket(rel_pos, num_buckets=32, max_distance=128):
    """Bidirectional T5 bucket scheme: the log is taken in fp32 and
    truncated to int32, as the JAX package does."""
    num_buckets //= 2
    ret = torch.where(rel_pos > 0, num_buckets, 0)
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9)
        / float(np.log(max_distance / max_exact))
        * (num_buckets - max_exact)).to(torch.int32)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


class RMSNorm(nn.Module):
    """T5's LayerNorm: no mean, no bias; fp32 statistics, output in the
    input's type."""

    def __init__(self, dim, eps, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


def _linear(i, o, device):
    return Linear(i, o, bias=False, device=device)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, *, device=None):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.ln0 = RMSNorm(cfg.d_model, cfg.eps, device=device)
        self.q = _linear(cfg.d_model, inner, device)
        self.k = _linear(cfg.d_model, inner, device)
        self.v = _linear(cfg.d_model, inner, device)
        self.o = _linear(inner, cfg.d_model, device)
        self.ln1 = RMSNorm(cfg.d_model, cfg.eps, device=device)
        self.wi_0 = _linear(cfg.d_model, cfg.d_ff, device)
        self.wi_1 = _linear(cfg.d_model, cfg.d_ff, device)
        self.wo = _linear(cfg.d_ff, cfg.d_model, device)

    def forward(self, x, bias):
        b, l, _ = x.shape
        cfg = self.cfg
        h = self.ln0(x)
        q, k, v = (p(h).reshape(b, l, cfg.num_heads, cfg.d_kv)
                   for p in (self.q, self.k, self.v))
        # no 1/sqrt(d) scale; the relative position bias of layer 0
        logits = torch.einsum('bnhd,bmhd->bhnm', q.float(), k.float()) + bias
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        attn = torch.einsum('bhnm,bmhd->bnhd', probs, v)
        x = x + self.o(attn.reshape(b, l, -1))
        h = self.ln1(x)
        gelu = F.gelu(self.wi_0(h), approximate='tanh')
        return x + self.wo(gelu * self.wi_1(h))


class T5Encoder(nn.Module):
    """The encoder stack: ``t5_encode`` of the JAX package as a module.
    ``forward(input_ids)``: (B, L) ints -> (B, L, d_model) last hidden
    state, computed in ``dtype`` (fp32 by default, as in JAX)."""

    def __init__(self, cfg: T5Config, *, device=None, seed=0):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.rel_bias = nn.Embedding(cfg.rel_buckets, cfg.num_heads,
                                     device=device)
        self.blocks = nn.ModuleList(T5Block(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_ln = RMSNorm(cfg.d_model, cfg.eps, device=device)
        if not self.embed.weight.is_meta:  # a meta build is loaded later
            self.init_weights_(make_generator(self.embed.weight.device, seed))

    @torch.no_grad()
    def init_weights_(self, g):
        """Seeded random weights in the JAX init's scheme (normal kernels
        scaled by fan_in^-0.5, a normal embedding, a 0.1-scaled bias table,
        unit norms); the numbers are torch's, not jax.random's."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(generator=g).mul_(m.in_features ** -0.5)
        self.embed.weight.normal_(generator=g)
        self.rel_bias.weight.normal_(generator=g).mul_(0.1)

    def position_bias(self, qlen, klen):
        """(1, H, q, k) fp32 bias from the bucketed relative positions."""
        device = self.rel_bias.weight.device
        ctx = torch.arange(qlen, device=device)[:, None]
        mem = torch.arange(klen, device=device)[None, :]
        buckets = relative_position_bucket(mem - ctx, self.cfg.rel_buckets,
                                           self.cfg.rel_max_distance)
        bias = self.rel_bias.weight.float()[buckets]  # (q, k, H)
        return bias.permute(2, 0, 1)[None]

    def forward(self, input_ids, dtype=torch.float32):
        x = self.embed.weight[input_ids.long()].to(dtype)
        l = x.shape[1]
        bias = self.position_bias(l, l)
        for block in self.blocks:
            x = block(x, bias)
        return self.final_ln(x)


def convert_t5_encoder(sd, prefix=''):
    """Hugging Face ``T5EncoderModel`` state dict -> ``T5Encoder`` state dict
    (both keep torch's (out, in) weights; the relative bias table lives in
    layer 0)."""
    def g(name):
        return torch.as_tensor(sd[prefix + name]).detach().clone()

    out = {}
    i = 0
    while f'{prefix}encoder.block.{i}.layer.0.SelfAttention.q.weight' in sd:
        base = f'encoder.block.{i}.layer.'
        for ours, theirs in (('ln0', '0.layer_norm'), ('q', '0.SelfAttention.q'),
                             ('k', '0.SelfAttention.k'), ('v', '0.SelfAttention.v'),
                             ('o', '0.SelfAttention.o'), ('ln1', '1.layer_norm'),
                             ('wi_0', '1.DenseReluDense.wi_0'),
                             ('wi_1', '1.DenseReluDense.wi_1'),
                             ('wo', '1.DenseReluDense.wo')):
            out[f'blocks.{i}.{ours}.weight'] = g(f'{base}{theirs}.weight')
        i += 1
    embed_key = ('shared.weight' if prefix + 'shared.weight' in sd
                 else 'encoder.embed_tokens.weight')
    out['embed.weight'] = g(embed_key)
    out['rel_bias.weight'] = g('encoder.block.0.layer.0.SelfAttention.'
                               'relative_attention_bias.weight')
    out['final_ln.weight'] = g('encoder.final_layer_norm.weight')
    return out


class T5TextEncoder:  # reference name: T5TextEmbedder (alias below)
    """Frozen text tower with the reference T5TextEmbedder call contract:
    ``encoder(list_of_strings) -> (B, 77, d_model)``; (B, L) token ids are
    taken too.  ``model`` is the ``T5Encoder`` (frozen, on ``device``).

    Without ``model`` the weights and the tokenizer load from ``version``, a
    local Hugging Face flan-t5 directory or an entry of the local Hugging
    Face cache (``transformers`` is imported then, and only then; nothing is
    downloaded).  ``tokenizer``: a callable with the Hugging Face tokenizer
    contract (``tokenizer(texts, truncation=True, max_length=...,
    padding='max_length', return_tensors='np')['input_ids']``)."""

    def __init__(self, version='google/flan-t5-large', max_length=77,
                 dtype=torch.float32, model=None, cfg=None, tokenizer=None,
                 device='cuda'):
        self.version = version
        self.max_length = max_length
        self.dtype = dtype
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        if model is None:
            model, self.tokenizer = self._load(version)
        self.model = model.to(self.device).requires_grad_(False).eval()
        self.cfg = cfg or model.cfg

    def _load(self, version):
        try:
            import transformers
        except ImportError as e:
            raise RuntimeError(
                f'T5TextEncoder({version!r}) loads its weights with the '
                "'transformers' package, which is not installed: pass model= "
                '(a T5Encoder with its weights), or precomputed contexts') from e
        hf_cfg = transformers.AutoConfig.from_pretrained(version,
                                                         local_files_only=True)
        hf = transformers.T5EncoderModel.from_pretrained(version,
                                                         local_files_only=True)
        cfg = T5Config.from_hf(hf_cfg)
        model = T5Encoder(cfg, device='meta').to_empty(device='cpu')
        model.load_state_dict(convert_t5_encoder(hf.state_dict()))
        try:
            tok = transformers.AutoTokenizer.from_pretrained(
                version, local_files_only=True)
        except (OSError, ValueError):
            tok = None
        return model, tok

    def tokenize(self, text):
        if self.tokenizer is None:
            raise RuntimeError(
                'No tokenizer available — pass precomputed token ids or '
                'text embeddings, or construct T5TextEncoder from a local '
                'HF directory containing tokenizer assets.')
        enc = self.tokenizer(list(text), truncation=True,
                             max_length=self.max_length, padding='max_length',
                             return_tensors='np')
        return torch.as_tensor(np.asarray(enc['input_ids']), dtype=torch.int64)

    @torch.no_grad()
    def encode_ids(self, input_ids):
        ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
            input_ids, torch.Tensor) else input_ids, device=self.device)
        return self.model(ids, dtype=self.dtype)

    def __call__(self, text):
        if isinstance(text, (list, tuple)) and text and isinstance(text[0], str):
            return self.encode_ids(self.tokenize(text))
        return self.encode_ids(text)

    encode = __call__


# reference-name alias (paintmind/modules/encoder.py:18)
T5TextEmbedder = T5TextEncoder
