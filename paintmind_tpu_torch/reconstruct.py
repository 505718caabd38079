"""Stage-1 reconstruction demo (``paintmind_tpu/reconstruct.py``, reference
paintmind/reconstruct.py:23-52): eval-mode ``stage1_transform``, encode ->
decode through the vit-s-vqgan on the card, and a side-by-side
origin / reconstruct PIL figure."""

from __future__ import annotations

import io

import numpy as np
from PIL import Image, ImageDraw, ImageFont


def restore(x):
    """[-1, 1] HWC (or CHW) array or tensor -> PIL image."""
    if not isinstance(x, np.ndarray):
        x = x.detach().float().cpu().numpy()
    if x.ndim == 3 and x.shape[0] in (1, 3) and x.shape[-1] not in (1, 3):
        x = x.transpose(1, 2, 0)
    x = (np.clip(x, -1.0, 1.0) + 1.0) * 0.5
    return Image.fromarray((255 * x).astype(np.uint8))


def download_image(url):
    """The image at ``url`` (the standard library's ``urllib``)."""
    import urllib.request
    with urllib.request.urlopen(url) as resp:
        return Image.open(io.BytesIO(resp.read()))


def reconstruction(img_path=None, model_name='vit-s-vqgan',
                   titles=('origin', 'reconstruct'), checkpoint_path=None,
                   scale=0.8, device='cuda', model=None):
    """``img_path``: a path, an ``http(s)`` URL (``download_image``) or a
    PIL image.  Pass ``model`` to reuse a VQModel; otherwise one is built on ``device``
    from ``checkpoint_path``."""
    from . import factory
    from .utils.transform import stage1_transform

    w, h = 256, 256
    if isinstance(img_path, Image.Image):
        img = img_path
    elif str(img_path).startswith('http'):
        img = download_image(img_path)
    else:
        img = Image.open(img_path).convert('RGB')

    x = stage1_transform(is_train=False, scale=scale)(img)
    if model is None:
        model = factory.create_model(arch='vqgan', version=model_name,
                                     pretrained=True,
                                     checkpoint_path=checkpoint_path,
                                     device=device)
    z, _, _ = model.encode(x[None])
    rec = model.decode(z)[0]

    fig = Image.new('RGB', (2 * w, h))
    fig.paste(restore(x), (0, 0))
    fig.paste(restore(rec), (w, 0))
    try:
        font = ImageFont.truetype('arialbi.ttf', 16)
    except OSError:
        font = None
    for i, title in enumerate(titles):
        ImageDraw.Draw(fig).text((i * w, 0), f'{title}', (255, 255, 255), font=font)
    return fig
