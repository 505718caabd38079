"""Model factory (``paintmind_tpu/factory.py``): builds a VQModel or a
Pipeline from the ``ver2cfg`` registry and loads local weights.

The port downloads nothing: ``pretrained=True`` without a
``checkpoint_path`` raises.  Weights are the JAX package's ``.npz`` trees.
"""

from __future__ import annotations

from .config import Config, ver2cfg


def create_model(arch='pipeline', version='paintmindv1', pretrained=True,
                 checkpoint_path=None, **kwargs):
    """``kwargs`` go to the model: ``device`` (default ``'cuda'``),
    ``compute_dtype``, ``param_dtype``, ``seed``; for a pipeline also
    ``stage1_checkpoint_path`` and ``text_encoder``: the conditioning tower
    (``'auto'``, ``None``, or a tower object; ``paintmindv1-clip`` and
    ``paintmindv1-imgvar`` take their CLIP tower this way, e.g.
    ``models.clip.load_image_tower(path)``)."""
    if pretrained and checkpoint_path is None:
        raise ValueError(
            f'create_model({arch!r}, {version!r}): pretrained=True needs a '
            'local checkpoint_path (the port downloads nothing); pass '
            'pretrained=False for seeded random weights')
    config = Config(ver2cfg[version])
    if arch == 'vqgan':
        from .models.vqmodel import VQModel
        model = VQModel(config, **kwargs)
    elif arch == 'pipeline':
        from .models.pipeline import Pipeline
        kwargs.setdefault('stage1_pretrained', False)
        model = Pipeline(config, **kwargs)
    else:
        raise ValueError(f"unknown arch {arch!r}; expected 'vqgan' or 'pipeline'")
    if checkpoint_path is not None:
        model.from_pretrained(checkpoint_path)
    return model


def create_pipeline_for_train(version='paintmindv1', stage1_pretrained=True,
                              stage1_checkpoint_path=None, **kwargs):
    """A ``Pipeline`` to train (``paintmind_tpu.factory``'s): fp32 master
    weights unless ``kwargs`` say otherwise, the stage-1 weights from
    ``stage1_checkpoint_path`` (the port downloads nothing, so
    ``stage1_pretrained=True`` needs it)."""
    from .models.pipeline import Pipeline
    return Pipeline(Config(ver2cfg[version]),
                    stage1_pretrained=stage1_pretrained,
                    stage1_checkpoint_path=stage1_checkpoint_path, **kwargs)
