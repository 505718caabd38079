"""PyTorch / CUDA port of paintmind_tpu for NVIDIA Hopper (H100).

Same models, layouts and parameter trees as the JAX package; every Pallas
kernel of the JAX package is a hand-written Hopper kernel here (``ops/``).  Entry points run on the card (``device='cuda'``) unless the
caller asks for the CPU.  The package imports neither JAX nor
``paintmind_tpu``.
"""

from . import optim
from .config import Config, register_version, ver2cfg
from .factory import create_model, create_pipeline_for_train
from .models.pipeline import Pipeline
from .models.vqmodel import VQModel
from .nn.attention import set_attention_backend
from .reconstruct import reconstruction
from .utils.trainer import PaintMindTrainer, VQGANTrainer
from .utils.transform import stage1_transform, stage2_transform
from .version import __version__

__all__ = ['Config', 'PaintMindTrainer', 'Pipeline', 'VQGANTrainer',
           'VQModel', '__version__', 'create_model',
           'create_pipeline_for_train', 'optim', 'reconstruction',
           'register_version', 'set_attention_backend', 'stage1_transform',
           'stage2_transform', 'ver2cfg']
