"""Serving tier (``paintmind_tpu/serving``): ``GenerationEngine`` batches
concurrent requests onto the card; ``server.serve`` exposes it over stdlib
HTTP.  ``python -m paintmind_tpu_torch.serving`` starts it.
"""

from .engine import (EngineOverloaded, GenerateRequest, GenerationEngine,
                     PaintRequest, ReconstructRequest)
from .server import make_server, serve

__all__ = ['GenerationEngine', 'GenerateRequest', 'PaintRequest',
           'ReconstructRequest', 'EngineOverloaded', 'make_server', 'serve']
