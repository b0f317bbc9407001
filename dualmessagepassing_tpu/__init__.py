"""dualmessagepassing_tpu: a JAX dual message passing framework.

A from-scratch JAX/XLA implementation of the capabilities of
HKUST-KnowComp/DualMessagePassing (AAAI 2022): subgraph-isomorphism counting
and matching (SCM) and unsupervised heterogeneous-graph node embedding (UNC),
re-designed for XLA — static shapes, matmul-shaped message passing, shard_map
scale-out.
"""

__version__ = "0.1.0"

from .graph import FlatGraph, GraphBatch, batch_graphs, single_graph
from .models.basemodel import ModelConfig
from .models.scm_models import build_model

__all__ = [
    "FlatGraph",
    "GraphBatch",
    "ModelConfig",
    "batch_graphs",
    "build_model",
    "single_graph",
]
