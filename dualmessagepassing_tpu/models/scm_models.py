"""Concrete SCM model classes + registry (reference train.py:68-87 build_model).

DMPNN here; CompGCN/RGCN/RGIN/LRP/DMPLRP and the EdgeSeq models register into
MODEL_REGISTRY from their own modules as they land.
"""

from __future__ import annotations

from typing import Dict, Type

from .. import nn

from .basemodel import GraphAdjModelV2, ModelConfig
from .dmpnn import DMPNNStack


class DMPNN(GraphAdjModelV2):
    """Dual message passing network (reference models/dmpnn.py:179-277)."""

    def make_rep_net(self) -> nn.Module:
        cfg = self.cfg
        return DMPNNStack(
            num_layers=cfg.rep_num_graph_layers,
            hidden_dim=cfg.hid_dim,
            init_neigenv=cfg.init_neigenv,
            init_eeigenv=cfg.init_eeigenv,
            num_mlp_layers=cfg.rep_dmpnn_num_mlp_layers,
            batch_norm=cfg.rep_dmpnn_batch_norm,
            act=cfg.rep_act_func,
            dropout=cfg.rep_dropout,
            residual=cfg.rep_residual,
            scatter_method=cfg.scatter_method,
            remat=cfg.rep_remat,
        )


MODEL_REGISTRY: Dict[str, Type[nn.Module]] = {
    "DMPNN": DMPNN,
}


def build_model(cfg: ModelConfig) -> nn.Module:
    """Instantiate the model named by cfg.rep_net (train.py:68-87)."""
    # deferred imports let optional model families register lazily
    if cfg.rep_net not in MODEL_REGISTRY:
        if cfg.rep_net == "CompGCN":
            from . import compgcn  # noqa: F401 (registers into MODEL_REGISTRY)
        elif cfg.rep_net in ("RGCN", "RGIN"):
            from . import rgnn  # noqa: F401
        elif cfg.rep_net in ("LRP", "DMPLRP"):
            from . import lrp  # noqa: F401
        elif cfg.rep_net in ("CNN", "RNN", "TXL"):
            from . import edgeseq  # noqa: F401
    try:
        cls = MODEL_REGISTRY[cfg.rep_net]
    except KeyError:
        raise ValueError(f"unknown rep_net '{cfg.rep_net}'") from None
    return cls(cfg)
