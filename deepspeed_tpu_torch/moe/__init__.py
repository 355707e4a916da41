"""Mixture of experts (Mixtral) at ep = 1: gating, the expert FFN and the
routed MLP of the no-cache forward (training and evaluation) and of the
cached forwards."""

from .sharded_moe import (eval_capacity, moe_layer, moe_serving_mlp,  # noqa: F401
                          top_k_gating, top_k_gating_indices, train_capacity)
