"""Activation checkpointing (rematerialisation) policies.

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing.py``. The JAX
package maps a policy name to a ``jax.checkpoint`` saveable-policy; the port
has two: ``none`` saves every activation, ``full`` (and its alias
``nothing``) saves only each layer's input and re-runs the layer in backward
(``torch.utils.checkpoint``, non-reentrant). The selective policies need
named activations inside a layer and are not ported yet.
"""

from __future__ import annotations

from typing import Optional

# every policy name the JAX package knows (it parses in the config)
KNOWN_POLICIES = ("full", "nothing", "dots_saveable", "dots_with_no_batch_dims",
                  "attn_only", "attn_mlp", "dots_flash", "offload_host")


def policy_by_name(name: Optional[str]) -> Optional[str]:
    """None for ``none`` (save everything), ``"full"`` for a whole-layer
    recompute; raises for the policies not ported yet."""
    if name in ("none", None):
        return None
    if name in ("full", "nothing"):
        return "full"
    if name in KNOWN_POLICIES:
        raise NotImplementedError(
            f"activation_checkpointing.policy {name!r} is not ported yet "
            "(selective remat: ROADMAP queue A item 6); use 'none' or 'full'"
        )
    raise KeyError(f"unknown remat policy {name!r}; have none, "
                   f"{', '.join(KNOWN_POLICIES)}")
