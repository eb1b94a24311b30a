"""JAX parameter pytree (as numpy) -> state_dict of the port's modules.

The port's modules name their parameters after the JAX pytree keys, so a
state_dict key is the JAX path joined with dots ("layers", a list in JAX,
is an nn.ModuleList here).  Layouts:

  linear weight (in, out)             same layout (the port keeps (in, out))
  emb_to_key_value (D, 2D)            same: one fused matrix, split after
                                      the product as in the JAX package
  conv weight (K, Cin/groups, Cout)   -> torch (Cout, Cin/groups, K)
  conv-pos v (K, Cin/groups, Cout)    -> (Cout, Cin/groups, K)
  conv-pos g (K, 1, 1)                -> (1, 1, K)
  VGG conv weight (Kt, Kf, Cin, Cout) -> torch (Cout, Cin, Kt, Kf)

Every 3-D leaf of a JAX s2t_emformer, MMA, CIF, transducer or
s2t_transformer_convpos tree is one of the conv tensors above (the
convpos model's non-causal conv-pos keeps all conv_pos taps; CIF's alpha
conv is (K, Cin, Cout)), so the rule is: 3-D leaves reverse their axes,
the rest copy.  The inverse of the JAX package's fairseq converter's
`_conv`; this package's compat/fairseq_converter.py loads fairseq
checkpoints straight into the port's names.

The mt_transformer tree's encoder.embed_tokens and decoder.embed_tokens
are two leaves (one array at init, apart once trained); the port keeps two
parameters too, so they copy like any other leaf.

This module imports no JAX: callers pass the tree already converted to
numpy (e.g. jax.tree_util.tree_map(np.asarray, params)).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"a": {"b": [x, y]}} -> {"a.b.0": x, "a.b.1": y}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def load_jax_params(tree: Any) -> Dict[str, torch.Tensor]:
    """JAX parameter tree of numpy arrays -> state_dict for the matching
    port module (load it with `module.load_state_dict(sd)`)."""
    sd = {}
    for key, a in flatten_tree(tree).items():
        if a.ndim == 3:
            a = np.transpose(a, (2, 1, 0))
        elif a.ndim == 4:
            a = np.transpose(a, (3, 2, 0, 1))
        sd[key] = torch.tensor(np.asarray(a, np.float32))
    return sd
