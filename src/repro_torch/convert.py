"""Carry the JAX package's model weights into the port.

``params_from_numpy(tree, cfg, device)`` takes the JAX parameter tree as
nested dicts (and, for ``blocks_list``, lists) of numpy arrays — the caller runs ``jax.device_get`` first, so
this module never imports JAX — and returns the port's ``Model`` holding
exactly those values.  The differential tests use it to start both packages
from identical weights.  ``cache_from_numpy(tree, device)`` carries a JAX
serving cache (dense, paged, with the recurrent blocks' tuple states) into
the port's layout, so the two packages' decode steps can start from the
same cache.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.errors import FormatError
from repro_torch.models.model import Model


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts and lists -> {'a/b/0/c': leaf} (a list's items keyed by
    their index, as the JAX package's ``path_str`` names them)."""
    out = {}
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    for key, value in items:
        path = f"{prefix}{key}"
        if isinstance(value, (Mapping, list, tuple)):
            out.update(flatten_tree(value, path + "/"))
        else:
            out[path] = value
    return out


def params_from_numpy(tree: Mapping, cfg, device="cuda") -> Model:
    """The port's model for ``cfg`` with the weights of ``tree`` (nested
    dicts and lists of numpy arrays, keyed as the JAX package's
    ``init_model`` returns them).  Every leaf is stored in
    ``cfg.param_dtype``, rounded to nearest even as the JAX package's
    ``astype`` rounds its f32 masters for the forward."""
    model = Model(cfg, device=device)
    flat = flatten_tree(tree)
    params = model.param_dict()
    if set(flat) != set(params):
        raise FormatError(f"parameter paths differ: only in tree "
                          f"{sorted(set(flat) - set(params))}, only in model "
                          f"{sorted(set(params) - set(flat))}")
    with torch.no_grad():
        for path, p in params.items():
            value = np.asarray(flat[path], dtype=np.float32)
            if value.shape != tuple(p.shape):
                raise FormatError(f"{path}: shape {value.shape}, the model "
                                  f"has {tuple(p.shape)}")
            p.copy_(torch.from_numpy(value.copy()))   # RNE to p.dtype
    return model


def cache_from_numpy(tree, device="cuda"):
    """The JAX package's cache pytree (nested dicts, lists and the
    recurrent blocks' state tuples of numpy arrays, after
    ``jax.device_get``) as the port's cache: the same nesting, each array a
    tensor of its dtype on ``device`` (a bf16 array, which numpy holds as
    ml_dtypes' bfloat16, by its bits)."""
    if isinstance(tree, Mapping):
        return {k: cache_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cache_from_numpy(v, device) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device_lib.resolve(device))
