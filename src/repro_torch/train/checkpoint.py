"""Checkpoints in the JAX package's format (mirrors
``repro.train.checkpoint``), so each package restores what the other saved.

Format: one directory per step, ``step_<10 digits>``, holding
``leaves.npz`` (every array of the tree as ``a<i>``) and ``manifest.json``
(``{"step", "index": [{"key", "name", "dtype", "shape"}, ...]}``).  Each
array is keyed by the string ``jax.tree_util.keystr`` gives the same leaf
of the JAX package's tree:

  * a NamedTuple field (``TrainState``, ``OptState``, ``AdafactorState``)
    is ``.field``;
  * a dict entry is ``['key']`` — the port's path-string keys
    ('blocks/b0_attn/attn/wq') are the JAX package's nested dicts, one
    ``['part']`` per level, in its sorted order;
  * a state leaf (``Quant8Leaf``, ``Full32Leaf``, ``AdafactorLeaf``) is a
    pytree without keys in JAX, so its arrays are ``[<flat index i>]``, i
    the array's position among the leaf's children (None children, such as
    a one-state algorithm's second moment, are skipped and keep their
    positions free);
  * an int (a step count) is stored as a 0-d int32 array, as JAX holds it.

Writes are atomic (a ``.tmp_*`` directory, then a rename), ``keep_last``
old steps are pruned, and ``latest_step`` scans the directory.  The
quantized states are stored as their uint8 codes and f32 absmax.

``restore`` loads **into the template's own tensors** (in place), so a
model whose parameters are the optimizer's masters holds the restored
weights; ints are returned anew.  It checks every key, shape and dtype
before it writes anything.  Not ported yet: bit-packed sub-byte states
(a ``packed`` manifest entry, ROADMAP A8) and pooled arenas (ROADMAP A9) —
both raise :class:`~repro_torch.errors.ConfigError`.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.optim.adafactor import AdafactorLeaf
from repro_torch.core.optim.base import Full32Leaf, Quant8Leaf
from repro_torch.core.optim.blockopt import leaf_order
from repro_torch.errors import ConfigError

# Children of each state leaf in the JAX package's ``tree_flatten`` order.
LEAF_CHILDREN = {
    Quant8Leaf: ("master", "codes_m", "absmax_m", "codes_r", "absmax_r"),
    Full32Leaf: ("master", "m", "r"),
    AdafactorLeaf: ("master", "m", "v_row", "v_col", "v_full"),
}
POOLED_FIELDS = (".arena", ".pool32")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _dict_key(key: str) -> str:
    """``['a']['b']`` for the path string 'a/b'."""
    return "".join(f"[{part!r}]" for part in key.split("/"))


def _flatten(tree, prefix: str = "") -> list:
    """(key, leaf) pairs of a tree, leaves being tensors and ints, in the
    JAX package's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor) or (isinstance(tree, int)
                                          and not isinstance(tree, bool)):
        return [(prefix, tree)]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, Mapping):
        return [kv for k in leaf_order(tree)
                for kv in _flatten(tree[k], prefix + _dict_key(k))]
    if type(tree) in LEAF_CHILDREN:
        return [kv for i, f in enumerate(LEAF_CHILDREN[type(tree)])
                for kv in _flatten(getattr(tree, f),
                                   f"{prefix}[<flat index {i}>]")]
    raise TypeError(f"{prefix or 'tree'}: cannot checkpoint a "
                    f"{type(tree).__name__}")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)
    return leaf.detach().cpu().numpy()


def save(ckpt_dir: str, step: int, tree, *, keep_last: int = 3) -> str:
    """Atomically write the checkpoint of ``step``.  Returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        arrays, index = {}, []
        for i, (key, leaf) in enumerate(_flatten(tree)):
            name = f"a{i}"
            arrays[name] = _to_numpy(leaf)
            index.append({"key": key, "name": name,
                          "dtype": str(arrays[name].dtype),
                          "shape": list(arrays[name].shape)})
        np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "index": index}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(ckpt_dir, keep_last)
    return final


def _prune(ckpt_dir: str, keep_last: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_"):
            try:
                out.append(int(d[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _with_ints(tree, prefix: str, values: dict):
    """The tree with every int replaced by its restored value (tensors and
    state leaves are the template's own, restored in place)."""
    if isinstance(tree, int) and not isinstance(tree, bool):
        return int(values[prefix])
    if _is_namedtuple(tree):
        return type(tree)(*(_with_ints(getattr(tree, f), f"{prefix}.{f}",
                                       values) for f in tree._fields))
    if isinstance(tree, Mapping):
        return type(tree)((k, _with_ints(v, prefix + _dict_key(k), values))
                          for k, v in tree.items())
    return tree


def restore(ckpt_dir: str, step: int, template: Any):
    """Load checkpoint ``step`` into ``template`` (a tree of the port's
    states, such as a fresh ``TrainState``): its tensors are overwritten
    in place, its ints returned anew.  Raises KeyError for a missing key
    and ValueError for a shape or dtype that differs, before anything is
    written."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    meta = {ent["key"]: ent for ent in manifest["index"]}
    pooled = [k for k in meta if any(p in k for p in POOLED_FIELDS)]
    if pooled:
        raise ConfigError(f"checkpoint holds pooled arenas ({pooled[0]}, "
                          f"...): not ported yet (ROADMAP A9)")
    pairs = _flatten(template)
    with np.load(os.path.join(path, "leaves.npz")) as data:
        arrays = {}
        for key, leaf in pairs:
            if key not in meta:
                raise KeyError(f"checkpoint missing leaf {key}")
            if "packed" in meta[key]:
                raise ConfigError(f"{key}: bit-packed "
                                  f"{meta[key]['packed']['bits']}-bit codes "
                                  f"are not ported yet (ROADMAP A8)")
            arr = data[meta[key]["name"]]
            want = _to_numpy(leaf) if isinstance(leaf, int) else None
            shape = () if want is not None else tuple(leaf.shape)
            dtype = want.dtype if want is not None else \
                torch.empty((), dtype=leaf.dtype).numpy().dtype
            if tuple(arr.shape) != shape:
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"template {shape}")
            if arr.dtype != dtype:
                raise ValueError(f"{key}: checkpoint dtype {arr.dtype} != "
                                 f"template {dtype}")
            arrays[key] = arr
    with torch.no_grad():
        for key, leaf in pairs:
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(torch.from_numpy(np.array(arrays[key])))
    return _with_ints(template, "", arrays)
