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
  * an int (a step count) is stored as a 0-d int32 array, as JAX holds it;
  * bit-packed codes (:class:`~repro_torch.core.lowbit.PackedCodes`) are
    stored as their packed uint8 bytes under the key of the codes they
    replace, with a ``"packed": {"bits", "n_codes"}`` annotation in the
    manifest entry, as the JAX package stores them;
  * a bf16 tensor (bf16 parameters or masters) is stored as its raw bytes,
    a two-byte void (``<V2`` in the ``.npy`` header; numpy has no bf16),
    with ``"dtype": "bfloat16"`` in the manifest entry: the bytes, header
    and entry the JAX package's ml_dtypes arrays give.  It is read back by
    the manifest's dtype.

Writes are atomic (a ``.tmp_*`` directory, then a rename), ``keep_last``
old steps are pruned, and ``latest_step`` scans the directory.  The
quantized states are stored as their uint8 codes and f32 absmax.

Pooled optimizer states are stored **per leaf**, as the JAX package
stores them: every ``OptState`` is read through its per-leaf canonical view
(``blockopt.unpool_state``), so the keys are the same whether either
package pooled, and a checkpoint restores into a pooled or a per-leaf
template alike.  Pooled containers outside their ``OptState`` raise
ValueError (their arena halves would be lost).

A partitioned optimizer state saves and restores interchangeably with
pooled and per-leaf ones: its arena's statistics are read out of (and
written back into) its pieces.  On a process group every rank calls
:func:`save` and rank 0 alone writes (a partitioned arena's spans
gathered to it).
Every rank restores from the same files, each writing its own span.

``restore`` loads **into the template's own tensors** (in place), so a
model whose parameters are the optimizer's masters holds the restored
weights; ints are returned anew.  A pooled template is loaded through its
canonical view, whose tensors are views of its arenas, and handed back by
``blockopt.repool_like``.  It checks every key, shape, dtype and packing
annotation before it writes anything: packed codes restore only into
packed codes of the same width and row length, and plain codes only into
plain codes (ValueError otherwise, as in the JAX package).

:func:`state_dict` / :func:`load_state_dict` hold the same content in
memory, ``{"state": {key: tensor or int}, "packed": {key: {"bits",
"n_codes"}}}``, and :func:`read` gives a checkpoint in that form (numpy
arrays), so the optimizer face's ``state_dict`` and a checkpoint restore
into each other.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.lowbit.packing import PackedCodes
from repro_torch.core.optim import blockopt
from repro_torch.core.optim.adafactor import AdafactorLeaf
from repro_torch.core.optim.base import (Full32Leaf, Pool32Arena, Pool32Leaf,
                                         PooledQuantLeaf, Quant8Leaf,
                                         QuantArena)
from repro_torch.core.optim.blockopt import OptState, leaf_order

# Children of each state leaf in the JAX package's ``tree_flatten`` order.
LEAF_CHILDREN = {
    Quant8Leaf: ("master", "codes_m", "absmax_m", "codes_r", "absmax_r"),
    Full32Leaf: ("master", "m", "r"),
    AdafactorLeaf: ("master", "m", "v_row", "v_col", "v_full"),
}
POOLED = (PooledQuantLeaf, Pool32Leaf, QuantArena, Pool32Arena)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _dict_key(key: str) -> str:
    """``['a']['b']`` for the path string 'a/b'."""
    return "".join(f"[{part!r}]" for part in key.split("/"))


def _flatten(tree, prefix: str = "") -> list:
    """(key, leaf) pairs of a tree, leaves being tensors and ints, in the
    JAX package's flatten order; an ``OptState`` in its per-leaf canonical
    layout."""
    if tree is None:
        return []
    if isinstance(tree, OptState):
        tree = blockopt.unpool_state(tree)
    if isinstance(tree, POOLED):
        raise ValueError(
            f"{prefix or 'tree'}: cannot checkpoint pooled optimizer "
            f"containers outside their OptState (their arena/per-leaf "
            f"halves live on sibling fields) — save the whole OptState "
            f"(or unpool_state it) instead")
    if isinstance(tree, (torch.Tensor, PackedCodes)) or (
            isinstance(tree, int) and not isinstance(tree, bool)):
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


BF16 = "bfloat16"      # the manifest's name of a bf16 leaf's dtype


def _to_numpy(leaf) -> np.ndarray:
    """The array a leaf is stored as; a bf16 tensor as its raw ``|V2``
    bytes."""
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)
    if isinstance(leaf, PackedCodes):
        leaf = leaf.packed
    if isinstance(leaf, np.ndarray):
        return leaf
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view("V2")
    return leaf.numpy()


def _savez(path: str, arrays: dict, names: dict) -> None:
    """``np.savez(path, **arrays)``, but a bf16 leaf's ``|V2`` array gets
    the header ml_dtypes gives it (``'descr': '<V2'``), so the file's
    members are byte for byte the JAX package's.  ``np.load`` reads either
    header; the bytes matter to whoever compares or checksums checkpoint
    files across the two packages (``tests/test_torch_checkpoint.py``
    holds a save to the JAX package's file byte for byte).  ``names``:
    array name -> manifest dtype."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, a in arrays.items():
            with zf.open(f"{name}.npy", "w", force_zip64=True) as f:
                if names[name] == BF16:
                    np.lib.format.write_array_header_1_0(f, {
                        "descr": "<V2", "fortran_order": False,
                        "shape": a.shape})
                    f.write(np.ascontiguousarray(a).tobytes())
                else:
                    np.lib.format.write_array(f, np.asanyarray(a),
                                              allow_pickle=False)


def _dtype_name(leaf, array: np.ndarray) -> str:
    """The manifest's dtype of a leaf stored as ``array``."""
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return BF16
    return str(array.dtype)


def _from_numpy(array: np.ndarray, dtype: str):
    """A stored array by its manifest dtype: ``|V2`` bytes of a bf16 leaf
    become a bf16 tensor, any other array stays as it is."""
    if dtype == BF16:
        return torch.from_numpy(array.view(np.int16).copy()).view(
            torch.bfloat16)
    return array


def state_dict(tree) -> dict:
    """What a checkpoint of ``tree`` holds, in memory: ``{"state": {key:
    tensor or int}, "packed": {key: {"bits", "n_codes"}}}``, the tensors
    the tree's own (packed codes as their bytes; no copy)."""
    state, packed = {}, {}
    for key, leaf in _flatten(tree):
        if isinstance(leaf, PackedCodes):
            packed[key] = {"bits": leaf.bits, "n_codes": leaf.n_codes}
            leaf = leaf.packed
        state[key] = leaf
    return {"state": state, "packed": packed}


def save(ckpt_dir: str, step: int, tree, *, keep_last: int = 3) -> str:
    """Atomically write the checkpoint of ``step``.  Returns its path.  A
    tree holding an optimizer state on a process group is saved by every
    rank calling this: rank 0 writes, a partitioned arena's spans
    gathered to it."""
    writer = [True]

    def gathered(state):
        state, w = blockopt.gather_spans(state)
        writer[0] = writer[0] and w
        return state

    tree = blockopt.map_opt_states(tree, gathered)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if not writer[0]:
        return final
    sd = state_dict(tree)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        arrays, index = {}, []
        for i, (key, leaf) in enumerate(sd["state"].items()):
            name = f"a{i}"
            entry = {"key": key, "name": name}
            if key in sd["packed"]:
                entry["packed"] = sd["packed"][key]
            arrays[name] = _to_numpy(leaf)
            entry.update(dtype=_dtype_name(leaf, arrays[name]),
                         shape=list(arrays[name].shape))
            index.append(entry)
        _savez(os.path.join(tmp, "leaves.npz"), arrays,
               {e["name"]: e["dtype"] for e in index})
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


def read(ckpt_dir: str, step: int) -> dict:
    """Checkpoint ``step`` in :func:`state_dict`'s form, as numpy arrays
    (a bf16 leaf as a bf16 tensor: numpy has no bf16)."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "leaves.npz")) as data:
        state = {ent["key"]: _from_numpy(data[ent["name"]], ent["dtype"])
                 for ent in manifest["index"]}
    return {"state": state,
            "packed": {ent["key"]: ent["packed"] for ent in manifest["index"]
                       if "packed" in ent}}


def restore(ckpt_dir: str, step: int, template: Any):
    """Load checkpoint ``step`` into ``template`` (a tree of the port's
    states, such as a fresh ``TrainState``): its tensors are overwritten
    in place, its ints returned anew.  Raises KeyError for a missing key
    and ValueError for a shape or dtype that differs, before anything is
    written."""
    return load_state_dict(template, read(ckpt_dir, step))


def load_state_dict(template: Any, sd: Mapping):
    """Load ``sd`` (:func:`state_dict`'s or :func:`read`'s form) into
    ``template`` in place, as :func:`restore` does."""
    state, packed = sd["state"], sd.get("packed", {})
    canon = blockopt.map_opt_states(
        template, lambda st: blockopt.unpool_state(st, placeholders=True))
    pairs = _flatten(canon)
    arrays = {}
    for key, leaf in pairs:
        if key not in state:
            raise KeyError(f"checkpoint missing leaf {key}")
        _check_packing(key, packed.get(key), leaf)
        if isinstance(leaf, PackedCodes):
            leaf = leaf.packed
        arr = state[key]
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(_to_numpy(arr).copy())
        if isinstance(leaf, int):
            shape, dtype = (), torch.int32
        else:
            shape, dtype = tuple(leaf.shape), leaf.dtype
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} "
                             f"!= template {shape}")
        if arr.dtype != dtype:
            raise ValueError(f"{key}: checkpoint dtype {arr.dtype} != "
                             f"template {dtype}")
        arrays[key] = arr
    with torch.no_grad():
        for key, leaf in pairs:
            if isinstance(leaf, PackedCodes):
                leaf = leaf.packed
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(arrays[key])   # at once when it is the leaf
    restored = _with_ints(canon, "", arrays)
    return blockopt.zip_opt_states(restored, template, blockopt.repool_like)


def _check_packing(key: str, saved: Optional[dict], leaf) -> None:
    """Packedness must agree both ways: packed bytes and plain codes can
    share a shape without sharing a meaning."""
    if isinstance(leaf, PackedCodes):
        if saved is None:
            raise ValueError(f"{key}: template expects {leaf.bits}-bit "
                             f"packed codes; checkpoint stores a plain "
                             f"array")
        if (saved["bits"], saved["n_codes"]) != (leaf.bits, leaf.n_codes):
            raise ValueError(f"{key}: checkpoint packs {saved['bits']}-bit x"
                             f" {saved['n_codes']} codes; template expects "
                             f"{leaf.bits}-bit x {leaf.n_codes}")
    elif saved is not None:
        raise ValueError(f"{key}: checkpoint stores packed "
                         f"{saved['bits']}-bit codes; template expects a "
                         f"plain array")
