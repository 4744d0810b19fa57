"""Sequence parallelism in the port (the JAX package's residual layout,
``src/repro/models/model.py::_superblock_fwd``): between blocks the
residual stream is (batch on dp, sequence on tp), each tensor-parallel
region bounded by an all-gather of the sequence before its products and a
reduce-scatter of its output (``models/constrain.py::seq_gather`` /
``seq_scatter``).

One subprocess plays rank 0 of the dry run's fake process group of 8
ranks (``launch.mesh.make_fake_mesh``; one process holds one default
group), with two meshes of it: the smoke mesh (pod 2, data 2, model 2:
two data-parallel axes) and (data 2, model 4).  Reduced configs, placed by
the sharding rules, run a train forward and backward, a prefill and a
decode step; the script records each block's input layout and the
collectives the block's forward issues on the model axis (a dispatch mode
beneath DTensor reads each ``_c10d_functional`` op's group), and the
collectives of the whole backward.  The fake group moves no data: values
are held to the unsharded model by the gloo worlds of
``tests/test_torch_dist.py::case_tensor_parallel_*``.

Checked here:
  * the residual entering every block is laid out as the JAX package's
    ``constrain(x, "dp", "tp", None)`` rule lays it out (its own code,
    called on shapes) -- the sequence on the model axis where it divides
    S, and batch on dp alone at decode's S = 1 and at an S it does not
    divide;
  * a dense block's forward makes one all-gather and one reduce-scatter on
    the model axis per branch (attention, MLP), and no all-reduce there;
    a parallel block (command-r) one of each; no (B, S, d) activation is
    all-reduced on the model axis, forward or backward.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

MESHES = {"smoke": {"pod": 2, "data": 2, "model": 2},
          "tp4": {"data": 2, "model": 4}}
ARCHS = ("paper-lm-209m", "command-r-35b", "mixtral-8x22b",
         "recurrentgemma-9b", "xlstm-350m")
BATCH, SEQ, ODD_SEQ, PROMPT = 8, 32, 31, 24

SCRIPT = r"""
import json, sys
import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.configs import base
from repro_torch.launch import mesh as ML
from repro_torch.launch.dryrun import _tree_map
from repro_torch.models import constrain as C
from repro_torch.models import model as M
from repro_torch.sharding import rules as R
from repro_torch.train import loop as L

MESHES, ARCHS, BATCH, SEQ, ODD_SEQ, PROMPT = json.loads(sys.argv[2])
torch.set_num_threads(1)
KINDS = {"all_gather_into_tensor": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_reduce": "all-reduce", "all_to_all_single": "all-to-all"}


class Collectives(TorchDispatchMode):
    # (kind, group name, output shape) of every functional collective,
    # beneath DTensor
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = func._schema.name.split("::")[-1]
        if func.namespace == "_c10d_functional" and name in KINDS:
            group = [a for a in args if isinstance(a, str)][-1]
            self.seen.append((KINDS[name], group, list(out.shape)))
        return out


def small(arch):
    cfg = base.get_config(arch)
    kw = dict(vocab_size=128)
    if arch == "recurrentgemma-9b":
        kw.update(n_layers=3, window=16)
    return base.reduced(cfg, **kw)


def placed(cfg, mesh):
    model = M.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    spec = R.param_shardings(M.logical_axes(cfg, model), model.param_dict(),
                             mesh, R.ShardingPolicy())
    for path, p in list(model.param_dict().items()):
        *parents, leaf = path.split("/")
        mod = model
        for n in parents:
            mod = getattr(mod, n)
        setattr(mod, leaf, torch.nn.Parameter(distribute_tensor(
            p.detach(), mesh, R.placements(spec[path], mesh))))
    C.set_block_param_specs({k[len("blocks/"):]: v for k, v in spec.items()
                             if k.startswith("blocks/")})
    return model


def batch(mesh, t):
    return distribute_tensor(t, mesh, R.placements(R.batch_sharding(
        mesh, R.ShardingPolicy(), t.dim(), t.shape[0]), mesh))


def run(mesh, tp_group, cfg, kind):
    # {"blocks": [(input shape, input placements, forward collectives on
    # the model axis)], "backward": [...]} of one call
    blocks, counter = [], Collectives()
    apply = M._apply_block

    def recorded(p, x, *a, **kw):
        n = len(counter.seen)
        out = apply(p, x, *a, **kw)
        blocks.append((list(x.shape), [str(q) for q in x.placements],
                       [c for c in counter.seen[n:] if c[1] == tp_group]))
        return out

    model = placed(cfg, mesh)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1),
                           generator=torch.Generator().manual_seed(1))
    M._apply_block = recorded
    backward = []
    try:
        with implicit_replication(), counter:
            if kind in ("train", "odd"):
                S = SEQ if kind == "train" else ODD_SEQ
                loss, _ = L.microbatch_loss(cfg, model, L.TrainHyper(),
                                            batch(mesh, tokens[:, :S + 1]),
                                            None)
                n = len(counter.seen)
                loss.backward()
                backward = [c for c in counter.seen[n:] if c[1] == tp_group]
            else:
                caches = M.init_cache(cfg, BATCH, PROMPT + 1, device="cpu")
                cspec = R.cache_shardings(caches, cfg, mesh,
                                          R.ShardingPolicy())
                caches = _tree_map(caches, lambda path, t: distribute_tensor(
                    t, mesh, R.placements(cspec[path], mesh)))
                _, caches = M.prefill(cfg, model,
                                      batch(mesh, tokens[:, :PROMPT]),
                                      PROMPT + 1, caches=caches)
                if kind == "decode":
                    del blocks[:]
                    M.decode_step(cfg, model,
                                  batch(mesh, tokens[:, PROMPT:PROMPT + 1]),
                                  caches, PROMPT)
    finally:
        M._apply_block = apply
    return {"blocks": blocks, "backward": backward}


out = {}
for mesh_name, sizes in MESHES.items():
    mesh = ML.make_fake_mesh(tuple(sizes.values()), tuple(sizes))
    names = list(sizes)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    C.set_activation_axes(dp, "model", 1 if not dp else
                          __import__("math").prod(sizes[a] for a in dp),
                          sizes["model"])
    tp_group = mesh.get_group(names.index("model")).group_name
    try:
        for arch in ARCHS:
            cfg = small(arch)
            kinds = ("train", "odd", "prefill", "decode") \
                if arch in ("paper-lm-209m", "recurrentgemma-9b") \
                else ("train",)
            for kind in kinds:
                key = f"{mesh_name}:{arch}:{kind}"
                try:
                    out[key] = run(mesh, tp_group, cfg, kind)
                except Exception:
                    import traceback
                    out[key] = {"error": traceback.format_exc()[-3000:]}
    finally:
        C.clear_activation_axes()
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def runs():
    """{"<mesh>:<arch>:<kind>": record} from the subprocess."""
    tmp = tempfile.mkdtemp(prefix="seqpar_test_")
    path = os.path.join(tmp, "seqpar.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, path, json.dumps(
            [MESHES, ARCHS, BATCH, SEQ, ODD_SEQ, PROMPT])],
        env=env, cwd=tmp, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and os.path.exists(path), \
        proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.load(open(path))


def _record(runs, key):
    rec = runs[key]
    assert "error" not in rec, rec.get("error")
    assert rec["blocks"], key
    return rec


def _jax_residual_spec(sizes: dict, shape: tuple) -> tuple:
    """The JAX package's ``constrain(x, "dp", "tp", None)`` spec of the
    residual of ``shape`` on a mesh of ``sizes``: its own rule, run on
    shapes (the sharding call replaced by one that returns the spec)."""
    import jax
    from repro.models import constrain as JC
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    JC.set_activation_axes(dp, "model", math.prod(sizes[a] for a in dp),
                           sizes["model"])
    orig = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = lambda x, spec: tuple(spec)
    try:
        got = JC.constrain(jax.ShapeDtypeStruct(shape, "float32"),
                           "dp", "tp", None)
    finally:
        jax.lax.with_sharding_constraint = orig
        JC.clear_activation_axes()
    return got if isinstance(got, tuple) else (None,) * len(shape)


def _placements(sizes: dict, spec: tuple) -> list:
    """The spec's placements as DTensor prints them, a mesh dim each."""
    from repro_torch.sharding import rules as R
    return [str(p) for p in R.placements(spec, sizes)]


LAYOUT_CASES = [(m, a, k) for m in MESHES for a in ARCHS
                for k in (("train", "odd", "prefill", "decode")
                          if a in ("paper-lm-209m", "recurrentgemma-9b")
                          else ("train",))]


@pytest.mark.parametrize("mesh,arch,kind", LAYOUT_CASES)
def test_residual_layout_is_the_jax_package(runs, mesh, arch, kind):
    """Every block's input (the residual between blocks) has the JAX
    package's layout: the sequence on the model axis at S 32 and 24
    (prefill), batch on dp alone at S 31 and decode's S 1."""
    sizes = MESHES[mesh]
    for shape, got, _ in _record(runs, f"{mesh}:{arch}:{kind}")["blocks"]:
        spec = _jax_residual_spec(sizes, tuple(shape))
        assert got == _placements(sizes, spec), (shape, spec)
        seq_on_tp = shape[1] % sizes["model"] == 0
        assert (spec[1] == "model") == seq_on_tp
        assert spec[0] is not None


def _kinds(colls) -> dict:
    out = {}
    for kind, _, _ in colls:
        out[kind] = out.get(kind, 0) + 1
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,branches", [("paper-lm-209m", 2),
                                           ("command-r-35b", 1)])
def test_block_forward_gathers_and_reduce_scatters(runs, mesh, arch,
                                                   branches):
    """A dense block's forward: one all-gather of the sequence and one
    reduce-scatter of the output per tensor-parallel region on the model
    axis, nothing else there; the parallel block's two branches share one
    of each.  The backward reduce-scatters every gather's gradient (which
    the products leave partial)."""
    rec = _record(runs, f"{mesh}:{arch}:train")
    tp = MESHES[mesh]["model"]
    for shape, _, colls in rec["blocks"]:
        B, S, d = shape
        B_dp = B // (math.prod(MESHES[mesh].values()) // tp)
        assert _kinds(colls) == {"all-gather": branches,
                                 "reduce-scatter": branches}, colls
        for kind, _, out in colls:
            # the gathered (B_dp, S, d) rows, or their shard of S (the
            # collectives run on dim 0: elements compared)
            want = B_dp * S * d if kind == "all-gather" else \
                B_dp * S // tp * d
            assert math.prod(out) == want, (kind, out, want)
    gathers = sum(_kinds(colls).get("all-gather", 0)
                  for _, _, colls in rec["blocks"])
    assert _kinds(rec["backward"]).get("reduce-scatter", 0) >= gathers > 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_no_activation_all_reduce_on_model_axis(runs, mesh, arch):
    """No (B, S, d) activation is all-reduced on the model axis, in the
    forward (any block) or the backward of a train step."""
    rec = _record(runs, f"{mesh}:{arch}:train")
    B, S, d = rec["blocks"][0][0]
    big = B * S * d // math.prod(MESHES[mesh].values()) * \
        MESHES[mesh]["model"]
    colls = [c for _, _, cs in rec["blocks"] for c in cs] + rec["backward"]
    reduced = [c for c in colls if c[0] == "all-reduce"
               and math.prod(c[2]) >= big]
    assert not reduced, reduced
