"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, without devices:

  * ``input_specs`` gives every supported (arch, shape) cell the JAX
    package's input shapes and dtypes (the decode caches leaf by leaf);
  * ``model_flops`` equals the JAX package's formula exactly;
  * ``lower_cell`` on the smoke mesh (2 x 2 x 2, a fake process group of
    8 in a subprocess) returns ``ok`` for train, prefill and decode of a
    reduced paper-lm and a reduced recurrentgemma, with the key set of the
    JAX package's artifact and, for the serving cells, argument bytes
    equal to the rules' arithmetic recomputed here (the train cells hold
    their own: ``lower_cell`` raises when they differ); the paper-lm train
    cell reduce-scatters its block outputs (sequence parallelism);
  * the command line writes an ``ok`` artifact for full-width
    paper-lm-209m train_4k on the 256-device pod mesh, and
    ``make_production_mesh`` builds the 512-device mesh over a fake group;
  * the reduced paper-lm train cell on the smoke mesh at remat "full"
    against the same cell at "none": equal argument bytes, fewer
    temporary bytes, more FLOPs (the recomputed forward);
  * on a mesh of one device (its own fake group) the dry run's FLOPs equal
    ``FlopCounterMode`` over the same train step run for real on the CPU;
  * the update on one device's local share of a (1, 1, 2) mesh makes the
    optimizer's own launches, on half the arena's rows, with the bytes per
    row of the one-device update;
  * ``DeviceCounter`` counts a sharded product's FLOPs per device (the
    global count over the shards), and raises where DTensor lacks a
    method it must mute;
  * the scans' counting mode (``models/scan_utils.counting``, on in
    ``lower_cell``) against the step-by-step trace of the same cell, for a
    reduced recurrentgemma and a reduced xlstm (one mLSTM and one sLSTM
    block) at T = 192, train and prefill, on the one-device host mesh and
    the smoke mesh: FLOPs, bytes read and written and every collective
    kind equal, the peak within SCAN_PEAK_RTOL; the mode raises on real
    tensors;
  * a vocab-sharded train cell (reduced stablelm, vocab 256 on the model
    axis of 2): no (B, S, V) tensor at the full vocab is live at its peak
    and no collective returns the logits at the full vocab (the loss
    reduces the vocab on its shards, ROADMAP C17);
  * xlstm-350m's parameter count and train_4k model FLOPs equal the JAX
    artifact's.

The subprocesses (one per smoke cell, the calibration, the command line)
run side by side, once for the file.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.launch import shapes as JS
from repro.roofline import analysis as JA
from repro_torch.configs import base as TB
from repro_torch.launch import shapes as TS
from repro_torch.roofline import analysis as TA

ROOT = Path(__file__).resolve().parents[1]
JAX_ARTIFACT = ROOT / "artifacts" / "dryrun" / "xlstm-350m__train_4k__smoke.json"
CELLS = [(a, s) for a in JB.list_archs() for s in JS.SHAPES
         if JS.cell_supported(JB.get_config(a), JS.SHAPES[s])[0]]

# the reduced cells of the smoke mesh: (arch, shape, seq_len, batch)
SMOKE = [(arch, shape, 64, 16 if shape == "train_4k" else 8)
         for arch in ("paper-lm-209m", "recurrentgemma-9b")
         for shape in ("train_4k", "prefill_32k", "decode_32k")]

SMOKE_SCRIPT = r"""
import dataclasses, json, sys
from repro_torch.configs import base
from repro_torch.launch import dryrun, shapes
from repro_torch.models import model as M
from repro_torch.sharding import rules

def serve_rules_bytes(cfg, case, mesh):
    # the rules' arithmetic of a serving cell: parameters, caches, tokens
    policy = rules.ShardingPolicy()
    model = M.Model(cfg, device="meta")
    params = model.param_dict()
    spec = rules.param_shardings(M.logical_axes(cfg, model), params, mesh,
                                 policy)
    n = sum(rules.local_bytes(p, spec[k], mesh) for k, p in params.items())
    cache = M.init_cache(cfg, case.global_batch, case.seq_len, device="meta")
    cspec = rules.cache_shardings(cache, cfg, mesh, policy)
    from repro_torch.convert import flatten_tree
    n += sum(rules.local_bytes(t, cspec[k], mesh)
             for k, t in flatten_tree(cache).items())
    ins = shapes.input_specs(cfg, case)
    for key in ("tokens", "token", "embeds"):
        if key in ins:
            t = ins[key]
            n += rules.local_bytes(t, rules.batch_sharding(
                mesh, policy, t.dim(), t.shape[0]), mesh)
    return n

out = {}
for arch, shape, seq, batch in CELLS:
    cfg = base.reduced(base.get_config(arch))
    case = dataclasses.replace(shapes.SHAPES[shape], seq_len=seq,
                               global_batch=batch)
    try:
        art = dryrun.lower_cell(arch, shape, "smoke", cfg=cfg, case=case)
        if case.kind != "train":
            art["rules_bytes"] = serve_rules_bytes(
                cfg, case, rules.mesh_sizes(dryrun.build_mesh("smoke")))
    except Exception as e:
        import traceback
        art = {"status": "FAILED", "error": traceback.format_exc()[-3000:]}
    out[f"{arch}:{shape}"] = art
json.dump(out, open(sys.argv[1], "w"))
"""

CALIB_SCRIPT = r"""
import dataclasses, json, sys, torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import base
from repro_torch.core.optim import make_optimizer
from repro_torch.launch import dryrun, shapes
from repro_torch.train import loop as L
cfg = base.reduced(base.get_config("paper-lm-209m"))
case = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=64,
                           global_batch=4)
art = dryrun.lower_cell("paper-lm-209m", "train_4k", "host", cfg=cfg,
                        case=case)
opt = make_optimizer("adam8", lr=dryrun.LR, weight_decay=0.1, impl="torch",
                     device="cpu")
state, model = L.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                  device="cpu")
step = L.make_train_step(cfg, model, opt, L.TrainHyper())
tokens = torch.randint(0, cfg.vocab_size, (4, 65),
                       generator=torch.Generator().manual_seed(1))
with FlopCounterMode(display=False) as fc:
    step(state, {"tokens": tokens})
json.dump({"art": art, "real_flops": fc.get_total_flops()},
          open(sys.argv[1], "w"))
"""


UPDATE_SCRIPT = r"""
import dataclasses, json, sys
from repro_torch.configs import base
from repro_torch.core.optim import blockopt
from repro_torch.launch import dryrun, shapes
from repro_torch.roofline import analysis
# the bytes and rows of every fused launch of the update, by the counter
# of the traced step
counters, launches = [], []
init, launch = analysis.DeviceCounter.__init__, blockopt.Block8bitOptimizer._launch

def counted_init(self, *args, **kwargs):
    init(self, *args, **kwargs)
    counters.append(self)

def counted_launch(self, stats, master, *args, **kwargs):
    b0 = counters[-1].bytes_accessed
    out = launch(self, stats, master, *args, **kwargs)
    launches.append((master.shape[0], counters[-1].bytes_accessed - b0,
                     len(stats.segments)))
    return out

analysis.DeviceCounter.__init__ = counted_init
blockopt.Block8bitOptimizer._launch = counted_launch
dryrun.MESHES["tp2"] = ((1, 1, 2), ("pod", "data", "model"))
cfg = base.reduced(base.get_config("paper-lm-209m"), d_model=256,
                   vocab_size=1024)
case = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=32,
                           global_batch=4)
art = dryrun.lower_cell("paper-lm-209m", "train_4k", sys.argv[1], cfg=cfg,
                        case=case)
json.dump({"status": art["status"], "n_chips": art["n_chips"],
           "launches": launches}, open(sys.argv[2], "w"))
"""

COUNTER_SCRIPT = r"""
import json, sys, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard, _dispatch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline.analysis import DeviceCounter
mesh = mesh_lib.make_fake_mesh((2, 2), ("data", "model"))
M, K, N = 64, 32, 48
counter = DeviceCounter()
with FakeTensorMode(), counter:
    with counter.arguments():
        # x's rows on "data", w's columns on "model": no collective
        x = torch.nn.Parameter(DTensor.from_local(
            torch.empty(M // 2, K), mesh, [Shard(0), Replicate()],
            run_check=False))
        w = torch.nn.Parameter(DTensor.from_local(
            torch.empty(K, N // 2), mesh, [Replicate(), Shard(1)],
            run_check=False))
        # the output's gradient sharded as the output is
        dy = DTensor.from_local(torch.empty(M // 2, N // 2), mesh,
                                [Shard(0), Shard(1)], run_check=False)
    (x @ w).backward(dy)
# a missing patch target raises
name = "_propagate_op_sharding_dispatch_slow_path"
orig = vars(_dispatch.OpDispatcher)[name]
delattr(_dispatch.OpDispatcher, name)
try:
    DeviceCounter().__enter__()
    raised = ""
except RuntimeError as e:
    raised = str(e)
finally:
    setattr(_dispatch.OpDispatcher, name, orig)
json.dump({"flops": counter.flops, "global": 3 * 2 * M * K * N,
           "shards": 4, "raised": raised}, open(sys.argv[1], "w"))
"""


# the reduced paper-lm smoke cell of SMOKE again, with remat "full" (the
# SMOKE cells trace reduced()'s remat "none")
REMAT_SCRIPT = r"""
import dataclasses, json, sys
from repro_torch.configs import base
from repro_torch.launch import dryrun, shapes
cfg = base.reduced(base.get_config("paper-lm-209m"))
case = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=64,
                           global_batch=16)
art = dryrun.lower_cell("paper-lm-209m", "train_4k", "smoke",
                        overrides={"remat": "full"}, cfg=cfg, case=case)
json.dump(art, open(sys.argv[1], "w"))
"""


# the scan counting mode (``models/scan_utils.counting``) against the
# step-by-step trace of the same cell: (arch, shape, mesh, seq, batch,
# reduced() overrides, lower_cell overrides).  T = 192 is three chunks of
# 64: the counted trace runs the first and the last chunk, the middle one
# only as phantoms and multipliers.  The xlstm config holds one mLSTM and
# one sLSTM block.
SCAN_T = 192
SCANS = [
    (arch, shape, mesh, SCAN_T,
     {"train_4k": 4, "prefill_32k": 2}[shape] * (4 if mesh == "smoke" else 1),
     kw, {"microbatches": 1} if shape == "train_4k" else {})
    for arch, kw in (("recurrentgemma-9b", {}),
                     ("xlstm-350m", {"n_layers": 2,
                                     "block_pattern": ("mlstm", "slstm")}))
    for shape in ("train_4k", "prefill_32k")
    for mesh in ("host", "smoke")]

SCAN_SCRIPT = r"""
import dataclasses, json, sys, time
from repro_torch.configs import base
from repro_torch.launch import dryrun, shapes
from repro_torch.roofline.analysis import DeviceCounter
arch, shape, mesh, seq, batch, kw, over = CELL
cfg = base.reduced(base.get_config(arch), **kw)
case = dataclasses.replace(shapes.SHAPES[shape], seq_len=seq,
                           global_batch=batch)
out = {}
for counted in (True, False):
    c = DeviceCounter()
    t0 = time.time()
    art = dryrun.lower_cell(arch, shape, mesh, overrides=over, cfg=cfg,
                            case=case, counter=c, count_scans=counted)
    out["counted" if counted else "steps"] = {
        "status": art["status"], "flops": c.flops, "read": c.bytes_read,
        "written": c.bytes_written, "collectives": c.collectives,
        "n_collectives": c.n_collectives, "peak": c.peak_bytes,
        "s": time.time() - t0}
json.dump(out, open(sys.argv[1], "w"))
"""

# a vocab-sharded train cell on the smoke mesh (vocab 256 on the model axis
# of 2): what was live at its peak, and the shape of every collective's
# result
VOCAB = 256
VOCAB_SCRIPT = r"""
import dataclasses, json, sys
from repro_torch.configs import base
from repro_torch.launch import dryrun, shapes
from repro_torch.roofline import analysis
results = []

class Recording(analysis.DeviceCounter):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        name = func._schema.name.split("::")[-1]
        if out is not NotImplemented and not self._muted and \
                name in analysis._COLLECTIVES:
            results.extend([name, list(t.shape)]
                           for t in analysis._tensors(out))
        return out

cfg = base.reduced(base.get_config("stablelm-1.6b"), vocab_size=VOCAB)
case = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=64,
                           global_batch=16)
c = Recording()
art = dryrun.lower_cell("stablelm-1.6b", "train_4k", "smoke", cfg=cfg,
                        case=case, counter=c)
json.dump({"status": art["status"], "error": art.get("error"),
           "peak": [[list(k[1]), b] for k, b in c.peak_by_op.items()],
           "collectives": results}, open(sys.argv[1], "w"))
""".replace("VOCAB", str(VOCAB))


MESH_SCRIPT = r"""
from repro_torch.launch import mesh
mesh.init_fake_process_group(512)
m = mesh.make_production_mesh(multi_pod=True, device_type="cpu")
print("MESH", m.mesh_dim_names, tuple(m.shape))
"""


@pytest.fixture(scope="module")
def runs():
    """The subprocesses' results, run side by side: each smoke cell in a
    process (and a fake group) of its own."""
    tmp = tempfile.mkdtemp(prefix="dryrun_test_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    cli_dir = os.path.join(tmp, "cli")
    run = lambda args: subprocess.Popen(
        [sys.executable, *args], env=env, cwd=tmp, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    procs = {f"{a}:{s}": run(["-c", "CELLS = " + repr([(a, s, n, b)])
                               + "\n" + SMOKE_SCRIPT,
                               os.path.join(tmp, f"{a}:{s}.json")])
             for a, s, n, b in SMOKE}
    procs["calib"] = run(["-c", CALIB_SCRIPT,
                          os.path.join(tmp, "calib.json")])
    procs["mesh"] = run(["-c", MESH_SCRIPT])
    procs["remat"] = run(["-c", REMAT_SCRIPT,
                          os.path.join(tmp, "remat.json")])
    for kind in ("host", "tp2"):
        procs[f"update_{kind}"] = run(["-c", UPDATE_SCRIPT, kind, os.path.join(
            tmp, f"update_{kind}.json")])
    procs["counter"] = run(["-c", COUNTER_SCRIPT,
                            os.path.join(tmp, "counter.json")])
    for cell in SCANS:
        key = "scan:" + ":".join(map(str, cell[:3]))
        procs[key] = run(["-c", f"CELL = {cell!r}\n" + SCAN_SCRIPT,
                          os.path.join(tmp, key + ".json")])
    procs["vocab"] = run(["-c", VOCAB_SCRIPT, os.path.join(tmp, "vocab.json")])
    procs["cli"] = run(["-m", "repro_torch.launch.dryrun", "--arch",
                        "paper-lm-209m", "--shape", "train_4k", "--mesh",
                        "pod", "--out", cli_dir])
    logs = {k: p.communicate(timeout=600)[0] for k, p in procs.items()}
    rcs = {k: p.returncode for k, p in procs.items()}

    def load(path):
        return json.load(open(path)) if os.path.exists(path) else None

    smoke = {}
    for a, s, _, _ in SMOKE:
        smoke.update(load(os.path.join(tmp, f"{a}:{s}.json")) or {})
    return {"rcs": rcs, "logs": logs, "smoke": smoke,
            "calib": load(os.path.join(tmp, "calib.json")),
            "counter": load(os.path.join(tmp, "counter.json")),
            "remat": load(os.path.join(tmp, "remat.json")),
            **{f"update_{k}": load(os.path.join(tmp, f"update_{k}.json"))
               for k in ("host", "tp2")},
            "scans": {":".join(map(str, c[:3])): load(os.path.join(
                tmp, "scan:" + ":".join(map(str, c[:3])) + ".json"))
                for c in SCANS},
            "vocab": load(os.path.join(tmp, "vocab.json")),
            "cli": load(os.path.join(
                cli_dir, "paper-lm-209m__train_4k__pod.json"))}


def _shapes(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of arrays / tensors."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        dt = str(tree.dtype).replace("torch.", "")
        return {prefix: (tuple(tree.shape), dt)}
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_jax(arch, shape):
    want = _shapes(JS.input_specs(JB.get_config(arch), JS.SHAPES[shape]))
    got = _shapes(TS.input_specs(TB.get_config(arch), TS.SHAPES[shape]))
    if "pos" in want:                 # a traced scalar there, an int here
        assert got.pop("pos")[0] == want.pop("pos")[0] == ()
    assert got == want


@pytest.mark.parametrize("arch", JB.list_archs())
def test_model_flops_equal_jax(arch):
    for shape in JS.SHAPES:
        assert TA.model_flops(TB.get_config(arch), TS.SHAPES[shape]) == \
            JA.model_flops(JB.get_config(arch), JS.SHAPES[shape])


def _keys(art) -> tuple:
    return (set(art), set(art["memory"]), set(art["roofline"]))


@pytest.mark.parametrize("arch,shape,seq,batch", SMOKE)
def test_lower_cell_smoke_mesh(runs, arch, shape, seq, batch):
    key = f"{arch}:{shape}"
    assert key in runs["smoke"], runs["logs"][key][-3000:]
    art = dict(runs["smoke"][key])
    assert art["status"] == "ok", art.get("error")
    want = json.load(open(JAX_ARTIFACT))
    rules_bytes = art.pop("rules_bytes", None)
    assert _keys(art) == _keys(want)
    assert art["n_chips"] == 8
    mem = art["memory"]
    if rules_bytes is not None:
        assert mem["argument_bytes"] == rules_bytes
    assert mem["total_per_device"] == mem["argument_bytes"] + \
        mem["temp_bytes"] > 0
    assert art["roofline"]["flops_per_device"] > 0
    if (arch, shape) == ("paper-lm-209m", "train_4k"):
        # sequence parallelism: the block outputs reduce-scattered onto
        # the residual's sequence shard (seq 64 on the model axis of 2)
        assert art["roofline"]["coll_breakdown"].get("reduce-scatter", 0) > 0


def test_remat_full_against_none_smoke_mesh(runs):
    """remat "full" holds the same arguments, fewer live bytes above them,
    and more FLOPs (the recomputed forward) than "none"."""
    full = runs["remat"]
    assert full is not None, runs["logs"]["remat"][-3000:]
    none = runs["smoke"]["paper-lm-209m:train_4k"]
    assert full["status"] == none["status"] == "ok", full.get("error")
    assert full["memory"]["argument_bytes"] == \
        none["memory"]["argument_bytes"]
    assert full["memory"]["temp_bytes"] < none["memory"]["temp_bytes"]
    assert full["cost"]["flops"] > none["cost"]["flops"]


def test_production_mesh_on_fake_group(runs):
    assert runs["rcs"]["mesh"] == 0, runs["logs"]["mesh"][-3000:]
    assert "MESH ('pod', 'data', 'model') (2, 16, 16)" in runs["logs"]["mesh"]


def test_cli_pod_artifact(runs):
    assert runs["rcs"]["cli"] == 0, runs["logs"]["cli"][-3000:]
    art = runs["cli"]
    assert art["status"] == "ok" and art["n_chips"] == 256
    assert _keys(art) == _keys(json.load(open(JAX_ARTIFACT)))


def test_calibration_flops_equal_real_step(runs):
    assert runs["calib"] is not None, runs["logs"]["calib"][-3000:]
    art = runs["calib"]["art"]
    assert art["status"] == "ok" and art["n_chips"] == 1
    assert art["cost"]["flops"] == runs["calib"]["real_flops"] > 0


# the local share's launches against the one-device update's: bytes per
# arena row (the fixed-size arguments, codebooks and scalars, aside)
UPDATE_ROW_RTOL = 1e-3


def test_local_update_matches_one_device_update(runs):
    whole, local = runs["update_host"], runs["update_tp2"]
    assert whole is not None and local is not None, \
        runs["logs"]["update_host"][-3000:] + runs["logs"]["update_tp2"][-3000:]
    assert whole["status"] == local["status"] == "ok"
    assert (whole["n_chips"], local["n_chips"]) == (1, 2)
    assert len(whole["launches"]) == len(local["launches"]) == 1
    (rows_w, bytes_w, segs), = whole["launches"]
    (rows_l, bytes_l, _), = local["launches"]
    # the two-device arena pads each leaf to an even block count, and the
    # shares to equal rows
    assert rows_w <= 2 * rows_l <= rows_w + segs + 1
    per_row_w, per_row_l = bytes_w / rows_w, bytes_l / rows_l
    assert abs(per_row_l - per_row_w) <= UPDATE_ROW_RTOL * per_row_w


def test_device_counter_counts_per_device(runs):
    got = runs["counter"]
    assert got is not None, runs["logs"]["counter"][-3000:]
    assert got["flops"] == got["global"] // got["shards"] > 0
    assert "DTensor has no OpDispatcher." in got["raised"]


# the counted trace's peak against the step-by-step trace's: the middle
# chunks' backward is not traced, and there the real loop holds one
# chunk's input gradients more than the first or the last chunk does (or
# one carry less); on these cells the two peaks are equal
SCAN_PEAK_RTOL = 0.005


@pytest.mark.parametrize("arch,shape,mesh", [c[:3] for c in SCANS])
def test_scan_counting_equals_step_by_step(runs, arch, shape, mesh):
    """The counted scans give the step-by-step trace's FLOPs, bytes read,
    bytes written and collective bytes of every kind exactly, its peak
    within SCAN_PEAK_RTOL."""
    key = f"{arch}:{shape}:{mesh}"
    got = runs["scans"][key]
    assert got is not None, runs["logs"]["scan:" + key][-3000:]
    counted, steps = got["counted"], got["steps"]
    assert counted["status"] == steps["status"] == "ok"
    for k in ("flops", "read", "written", "collectives", "n_collectives"):
        assert counted[k] == steps[k], k
    assert counted["flops"] > 0
    if mesh == "smoke":
        assert counted["collectives"]
    assert abs(counted["peak"] - steps["peak"]) <= \
        SCAN_PEAK_RTOL * steps["peak"]


def test_scan_counting_refuses_real_tensors():
    """The counting mode raises on a real tensor: a run on the CPU (or the
    card) cannot take it."""
    from repro_torch.models import scan_utils
    step = lambda h, x: (h + x, h + x)
    with scan_utils.counting(TA.DeviceCounter()):
        for grad in (False, True):
            xs = torch.zeros(192, 2, requires_grad=grad)
            with pytest.raises(RuntimeError, match="real tensor"):
                scan_utils.checkpointed_scan(step, torch.zeros(2), xs)
    _, ys = scan_utils.checkpointed_scan(step, torch.zeros(2),
                                         torch.ones(192, 2))
    assert float(ys[-1, 0]) == 192.0


def test_vocab_sharded_loss_keeps_the_vocab_sharded(runs):
    """Under activation sharding the loss reduces the vocab on its shards:
    no (B, S, V) tensor at the full vocab is live at the peak, and no
    collective returns one (the logits' local shards are (b, S, V / 2))."""
    got = runs["vocab"]
    assert got is not None, runs["logs"]["vocab"][-3000:]
    assert got["status"] == "ok", got.get("error")
    full = [s for s, _ in got["peak"] if len(s) >= 3 and s[-1] == VOCAB]
    assert not full, full
    assert any(len(s) >= 3 and s[-1] == VOCAB // 2 for s, _ in got["peak"])
    # no collective returns the logits of this device's rows (16 over the
    # 4 data-parallel devices, 64 positions) at the full vocab, in any
    # layout
    logits = (16 // 4) * 64 * VOCAB
    gathered = [r for r in got["collectives"] if len(r[1]) >= 3 and (
        r[1][-1] == VOCAB or math.prod(r[1]) >= logits)]
    assert not gathered, gathered


def test_xlstm_train_4k_smoke_matches_jax_artifact_counts():
    """The JAX artifact's cell: the parameter count and model FLOPs of
    xlstm-350m at train_4k are the port's exactly (the traced cell itself
    runs on the card machine's host, PERF.md)."""
    want = json.load(open(JAX_ARTIFACT))
    cfg = TB.get_config("xlstm-350m")
    assert cfg.param_count() == want["params"] == 347744256
    assert TA.model_flops(cfg, TS.SHAPES["train_4k"]) == \
        want["roofline"]["model_flops"] == 2187817685876736
