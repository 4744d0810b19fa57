"""The port's static serving engine, its telemetry registry and the serve
launcher (mirrors tests/test_serve.py for the dense model, on the
non-gated, stable-embedding widths the port's model builds)."""
import subprocess
import sys
from bisect import bisect
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.errors import FormatError
from repro_torch.models import model as M
from repro_torch.serve import engine as E
from repro_torch.serve.kvcache import PagedKVConfig
from repro_torch.serve.scheduler import (ContinuousBatchingEngine, Request,
                                         SchedulerConfig)
from repro_torch.telemetry import MetricRegistry

ROOT = Path(__file__).resolve().parents[1]
WIDTHS = dict(arch_id="t", family="dense", n_layers=2, d_model=32,
              n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=97, head_dim=8,
              compute_dtype="float32", remat="none", attn_chunk=16,
              gated_mlp=False)
CFG = ModelConfig(**WIDTHS)


@pytest.fixture(scope="module")
def weights():
    params, _ = JM.init_model(JConfig(**WIDTHS), jax.random.PRNGKey(0))
    return params, convert.params_from_numpy(jax.device_get(params), CFG,
                                             device="cpu")


def _prompts(B=3, P=10):
    return np.random.RandomState(0).randint(0, 97, (B, P)).astype(np.int32)


class _ListSink:
    def __init__(self):
        self.events, self.flushes = [], 0

    def write(self, event):
        self.events.append(event)

    def flush(self):
        self.flushes += 1


def test_decode_matches_forward(weights):
    """prefill + decode reproduce the teacher-forced forward logits."""
    _, model = weights
    S, P = 20, 12
    tok = torch.from_numpy(
        np.random.RandomState(3).randint(0, 97, (2, S)).astype(np.int64))
    with torch.no_grad():
        full, _ = M.forward(CFG, model, tok)
    logits_p, cache = M.prefill(CFG, model, tok[:, :P], max_len=S)
    errs = [float((logits_p[:, -1] - full[:, P - 1]).abs().max())]
    for t in range(P, S):
        lg, cache = M.decode_step(CFG, model, tok[:, t:t + 1], cache, t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 5e-5, errs


def test_cache_layout_matches_jax():
    """The same pytree, leaf names, shapes and dtypes as the JAX
    package's caches (the leading axis is the layer)."""
    jc = JM.init_cache(JConfig(**WIDTHS), batch=2, max_len=16)
    tc = M.init_cache(CFG, 2, 16, device="cpu")
    assert tc["rem"] == [] and set(tc["scan"]) == set(jc["scan"])
    for name, leaf in jc["scan"]["b0_attn"].items():
        t = tc["scan"]["b0_attn"][name]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)
    jp = JM.init_paged_cache(JConfig(**WIDTHS), 3, 5, 4, 4)
    tp = M.init_paged_cache(CFG, 3, 5, 4, 4, device="cpu")
    for name, leaf in jp["scan"]["b0_attn"].items():
        assert tuple(tp["scan"]["b0_attn"][name].shape) == leaf.shape


def test_refuses_unported_configs():
    """Every block kind builds its paged cache now: the recurrent kinds'
    per-slot state (refused before they were ported) has the JAX
    package's tree and shapes; the attention family's features (sliding
    windows, gated MLPs, MoE) build too."""
    import dataclasses
    for kw in (dict(block_pattern=("rglru", "attn"), lru_width=16),
               dict(block_pattern=("mlstm",)), dict(block_pattern=("slstm",))):
        jp = JM.init_paged_cache(JConfig(**dict(WIDTHS, **kw)), 2, 4, 4)
        tp = M.init_paged_cache(dataclasses.replace(CFG, **kw), 2, 4, 4,
                                device="cpu")
        jl, jdef = jax.tree_util.tree_flatten(jp)
        tl, tdef = jax.tree_util.tree_flatten(tp)
        assert tdef == jdef
        for t, leaf in zip(tl, jl):
            assert tuple(t.shape) == leaf.shape
            assert torch.equal(t, torch.from_numpy(np.array(leaf)))
    for kw in (dict(attn_type="swa", window=8), dict(gated_mlp=True),
               dict(n_experts=4, top_k=2)):
        M.init_paged_cache(dataclasses.replace(CFG, **kw), 2, 4, 4,
                           device="cpu")


def test_generate_greedy_matches_jax(weights):
    """The static engine's greedy tokens equal the JAX ServeEngine's on
    the same weights."""
    params, model = weights
    prompts = _prompts()
    want = JE.ServeEngine(JConfig(**WIDTHS), params,
                          JE.ServeConfig(max_len=64)).generate(prompts, 6)
    got = E.ServeEngine(CFG, model, E.ServeConfig(max_len=64)).generate(
        prompts, 6)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_generate_greedy_deterministic(weights):
    _, model = weights
    eng = E.ServeEngine(CFG, model, E.ServeConfig(max_len=64))
    g1 = eng.generate(_prompts(), 6)
    g2 = eng.generate(_prompts(), 6)
    np.testing.assert_array_equal(g1, g2)
    assert g1.shape == (3, 6)


def test_generate_zero_new_tokens_is_empty(weights):
    _, model = weights
    eng = E.ServeEngine(CFG, model, E.ServeConfig(max_len=64))
    out = eng.generate(_prompts(), 0)
    assert out.shape == (3, 0) and out.dtype == np.int32


def test_generate_capacity_check_raises(weights):
    _, model = weights
    eng = E.ServeEngine(CFG, model, E.ServeConfig(max_len=16))
    prompts = np.zeros((2, 10), np.int32)
    with pytest.raises(ValueError, match="10.*7.*16"):
        eng.generate(prompts, 7)
    with pytest.raises(ValueError, match="-1"):
        eng.generate(prompts, -1)


def test_serve_telemetry_latency_and_throughput(weights):
    """Per-request latency lands in the pre-binned histogram (cumulative
    across calls, 0-token requests included) and a generated tokens/s
    gauge is published; flush emits one event per metric."""
    _, model = weights
    reg = MetricRegistry()
    sink = _ListSink()
    reg.add_sink(sink)
    eng = E.ServeEngine(CFG, model, E.ServeConfig(max_len=64), registry=reg)
    eng.generate(_prompts(), 6)
    eng.generate(_prompts(), 0)
    m = reg.metrics()
    counts = np.asarray(m["serve/latency_ms"])
    assert counts.shape == (E.N_LATENCY_BINS,)
    assert counts.sum() == 6          # 3 requests per call, 2 calls
    assert m["serve/requests"] == 6
    assert m["serve/generated_tokens"] == 18
    assert m["serve/tokens_per_s"] > 0.0
    reg.flush(step=3)
    assert sink.flushes == 1
    assert {ev["name"] for ev in sink.events} == set(m)
    for ev in sink.events:
        assert ev["schema"] == "repro.telemetry.v1" and ev["step"] == 3
        assert ev["kind"] == "metric" and ev["value"] == m[ev["name"]]
    hist = [ev for ev in sink.events if ev["type"] == "histogram"]
    assert hist and hist[0]["n_bins"] == E.N_LATENCY_BINS


def test_generate_sampled_calls_differ(weights):
    """Successive sampled calls draw from distinct streams; a fresh engine
    with the same seed reproduces the first."""
    _, model = weights
    mk = lambda: E.ServeEngine(CFG, model, E.ServeConfig(
        max_len=64, temperature=1.0, seed=3))
    eng = mk()
    g1 = eng.generate(_prompts(), 12)
    g2 = eng.generate(_prompts(), 12)
    assert not np.array_equal(g1, g2)
    np.testing.assert_array_equal(g1, mk().generate(_prompts(), 12))


def test_sample_is_gumbel_max_over_counter_hash():
    """Sampling is a function of (logits, keys) alone, greedy is the first
    argmax, and the draws follow the softmax (a chi-square-free check: the
    empirical frequencies of a 3-way distribution over 4000 keys)."""
    logits = torch.tensor([[0.0, 2.0, 2.0, -1.0]])
    assert int(E.sample(logits, 0.0)) == 1          # ties: first index
    keys = E.stream_keys(7, torch.zeros(4000, dtype=torch.int64),
                         torch.arange(4000))
    lg = torch.log(torch.tensor([0.2, 0.5, 0.3])).expand(4000, 3)
    draws = E.sample(lg, 1.0, keys)
    np.testing.assert_array_equal(draws, E.sample(lg, 1.0, keys))
    freq = np.bincount(draws.numpy(), minlength=3) / 4000
    np.testing.assert_allclose(freq, [0.2, 0.5, 0.3], atol=0.03)


def test_latency_histogram_bin_edges(weights):
    """An exact edge lands in the bin to its right (bisect), anything past
    10 s in the overflow bin; the edges are the JAX package's."""
    assert E.LATENCY_BIN_EDGES_MS == JE.LATENCY_BIN_EDGES_MS
    assert E.N_LATENCY_BINS == len(E.LATENCY_BIN_EDGES_MS) + 1
    assert bisect(E.LATENCY_BIN_EDGES_MS, 0.5) == 0
    for i, edge in enumerate(E.LATENCY_BIN_EDGES_MS):
        assert bisect(E.LATENCY_BIN_EDGES_MS, edge) == i + 1
        assert bisect(E.LATENCY_BIN_EDGES_MS, edge - 1e-9) == i
    _, model = weights
    reg = MetricRegistry()
    eng = E.ServeEngine(CFG, model, E.ServeConfig(max_len=64), registry=reg)
    eng._observe_request(1, 10, 0.002)
    eng._observe_request(2, 10, 7200.0)
    counts = np.asarray(reg.metrics()["serve/latency_ms"])
    assert counts[1] == 1 and counts[E.N_LATENCY_BINS - 1] == 2
    assert counts.sum() == 3


def test_scheduler_telemetry(weights):
    """Scheduler counters and gauges: admissions, completions, occupancy,
    tokens/s, KV bytes per token, the latency histogram."""
    _, model = weights
    reg = MetricRegistry()
    kv = PagedKVConfig(page_size=4, n_pages=6, n_slots=2,
                       max_pages_per_seq=3)
    eng = ContinuousBatchingEngine(CFG, model, SchedulerConfig(kv=kv),
                                   registry=reg)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=tuple(rng.randint(0, 97, 5).tolist()),
                    max_new_tokens=6) for i in range(4)]
    eng.serve(reqs)
    m = reg.metrics()
    assert m["serve/sched/admitted"] >= 4
    assert m["serve/sched/completed"] == 4
    assert m["serve/requests"] == 4
    assert m["serve/generated_tokens"] == 24
    assert 0.0 <= m["serve/sched/slot_occupancy"] <= 1.0
    assert m["serve/sched/page_occupancy"] == 0.0   # all released at end
    assert m["serve/tokens_per_s"] > 0.0
    assert m["serve/kv_bytes_per_token"] > 0.0
    assert np.asarray(m["serve/latency_ms"]).sum() == 4
    lat = eng.latency_percentiles()
    assert 0.0 < lat["p50_ms"] <= lat["p99_ms"]


def test_registry_types_and_errors():
    reg = MetricRegistry()
    assert reg.counter("a").inc(2) == 2 and reg.counter("a").inc() == 3
    with pytest.raises(ValueError):
        reg.counter("a").inc(-1)
    with pytest.raises(TypeError):
        reg.gauge("a")
    reg.gauge("g").set(np.float32(1.5))
    assert reg.get("g") == 1.5 and reg.get("missing") is None
    h = reg.histogram("h", n_bins=3)
    h.observe_counts([1, 0, 2])
    assert reg.get("h") == [1, 0, 2]
    with pytest.raises(FormatError):
        h.observe_counts([1, 2])
    with pytest.raises(TypeError):
        reg.histogram("h", n_bins=4)
    reg.gauge("unset")
    sink = _ListSink()
    reg.add_sink(sink)
    reg.flush()
    assert {ev["name"] for ev in sink.events} == {"a", "g", "h"}


def _launcher(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduce",
         "--streams", "4", "--max-new", "6", *args],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=300)


def test_launch_serve_cpu_smoke():
    """``python -m repro_torch.launch.serve --reduce --device cpu``: every
    request completes and the summary line is printed; without a card the
    default device raises, as every entry point does."""
    import json
    r = _launcher("--device", "cpu")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert sum(line.startswith("request ") for line in lines) == 4
    summary = json.loads(lines[-1])
    assert summary["engine"] == "paged" and summary["device"] == "cpu"
    assert summary["tokens_per_s"] > 0 and summary["p99_ms"] > 0
    r = _launcher("--device", "cpu", "--engine", "static", "--prompt-lens",
                  "8", "--serve-kv-bits", "4")
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1])["kv_bits"] == 16


def test_launch_serve_refuses_out_and_missing_card(monkeypatch, tmp_path):
    """--out (ported with A11) writes the registry as telemetry JSONL that
    the JAX package's validator accepts; without a card the launcher
    refuses the default device."""
    from repro.telemetry.export import validate_jsonl
    from repro_torch.launch import serve as launcher
    out = str(tmp_path / "serve.jsonl")
    summary = launcher.main(["--reduce", "--device", "cpu", "--out", out])
    events, errors = validate_jsonl(out)
    assert errors == [] and events
    got = {e["name"]: e["value"] for e in events if e["kind"] == "metric"}
    assert got["serve/tokens_per_s"] == summary["tokens_per_s"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--reduce"])
