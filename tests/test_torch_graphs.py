"""The compiled round's host side on the CPU, where the engine runs eagerly.

On a card ``TorchEngine`` captures each chunk bucket's step as a CUDA graph
and replays it (``repro_torch/engine/graphs.py``); a graph reads its
inputs and state where they lay at capture, so every tensor a round reads
or writes must keep its storage.  The graphs themselves need a card
(``chip_smoke.py`` phase 21 holds replays bitwise against the eager step);
checked here:

(a) a CPU serve on split, fused and dense, under KV pressure (preemptions,
    swaps and slot re-binds), keeps the data pointers of ``block_tables``,
    ``lens``, ``last_token``, every cache tensor and each bucket's input
    buffer fixed across rounds;
(b) greedy outputs still equal ``JAXEngine``'s on the same converted
    weights, in f32, on each layout;
(c) the launch-count bookkeeping: a capture takes back what its recording
    counted and each replay adds the graph's launches once (stand-ins for
    the graph);
(d) ``_build_state`` (a pool re-bind) drops captured graphs;
(e) ``TorchEngine(..., device="cuda")`` without a card raises, graphs or
    not;
(f) the round's RoPE tables, computed once for all layers, give the round
    of the per-layer computation bit for bit (f32 and bf16; split, fused,
    dense);
(g) a sampling engine (temperature > 0, the graphs' registered generator
    on a card) warms up and serves on the CPU: an idle lane's NaN logits
    no longer make ``torch.multinomial`` raise;
(h) an engine that served, on each layout and loop, is freed as soon as
    its last reference goes, with Python's cyclic collector off: nothing
    of it sits in a reference cycle (``chip_smoke.py`` phase 21 gates the
    same with graphs, by the card's allocated bytes).
"""
import contextlib
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as jax_tiny_config
from repro.core.scheduler import ChunkedPrefillScheduler as JaxScheduler
from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro.engine.engine import EngineConfig as JaxEngineConfig
from repro.engine.engine import JAXEngine
from repro.engine.engine import serve as jax_serve
from repro.engine.workload import WorkloadSpec as JaxWorkloadSpec
from repro.engine.workload import attach_prompt_tokens as jax_attach
from repro.engine.workload import sharegpt_like as jax_sharegpt_like
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import tiny_config
from repro_torch.core.scheduler import ChunkedPrefillScheduler, SchedulerConfig
from repro_torch.engine import graphs
from repro_torch.engine.engine import EngineConfig, TorchEngine, serve
from repro_torch.engine.kv_cache import KVBlockPool, KVPoolConfig
from repro_torch.engine.sampler import SamplerConfig, sample_tokens
from repro_torch.engine.workload import (
    WorkloadSpec, attach_prompt_tokens, shared_prefix, sharegpt_like,
)
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.paged_prefill_attention import (
    paged_prefill_attention,
)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.weights import from_jax_params

WORKLOAD = dict(n_requests=6, inter_arrival_s=0.01, max_context=100,
                max_new_tokens=8, seed=7)
ENGINE = dict(n_slots=8, max_context=256)
SCHED = dict(policy="aging", token_budget=48, max_seqs=8)
LAYOUTS = {"split": dict(kv_layout="split"),
           "fused": dict(kv_layout="fused"),
           "dense": dict(paged_kv=False)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """Tiny f32 qwen JAX params, and the same weights in the port."""
    jcfg = jax_tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    tcfg = tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, from_jax_params(np_params, tcfg, device="cpu")


def _pointers(eng):
    ptrs = {"lens": eng.lens.data_ptr(),
            "last_token": eng.last_token.data_ptr(),
            **{f"cache[{n}]": t.data_ptr() for n, t in eng.cache.items()},
            **{f"inputs[{c}]": t.data_ptr()
               for c, t in eng._round_inputs.items()}}
    if eng.block_tables is not None:
        ptrs["block_tables"] = eng.block_tables.data_ptr()
    return ptrs


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_serve_keeps_round_buffers_in_place(weights, layout):
    """Every round, under KV pressure (preemptions, swap-outs, restores,
    prefix hits and slot re-binds: two waves of shared-prefix requests on
    an 11-block pool), reads and writes the same storage: what a graph
    captured at warm-up reads on every replay."""
    _, _, tcfg, tparams = weights
    eng = TorchEngine(tcfg, EngineConfig(preemption_mode="swap",
                                         n_slots=6, max_context=128, seed=3,
                                         **LAYOUTS[layout]),
                      params=tparams, device="cpu")
    pool = KVBlockPool(KVPoolConfig(n_blocks=11, block_size=16,
                                    bytes_per_token=4,
                                    enable_prefix_cache=True))
    eng.bind_kv_pool(pool)
    eng.warmup()
    seen = []
    dispatch = eng.dispatch

    def recording(batch):
        seen.append(_pointers(eng))
        out = dispatch(batch)
        seen.append(_pointers(eng))
        return out

    eng.dispatch = recording
    reqs = shared_prefix(n_requests=12, n_prefixes=2, prefix_len=48,
                         suffix_range=(8, 16), max_new_tokens=10,
                         inter_arrival_s=0.0, vocab_size=512, seed=5)
    for i, r in enumerate(reqs):
        r.arrival_time = 0.0 if i < 6 else 60.0
    sched = ChunkedPrefillScheduler(SchedulerConfig(
        policy="fcfs", token_budget=96, max_seqs=6))
    res = serve(reqs, sched, eng, kv_pool=pool)
    assert res.report.n_finished == len(reqs)
    assert sched.stats.swap_preemptions > 0
    assert sched.stats.swap_restores == sched.stats.swap_preemptions
    assert len(eng._round_inputs) > 1
    final = _pointers(eng)
    for ptrs in seen:
        assert all(final[k] == v for k, v in ptrs.items()), ptrs
    assert not eng.graphs and not eng.cuda_graphs


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_serve_matches_jax_engine(weights, layout):
    jcfg, jparams, tcfg, tparams = weights
    jeng = JAXEngine(jcfg, JaxEngineConfig(pipelined=False, **LAYOUTS[layout],
                                           **ENGINE), params=jparams)
    jreqs = jax_sharegpt_like(JaxWorkloadSpec(**WORKLOAD))
    jax_attach(jreqs, jcfg.vocab_size)
    jres = jax_serve(jreqs, JaxScheduler(JaxSchedulerConfig(**SCHED)), jeng)

    eng = TorchEngine(tcfg, EngineConfig(pipelined=True, **LAYOUTS[layout],
                                         **ENGINE),
                      params=tparams, device="cpu")
    reqs = sharegpt_like(WorkloadSpec(**WORKLOAD))
    attach_prompt_tokens(reqs, tcfg.vocab_size)
    res = serve(reqs, ChunkedPrefillScheduler(SchedulerConfig(**SCHED)), eng)
    assert res.report.n_finished == len(reqs)
    assert ([res.outputs[r.req_id] for r in reqs]
            == [jres.outputs[r.req_id] for r in jreqs])


class _StandInGraph:
    """What ``torch.cuda.CUDAGraph`` offers the bookkeeping: ``replay``
    (counted) and ``register_generator_state``."""

    def __init__(self):
        self.replays = 0
        self.generators = []

    def replay(self):
        self.replays += 1

    def register_generator_state(self, gen):
        self.generators.append(gen)


def test_replay_adds_the_graphs_launches_once_each():
    before = graphs.launch_counts()
    stand_in = _StandInGraph()
    outputs = (torch.zeros(3),)
    g = graphs.RoundGraph(stand_in, outputs,
                          {"paged_decode_attention": 24,
                           "paged_prefill_attention": 0})
    assert g.launches == {"paged_decode_attention": 24}
    try:
        for _ in range(3):
            assert g.replay() is outputs
        after = graphs.launch_counts()
        assert stand_in.replays == 3
        assert after["paged_decode_attention"] == (
            before["paged_decode_attention"] + 72)
        assert {n: c for n, c in after.items()
                if n != "paged_decode_attention"} == {
            n: c for n, c in before.items() if n != "paged_decode_attention"}
    finally:
        graphs.add_launches({"paged_decode_attention": 72}, -1)
    assert graphs.launch_counts() == before


def test_capture_keeps_the_windowed_launches_apart(monkeypatch):
    """A round of 8 layers, 6 of them windowed: the capture holds both
    counts, puts both back, and each replay adds both again."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, pool=None, stream=None:
                        contextlib.nullcontext())
    before = graphs.launch_counts()
    out = torch.ones(2)

    def round_():
        for l in range(8):
            paged_prefill_attention.launches += 1
            paged_prefill_attention.windowed_launches += l % 4 != 3
        return (out,)

    g = graphs.capture(round_, pool=None, stream=None)
    assert graphs.launch_counts() == before
    assert g.launches == {"paged_prefill_attention": 8,
                          "paged_prefill_attention.windowed": 6}
    g.replay()
    g.replay()
    after = graphs.launch_counts()
    assert (after["paged_prefill_attention"],
            after["paged_prefill_attention.windowed"]) == (
        before["paged_prefill_attention"] + 16,
        before["paged_prefill_attention.windowed"] + 12)
    graphs.add_launches({"paged_prefill_attention": 16,
                         "paged_prefill_attention.windowed": 12}, -1)
    assert graphs.launch_counts() == before


def test_capture_takes_back_what_the_recording_counted(monkeypatch):
    """Recording a round runs each wrapper once (each adds to its count)
    but launches nothing: the capture keeps the deltas for the replays and
    puts the counts back; a sampling round's generator is registered."""
    made = []

    def new_graph():
        made.append(_StandInGraph())
        return made[-1]

    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, pool=None, stream=None:
                        contextlib.nullcontext())
    before = graphs.launch_counts()
    out = torch.ones(2)

    def round_():
        for _ in range(4):
            paged_prefill_attention.launches += 1
        paged_decode_attention.launches += 2
        return (out,)

    gen = torch.Generator()
    g = graphs.capture(round_, pool=None, stream=None, generator=gen)
    assert graphs.launch_counts() == before
    assert g.launches == {"paged_prefill_attention": 4,
                          "paged_decode_attention": 2}
    assert g.outputs == (out,) and made[0].generators == [gen]
    g.replay()
    g.replay()
    after = graphs.launch_counts()
    assert after["paged_prefill_attention"] == (
        before["paged_prefill_attention"] + 8)
    assert after["paged_decode_attention"] == (
        before["paged_decode_attention"] + 4)
    graphs.add_launches({"paged_prefill_attention": 8,
                         "paged_decode_attention": 4}, -1)
    assert graphs.capture(lambda: (out,), pool=None, stream=None).launches == {}
    assert made[1].generators == []


@pytest.mark.parametrize("layout", ["split", "dense"])
def test_build_state_drops_captured_graphs(weights, layout):
    _, _, tcfg, tparams = weights
    eng = TorchEngine(tcfg, EngineConfig(**LAYOUTS[layout], **ENGINE),
                      params=tparams, device="cpu")
    buf = eng._inputs(16)
    eng.graphs[16] = graphs.RoundGraph(_StandInGraph(), (buf,), {})
    eng._graph_pool = (0, 1)
    eng._build_state()
    assert eng.graphs == {} and eng._graph_pool is None
    # the input buffers do not depend on the pool, and stay
    assert eng._inputs(16) is buf


def test_rebinding_the_pool_drops_captured_graphs(weights):
    _, _, tcfg, tparams = weights
    eng = TorchEngine(tcfg, EngineConfig(**ENGINE), params=tparams,
                      device="cpu")
    eng.graphs[1] = graphs.RoundGraph(_StandInGraph(), (eng.lens,), {})
    eng.bind_kv_pool(KVBlockPool(KVPoolConfig(n_blocks=40, block_size=16)))
    assert eng.graphs == {}
    assert eng.block_tables.shape == (ENGINE["n_slots"], eng.max_pages)


@pytest.mark.parametrize("cuda_graphs", [True, False])
def test_engine_on_cuda_without_a_card_raises(monkeypatch, cuda_graphs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchEngine(tiny_config("qwen1.5-0.5b"), device="cuda",
                    cuda_graphs=cuda_graphs)


# -- RoPE once a round ------------------------------------------------------------
def _per_layer_rope(x, positions, theta):
    """``layers.apply_rope`` as it was before the round computed the
    tables: frequencies, angles, cos and sin made anew for every call."""
    hd = x.shape[-1]
    freqs = L.rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _per_layer_qkv(p, x, cfg, positions=None, rope=True, rope_tabs=None):
    B, S, D = x.shape

    def proj(w):
        return (x @ w.reshape(D, -1)).reshape(B, S, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if rope and positions is not None:
        q = _per_layer_rope(q, positions, cfg.rope_theta)
        k = _per_layer_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mixed_rounds(cfg, layout, seed):
    """Three rounds (a prefill chunk, a mixed round, a decode) on one
    state, from numpy draws: their logits and the final cache."""
    rng = np.random.default_rng(seed)
    model = T.TransformerLM(cfg)
    dt = T.torch_dtype(cfg.param_dtype)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    B, hd, ps, n_phys = 4, cfg.resolved_head_dim, 8, 24
    if layout == "dense":
        cache = {n: torch.zeros((cfg.n_layers, B, 65, cfg.n_kv_heads, hd),
                                dtype=dt) for n in ("k", "v")}
    else:
        H = cfg.n_kv_heads * (2 if layout == "fused" else 1)
        names = ("kv",) if layout == "fused" else ("k", "v")
        cache = {n: torch.zeros((cfg.n_layers, n_phys, ps, H, hd), dtype=dt)
                 for n in names}
        tables = torch.from_numpy(
            rng.permutation(n_phys - 1)[:B * 5].reshape(B, 5).astype(np.int32))
    lens = torch.zeros(B, dtype=torch.int32)
    out = []
    for C, chunk in ((16, [16, 9, 0, 12]), (16, [1, 16, 1, 3]),
                     (1, [1, 1, 1, 0])):
        chunk = torch.tensor(chunk, dtype=torch.int32)
        tokens = torch.from_numpy(
            rng.integers(1, cfg.vocab_size, (B, C)).astype(np.int32))
        if layout == "dense":
            logits = model.chunked_step(params, tokens, cache, lens, chunk)
        else:
            logits = model.chunked_step_paged(params, tokens, cache, lens,
                                              chunk, tables)
        lens = lens + chunk
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["split", "fused", "dense"])
def test_round_rope_tables_match_per_layer_rope_bitwise(monkeypatch, layout,
                                                        dtype):
    cfg = tiny_config("qwen1.5-0.5b").with_(param_dtype=dtype)
    new_logits, new_cache = _mixed_rounds(cfg, layout, seed=3)
    monkeypatch.setattr(T.L, "qkv_project", _per_layer_qkv)
    old_logits, old_cache = _mixed_rounds(cfg, layout, seed=3)
    for a, b in list(zip(new_logits, old_logits)) + [
            (new_cache[n], old_cache[n]) for n in new_cache]:
        assert _same_bits(a, b)


def _same_bits(a, b):
    """Bitwise equality (an idle row's NaN logits included)."""
    iv = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(iv), b.view(iv))


def test_sampling_engine_warms_up_and_serves_on_the_cpu():
    """At temperature > 0 the idle lanes of a round (NaN logits under the
    plain attention) draw from the uniform distribution instead of making
    ``torch.multinomial`` raise, as ``jax.random.categorical`` draws; every
    request finishes with ids in the vocabulary."""
    cfg = tiny_config("qwen1.5-0.5b")
    eng = TorchEngine(cfg, EngineConfig(
        sampler=SamplerConfig(temperature=1.0, top_k=8), **ENGINE),
        device="cpu")
    eng.warmup()
    reqs = sharegpt_like(WorkloadSpec(**WORKLOAD))
    attach_prompt_tokens(reqs, cfg.vocab_size)
    res = serve(reqs, ChunkedPrefillScheduler(SchedulerConfig(**SCHED)), eng)
    assert res.report.n_finished == len(reqs)
    assert all(0 <= t < cfg.vocab_size
               for r in reqs for t in res.outputs[r.req_id])
    logits = torch.randn(3, 50)
    logits[1, 7] = float("nan")
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([sample_tokens(logits, gen, SamplerConfig(1.0))
                         for _ in range(200)])
    assert ((draws >= 0) & (draws < 50)).all()
    assert len(set(draws[:, 1].tolist())) > 20      # uniform over 50


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "sync"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dropped_engine_is_freed_without_the_cyclic_collector(layout,
                                                              pipelined):
    cfg = tiny_config("qwen1.5-0.5b")
    gc.collect()
    gc.disable()
    try:
        eng = TorchEngine(cfg, EngineConfig(pipelined=pipelined,
                                            **LAYOUTS[layout], **ENGINE),
                          device="cpu")
        eng.warmup()
        reqs = sharegpt_like(WorkloadSpec(**WORKLOAD))
        attach_prompt_tokens(reqs, cfg.vocab_size)
        res = serve(reqs, ChunkedPrefillScheduler(SchedulerConfig(**SCHED)),
                    eng)
        assert res.report.n_finished == len(reqs)
        ref = weakref.ref(eng)
        del eng, res
        assert ref() is None
    finally:
        gc.enable()
