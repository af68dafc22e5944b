"""The yardstick's arithmetic against hand counts: the flops and bytes
functions at one shape, and the per-layer metrics' readers on hand-made
counters and rounds."""
import math

import pytest

from bench import cell as cells
from bench.flops import model as fm, peaks
from bench.loop import RoundRecord

CFG = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 2,
       "vocab_size": 10}


def test_active_params_hand_count():
    attn = 8 * 4 * 2 + 2 * 8 * 2 * 2 + 4 * 2 * 8          # 64 + 64 + 64
    assert fm.active_params(CFG) == 2 * (attn + 3 * 8 * 16)
    moe = dict(CFG, num_local_experts=4, num_experts_per_tok=2,
               parallel_attn_mlp_res=True)
    assert fm.active_params(moe) == 2 * (attn + 8 * 4 + 2 * 3 * 8 * 16 + 3 * 8 * 8)


def test_attention_cost_hand_count():
    # a decode row with 5 cached (6 keys) and a chunk of 3 after 2 cached
    # (keys 3, 4, 5)
    rows = [(5, 1), (2, 3)]
    flops, nbytes = fm.attention_cost(CFG, rows)
    assert flops == 4 * 4 * 2 * (6 + 3 + 4 + 5)
    kv = (6 + 5) * 2 * 2 * 2 * 2        # keys x (K, V) x Hkv x hd x bf16
    qo = 4 * 2 * 4 * 2 * 2              # tokens x (q, out) x Hq x hd x bf16
    assert nbytes == kv + qo
    assert fm.bound_s(flops, nbytes, 1.0, 2.0) == max(flops, nbytes / 2)


def test_step_flops_hand_count():
    rows = [(5, 1), (2, 3)]
    want = (2 * fm.active_params(CFG) * 4 + 4 * 2 * 4 * 2 * (6 + 3 + 4 + 5)
            + 2 * 8 * 10 * 2)
    assert fm.step_flops(CFG, rows, n_sampled=2) == want


class Ctx:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_useful_token_pct_from_hand_made_counters():
    r = cells.metric_reader("useful_token_pct")
    ctx = Ctx(n_slots=16, off=Ctx(scheduled_tokens=16 * 3 + 100,
                                  bucket_rounds={1: 3, 128: 1, 16: 0}))
    assert r.read(ctx) == pytest.approx(100 * 148 / (16 * 3 + 16 * 128))
    assert r.read(Ctx(n_slots=16, off=Ctx(scheduled_tokens=0,
                                          bucket_rounds={}))) is None


def test_device_idle_is_the_traces_union():
    from bench import trace_read
    r = cells.metric_reader("device_idle_pct")
    tr = trace_read.Trace(lo=0, hi=4 * 10**9, host=[],
                          device=[("a", 0, 2 * 10**9), ("b", 10**9, 3 * 10**9)])
    ctx = Ctx(trace=tr, window_s=tr.window_s, busy_s=trace_read.busy_s(tr))
    assert r.read(ctx) == pytest.approx(25.0)
    ctx.trace = trace_read.Trace(lo=0, hi=4 * 10**9, host=[], device=[])
    assert r.read(ctx) is None


def test_step_mfu_from_hand_made_rounds():
    r = cells.metric_reader("step_mfu_pct")
    rounds = [RoundRecord(C=16, rows=[(5, 1), (2, 3)], n_sampled=2)]
    ctx = Ctx(config=CFG, rounds=rounds, window_s=2.0, flops=fm, peaks=peaks)
    want = 100 * fm.step_flops(CFG, rounds[0].rows, 2) / (2.0 * 989e12)
    assert r.read(ctx) == pytest.approx(want)


def test_rooflines_read_nothing_without_their_kernel():
    from bench import trace_read
    tr = trace_read.Trace(lo=0, hi=10, device=[("gemm", 0, 5)], host=[])
    for name in ("decode_attn_roofline", "prefill_attn_roofline"):
        ctx = Ctx(config=CFG, rounds=[RoundRecord(1, [(3, 1)], 1),
                                      RoundRecord(16, [(0, 9)], 1)],
                  trace=tr, trace_read=trace_read, flops=fm, peaks=peaks,
                  log=print)
        assert cells.metric_reader(name).read(ctx) is None


def test_roofline_hand_count():
    from bench import trace_read
    rows = [(100, 1), (200, 1)]
    tr = trace_read.Trace(lo=0, hi=10**9, host=[], device=[
        ("void decode_splitk_kernel<x>", 0, 1000),
        ("void decode_splitk_kernel<x>", 2000, 3000)])
    ctx = Ctx(config=CFG, rounds=[RoundRecord(1, rows, 2)], trace=tr,
              trace_read=trace_read, flops=fm, peaks=peaks, log=print)
    f, b = fm.attention_cost(CFG, rows)
    bound = 2 * max(f / 989e12, b / 3.35e12)
    got = cells.metric_reader("decode_attn_roofline").read(ctx)
    assert got == pytest.approx(100 * bound / 2e-6)
    # a launch the profiler missed: the average launch stands for it
    ctx.trace = trace_read.Trace(lo=0, hi=10**9, host=[], device=tr.device[:1])
    assert cells.metric_reader("decode_attn_roofline").read(ctx) == \
        pytest.approx(100 * bound / 2 / 1e-6)


def test_busy_and_idle_gaps():
    from bench import trace_read
    tr = trace_read.Trace(lo=0, hi=100, device=[("a", 10, 30), ("b", 20, 40),
                                               ("c", 70, 80)],
                          host=[("bench.sleep", 0, 10), ("bench.schedule", 35, 60)])
    assert trace_read.busy_s(tr) == pytest.approx(40e-9)
    gaps = trace_read.idle_gaps(tr)
    assert gaps[0] == ["bench.schedule", pytest.approx(30e-9)]
    assert {g[0] for g in gaps} == {"bench.schedule", "bench.sleep",
                                    "host: outside the harness's spans"}
    assert math.isclose(sum(g[1] for g in gaps), 60e-9)


def test_arctic_dense_residual_is_hidden_size_wide():
    """Snowflake's ArcticMLP(is_residual_mlp=True) is hidden_size wide; the
    experts are intermediate_size wide: the program, the weights and the
    flops all take those widths."""
    config = cells.load_json(cells.ROOT / "bench/configs/arctic-1l.json")
    mcfg = cells.model_config(config)
    D, F = config["hidden_size"], config["intermediate_size"]
    assert (mcfg.d_ff, mcfg.moe.d_ff) == (D, F)
    draws = cells.model_module(config).draws(config, mcfg)
    shapes = {n: s for n, s, _, _ in draws}
    assert shapes["w_gate"] == (1, D, D) and shapes["e_gate"] == (1, 128, D, F)
    attn = D * 56 * 128 * 2 + 2 * D * 8 * 128
    assert fm.active_params(config) == attn + D * 128 + 2 * 3 * D * F + 3 * D * D
