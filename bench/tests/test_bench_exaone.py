"""The K-EXAONE form's files (``bench/configs/k-exaone-8l.json``,
``bench/models/exaone_moe.py``, ``bench/reference/exaone_moe.py``): the
program's ``ModelConfig`` and the draws of ``k-exaone-8l``; the attention
launches' bounds on hand-made rows, a row past the window among them; the
active parameters of the uncut model against its published 22.7B; and a
tiny form of it served as added files through the harness on the CPU, as
``test_a_cell_of_added_files_only_runs`` serves its cells."""
import copy
import json
import math

import pytest
import torch

from bench import cell as cells
from bench.flops import model as fm
from bench.tests import conftest

EXAONE = cells.load_json(cells.ROOT / "bench/configs/k-exaone-8l.json")
SEED = 2**31 + 77


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_model_config_takes_each_layers_kind():
    mcfg = cells.model_config(EXAONE)
    assert type(mcfg).__name__ == "LayeredModelConfig"
    assert (mcfg.n_layers, mcfg.d_model, mcfg.n_heads, mcfg.n_kv_heads,
            mcfg.resolved_head_dim, mcfg.d_ff, mcfg.vocab_size) == (
        8, 6144, 64, 8, 128, 18432, 153600)
    assert mcfg.layer_windows == (128, 128, 128, 0) * 2
    assert mcfg.layer_rope == (True, True, True, False) * 2
    assert mcfg.layer_sparse == (False,) + (True,) * 7
    assert mcfg.qk_norm and mcfg.post_norm and not mcfg.uniform_layers
    assert (mcfg.rope_theta, mcfg.norm_eps) == (1e6, 1e-5)
    m = mcfg.moe
    assert (m.n_experts, m.top_k, m.d_ff, m.capacity_factor) == (128, 8, 2048, 16.0)
    assert (m.scoring, m.routed_scale) == ("sigmoid", 2.5)
    assert (m.n_shared, m.shared_d_ff, m.first_held, m.held) == (1, 2048, 0, 64)


@pytest.mark.parametrize("key,value", [("n_group", 8),
                                       ("norm_topk_prob", False)])
def test_model_config_refuses_a_router_the_program_does_not_compute(key,
                                                                   value):
    with pytest.raises(ValueError, match=key):
        cells.model_config({**EXAONE, key: value})


def test_draws_hold_the_held_experts_only():
    mcfg = cells.model_config(EXAONE)
    draws = cells.model_module(EXAONE).draws(EXAONE, mcfg)
    got = {n: (tuple(s), sc, str(dt).replace("torch.", ""))
           for n, s, sc, dt in draws}
    D, F, Fe = 6144, 18432, 2048
    sd = 1 / math.sqrt(D)
    assert got == {
        "embed": ((153600, D), 0.02, "bfloat16"),
        "wq": ((8, D, 64, 128), sd, "bfloat16"),
        "wk": ((8, D, 8, 128), sd, "bfloat16"),
        "wv": ((8, D, 8, 128), sd, "bfloat16"),
        "wo": ((8, 64, 128, D), 1 / math.sqrt(8192), "bfloat16"),
        "q_norm": ((8, 128), 0.0, "bfloat16"),
        "k_norm": ((8, 128), 0.0, "bfloat16"),
        "post_attn_norm": ((8, D), 0.0, "bfloat16"),
        "post_ffn_norm": ((8, D), 0.0, "bfloat16"),
        "w_gate": ((1, D, F), sd, "bfloat16"),
        "w_up": ((1, D, F), sd, "bfloat16"),
        "w_down": ((1, F, D), 1 / math.sqrt(F), "bfloat16"),
        "router": ((7, D, 128), sd, "float32"),
        "router_bias": ((7, 128), 0.1, "float32"),
        "e_gate": ((7, 64, D, Fe), sd, "bfloat16"),
        "e_up": ((7, 64, D, Fe), sd, "bfloat16"),
        "e_down": ((7, 64, Fe, D), 1 / math.sqrt(Fe), "bfloat16"),
        "s_gate": ((7, D, Fe), sd, "bfloat16"),
        "s_up": ((7, D, Fe), sd, "bfloat16"),
        "s_down": ((7, Fe, D), 1 / math.sqrt(Fe), "bfloat16"),
        "final_norm": ((D,), 0.0, "bfloat16"),
        "lm_head": ((D, 153600), sd, "bfloat16")}
    assert [n for n, *_ in draws][0] == "embed"
    weights_gb = sum(math.prod(s) * (4 if dt == torch.float32 else 2)
                     for _, s, _, dt in draws) / 1e9
    assert 40.0 < weights_gb < 41.5


def _keys_by_hand(rows, W):
    """Each new token's visible keys, counted one by one: (query-key pairs,
    distinct K/V rows read)."""
    pairs, rows_read = 0, 0
    for c, n in rows:
        seen = set()
        for i in range(n):
            p = c + i
            keys = [j for j in range(p + 1) if not W or j > p - W]
            pairs += len(keys)
            seen.update(keys)
        rows_read += len(seen)
    return pairs, rows_read


# one row past the window in each: a decode at 300 cached, a chunk of 64
# at 1,000, a chunk of 3 at 130 (and one that ends past the window but
# reads no further back than its own context)
ROWS = {"decodes": [(300, 1), (5, 1), (127, 1), (128, 1)],
        "chunks": [(1000, 64), (0, 100)],
        "mixed": [(130, 3), (2047, 1), (0, 128), (90, 60)]}


@pytest.mark.parametrize("name", sorted(ROWS))
def test_launches_count_the_keys_within_each_window(name):
    rows = ROWS[name]
    model = cells.model_module(EXAONE)
    Hq, Hkv, hd = 64, 8, 128
    launches = fm.attention_launches(EXAONE, rows)
    windowed = model.window_launches(EXAONE, rows)
    assert len(launches) == 8 and len(windowed) == 6
    qo = sum(n for _, n in rows) * 2 * Hq * hd * 2
    for W, (f, b) in zip((128, 128, 128, 0) * 2, launches):
        pairs, kv_rows = _keys_by_hand(rows, W)
        assert f == 4.0 * Hq * hd * pairs
        assert b == kv_rows * 2 * Hkv * hd * 2 + qo
    assert windowed == [launches[l] for l in (0, 1, 2, 4, 5, 6)]
    # a row past the window reads 128 keys (decode) or 128 + n - 1 (chunk)
    _, kv_rows = _keys_by_hand([rows[0]], 128)
    c, n = rows[0]
    assert c + n > 128 and kv_rows == min(c + n, 128 + n - 1) < c + n


def uncut():
    c = copy.deepcopy(EXAONE)
    c.update(num_hidden_layers=48, num_experts=128)
    return c


def test_active_parameters_are_the_published_22_7b():
    """At the uncut sizes (48 layers, all 128 experts held): attention,
    the dense layer, each sparse layer's router, top-8 experts and shared
    expert, and one of the embedding and the head, as the name's A23B
    counts: 22.7B."""
    n = fm.active_params(uncut()) + 153600 * 6144
    assert n == pytest.approx(22.72e9, rel=2e-3)
    # the cut counts the routed experts at the held share, 8 x 64 / 128
    D, Fe = 6144, 2048
    per_layer = fm.active_params(uncut()) - fm.active_params(
        dict(uncut(), num_experts=64))
    assert per_layer == 47 * 4 * 3 * D * Fe


def tiny_exaone(dtype="bfloat16"):
    c = copy.deepcopy(EXAONE)
    c.update(hidden_size=64, intermediate_size=96, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, vocab_size=512,
             moe_intermediate_size=32, num_experts=4, num_experts_per_tok=2,
             published={"num_hidden_layers": 48, "num_experts": 8},
             sliding_windows=[4 if w else 0 for w in c["sliding_windows"]],
             torch_dtype=dtype,
             limits={"delivery_faults": 0, "max_logit_gap": 0.25},
             serving=conftest.serving({}, moe_capacity_factor=4.0))
    return c


def exaone_root(tmp_path, dtype="bfloat16"):
    """The tiny roots' benchmark plus ``tiny-exaone``: its configuration,
    its cell under the tiny mix, and ``window_attn_roofline`` listing it;
    its model module and reference are the benchmark's own files."""
    root = conftest.make_root(tmp_path)
    c = dict(tiny_exaone(dtype), name="tiny-exaone")
    (root / "bench/configs/tiny-exaone.json").write_text(json.dumps(c))
    (root / "bench/cells/tiny-exaone.tiny.json").write_text(
        json.dumps({"rate_per_s": 12.0}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-exaone", "source": "test",
                             "reduced": [], "why": "test",
                             "file": "bench/configs/tiny-exaone.json"})
    bench["workloads"].append({"name": "tiny-exaone.tiny",
                               "config": "tiny-exaone", "traffic": "tiny",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "k-exaone-8l.longdoc" in m.get("workloads", []):
            m["workloads"].append("tiny-exaone.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, trace=False):
    """A run of the tiny cell: a window of 5 s, so that the finished
    requests hold the check's 400 tokens on a busy CPU."""
    import bench.run as run
    return run.run_cell(cells.find_cell("tiny-exaone.tiny", root), SEED, 5.0,
                        trace, device="cpu", log=lambda *a, **k: None)


def test_a_tiny_exaone_cell_of_added_files_runs(tmp_path):
    """Served, traced and checked by the harness in float32, where the
    program and the reference agree to rounding; on the CPU no windowed
    kernel is traced, so ``window_attn_roofline`` finds nothing and is left
    out.  (In bfloat16 the CPU serves too few tokens in a short window for
    the check.)"""
    root = exaone_root(tmp_path, "float32")
    res = _run(root, trace=True)
    assert res["correct"], res["checks"]
    assert "useful_token_pct" in res["metrics"]
    assert "window_attn_roofline" not in res["metrics"]
    res = _run(root)
    assert res["checks"]["max_logit_gap"]["value"] < 1e-4, res["checks"]
    assert set(res["metrics"]) == {"out_tok_s", "ttft_p95_ms", "e2e_p90_ms",
                                   "setup_s"}


def test_window_reader_sums_the_window_launches(tmp_path):
    """Traced launches of the windowed kernels (by name) against the
    module's ``window_launches``: the unwindowed ones are not counted."""
    from bench import trace_read
    from bench.flops import peaks
    from bench.loop import RoundRecord

    rounds = [RoundRecord(1, [(300, 1), (5, 1)], 2),
              RoundRecord(16, [(1000, 16)], 1)]
    names = (["void paged::dec::decode_splitk_kernel<__nv_bfloat16, 128, 16, "
              "true, paged::PagedKV<__nv_bfloat16, false>, paged::SlidingWindow>"]
             * 6 + ["void paged::paged_prefill_wgmma_kernel<128, false, "
                    "paged::SlidingWindow>"] * 6
             + ["void paged::paged_prefill_wgmma_kernel<128, false, "
                "paged::Causal>"] * 2)
    tr = trace_read.Trace(lo=0, hi=10**9, host=[], device=[
        (n, 100 * i, 100 * i + 50) for i, n in enumerate(names)])

    class Ctx:
        config = EXAONE
        trace = tr
        flops = fm.Yardstick()
        log = print
    Ctx.rounds, Ctx.trace_read, Ctx.peaks = rounds, trace_read, peaks
    model = cells.model_module(EXAONE)
    bound = sum(fm.bound_s(f, b, peaks.BF16_FLOPS, peaks.HBM_BYTES_PER_S)
                for r in rounds for f, b in model.window_launches(EXAONE, r.rows))
    got = cells.metric_reader("window_attn_roofline").read(Ctx)
    assert got == pytest.approx(100 * bound / (12 * 50e-9))
