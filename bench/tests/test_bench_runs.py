"""Whole runs of the harness on the CPU at a tiny size (the look for a
card skipped): a sound run comes out correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault a served cell
can have; the float8 control fails the limit the sound run meets; the
reference agrees with the program's path in float32; a cell made only of
added files runs, its model module and reference too, and a model module
that maps a key wrongly is caught."""
import json

import pytest
import torch

from bench import cell as cells
from bench.tests import conftest

SEED = 2**31 + 5


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _run(root, name, tamper=None, trace=False, seconds=3.0):
    import bench.run as run
    return run.run_cell(cells.find_cell(name, root), SEED, seconds, trace,
                        device="cpu", tamper=tamper, log=lambda *a, **k: None)


def test_sound_run_is_correct_and_reports_its_metrics(tiny_root):
    res = _run(tiny_root, "tiny-dense.tiny")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"out_tok_s", "ttft_p95_ms", "itl_p95_ms",
                                   "e2e_p90_ms", "setup_s"}
    assert list(res) [-1] == "checks"
    import bench.run as run
    line = json.loads(run.result_line(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "checks"


def test_traced_run_reports_host_metrics(tiny_root):
    res = _run(tiny_root, "tiny-dense.tiny", trace=True)
    assert res["correct"], res["checks"]
    for name in ("gen_lag_p99_ms", "sched_ms_per_round", "useful_token_pct",
                 "bubble_ms_mean", "step_mfu_pct"):
        assert name in res["metrics"], name
    assert 0 < res["metrics"]["useful_token_pct"]["value"] <= 100
    assert "device_ops" in res["breakdown"] and "idle_gaps" in res["breakdown"]


def _state_unchanged(stack):
    """Each round's K/V writes land in copies: the cache never changes."""
    impl = stack.engine.model.impl
    split = type(impl)._attend_split

    def attend(ck, cv, *rest):
        return split(ck.clone(), cv.clone(), *rest)
    impl._attend_split = attend


def _half_batch(stack):
    """The upper half of the slots computes on zeros."""
    eng = stack.engine
    step = type(eng)._step

    def half(tokens, *rest):
        tokens = tokens.clone()
        tokens[tokens.shape[0] // 2:] = 0
        return step(eng, tokens, *rest)
    eng._step = half


def _altered_token(stack):
    """Every sampled id of every fifth round is off by one as it leaves the
    round: from the eager step on the CPU, from each bucket's graph replay
    on a card (the ids fed back on the device stay the model's)."""
    eng = stack.engine
    n = [0]

    def alter(out):
        n[0] += 1
        if n[0] % 5 == 0:
            return ((out[0] + 1) % stack.mcfg.vocab_size,) + tuple(out[1:])
        return out

    if eng.graphs:
        for g in eng.graphs.values():
            g.replay = (lambda replay: lambda: alter(replay()))(g.replay)
    else:
        step = type(eng)._step
        eng._step = lambda *args: alter(step(eng, *args))


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _altered_token])
def test_fault_makes_correct_false(tiny_root, fault):
    res = _run(tiny_root, "tiny-dense.tiny", tamper=fault)
    assert not res["correct"], res["checks"]


def test_float8_control_fails_the_limit_the_program_meets(tiny_root):
    from bench import compare
    import bench.run as run

    cell = cells.find_cell("tiny-dense.tiny", tiny_root)
    stack = run.Stack(cell, SEED, "cpu")
    server = stack.server(stack.scheduler())
    reqs, prompts = stack.requests(cell.params["rate_per_s"], 3.0, SEED)
    import time
    from bench import loop
    loop.serve_window(server, reqs, time.perf_counter(), 3.5)
    done = compare.from_requests(reqs, prompts, server.outputs)
    ch = compare.checks(cells.reference_module(cell.config, tiny_root),
                        cell.config, stack.stacks, done, SEED, control=True)
    limit = cell.config["limits"]["max_logit_gap"]
    assert ch["max_logit_gap"]["value"] <= limit
    assert ch["control_max_logit_gap"]["value"] > limit


@pytest.mark.parametrize("name", ["tiny-dense.tiny", "tiny-moe.tiny",
                                  "tiny-qkvbias.tiny"])
def test_reference_equals_the_program_in_float32(tmp_path, name, monkeypatch):
    for cfg in conftest.TINY_CONFIGS.values():
        monkeypatch.setitem(cfg, "torch_dtype", "float32")
    root = conftest.make_root(tmp_path)
    res = _run(root, name)
    assert res["checks"]["max_logit_gap"]["value"] < 1e-4, res["checks"]
    assert res["correct"]


@pytest.mark.parametrize("name", ["tiny-moe.tiny", "tiny-qkvbias.tiny"])
def test_a_cell_of_added_files_only_runs(tiny_root, name):
    """The tiny cells, their configurations, their mix, a new metric, and
    for ``tiny-qkvbias`` its model module and reference, are files added
    beside the benchmark's; BENCHMARK.json only gains entries, and no other
    file changes."""
    root = tiny_root
    for p in (conftest.ROOT / "bench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts and ".cache" not in p.parts:
            rel = p.relative_to(conftest.ROOT)
            assert (root / rel).read_bytes() == p.read_bytes(), rel
    (root / "bench/metrics/rounds_traced.py").write_text(
        'LAYER = "engine round"\nUNIT = "rounds"\nMOVES = "out_tok_s"\n'
        "def read(ctx):\n    return float(len(ctx.off.rounds)) or None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "rounds_traced", "unit": "rounds",
                               "better": "higher", "source": "program_counter",
                               "layer": "engine round", "moves": "out_tok_s",
                               "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = _run(root, name, trace=True)
    assert res["metrics"]["rounds_traced"]["value"] > 0


def test_a_model_of_added_files_is_correct(tiny_root):
    """``tiny-qkvbias``'s added model module and reference, in bfloat16."""
    res = _run(tiny_root, "tiny-qkvbias.tiny")
    assert res["correct"], res["checks"]


def test_a_model_module_that_drops_a_key_is_caught(tiny_root):
    """A model module whose ``program_config`` leaves out the biases: the
    weights are drawn and the reference adds them, the program does not,
    and ``correct`` comes out false through the added module."""
    path = tiny_root / "bench/models/qkvbias.py"
    src = path.read_text()
    mapped = 'qkv_bias=bool(config["attention_bias"])'
    assert src.count(mapped) == 1
    path.write_text(src.replace(mapped, "qkv_bias=False"))
    res = _run(tiny_root, "tiny-qkvbias.tiny")
    assert not res["correct"], res["checks"]


def test_metric_files_declare_what_benchmark_json_says():
    bench = json.loads((conftest.ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        mod = cells.metric_reader(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])
        assert getattr(mod, "WORKLOADS", None) == m.get("workloads")


SMALL = {"hidden_size": 256, "intermediate_size": 512, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 64, "vocab_size": 1024}


@pytest.mark.card
def test_on_the_card_sound_passes_and_the_control_fails(card, tmp_path,
                                                        monkeypatch):
    """The kernels' path at a size they take (head_dim 64): a sound run is
    correct, the float8 control reads above the limit, and a token altered
    where it is produced makes the run incorrect."""
    for k, v in SMALL.items():
        monkeypatch.setitem(conftest.TINY, k, v)
    root = conftest.make_root(tmp_path)
    name = "tiny-dense.tiny"
    import time
    import bench.run as run
    from bench import compare, loop

    cell = cells.find_cell(name, root)
    stack = run.Stack(cell, SEED, "cuda", log=lambda *a, **k: None)
    server = stack.server(stack.scheduler())
    reqs, prompts = stack.requests(cell.params["rate_per_s"], 3.0, SEED)
    loop.serve_window(server, reqs, time.perf_counter(), 3.5)
    done = compare.from_requests(reqs, prompts, server.outputs)
    ch = compare.checks(cells.reference_module(cell.config, root), cell.config,
                        stack.stacks, done, SEED, control=True)
    assert compare.passed(ch), ch
    assert any(not v["value"] <= v["limit"] for k, v in ch.items()
               if k.startswith("control_") and v["limit"] is not None), ch
    bad = run.run_cell(cell, SEED, 3.0, False, device="cuda",
                       tamper=_altered_token, log=lambda *a, **k: None)
    assert not bad["correct"], bad["checks"]
