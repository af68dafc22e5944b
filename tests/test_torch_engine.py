"""The port's serving engine (``repro_torch.engine``) end to end on the CPU:
``serve()`` of the port and of the JAX package on the same workload and the
same converted weights give identical greedy outputs per request; the
pipelined loop gives the synchronous loop's outputs; the port imports
neither ``jax`` nor ``repro``; an engine asked for the card without one
raises instead of falling back; and the serve CLI's chaos plans are the JAX
CLI's.
"""
import subprocess
import sys
from pathlib import Path

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
from repro.launch import serve as jax_serve_cli
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import tiny_config
from repro_torch.core.scheduler import ChunkedPrefillScheduler, SchedulerConfig
from repro_torch.engine.engine import EngineConfig, TorchEngine, serve
from repro_torch.engine.sampler import SamplerConfig, sample_tokens
from repro_torch.engine.workload import (
    WorkloadSpec, attach_prompt_tokens, sharegpt_like,
)
from repro_torch.launch import serve as serve_cli
from repro_torch.weights import from_jax_params

WORKLOAD = dict(n_requests=6, inter_arrival_s=0.01, max_context=100,
                max_new_tokens=8, seed=7)
ENGINE = dict(n_slots=8, max_context=256)
SCHED = dict(policy="aging", token_budget=48, max_seqs=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and several test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """Tiny f32 qwen (QKV bias) JAX params, and the same weights in the
    port."""
    jcfg = jax_tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    tcfg = tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, from_jax_params(np_params, tcfg, device="cpu")


def _torch_serve(cfg, params, *, pipelined):
    eng = TorchEngine(cfg, EngineConfig(pipelined=pipelined, **ENGINE),
                      params=params, device="cpu")
    reqs = sharegpt_like(WorkloadSpec(**WORKLOAD))
    attach_prompt_tokens(reqs, cfg.vocab_size)
    res = serve(reqs, ChunkedPrefillScheduler(SchedulerConfig(**SCHED)), eng)
    assert res.report.n_finished == len(reqs)
    return [res.outputs[r.req_id] for r in reqs], reqs


def test_serve_matches_jax_engine(weights):
    jcfg, jparams, tcfg, tparams = weights
    jeng = JAXEngine(jcfg, JaxEngineConfig(pipelined=False, **ENGINE),
                     params=jparams)
    jreqs = jax_sharegpt_like(JaxWorkloadSpec(**WORKLOAD))
    jax_attach(jreqs, jcfg.vocab_size)
    jres = jax_serve(jreqs, JaxScheduler(JaxSchedulerConfig(**SCHED)), jeng)
    want = [jres.outputs[r.req_id] for r in jreqs]

    got, reqs = _torch_serve(tcfg, tparams, pipelined=False)
    assert [r.prompt_tokens for r in reqs] == [r.prompt_tokens for r in jreqs]
    assert all(len(g) == r.max_new_tokens for g, r in zip(got, reqs))
    assert got == want


def test_pipelined_matches_sync(weights):
    _, _, tcfg, tparams = weights
    sync, _ = _torch_serve(tcfg, tparams, pipelined=False)
    piped, _ = _torch_serve(tcfg, tparams, pipelined=True)
    assert piped == sync


def test_port_imports_no_jax_and_no_repro():
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.engine.engine\n"
        "import repro_torch.weights, repro_torch.disagg\n"
        "import repro_torch.kernels.chunked_prefill_attention\n"
        "import repro_torch.kernels.decode_attention\n"
        "import repro_torch.kernels.fused_swiglu\n"
        "import repro_torch.kernels.paged_decode_attention\n"
        "import repro_torch.kernels.paged_prefill_attention\n"
        "import repro_torch.kernels.swap\n"
        "import repro_torch.core.predictor\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=src, text=True,
                         capture_output=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    for path in (src / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert words[:2] not in (["import", "jax"], ["import", "repro"]), path
            assert not (words[:1] == ["from"] and len(words) > 1 and (
                words[1] in ("jax", "repro") or words[1].startswith(
                    ("jax.", "repro.")))), (path, line)


def test_engine_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchEngine(tiny_config("qwen1.5-0.5b"))


@pytest.mark.parametrize(
    "seed,disagg", [(s, False) for s in range(8)] + [(s, True) for s in range(8)],
    ids=[str(s) for s in range(8)] + [f"disagg-{s}" for s in range(8)])
def test_serve_cli_chaos_plan_matches_jax_cli(seed, disagg):
    """``--chaos-seed N`` fuzzes the same FaultPlan over every site as the
    JAX package's serve CLI, colocated and ``--disagg`` alike (nan_logits
    included: the NaN guard is ported)."""
    args = serve_cli.build_parser().parse_args(
        ["--chaos-seed", str(seed), "--chaos-faults", "6"]
        + (["--disagg"] if disagg else []))
    plan = serve_cli.robustness_from_args(args).injector.plan
    want = jax_serve_cli.robustness_from_args(args).injector.plan
    assert len(plan.specs) == 6
    assert [vars(s) for s in plan.specs] == [vars(s) for s in want.specs]


def test_serve_cli_handoff_ttl_reaches_the_handoff_store():
    args = serve_cli.build_parser().parse_args(
        ["--device", "cpu", "--disagg", "--failover", "--handoff-ttl", "1.5",
         "--n-requests", "2"])
    router, reqs = serve_cli.build_fleet(args)
    assert router.store.ttl_s == 1.5
    assert len(router.prefill) == len(router.decode) == 1 and len(reqs) == 2
    # warmed up as build() warms the colocated engine
    assert all(rs.engine.warmed for rs in router.replicas)


def test_device_busy_is_the_union_of_device_events():
    ev = [
        {"ph": "X", "cat": "kernel", "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "ts": 500.0, "dur": 1000.0},  # overlaps
        {"ph": "X", "cat": "gpu_memcpy", "ts": 3000.0, "dur": 500.0},
        {"ph": "X", "cat": "gpu_memset", "ts": 3100.0, "dur": 100.0},  # inside
        {"ph": "X", "cat": "cuda_runtime", "ts": 0.0, "dur": 9000.0},  # host
        {"ph": "X", "cat": "cpu_op", "ts": 0.0, "dur": 9000.0},
        {"ph": "i", "cat": "kernel", "ts": 8000.0},
    ]
    assert serve_cli.device_busy_ms(ev) == pytest.approx(2.0)
    assert serve_cli.device_busy_ms([]) == 0.0


def test_swap_device_ms_sums_swap_kernels_and_copies_by_direction():
    big = 2 << 20
    ev = [
        {"ph": "X", "cat": "kernel", "name": "void swap::gather_kernel<int>()",
         "ts": 0.0, "dur": 40.0},
        {"ph": "X", "cat": "kernel", "name": "void swap::scatter_kernel<int>()",
         "ts": 50.0, "dur": 60.0},
        {"ph": "X", "cat": "kernel", "name": "void paged::paged_decode_kernel()",
         "ts": 0.0, "dur": 99.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)",
         "ts": 0.0, "dur": 500.0, "args": {"bytes": big}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)",
         "ts": 0.0, "dur": 2.0, "args": {"bytes": 64}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
         "ts": 0.0, "dur": 600.0, "args": {"bytes": big}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)",
         "ts": 0.0, "dur": 7.0, "args": {"bytes": big}},
        {"ph": "X", "cat": "cpu_op", "name": "swap::gather", "ts": 0.0,
         "dur": 9000.0},
    ]
    got = serve_cli.swap_device_ms(ev)
    assert got == {
        "swap kernels": (pytest.approx(0.1), 2, 0),
        "memcpy DtoH >= 256 KiB": (pytest.approx(0.5), 1, big),
        "memcpy DtoH < 256 KiB": (pytest.approx(0.002), 1, 64),
        "memcpy HtoD >= 256 KiB": (pytest.approx(0.6), 1, big),
    }
    assert serve_cli.swap_device_ms([]) == {}


def test_greedy_sampling_takes_first_maximum():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]])
    toks = sample_tokens(logits, None, SamplerConfig())
    assert toks.dtype == torch.int32 and toks.tolist() == [1, 0]
    assert toks.tolist() == np.asarray(
        jax.numpy.argmax(jax.numpy.asarray(logits.numpy()), axis=-1)).tolist()
