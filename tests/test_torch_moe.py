"""The MoE and VLM families in the port against the JAX package, on the CPU.

(a) ``moe_ffn`` (the GShard one-hot dispatch's semantics) and
    ``moe_ffn_scatter`` against ``repro.models.layers``' on the same numpy
    inputs and converted params: one group, several groups, the gcd
    fallback, capacity factor 1.25 with drops, rows with exact router ties
    and all-NaN rows (an idle lane of the plain attention);
(b) the reference's one-hot fault: a NaN row turns every output of
    ``repro``'s ``moe_ffn`` NaN (0 * NaN in its dispatch einsum); the port's
    keeps it to its own row and takes its capacity as the reference routes
    it (experts 0 and 1);
(c) ``from_jax_params`` keeps the router f32 under bf16 params, and the
    port's init builds the reference's parameter tree;
(d) greedy ``serve()`` of tiny arctic-480b (scatter dispatch, dense
    residual) equal to ``JAXEngine``'s on split, fused and dense, at
    capacity factors 8.0 (no drops) and 1.25, pipelined equal to sync;
    the one-hot impl equal to ``JAXEngine(use_pallas=True)``'s and to the
    scatter serve; tiny llava-next-mistral-7b (its text backbone) equal to
    the JAX serve; mixtral-8x7b refused at the same assertion by both
    engines; ``--arch arctic-480b --device cpu`` served by the CLI.

Tolerances: f32 within 1e-6 of the output's scale (the two packages' GEMMs
sum in other orders); bf16 within tests/test_engine.py's atol 0.25 / rtol
0.05 on the outputs over their RMS, since those tolerances are for values
of order one and the experts' outputs are about 60 here (the reference's
expert init takes the fan-in from the expert axis).
"""
import dataclasses

import jax
import jax.numpy as jnp
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
from repro.models import layers as JL
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import tiny_config
from repro_torch.core.scheduler import ChunkedPrefillScheduler, SchedulerConfig
from repro_torch.engine.engine import EngineConfig, TorchEngine, serve
from repro_torch.engine.workload import (
    WorkloadSpec, attach_prompt_tokens, sharegpt_like,
)
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.models.model import build_model
from repro_torch.weights import from_jax_params

# every request arrives at once: at capacity factor 1.25 a round's lanes
# decide which tokens are dropped, so the rounds must not depend on timing
WORKLOAD = dict(n_requests=6, inter_arrival_s=0.0, max_context=100,
                max_new_tokens=8, seed=7)
ENGINE = dict(n_slots=8, max_context=256)
SCHED = dict(policy="aging", token_budget=48, max_seqs=8)
LAYOUTS = {"split": dict(kv_layout="split"),
           "fused": dict(kv_layout="fused"),
           "dense": dict(paged_kv=False)}
IMPLS = {"scatter": (JL.moe_ffn_scatter, L.moe_ffn_scatter),
         "onehot": (JL.moe_ffn, L.moe_ffn)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32", **moe):
    """The tiny config of ``arch`` in both packages, the MoE fields in
    ``moe`` (``impl``, ``capacity_factor``) replaced."""
    out = []
    for cfg in (jax_tiny_config(arch), tiny_config(arch)):
        cfg = cfg.with_(param_dtype=dtype)
        if "impl" in moe:
            cfg = cfg.with_(moe_impl=moe["impl"])
        if "capacity_factor" in moe:
            cfg = cfg.with_(moe=dataclasses.replace(
                cfg.moe, capacity_factor=moe["capacity_factor"]))
        out.append(cfg)
    return out


def _moe_params(jcfg, tcfg):
    """One layer's MoE params from the reference's init: (JAX, port)."""
    jp = jax.jit(JL.init_moe, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    stacked = {"moe": {k: v[None] for k, v in np_p.items()}}
    tp = from_jax_params({"embed": np.zeros((1, 1), np.float32),
                          "final_norm": np.zeros((1,), np.float32),
                          "layers": stacked},
                         tcfg.with_(n_layers=1), device="cpu")
    return jp, tp["layers"][0]["moe"]


def _jax_init(jcfg):
    return jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))


def _inputs(rng, B, S, D, nan=True):
    """Normal rows (what the FFN norm hands the experts) with repeated rows
    (the same token routes alike, so experts overflow), zero rows (the
    router's logits all equal: an exact tie over every expert) and, with
    ``nan``, all-NaN rows."""
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    flat = x.reshape(-1, D)
    flat[::3] = flat[0]
    flat[1::7] = 0.0
    if nan:
        flat[2::11] = np.nan
    return x


def _run(impl, jcfg, tcfg, jp, tp, x, group_size):
    jfn, tfn = IMPLS[impl]
    jx = jnp.asarray(x, dtype=jnp.dtype(jcfg.param_dtype))
    want = np.asarray(jax.jit(jfn, static_argnums=(2, 3))(
        jp, jx, jcfg, group_size), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, tcfg.param_dtype))
    got = tfn(tp, tx, tcfg, group_size=group_size).float().numpy()
    return got, want


def _close(got, want, dtype):
    """NaN exactly where the reference has NaN; elsewhere within the
    dtype's tolerance (module docstring)."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    g, w = got[fin], want[fin]
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())
    else:
        rms = np.sqrt(np.mean(w.astype(np.float64) ** 2))
        np.testing.assert_allclose(g / rms, w / rms, atol=0.25, rtol=0.05)


# (B, S, group_size): one group; four groups of 8; T = 20 with groups of 12,
# which the gcd fallback turns into five groups of 4; 128 lanes in one group
SHAPES = {"one-group": (4, 8, 0), "groups": (4, 8, 8), "gcd": (5, 4, 12),
          "wide": (8, 16, 0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_moe_layer_matches_jax(impl, shape, cf, dtype):
    """NaN rows go to the scatter impl only: the reference's one-hot turns
    every row NaN on them (test_onehot_nan_row_poisons_only_itself)."""
    jcfg, tcfg = _cfgs("arctic-480b", dtype, capacity_factor=cf)
    jp, tp = _moe_params(jcfg, tcfg)
    B, S, gs = SHAPES[shape]
    x = _inputs(np.random.default_rng(0), B, S, jcfg.d_model,
                nan=impl == "scatter")
    got, want = _run(impl, jcfg, tcfg, jp, tp, x, gs)
    _close(got, want, dtype)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_capacity_drops_bite_at_1_25(impl):
    """The 1.25 cases above drop tokens (their outputs differ from the
    drop-free 8.0's), and the two impls drop different ones."""
    jcfg, tcfg = _cfgs("arctic-480b")
    _, tp = _moe_params(jcfg, tcfg)
    x = torch.from_numpy(_inputs(np.random.default_rng(0), 8, 16, 64,
                                 nan=False))
    outs = {}
    for cf in (8.0, 1.25):
        cfg = _cfgs("arctic-480b", capacity_factor=cf)[1]
        for name in IMPLS:
            outs[cf, name] = IMPLS[name][1](tp, x, cfg)
    torch.testing.assert_close(outs[8.0, impl], outs[8.0, "scatter"])
    assert not torch.equal(outs[1.25, impl], outs[8.0, impl])
    assert not torch.equal(outs[1.25, "onehot"], outs[1.25, "scatter"])


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_onehot_nan_row_poisons_only_itself(cf):
    """A NaN row routes to experts 0 and 1 (``jax.lax.top_k``: NaN first,
    then the lowest index) and takes its slots there.  ``repro``'s one-hot
    ``moe_ffn`` turns EVERY output NaN (the 0/1 dispatch einsum multiplies
    each row by 0 or 1, and 0 * NaN is NaN); the port's is NaN in that row
    only and, elsewhere, equals the reference on an input whose NaN row is
    a finite row routed to experts 0 then 1."""
    jcfg, tcfg = _cfgs("arctic-480b", capacity_factor=cf)
    jp, tp = _moe_params(jcfg, tcfg)
    rng = np.random.default_rng(3)
    x = _inputs(rng, 4, 8, jcfg.d_model, nan=False)
    r = 5
    x_nan = x.copy()
    x_nan[0, r] = np.nan
    moe_ffn = jax.jit(JL.moe_ffn, static_argnums=2)
    ref_nan = np.asarray(moe_ffn(jp, jnp.asarray(x_nan), jcfg))
    assert np.isnan(ref_nan).all()
    # a finite row that the reference routes to experts 0 then 1
    while True:
        cand = rng.standard_normal(jcfg.d_model).astype(np.float32)
        probs = jax.nn.softmax(jnp.asarray(cand) @ jp["router"])
        if jax.lax.top_k(probs, 2)[1].tolist() == [0, 1]:
            break
    x_fin = x.copy()
    x_fin[0, r] = cand
    want = np.asarray(moe_ffn(jp, jnp.asarray(x_fin), jcfg))
    got = L.moe_ffn(tp, torch.from_numpy(x_nan), tcfg).numpy()
    assert np.isnan(got[0, r]).all()
    keep = np.ones(got.shape[:2], bool)
    keep[0, r] = False
    _close(got[keep], want[keep], "float32")


def test_top_k_order_is_jax_top_k():
    """Ties take the lowest index first and NaN sorts above every number,
    as ``jax.lax.top_k`` orders them (``torch.topk`` takes other indices
    of a tie): router logits of an all-NaN row, a row of four equal values
    and a row whose two largest are equal."""
    logits = np.log(np.array([[np.nan] * 4, [0.25] * 4,
                              [0.3, 0.1, 0.3, 0.2]], np.float32))
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    want_w, want = jax.lax.top_k(probs, 2)
    p = {"router": torch.eye(4)}
    w, idx = L.moe_route(p, torch.from_numpy(logits)[None], 2)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(want))
    assert idx[0].tolist() == [[0, 1], [0, 1], [0, 2]]
    assert torch.isnan(w[0, 0]).all() and (w[0, 1:] == 0.5).all()


def test_from_jax_params_keeps_the_router_f32_under_bf16():
    """bf16 params: every leaf bf16 but the router, which stays f32 (the
    reference's ``init_moe``) and routes as the reference does."""
    jcfg, tcfg = _cfgs("arctic-480b", "bfloat16")
    jparams = _jax_init(jcfg)
    assert jparams["layers"]["moe"]["router"].dtype == jnp.float32
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    for lp in tparams["layers"]:
        assert lp["moe"]["router"].dtype == torch.float32
        for name in ("w_gate", "w_up", "w_down"):
            assert lp["moe"][name].dtype == torch.bfloat16
            assert lp["ffn"][name].dtype == torch.bfloat16
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, jcfg.d_model)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    router = jparams["layers"]["moe"]["router"][0]
    probs = jax.nn.softmax(xb.astype(jnp.float32) @ router, axis=-1)
    want = np.asarray(jax.lax.top_k(probs, 2)[1])
    tx = torch.from_numpy(x).to(torch.bfloat16)[None]
    _, idx = L.moe_route(tparams["layers"][0]["moe"], tx, 2)
    np.testing.assert_array_equal(idx[0].numpy(), want)


@pytest.mark.parametrize("arch", ["arctic-480b", "llava-next-mistral-7b"])
def test_init_builds_the_reference_tree(arch):
    """The port's seeded init has the reference's leaves, shapes and dtypes
    per layer (bf16, the router f32), and the experts its scale."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    params = build_model(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    want = jax.tree_util.tree_leaves_with_path(shapes["layers"])
    for lp in params["layers"]:
        got = {}

        def walk(t, path=()):
            for k, v in t.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    got[path + (k,)] = v

        walk(lp)
        assert len(got) == len(want)
        for path, leaf in want:
            t = got[tuple(k.key for k in path)]
            assert tuple(t.shape) == leaf.shape[1:]
            assert str(t.dtype).split(".")[-1] == leaf.dtype.name
    if tcfg.moe is not None:
        w = params["layers"][0]["moe"]["w_gate"].float()
        assert abs(w.std().item() * np.sqrt(tcfg.moe.n_experts) - 1) < 0.05


@pytest.fixture(scope="module")
def arctic():
    """Tiny f32 arctic JAX params, and the same weights in the port."""
    jcfg, tcfg = _cfgs("arctic-480b")
    jparams = _jax_init(jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, from_jax_params(np_params, tcfg, device="cpu")


def _jax_serve(jcfg, jparams, layout, use_pallas=False):
    eng = JAXEngine(jcfg, JaxEngineConfig(pipelined=False,
                                          use_pallas=use_pallas,
                                          **LAYOUTS[layout], **ENGINE),
                    params=jparams)
    reqs = jax_sharegpt_like(JaxWorkloadSpec(**WORKLOAD))
    jax_attach(reqs, jcfg.vocab_size)
    res = jax_serve(reqs, JaxScheduler(JaxSchedulerConfig(**SCHED)), eng)
    assert res.report.n_finished == len(reqs)
    return [res.outputs[r.req_id] for r in reqs]


def _torch_serve(tcfg, tparams, layout, pipelined=True):
    eng = TorchEngine(tcfg, EngineConfig(pipelined=pipelined,
                                         **LAYOUTS[layout], **ENGINE),
                      params=tparams, device="cpu")
    reqs = sharegpt_like(WorkloadSpec(**WORKLOAD))
    attach_prompt_tokens(reqs, tcfg.vocab_size)
    res = serve(reqs, ChunkedPrefillScheduler(SchedulerConfig(**SCHED)), eng)
    assert res.report.n_finished == len(reqs)
    return [res.outputs[r.req_id] for r in reqs]


@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_arctic_serve_matches_jax_engine(arctic, layout, cf):
    jparams, tparams = arctic
    jcfg, tcfg = _cfgs("arctic-480b", impl="scatter", capacity_factor=cf)
    want = _jax_serve(jcfg, jparams, layout)
    assert _torch_serve(tcfg, tparams, layout) == want
    assert _torch_serve(tcfg, tparams, layout, pipelined=False) == want


def test_capacity_changes_the_served_tokens(arctic):
    """At 1.25 the serve drops real tokens: its outputs are not 8.0's."""
    _, tparams = arctic
    outs = [_torch_serve(_cfgs("arctic-480b", capacity_factor=cf)[1],
                         tparams, "split") for cf in (8.0, 1.25)]
    assert outs[0] != outs[1]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_onehot_serve_matches_jax_pallas_engine(arctic, layout):
    """The one-hot impl against ``JAXEngine(use_pallas=True)``, whose
    kernels store 0 for an idle lane (its ``jnp`` path serves token 0
    throughout: test_onehot_nan_row_poisons_only_itself), and against the
    scatter serve (no drops at 8.0: both impls compute the same)."""
    jparams, tparams = arctic
    jcfg, tcfg = _cfgs("arctic-480b", impl="onehot")
    got = _torch_serve(tcfg, tparams, layout)
    assert got == _jax_serve(jcfg, jparams, layout, use_pallas=True)
    assert got == _torch_serve(_cfgs("arctic-480b", impl="scatter")[1],
                               tparams, layout)


@pytest.fixture(scope="module")
def llava():
    jcfg, tcfg = _cfgs("llava-next-mistral-7b")
    jparams = _jax_init(jcfg)
    return jparams, from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                    tcfg, device="cpu")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_llava_serve_matches_jax_engine(llava, layout):
    jparams, tparams = llava
    jcfg, tcfg = _cfgs("llava-next-mistral-7b")
    assert (_torch_serve(tcfg, tparams, layout)
            == _jax_serve(jcfg, jparams, layout))


def test_mixtral_fails_at_the_sliding_window_assertion_in_both():
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    with pytest.raises(AssertionError, match="linear caches"):
        _jax_serve(jcfg, _jax_init(jcfg),
                   "split")
    with pytest.raises(AssertionError, match="linear caches"):
        _torch_serve(tcfg, None, "split")


@pytest.mark.parametrize("family", ["hybrid", "ssm", "encdec"])
def test_unported_families_still_raise(family):
    """A family the port has no model for still raises, from each of the
    three configs ``Model`` refused until item 14 (which now build:
    ``test_every_family_builds``)."""
    arch = {"hybrid": "jamba-1.5-large-398b", "ssm": "xlstm-1.3b",
            "encdec": "whisper-large-v3"}[family]
    with pytest.raises(ValueError, match="unknown family"):
        build_model(tiny_config(arch).with_(family="rnn"))


@pytest.mark.parametrize("family", ["hybrid", "ssm", "encdec"])
def test_every_family_builds(family):
    """The three families ``Model`` refused until item 14 build their
    models (``repro_torch.models.{hybrid,xlstm,whisper}``)."""
    arch = {"hybrid": "jamba-1.5-large-398b", "ssm": "xlstm-1.3b",
            "encdec": "whisper-large-v3"}[family]
    impl = {"hybrid": "HybridLM", "ssm": "XLSTMLM",
            "encdec": "WhisperModel"}[family]
    assert type(build_model(tiny_config(arch)).impl).__name__ == impl


@pytest.mark.parametrize("arch", ["arctic-480b", "llava-next-mistral-7b"])
def test_serve_cli_serves_the_family_on_the_cpu(arch):
    res = serve_cli.main(["--arch", arch, "--device", "cpu",
                          "--n-requests", "4"])
    assert res.report.n_finished == res.report.n_total == 4


@pytest.mark.parametrize("arch", ["arctic-480b", "llava-next-mistral-7b"])
def test_engine_without_a_card_raises(monkeypatch, arch):
    """No silent CPU fallback for the new families either."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchEngine(tiny_config(arch))
