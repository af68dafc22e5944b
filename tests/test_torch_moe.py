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
from repro_torch.kernels import grouped_swiglu as GK
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
    """The reference's chunked round asserts full attention; the port's
    paged layouts now take the window (tests/test_torch_exaone.py holds
    them against the ring decode), and its dense layout refuses it."""
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    with pytest.raises(AssertionError, match="linear caches"):
        _jax_serve(jcfg, _jax_init(jcfg),
                   "split")
    assert len(_torch_serve(tcfg, None, "split")) == WORKLOAD["n_requests"]
    with pytest.raises(NotImplementedError, match="paged layouts take windows"):
        _torch_serve(tcfg, None, "dense")


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


# -- the engine round's MoE on routed rows only (L.moe_round) ------------------
GROUPED_SETTINGS = {
    # (capacity factor, n_experts or None, lane mask density): dropless with
    # a mask; capacity-bound, every lane; 64 = E / K over 128 experts
    "cf8-masked": (8.0, None, 0.5),
    "cf1.25-all": (1.25, None, 1.0),
    "e128-cf64": (64.0, 128, 0.5),
}


def _grouped_cfgs(setting, dtype="float32"):
    cf, n_experts, _ = GROUPED_SETTINGS[setting]
    out = []
    for cfg in _cfgs("arctic-480b", dtype, impl="scatter", capacity_factor=cf):
        if n_experts:
            cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                    n_experts=n_experts))
        out.append(cfg)
    return out


def _lane_mask(rng, B, S, density):
    mask = rng.random((B, S)) < density
    mask[0, 0] = True
    return mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("setting", sorted(GROUPED_SETTINGS))
def test_grouped_round_matches_jax_scatter(setting, dtype):
    """``moe_round`` (its plain path) against ``repro``'s
    ``moe_ffn_scatter``: dropless with a lane mask, the real lanes within
    the module's tolerance and the masked lanes with no expert row (zero
    output); at 1.25 every lane takes capacity, so every lane matches."""
    jcfg, tcfg = _grouped_cfgs(setting, dtype)
    jp, tp = _moe_params(jcfg, tcfg)
    rng = np.random.default_rng(4)
    B, S = 4, 8
    x = _inputs(rng, B, S, jcfg.d_model, nan=False)
    want = np.asarray(jax.jit(JL.moe_ffn_scatter, static_argnums=2)(
        jp, jnp.asarray(x, jnp.dtype(dtype)), jcfg), np.float32)
    mask = _lane_mask(rng, B, S, GROUPED_SETTINGS[setting][2])
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    counts = torch.zeros(3, dtype=torch.long)
    got = L.moe_round(tp, tx, tcfg, torch.from_numpy(mask),
                      counts).float().numpy()
    rows = int(counts[1])
    if GROUPED_SETTINGS[setting][0] >= tcfg.moe.n_experts / tcfg.moe.top_k:
        _close(got[mask], want[mask], dtype)
        assert (got[~mask] == 0).all()
        assert rows == mask.sum() * tcfg.moe.top_k
    else:
        _close(got, want, dtype)
        assert rows < B * S * tcfg.moe.top_k       # some choices dropped


def _capacity_walk(top_idx, E, C, order):
    """The reference's capacity walk, one (token, choice) at a time, per
    group: each pair's slot in its expert, -1 where the expert is full.
    ``token``: token-major over the flattened (token, choice) axis;
    ``choice``: choice 0 of every token first, the kept counts carried
    into choice 1 (``repro``'s one-hot dispatch)."""
    idx = top_idx.numpy()
    G, T, K = idx.shape
    slot = np.full(idx.shape, -1, np.int64)
    for g in range(G):
        n = np.zeros(E, np.int64)
        pairs = ([(t, j) for t in range(T) for j in range(K)]
                 if order == "token" else
                 [(t, j) for j in range(K) for t in range(T)])
        for t, j in pairs:
            e = idx[g, t, j]
            if n[e] < C:
                slot[g, t, j] = n[e]
                n[e] += 1
    return torch.from_numpy(slot)


@pytest.mark.parametrize("order", ["token", "choice"])
@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_expert_layout_against_capacity_rows(shape, cf, order):
    """The sort-based capacity rank keeps the reference's capacity walk's
    set at its slots, and ``capacity_rows`` puts each kept pair at its
    expert's slot; the layout sorts the kept rows by expert, stable in
    (token, choice) order, with counts, offsets and a tile table that cover
    each row once, tiles of one expert of at most ``bn`` rows, each naming
    its expert's first tile and tile count."""
    jcfg, tcfg = _cfgs("arctic-480b", capacity_factor=cf)
    _, tp = _moe_params(jcfg, tcfg)
    B, S, gs = SHAPES[shape]
    x = torch.from_numpy(_inputs(np.random.default_rng(5), B, S,
                                 tcfg.d_model))
    m = tcfg.moe
    xg = L.moe_groups(x, gs)
    G, t, _ = xg.shape
    _, top_idx = L.moe_route(tp, xg, m.top_k)
    C = L.moe_capacity(t, m.n_experts, m.top_k, cf)
    rank = L.capacity_rank(top_idx, order)
    want = _capacity_walk(top_idx, m.n_experts, C, order)
    kept = rank < C
    assert torch.equal(kept, want >= 0)
    assert torch.equal(rank[kept], want[kept])
    dest = L.capacity_rows(top_idx, m.n_experts, C, order)
    g = torch.arange(G).view(G, 1, 1)
    assert torch.equal(dest, torch.where(
        kept, top_idx * (G * C) + g * C + want, m.n_experts * G * C))
    for bn in (2, 16):
        lay = GK.expert_layout(top_idx.reshape(G * t, m.top_k),
                               kept.reshape(G * t, m.top_k), m.n_experts, bn)
        flat_e = top_idx.reshape(-1)[kept.reshape(-1)]
        assert torch.equal(lay.counts, torch.bincount(flat_e,
                                                      minlength=m.n_experts))
        n = int(lay.counts.sum())
        row = lay.row.reshape(-1)[kept.reshape(-1)]
        assert sorted(row.tolist()) == list(range(n))
        # sorted by expert, and within an expert in (token, choice) order
        order_of = torch.empty(n, dtype=torch.long)
        order_of[row] = torch.arange(n)
        e_of_row = flat_e[order_of]
        assert bool((e_of_row[1:] >= e_of_row[:-1]).all())
        same = e_of_row[1:] == e_of_row[:-1]
        assert bool((order_of[1:][same] > order_of[:-1][same]).all())
        tok = torch.arange(G * t).repeat_interleave(m.top_k)[kept.reshape(-1)]
        assert torch.equal(lay.tok[row].long(), tok)
        tiles, n_tiles = lay.tiles.long(), int(lay.n_tiles)
        assert n_tiles == int(((lay.counts + bn - 1) // bn).sum())
        assert (tiles[n_tiles:, 2] == 0).all() and (tiles[:n_tiles, 2] > 0).all()
        assert tiles.shape[0] == GK.max_tiles(G * t * m.top_k, m.n_experts, bn)
        cover = torch.zeros(n, dtype=torch.long)
        for j, (e, r0, k, first, per) in enumerate(tiles[:n_tiles].tolist()):
            assert k <= bn and (e_of_row[r0:r0 + k] == e).all()
            cover[r0:r0 + k] += 1
            assert (tiles[first:first + per, 0] == e).all() and first <= j < first + per
            assert per == -(-int(lay.counts[e]) // bn)
        assert (cover == 1).all()
        assert (tiles[n_tiles:] == 0).all()


@pytest.mark.parametrize("bn", [16, GK.ROW_TILE])
def test_expert_with_no_rows_gets_no_tile(bn):
    """Experts no kept row reaches -- unrouted, or routed only from masked
    lanes -- hold no tile, and a round with every lane masked has none."""
    E, T, K = 8, 12, 2
    expert = torch.tensor([[1, 3]] * 6 + [[3, 6]] * 6)
    kept = torch.ones((T, K), dtype=torch.bool)
    kept[6:] = False                          # expert 6's only choices
    lay = GK.expert_layout(expert, kept, E, bn)
    live = lay.tiles[: int(lay.n_tiles)]
    assert sorted(live[:, 0].tolist()) == [1, 3]
    assert lay.counts.tolist() == [0, 6, 0, 6, 0, 0, 0, 0]
    none = GK.expert_layout(expert, torch.zeros_like(kept), E, bn)
    assert int(none.n_tiles) == 0 and (none.tiles[:, 2] == 0).all()


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_nan_idle_lane_reaches_no_real_lane(cf):
    """An idle lane holding NaN (the plain attention's softmax over no
    key): dropless it enters no expert and its expert output is 0; at 1.25
    it takes capacity as in the reference and is NaN in its own row only.
    Every real lane equals the output with that lane finite."""
    jcfg, tcfg = _cfgs("arctic-480b", capacity_factor=cf)
    _, tp = _moe_params(jcfg, tcfg)
    rng = np.random.default_rng(6)
    x = _inputs(rng, 4, 8, tcfg.d_model, nan=False)
    mask = np.ones((4, 8), bool)
    mask[1, 5:] = mask[3, 2:] = False
    x_nan = x.copy()
    x_nan[~mask] = np.nan
    lanes = torch.from_numpy(mask)
    got = L.moe_round(tp, torch.from_numpy(x_nan), tcfg, lanes).numpy()
    if cf == 8.0:
        # the masked lanes take no capacity: any finite values there agree
        want = L.moe_round(tp, torch.from_numpy(x), tcfg, lanes).numpy()
        assert (got[~mask] == 0).all()
        np.testing.assert_array_equal(got[mask], want[mask])
    else:
        want = L.moe_ffn_scatter(tp, torch.from_numpy(x_nan), tcfg).numpy()
        assert np.isnan(got[~mask]).all()
        assert np.isfinite(got[mask]).all()
        _close(got, want, "float32")


@pytest.mark.parametrize("layout", ["split", "fused"])
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_paged_round_with_idle_slots_matches_jax(arctic, layout, cf):
    """Three ``chunked_step_paged`` rounds of tiny arctic with idle slots
    (a mixed round, a pure-decode round, a wider mixed round) against
    ``repro``'s on the same weights: the logits of every slot with work
    within 1e-4, the MoE on the port's grouped path."""
    jparams, tparams = arctic
    jcfg, tcfg = _cfgs("arctic-480b", impl="scatter", capacity_factor=cf)
    schedule = [(16, (16, 0, 9, 0)), (1, (1, 0, 1, 0)), (32, (1, 0, 20, 7))]
    ps, max_pages, B = 8, 8, 4
    rng = np.random.default_rng(7)
    n_phys = B * max_pages + 3
    sink = n_phys - 1
    hd = jcfg.resolved_head_dim
    split = (jcfg.n_layers, n_phys, ps, jcfg.n_kv_heads, hd)
    if layout == "split":
        jpool = {n: jnp.zeros(split, jnp.float32) for n in ("k", "v")}
        tpool = {n: torch.zeros(split) for n in ("k", "v")}
    else:
        fused = split[:3] + (2 * jcfg.n_kv_heads, hd)
        jpool, tpool = {"kv": jnp.zeros(fused, jnp.float32)}, {
            "kv": torch.zeros(fused)}
    jstep = jax.jit(jax_build_model(jcfg).impl.chunked_step_paged,
                    static_argnames="kv_layout")
    timpl = build_model(tcfg).impl
    ids = rng.permutation(sink)[: B * max_pages].reshape(B, max_pages)
    lens = np.zeros(B, np.int32)
    for C, chunks in schedule:
        chunk_lens = np.asarray(chunks, np.int32)
        tokens = np.zeros((B, C), np.int32)
        for b, c in enumerate(chunks):
            tokens[b, :c] = rng.integers(1, jcfg.vocab_size, c)
        tables = np.full((B, max_pages), sink, np.int32)
        for b in range(B):
            n = -(-int(lens[b] + chunk_lens[b]) // ps)
            tables[b, :n] = ids[b, :n]
        want, jpool = jstep(jparams, jnp.asarray(tokens), jpool,
                            jnp.asarray(lens), jnp.asarray(chunk_lens),
                            jnp.asarray(tables), kv_layout=layout)
        got = timpl.chunked_step_paged(
            tparams, torch.from_numpy(tokens), tpool, torch.from_numpy(lens),
            torch.from_numpy(chunk_lens), torch.from_numpy(tables))
        live = chunk_lens > 0
        w = np.asarray(want, np.float32)[live]
        np.testing.assert_allclose(got.numpy()[live], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
        lens = lens + chunk_lens


@pytest.mark.parametrize("cf", [64.0, 1.25])
def test_moe_counter_on_a_known_routing(cf):
    """The counter adds (experts holding a row, rows) a call: a router
    whose logits are each row's first E features routes row ``i`` to
    experts (2i mod E, 2i + 1 mod E); dropless only the real lanes count,
    at capacity 1 each expert keeps its first choice."""
    E, K, D = 8, 2, 16
    cfg = tiny_config("arctic-480b").with_(d_model=D, moe=dataclasses.replace(
        tiny_config("arctic-480b").moe, n_experts=E, top_k=K,
        capacity_factor=cf))
    p = L.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32,
                   "cpu")
    p["router"] = torch.eye(D, E) * 50.0
    T = 6
    x = torch.zeros((1, T, D))
    for i in range(T):
        x[0, i, (2 * i) % E] = 2.0
        x[0, i, (2 * i + 1) % E] = 1.0
    lanes = torch.tensor([[True] * 4 + [False] * 2])
    counts = torch.zeros(3, dtype=torch.long)
    L.moe_round(p, x, cfg, lanes, counts)
    got = counts.tolist()
    if cf == 64.0:
        # lanes 0-3 reach experts 0-7 once each
        assert got == [8, 8, 0]
    else:
        # capacity ceil(6 * 2 / 8 * 1.25) = 2 < 6: every lane takes it;
        # lanes 4, 5 reach experts 0-3 again, each holding two rows
        assert L.moe_capacity(T, E, K, cf) == 2
        assert got == [8, 12, 0]


def test_whole_sequence_and_training_keep_the_batched_gemms(monkeypatch,
                                                             arctic):
    """Prefill (and so training's forward) runs the batched expert GEMMs,
    which have a gradient; an engine round runs the grouped path and never
    those GEMMs."""
    _, tparams = arctic
    _, tcfg = _cfgs("arctic-480b", impl="scatter")
    calls = []
    expert_ffn = L.expert_ffn
    monkeypatch.setattr(L, "expert_ffn",
                        lambda p, buf: calls.append(1) or expert_ffn(p, buf))
    impl = build_model(tcfg).impl
    tokens = torch.randint(1, tcfg.vocab_size, (2, 8))
    impl.train_hidden(tparams, {"tokens": tokens})
    assert len(calls) == tcfg.n_layers
    calls.clear()
    B, C, ps = 2, 4, 8
    shape = (tcfg.n_layers, 9, ps, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    pool = {n: torch.zeros(shape) for n in ("k", "v")}
    tables = torch.arange(8, dtype=torch.int32).view(B, 4)
    counts = torch.zeros(3, dtype=torch.long)
    impl.chunked_step_paged(tparams, tokens[:, :C], pool,
                            torch.zeros(B, dtype=torch.int32),
                            torch.tensor([C, 2], dtype=torch.int32), tables,
                            moe_counts=counts)
    assert not calls
    assert int(counts[1]) == (C + 2) * tcfg.moe.top_k * tcfg.n_layers


# (lanes, capacity factor) of tiny arctic (4 experts top-2): capacity 40 at
# 1.25, within GROUPED_MAX_CAPACITY (64); 160, above it; dropless at 8.0
ROUTE_SIDES = {"grouped-cf1.25": (64, 1.25), "batched-cf1.25": (256, 1.25),
               "grouped-dropless": (256, 8.0)}


@pytest.mark.parametrize("side", sorted(ROUTE_SIDES))
def test_round_takes_batched_gemms_only_above_the_capacity(monkeypatch, side):
    """A capacity-bound round whose experts may hold more than
    ``GROUPED_MAX_CAPACITY`` rows runs the reference's layer (the batched
    GEMMs over (E, C) buffers: equal to ``moe_ffn_scatter`` bit for bit,
    every expert and slot counted); at or below it, and dropless at any
    size, the grouped kernels (their plain versions here) and no batched
    GEMM, matching ``moe_ffn_scatter`` wherever a lane is real."""
    t, cf = ROUTE_SIDES[side]
    jcfg, tcfg = _cfgs("arctic-480b", impl="scatter", capacity_factor=cf)
    _, tp = _moe_params(jcfg, tcfg)
    m = tcfg.moe
    C = L.moe_capacity(t, m.n_experts, m.top_k, cf)
    batched = side.startswith("batched")
    assert (t > C > L.GROUPED_MAX_CAPACITY) == batched
    calls = {"expert_ffn": 0, "grouped": 0}
    expert_ffn, gate_up = L.expert_ffn, GK.grouped_gate_up

    def counted_ffn(p, buf):
        calls["expert_ffn"] += 1
        return expert_ffn(p, buf)

    def counted_gate_up(*args):
        calls["grouped"] += 1
        return gate_up(*args)

    monkeypatch.setattr(L, "expert_ffn", counted_ffn)
    monkeypatch.setattr(GK, "grouped_gate_up", counted_gate_up)
    x = torch.from_numpy(_inputs(np.random.default_rng(8), 4, t // 4,
                                 tcfg.d_model, nan=False))
    counts = torch.zeros(3, dtype=torch.long)
    got = L.moe_round(tp, x, tcfg, torch.ones((4, t // 4), dtype=torch.bool),
                      counts)
    assert calls == {"expert_ffn": int(batched), "grouped": int(not batched)}
    calls["expert_ffn"] = 0
    want = L.moe_ffn_scatter(tp, x, tcfg)
    if batched:
        assert torch.equal(got, want)
        assert counts.tolist() == [m.n_experts, m.n_experts * C, 0]
    else:
        _close(got.numpy(), want.numpy(), "float32")
        assert int(counts[1]) <= t * m.top_k


def test_meta_round_is_the_reference_layer(monkeypatch):
    """On the meta device (the dry-run's count of the reference's lowering)
    the round's MoE is the reference's layer over every lane: the batched
    expert GEMMs, no grouped kernel, the counter untouched."""
    _, tcfg = _cfgs("arctic-480b", impl="scatter")
    p = L.init_moe(None, tcfg, torch.float32, "meta")
    calls = []
    expert_ffn = L.expert_ffn
    monkeypatch.setattr(L, "expert_ffn",
                        lambda p, buf: calls.append(buf.shape) or expert_ffn(p, buf))
    x = torch.empty((4, 8, tcfg.d_model), device="meta")
    lanes = torch.ones((4, 8), dtype=torch.bool, device="meta")
    out = L.moe_round(p, x, tcfg, lanes)
    assert out.shape == x.shape and out.device.type == "meta"
    assert calls == [torch.Size([tcfg.moe.n_experts, L.moe_capacity(
        32, tcfg.moe.n_experts, tcfg.moe.top_k, tcfg.moe.capacity_factor),
        tcfg.d_model])]
