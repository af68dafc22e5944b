"""The port's training stack (``repro_torch.models.model.chunked_cross_entropy``
and ``Model.loss``, ``repro_torch.training``, ``repro_torch.distributed.
checkpoint``, ``repro_torch.launch.train`` and
``examples/torch_train_tiny.py``) on the CPU against the JAX package.

(a) ``chunked_cross_entropy`` with and without a mask, both unembedding
    layouts, at S = 600 (chunks of 300: 512 does not divide it): f32 within
    1e-6; bf16 (the logits rounded to bf16 before f32, as JAX's einsum)
    within 1e-3.  ``loss_and_grad`` on converted f32 weights for tiny qwen
    (QKV bias, tied embeddings) and tiny arctic (MoE + dense residual), one
    and two microbatches: the loss within 1e-5, every grad leaf
    max-normalised within 1e-4.
(b) ``adamw_update`` fed the SAME numpy grads as the reference's (f32 and
    bf16 moments, clipping on and off, weight decay, the warmup-cosine
    schedule) over 3 steps: params and f32 moments within 1e-6, bf16
    moments equal; ``_schedule`` at steps 0, 9 and 100; ``SyntheticLM.
    batch_at`` bitwise.
(c) Mirrors of every case of tests/test_training.py (the restart test
    included, with its ``rtol=2e-2``: it fails in ``repro`` only at jax
    0.9's mesh, and the port has none), a resume under the same ``steps``
    with the last checkpoint deleted (bitwise), and the example.
(d) Checkpoints: mirrors of tests/test_distributed.py's roundtrip, async +
    gc and NamedTuple cases; checkpoints written by either package restore
    bitwise in the other; an async save followed by an in-place update
    writes the values held at ``save()``; restore onto the template's dtype
    and device.
"""
import os
import shutil
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as jax_tiny_config
from repro.distributed.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.models.model import build_model as jax_build_model
from repro.models.model import chunked_cross_entropy as jax_xent
from repro.training import optimizer as jopt
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import SyntheticLM as JaxSyntheticLM
from repro.training.train_step import TrainConfig as JaxTrainConfig
from repro.training.train_step import loss_and_grad as jax_loss_and_grad
from repro_torch.configs import tiny_config
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.launch.train import train
from repro_torch.models.model import build_model, chunked_cross_entropy
from repro_torch.training import optimizer as topt
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import (
    AdamWConfig, _schedule, adamw_init, adamw_update,
)
from repro_torch.training.train_step import (
    TrainConfig, init_train_state, loss_and_grad, make_train_step,
)
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_jax_params

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and several test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _stacked(tree):
    """The port's tree in the reference's layout (per-layer lists stacked),
    f32 numpy leaves."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    if isinstance(tree, list):
        kids = [_stacked(v) for v in tree]
        return jax.tree_util.tree_map(lambda *a: np.stack(a), *kids)
    return _np(tree)


# ---------------------------------------------------------------------------
# (a) the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["dv", "vd"])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_cross_entropy_matches_jax(masked, kind, dtype):
    rng = np.random.default_rng(11)
    B, S, D, V = 2, 600, 16, 50
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((D, V) if kind == "dv" else (V, D)).astype(
        np.float32)
    y = rng.integers(0, V, (B, S)).astype(np.int32)
    m = (rng.random((B, S)) > 0.3).astype(np.float32) if masked else None
    jdt = jnp.dtype(dtype)
    want = jax_xent(jnp.asarray(h).astype(jdt), jnp.asarray(w).astype(jdt),
                    kind, jnp.asarray(y), None if m is None else jnp.asarray(m))
    tdt = getattr(torch, dtype)
    got = chunked_cross_entropy(
        torch.from_numpy(h).to(tdt), torch.from_numpy(w).to(tdt), kind,
        torch.from_numpy(y), None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == ()
    tol = 1e-6 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(got.item(), float(want), rtol=tol, atol=tol)


def test_chunked_cross_entropy_chunks_and_checkpoints(monkeypatch):
    """c = min(512, S) decreased until it divides S (S = 600: two chunks of
    300); under grad each chunk runs through ``torch.utils.checkpoint``;
    an all-zero mask gives 0, not NaN."""
    import repro_torch.models.model as model_mod
    calls = []
    real = model_mod.checkpoint

    def spy(fn, *args, **kw):
        calls.append(args[0].shape[1])
        assert kw == {"use_reentrant": False}
        return real(fn, *args, **kw)

    monkeypatch.setattr(model_mod, "checkpoint", spy)
    h = torch.randn(2, 600, 8, requires_grad=True)
    w = torch.randn(8, 20)
    y = torch.randint(0, 20, (2, 600))
    chunked_cross_entropy(h, w, "dv", y).backward()
    assert calls == [300, 300] and torch.isfinite(h.grad).all()
    with torch.no_grad():
        zero = chunked_cross_entropy(h, w, "dv", y, torch.zeros(2, 600))
    assert calls == [300, 300] and zero.item() == 0.0


def _converted(arch):
    jcfg = jax_tiny_config(arch).with_(param_dtype="float32")
    tcfg = tiny_config(arch).with_(param_dtype="float32")
    jmodel = jax_build_model(jcfg)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    return (jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params), tcfg,
            build_model(tcfg), from_jax_params(params, tcfg, device="cpu"))


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "arctic-480b"])
def test_loss_and_grad_matches_jax(arch, n_micro):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = _converted(arch)
    batch = JaxSyntheticLM(JaxDataConfig(jcfg.vocab_size, 4, 32)).batch_at(0)
    jloss, jmetrics, jgrads = jax_loss_and_grad(
        jmodel, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        JaxTrainConfig(n_microbatches=n_micro))
    tloss, tmetrics, tgrads = loss_and_grad(
        tmodel, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
        TrainConfig(n_microbatches=n_micro))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert tmetrics["loss"].item() == tloss.item()
    flat_w, tree_w = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, jgrads))
    flat_g, tree_g = jax.tree_util.tree_flatten(_stacked(tgrads))
    assert tree_g == tree_w
    for g, w in zip(flat_g, flat_w):
        assert np.abs(g - w).max() / (np.abs(w).max() + 1e-12) < 1e-4
    assert all(g.dtype == torch.float32 for g in tree_leaves(tgrads))


# ---------------------------------------------------------------------------
# (b) AdamW on identical grads, the schedule, the data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_jax_on_the_same_grads(moments, clip):
    """Three steps with the same numpy grads fed to both packages (Adam's
    first step is sign(g) times lr, so grads from two autodiffs could move
    a param by 2 lr where a tiny grad's sign differs): f32 and bf16
    params, weight decay, warmup 2 of 10 steps."""
    rng = np.random.default_rng(12)
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip_norm=clip,
               warmup_steps=2, total_steps=10)
    p0 = {"w": rng.standard_normal((8, 16)).astype(np.float32),
          "b": rng.standard_normal((16,)).astype(np.float32),
          "layers": [{"n": rng.standard_normal((4,)).astype(np.float32)}]}
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jp["b"] = jp["b"].astype(jnp.bfloat16)
    tp = {"w": torch.from_numpy(p0["w"].copy()),
          "b": torch.from_numpy(p0["b"].copy()).bfloat16(),
          "layers": [{"n": torch.from_numpy(p0["layers"][0]["n"].copy())}]}
    jstate = jopt.adamw_init(jp, moment_dtype=jnp.dtype(moments))
    tstate = adamw_init(tp, moment_dtype=getattr(torch, moments))
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * 3).astype(np.float32), p0)
        jp, jstate, jm = jopt.adamw_update(
            jopt.AdamWConfig(**cfg), jax.tree_util.tree_map(jnp.asarray, g),
            jstate, jp)
        tp, tstate, tm = adamw_update(
            AdamWConfig(**cfg), jax.tree_util.tree_map(torch.from_numpy, g),
            tstate, tp)
        assert int(tstate.step) == int(jstate.step) == step + 1
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=1e-6)
        for name, t, j in (("params", tp, jp), ("mu", tstate.mu, jstate.mu),
                           ("nu", tstate.nu, jstate.nu)):
            for key in ("w", "b"):
                a, w = t[key], j[key]
                assert str(a.dtype)[6:] == w.dtype.name, (name, key)
                if name != "params" and moments == "bfloat16":
                    np.testing.assert_array_equal(_np(a), _np(w))
                else:
                    np.testing.assert_allclose(_np(a), _np(w), rtol=1e-6,
                                               atol=1e-6, err_msg=name)
            np.testing.assert_allclose(_np(t["layers"][0]["n"]),
                                       _np(j["layers"][0]["n"]), rtol=1e-6,
                                       atol=1e-6)


def test_adamw_update_writes_params_and_moments_in_place():
    """The update writes into the given params and moments (the reference's
    jitted step donates their buffers) and returns those tensors; the step
    counter is a new tensor."""
    p = {"w": torch.ones(4)}
    s = adamw_init(p)
    g = {"w": torch.full((4,), 0.5)}
    new, s1, _ = adamw_update(AdamWConfig(lr=0.1), g, s, p)
    assert new["w"] is p["w"]
    assert s1.mu["w"] is s.mu["w"] and s1.nu["w"] is s.nu["w"]
    assert int(s.step) == 0 and int(s1.step) == 1
    # Adam's first step moves a param by lr * sign(g)
    torch.testing.assert_close(p["w"], torch.full((4,), 0.9))
    torch.testing.assert_close(s.mu["w"], torch.full((4,), 0.05))


def test_schedule_matches_jax():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=1, total_steps=8),
               dict(lr=0.5, warmup_steps=4), dict(lr=0.5, total_steps=20)):
        for step in (0, 1, 9, 50, 100, 120):
            got = _schedule(AdamWConfig(**kw), step)
            want = jopt._schedule(jopt.AdamWConfig(**kw), jnp.float32(step))
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                                       atol=1e-9)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_lm_batch_at_is_bitwise_the_reference(seed):
    t = SyntheticLM(DataConfig(vocab_size=1000, global_batch=3, seq_len=17,
                               seed=seed))
    j = JaxSyntheticLM(JaxDataConfig(vocab_size=1000, global_batch=3,
                                     seq_len=17, seed=seed))
    for step in (0, 1, 17, 1 << 19):
        a, b = t.batch_at(step), j.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# (c) mirrors of tests/test_training.py
# ---------------------------------------------------------------------------

def _setup(arch="qwen1.5-0.5b", n_micro=1, moment_dtype="float32"):
    cfg = tiny_config(arch)
    model = build_model(cfg)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=1e-3, weight_decay=0.01, grad_clip_norm=1.0),
        n_microbatches=n_micro, moment_dtype=moment_dtype,
    )
    params, opt = init_train_state(model, torch.Generator().manual_seed(0),
                                   tcfg, device="cpu")
    data = SyntheticLM(DataConfig(cfg.vocab_size, global_batch=4, seq_len=32))
    return model, tcfg, params, opt, data


def _tbatch(d, step):
    return {k: torch.from_numpy(v) for k, v in d.batch_at(step).items()}


def test_loss_decreases_over_steps():
    model, tcfg, params, opt, data = _setup()
    step = make_train_step(model, tcfg)
    losses = []
    for i in range(12):
        params, opt, m = step(params, opt, _tbatch(data, i))
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_grad_accum_matches_single_batch():
    """n_microbatches=4 must give (numerically close) grads to n=1."""
    model, tcfg1, params, _, data = _setup(n_micro=1)
    tcfg4 = TrainConfig(optimizer=tcfg1.optimizer, n_microbatches=4)
    batch = _tbatch(data, 0)
    _, _, g1 = loss_and_grad(model, params, batch, tcfg1)
    _, _, g4 = loss_and_grad(model, params, batch, tcfg4)
    for a, b in zip(tree_leaves(g1), tree_leaves(g4)):
        na, nb = _np(a), _np(b)
        assert np.abs(na - nb).max() / (np.abs(na).max() + 1e-6) < 0.05


def test_bf16_moments_update_params():
    model, tcfg, params, opt, data = _setup(moment_dtype="bfloat16")
    assert all(m.dtype == torch.bfloat16 for m in tree_leaves(opt.mu))
    before = [p.clone() for p in tree_leaves(params)]
    p2, o2, m = make_train_step(model, tcfg)(params, opt, _tbatch(data, 0))
    # params moved, moments stayed bf16
    assert all(mm.dtype == torch.bfloat16 for mm in tree_leaves(o2.mu))
    assert any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(p2)))


def test_grad_clip_bounds_update():
    cfg = AdamWConfig(lr=1.0, grad_clip_norm=1e-3)
    params = {"w": torch.ones(4)}
    opt = adamw_init(params)
    grads = {"w": torch.full((4,), 1e6)}
    _, _, metrics = adamw_update(cfg, grads, opt, params)
    assert metrics["grad_norm"].item() == pytest.approx(2e6, rel=1e-3)


def test_warmup_cosine_schedule():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert _schedule(cfg, torch.tensor(0.0)).item() == pytest.approx(0.1)
    assert _schedule(cfg, torch.tensor(9.0)).item() == pytest.approx(1.0)
    assert _schedule(cfg, torch.tensor(100.0)).item() < 1e-6 + 1e-3


def test_data_pipeline_deterministic_resume():
    d = SyntheticLM(DataConfig(vocab_size=1000, global_batch=2, seq_len=16,
                               seed=3))
    a = d.batch_at(17)
    b = d.batch_at(17)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = next(d.iterate(start_step=17))
    np.testing.assert_array_equal(a["tokens"], c["tokens"])
    full = d.batch_at(5)
    assert full["tokens"].shape == full["labels"].shape


def test_train_driver_checkpoint_restart(tmp_path):
    """launch/train.py end-to-end: a run killed at step 3 and resumed must
    reproduce the uninterrupted run's losses (deterministic data + state);
    the 3-step run's schedule decays over 3 steps, so the tail is close,
    not equal."""
    kw = dict(global_batch=2, seq_len=16, log_every=100, device="cpu")
    _, losses_full = train("qwen1.5-0.5b", steps=6, **kw)
    d = str(tmp_path / "ck")
    train("qwen1.5-0.5b", steps=3, ckpt_dir=d, ckpt_every=100, **kw)
    _, losses_tail = train("qwen1.5-0.5b", steps=6, ckpt_dir=d,
                           ckpt_every=100, resume=True, **kw)
    np.testing.assert_allclose(losses_full[3:], losses_tail, rtol=2e-2)


def test_resume_under_the_same_steps_is_bitwise(tmp_path, monkeypatch):
    """steps=6 with a checkpoint every 3; the step-6 checkpoint deleted, a
    resume restores the step-3 one (params, moments and step exactly what
    the save held) and runs steps 3-5 to the uninterrupted run's losses and
    params, bitwise (the CPU is deterministic)."""
    kw = dict(global_batch=2, seq_len=16, log_every=100, device="cpu")
    saved, restored = {}, {}
    real_save, real_restore = CheckpointManager.save, CheckpointManager.restore

    def save(self, step, state, **k):
        saved[step] = [t.clone() for t in tree_leaves(state)]
        return real_save(self, step, state, **k)

    def restore(self, template, *a, **k):
        step, state = real_restore(self, template, *a, **k)
        # copies: the resumed run then updates the state in place
        restored[step] = [t.clone() for t in tree_leaves(state)]
        return step, state

    monkeypatch.setattr(CheckpointManager, "save", save)
    monkeypatch.setattr(CheckpointManager, "restore", restore)
    d = tmp_path / "ck"
    full, losses_full = train("qwen1.5-0.5b", steps=6, ckpt_dir=str(d),
                              ckpt_every=3, **kw)
    shutil.rmtree(d / f"step_{6:010d}")
    again, losses_tail = train("qwen1.5-0.5b", steps=6, ckpt_dir=str(d),
                               ckpt_every=3, resume=True, **kw)
    assert list(restored) == [3]
    assert len(saved[3]) == len(restored[3])
    for a, b in zip(saved[3], restored[3]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert losses_tail == losses_full[3:]
    for a, b in zip(tree_leaves(full), tree_leaves(again)):
        assert torch.equal(a, b)


def test_train_tiny_example_runs_on_the_cpu(capsys):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_train_tiny
    finally:
        sys.path.remove(str(ROOT / "examples"))
    assert torch_train_tiny.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 60" in out and out.rstrip().endswith("ok")


def test_train_cli_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train("qwen1.5-0.5b", steps=1)


# ---------------------------------------------------------------------------
# (d) checkpoints
# ---------------------------------------------------------------------------

def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((8, 16), generator=g),
        "emb": torch.randn((32, 8), generator=g).bfloat16(),
        "nested": {"b": torch.arange(5, dtype=torch.int32)},
    }


def _equal(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    st = _state()
    mgr.save(7, st, blocking=True)
    step, back = mgr.restore(st)
    assert step == 7
    for a, b in zip(tree_leaves(st), tree_leaves(back)):
        assert _equal(a, b)


def test_checkpoint_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    st = _state()
    for s in (1, 2, 3, 4):
        mgr.save(s, st)
    mgr.wait()
    assert mgr.list_steps() == [3, 4]      # GC kept last 2
    step, _ = mgr.restore(st)
    assert step == 4
    mgr.close()


def test_checkpoint_namedtuple_state(tmp_path):
    params = {"w": torch.ones((4, 4))}
    opt = adamw_init(params)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, (params, opt), blocking=True)
    step, (p2, o2) = mgr.restore((params, opt))
    assert step == 3
    assert type(o2) is topt.AdamWState and int(o2.step) == 0
    assert o2.step.dtype == torch.int32
    assert torch.equal(p2["w"], torch.ones((4, 4)))


def _jax_state():
    k = jax.random.PRNGKey(5)
    params = {"w": jax.random.normal(k, (8, 16), jnp.float32),
              "emb": jax.random.normal(k, (32, 8), jnp.bfloat16),
              "nested": {"b": jnp.arange(5, dtype=jnp.int32)}}
    opt = jopt.adamw_init(params, moment_dtype=jnp.bfloat16)
    opt = opt._replace(step=jnp.int32(7), mu=jax.tree_util.tree_map(
        lambda a: (a + 0.5).astype(jnp.bfloat16), opt.mu))
    return params, opt


def _as_torch(tree):
    def leaf(a):
        a = np.array(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, jopt.AdamWState):
        return topt.AdamWState(*(_as_torch(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_as_torch(v) for v in tree)
    return leaf(tree)


def test_checkpoints_cross_packages_bitwise(tmp_path):
    """``repro``'s CheckpointManager writes (a dict of f32, bf16 and int32
    leaves, and an AdamWState with bf16 moments); the port restores it
    bitwise.  The port writes the same state; ``repro`` restores it
    bitwise, file for file the same layout."""
    jstate = _jax_state()
    tstate = _as_torch(jstate)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jm = JaxCheckpointManager(str(jdir), async_save=False)
    jm.save(7, jstate, blocking=True)
    step, back = CheckpointManager(str(jdir), async_save=False).restore(tstate)
    assert step == 7 and type(back[1]) is topt.AdamWState
    for a, b in zip(tree_leaves(tstate), tree_leaves(back)):
        assert _equal(a, b)

    tm = CheckpointManager(str(tdir), async_save=False)
    tm.save(7, tstate, blocking=True)
    step, jback = JaxCheckpointManager(str(tdir), async_save=False).restore(
        jstate)
    assert step == 7
    for a, b in zip(jax.tree_util.tree_leaves(jstate),
                    jax.tree_util.tree_leaves(jback)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                      np.asarray(b).reshape(-1).view(np.uint8))
    names = sorted(os.listdir(jdir / f"step_{7:010d}"))
    assert names == sorted(os.listdir(tdir / f"step_{7:010d}"))
    with open(jdir / f"step_{7:010d}" / "manifest.json") as f:
        jman = f.read()
    with open(tdir / f"step_{7:010d}" / "manifest.json") as f:
        assert f.read() == jman
    for n in names:
        if n.endswith(".npy"):
            a = np.load(jdir / f"step_{7:010d}" / n)
            b = np.load(tdir / f"step_{7:010d}" / n)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_async_save_snapshots_before_an_in_place_update(tmp_path,
                                                        monkeypatch):
    """The writer thread is held until the state has been updated in place
    (as the train driver's step does); the checkpoint holds the
    values of ``save()`` time."""
    gate = threading.Event()
    real_write = CheckpointManager._write

    def held(self, *a):
        assert gate.wait(timeout=30)
        return real_write(self, *a)

    monkeypatch.setattr(CheckpointManager, "_write", held)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    st = _state()
    want = [t.clone() for t in tree_leaves(st)]
    mgr.save(1, st)
    for t in tree_leaves(st):
        t.add_(1)
    gate.set()
    mgr.wait()
    mgr.close()
    _, back = mgr.restore(st)
    for a, b in zip(want, tree_leaves(back)):
        assert _equal(a, b)


def test_restore_follows_the_template_dtype_and_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(2, {"a": torch.arange(6.0).view(2, 3)}, blocking=True)
    _, back = mgr.restore({"a": torch.zeros(2, 3, dtype=torch.bfloat16)})
    assert back["a"].dtype == torch.bfloat16
    assert torch.equal(back["a"].float(), torch.arange(6.0).view(2, 3))
    _, back = mgr.restore({"a": torch.zeros(2, 3)}, device="meta")
    assert back["a"].device.type == "meta"
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty"),
                          async_save=False).restore({})


def test_training_modules_and_example_import_no_jax():
    """The training stack, the new families and the example run on the
    card machine, which has no JAX: importing them pulls in neither
    ``jax`` nor ``repro``, and the example's source imports neither."""
    import subprocess
    code = (
        "import sys\n"
        "import repro_torch.launch.train, repro_torch.distributed.checkpoint\n"
        "import repro_torch.models.hybrid, repro_torch.models.xlstm\n"
        "import repro_torch.models.whisper, repro_torch.training.train_step\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT / "src",
                         text=True, capture_output=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    for line in (ROOT / "examples" / "torch_train_tiny.py").read_text(
            ).splitlines():
        words = line.split()
        assert words[:2] not in (["import", "jax"], ["import", "repro"])
        assert not (words[:1] == ["from"] and len(words) > 1
                    and words[1].split(".")[0] in ("jax", "repro")), line
