"""The port's dry-run stack on the CPU: the op-level cost counter
(``repro_torch.launch.op_cost``), INT8 gradient compression
(``repro_torch.distributed.compression``), the dry-run driver
(``repro_torch.launch.dryrun``), the meta route of
``chunked_prefill_attention`` and ``CheckpointManager.restore``'s
``shardings``.

(a) The counter: a Python loop of 7 ``tanh(x @ w_i)`` counts exactly 7
    matmuls of 2 M K K flops (hlo_cost's scan case) plus the elementwise
    ones; views are free; a tiny model's train step counts the same on
    ``cpu`` and ``meta``; and the trip-scaled count of every loop that uses
    ``trip_range`` / ``trip_items`` (mamba's steps and chunks, mLSTM's
    chunks, sLSTM's steps, the microbatches, the layers and groups of every
    family) equals the unrolled count EXACTLY, flops and bytes op by op,
    forward and backward; outside a counter the helpers are ``range`` and
    ``enumerate``.
(b) Compression: fed ``repro``'s own noise draw, the quantizer returns
    ``repro``'s codes and scales bitwise; the reference's bars hold for the
    port's draws; ``compressed_psum`` on an in-process gloo group of one,
    and the counter charges its all-reduces by hlo_cost's convention.
(c) The dry-run: ``dry_run_cell`` is ok for a tiny config of each family
    and each shape kind; ``main`` at qwen1.5-0.5b's full width, decode_32k;
    ``CellResult``'s fields and ``model_flops_for`` equal ``repro``'s; the
    meta route of ``chunked_prefill_attention`` and a restore under
    ``NamedSharding``s over a mesh of one (a larger mesh raises).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.distributed.compression import quantize_int8 as jax_quantize_int8
from repro_torch.configs import (
    ASSIGNED_ARCHS, SHAPES_BY_NAME, applicable_shapes, get_config, tiny_config,
)
from repro_torch.configs.base import EncoderConfig
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.compression import (
    BLOCK, _quantize_with_noise, compressed_psum, compression_ratio,
    dequantize_int8, quantize_int8,
)
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.kernels import chunked_prefill_attention as cpa_mod
from repro_torch.kernels import native
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.op_cost import (
    OpCounter, bytes_breakdown, count, flop_breakdown, trip_fill, trip_items,
    trip_range,
)
from repro_torch.models import mamba, xlstm
from repro_torch.models.model import build_model
from repro_torch.training.train_step import TrainConfig, loss_and_grad

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_modules_and_example_import_no_jax():
    """The five new modules and the example run on the card machine, which
    has no JAX: importing them pulls in neither ``jax`` nor ``repro``."""
    code = (
        "import sys\n"
        "import repro_torch.launch.mesh, repro_torch.launch.op_cost\n"
        "import repro_torch.launch.dryrun, repro_torch.distributed.sharding\n"
        "import repro_torch.distributed.compression\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT / "src",
                         text=True, capture_output=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    src = (ROOT / "examples" / "torch_multipod_dryrun.py").read_text()
    for line in src.splitlines():
        words = line.split()
        assert words[:2] not in (["import", "jax"], ["import", "repro"])
        assert not (words[:1] == ["from"] and len(words) > 1
                    and words[1].split(".")[0] in ("jax", "repro")), line
    assert "repro_torch.launch import dryrun" in src


# ---------------------------------------------------------------------------
# (a) the counter
# ---------------------------------------------------------------------------


def test_op_cost_loop_matmul_exact():
    """hlo_cost's scan-of-matmul ground truth on a Python loop."""
    L_, M, K = 7, 32, 64
    x = torch.randn(M, K)
    ws = [torch.randn(K, K) for _ in range(L_)]

    def f():
        h = x
        for w in ws:
            h = torch.tanh(h @ w)
        return h

    _, rep = count(f)
    assert rep.by_op["mm"][0] == L_ * 2 * M * K * K
    assert rep.by_op["tanh"][0] == L_ * 4 * M * K        # transcendental
    assert rep.flops == L_ * 2 * M * K * K + L_ * 4 * M * K
    assert rep.by_op["mm"][1] == L_ * 4 * (M * K + K * K + M * K)
    assert flop_breakdown(rep, 1)[0][0] == "mm"
    assert bytes_breakdown(rep)[0][0] == "mm"
    assert rep.total_collective_bytes == 0 and rep.unknown_ops == {}


def test_views_are_free():
    x = torch.randn(4, 6, 8)

    def f():
        y = x.view(24, 8).t().reshape(8, 24)[:, :3].expand(2, 8, 3)
        return x.permute(2, 0, 1).detach(), y, x.unsqueeze(0)

    _, rep = count(f)
    assert rep.flops == 0 and rep.hbm_bytes == 0 and rep.by_op == {}


def _train_count(cfg, device, S=32, B=4, n_micro=1, trips=True):
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device)
    tok = torch.zeros((B, S), dtype=torch.int32, device=device)
    batch = {"tokens": tok, "labels": tok}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((B, cfg.encoder.seq_len, cfg.d_model),
                                      dtype=params["embed"].dtype, device=device)
    with OpCounter(trips=trips) as c:
        loss_and_grad(model, params, batch, TrainConfig(n_microbatches=n_micro))
    return c.report


def _assert_same(a, b):
    diff = {k: (a.by_op.get(k), b.by_op.get(k))
            for k in set(a.by_op) | set(b.by_op)
            if (a.by_op.get(k) or [0, 0])[:2] != (b.by_op.get(k) or [0, 0])[:2]}
    assert diff == {}
    assert a.flops == b.flops and a.hbm_bytes == b.hbm_bytes


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "xlstm-1.3b"])
def test_tiny_step_counts_the_same_on_cpu_and_meta(arch):
    cfg = tiny_config(arch)
    cpu = _train_count(cfg, "cpu", n_micro=2)
    meta = _train_count(cfg, "meta", n_micro=2)
    _assert_same(cpu, meta)
    assert meta.n_while_loops > 0 and cpu.n_while_loops == 0


TRIP_CASES = {
    # the layers (4 > 3) and 4 microbatches
    "dense_layers_microbatches": (tiny_config("qwen1.5-0.5b"), dict(n_micro=4)),
    # 4 groups of 8 layers: groups, mamba steps
    "jamba_groups": (tiny_config("jamba-1.5-large-398b").with_(n_layers=32),
                     dict(S=8)),
    # 4 groups: groups, 7 mLSTM blocks, sLSTM steps
    "xlstm_groups": (tiny_config("xlstm-1.3b").with_(n_layers=32),
                     dict(S=16)),
    # encoder and decoder blocks
    "whisper_blocks": (tiny_config("whisper-large-v3").with_(
        n_layers=5, encoder=EncoderConfig(n_layers=5, seq_len=16)), {}),
}


@pytest.mark.parametrize("case", list(TRIP_CASES))
def test_trip_scaled_count_equals_unrolled(case):
    cfg, kw = TRIP_CASES[case]
    unrolled = _train_count(cfg, "meta", trips=False, **kw)
    scaled = _train_count(cfg, "meta", **kw)
    assert scaled.n_while_loops > 0 and unrolled.n_while_loops == 0
    _assert_same(unrolled, scaled)


def _mixer_count(fn, trips):
    with OpCounter(trips=trips) as c:
        fn()
    return c.report


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
@pytest.mark.parametrize("grad", [True, False], ids=["backward", "forward"])
def test_trip_scaled_mixers_equal_unrolled(mixer, grad):
    """The scan loops at chunk 8 over 64 steps (8 chunks, 8 steps each),
    forward alone and forward + backward."""
    if mixer == "mamba":
        cfg = tiny_config("jamba-1.5-large-398b")
        p = mamba.init_mamba(torch.Generator(), cfg, torch.float32, "meta")

        def run(p, x):
            return mamba.mamba_mixer(p, x, cfg, chunk=8)[0]
    else:
        cfg = tiny_config("xlstm-1.3b")
        init = xlstm.init_mlstm if mixer == "mlstm" else xlstm.init_slstm
        p = init(torch.Generator(), cfg, torch.float32, "meta")

        def run(p, x):
            if mixer == "mlstm":
                return xlstm.mlstm_mixer(p, x, cfg, chunk=8)[0]
            return xlstm.slstm_mixer(p, x, cfg)[0]

    def fn():
        leaves = {k: v.detach().requires_grad_(grad) for k, v in p.items()}
        x = torch.empty((2, 64, cfg.d_model), device="meta",
                        requires_grad=grad)
        with torch.set_grad_enabled(grad):
            y = run(leaves, x)
            if grad:
                torch.autograd.grad(y.sum(), [x, *leaves.values()])

    unrolled, scaled = _mixer_count(fn, False), _mixer_count(fn, True)
    assert scaled.n_while_loops > 0
    _assert_same(unrolled, scaled)


def test_trip_helpers_are_plain_outside_a_counter():
    assert trip_range(0, 64, 8, device="cpu") == range(0, 64, 8)
    assert trip_range(9, device="meta") == range(9)
    items = [1, 2, 3, 4, 5]
    assert list(trip_items(items, device="meta")) == list(enumerate(items))
    with OpCounter():
        assert trip_range(9, device="cpu") == range(9)
        assert list(trip_items(items, device="cuda")) == list(enumerate(items))
        assert trip_fill([1, 2, 3], 3) == [1, 2, 3]
        assert list(trip_range(9, device="meta")) == [0, 1, 8]
        assert trip_range(3, device="meta") == range(3)


# ---------------------------------------------------------------------------
# (b) compression
# ---------------------------------------------------------------------------


def test_quantize_with_reference_noise_is_bitwise(rng):
    x = (rng.standard_normal((1000,)) * 3.0).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        q, s = jax_quantize_int8(jnp.asarray(x), key)
        noise = np.array(jax.random.uniform(key, (4, BLOCK), minval=-0.5,
                                            maxval=0.5))
        tq, ts = _quantize_with_noise(torch.from_numpy(x),
                                      torch.from_numpy(noise))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(s))


def test_quantize_roundtrip_error_bounded(rng):
    """tests/test_distributed.py's bars on the port's own draws."""
    x = torch.from_numpy((rng.standard_normal((1000,)) * 3.0).astype(np.float32))
    q, s = quantize_int8(x, torch.Generator().manual_seed(0))
    back = dequantize_int8(q.to(torch.int32), s, x.shape, x.numel())
    assert float((back - x).abs().max()) <= float(s.max())
    assert compression_ratio() < 0.27


def test_quantization_is_unbiased(rng):
    x = torch.from_numpy(rng.standard_normal((256,)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    errs = []
    for _ in range(64):
        q, s = quantize_int8(x, gen)
        errs.append((dequantize_int8(q.to(torch.int32), s, x.shape,
                                     x.numel()) - x).numpy())
    assert abs(np.mean(errs)) < 5e-3


def test_compressed_psum_single_process(tmp_path):
    """An axis of size 1 (a gloo group of one): compressed psum is the
    identity up to quantization, the residual held; the counter charges
    its two all-reduces per leaf at 2 x operand bytes."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        grads = {"w": torch.linspace(-1, 1, 512).reshape(2, 256)}
        with OpCounter() as c:
            out, err = compressed_psum(grads, None,
                                       torch.Generator().manual_seed(0))
        assert float((out["w"] - grads["w"]).abs().max()) <= 2e-2
        assert float(err["w"].abs().max()) <= 2e-2
        assert c.report.n_collective_ops == 2
        assert c.report.collective_bytes["all-reduce"] == 2 * (512 * 4 + 2 * 4)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# (c) the dry-run
# ---------------------------------------------------------------------------

TINY_CELLS = [
    ("qwen1.5-0.5b", "train_4k"), ("qwen1.5-0.5b", "prefill_32k"),
    ("qwen1.5-0.5b", "decode_32k"), ("arctic-480b", "train_4k"),
    ("llava-next-mistral-7b", "prefill_32k"), ("mixtral-8x7b", "long_500k"),
    ("jamba-1.5-large-398b", "train_4k"), ("jamba-1.5-large-398b", "long_500k"),
    ("xlstm-1.3b", "train_4k"), ("xlstm-1.3b", "prefill_32k"),
    ("whisper-large-v3", "train_4k"), ("whisper-large-v3", "decode_32k"),
]


@pytest.mark.parametrize("arch,shape", TINY_CELLS)
def test_dry_run_cell_tiny_families(arch, shape, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", tiny_config)
    memo = {}
    mesh = make_production_mesh(multi_pod=True)
    r = dryrun.dry_run_cell(arch, shape, mesh, memo=memo)
    assert r.ok, r.error
    assert r.hlo_flops > 0 and r.hlo_bytes > 0 and r.coll_bytes == 0
    assert r.compute_term_s == r.hlo_flops / (512 * 989e12)
    assert r.dominant in ("compute", "memory") and r.peak_memory_mb > 0
    assert "coll=n/a (one process)" in dryrun.fmt_row(r)
    # the other mesh derives its row from the same count (no new pass: a
    # tiny config trains in one microbatch on both meshes)
    n = len(memo)
    r16 = dryrun.dry_run_cell(arch, shape, make_production_mesh(), memo=memo)
    assert r16.ok and r16.hlo_flops == r.hlo_flops and len(memo) == n
    assert r16.compute_term_s == 2 * r.compute_term_s


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mixtral-8x7b", "xlstm-1.3b"])
def test_chunked_serve_cell(arch, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", tiny_config)
    r = dryrun.chunked_serve_cell(arch, make_production_mesh(), n_slots=8,
                                  chunk=16, max_context=64)
    if arch == "qwen1.5-0.5b":
        assert r.ok and r.hlo_flops > 0, r.error
    else:
        assert r.error == "family has no linear-cache chunked_step"


def test_main_full_width_decode_cell(capsys):
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                        "--quiet"]) == 0
    out = capsys.readouterr().out
    assert "1/1 cells OK" in out and "463,987,712 built (meta)" in out


def test_cell_result_fields_equal_reference():
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "CellResult")
    ref = [s.target.id for s in cls.body if isinstance(s, ast.AnnAssign)]
    assert ref == list(dryrun.CellResult.__dataclass_fields__)


@pytest.fixture
def jax_dryrun():
    """repro's dry-run module, imported with the XLA_FLAGS it sets at
    import taken back (JAX's backend is up first, so it sees no change)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def test_model_flops_for_equals_reference(jax_dryrun):
    for arch in ASSIGNED_ARCHS:
        for s in applicable_shapes(get_config(arch)):
            assert dryrun.model_flops_for(get_config(arch), s) == \
                jax_dryrun.model_flops_for(jax_get_config(arch),
                                           SHAPES_BY_NAME[s.name])
    assert dryrun.all_cells() == jax_dryrun.all_cells()


def test_chunked_prefill_attention_meta_route_and_native_path(monkeypatch):
    q = torch.empty((2, 4, 8, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 32, 2, 64), dtype=torch.bfloat16, device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    out = cpa_mod.chunked_prefill_attention(q, k, k, lens, lens)
    want = cpa_mod.chunked_prefill_attention_plain(q, k, k, lens, lens)
    assert out.device.type == "meta" and out.shape == want.shape == q.shape
    assert out.dtype == want.dtype == torch.bfloat16
    assert cpa_mod.chunked_prefill_attention.launches == 0

    class Reached(Exception):
        pass

    def record(*args):
        raise Reached(args)

    class CudaQ:            # a stand-in: the tests run without a CUDA device
        device, dtype, shape = torch.device("cuda"), torch.bfloat16, q.shape

    monkeypatch.setattr(native, "check_attention_dims", record)
    with pytest.raises(Reached):
        cpa_mod.chunked_prefill_attention(CudaQ(), k, k, lens, lens)


def test_checkpoint_restore_with_shardings(tmp_path):
    """tests/test_distributed.py's resharding case over a mesh of one; a
    larger mesh is refused."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    st = {"w": torch.randn(8, 16), "emb": torch.randn(32, 8).bfloat16(),
          "nested": {"b": torch.arange(5, dtype=torch.int32)}}
    mgr.save(1, st, blocking=True)
    one = make_mesh((1,), ("model",))
    sh = {"w": NamedSharding(one, P(None, "model")),
          "emb": NamedSharding(one, P("model", None)),
          "nested": {"b": NamedSharding(one, P())}}
    _, back = mgr.restore(st, shardings=sh)
    assert torch.equal(back["w"], st["w"]) and torch.equal(back["emb"], st["emb"])
    big = {**sh, "w": NamedSharding(make_production_mesh(), P(None, "model"))}
    with pytest.raises(NotImplementedError, match="256"):
        mgr.restore(st, shardings=big)
    mgr.close()
