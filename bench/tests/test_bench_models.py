"""Model modules (``bench/models/``): ``arctic-1l`` reads through its module
what the harness read before configurations named one (the values below
were recorded from the harness of that time: ``cell.model_config``,
``weights._shapes``, ``flops/model.py``); the transformer module refuses
what neither the engine's path nor its reference computes; the attention
readers take each launch a module gives."""
import dataclasses
import hashlib

import pytest
import torch

from bench import cell as cells, weights
from bench.flops import model as fm, peaks
from bench.loop import RoundRecord
from bench.tests import conftest

ARCTIC = cells.load_json(cells.ROOT / "bench/configs/arctic-1l.json")

MODEL_CONFIG = {
    'name': 'arctic-1l', 'family': 'moe', 'n_layers': 1, 'd_model': 7168,
    'n_heads': 56, 'n_kv_heads': 8, 'd_ff': 7168, 'vocab_size': 32000,
    'head_dim': 128, 'qkv_bias': False, 'sliding_window': 0,
    'rope_theta': 10000.0, 'norm_eps': 1e-05, 'tie_embeddings': False,
    'moe': {'n_experts': 128, 'top_k': 2, 'd_ff': 4864,
            'capacity_factor': 64.0, 'dense_residual': True, 'every': 1},
    'ssm': None, 'encoder': None, 'attn_every': 0, 'n_patch_tokens': 0,
    'sharding': 'tp', 'scan_layers': True, 'moe_impl': 'scatter',
    'param_dtype': 'bfloat16', 'compute_dtype': 'bfloat16',
    'subquadratic': False, 'has_decode': True, 'max_seq_len': 4096,
    'notes': ''}

S_D = 0.01181138978153835           # 1 / sqrt(7168)
DRAWS = [
    ('embed', (32000, 7168), 0.02, 'bfloat16'),
    ('attn_norm', (1, 7168), 0.0, 'bfloat16'),
    ('wq', (1, 7168, 56, 128), S_D, 'bfloat16'),
    ('wk', (1, 7168, 8, 128), S_D, 'bfloat16'),
    ('wv', (1, 7168, 8, 128), S_D, 'bfloat16'),
    ('wo', (1, 56, 128, 7168), S_D, 'bfloat16'),
    ('ffn_norm', (1, 7168), 0.0, 'bfloat16'),
    ('w_gate', (1, 7168, 7168), S_D, 'bfloat16'),
    ('w_up', (1, 7168, 7168), S_D, 'bfloat16'),
    ('w_down', (1, 7168, 7168), S_D, 'bfloat16'),
    ('router', (1, 7168, 128), S_D, 'float32'),
    ('e_gate', (1, 128, 7168, 4864), S_D, 'bfloat16'),
    ('e_up', (1, 128, 7168, 4864), S_D, 'bfloat16'),
    ('e_down', (1, 128, 4864, 7168), 0.014338483366910109, 'bfloat16'),
    ('final_norm', (7168,), 0.0, 'bfloat16'),
    ('lm_head', (7168, 32000), S_D, 'bfloat16')]

ROWS = {
    "decode16": [(c, 1) for c in (3, 17, 40, 95, 128, 200, 311, 512, 7, 64,
                                  1000, 2047, 5, 33, 260, 800)],
    "prefill": [(0, 128)],
    "mixed": [(19, 1), (250, 1), (0, 37), (64, 64), (180, 27)],
}
# step_flops with n_sampled = len(rows) - 1; one attention launch's
# operations, bytes and bound
READINGS = {
    "decode16": (22454132736.0, 158785536.0, 23142400.0, 6.908179104477612e-06),
    "prefill": (123549253632.0, 236716032.0, 4194304.0, 1.2520310447761193e-06),
    "mixed": (127429492736.0, 355188736.0, 6361088.0, 1.8988322388059703e-06),
}

# SHA-256 over each stack's name and bytes, in draw order, seed 0, CPU
STACKS_SHA = {
    "tiny-dense": "3d23a7dfe775e6948826538370f6de82063eb5fc89198d6fc4df4b5fa24a49b2",
    "tiny-moe": "c2ceb02d9c7294d7bc37192a77ecc5cc635241eb0c9beb8d87b6acd7f490903c",
}


def test_arctic_model_config_is_as_before():
    assert dataclasses.asdict(cells.model_config(ARCTIC)) == MODEL_CONFIG


def test_arctic_draws_are_as_before():
    mcfg = cells.model_config(ARCTIC)
    draws = cells.model_module(ARCTIC).draws(ARCTIC, mcfg)
    assert [(n, tuple(s), sc, str(dt).replace("torch.", ""))
            for n, s, sc, dt in draws] == DRAWS


@pytest.mark.parametrize("rows", sorted(ROWS))
def test_arctic_arithmetic_is_as_before(rows):
    step, f, b, bound = READINGS[rows]
    r = ROWS[rows]
    assert fm.active_params(ARCTIC) == 481689600
    assert fm.step_flops(ARCTIC, r, n_sampled=len(r) - 1) == step
    assert fm.attention_launches(ARCTIC, r) == [(f, b)]
    assert fm.bound_s(f, b, peaks.BF16_FLOPS, peaks.HBM_BYTES_PER_S) == bound


@pytest.mark.parametrize("name", sorted(STACKS_SHA))
def test_tiny_stacks_are_as_before(tmp_path, name):
    root = conftest.make_root(tmp_path)
    config = cells.load_json(root / f"bench/configs/{name}.json")
    mcfg = cells.model_config(config, root)
    draws = cells.model_module(config, root).draws(config, mcfg)
    stacks = weights.make_stacks(draws, 0, "cpu")
    h = hashlib.sha256()
    for n, t in stacks.items():
        h.update(n.encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == STACKS_SHA[name]


@pytest.mark.parametrize("key,value", [("moe_layer_frequency", 2),
                                       ("sliding_window", 4096)])
def test_transformer_refuses_what_it_does_not_compute(key, value):
    config = dict(ARCTIC, **{key: value})
    with pytest.raises(ValueError, match=key):
        cells.model_config(config)


def test_added_model_maps_its_key_and_draws_its_biases(tiny_root):
    config = cells.load_json(tiny_root / "bench/configs/tiny-qkvbias.json")
    model = cells.model_module(config, tiny_root)
    mcfg = model.program_config(config)
    assert mcfg.qkv_bias
    stacks = weights.make_stacks(model.draws(config, mcfg), 1, "cpu")
    attn = model.as_params(mcfg, stacks)["layers"][1]["attn"]
    assert attn["bq"].shape == (4, 16) and attn["bv"].shape == (2, 16)
    assert all(attn[k].abs().min() > 0 for k in ("bq", "bk", "bv"))


class Ctx:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_rooflines_take_each_launch_the_module_gives(tmp_path):
    """A module whose layers launch the kernel unevenly (a layer without
    attention, a layer over fewer keys): the reader expects its launches
    and sums their bounds."""
    from bench import trace_read
    (tmp_path / "bench/models").mkdir(parents=True)
    (tmp_path / "bench/models/uneven.py").write_text(
        "def attention_launches(config, rows):\n"
        "    return [(4e6, 1e3), (1e6, 3.35e6)]\n")
    ctx = Ctx(config={"model": "uneven"},
              rounds=[RoundRecord(1, [(3, 1)], 1), RoundRecord(1, [(5, 1)], 1)],
              trace=trace_read.Trace(lo=0, hi=10**9, host=[], device=[
                  ("decode_splitk_kernel", 10 * i, 10 * i + 5) for i in range(4)]),
              trace_read=trace_read, flops=fm.Yardstick(tmp_path), peaks=peaks,
              log=print)
    bound = 2 * (4e6 / 989e12 + 1e-6)
    got = cells.metric_reader("decode_attn_roofline").read(ctx)
    assert got == pytest.approx(100 * bound / 20e-9)
