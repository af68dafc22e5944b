"""The port's sharding rules, virtual meshes, meta param trees and input
specs (``repro_torch.distributed.sharding``, ``repro_torch.launch.mesh``,
``Model.init_shape`` / ``input_specs``, ``init_train_state_shape``) on the
CPU against the JAX package.

(a) ``param_specs`` over the port's meta tree equals ``repro``'s over
    ``init_shape()`` for all ten assigned archs on both production meshes
    with FSDP on and off: each port leaf's spec is the reference's minus
    its stacked dims, which the reference never shards.  Mirrors of
    tests/test_distributed.py's sanitize / rule cases, and a seeded grid of
    random specs and shapes against ``repro``'s ``sanitize_spec``.
(b) The meta trees' element counts equal ``repro``'s (the published table),
    mirrors of tests/test_models_smoke.py's count band and per-spec skips
    (33 cells), ``input_specs`` (decode's ``cache_struct`` included) equal
    to ``repro``'s in shape and dtype for all 33 cells, and
    ``init_train_state_shape`` equal to ``repro``'s for tiny dense, MoE and
    hybrid configs in both moment dtypes.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import tiny_config as jax_tiny_config
from repro.distributed import sharding as jsh
from repro.models.model import build_model as jax_build_model
from repro.training.train_step import TrainConfig as JaxTrainConfig
from repro.training.train_step import (
    init_train_state_shape as jax_init_train_state_shape,
)
from repro_torch.configs import (
    ASSIGNED_ARCHS, SHAPES_BY_NAME, applicable_shapes, get_config, tiny_config,
)
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.launch.mesh import (
    HBM_BW, PEAK_FLOPS_BF16, VirtualMesh, make_host_mesh, make_mesh,
    make_production_mesh, mesh_chips,
)
from repro_torch.models.model import build_model
from repro_torch.training.train_step import TrainConfig, init_train_state_shape
from repro_torch.tree import tree_leaves

# the element counts of the built (meta) param trees, the same in repro
LEAF_ELEMENTS = {
    "llama3.2-1b": 1_235_814_400,
    "granite-34b": 47_249_922_048,
    "qwen1.5-0.5b": 463_987_712,
    "mistral-large-123b": 122_610_069_504,
    "jamba-1.5-large-398b": 398_555_111_424,
    "whisper-large-v3": 1_534_602_240,
    "arctic-480b": 476_850_275_328,
    "mixtral-8x7b": 46_702_792_704,
    "llava-next-mistral-7b": 7_241_732_096,
    "xlstm-1.3b": 1_339_431_080,
}

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}

CELLS = [(a, s.name) for a in ASSIGNED_ARCHS
         for s in applicable_shapes(get_config(a))]


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def port_tree(arch):
    return build_model(get_config(arch)).init_shape()


@functools.lru_cache(maxsize=None)
def ref_tree(arch):
    return jax_build_model(jax_get_config(arch)).init_shape()


def unstacked_pairs(port, ref, n_stacked=0, path=""):
    """(path, port leaf, ref leaf, stacked dims) lining the port's list
    tree up with the reference's stacked one."""
    if isinstance(port, dict):
        assert set(port) == set(ref), (path, set(port) ^ set(ref))
        for k in port:
            yield from unstacked_pairs(port[k], ref[k], n_stacked,
                                       f"{path}/{k}")
    elif isinstance(port, list):
        yield from unstacked_pairs(port[0], ref, n_stacked + 1, path)
    else:
        yield path, port, ref, n_stacked


def dtype_name(t):
    return str(t.dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# (a) the rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "tp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_match_reference(arch, mesh_name, fsdp):
    mesh = FakeMesh(MESHES[mesh_name])
    port = tsh.param_specs(port_tree(arch), mesh, fsdp=fsdp)
    ref = jsh.param_specs(ref_tree(arch), mesh, fsdp=fsdp)
    n = 0
    for path, p, r, k in unstacked_pairs(port, ref):
        assert isinstance(p, P), path
        assert all(a is None for a in tuple(r)[:k]), (path, r)
        assert tuple(p) == tuple(r)[k:], (path, p, r)
        n += 1
    assert n == len(jax.tree.leaves(
        ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))


def test_path_marker_quirk_is_copied():
    """The hybrid's and xLSTM's stacks carry neither ``layers`` nor
    ``blocks``: the rule's axes land on their group dims, as in repro."""
    mesh = FakeMesh(MESHES["16x16"])
    jam = tsh.param_specs(port_tree("jamba-1.5-large-398b"), mesh, fsdp=True)
    xl = tsh.param_specs(port_tree("xlstm-1.3b"), mesh, fsdp=True)
    assert jam["mamba_dense"][0][0]["mamba"]["in_proj"] == P(None, None)
    assert xl["mlstm"][0][0]["wq"] == P(None, None, None)
    assert xl["slstm"][0]["up_proj"] == P("model", None)
    assert jam["mamba_moe"][0][0]["moe"]["w_gate"] == P("model", None, None)


def test_sanitize_spec_math():
    """tests/test_distributed.py's case on the port."""
    mesh = FakeMesh({"data": 16, "model": 16})
    assert tsh.sanitize_spec(mesh, (None, None, "model", None),
                             (1, 1, 8, 64)) == P(None, None, None, None)
    assert tsh.sanitize_spec(mesh, (None, None, "model", None),
                             (1, 1, 96, 64)) == P(None, None, "model", None)
    assert tsh.sanitize_spec(mesh, (("data", "model"),),
                             (256,)) == P(("data", "model"))
    assert tsh.sanitize_spec(mesh, (("data", "model"),), (32,)) == P("data")
    assert tsh.sanitize_spec(mesh, ("model", "model"),
                             (32, 32)) == P("model", None)


def test_spec_for_param_rules():
    """tests/test_distributed.py's case on the port's (stacked-view) rule."""
    mesh = FakeMesh({"data": 16, "model": 16})
    assert tsh.spec_for_param("layers/attn/wq", (16, 4096, 32, 128), mesh,
                              fsdp=True) == P(None, "data", "model", None)
    assert tsh.spec_for_param("layers/ffn/w_gate", (32, 4096, 14336), mesh,
                              fsdp=True) == P(None, "data", "model")
    assert tsh.spec_for_param("layers/moe/w_gate", (32, 128, 4096, 4864),
                              mesh, fsdp=True) == P(None, "model", "data", None)
    assert tsh.spec_for_param("layers/attn_norm", (32, 4096), mesh,
                              fsdp=True) == P(None, None)


@pytest.mark.parametrize("seed", range(4))
def test_sanitize_spec_random_grid_matches_reference(seed):
    rng = np.random.default_rng(seed)
    mesh = FakeMesh(MESHES["2x16x16"])
    dims = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, 512]
    axes = [None, "data", "model", "pod", ("data", "model"),
            ("model", "data"), ("pod", "data"), ("pod", "data", "model")]
    for _ in range(200):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice(dims)) for _ in range(nd))
        spec = tuple(axes[int(rng.integers(len(axes)))]
                     for _ in range(int(rng.integers(0, nd + 1))))
        assert tuple(tsh.sanitize_spec(mesh, spec, shape)) == tuple(
            jsh.sanitize_spec(mesh, spec, shape)), (spec, shape)


def test_named_sharding_shard_shape_and_tree():
    mesh = make_production_mesh(multi_pod=True)
    s = NamedSharding(mesh, P(("pod", "data"), None, "model"))
    assert s.shard_shape((256, 7, 64)) == (8, 7, 4)
    with pytest.raises(ValueError):
        NamedSharding(mesh, P("model")).shard_shape((8,))
    tree = {"a": [P("data"), P()], "b": P(None, "model")}
    sh = tsh.shardings_for(tree, mesh)
    assert isinstance(sh["a"][0], NamedSharding) and sh["b"].spec == P(None, "model")
    x = torch.ones(3)
    assert tsh.constrain(x, ("batch",)) is x
    assert P("a", None) == ("a", None) and repr(P("a")) == "P('a',)"


def test_virtual_meshes_and_h100_constants():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.axis_names == ("data", "model") and single.axis_sizes == (16, 16)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh_chips(single) == 256 and mesh_chips(multi) == 512
    assert make_mesh((4, 2), ("data", "model")).size == 8
    assert make_host_mesh().size == 1          # the tests run without CUDA
    with pytest.raises(ValueError):
        VirtualMesh(("data",), (2, 2))
    # the H100's data-sheet peaks, not a TPU's
    assert (PEAK_FLOPS_BF16, HBM_BW) == (989e12, 3.35e12)
    assert tsh.default_rules(multi, fsdp=True) == jsh.default_rules(
        FakeMesh(multi.shape), fsdp=True)


# ---------------------------------------------------------------------------
# (b) counts, shapes, specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_meta_leaf_counts_match_reference(arch):
    n = sum(t.numel() for t in tree_leaves(port_tree(arch)))
    assert n == LEAF_ELEMENTS[arch]
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(ref_tree(arch)))
    for path, p, r, k in unstacked_pairs(port_tree(arch), ref_tree(arch)):
        assert p.device.type == "meta"
        assert tuple(p.shape) == tuple(r.shape)[k:], path
        assert dtype_name(p) == str(r.dtype), path


def test_param_counts_in_band():
    """tests/test_models_smoke.py's analytic bands on the port's configs."""
    bands = {
        "llama3.2-1b": (0.9e9, 1.6e9), "granite-34b": (40e9, 52e9),
        "qwen1.5-0.5b": (0.35e9, 0.7e9), "mistral-large-123b": (110e9, 130e9),
        "jamba-1.5-large-398b": (330e9, 440e9), "arctic-480b": (420e9, 520e9),
        "mixtral-8x7b": (42e9, 50e9), "llava-next-mistral-7b": (6.5e9, 8e9),
        "xlstm-1.3b": (0.9e9, 1.8e9),
    }
    for arch, (lo, hi) in bands.items():
        assert lo <= get_config(arch).param_count() <= hi, arch


def test_shape_skips_per_spec():
    total = 0
    for arch in ASSIGNED_ARCHS:
        shapes = {s.name for s in applicable_shapes(get_config(arch))}
        total += len(shapes)
        assert ("long_500k" in shapes) == (arch in (
            "jamba-1.5-large-398b", "mixtral-8x7b", "xlstm-1.3b"))
    assert total == len(CELLS) == 33


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    spec = SHAPES_BY_NAME[shape]
    port = build_model(get_config(arch)).input_specs(spec)
    ref = jax_build_model(jax_get_config(arch)).input_specs(spec)
    assert set(port) == set(ref)
    p_leaves, r_leaves = tree_leaves(port), jax.tree.leaves(ref)
    assert len(p_leaves) == len(r_leaves)
    for p, r in zip(p_leaves, r_leaves):
        assert p.device.type == "meta"
        assert tuple(p.shape) == tuple(r.shape) and dtype_name(p) == str(r.dtype)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "arctic-480b",
                                  "jamba-1.5-large-398b"])
def test_init_train_state_shape_matches_reference(arch, moment_dtype):
    port_p, port_o = init_train_state_shape(
        build_model(tiny_config(arch)), TrainConfig(moment_dtype=moment_dtype))
    ref_p, ref_o = jax_init_train_state_shape(
        jax_build_model(jax_tiny_config(arch)),
        JaxTrainConfig(moment_dtype=moment_dtype))
    for port, ref in ((port_p, ref_p), (port_o.mu, ref_o.mu),
                      (port_o.nu, ref_o.nu)):
        for path, p, r, k in unstacked_pairs(port, ref):
            assert p.device.type == "meta"
            assert tuple(p.shape) == tuple(r.shape)[k:], path
            assert dtype_name(p) == str(r.dtype), path
    assert dtype_name(port_o.mu["embed"]) == moment_dtype
    assert port_o.step.shape == () and port_o.step.dtype == torch.int32
