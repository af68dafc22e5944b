"""Multi-pod dry-run on one process: count every (architecture x input
shape) cell of the model zoo on the production meshes and derive its
roofline terms (the port of ``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun                   # all cells, single-pod
    python -m repro_torch.launch.dryrun --both --chunked-serve
    python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape decode_32k
    python -m repro_torch.launch.dryrun --json out.json   # machine-readable record

Where the reference lowers and compiles each cell for 512 devices and
reads its costs from the compiled HLO, the port runs the cell's step once
on the meta device -- shapes and dtypes, no storage, no arithmetic --
under ``repro_torch.launch.op_cost.OpCounter``, which counts every aten
op with the loops' trip counts multiplied through.  The meshes are virtual
(``repro_torch.launch.mesh``); the sharding rules give every argument's
and output's per-device shard shape.

What each field holds:

  * ``hlo_flops`` / ``hlo_bytes``: the GLOBAL counts of the step (the
    reference's per-device counts times its chips).
  * ``coll_bytes``: 0.  One process runs no collective, and the dry-run
    does not estimate the ones a sharded run would make; ``fmt_row``
    prints ``coll=n/a (one process)``.
  * ``compute_term_s`` / ``memory_term_s``: the global counts over the
    mesh's chips at the H100's peaks (``mesh.PEAK_FLOPS_BF16``,
    ``mesh.HBM_BW``): lower bounds.
  * ``lower_s``: the counted pass's wall seconds; ``compile_s``: 0.
  * ``bytes_per_device``: the step's outputs' per-device bytes under the
    port's shardings; ``peak_memory_mb``: those plus its arguments' (params,
    optimizer state, inputs, cache).  Temporaries are not tracked.

The counted pass does not depend on the mesh, except through the train
step's microbatch count: each (cell, TrainConfig) is counted once
(``memo``) and both meshes' rows derive from it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ASSIGNED_ARCHS, applicable_shapes, get_config
from repro_torch.configs.base import SHAPES_BY_NAME, ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import (
    NamedSharding,
    P,
    default_rules,
    param_specs,
    sanitize_spec,
    shardings_for,
)
from repro_torch.launch.mesh import (
    HBM_BW,
    NVLINK_BW_PER_LINK,
    PEAK_FLOPS_BF16,
    make_production_mesh,
    mesh_chips,
)
from repro_torch.launch.op_cost import CostReport, OpCounter
from repro_torch.models.model import Model, build_model
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_step import (
    default_train_config,
    init_train_state_shape,
    make_train_step,
)
from repro_torch.tree import tree_leaves, tree_map_with_path

# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------


@dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    error: Optional[str] = None
    lower_s: float = 0.0
    compile_s: float = 0.0
    hlo_flops: float = 0.0
    hlo_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_breakdown: Dict[str, int] = field(default_factory=dict)
    bytes_per_device: float = 0.0
    peak_memory_mb: float = 0.0
    compute_term_s: float = 0.0
    memory_term_s: float = 0.0
    collective_term_s: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0
    useful_flops_ratio: float = 0.0
    roofline_fraction: float = 0.0

    def bound_s(self) -> float:
        return max(self.compute_term_s, self.memory_term_s, self.collective_term_s)


def model_flops_for(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill) / 2*N_active*B (decode)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def roofline(res: CellResult, n_chips: int) -> None:
    res.compute_term_s = res.hlo_flops / (n_chips * PEAK_FLOPS_BF16)
    res.memory_term_s = res.hlo_bytes / (n_chips * HBM_BW)
    res.collective_term_s = res.coll_bytes / (n_chips * NVLINK_BW_PER_LINK)
    terms = {
        "compute": res.compute_term_s,
        "memory": res.memory_term_s,
        "collective": res.collective_term_s,
    }
    res.dominant = max(terms, key=terms.get)
    res.useful_flops_ratio = res.model_flops / res.hlo_flops if res.hlo_flops else 0.0
    ideal = res.model_flops / (n_chips * PEAK_FLOPS_BF16)
    res.roofline_fraction = ideal / res.bound_s() if res.bound_s() > 0 else 0.0


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------


def _batch_shards(mesh, rules) -> int:
    batch_ax = rules["batch"]
    n = 1
    for a in (batch_ax,) if isinstance(batch_ax, str) else tuple(batch_ax):
        n *= mesh.shape[a]
    return n


def batch_input_shardings(model: Model, shape: ShapeSpec, mesh, rules) -> Any:
    """NamedShardings for the input batch dict of this cell."""
    specs = model.input_specs(shape)

    def spec_of(name: str, s) -> NamedSharding:
        batch_ax = rules["batch"]
        if name in ("tokens", "labels", "loss_mask", "lens"):
            p = sanitize_spec(mesh, (batch_ax,) + (None,) * (len(s.shape) - 1), s.shape)
        elif name in ("frames", "patch_embeds"):
            p = sanitize_spec(mesh, (batch_ax, None, None), s.shape)
        else:
            p = P()
        return NamedSharding(mesh, p)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return spec_of(name, tree)

    return walk(specs)


def cache_shardings(
    model: Model, shape: ShapeSpec, mesh, rules, *, phase: str = "decode"
) -> Tuple[Any, Dict[str, Any]]:
    """KV cache: batch over data; heads over model when divisible.  When
    heads do not divide the model axis, the layout is phase-optimal: the
    *decode* input cache shards the LENGTH over model, while the *prefill*
    output cache shards HEAD_DIM over model under capacity pressure.
    Recurrent (SSM / xLSTM) states: batch over data + the widest divisible
    trailing dim over model.  Returns (shardings, cache_rules)."""
    struct = model.cache_struct(shape.global_batch, shape.seq_len)
    batch_ax = rules["batch"]
    model_sz = mesh.shape["model"]
    batch_shards = _batch_shards(mesh, rules)

    hd_sharded = []  # records whether any prefill kv leaf went hd-sharded

    def kv_spec(shp, dtype_bytes=2):
        # (L, B, S, H, hd)
        L_, B, S, H, hd = shp
        if H % model_sz == 0:
            return sanitize_spec(mesh, (None, batch_ax, None, "model", None), shp)
        if phase == "prefill":
            # hd-sharding (a local slice on write) only under capacity
            # pressure: 4 GB/device budget for one of k/v.
            per_dev = L_ * max(1, B // batch_shards) * S * H * hd * dtype_bytes
            if per_dev <= 4 * 2**30 or hd % model_sz != 0:
                return sanitize_spec(mesh, (None, batch_ax, None, None, None), shp)
            hd_sharded.append(True)
            return sanitize_spec(mesh, (None, batch_ax, None, None, "model"), shp)
        return sanitize_spec(mesh, (None, batch_ax, "model", None, None), shp)

    def state_spec(shp):
        spec = [None] * len(shp)
        b_idx = None
        for i, d in enumerate(shp):
            if d == shape.global_batch:
                spec[i] = batch_ax
                b_idx = i
                break
        # widest trailing dim divisible by the model axis (skip the batch dim)
        best, best_d = None, 0
        for i in range(len(shp) - 1, (b_idx if b_idx is not None else -1), -1):
            if spec[i] is None and shp[i] % model_sz == 0 and shp[i] > best_d:
                best, best_d = i, shp[i]
        if best is not None:
            spec[best] = "model"
        return sanitize_spec(mesh, tuple(spec), shp)

    def one(path: str, s) -> NamedSharding:
        shp = tuple(s.shape)
        name = path.split("/")[0]
        if (name in ("k", "v") or name.startswith("self")
                or name.startswith("cross")):
            p = kv_spec(shp)
        elif name == "kv_pos":
            p = sanitize_spec(mesh, (None, batch_ax, None), shp)
        else:  # recurrent / conv state of any nesting
            p = state_spec(shp)
        return NamedSharding(mesh, p)

    shardings = tree_map_with_path(one, struct)
    cache_rules = {"cache_hd": "model", "cache_heads": None} if hd_sharded else {}
    return shardings, cache_rules


def _sharded_bytes(tree, shardings) -> int:
    """Per-device bytes of a tree of tensors under a matching tree of
    NamedShardings (a ``None`` sharding: the leaf whole on every device)."""
    total = 0
    for t, s in zip(tree_leaves(tree), tree_leaves(shardings)):
        shp = tuple(t.shape) if s is None else s.shard_shape(tuple(t.shape))
        n = 1
        for d in shp:
            n *= d
        total += n * t.element_size()
    return total


def _replicated(tree, mesh):
    return tree_map_with_path(
        lambda _, t: NamedSharding(mesh, P(*(None,) * t.dim())), tree)


def _batch_sharded(tree, mesh, rules):
    """Leading dim over the batch axes (the step's logits)."""
    return tree_map_with_path(lambda _, t: NamedSharding(mesh, sanitize_spec(
        mesh, (rules["batch"],) + (None,) * (t.dim() - 1), tuple(t.shape))),
        tree)


# ---------------------------------------------------------------------------
# per-cell counting
# ---------------------------------------------------------------------------


def _arch_state(arch: str, memo: Dict) -> Tuple[ModelConfig, Model, Any, Any]:
    """(cfg, model, meta params, meta opt state), built once per arch: the
    train state of ``default_train_config``'s moment dtype (it depends on
    the param count only)."""
    key = ("arch", arch)
    if key not in memo:
        cfg = get_config(arch)
        model = build_model(cfg)
        tcfg = default_train_config(cfg.param_count(), batch_shards=1,
                                    global_batch=1)
        params, opt = init_train_state_shape(model, tcfg)
        memo[key] = (cfg, model, params, opt)
    return memo[key]


def param_leaf_count(arch: str, memo: Optional[Dict] = None) -> int:
    """Elements in the arch's built param tree (the meta one)."""
    _, _, params, _ = _arch_state(arch, {} if memo is None else memo)
    return sum(t.numel() for t in tree_leaves(params))


def _counted(key, fn, memo: Dict) -> Tuple[CostReport, Any, float]:
    """(report, outputs, wall s) of ``fn()`` under an OpCounter, once per
    key."""
    if key not in memo:
        t0 = time.perf_counter()
        with OpCounter() as c:
            out = fn()
        memo[key] = (c.report, out, time.perf_counter() - t0)
    return memo[key]


def dry_run_cell(
    arch: str,
    shape_name: str,
    mesh,
    *,
    fsdp: Optional[bool] = None,
    shard_seq: bool = False,
    verbose: bool = True,
    extra_rules: Optional[Dict[str, Any]] = None,
    memo: Optional[Dict] = None,
) -> CellResult:
    """Count one cell on the meta device and fill its roofline terms over
    ``mesh`` (``lower_cell``'s counterpart).  ``memo`` carries the meta
    trees and the counts between calls."""
    memo = {} if memo is None else memo
    shape = SHAPES_BY_NAME[shape_name]
    mesh_name = "x".join(str(s) for s in mesh.axis_sizes)
    res = CellResult(arch=arch, shape=shape_name, mesh=mesh_name, ok=False)
    n_chips = mesh_chips(mesh)
    try:
        cfg, model, params, opt = _arch_state(arch, memo)
        use_fsdp = fsdp if fsdp is not None else (cfg.sharding == "fsdp_tp")
        rules = default_rules(mesh, shard_seq=shard_seq, fsdp=use_fsdp)
        if extra_rules:
            rules.update(extra_rules)
        pshard = shardings_for(param_specs(params, mesh, fsdp=use_fsdp), mesh)
        specs = model.input_specs(shape)

        if shape.kind == "train":
            tcfg = default_train_config(
                cfg.param_count(), batch_shards=_batch_shards(mesh, rules),
                global_batch=shape.global_batch,
            )
            step = make_train_step(model, tcfg)
            rep, out, wall = _counted(
                ("train", arch, shape_name, tcfg),
                lambda: step(params, opt, specs), memo)
            mom = shardings_for(param_specs(opt.mu, mesh, fsdp=use_fsdp), mesh)
            oshard = AdamWState(step=NamedSharding(mesh, P()), mu=mom, nu=mom)
            args_b = (_sharded_bytes(params, pshard)
                      + _sharded_bytes(opt, oshard)
                      + _sharded_bytes(specs, batch_input_shardings(
                          model, shape, mesh, rules)))
            out_b = (_sharded_bytes(out[0], pshard)
                     + _sharded_bytes(out[1], oshard)
                     + _sharded_bytes(out[2], _replicated(out[2], mesh)))
        elif shape.kind == "prefill":
            cshard, cache_rules = cache_shardings(model, shape, mesh, rules,
                                                  phase="prefill")
            rules.update(cache_rules)

            def prefill():
                with torch.no_grad():
                    return model.prefill(params, specs)

            rep, out, wall = _counted(("prefill", arch, shape_name), prefill,
                                      memo)
            args_b = (_sharded_bytes(params, pshard)
                      + _sharded_bytes(specs, batch_input_shardings(
                          model, shape, mesh, rules)))
            out_b = (_sharded_bytes(out[0], _batch_sharded(out[0], mesh, rules))
                     + _sharded_bytes(out[1], cshard))
        else:  # decode
            cshard, _ = cache_shardings(model, shape, mesh, rules,
                                        phase="decode")

            def decode():
                with torch.no_grad():
                    return model.decode(params, specs["tokens"],
                                        specs["cache"], specs["lens"])

            rep, out, wall = _counted(("decode", arch, shape_name), decode,
                                      memo)
            in_shard = {
                "tokens": NamedSharding(mesh, sanitize_spec(
                    mesh, (rules["batch"], None), tuple(specs["tokens"].shape))),
                "cache": cshard,
                "lens": NamedSharding(mesh, sanitize_spec(
                    mesh, (rules["batch"],), tuple(specs["lens"].shape))),
            }
            args_b = _sharded_bytes(params, pshard) + _sharded_bytes(
                specs, in_shard)
            out_b = (_sharded_bytes(out[0], _batch_sharded(out[0], mesh, rules))
                     + _sharded_bytes(out[1], cshard))

        _fill(res, rep, wall, args_b, out_b, model_flops_for(cfg, shape),
              n_chips)
    except Exception as e:  # noqa: BLE001 -- record per-cell failures
        res.error = f"{type(e).__name__}: {e}"
        if verbose:
            traceback.print_exc()
    return res


def _fill(res: CellResult, rep: CostReport, wall: float, args_b: int,
          out_b: int, model_flops: float, n_chips: int) -> None:
    res.lower_s = wall
    res.hlo_flops = rep.flops
    res.hlo_bytes = rep.hbm_bytes
    res.coll_bytes = 0.0          # one process: no collective is modelled
    res.coll_breakdown = {k: int(v) for k, v in rep.collective_bytes.items()}
    res.coll_breakdown["n_ops"] = rep.n_collective_ops
    res.bytes_per_device = float(out_b)
    res.peak_memory_mb = float(out_b + args_b) / 2**20
    res.model_flops = model_flops
    roofline(res, n_chips)
    res.ok = True


def chunked_serve_cell(
    arch: str,
    mesh,
    *,
    n_slots: int = 128,
    chunk: int = 256,
    max_context: int = 8192,
    verbose: bool = False,
    memo: Optional[Dict] = None,
) -> CellResult:
    """Count the paper's execution unit -- one mixed chunked-prefill round
    (decode slots advance 1 token, prefill slots by their chunk) -- of the
    dense ``chunked_step`` on the meta device (its attention is
    ``chunked_prefill_attention``'s plain version there), as the reference
    lowers it (``lower_chunked_serve``)."""
    memo = {} if memo is None else memo
    cfg = get_config(arch)
    mesh_name = "x".join(str(s) for s in mesh.axis_sizes)
    res = CellResult(arch=arch, shape="chunk_serve", mesh=mesh_name, ok=False)
    n_chips = mesh_chips(mesh)
    model = build_model(cfg)
    impl = model.impl
    if not hasattr(impl, "chunked_step") or cfg.sliding_window:
        res.error = "family has no linear-cache chunked_step"
        return res
    try:
        _, _, params, _ = _arch_state(arch, memo)
        use_fsdp = cfg.sharding == "fsdp_tp"
        rules = default_rules(mesh, fsdp=use_fsdp)
        batch_ax = rules["batch"]
        dt = params["embed"].dtype
        kv_shape = (cfg.n_layers, n_slots, max_context + 1, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
        meta = dict(device="meta")
        cache = {k: torch.empty(kv_shape, dtype=dt, **meta) for k in ("k", "v")}
        tok = torch.empty((n_slots, chunk), dtype=torch.int32, **meta)
        lens = torch.empty((n_slots,), dtype=torch.int32, **meta)

        def round_():
            with torch.no_grad():
                return impl.chunked_step(params, tok, cache, lens, lens)

        rep, out, wall = _counted(
            ("chunk_serve", arch, n_slots, chunk, max_context), round_, memo)
        if cfg.n_kv_heads % mesh.shape["model"] == 0:
            kv = sanitize_spec(mesh, (None, batch_ax, None, "model", None), kv_shape)
        else:
            kv = sanitize_spec(mesh, (None, batch_ax, None, None, None), kv_shape)
        cshard = {k: NamedSharding(mesh, kv) for k in ("k", "v")}
        pshard = shardings_for(param_specs(params, mesh, fsdp=use_fsdp), mesh)
        tshard = NamedSharding(mesh, sanitize_spec(mesh, (batch_ax, None),
                                                   tuple(tok.shape)))
        lshard = NamedSharding(mesh, sanitize_spec(mesh, (batch_ax,),
                                                   tuple(lens.shape)))
        cache_b = _sharded_bytes(cache, cshard)
        args_b = (_sharded_bytes(params, pshard) + cache_b
                  + _sharded_bytes([tok, lens, lens], [tshard, lshard, lshard]))
        out_b = _sharded_bytes(out, _batch_sharded(out, mesh, rules)) + cache_b
        # model flops: ~n_slots*chunk tokens of prefill-like work
        _fill(res, rep, wall, args_b, out_b,
              2.0 * cfg.active_param_count() * n_slots * chunk, n_chips)
    except Exception as e:  # noqa: BLE001
        res.error = f"{type(e).__name__}: {e}"
        if verbose:
            traceback.print_exc()
    return res


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def all_cells() -> List[tuple]:
    cells = []
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for s in applicable_shapes(cfg):
            cells.append((arch, s.name))
    return cells


def fmt_row(r: CellResult) -> str:
    if not r.ok:
        return f"  {r.arch:24s} {r.shape:12s} FAIL  {r.error}"
    return (
        f"  {r.arch:24s} {r.shape:12s} ok "
        f"comp={r.compute_term_s*1e3:9.2f}ms mem={r.memory_term_s*1e3:9.2f}ms "
        f"coll=n/a (one process) dom={r.dominant:10s} "
        f"useful={r.useful_flops_ratio:6.3f} roofline={r.roofline_fraction:6.3f} "
        f"mem/dev={r.peak_memory_mb:9.1f}MB"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true", help="run single-pod AND multi-pod")
    ap.add_argument("--chunked-serve", action="store_true",
                    help="also count the paper's mixed chunked-prefill round")
    ap.add_argument("--json", default=None)
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.both:
        meshes = [("single-pod 16x16", False), ("multi-pod 2x16x16", True)]
    else:
        meshes = [("multi-pod 2x16x16" if args.multi_pod else "single-pod 16x16",
                   args.multi_pod)]

    if args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = [(args.arch, s.name) for s in applicable_shapes(get_config(args.arch))]
    else:
        cells = all_cells()

    memo: Dict = {}
    results: List[CellResult] = []
    rows: List[Dict[str, Any]] = []
    n_fail = 0
    for arch in dict.fromkeys(a for a, _ in cells):
        try:
            n = param_leaf_count(arch, memo)
        except Exception as e:  # noqa: BLE001 -- the arch's cells fail below
            print(f"  {arch}: meta params FAIL {type(e).__name__}: {e}")
            continue
        print(f"  {arch:24s} params: {n:,} built (meta) / "
              f"{get_config(arch).param_count():,} analytic "
              f"(ModelConfig.param_count)")
    for mesh_label, mp in meshes:
        mesh = make_production_mesh(multi_pod=mp)
        print(f"=== {mesh_label}: {mesh_chips(mesh)} chips, "
              f"axes {mesh.axis_names} {mesh.axis_sizes} (virtual) ===")
        for arch, shape in cells:
            t0 = time.perf_counter()
            r = dry_run_cell(arch, shape, mesh, verbose=not args.quiet,
                             memo=memo)
            results.append(r)
            rows.append(asdict(r))
            print(fmt_row(r) + f" wall={time.perf_counter() - t0:.2f}s",
                  flush=True)
            n_fail += 0 if r.ok else 1
        if args.chunked_serve:
            for arch in dict.fromkeys(a for a, _ in cells):
                t0 = time.perf_counter()
                r = chunked_serve_cell(arch, mesh, verbose=not args.quiet,
                                       memo=memo)
                if r.error == "family has no linear-cache chunked_step":
                    continue
                results.append(r)
                rows.append(asdict(r))
                print(fmt_row(r) + f" wall={time.perf_counter() - t0:.2f}s",
                      flush=True)
                n_fail += 0 if r.ok else 1

    print(f"\n{len(results) - n_fail}/{len(results)} cells OK")
    if args.json:
        for row in rows:
            row["param_leaves"] = param_leaf_count(row["arch"], memo)
            row["param_count"] = get_config(row["arch"]).param_count()
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.json}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
