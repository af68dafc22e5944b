"""The index math of the three redesigned swap kernels, modelled on the CPU.

``csrc/swap_scatter_pages.cu`` walks (layer, item, chunk) work items over
persistent CTAs, one elected thread moving each chunk of a page through a
ring of shared-memory stages by bulk copies, and writes nothing for an id
that the next id repeats.  ``csrc/swap_scatter_pages_q8.cu`` walks the same
items over chunks of codes: a producer warp loads each chunk and its scale
slots into a ring stage (a bulk copy, small copies for unaligned ends and
the scales) and consumer warps dequantize it into 16-byte stores, the same
repeated-id rule deciding which items write.  ``csrc/swap_gather_pages_q8.cu``
walks (layer, page, head block) items, loads each into a ring stage once,
takes every head's absmax from shared memory (a warp per head, a shuffle
reduction) and its codes from the same tile, 16 (or 8, or 4) a store; a
head whose rows exceed a stage takes its two-pass kernel instead, a CTA
per (page, block of kHeadBlock heads), so that any H is taken.  This
file models the walks in numpy with the constants read from the sources --
the ring's stages and their mbarrier phases, the refill rule, the chunking
of large pages, the head blocks, the scale slots, the repeated-id rule --
and holds the models against the plain versions
(``repro_torch.kernels.swap``, bitwise) and against ``repro.kernels.swap``
run as tests/test_torch_swap.py runs it (its jnp path and its Pallas
kernels in interpret mode): the scatters bitwise; scales within rtol 1e-6
(XLA may divide by 127 as a multiply by the reciprocal, an ulp away), and
INT8 codes exactly wherever the two scales agree bitwise and within one
step where they do not.  Each model asserts that every (layer, page) of its
output is covered once and that each stage holds the item it is read as.

The CUDA kernels themselves need nvcc and a card; ``chip_smoke.py`` phase 4
holds them bitwise against the plain versions on the GPU.
"""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import swap as jswap
from repro_torch.kernels import native
from repro_torch.kernels import swap as tswap

CSRC = Path(native.__file__).resolve().parent / "csrc"
SCATTER_SRC = (CSRC / "swap_scatter_pages.cu").read_text()
GATHER_Q8_SRC = (CSRC / "swap_gather_pages_q8.cu").read_text()
SCATTER_Q8_SRC = (CSRC / "swap_scatter_pages_q8.cu").read_text()


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


CHUNK_BYTES = _constant(SCATTER_SRC, "kChunkBytes")
SCATTER_STAGES = _constant(SCATTER_SRC, "kStages")
SCATTER_CTAS_PER_SM = _constant(SCATTER_SRC, "kCtasPerSm")
Q8_THREADS = _constant(GATHER_Q8_SRC, "kQ8Threads")
STAGE_BYTES = _constant(GATHER_Q8_SRC, "kStageBytes")
Q8_STAGES = _constant(GATHER_Q8_SRC, "kStages")
MAX_STAGE_BYTES = _constant(GATHER_Q8_SRC, "kMaxStageBytes")
Q8_CTAS_PER_SM = _constant(GATHER_Q8_SRC, "kCtasPerSm")
Q8_HEAD_BLOCK = _constant(GATHER_Q8_SRC, "kHeadBlock")
TWO_PASS_THREADS = _constant((CSRC / "swap_pages_common.cuh").read_text(),
                             "kThreads")
Q8S_CHUNK_CODES = _constant(SCATTER_Q8_SRC, "kChunkCodes")
Q8S_STAGES = _constant(SCATTER_Q8_SRC, "kStages")
Q8S_CONSUMERS = 32 * _constant(SCATTER_Q8_SRC, "kConsumerWarps")
Q8S_CTAS_PER_SM = _constant(SCATTER_Q8_SRC, "kCtasPerSm")
Q8S_HEADER_BYTES = _constant(SCATTER_Q8_SRC, "kHeaderBytes")
MAX_SMEM_PER_CTA = 232448        # an H100 CTA's shared memory limit
SMEM_PER_SM = 233472             # an H100 SM's shared memory
H100_SMS = 132
# CTAs of the persistent grid: one, a few, and as many as an H100 runs at
# once (kCtasPerSm on each SM; fewer where the items run out)
GRIDS = {"1cta": lambda n_items, per_sm: 1,
         "5ctas": lambda n_items, per_sm: min(n_items, 5),
         "h100": lambda n_items, per_sm: min(n_items, H100_SMS * per_sm)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
N_PHYS = 9                       # page 8 is the sink
# a run of three equal real ids and a tail of three sink ids (the engine's
# padding)
IDS = np.array([7, 2, 2, 2, 5, 8, 8, 8], np.int32)
LAST_OF_RUN = {7: 0, 2: 3, 5: 4, 8: 7}    # page -> the item that must win


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(rng, shape, dtype):
    """numpy f32 values exactly representable in ``dtype``, and the same
    values as a torch CPU tensor of ``dtype``."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3.0)
    t = x.to(DTYPES[dtype][0])
    return t.float().numpy(), t


def _bytes(t):
    """A contiguous torch tensor's bytes as a numpy uint8 array, one row per
    (layer, page)."""
    L, n = t.shape[:2]
    return t.contiguous().view(torch.uint8).numpy().reshape(L, n, -1).copy()


# -- the scatter's walk ------------------------------------------------------------
def scatter_model(pool, ids, staged, grid):
    """``csrc/swap_scatter_pages.cu`` on ``pool`` (uint8, (L, n_phys,
    page_bytes), updated in place) from ``staged`` (uint8, (L, n,
    page_bytes)) with the grid ``grid(n_items, kCtasPerSm)``: every CTA's
    elected thread, one after the other (distinct written items touch
    distinct bytes).  Returns the (layer, page, offset) of every chunk
    written."""
    L, n_phys, page_bytes = pool.shape
    n = len(ids)
    n_chunks = -(-page_bytes // CHUNK_BYTES)
    n_items = L * n * n_chunks
    grid = grid(n_items, SCATTER_CTAS_PER_SM)
    S = SCATTER_STAGES

    def writes(w):
        i = (w // n_chunks) % n
        return i + 1 == n or ids[i + 1] != ids[i]

    def next_item(w):
        while w < n_items and not writes(w):
            w += grid
        return w

    def chunk_of(w):
        page, c = divmod(w, n_chunks)
        l, i = divmod(page, n)
        off = c * CHUNK_BYTES
        return l, i, int(ids[i]), off, min(CHUNK_BYTES, page_bytes - off)

    written = []
    for b in range(grid):
        ring = np.zeros((S, CHUNK_BYTES), np.uint8)
        held, landed = [None] * S, [0] * S   # item in a stage, phases done
        reading = []                         # stages a store may still read

        def load(w, s):
            assert s not in reading, "refilled a stage a store still reads"
            l, i, _, off, nb = chunk_of(w)
            assert 0 < nb <= CHUNK_BYTES and nb % 16 == 0
            ring[s, :nb] = staged[l, i, off:off + nb]
            held[s] = w
            landed[s] += 1

        w_load = next_item(b)
        w_store, k_load = w_load, 0
        while k_load < S - 1 and w_load < n_items:
            load(w_load, k_load)
            k_load += 1
            w_load = next_item(w_load + grid)
        k = 0
        while w_store < n_items:
            s = k % S
            # mbar_wait(parity (k / S) & 1): the stage's (k / S)-th load
            # has landed, and it holds this item
            assert landed[s] == k // S + 1 and held[s] == w_store
            l, _, pid, off, nb = chunk_of(w_store)
            pool[l, pid, off:off + nb] = ring[s, :nb]
            written.append((l, pid, off))
            reading.append(s)                # bulk_store + commit
            w_store = next_item(w_store + grid)
            if w_load < n_items:
                reading = reading[-1:]       # wait_group.read 1
                load(w_load, k_load % S)
                k_load += 1
                w_load = next_item(w_load + grid)
            k += 1
    return written


SCATTER_SHAPES = {
    # (page_size, H, hd): bf16 / f32 page bytes, against 8 KiB chunks
    "H1": (16, 1, 16),        # 512 B / 1 KiB: smaller than a chunk
    "H2": (16, 2, 16),        # 1 / 2 KiB
    "H16": (16, 16, 16),      # 8 KiB (one chunk) / 16 KiB (two)
    "H32": (16, 32, 64),      # 64 KiB (the fused serve pool) / 128 KiB
}


def _scatter_case(rng, shape, dtype, grid):
    ps, H, hd = shape
    pages_np, pages = _values(rng, (2, N_PHYS, ps, H, hd), dtype)
    staged_np, staged = _values(rng, (2, len(IDS), ps, H, hd), dtype)
    pool = _bytes(pages)
    written = scatter_model(pool, IDS, _bytes(staged), GRIDS[grid])
    got = torch.from_numpy(pool.reshape(-1)).view(pages.dtype).reshape(
        pages.shape)
    return pages, staged, got, written


def _check_scatter_walk(pages, written, page_bytes):
    """Only the last id of each run writes, each of its chunks exactly once;
    the bytes moved are the bound's (each distinct target page once)."""
    L = pages.shape[0]
    want = {(l, p, c * CHUNK_BYTES) for l in range(L) for p in set(IDS.tolist())
            for c in range(-(-page_bytes // CHUNK_BYTES))}
    assert len(written) == len(set(written)) and set(written) == want


@pytest.mark.parametrize("grid", ["1cta", "h100"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SCATTER_SHAPES))
def test_scatter_model_matches_plain_and_jax(rng, shape, dtype, grid):
    pages, staged, got, written = _scatter_case(
        rng, SCATTER_SHAPES[shape], dtype, grid)
    page_bytes = pages[0, 0].numel() * pages.element_size()
    _check_scatter_walk(pages, written, page_bytes)
    # the last staged row of each run in its page, nothing outside the ids
    for page, item in LAST_OF_RUN.items():
        assert torch.equal(got[:, page].view(torch.uint8),
                           staged[:, item].view(torch.uint8))
    outside = [p for p in range(N_PHYS) if p not in LAST_OF_RUN]
    assert torch.equal(got[:, outside].view(torch.uint8),
                       pages[:, outside].view(torch.uint8))
    # the plain version on every page written once by it (a plain scatter of
    # repeated ids may leave any of their rows)
    plain = tswap.swap_scatter_pages(pages.clone(), torch.from_numpy(IDS),
                                     staged)
    once = [p for p in range(N_PHYS) if (IDS == p).sum() <= 1]
    assert torch.equal(got[:, once].view(torch.uint8),
                       plain[:, once].view(torch.uint8))
    # the JAX package, both paths: the whole pool, bitwise (its sequential
    # grid leaves the last of each run, and so does XLA's scatter here)
    jdt = DTYPES[dtype][1]
    jp = jnp.asarray(pages.float().numpy(), jdt)
    js = jnp.asarray(staged.float().numpy(), jdt)
    for use_pallas in (False, True):
        want = jswap.swap_scatter_pages(jnp.array(jp), jnp.asarray(IDS), js,
                                        use_pallas=use_pallas, interpret=True)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("shape", [(16, 64, 128), (16, 2, 2048)],
                         ids=["512KiB", "tall_head"])
def test_scatter_model_chunks_large_pages(rng, shape, grid):
    """f32 pages of 512 KiB and 256 KiB (more chunks than stages): every
    chunk of every written page once, the last of each run, pages outside
    untouched."""
    pages, staged, got, written = _scatter_case(rng, shape, "float32", grid)
    page_bytes = pages[0, 0].numel() * 4
    assert page_bytes // CHUNK_BYTES > SCATTER_STAGES
    _check_scatter_walk(pages, written, page_bytes)
    for page, item in LAST_OF_RUN.items():
        assert torch.equal(got[:, page], staged[:, item])
    outside = [p for p in range(N_PHYS) if p not in LAST_OF_RUN]
    assert torch.equal(got[:, outside], pages[:, outside])


def test_scatter_model_skips_repeated_ids_only():
    """Adjacent equal ids: only the last of the run writes.  Equal ids that
    are not neighbours both write (in no set order on the card)."""
    pool = np.zeros((1, 4, 16), np.uint8)
    staged = np.arange(6 * 16, dtype=np.uint8).reshape(1, 6, 16)
    ids = np.array([1, 1, 2, 1, 3, 3], np.int32)
    written = scatter_model(pool, ids, staged, GRIDS["1cta"])
    assert sorted(written) == [(0, 1, 0), (0, 1, 0), (0, 2, 0), (0, 3, 0)]
    assert (pool[0, 3] == staged[0, 5]).all() and (pool[0, 2] == staged[0, 2]).all()


# -- the INT8 scatter's walk -------------------------------------------------------
def q8_scatter_plan(ps, H, hd, esz):
    """What ``launch`` in csrc/swap_scatter_pages_q8.cu sets up: a page's
    chunks, the scale slots a stage holds at most, and a stage's layout (a
    header, the codes with room for a 16-byte misalignment, the slots)."""
    kvec = 16 // esz
    vpr = hd // kvec
    page_elems = ps * H * hd
    rows = (Q8S_CHUNK_CODES // kvec + vpr - 2) // vpr + 1
    max_slots = min(H, rows)
    scale_off = Q8S_HEADER_BYTES + Q8S_CHUNK_CODES + 16
    return dict(kvec=kvec, vpr=vpr, page_elems=page_elems,
                n_chunks=-(-page_elems // Q8S_CHUNK_CODES),
                max_slots=max_slots, scale_off=scale_off,
                stage=-(-(scale_off + 4 * max_slots) // 128) * 128)


@functools.lru_cache(maxsize=None)
def q8_walk(col0, nv, vpr, H):
    """Every consumer thread's (vector, slot) pairs over a chunk of ``nv``
    output vectors whose first is column ``col0`` of its head row, stepped
    as the kernel steps them: one divide and one modulo a chunk, then
    ``kConsumerThreads`` vectors a step with the slot carried along."""
    dr, dc = divmod(Q8S_CONSUMERS, vpr)
    dk = dr % H
    vs, ks = [], []
    for t in range(Q8S_CONSUMERS):
        c = col0 + t
        r = c // vpr
        c -= r * vpr
        k = r % H
        for v in range(t, nv, Q8S_CONSUMERS):
            vs.append(v)
            ks.append(k)
            c += dc
            k += dk
            if c >= vpr:
                c -= vpr
                k += 1
            if k >= H:
                k -= H
            assert 0 <= k < H                 # one subtraction suffices
    return np.array(vs, np.int64), np.array(ks, np.int64)


def scatter_q8_model(pages, ids, q, scales, grid):
    """``csrc/swap_scatter_pages_q8.cu`` on ``pages`` (a contiguous torch CPU
    tensor of the pool's dtype, updated in place) from ``q`` (int8, (L, n,
    page_size, H, hd), its base 16-byte aligned as the wrapper requires) and
    ``scales`` (f32, (L, n, 1, H, 1)) with the grid ``grid(n_items,
    kCtasPerSm)``: every CTA's producer warp filling its ring as far as the
    stages' empty mbarriers let it, and its consumer warps taking each
    stage once its full mbarrier's phase has completed.  Returns the
    (layer, page, chunk) of every chunk written, and asserts that each
    stage holds the chunk it is read as, that every copy is aligned as its
    kind needs, that every vector of a chunk is stored once, and that each
    vector's slot holds its head's scale."""
    L, n_phys, ps, H, hd = pages.shape
    n = len(ids)
    p = q8_scatter_plan(ps, H, hd, pages.element_size())
    kvec, vpr, page_elems = p["kvec"], p["vpr"], p["page_elems"]
    n_chunks, scale_off = p["n_chunks"], p["scale_off"]
    n_items = L * n * n_chunks
    grid = grid(n_items, Q8S_CTAS_PER_SM)
    S, hb = Q8S_STAGES, Q8S_HEADER_BYTES
    codes_in = q.contiguous().view(-1).numpy().view(np.uint8)
    scales_in = scales.contiguous().view(-1).numpy()
    out = pages.view(-1)
    written = []

    def writes(w):
        i = (w // n_chunks) % n
        return i + 1 == n or ids[i + 1] != ids[i]

    def items(b):
        """CTA b's writing items in the order its producer warp fills them:
        the lanes evaluate items w0 + lane * grid, 32 at a time, and the
        warp takes the writers among them in lane order."""
        for w0 in range(b, n_items, 32 * grid):
            lanes = [w0 + j * grid for j in range(32) if w0 + j * grid < n_items]
            yield from (w for w in lanes if writes(w))

    def fill(ring, s, w):
        """The producer warp's copies of item w into stage s; returns the
        header and the head each slot's scale belongs to."""
        page, c = divmod(w, n_chunks)
        l, i = divmod(page, n)
        e0 = c * Q8S_CHUNK_CODES
        nb = min(Q8S_CHUNK_CODES, page_elems - e0)
        src = page * page_elems + e0            # the base is 16-byte aligned
        shift = src % 16
        head = min(nb, (16 - shift) % 16)
        body = (nb - head) // 16 * 16
        tail = nb - head - body
        codes = hb + shift
        assert shift % kvec == 0 and head % kvec == 0 and tail % kvec == 0
        assert codes + nb <= scale_off
        if body:                                # lane 0: cp.async.bulk
            assert (src + head) % 16 == 0 and (codes + head) % 16 == 0
            ring[s, codes + head:codes + head + body] = \
                codes_in[src + head:src + head + body]
        pieces = [j * kvec for j in range(head // kvec)] + \
            [head + body + j * kvec for j in range(tail // kvec)]
        assert len(pieces) <= 32                # a lane each
        for o in pieces:                        # cp.async of kVec bytes
            ring[s, codes + o:codes + o + kvec] = codes_in[src + o:src + o + kvec]
        col0 = (e0 // kvec) % vpr
        nv = nb // kvec
        n_slots = min(H, (col0 + nv - 1) // vpr + 1)
        assert n_slots <= p["max_slots"]
        assert scale_off + 4 * n_slots <= p["stage"]
        heads = (e0 // hd) % H + np.arange(n_slots)
        heads[heads >= H] -= H                  # lanes k, k + 32, ...
        ring[s, scale_off:scale_off + 4 * n_slots] = \
            scales_in[page * H + heads].view(np.uint8)
        dst = (l * n_phys + int(ids[i])) * page_elems + e0
        return (dst, nv, col0, shift, e0, (l, int(ids[i]), c)), heads

    for b in range(grid):
        ring = np.zeros((S, p["stage"]), np.uint8)
        header, slot_heads = [None] * S, [None] * S
        full_done, empty_done = [0] * S, [0] * S
        todo, f_prod, f_cons, producing = items(b), 0, 0, True
        while True:
            # the producer fills stage f % kStages once its empty mbarrier's
            # phase f / kStages - 1 has completed
            while producing and (f_prod < S
                                 or empty_done[f_prod % S] >= f_prod // S):
                s = f_prod % S
                assert f_prod < S or empty_done[s] == f_prod // S
                w = next(todo, None)
                if w is None:
                    header[s], producing = None, False    # nv = -1
                else:
                    header[s], slot_heads[s] = fill(ring, s, w)
                full_done[s] += 1
                f_prod += 1
            # the consumers wait for full phase f / kStages of stage s
            s = f_cons % S
            assert full_done[s] == f_cons // S + 1
            if header[s] is None:
                break
            dst, nv, col0, shift, e0, where = header[s]
            written.append(where)
            vs, ks = q8_walk(col0, nv, vpr, H)
            assert np.array_equal(np.sort(vs), np.arange(nv))
            assert (ks < len(slot_heads[s])).all()
            # each vector's slot holds the scale of the vector's head
            assert np.array_equal(slot_heads[s][ks],
                                  ((e0 + vs * kvec) // hd) % H)
            codes = ring[s, hb + shift:hb + shift + nv * kvec].view(np.int8)
            slots = ring[s, scale_off:scale_off + 4 * len(slot_heads[s])]
            prod = (codes.reshape(nv, kvec)[vs].astype(np.float32)
                    * slots.view(np.float32)[ks][:, None])
            at = dst + vs[:, None] * kvec + np.arange(kvec)
            out[torch.from_numpy(at.reshape(-1))] = \
                torch.from_numpy(prod.reshape(-1)).to(pages.dtype)
            empty_done[s] += 1                  # each consumer warp arrives
            f_cons += 1
    return written


def _bits(x):
    """A float tensor's or array's bits as a numpy integer array."""
    if isinstance(x, torch.Tensor):
        return x.view({2: torch.int16, 4: torch.int32}[x.element_size()]).numpy()
    return np.asarray(x).view({2: np.int16, 4: np.int32}[np.asarray(x).itemsize])


def _check_scatter_q8(rng, shape, dtype, grid):
    """The model on ids with a run of three equal real ids and a tail of
    three sink ids (``IDS``), from codes and scales quantized by the plain
    gather of random pages, one head of staged item 3 all zero (scale 0)."""
    ps, H, hd = shape
    _, pages = _values(rng, (2, N_PHYS, ps, H, hd), dtype)
    _, src = _values(rng, (2, len(IDS), ps, H, hd), dtype)
    src[:, 3, :, H - 1] = 0
    q, scales = tswap.swap_gather_pages_q8_plain(
        src, torch.arange(len(IDS), dtype=torch.int32))
    assert (scales[:, 3, 0, H - 1, 0] == 0).all()
    got = pages.clone()
    written = scatter_q8_model(got, IDS, q, scales, GRIDS[grid])
    # only the last id of each run writes, each of its chunks exactly once
    n_chunks = q8_scatter_plan(ps, H, hd, pages.element_size())["n_chunks"]
    want = {(l, pg, c) for l in range(2) for pg in LAST_OF_RUN
            for c in range(n_chunks)}
    assert len(written) == len(set(written)) and set(written) == want
    deq = tswap.dequantize_pages(q, scales, pages.dtype)
    for page, item in LAST_OF_RUN.items():
        np.testing.assert_array_equal(_bits(got[:, page]), _bits(deq[:, item]))
    assert not got[:, 2, :, H - 1].float().any()         # the zero head
    outside = [pg for pg in range(N_PHYS) if pg not in LAST_OF_RUN]
    np.testing.assert_array_equal(_bits(got[:, outside]), _bits(pages[:, outside]))
    # the plain version on every page written once by it
    plain = tswap.swap_scatter_pages_q8(pages.clone(), torch.from_numpy(IDS),
                                        q, scales)
    once = [pg for pg in range(N_PHYS) if (IDS == pg).sum() <= 1]
    np.testing.assert_array_equal(_bits(got[:, once]), _bits(plain[:, once]))
    # the JAX package, both paths: the whole pool, bitwise (its sequential
    # grid leaves the last of each run, and so does XLA's scatter here)
    jp = jnp.asarray(pages.float().numpy(), DTYPES[dtype][1])
    jq, js = jnp.asarray(q.numpy()), jnp.asarray(scales.numpy())
    for use_pallas in (False, True):
        want = jswap.swap_scatter_pages_q8(jnp.array(jp), jnp.asarray(IDS), jq,
                                           js, use_pallas=use_pallas,
                                           interpret=True)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SCATTER_SHAPES))
def test_scatter_q8_model_matches_plain_and_jax(rng, shape, dtype, grid):
    _check_scatter_q8(rng, SCATTER_SHAPES[shape], dtype, grid)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("case", [
    ("float32", (16, 64, 128)),   # 512 KiB pages: 32 chunks, 8 head rows each
    ("float32", (4, 300, 12)),    # 300 heads: slots wrap mod H, chunks start
                                  # mid-row (4096 codes are not whole rows of 12)
    ("bfloat16", (2, 300, 8)),    # 300 heads of one 16-byte vector a row:
                                  # a slot for every vector, wrapping mod H
    ("float32", (3, 3, 4)),       # 36 codes a page: codes off a 16-byte
    ("bfloat16", (1, 3, 8)),      # boundary, copied as 4- or 8-byte ends
], ids=["512KiB", "300heads", "300heads_bf16", "unaligned_f32",
        "unaligned_bf16"])
def test_scatter_q8_model_edges(rng, case, grid):
    dtype, shape = case
    plan = q8_scatter_plan(*shape, 4 if dtype == "float32" else 2)
    if shape[1] > 256:
        assert plan["max_slots"] == shape[1]
    _check_scatter_q8(rng, shape, dtype, grid)


def test_q8_walk_slots_follow_heads():
    """The division-free walk's slot equals (head row of the vector) mod H
    for column offsets, head widths and head counts around the step's
    wrap points."""
    for vpr in (1, 2, 3, 7, 8, 16, 255, 256, 257, 600):
        for H in (1, 2, 3, 16, 300):
            for col0 in {0, 1, vpr - 1}:
                nv = 3 * Q8S_CONSUMERS + 5
                vs, ks = q8_walk(col0, nv, vpr, H)
                np.testing.assert_array_equal(ks, ((col0 + vs) // vpr) % H)


# -- the INT8 gather's walk ------------------------------------------------------
def q8_plan(ps, H, hd, esz):
    """What ``launch`` in csrc/swap_gather_pages_q8.cu picks: None for the
    two-pass kernel (a head's rows over kMaxStageBytes), else the head
    block, the stage's bytes and the codes per store."""
    col = ps * hd * esz
    if col == 0 or col > MAX_STAGE_BYTES:
        return None
    h_blk = min(H, max(1, STAGE_BYTES // col))
    return dict(h_blk=h_blk, n_hblk=-(-H // h_blk), stage=h_blk * col,
                codes=16 if hd % 16 == 0 else 16 // esz)


def walk(lane, per_row, rows):
    """The cells (row, column) that ``Walk`` gives ``lane``: cell lane, lane
    + 32, ... of ``per_row`` cells a row, stepped as the kernel steps it."""
    r, c = divmod(lane, per_row)
    dr, dc = divmod(32, per_row)
    cells = []
    while r < rows:
        cells.append((r, c))
        c += dc
        r += dr
        if c >= per_row:
            c -= per_row
            r += 1
    return cells


def gather_q8_model(pages, ids, esz, grid):
    """``csrc/swap_gather_pages_q8.cu`` on ``pages`` (f32 numpy, the values
    of the pool's dtype) with the grid ``grid(n_items, kCtasPerSm)``: every
    CTA's walk over its items, its ring (kStages - 1 loads ahead, each
    issued as the item before it lands, into the stage the previous item
    left), and a warp per head with its lanes on the cells of ``walk``.
    Returns (q, scales) and asserts that every code and scale is written
    exactly once, that each stage holds the item it is read as and is not
    refilled while read, that each (layer, page, head block) is loaded once,
    and that each store is aligned."""
    L, n_phys, ps, H, hd = pages.shape
    n = len(ids)
    plan = q8_plan(ps, H, hd, esz)
    h_blk, n_hblk, codes = plan["h_blk"], plan["n_hblk"], plan["codes"]
    n_items = L * n * n_hblk
    grid = grid(n_items, Q8_CTAS_PER_SM)
    S, kvec = Q8_STAGES, 16 // esz
    page_elems = ps * H * hd
    q = np.zeros(L * n * page_elems, np.int8)
    q_writes = np.zeros(q.size, np.int64)
    scales = np.zeros(L * n * H, np.float32)
    s_writes = np.zeros(scales.size, np.int64)
    loaded = np.zeros(n_items, np.int64)
    lanes = np.arange(32)
    vec_cells = [walk(lane, hd // kvec, ps) for lane in range(32)]
    group_cells = np.array([rc for lane in range(32)
                            for rc in walk(lane, hd // codes, ps)])

    def item_of(w):
        page, hb = divmod(w, n_hblk)
        h0 = hb * h_blk
        return page, page % n, h0, min(h_blk, H - h0)

    for b in range(grid):
        ring, held, landed = [None] * S, [None] * S, [0] * S
        reading = None                     # the stage being quantized

        def load(w, s):
            assert s != reading, "refilled the stage being read"
            page, i, h0, nh = item_of(w)
            rows = pages[page // n, ids[i], :, h0:h0 + nh, :]   # ps row copies
            assert rows.size * esz <= plan["stage"]
            ring[s] = rows.reshape(-1).copy()
            held[s] = w
            landed[s] += 1
            loaded[w] += 1

        for s in range(S - 1):
            if b + s * grid < n_items:
                load(b + s * grid, s)
        for k, w in enumerate(range(b, n_items, grid)):
            s = k % S
            assert landed[s] == k // S + 1 and held[s] == w
            reading = s
            if w + (S - 1) * grid < n_items:      # the next load, as k lands
                load(w + (S - 1) * grid, (k + S - 1) % S)
            page, _, h0, nh = item_of(w)
            tile, row_elems = ring[s], nh * hd
            for hl in range(nh):            # warp hl % kWarps takes head hl
                lane_max = np.zeros(32, np.float32)
                for lane in range(32):
                    for r, c in vec_cells[lane]:
                        at = r * row_elems + hl * hd + c * kvec
                        lane_max[lane] = max(lane_max[lane],
                                             np.abs(tile[at:at + kvec]).max())
                for off in (16, 8, 4, 2, 1):          # __shfl_xor_sync
                    lane_max = np.maximum(lane_max, lane_max[lanes ^ off])
                assert (lane_max == lane_max[0]).all()
                scale = lane_max[0] / np.float32(127)
                safe = scale if scale > 0 else np.float32(1)
                scales[page * H + h0 + hl] = scale
                s_writes[page * H + h0 + hl] += 1
                r, c = group_cells[:, 0], group_cells[:, 1]
                src = r * row_elems + hl * hd + c * codes
                y = tile[src[:, None] + np.arange(codes)] / safe
                # the kernel clips, then rounds half to even in the
                # conversion; the plain version rounds, then clips
                code = np.rint(np.fmin(np.fmax(y, -127), 127)).astype(np.int8)
                dst = page * page_elems + r * H * hd + (h0 + hl) * hd + c * codes
                assert (dst % codes == 0).all()       # aligned stores
                at = dst[:, None] + np.arange(codes)
                q[at] = code
                np.add.at(q_writes, at, 1)
            reading = None                            # __syncthreads
    assert (q_writes == 1).all() and (s_writes == 1).all()
    assert (loaded == 1).all()
    return q.reshape(L, n, ps, H, hd), scales.reshape(L, n, 1, H, 1)


def gather_q8_two_pass_model(pages, ids, esz):
    """``gather_q8_two_pass_kernel`` on ``pages`` (f32 numpy, the values of
    the pool's dtype): a CTA per (page, block of kHeadBlock heads, layer),
    its kThreads threads on the block's 16-byte vectors t, t + kThreads,
    ... of each token row's part; pass 1 folds each thread's running
    per-head max into the head's shared slot (atomicMax on the float's
    bits), pass 2 writes each vector's codes.  Returns (q, scales) and
    asserts that every code and scale is written once, each by the CTA of
    its head block, and that no slot outside the block's ``nh`` heads is
    touched."""
    L, n_phys, ps, H, hd = pages.shape
    n = len(ids)
    kvec = 16 // esz
    head_vecs = hd // kvec
    n_hblk = -(-H // Q8_HEAD_BLOCK)
    flat = pages.reshape(L, n_phys, -1)
    q = np.zeros((L, n, ps * H * hd), np.int8)
    q_writes = np.zeros(q.shape, np.int64)
    scales = np.zeros((L, n, H), np.float32)
    s_writes = np.zeros(scales.shape, np.int64)
    for l in range(L):
        for x in range(n * n_hblk):             # blockIdx.x
            i, hb = divmod(x, n_hblk)
            h0 = hb * Q8_HEAD_BLOCK
            nh = min(Q8_HEAD_BLOCK, H - h0)
            blk_vecs = nh * head_vecs
            v = np.arange(ps * blk_vecs)
            s_, c = v // blk_vecs, v % blk_vecs
            src_vec = s_ * (H * head_vecs) + h0 * head_vecs + c
            vals = flat[l, ids[i]][src_vec[:, None] * kvec + np.arange(kvec)]
            head = c // head_vecs                 # local head of each vector
            assert head.max() < nh
            amax = np.zeros(Q8_HEAD_BLOCK, np.uint32)
            for t in range(TWO_PASS_THREADS):    # pass 1, thread by thread
                mine = v[t::TWO_PASS_THREADS]
                for h in np.unique(head[mine]):
                    m = np.abs(vals[mine[head[mine] == h]]).max()
                    amax[h] = max(amax[h], np.float32(m).view(np.uint32))
            scale = amax[:nh].view(np.float32) / np.float32(127)
            scales[l, i, h0:h0 + nh] = scale
            s_writes[l, i, h0:h0 + nh] += 1
            safe = np.where(scale > 0, scale, np.float32(1))[head]
            y = vals / safe[:, None]
            code = np.rint(np.fmin(np.fmax(y, -127), 127)).astype(np.int8)
            at = src_vec[:, None] * kvec + np.arange(kvec)
            q[l, i][at] = code
            np.add.at(q_writes[l, i], at, 1)
    assert (q_writes == 1).all() and (s_writes == 1).all()
    return q.reshape(L, n, ps, H, hd), scales.reshape(L, n, 1, H, 1)


@pytest.mark.parametrize("case", [
    ("float32", (2, 300, 4)),     # two head blocks: 256 + 44
    ("bfloat16", (2, 600, 8)),    # three: 256 + 256 + 88
    ("float32", (1, 256, 4)),     # exactly one
    ("float32", (16, 2, 2048)),   # chip_smoke.py's tall head, one block
], ids=["300heads", "600heads_bf16", "256heads", "tall_head"])
def test_gather_q8_two_pass_model_matches_plain_and_jax(rng, case):
    """The two-pass kernel's walk, which shapes whose head exceeds
    kMaxStageBytes take (at any H: chip_smoke.py runs 260 heads of 128 KiB
    on the card), bitwise against the plain version and against
    ``repro``'s jnp and interpret-mode Pallas kernels, at head counts over
    one block of kHeadBlock."""
    dtype, shape = case
    pages_np, pages = _q8_pool(rng, shape, dtype)
    esz = pages.element_size()
    q, scales = gather_q8_two_pass_model(pages_np, Q8_IDS, esz)
    _check_q8_result(q, scales, pages_np, pages, dtype, jax_too=True)


def _q8_pool(rng, shape, dtype):
    pages_np, pages = _values(rng, (2, N_PHYS) + shape, dtype)
    pages_np[:, 5] = 0.0                          # an all-zero page
    pages_np[:, 2, :, shape[1] - 1] = 0.0         # an all-zero head
    pages = torch.from_numpy(pages_np).to(DTYPES[dtype][0])
    return pages_np, pages


Q8_IDS = np.array([7, 2, 5, 5, 1, 8, 8, 8], np.int32)


def _check_q8(pages_np, pages, dtype, grid, jax_too):
    esz = pages.element_size()
    q, scales = gather_q8_model(pages_np, Q8_IDS, esz, GRIDS[grid])
    _check_q8_result(q, scales, pages_np, pages, dtype, jax_too)


def _check_q8_result(q, scales, pages_np, pages, dtype, jax_too):
    tq, ts = tswap.swap_gather_pages_q8(pages, torch.from_numpy(Q8_IDS))
    np.testing.assert_array_equal(q, tq.numpy())
    np.testing.assert_array_equal(scales.view(np.int32),
                                  ts.numpy().view(np.int32))
    assert (scales[:, 2] == 0).all() and (scales[:, 1, :, -1] == 0).all()
    assert not q[:, 2].any() and not q[:, 1, :, -1].any()
    if jax_too:
        jp = jnp.asarray(pages_np, DTYPES[dtype][1])
        for use_pallas in (False, True):
            jq, js = jswap.swap_gather_pages_q8(jp, jnp.asarray(Q8_IDS),
                                                use_pallas=use_pallas,
                                                interpret=True)
            jq, js = np.asarray(jq), np.asarray(js)
            np.testing.assert_allclose(scales, js, rtol=1e-6)
            # codes exactly where the two scales agree bitwise; where XLA's
            # is an ulp away, a code on a rounding boundary may move a step
            same = np.broadcast_to(scales.view(np.int32) == js.view(np.int32),
                                   q.shape)
            np.testing.assert_array_equal(q[same], jq[same])
            assert np.abs(q.astype(np.int32) - jq).max() <= 1


@pytest.mark.parametrize("grid", ["1cta", "h100"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("H", [1, 2, 16, 32])
def test_gather_q8_model_matches_plain_and_jax(rng, H, dtype, grid):
    """hd 64, page 16: a page smaller than a stage (H 1 and 2), one stage
    long (H 16 bf16: the split serve page) and several (H 16 f32, H 32: the
    fused serve page)."""
    pages_np, pages = _q8_pool(rng, (16, H, 64), dtype)
    plan = q8_plan(16, H, 64, pages.element_size())
    page_bytes = 16 * H * 64 * pages.element_size()
    assert plan["n_hblk"] == -(-page_bytes // STAGE_BYTES)
    _check_q8(pages_np, pages, dtype, grid, jax_too=True)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("case", [
    ("float32", (16, 64, 128)),   # 512 KiB pages, 16 head blocks of 4
    ("float32", (16, 12, 64)),    # blocks of 8 and 4 heads
    ("float32", (16, 2, 1024)),   # one head (64 KiB) over a stage: per-row loads
    ("bfloat16", (8, 2, 8)),      # hd not a multiple of 16: 8 codes a store
    ("float32", (8, 3, 4)),       # 4 codes a store
], ids=["512KiB", "partial_block", "big_head", "codes8", "codes4"])
def test_gather_q8_model_edges(rng, case, grid):
    dtype, shape = case
    pages_np, pages = _q8_pool(rng, shape, dtype)
    _check_q8(pages_np, pages, dtype, grid, jax_too=shape[2] <= 64)


def test_quantize_clip_then_round_equals_round_then_clip():
    """The kernel's code, fmin(fmax(y, -127), 127) rounded half to even by
    the conversion, equals the plain version's clip(round(y)) at ties, the
    bounds, out of range and for NaN (fmaxf drops it: -127 either way)."""
    y = np.array([-np.inf, -1e9, -128.0, -127.5, -127.49, -127.0, -126.5,
                  -2.5, -1.5, -0.5, -0.0, 0.0, 0.5, 1.5, 2.5, 63.5, 126.5,
                  126.51, 127.0, 127.5, 128.0, 1e9, np.inf], np.float32)
    y = np.concatenate([y, np.random.default_rng(0).uniform(
        -200, 200, 10_000).astype(np.float32)])
    kernel = np.rint(np.fmin(np.fmax(y, -127), 127))
    plain = np.fmin(np.fmax(np.rint(y), -127), 127)
    np.testing.assert_array_equal(kernel, plain)
    assert np.rint(np.fmin(np.fmax(np.float32(np.nan), -127), 127)) == -127


@pytest.mark.parametrize("per_row", [1, 2, 3, 4, 8, 16, 31, 32, 33, 64, 70, 256])
def test_walk_visits_each_cell_once(per_row):
    """``Walk``'s division-free steps visit cells lane, lane + 32, ... in
    row-major order: every cell of the rows once, over the 32 lanes."""
    rows = 5
    seen = [rc for lane in range(32) for rc in walk(lane, per_row, rows)]
    assert sorted(seen) == [(r, c) for r in range(rows) for c in range(per_row)]
    for lane in range(32):
        want = [divmod(v, per_row) for v in range(lane, rows * per_row, 32)]
        assert walk(lane, per_row, rows) == want


def test_q8_plan_bounds_shared_memory():
    """A stage stays bounded whatever H is; a head whose rows exceed
    kMaxStageBytes takes the two-pass kernel; the ring fits a CTA's shared
    memory, and the scatter's ring fits kCtasPerSm CTAs on an SM."""
    for ps, H, hd, esz in ((16, 256, 128, 4), (16, 16, 64, 2), (16, 1, 1152, 4),
                           (16, 256, 8, 2)):
        plan = q8_plan(ps, H, hd, esz)
        assert plan["stage"] <= max(STAGE_BYTES, ps * hd * esz)
        assert Q8_STAGES * plan["stage"] + 4 * 256 + 64 <= MAX_SMEM_PER_CTA
        assert Q8_STAGES * MAX_STAGE_BYTES + 4 * 256 + 64 <= MAX_SMEM_PER_CTA
    assert q8_plan(16, 2, 2048, 4) is None          # chip_smoke.py's tall head
    assert q8_plan(16, 260, 2048, 4) is None        # and its 260 heads of it
    assert -(-260 // Q8_HEAD_BLOCK) == 2            # two blocks of heads
    assert q8_plan(16, 2, 1152, 4) is not None
    assert q8_plan(16, 64, 128, 4)["n_hblk"] == 16  # chip_smoke.py's 512 KiB
    assert (SCATTER_CTAS_PER_SM * (SCATTER_STAGES * CHUNK_BYTES + 1024 + 64)
            <= SMEM_PER_SM)
    assert Q8_THREADS % 32 == 0 and CHUNK_BYTES % 16 == 0


def test_scatter_q8_plan_bounds_shared_memory():
    """The INT8 scatter's stage stays bounded whatever H is (its scale slots
    are at most a chunk's head rows), kCtasPerSm CTAs fit on an SM at the
    serve pools, and the largest stage (f32, 16-byte heads: a slot for
    each of a chunk's 1,024 head rows) still fits a CTA."""
    serve = [q8_scatter_plan(16, H, 64, 2) for H in (16, 32)]
    for p in serve:
        assert p["max_slots"] <= 32 and p["n_chunks"] * Q8S_CHUNK_CODES == p["page_elems"]
        assert Q8S_CTAS_PER_SM * (Q8S_STAGES * p["stage"] + 1024 + 128) <= SMEM_PER_SM
    worst = max((q8_scatter_plan(16, H, hd, esz) for H in (1, 300, 4096, 65536)
                 for hd, esz in ((4, 4), (8, 2), (64, 2), (12, 4))),
                key=lambda p: p["stage"])
    assert worst["max_slots"] == Q8S_CHUNK_CODES // 4
    assert Q8S_STAGES * worst["stage"] + 128 <= MAX_SMEM_PER_CTA
    assert Q8S_CHUNK_CODES % 16 == 0 and Q8S_HEADER_BYTES % 16 == 0
