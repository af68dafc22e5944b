"""The engine round as CUDA graphs: the port's counterpart of the JAX
engine's ``jax.jit(step)`` (``repro/engine/engine.py:266``), one graph per
chunk bucket, captured at warm-up or at a bucket's first round and replayed
from then on, so that a round costs one launch from the host instead of
one per op of every layer.

The kernel wrappers count their launches in Python (``fn.launches``,
raised where each calls its kernel), and a replay never runs that code.  So
a capture records how far each count moved while the round was recorded,
takes that back (a capture launches nothing), and every replay adds it
again: a count reads the same whether the rounds ran eagerly or replayed.
The paged attention wrappers also count their windowed launches
(``fn.windowed_launches``), kept as ``"<name>.windowed"``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.chunked_prefill_attention import (
    chunked_prefill_attention,
)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.fused_swiglu import fused_swiglu
from repro_torch.kernels.grouped_swiglu import grouped_down, grouped_gate_up
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_decode_attention_fused,
)
from repro_torch.kernels.paged_prefill_attention import (
    paged_prefill_attention, paged_prefill_attention_fused,
)
from repro_torch.kernels.swap import (
    swap_gather_pages, swap_gather_pages_q8, swap_scatter_pages,
    swap_scatter_pages_q8,
)

# every wrapper that counts its kernel's launches
COUNTED = (paged_decode_attention, paged_prefill_attention,
           paged_decode_attention_fused, paged_prefill_attention_fused,
           swap_gather_pages, swap_scatter_pages, swap_gather_pages_q8,
           swap_scatter_pages_q8, chunked_prefill_attention,
           decode_attention, fused_swiglu, grouped_gate_up, grouped_down)


# the wrappers that count their windowed launches apart
WINDOWED = (paged_decode_attention, paged_prefill_attention,
            paged_decode_attention_fused, paged_prefill_attention_fused)


def launch_counts() -> Dict[str, int]:
    counts = {fn.__name__: fn.launches for fn in COUNTED}
    counts.update({fn.__name__ + ".windowed": fn.windowed_launches
                   for fn in WINDOWED})
    return counts


def add_launches(deltas: Dict[str, int], sign: int = 1) -> None:
    for fn in COUNTED:
        fn.launches += sign * deltas.get(fn.__name__, 0)
    for fn in WINDOWED:
        fn.windowed_launches += sign * deltas.get(fn.__name__ + ".windowed", 0)


class RoundGraph:
    """One captured round: the graph, the tensors its replays write (the
    round's outputs, overwritten by the next replay of any graph of the
    engine's pool), and the launches of each counted kernel it holds."""

    def __init__(self, graph, outputs: Tuple[torch.Tensor, ...],
                 launches: Dict[str, int], capture_s: float = 0.0):
        self.graph = graph
        self.outputs = outputs
        self.launches = {n: c for n, c in launches.items() if c}
        self.capture_s = capture_s

    def replay(self) -> Tuple[torch.Tensor, ...]:
        """Enqueue the round on the current stream; its outputs."""
        self.graph.replay()
        add_launches(self.launches)
        return self.outputs


def capture(fn: Callable[[], Tuple[torch.Tensor, ...]], *, pool, stream,
            generator: Optional[torch.Generator] = None) -> RoundGraph:
    """Record ``fn()`` (every tensor it reads must outlive the graph, and
    every launch in it must be legal inside a capture) as a graph on
    ``stream`` in memory ``pool``.  ``generator``, when ``fn`` draws from
    it, is registered with the graph, so that each replay advances it and
    draws afresh.  A failure raises: there is no eager fallback."""
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        outputs = fn()
    capture_s = time.perf_counter() - t0
    after = launch_counts()
    launches = {n: after[n] - before[n] for n in after}
    add_launches(launches, -1)
    return RoundGraph(graph, outputs, launches, capture_s)
