"""The model's weights, made by the benchmark from ``--seed`` on the device.

One generator on the device and one draw per kind of tensor, stacked over
the layers, in the dtype the model is served in; each layer's tensors are
views of those stacks.  Which stacks, their shapes, scales and dtypes, and
their order, are the model module's (``draws`` in ``bench/models/``); so
is the program's parameter dict over them (``as_params``).  The program
(``TorchEngine(params=...)``) and the plain reference get these same
tensors.  ``out`` refills an existing set in place, in the same order of
draws (a dozen seeds in one process, behind the same captured graphs).

Each draw is N(0, 1) times its scale; scale 0 marks a norm, drawn as
1 + N(0, 0.05^2) (not all ones, so that a norm weight that is read wrongly
shows).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch


def make_stacks(draws: Iterable[Tuple[str, Tuple[int, ...], float, torch.dtype]],
                seed: int, device,
                out: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """Every stack of ``draws`` (``(name, shape, scale, dtype)``, in draw
    order) drawn from ``seed``; into ``out``'s tensors when given."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    stacks = {} if out is None else out
    for name, shape, scale, dtype in draws:
        t = stacks.get(name)
        if t is None:
            t = torch.empty(shape, dtype=dtype, device=dev)
            stacks[name] = t
        t.normal_(0.0, 1.0, generator=gen)
        if scale:
            t.mul_(scale)
        else:
            t.mul_(0.05).add_(1.0)
    return stacks
