"""Each traffic file gives the same requests for the same seed, and the
same work (sizes and due times) for every seed: a seed draws only the
prompt token ids."""
import json

import pytest

from bench import traffic_gen
from bench.tests.conftest import ROOT

MIXES = sorted(p.stem for p in (ROOT / "bench/traffic").glob("*.json"))


def _gen(mix, seed, seconds=20.0, rate=3.0):
    traffic = json.loads((ROOT / f"bench/traffic/{mix}.json").read_text())
    return traffic, traffic_gen.generate(traffic, rate, seconds, seed, 32000)


@pytest.mark.parametrize("mix", MIXES)
def test_reproducible_from_the_seed(mix):
    _, a = _gen(mix, 2**31 + 11)
    _, b = _gen(mix, 2**31 + 11)
    assert [(x.due_s, x.prompt, x.max_new_tokens, x.in_window) for x in a] == \
           [(x.due_s, x.prompt, x.max_new_tokens, x.in_window) for x in b]
    _, c = _gen(mix, 2**31 + 12)
    assert [x.prompt for x in a] != [x.prompt for x in c]


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_gets_the_same_work(mix):
    traffic, a = _gen(mix, 1)
    _, b = _gen(mix, 987654321)
    assert [(x.due_s, len(x.prompt), x.max_new_tokens, x.in_window) for x in a] \
        == [(x.due_s, len(x.prompt), x.max_new_tokens, x.in_window) for x in b]
    lead = traffic["lead_in_s"]
    for items in (a, b):
        assert all(0 <= x.due_s < lead for x in items if not x.in_window)
        assert all(lead <= x.due_s < lead + 20.0 for x in items if x.in_window)
        assert all(len(x.prompt) + x.max_new_tokens <= traffic["max_context"]
                   for x in items)
        assert all(1 <= t < 32000 for x in items for t in x.prompt)
    assert sum(x.in_window for x in a) == 60


def test_chat_is_the_papers_sharegpt_fit():
    import numpy as np
    traffic, items = _gen("chat", 5, seconds=2000.0, rate=5.0)
    p = np.array([len(x.prompt) for x in items])
    o = np.array([x.max_new_tokens for x in items])
    assert np.median(p) == pytest.approx(19, rel=0.1)
    assert np.percentile(p, 90) == pytest.approx(179.4, rel=0.1)
    assert np.median(o) == pytest.approx(60, rel=0.1)
    assert p.max() <= 512 and o.max() <= 512


@pytest.mark.parametrize("mix", MIXES)
def test_a_held_out_schedule_is_other_work_drawn_alike(mix):
    """``schedule_seed`` replaces the file's base_seed: other due times and
    sizes, reproducible, as many requests."""
    traffic = json.loads((ROOT / f"bench/traffic/{mix}.json").read_text())

    def work(sched):
        return [(x.due_s, len(x.prompt), x.max_new_tokens) for x in
                traffic_gen.generate(traffic, 3.0, 20.0, 1, 32000, sched)]
    base = work(None)
    assert work(traffic["base_seed"]) == base
    held = work(traffic["base_seed"] + 1)
    assert held == work(traffic["base_seed"] + 1) and held != base
    assert len(held) == len(base)
