"""The window and censoring arithmetic of each end-to-end metric, on
hand-made token stamps (seconds on the serve clock; window [10, 20))."""
import pytest

from bench import endtoend as e
from bench.endtoend import Served

T0, T1 = 10.0, 20.0


def test_out_tokens_count_only_stamps_inside_the_window():
    reqs = [Served(due=9.0, max_new_tokens=4, stamps=[9.5, 10.0, 19.9, 20.0]),
            Served(due=12.0, max_new_tokens=2, stamps=[12.5, 13.0])]
    # the request due at 9.0 is the lead-in's: none of its tokens count
    assert e.out_tokens(reqs, T0, T1) == 2          # 12.5, 13.0
    assert e.compute(reqs, T0, T1)["out_tok_s"] == pytest.approx(0.2)


def test_out_tokens_never_rise_when_stamps_come_later():
    """A slower system delivers every token later; the count of the
    window's tokens can only fall, a lead-in request's included."""
    base = [Served(due=8.0, max_new_tokens=3, stamps=[9.0, 9.4, 9.8]),
            Served(due=9.5, max_new_tokens=3, stamps=[9.9, 10.3, 10.7]),
            Served(due=11.0, max_new_tokens=3, stamps=[11.5, 12.0, 12.5]),
            Served(due=18.0, max_new_tokens=4, stamps=[18.5, 19.0, 19.5, 19.9])]
    counts = [e.out_tokens([Served(r.due, r.max_new_tokens,
                                   [s + 0.25 * k for s in r.stamps])
                            for r in base], T0, T1) for k in range(12)]
    assert all(b <= a for a, b in zip(counts, counts[1:])), counts
    assert counts[0] == 7 and counts[-1] < counts[0]


def test_ttft_from_due_time_and_censored_at_the_end():
    reqs = [Served(due=9.0, max_new_tokens=1, stamps=[11.0]),    # due before
            Served(due=10.0, max_new_tokens=1, stamps=[10.25]),
            Served(due=15.0, max_new_tokens=1, stamps=[]),       # never came
            Served(due=19.0, max_new_tokens=1, stamps=[21.0])]   # after t1
    assert sorted(e.ttft_samples(reqs, T0, T1)) == pytest.approx([0.25, 1.0, 5.0])


def test_itl_takes_gaps_whose_later_stamp_is_inside():
    reqs = [Served(due=0.0, max_new_tokens=5, stamps=[9.0, 10.5, 11.0, 20.5]),
            Served(due=0.0, max_new_tokens=2, stamps=[12.0, 12.1])]
    assert sorted(e.itl_samples(reqs, T0, T1)) == pytest.approx([0.1, 0.5, 1.5])


def test_e2e_cohort_is_the_first_half_and_unfinished_enter_with_their_age():
    reqs = [Served(due=10.0, max_new_tokens=2, stamps=[11.0, 12.0]),   # 2.0
            Served(due=14.0, max_new_tokens=3, stamps=[15.0, 16.0]),   # 6.0
            Served(due=14.5, max_new_tokens=1, stamps=[20.5]),         # 5.5
            Served(due=15.0, max_new_tokens=1, stamps=[15.5]),         # not in
            Served(due=9.0, max_new_tokens=1, stamps=[10.5])]          # not in
    assert sorted(e.e2e_samples(reqs, T0, T1)) == pytest.approx([2.0, 5.5, 6.0])


def test_percentiles_are_numpys_linear_interpolation():
    xs = list(range(1, 21))                  # 1..20
    assert e.percentile(xs, 95) == pytest.approx(19.05)
    assert e.percentile(xs, 90) == pytest.approx(18.1)
    m = e.compute([Served(due=10.0 + i * 0.1, max_new_tokens=1,
                          stamps=[10.0 + i * 0.1 + (i + 1) * 0.01])
                   for i in range(20)], T0, T1)
    assert m["ttft_p95_ms"] == pytest.approx(190.5)
