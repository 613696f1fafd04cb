"""The traffic generator: a mix's sizes and arrivals are fixed by the mix,
its prompts and adapters by the seed, and the same seed gives the same
stream."""
import numpy as np
import pytest

from portbench import generate, spec
from repro_torch.serving.workload import zipf_pmf

MIXES = ["score-backlog", "poisson"]


def _mix(name):
    """A mix file, or (``poisson``) the backlog's as an open loop."""
    if name == "poisson":
        return dict(_mix("score-backlog"), arrival="poisson", rate_per_s=5.0)
    return spec.load_json(spec.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_schedule_is_fixed_by_the_mix(name):
    a, b = generate.schedule(_mix(name)), generate.schedule(_mix(name))
    assert np.array_equal(a.lengths, b.lengths)
    assert np.array_equal(a.due_s, b.due_s)
    pl = _mix(name)["prompt_len"]
    assert a.lengths.min() >= pl["min"] and a.lengths.max() <= pl["max"]
    # lognormal with the stated median: half the prompts on each side
    assert abs(np.median(a.lengths) - pl["median"]) < 0.05 * pl["median"]


def test_poisson_arrivals_at_the_stated_rate():
    mix = _mix("poisson")
    due = generate.schedule(mix).due_s
    assert np.all(np.diff(due) > 0)
    rate = len(due) / due[-1]
    assert abs(rate / mix["rate_per_s"] - 1) < 0.05


def test_backlog_is_due_at_once():
    assert not generate.schedule(_mix("score-backlog")).due_s.any()


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 3 * 2**32 + 5])
def test_same_seed_same_stream(seed):
    mix = _mix("score-backlog")
    a = generate.Inputs(mix, seed, 1000, 32000)
    b = generate.Inputs(mix, seed, 1000, 32000)
    for i in (0, 1, 500):
        ta, aa = a.request(i, 100)
        tb, ab = b.request(i, 100)
        assert np.array_equal(ta, tb) and aa == ab
        assert ta.min() >= 0 and ta.max() < 32000 and 0 <= aa < 1000


def test_other_seed_other_contents():
    mix = _mix("score-backlog")
    a = generate.Inputs(mix, 1, 1000, 32000).request(3, 64)
    b = generate.Inputs(mix, 2, 1000, 32000).request(3, 64)
    assert not np.array_equal(a[0], b[0])


def test_zipf_is_the_ports_arithmetic_and_skewed():
    assert np.allclose(generate.zipf_pmf(1000, 1.0), zipf_pmf(1000, 1.0))
    inp = generate.Inputs(_mix("score-backlog"), 3, 1000, 32000)
    ids = [inp.request(i, 1)[1] for i in range(3000)]
    counts = np.bincount(ids, minlength=1000)
    # the hottest adapter takes about 1/H(1000) ~ 13% of requests
    assert 0.09 < counts.max() / 3000 < 0.18
    assert np.argmax(counts) == inp.rank_of[0]


def test_unknown_processes_are_refused():
    mix = dict(_mix("score-backlog"), arrival="gamma")
    with pytest.raises(ValueError):
        generate.schedule(mix)
    mix = dict(_mix("poisson"), rate_per_s=0)
    with pytest.raises(ValueError):
        generate.schedule(mix)
