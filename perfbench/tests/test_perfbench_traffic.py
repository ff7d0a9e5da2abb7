"""The traffic generator: one seed, one trace; every seed, one multiset of
sizes and gaps; a new mix file is found by its name."""
import json
from collections import Counter

import pytest

from perfbench.harness import manifest, traffic

MIXES = ["backlog-chat", "backlog-one-tenant", "backlog-reasoning"]


def _key(r):
    return (r.rid, r.tenant, round(r.due_s, 12), r.prompt_len, r.output_len,
            r.tier)


@pytest.mark.parametrize("name", MIXES + ["tiny-chat"])
def test_perfbench_mix_is_the_same_for_the_same_seed(name):
    mix = _mix(name)
    a = traffic.generate(mix, 2**31 + 11, 4 * mix["block"])
    b = traffic.generate(mix, 2**31 + 11, 4 * mix["block"])
    c = traffic.generate(mix, 2**31 + 12, 4 * mix["block"])
    assert [_key(r) for r in a] == [_key(r) for r in b]
    assert [_key(r) for r in a] != [_key(r) for r in c]


@pytest.mark.parametrize("name", MIXES + ["tiny-chat"])
def test_perfbench_every_seed_draws_one_multiset(name):
    """Each whole block holds the same sizes, tenants, tiers and gaps
    whatever the seed: only their order and pairing change."""
    mix = _mix(name)
    m = mix["block"]
    runs = [traffic.generate(mix, seed, 3 * m) for seed in (1, 7, 2**31 + 5)]
    for field in ("prompt_len", "output_len", "tenant", "tier"):
        bags = [Counter(getattr(r, field) for r in rs[:m]) for rs in runs]
        assert bags[0] == bags[1] == bags[2], field
    spans = [rs[m - 1].due_s for rs in runs]
    assert spans[1] == pytest.approx(spans[0]) and \
        spans[2] == pytest.approx(spans[0])
    counts = Counter(r.tenant for r in runs[0][:m])
    for t, w in enumerate(mix["tenant_weights"]):
        assert abs(counts[t] - w * m) < 1


def test_perfbench_lengths_stay_in_their_clips():
    mix = _mix("backlog-chat")
    reqs = traffic.generate(mix, 3, 256)
    assert min(r.prompt_len for r in reqs) >= 32
    assert max(r.prompt_len for r in reqs) <= 2048
    assert min(r.output_len for r in reqs) >= 16
    assert max(r.output_len for r in reqs) <= 512
    assert all(r.due_s == 0.0 for r in reqs)
    assert sorted(traffic.distinct_prompt_lengths(mix)) == sorted(
        {r.prompt_len for r in reqs})


def test_perfbench_poisson_rate_holds_per_block():
    mix = _mix("tiny-chat")
    m = mix["block"]
    reqs = traffic.generate(mix, 5, 20 * m)
    span = reqs[-1].due_s
    # the block's gaps are the Exp quantiles: their mean is just under 1/rate
    assert span == pytest.approx(len(reqs) / mix["arrival"]["rate_rps"],
                                 rel=0.1)
    assert traffic.tier_limits(mix, 2) == (4 * mix["ttft_limit_s"],
                                           4 * mix["gap_limit_s"])


def test_perfbench_bursty_mix_is_a_permutation_per_block():
    mix = dict(_mix("tiny-chat"), arrival={
        "process": "bursty", "rate_rps": 10.0, "burst_factor": 5.0,
        "p_burst": 0.2})
    a = traffic.generate(mix, 1, 5 * mix["block"])
    b = traffic.generate(mix, 2, 5 * mix["block"])
    assert a[-1].due_s == pytest.approx(b[-1].due_s, rel=0.25)
    assert [r.due_s for r in a] != [r.due_s for r in b]


def test_perfbench_new_mix_file_is_found_by_name(tmp_path):
    (tmp_path / "traffic").mkdir()
    mix = dict(_mix("tiny-chat"), block=4)
    (tmp_path / "traffic" / "brand-new.json").write_text(json.dumps(mix))
    assert manifest.traffic("brand-new", bench=tmp_path)["block"] == 4


def _mix(name):
    if name.startswith("tiny"):
        return json.loads((manifest.BENCH / "tests" / "data" /
                           f"{name}.json").read_text())
    return manifest.traffic(name)
