"""The yardstick's arithmetic."""
import math

import pytest
import torch

from perfbench.harness import measure


def test_perfbench_launch_bound_is_bytes_at_decode_and_flops_at_prefill():
    # a decode launch: 32 rows against 4 tenants' [4096, 4096] weights
    M, K, N, G = 32, 4096, 4096, 4
    t = measure.launch_least_s(M, K, N, G, 2)
    assert t == pytest.approx(2 * (M * K + G * K * N + M * N) / 3.35e12)
    # a prompt of 4096 rows against one weight: the FLOPs bound
    t = measure.launch_least_s(4096, 4096, 4096, 1, 2)
    assert t == pytest.approx(2 * 4096 ** 3 / 989e12)
    launches = {(32, 4096, 4096, 4, torch.bfloat16): 3,
                (4096, 4096, 4096, 1, torch.bfloat16): 2}
    assert measure.launches_least_s(launches) == pytest.approx(
        3 * measure.launch_least_s(32, 4096, 4096, 4, 2)
        + 2 * measure.launch_least_s(4096, 4096, 4096, 1, 2))


def test_perfbench_idle_share_from_overlapping_intervals():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert measure.union_s(spans) == pytest.approx(6.0)
    # inside [0, 10]: busy 0-2, 3-4, 9-10 = 4 s
    assert measure.idle_share(spans, 0.0, 10.0) == pytest.approx(0.6)
    assert measure.gaps(spans, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert measure.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_perfbench_percentile_over_all_requests():
    xs = [float(i) for i in range(1, 21)]
    assert measure.percentile(xs, 50) == pytest.approx(10.5)
    assert measure.percentile(xs, 95) == pytest.approx(19.05)
    # a request that never got its token counts as the slowest
    assert measure.percentile(xs[:-1] + [math.inf], 95) == math.inf
    assert measure.percentile(xs[:-1] + [math.inf], 50) == pytest.approx(10.5)
    with pytest.raises(ValueError):
        measure.percentile([], 50)


def test_perfbench_model_flops_of_a_token():
    model = {"hidden_size": 8, "num_hidden_layers": 2, "head_dim": 2,
             "num_attention_heads": 4, "num_key_value_heads": 2,
             "intermediate_size": 16, "vocab_size": 32}
    attn = 8 * 8 * 2 + 8 * 4 * 2
    per_layer = 2 * (attn + 3 * 8 * 16) + 4 * 8 * 5
    assert measure.token_flops(model, 5) == 2 * per_layer + 2 * 8 * 32
    moe = dict(model, moe={"num_local_experts": 4, "num_experts_per_tok": 2})
    ffn = 2 * 3 * 8 * 16 + 8 * 4
    assert measure.token_flops(moe, 5) == \
        2 * (2 * (attn + ffn) + 4 * 8 * 5) + 2 * 8 * 32
    # a prompt pass: every position at its causal context, one unembedding
    unembed = 2 * 8 * 32
    want = sum(measure.token_flops(model, c) - unembed for c in range(1, 7)) \
        + unembed
    assert measure.prompt_flops(model, 6) == pytest.approx(want)


def test_perfbench_front_door_reads_only_requests_clear_of_the_profiler():
    import importlib.util

    from perfbench.harness import manifest
    from perfbench.harness.serve import QUIET_MARGIN_S, Run, Served
    from perfbench.harness.traffic import Request

    def reader(name):
        path = manifest.BENCH / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    run = Run(workload={}, config={}, mix={"mode": "chat"}, seed=1,
              seconds=20.0, device=torch.device("cpu"), t_process=0.0,
              t_window=(100.0, 130.0), t_profile=(112.0, 114.0))
    # twenty quiet requests due 100..106.65 s, TTFT 0.01..0.20 s, the poll
    # a tenth of that; then requests the profiler's stall held for 2 s
    for i in range(20):
        due = 100.0 + 0.35 * i
        s = run.served[i] = Served(Request(i, 0, due, 8, 2), due=due,
                                   poll=due + 0.001 * (i + 1))
        s.instants = [due + 0.01 * (i + 1), due + 0.3]
    for i in range(20, 30):
        due = 112.0 - QUIET_MARGIN_S + 0.3 * (i - 20)
        s = run.served[i] = Served(Request(i, 0, due, 8, 2), due=due,
                                   poll=due + 2.0)
        s.instants = [due + 2.5, due + 2.6]
    quiet = run.quiet_requests()
    assert sorted(s.req.rid for s in quiet) == list(range(20))
    assert reader("ttft_p95_s")(run) == pytest.approx(
        measure.percentile([0.01 * (i + 1) for i in range(20)], 95))
    assert reader("poll_wait_p95_s")(run) == pytest.approx(
        measure.percentile([0.001 * (i + 1) for i in range(20)], 95))
    # an untraced run reads the same requests: the rule is the window's
    run.profile = None
    assert run.quiet_requests() == quiet
