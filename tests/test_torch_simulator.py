"""The port's copy of the simulator (``core/simulator.py``) against the
JAX package's, on ``test_core.py``'s population: six gemma3-1b streams of
four requests at batch 16. With the reference's devices (TPU v5e, V100)
every ``SimResult`` field of the three policies is EQUAL to the
reference's (the same pure-Python arithmetic over the copied core); with
the port's ``H100`` (spec sheet, modelled) the regimes rank as the paper
predicts.
"""
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import CostModel as JaxCostModel
from repro.core import TPUV5E as JTPU, V100 as JV100
from repro.core import simulator as jsim
from repro_torch.configs import get_config
from repro_torch.core import H100, TPUV5E, V100, CostModel
from repro_torch.core import simulator as tsim

DEVICES = {"tpuv5e": (JTPU, TPUV5E), "v100": (JV100, V100)}


def _population(get, arrivals=4, streams=6):
    cfg = get("gemma3-1b")
    return [(cfg, 0.5, [i * 1e-4 for i in range(arrivals)])
            for _ in range(streams)]


@pytest.mark.parametrize("device", sorted(DEVICES))
@pytest.mark.parametrize("policy", ["time", "space", "vliw"])
def test_policy_results_equal_reference(policy, device):
    jdev, tdev = DEVICES[device]
    want = jsim.POLICIES[policy](
        jsim.make_requests(_population(jax_get_config), batch=16),
        JaxCostModel(jdev))
    got = tsim.POLICIES[policy](
        tsim.make_requests(_population(get_config), batch=16),
        CostModel(tdev))
    assert got.name == want.name
    assert got.latencies == want.latencies
    for field in ("makespan", "useful_flops", "peak_flops", "slo_misses",
                  "num_requests", "mean_latency", "throughput_rps",
                  "utilization", "slo_attainment"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.p(0.99) == want.p(0.99)


def test_h100_regimes_rank_as_the_paper_predicts():
    reqs = tsim.make_requests(_population(get_config), batch=16)
    cost = CostModel(H100)
    t = tsim.simulate_time_mux(reqs, cost)
    v = tsim.simulate_vliw(tsim.make_requests(_population(get_config),
                                              batch=16), cost)
    assert v.throughput_rps > t.throughput_rps
    assert v.utilization > t.utilization
    assert set(v.latencies) == set(t.latencies)
    assert v.peak_flops == H100.peak_flops
