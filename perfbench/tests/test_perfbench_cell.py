"""A whole run of a CPU-size cell, chip look skipped: the program's
tokens pass the check; the fp8 control and faults planted in the timed
path fail it."""
import json

import pytest
import torch

from perfbench.harness import manifest
from perfbench.harness.cell import execute

DATA = manifest.BENCH / "tests" / "data"
E2E = [{"name": n, "unit": "x"} for n in
       ("tokens_per_s", "setup_s", "ttft_p95_s", "itl_p95_s",
        "slo_attainment")]


def _run(cfg, mix, control=False, seconds=3.0, seed=2**31 + 3,
         metrics=E2E, trace=False):
    config = json.loads((DATA / f"{cfg}.json").read_text())
    traffic = json.loads((DATA / f"{mix}.json").read_text())
    threads = torch.get_num_threads()
    # a run's window is on the host clock: one thread keeps it from
    # contending with the other test processes for the cores
    torch.set_num_threads(1)
    try:
        return execute({"name": f"{cfg}.{mix}"}, config, traffic, metrics,
                       seed=seed, seconds=seconds, trace=trace,
                       device=torch.device("cpu"), control=control)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("cfg,mix", [("tiny-dense", "tiny-backlog"),
                                     ("tiny-dense", "tiny-chat"),
                                     ("tiny-moe", "tiny-backlog-one")])
def test_perfbench_cpu_cell_is_correct_and_its_control_is_not(cfg, mix):
    res, lines = _run(cfg, mix, control=True)
    assert res["correct"], lines
    assert res["attempted"] > 0 and res["failed"] == 0
    checks = res["checks"]
    assert list(res)[-1] == "checks"
    assert lines[-len(checks):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}"
        for k, v in checks.items()]
    assert "setup_s" in res["metrics"]
    if "chat" in mix:
        assert "ttft_p95_s" in res["metrics"], lines
    # the control, fp8 in the program's place, is not correct by the
    # harness's own comparison against the same limits
    assert res["control_correct"] is False, lines
    assert any(res["control"][k] > v["limit"] for k, v in checks.items())


def test_perfbench_traced_cpu_run_reads_its_sub_window_and_front_door():
    # (decode_step_ms counts graph replays: the CPU runs its bodies eagerly)
    layer = [{"name": n, "unit": "x"} for n in
             ("ttft_p95_s", "poll_wait_p95_s", "mean_group.chat")]
    res, lines = _run("tiny-dense", "tiny-chat", metrics=layer, trace=True)
    assert res["correct"], lines
    assert set(res["metrics"]) == {m["name"] for m in layer}, lines
    assert any("sub-window" in line for line in lines), lines


def _altered_token(monkeypatch):
    from repro_torch.serving import engine
    real = engine.ServingEngine._emit_token
    seen = []

    def emit(self, req, tok, t):
        seen.append(1)
        if len(seen) % 5 == 3:
            tok = (tok + 1) % 512
        return real(self, req, tok, t)

    monkeypatch.setattr(engine.ServingEngine, "_emit_token", emit)


def _state_unchanged(monkeypatch):
    """A decode step that leaves its cache as it found it."""
    from repro_torch.core import jit
    real = jit._gqa_decode_attend

    def attend(cfg, B, q, k, v, kc, vc, pos, is_global, out_dtype):
        out, _, _ = real(cfg, B, q, k, v, kc, vc, pos, is_global, out_dtype)
        return out, kc.clone(), vc.clone()

    monkeypatch.setattr(jit, "_gqa_decode_attend", attend)


def _half_the_batch(monkeypatch):
    """Half of each MoE step's rows left out of the expert combine."""
    from repro_torch.core import jit
    real = jit._moe_combine

    def combine(cfg, out_buf, weights, meta):
        y = real(cfg, out_buf, weights, meta)
        return torch.cat([y[: y.shape[0] // 2],
                          torch.zeros_like(y[y.shape[0] // 2:])])

    monkeypatch.setattr(jit, "_moe_combine", combine)


@pytest.mark.parametrize("fault,cfg,mix", [
    (_altered_token, "tiny-dense", "tiny-backlog"),
    (_altered_token, "tiny-moe", "tiny-backlog-one"),
    (_state_unchanged, "tiny-dense", "tiny-chat"),
    (_half_the_batch, "tiny-moe", "tiny-backlog-one")])
def test_perfbench_fault_in_the_timed_path_is_not_correct(monkeypatch, fault,
                                                          cfg, mix):
    fault(monkeypatch)
    res, lines = _run(cfg, mix)
    assert not res["correct"], lines
