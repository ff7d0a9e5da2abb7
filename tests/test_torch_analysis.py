"""The port's analysis package against the JAX package's, on the CPU.

  * Dependence graphs: the port's dense (gemma3-1b smoke), MoE (grok-1
    smoke) and SSM (mamba2-2.7b smoke) decode templates, stacked and
    per-layer, give the JAX package's RAW/WAR/WAW edges edge by edge (and
    the same wildcard stages and unsourced reads). Exact: the graphs are
    built from the stages' declared access sets only.
  * Certification: a real certified serve (two gemma3-1b smoke tenants with
    distinct weights, the reference's two-wave trace, both packages on the
    same TPUV5E cost model and the JAX package's prompts) certifies clean
    in both regimes, with the reference's number of checks and dispatches.
  * Mutations: each mutation of tests/test_schedule_certifier.py, applied
    to the port's trace and to the reference's, is rejected with the same
    ``HazardViolation`` subclass by each package's certifier.
  * Lint: TH002 is clean on ``src/repro_torch`` and flags a key function
    that omits a field.
"""
import copy
import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.analysis as janalysis
import repro_torch
import repro_torch.analysis as tanalysis
from repro.configs import smoke_config as jax_smoke_config
from repro.core import jit as jjit
from repro.core.costmodel import CostModel as JaxCostModel, TPUV5E as JTPU
from repro.models import Model as JaxModel
from repro.serving import ServingEngine as JaxEngine, Tenant as JaxTenant
from repro_torch.analysis.lint import lint_paths, main as lint_main
from repro_torch.configs import smoke_config
from repro_torch.core import jit as tjit
from repro_torch.core.costmodel import CostModel, TPUV5E
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServingEngine, Tenant, two_wave_trace

SRC = Path(repro_torch.__file__).resolve().parents[1]
REGIMES = [True, False]
ARCHS = {"dense": "gemma3-1b", "moe": "grok-1-314b", "ssm": "mamba2-2.7b"}


def _pair(arch, seed):
    """(JAX model, params, port model, params), the same weights."""
    jm = JaxModel(jax_smoke_config(arch), param_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = Model(smoke_config(arch), param_dtype=torch.float32, device="cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


def _jax_prompt(cfg, req, rng=jax.random.PRNGKey(0)):
    """The JAX engine's prompt for ``req`` (its ``_make_prompt``)."""
    return np.array(jax.random.randint(jax.random.fold_in(rng, req.req_id),
                                       (1, req.prompt_len), 0,
                                       cfg.vocab_size))


# ---------------------------------------------------------------------------
# dependence graphs of the templates
# ---------------------------------------------------------------------------

def _edges(g):
    return [(e.kind, e.src, e.dst, repr(e.resource)) for e in g.edges]


@pytest.mark.parametrize("stacked", REGIMES)
@pytest.mark.parametrize("family", list(ARCHS))
def test_template_depgraph_equals_reference(family, stacked):
    jm, jp, tm, tp = _pair(ARCHS[family], 1)
    jbuild, tbuild = {
        "dense": (jjit.build_dense_decode_template,
                  tjit.build_dense_decode_template),
        "moe": (jjit.build_moe_decode_template,
                tjit.build_moe_decode_template),
        "ssm": (jjit.build_ssm_decode_template,
                tjit.build_ssm_decode_template)}[family]
    jt, tt = jbuild(jm, jp, 2, stacked=stacked), \
        tbuild(tm, tp, 2, stacked=stacked)
    # the same stages: GEMMs and bodies at the same positions, same tags
    assert [getattr(st, "tag", None) for st in tt.stages] == \
        [getattr(st, "tag", None) for st in jt.stages]
    want, got = janalysis.build_depgraph(jt), tanalysis.build_depgraph(tt)
    assert _edges(got) == _edges(want)
    assert got.conservative == want.conservative == []
    assert got.unsourced_reads == want.unsourced_reads
    assert any(e[0] == "RAW" and e[3] == "'x'" for e in _edges(got))


class _St:
    """Minimal stage stand-in: only the declared access sets matter."""

    def __init__(self, tag, reads=None, writes=None):
        self.tag = tag
        if reads is not None:
            self.reads = tuple(reads)
        if writes is not None:
            self.writes = tuple(writes)


@pytest.mark.parametrize("stages", [
    [_St("a", reads=("cache",), writes=("x",)),
     _St("b", reads=("x",), writes=("h",)),
     _St("c", reads=(), writes=("x",))],
    [_St("a", reads=(), writes=("x",)), _St("mystery"),
     _St("c", reads=("x",), writes=("y",))],
    [_St("a", reads=("bogus",), writes=("x",))],
], ids=["raw-war-waw", "undeclared-barrier", "unsourced"])
def test_depgraph_of_stand_in_stages_equals_reference(stages):
    want = janalysis.build_depgraph(stages)
    got = tanalysis.build_depgraph(stages)
    assert _edges(got) == _edges(want) and got.labels == want.labels
    assert got.conservative == want.conservative
    assert got.unsourced_reads == want.unsourced_reads


class _NSProg:
    def __init__(self, kv_writes, env, stages):
        self.kv_writes = kv_writes
        self.env = env
        self.stages = stages


def test_cross_program_conflicts_kv_and_env():
    env = {}
    a = _NSProg((("kv", "t", 0),), env, [_St("s", reads=(), writes=("x",))])
    b = _NSProg((("kv", "t", 0), ("kv", "t", 1)), {}, [])
    c = _NSProg((), env, [_St("s", reads=(), writes=("x", "y"))])
    d = _NSProg((("kv", "u", 0),), {}, [])
    for x, y in ((a, b), (a, c), (b, d)):
        assert tanalysis.cross_program_conflicts(x, y) == \
            janalysis.cross_program_conflicts(x, y)
    assert tanalysis.cross_program_conflicts(a, b) == [("kv", ("kv", "t", 0))]
    assert ("env", "x") in tanalysis.cross_program_conflicts(a, c)


# ---------------------------------------------------------------------------
# a real certified serve, both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma():
    jm, jp1, tm, tp1 = _pair("gemma3-1b", 11)
    _, jp2, _, tp2 = _pair("gemma3-1b", 12)
    return jm, (jp1, jp2), tm, (tp1, tp2)


def _serve_both(gemma, stacked):
    jm, jps, tm, tps = gemma
    jeng = JaxEngine([JaxTenant(n, jm, p, cache_len=32, max_batch=2)
                      for n, p in zip(("t1", "t2"), jps)], mode="vliw",
                     certify=True, cost=JaxCostModel(JTPU),
                     stacked_layers=stacked)
    teng = ServingEngine(
        [Tenant(n, tm, p, cache_len=32, max_batch=2)
         for n, p in zip(("t1", "t2"), tps)], mode="vliw", certify=True,
        cost=CostModel(TPUV5E), stacked_layers=stacked, device="cpu",
        prompt_fn=lambda t, r: torch.from_numpy(_jax_prompt(t.cfg, r)))
    gap = 1.5 * teng._prefill_time(tm.cfg, 8)
    trace = two_wave_trace(["t1", "t2"], ["t1", "t2"], gap, prompt_len=8,
                           max_new_tokens=4, slo_s=1.0)
    jrep, trep = jeng.run(trace), teng.run(trace)
    return (jrep, jeng.last_trace), (trep, teng.last_trace)


@pytest.fixture(scope="module")
def served(gemma):
    return {stacked: _serve_both(gemma, stacked) for stacked in REGIMES}


def _coalesced_dispatches(trace):
    return [di for di, d in enumerate(trace.dispatches)
            if len({op.prog_uid for op in d.ops if op.prog_uid}) >= 2]


@pytest.mark.parametrize("stacked", REGIMES)
def test_real_serving_trace_certifies_clean(served, stacked):
    (jrep, jtrace), (trep, trace) = served[stacked]
    assert {r.req_id: r.tokens_out for r in trep.requests} == \
        {r.req_id: r.tokens_out for r in jrep.requests}
    assert trep.jit.hazard_checks > 0 and trep.jit.hazard_violations == 0
    # the same decisions, so the same number of checks and dispatches
    assert trep.jit.hazard_checks == jrep.jit.hazard_checks
    assert len(trace.dispatches) == len(jtrace.dispatches)
    assert [len(d.ops) for d in trace.dispatches] == \
        [len(d.ops) for d in jtrace.dispatches]
    assert trace.req_admits and trace.req_retires
    assert _coalesced_dispatches(trace)
    assert any(pa.kv_writes for pa in trace.prog_admits)
    cert = tanalysis.certify_trace(trace, raise_on_violation=False)
    assert cert.violations == [] and cert.checks > 0


@pytest.mark.parametrize("stacked", REGIMES)
def test_served_programs_have_disjoint_footprints(served, stacked):
    _, (_, trace) = served[stacked]
    by_stream = {}
    for pa in trace.prog_admits:
        by_stream.setdefault(pa.stream, set()).update(pa.kv_writes)
    assert len(by_stream) == 2
    a, b = by_stream.values()
    assert not (a & b)


def test_raw_session_trace_certifies_clean(gemma):
    """The session-level trace path (no engine): two concurrent dense
    decode programs, driven to completion tick by tick."""
    _, _, tm, (tp, _) = gemma
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (2, 8)))
    _, cache = tm.prefill(tp, {"tokens": prompt}, cache_len=32)
    tok = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (2, 1)))
    session = tjit.VLIWJit(max_group=8).session(record_trace=True)
    tmpl = tjit.build_dense_decode_template(tm, tp, 2)
    for sid in (0, 1):
        session.admit(tmpl.bind(stream_id=sid, tokens=tok, cache=cache))
    now = 0.0
    while session.live:
        ev = session.tick(now)
        now = max(now, ev.t)
    assert session.trace.dispatches and session.trace.prog_admits
    assert all(op.prog_uid for d in session.trace.dispatches
               for op in d.ops)
    cert = tanalysis.certify_trace(session.trace, raise_on_violation=False)
    assert cert.violations == [] and cert.checks > 0


def test_hazard_counters_fold_through_merge():
    a = tjit.JitStats(hazard_checks=3, hazard_violations=1,
                      collective_time_s=0.5)
    b = tjit.JitStats(hazard_checks=2, hazard_violations=0,
                      collective_time_s=0.25)
    assert a.merge(b) is a
    assert (a.hazard_checks, a.hazard_violations, a.collective_time_s) == \
        (5, 1, 0.75)


def test_unique_req_ids_admit_under_certification(gemma):
    from repro_torch.serving import ServeRequest
    _, _, tm, (tp, _) = gemma
    eng = ServingEngine([Tenant("a", tm, tp, cache_len=32, max_batch=2)],
                        mode="vliw", certify=True, device="cpu")
    rep = eng.run([ServeRequest(0, "a", 0.0, 8, 2, 1.0),
                   ServeRequest(1, "a", 1e-6, 8, 2, 1.0)])
    assert rep.unfinished == 0
    assert rep.jit.hazard_violations == 0 and rep.jit.hazard_checks > 0


# ---------------------------------------------------------------------------
# mutated traces: the same hazard class from both packages
# ---------------------------------------------------------------------------

def _prog_positions(trace):
    pos = {}
    for di, d in enumerate(trace.dispatches):
        for oi, op in enumerate(d.ops):
            if op.prog_uid:
                pos.setdefault(op.prog_uid, []).append((di, oi))
    return [ps for _, ps in sorted(pos.items()) if len(ps) >= 2]


def _replace_op(trace, di, oi, **changes):
    d = trace.dispatches[di]
    ops = list(d.ops)
    ops[oi] = dataclasses.replace(ops[oi], **changes)
    trace.dispatches[di] = dataclasses.replace(d, ops=tuple(ops))


def _swap_same_program(trace, idx):
    progs = _prog_positions(trace)
    (d1, o1), (d2, o2) = progs[idx % len(progs)][0], \
        progs[idx % len(progs)][-1]
    assert d1 != d2
    a, b = trace.dispatches[d1].ops[o1], trace.dispatches[d2].ops[o2]
    _replace_op(trace, d1, o1, seq=b.seq, tag=b.tag)
    _replace_op(trace, d2, o2, seq=a.seq, tag=a.tag)


def _same_stream_in_group(trace, idx):
    (d1, _), (d2, o2) = _prog_positions(trace)[idx][:2]
    d = trace.dispatches[d1]
    trace.dispatches[d1] = dataclasses.replace(
        d, ops=d.ops + (trace.dispatches[d2].ops[o2],))


def _drop_retire(trace, idx):
    covered = set(trace.evicted) | set(trace.unfinished)
    plain = [i for i, (rid, _) in enumerate(trace.req_retires)
             if rid not in covered]
    trace.req_retires.pop(plain[idx % len(plain)])


def _duplicate_admission(trace, idx):
    trace.req_admits.append(trace.req_admits[idx % len(trace.req_admits)])


def _alias_kv(trace, idx):
    cds = _coalesced_dispatches(trace)
    di = cds[idx % len(cds)]
    for oi in range(len(trace.dispatches[di].ops)):
        _replace_op(trace, di, oi, kv_writes=(("kv", "t1", 0),))


def _distinct_shared_operands(trace, idx):
    cds = _coalesced_dispatches(trace)
    di = cds[idx % len(cds)]
    for oi in range(len(trace.dispatches[di].ops)):
        _replace_op(trace, di, oi, weight_key=("shared", "wq"),
                    weight_id=(0xBAD + oi,))
    trace.dispatches[di] = dataclasses.replace(trace.dispatches[di],
                                               shared_operand=True)


def _shared_env(trace, idx):
    di = _coalesced_dispatches(trace)[idx]
    for oi in range(len(trace.dispatches[di].ops)):
        _replace_op(trace, di, oi, env_id=0xE17, env_writes=("x",))


def _undeclared_env_writes(trace, idx):
    di = _coalesced_dispatches(trace)[idx]
    _replace_op(trace, di, 0, env_id=0xE17, env_writes=("*",))
    _replace_op(trace, di, 1, env_id=0xE17, env_writes=("hf",))


def _latest_start_regression(trace, idx):
    ps = _prog_positions(trace)[idx]
    (d1, o1), (d2, o2) = ps[0], ps[-1]
    first = trace.dispatches[d1].ops[o1]
    _replace_op(trace, d2, o2, latest_start_t=first.latest_start_t - 1.0)


def _deadline_drift(trace, idx):
    (d2, o2) = _prog_positions(trace)[idx][-1]
    old = trace.dispatches[d2].ops[o2].deadline_t
    _replace_op(trace, d2, o2,
                deadline_t=0.5 * old if math.isfinite(old) else 1.0)


MUTATIONS = {
    "swap-same-program": (_swap_same_program, "ProgramOrderHazard"),
    "same-stream-in-group": (_same_stream_in_group, "ProgramOrderHazard"),
    "drop-retire": (_drop_retire, "ConservationHazard"),
    "duplicate-admission": (_duplicate_admission, "ConservationHazard"),
    "alias-kv": (_alias_kv, "KVAliasHazard"),
    "distinct-shared-operands": (_distinct_shared_operands,
                                 "OperandIdentityHazard"),
    "shared-env": (_shared_env, "EnvAliasHazard"),
    "undeclared-env-writes": (_undeclared_env_writes, "EnvAliasHazard"),
    "latest-start-regression": (_latest_start_regression, "DeadlineHazard"),
    "deadline-drift": (_deadline_drift, "DeadlineHazard"),
}


@pytest.mark.parametrize("stacked", REGIMES)
@pytest.mark.parametrize("name", list(MUTATIONS))
def test_mutation_raises_the_reference_hazard_class(served, name, stacked):
    mutate, want = MUTATIONS[name]
    (_, jtrace0), (_, ttrace0) = served[stacked]
    raised = {}
    for pkg, trace0 in ((janalysis, jtrace0), (tanalysis, ttrace0)):
        trace = copy.deepcopy(trace0)
        mutate(trace, 0)
        with pytest.raises(pkg.HazardViolation) as exc:
            pkg.certify_trace(trace)
        raised[pkg.__name__] = type(exc.value).__name__
        cert = pkg.certify_trace(trace, raise_on_violation=False)
        assert any(type(v).__name__ == want for v in cert.violations)
    assert raised == {"repro.analysis": want, "repro_torch.analysis": want}


# ---------------------------------------------------------------------------
# lint: TH002
# ---------------------------------------------------------------------------

def test_lint_th002_clean_on_the_port():
    assert lint_paths([SRC / "repro_torch"]) == []
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint",
         str(SRC / "repro_torch"), "--strict"], cwd=SRC,
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout


def test_lint_th002_flags_a_key_function_missing_fields(tmp_path, capsys):
    bad = tmp_path / "keys.py"
    bad.write_text(
        "def decode_program_cache_key(model, params, batch, cache):\n"
        "    return ('decode', id(model), batch, str(params.dtype))\n"
        "def helper(model):\n"
        "    return model\n")
    findings = lint_paths([bad])
    assert [(f.code, f.symbol, f.line) for f in findings] == \
        [("TH002", "decode_program_cache_key", 1)]
    assert "cache geometry" in findings[0].message
    assert "emission regime" in findings[0].message
    assert "dtype" not in findings[0].message.split(":", 1)[1]
    assert lint_main([str(bad), "--strict"]) == 1
    assert lint_main([str(bad)]) == 0
    assert lint_main([str(bad), "--json"]) == 0
    assert '"TH002"' in capsys.readouterr().out
