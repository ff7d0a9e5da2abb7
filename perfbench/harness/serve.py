"""Drive the port's ``ServingEngine.serve_forever`` through one run.

Set-up builds the tenants from the configuration file (their weights made
by ``harness/weights.py``), the engine with the file's settings, and
serves one warm-up epoch that reaches every key the cell's traffic uses:
each tenant's decode body at its batch, and each prompt length the mix
can draw (a dense tenant's prefill bucket, an MoE tenant's exact length).
Then the window's epoch:

* offline (a backlog): every request is in the door at the epoch's
  start; the window opens ``ramp_s`` later and closes ``--seconds`` after
  that, and the loop is left from its heartbeat (``on_stats``) as it
  closes, without draining;
* chat (open loop): a feeder thread submits each request at its due time;
  the window is the ``--seconds`` after ``lead_s`` of arrivals; the door
  closes at the window's end and the loop runs until every request due in
  the window has its last token.

Every token's host instant is taken in the ticket's callback. With
``trace`` the profiler covers a sub-window of ``profile_s`` in the middle
of the window, and the program's counters are read at its edges. Starting
and stopping the profiler stall the loop (the stop flushes the device
trace on the loop's thread), so the front door's host-clock readings take
only the requests due well before the sub-window opens
(``Run.quiet_requests``), in traced and untraced runs alike.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from perfbench.harness import traffic as traffic_lib
from perfbench.harness import weights as weights_lib

OFFLINE_SLO_S = 3600.0
WARMUP_ID0 = 1 << 40
# the front door's readings skip the requests due less than this before
# the profiled sub-window opens: one due earlier has its first token
# before the profiler starts unless it waits over 5 s (the chat cell's
# worst untraced TTFT p95 is about 2 s)
QUIET_MARGIN_S = 5.0


class WindowClosed(Exception):
    """Raised from the heartbeat to leave an offline window's loop."""


@dataclasses.dataclass
class Served:
    """What one request got: tokens, their host instants (monotonic
    seconds) and the engine's stamps."""
    req: Any                      # traffic.Request
    due: float = math.nan         # host instant it was due
    poll: float = math.nan        # host instant the loop's poll stamped
    tokens: List[int] = dataclasses.field(default_factory=list)
    instants: List[float] = dataclasses.field(default_factory=list)

    @property
    def finished(self) -> bool:
        return len(self.tokens) >= self.req.output_len


@dataclasses.dataclass
class Run:
    """Everything a metric reader or the correctness check reads."""
    workload: Dict
    config: Dict
    mix: Dict
    seed: int
    seconds: float
    device: torch.device
    t_process: float
    t_window: Tuple[float, float] = (math.nan, math.nan)
    # where the profiled sub-window lies (set whether or not it is traced)
    t_profile: Tuple[float, float] = (math.nan, math.nan)
    served: Dict[int, Served] = dataclasses.field(default_factory=dict)
    # (rid, token, engine stamp) in delivery order, the window's epoch
    events: List[Tuple[int, int, float]] = dataclasses.field(
        default_factory=list)
    prompts: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    params: List[Dict] = dataclasses.field(default_factory=list)
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    profile: Optional[Dict] = None
    memory_peak_bytes: int = 0
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def model(self) -> Dict:
        return self.config["model"]

    @property
    def chat(self) -> bool:
        return self.mix["mode"] == "chat"

    def in_window(self, t: float) -> bool:
        return self.t_window[0] <= t <= self.t_window[1]

    def window_requests(self) -> List[Served]:
        """Chat: the requests due in the window. Offline: those that got a
        token in it."""
        if self.chat:
            return [s for s in self.served.values() if self.in_window(s.due)]
        return [s for s in self.served.values()
                if any(self.in_window(t) for t in s.instants)]

    def quiet_requests(self) -> List[Served]:
        """The chat window's requests due at least ``quiet_margin_s`` (the
        mix's; ``QUIET_MARGIN_S`` by default) before the profiled
        sub-window opens: clear of the profiler and of the queue its stalls
        leave behind. The same requests in an untraced run, so both read
        alike."""
        cut = self.t_profile[0] - float(self.mix.get("quiet_margin_s",
                                                     QUIET_MARGIN_S))
        return [s for s in self.window_requests() if s.due < cut]


def port_config(cfg: Dict):
    """The port's ``ModelConfig`` of a configuration file's model."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    m = cfg["model"]
    moe = m.get("moe")
    if m["vocab_size"] % 256:
        raise ValueError("the port pads the vocabulary to 256: give a "
                         "multiple of it")
    return ModelConfig(
        name=cfg["name"], arch_type="moe" if moe else "dense",
        num_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        num_heads=m["num_attention_heads"],
        num_kv_heads=m["num_key_value_heads"],
        d_ff=m["intermediate_size"], vocab_size=m["vocab_size"],
        head_dim=m["head_dim"], rope_theta=m["rope_theta"],
        norm_eps=m["rms_norm_eps"], tie_embeddings=False,
        moe=MoEConfig(num_experts=moe["num_local_experts"],
                      top_k=moe["num_experts_per_tok"],
                      capacity_factor=moe["capacity_factor"])
        if moe else None)


def _profile_events(prof) -> Dict:
    """Device operations and top-level host ops of a finished profiler:
    [(name, start_s, end_s)] each, on the profiler's clock."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.events():
        rec = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            device.append(rec)
        elif e.cpu_parent is None:
            host.append(rec)
    return {"device": device, "host": host}


class Runner:
    """One run of one cell: set-up, the window, the program's counters."""

    def __init__(self, run: Run, trace: bool):
        self.run = run
        self.trace = trace
        self.mix = run.mix
        self.engine = None
        self.names: List[str] = []

    # ------------------------------------------------------------------
    def build(self) -> None:
        from repro_torch.models.model import Model
        from repro_torch.serving.engine import ServingEngine, Tenant
        run, cfg = self.run, self.run.config
        eng = cfg["engine"]
        mcfg = port_config(cfg)
        n = eng["tenants"]
        dtype = getattr(torch, cfg["model"].get("torch_dtype", "bfloat16"))
        run.params = weights_lib.make(cfg["model"], run.seed, n, run.device,
                                      dtype)
        model = Model(mcfg, param_dtype=dtype, device=run.device)
        self.names = [f"{cfg['name']}.t{i}" for i in range(n)]
        tenants = [Tenant(name, model, p, cache_len=eng["cache_len"],
                          max_batch=eng["max_batch"])
                   for name, p in zip(self.names, run.params)]
        self.engine = ServingEngine(
            tenants, mode="vliw", device=run.device,
            weight_budget_bytes=eng["weight_budget_bytes"],
            plan_capacity=eng["plan_capacity"], stacked_layers=True,
            cuda_graphs=True, prompt_fn=self._prompt)

    def _prompt(self, tenant, req) -> torch.Tensor:
        return self.run.prompts[req.req_id]

    def _make_prompts(self, reqs) -> None:
        """Every prompt's token ids, from the seed, in one draw on the
        device: views [1, S] into it."""
        vocab = self.run.model["vocab_size"]
        total = sum(r.prompt_len for r in reqs)
        gen = torch.Generator(device=self.run.device)
        gen.manual_seed((int(self.run.seed) * 7919 + 17) & (2**63 - 1))
        flat = torch.randint(0, vocab, (total,), generator=gen,
                             device=self.run.device)
        off = 0
        for r in reqs:
            self.run.prompts[r.rid] = flat[off:off + r.prompt_len].view(
                1, r.prompt_len)
            off += r.prompt_len

    def _serve_request(self, r, slo_s: float):
        from repro_torch.serving.workload import ServeRequest
        return ServeRequest(r.rid, self.names[r.tenant], 0.0, r.prompt_len,
                            r.output_len, slo_s=slo_s, tier=r.tier)

    # ------------------------------------------------------------------
    def warm_up(self) -> None:
        """One epoch over a request per (tenant, key length): every
        prefill key the mix can reach and each tenant's decode body."""
        from repro_torch.core.jit import prefill_bucket
        from repro_torch.serving.frontdoor import FrontDoor
        lengths = traffic_lib.distinct_prompt_lengths(self.mix)
        if "moe" not in self.run.model:
            # a dense prompt runs the declared program of its bucket
            by_bucket = {}
            for s in lengths:
                by_bucket.setdefault(prefill_bucket(s), s)
            lengths = sorted(by_bucket.values())
        keys = [(t, s) for t in range(len(self.mix["tenant_weights"]))
                for s in lengths]
        reqs = [traffic_lib.Request(WARMUP_ID0 + i, t, 0.0, s, 2)
                for i, (t, s) in enumerate(keys)]
        self._make_prompts(reqs)
        door = FrontDoor()
        for r in reqs:
            door.submit(self._serve_request(r, OFFLINE_SLO_S))
        door.close()
        self.engine.serve_forever(door, seed=self.run.seed)
        if self.trace:
            # the profiler's first start loads and initializes the tracer:
            # set-up pays it, not the window
            self._start_profiler().stop()
        for r in reqs:
            del self.run.prompts[r.rid]

    # ------------------------------------------------------------------
    def _counters(self) -> Dict[str, Any]:
        from repro_torch.kernels.coalesced_gemm import coalesced_gemm
        ds = self.engine.jit.executor.stats
        return {"dispatch": ds.copy(),
                "launches": dict(coalesced_gemm.launches_by_shape),
                "t": time.monotonic()}

    def window(self) -> None:
        """The window's epoch."""
        from repro_torch.serving.frontdoor import FrontDoor, MonotonicClock
        run, mix = self.run, self.mix
        reqs = traffic_lib.generate(
            mix, run.seed, traffic_lib.requests_for(mix, run.seconds))
        self._make_prompts(reqs)
        door = FrontDoor()
        clock = MonotonicClock()
        c0 = time.monotonic() - clock.now()       # the clock's zero
        by_id: Dict[int, Any] = {}
        edges: Dict[str, Dict] = {}
        prof_box: List[Any] = []

        def submit(r, slo_s, due):
            sr = self._serve_request(r, slo_s)
            by_id[r.rid] = sr
            s = run.served[r.rid] = Served(r, due=due)

            def on_token(tok, t_engine, s=s, rid=r.rid):
                now = time.monotonic()
                s.tokens.append(int(tok))
                s.instants.append(now)
                run.events.append((rid, int(tok), float(t_engine)))

            door.submit(sr, on_token=on_token)

        start = time.monotonic()
        if run.chat:
            lead = float(mix["lead_s"])
            w0 = start + lead
        else:
            w0 = start + float(mix["ramp_s"])
        w1 = w0 + run.seconds
        run.t_window = (w0, w1)
        profile_s = float(mix.get("profile_s", 2.0))
        p0 = w0 + 0.5 * (run.seconds - profile_s)
        run.t_profile = (p0, p0 + profile_s)
        sub_end: List[float] = []

        feeder = None
        if run.chat:
            def feed():
                for r in reqs:
                    due = start + r.due_s
                    if due > w1:
                        break
                    wait = due - time.monotonic()
                    if wait > 0:
                        time.sleep(wait)
                    lim = traffic_lib.tier_limits(mix, r.tier)
                    submit(r, lim[0] + (r.output_len - 1) * lim[1], due)
                wait = w1 - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                door.close()

            feeder = threading.Thread(target=feed, name="perfbench-feeder",
                                      daemon=True)
        else:
            for r in reqs:
                submit(r, OFFLINE_SLO_S, start)

        tail_limit = w1 + float(mix.get("tail_limit_s", 120.0))

        def heartbeat(_stats):
            now = time.monotonic()
            if "w0" not in edges and now >= w0:
                edges["w0"] = self._counters()
            if self.trace and not prof_box and now >= p0:
                # starting the tracer can take a second: the sub-window
                # opens once it runs
                prof_box.append(self._start_profiler())
                edges["p0"] = self._counters()
                sub_end.append(edges["p0"]["t"] + profile_s)
            if self.trace and len(prof_box) == 1 and now >= sub_end[0]:
                if run.device.type == "cuda":
                    torch.cuda.synchronize(run.device)
                edges["p1"] = self._counters()
                prof_box[0].stop()
                prof_box.append(None)
            if "w1" not in edges and now >= w1:
                edges["w1"] = self._counters()
                if not run.chat:
                    raise WindowClosed()
            if now > tail_limit:
                raise RuntimeError("requests due in the window did not finish "
                                   f"within {mix.get('tail_limit_s', 120.0)} s "
                                   "of its end")

        jit0 = dataclasses.replace(self.engine.jit_stats.groups)
        if feeder is not None:
            feeder.start()
        try:
            self.engine.serve_forever(door, clock=clock, seed=run.seed,
                                      on_stats=heartbeat,
                                      stats_interval_s=0.0)
        except WindowClosed:
            pass
        finally:
            if feeder is not None:
                feeder.join(timeout=run.seconds + 60.0)
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        if "w1" not in edges:
            edges["w1"] = self._counters()
        if "w0" not in edges:
            edges["w0"] = edges["w1"]
        for rid, sr in by_id.items():
            run.served[rid].poll = c0 + sr.arrival_t
        jit1 = self.engine.jit_stats.groups
        run.counters = {
            "edges": edges,
            "groups": (jit1.count - jit0.count, jit1.total - jit0.total),
        }
        if self.trace and prof_box:
            if len(prof_box) == 1:
                edges["p1"] = self._counters()
                prof_box[0].stop()
            t = time.monotonic()
            run.profile = _profile_events(prof_box[0])
            run.notes.append(
                f"profile events device={len(run.profile['device'])} "
                f"host={len(run.profile['host'])} read in "
                f"{time.monotonic() - t:.1f} s; sub-window "
                f"{edges['p1']['t'] - edges['p0']['t']:.3f} s")

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.run.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def close(self) -> None:
        """Free the program's state: the engine, its caches and graphs."""
        import gc
        self.engine = None
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
            torch.cuda.empty_cache()
