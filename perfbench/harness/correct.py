"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample
drawn from the seed of the requests the window finished (the longest among
them) is run through the plain reference (``perfbench/reference``) over its
prompt and its served tokens. Each served token is judged by the gap by
which its reference logit lies below the reference's best at that
position. Two readings are taken over the sample, the widest and the mean
gap; those the configuration file's ``checks`` names are compared, each
against its limit there.

Rows of a dense model are independent, so each sampled request is one
causal forward of its prompt and tokens. An MoE model routes a decode
step's whole batch as one group with a per-expert capacity, so a row's
result depends on its batchmates: there the reference serves the window's
whole batch again, step by step from the epoch's start, teacher-forced on
the served tokens, as far as the sample's last token. The batch of each
step is read off the token stream: a request's first token is its
admission into the lowest free slot, a decode step delivers one token to
every occupied slot in slot order, and a request leaves its slot after its
last token. A step that does not fit that reading fails the check.

The control (``--control``) is the reference at fp8, in the program's
place: at each position of the same prompts and tokens, the gap (in the
fp32 reference) of the token the fp8 model puts first. Its readings go
through the same comparison against the same limits as the program's, and
give ``control_correct``, which a sound calibration reads false.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import torch

from perfbench.reference.model import Reference, exact_fp32_products, gaps


def sample(run, limit: int) -> List:
    """The finished requests to check: the longest, then others drawn from
    the seed, at most ``limit`` in all (the window's own for chat, those
    finished inside it offline)."""
    done = [s for s in run.window_requests() if s.finished
            and (run.chat or run.in_window(s.instants[-1]))]
    if not done:
        return []
    done.sort(key=lambda s: s.req.rid)
    longest = max(done, key=lambda s: (s.req.output_len, -s.req.rid))
    rest = [s for s in done if s is not longest]
    random.Random(run.seed).shuffle(rest)
    return [longest] + rest[:limit - 1]


def _dense(run, picks, control: bool) -> Tuple[List[torch.Tensor], List]:
    """Per request: the fp32 gaps of the served tokens, and with
    ``control`` the fp32 gaps of the fp8 model's first choices."""
    by_tenant: Dict[int, List] = {}
    for s in picks:
        by_tenant.setdefault(s.req.tenant, []).append(s)
    served, ctrl = [], []
    for t, group in sorted(by_tenant.items()):
        params = run.params[t]
        ref = Reference(run.model, params)
        low = Reference(run.model, params, "fp8") if control else None
        for s in group:
            prompt = run.prompts[s.req.rid][0]
            toks = torch.tensor(s.tokens, device=prompt.device)
            seq = torch.cat([prompt, toks[:-1]])
            rows = torch.arange(prompt.shape[0] - 1, seq.shape[0],
                                device=prompt.device)
            logits, _ = ref.prompt(seq, rows)
            served.append(gaps(logits, toks))
            if low is not None:
                low_logits, _ = low.prompt(seq, rows)
                ctrl.append(gaps(logits, low_logits.argmax(-1)))
            del logits
        del ref, low
    return served, ctrl


def schedule(run, batch: int) -> List[Tuple[str, object]]:
    """The window epoch's events as ("admit", (rid, slot)) and ("step",
    [(slot, rid)] in slot order), read off the token stream."""
    out: List[Tuple[str, object]] = []
    slots: List[Optional[int]] = [None] * batch
    count: Dict[int, int] = {}
    step: List[Tuple[int, int, float]] = []

    def flush():
        if not step:
            return
        rids = [rid for rid, _, _ in step]
        active = [(i, r) for i, r in enumerate(slots) if r is not None]
        if [r for _, r in active] != rids:
            raise ValueError("a decode step's tokens are not one per "
                             f"occupied slot in slot order: {rids} against "
                             f"{[r for _, r in active]}")
        out.append(("step", active))
        for i, r in active:
            if count[r] >= run.served[r].req.output_len:
                slots[i] = None
        step.clear()

    for rid, tok, t_engine in run.events:
        if rid not in count:
            flush()
            count[rid] = 1
            if run.served[rid].req.output_len > 1:
                free = slots.index(None)
                slots[free] = rid
                out.append(("admit", (rid, free)))
            continue
        if step and step[-1][2] != t_engine:
            flush()
        count[rid] += 1
        step.append((rid, tok, t_engine))
    flush()
    return out


def _moe(run, picks, control: bool) -> Tuple[List[torch.Tensor], List]:
    """The window's batch served again by the reference (and the fp8
    control beside it), teacher-forced; the gaps of the sampled requests'
    tokens."""
    eng = run.config["engine"]
    B, T = eng["max_batch"], eng["cache_len"]
    m = run.model
    L, Hkv, hd = m["num_hidden_layers"], m["num_key_value_heads"], \
        m["head_dim"]
    want = {s.req.rid for s in picks}
    left = {rid: run.served[rid].req.output_len for rid in want}
    models = [Reference(m, run.params[0])]
    if control:
        models.append(Reference(m, run.params[0], "fp8"))
    dev = run.params[0]["embed"].device
    caches = [(torch.zeros(L, B, Hkv, T, hd, device=dev),
               torch.zeros(L, B, Hkv, T, hd, device=dev)) for _ in models]
    pos = torch.zeros(B, dtype=torch.long, device=dev)
    last = torch.zeros(B, dtype=torch.long, device=dev)
    k_of: Dict[int, int] = {}
    served: Dict[int, List[torch.Tensor]] = {rid: [] for rid in want}
    ctrl: Dict[int, List[torch.Tensor]] = {rid: [] for rid in want}

    def judge(rid, logits, toks):
        if rid in want:
            served[rid].append(gaps(logits, toks))
            left[rid] -= int(toks.shape[0])

    for kind, what in schedule(run, B):
        if not any(v > 0 for v in left.values()):
            break
        if kind == "admit":
            rid, slot = what
            prompt = run.prompts[rid][0]
            S = prompt.shape[0]
            first = torch.tensor(run.served[rid].tokens[:1], device=dev)
            outs = []
            for model, (kc, vc) in zip(models, caches):
                logits, kvs = model.prompt(prompt, torch.tensor([S - 1],
                                                               device=dev))
                for l, (k, v) in enumerate(kvs):
                    kc[l, slot].zero_()
                    vc[l, slot].zero_()
                    kc[l, slot, :, :S] = k
                    vc[l, slot, :, :S] = v
                outs.append(logits)
            judge(rid, outs[0], first)
            if control and rid in want:
                ctrl[rid].append(gaps(outs[0], outs[1].argmax(-1)))
            pos[slot], last[slot] = S, first[0]
            k_of[rid] = 1
            continue
        active = what
        if len(active) != B:
            raise ValueError("a decode step with an idle slot: the reference "
                             "cannot know that slot's state")
        toks = torch.tensor([run.served[r].tokens[k_of[r]] for _, r in active],
                            device=dev)
        outs = [model.decode(last, pos, kc, vc)
                for model, (kc, vc) in zip(models, caches)]
        for (slot, rid) in active:
            judge(rid, outs[0][slot:slot + 1], toks[slot:slot + 1])
            if control and rid in want:
                ctrl[rid].append(gaps(outs[0][slot:slot + 1],
                                      outs[1][slot:slot + 1].argmax(-1)))
            k_of[rid] += 1
        last = toks
        pos = pos + 1
    if any(v > 0 for v in left.values()):
        raise ValueError("the token stream ended before the sample's last "
                         "token")
    return ([torch.cat(served[r]) for r in sorted(want)],
            [torch.cat(ctrl[r]) for r in sorted(want)] if control else [])


def compare(readings: Dict[str, float], checks: Dict) -> Tuple[Dict, bool]:
    """The readings that ``checks`` names, each beside its limit, and
    whether every one is within it."""
    numbers = {k: {"value": v, "limit": float(checks[k])}
               for k, v in readings.items() if k in checks}
    return numbers, all(v["value"] <= v["limit"] for v in numbers.values())


def _readings(g: torch.Tensor) -> Dict[str, float]:
    g = g.float()
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean())}


def check(run, control: bool = False) -> Dict:
    """The numbers compared and their limits; ``correct`` is all of them
    within their limits. With ``control`` also the control's readings of
    the same numbers, put through the same comparison
    (``control_numbers``, ``control_correct``)."""
    exact_fp32_products()
    checks = run.config["checks"]
    picks = sample(run, int(checks["sample_requests"]))
    out: Dict = {"sampled_requests": len(picks)}
    if not picks:
        out["correct"] = False
        out["why"] = "the window finished no request"
        return out
    fn = _moe if "moe" in run.model else _dense
    try:
        served, ctrl = fn(run, picks, control)
    except ValueError as err:
        out["correct"] = False
        out["why"] = str(err)
        return out
    g = torch.cat(served)
    out["sampled_tokens"] = int(g.numel())
    out["readings"] = _readings(g)
    out["numbers"], out["correct"] = compare(out["readings"], checks)
    if control:
        out["control"] = _readings(torch.cat(ctrl))
        out["control_numbers"], out["control_correct"] = compare(
            out["control"], checks)
    return out
