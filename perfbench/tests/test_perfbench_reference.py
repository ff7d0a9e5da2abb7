"""The plain reference against the port's model at a CPU size, in fp32:
a prompt pass and decode steps of a dense model, and of an MoE model whose
capacity drops tokens (a prompt as one group; a decode step's batch as
one)."""
import json

import pytest
import torch

from perfbench.harness import manifest, weights
from perfbench.harness.serve import port_config
from perfbench.reference.model import Reference, gaps

DATA = manifest.BENCH / "tests" / "data"


def _setup(name, seed=3):
    cfg = json.loads((DATA / f"{name}.json").read_text())
    from repro_torch.models.model import Model
    params = weights.make(cfg["model"], seed, 1, torch.device("cpu"),
                          torch.float32)[0]
    model = Model(port_config(cfg), param_dtype=torch.float32, device="cpu")
    return cfg, model, params


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_perfbench_reference_prompt_and_steps_match_the_port(name):
    cfg, model, params = _setup(name)
    ref = Reference(cfg["model"], params)
    g = torch.Generator().manual_seed(5)
    S, steps, V = 37, 4, cfg["model"]["vocab_size"]
    seq = torch.randint(0, V, (S + steps,), generator=g)
    logits, cache = model.prefill(params, {"tokens": seq[None, :S]},
                                  cache_len=64)
    got = [logits[0, -1]]
    for i in range(steps):
        logits, cache = model.decode_step(params, seq[None, S + i:S + i + 1]
                                          .T.contiguous(), cache)
        got.append(logits[0, -1])
    if "moe" in cfg["model"]:
        # a decode step of one row routes alone: compare the prompt only
        got = got[:1]
    rows = torch.arange(S - 1, S - 1 + len(got))
    want, _ = ref.prompt(seq[:S + len(got) - 1], rows)
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4, atol=1e-4)


def test_perfbench_reference_batch_step_matches_the_port_with_drops():
    """One MoE decode step over B rows at different positions: the
    capacity (here 3 of 12 choices over 4 experts) drops choices, which
    depends on the batchmates, and the reference drops the same ones."""
    cfg, model, params = _setup("tiny-moe", seed=9)
    ref = Reference(cfg["model"], params)
    B, T = 6, 64
    m = cfg["model"]
    g = torch.Generator().manual_seed(1)
    cache = model.init_cache(B, T)
    L, Hkv, hd = m["num_hidden_layers"], m["num_key_value_heads"], \
        m["head_dim"]
    kc = torch.zeros(L, B, Hkv, T, hd)
    vc = torch.zeros(L, B, Hkv, T, hd)
    pos = torch.zeros(B, dtype=torch.long)
    toks = torch.zeros(B, dtype=torch.long)
    for b in range(B):
        S = 8 + 5 * b
        prompt = torch.randint(0, m["vocab_size"], (S,), generator=g)
        _, pc = model.prefill(params, {"tokens": prompt[None]}, cache_len=T)
        for key in ("k", "v"):
            cache["layers"][key][:, b] = pc["layers"][key][:, 0]
        cache["pos"][b] = S
        _, kvs = ref.prompt(prompt, torch.tensor([S - 1]))
        for l, (k, v) in enumerate(kvs):
            kc[l, b, :, :S], vc[l, b, :, :S] = k, v
        pos[b] = S
        toks[b] = int(prompt[-1])
    drops = 0
    for _ in range(3):
        logits, cache = model.decode_step(params, toks[:, None], cache)
        want = ref.decode(toks, pos, kc, vc)
        torch.testing.assert_close(logits[:, 0], want, rtol=1e-4, atol=1e-4)
        # the same step with one row alone routes differently somewhere
        alone = []
        for b in range(B):
            kb, vb = kc[:, b:b + 1].clone(), vc[:, b:b + 1].clone()
            alone.append(ref.decode(toks[b:b + 1], pos[b:b + 1], kb, vb)[0])
        drops += int((torch.stack(alone) - want).abs().max() > 1e-3)
        toks = logits[:, 0].argmax(-1)
        pos = pos + 1
    assert drops > 0, "the test batch never overflowed an expert"


def test_perfbench_gaps_and_fp8_control():
    logits = torch.tensor([[1.0, 3.0, 2.0], [0.5, 0.1, 0.4]])
    assert gaps(logits, torch.tensor([2, 0])).tolist() == [1.0, 0.0]
    cfg, _, params = _setup("tiny-dense")
    ref = Reference(cfg["model"], params)
    low = Reference(cfg["model"], params, "fp8")
    seq = torch.randint(0, cfg["model"]["vocab_size"], (40,),
                        generator=torch.Generator().manual_seed(2))
    rows = torch.arange(20, 40)
    a, _ = ref.prompt(seq, rows)
    b, _ = low.prompt(seq, rows)
    err = (a - b).abs().max()
    assert 1e-3 < err < 1.0
