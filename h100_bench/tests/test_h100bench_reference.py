"""The plain reference held to independent hand-written versions at tiny
sizes, and its grammar held to the configuration's statement of the
serving grammar as the program compiles it."""

import json
import math
import random
import subprocess
import sys

import pytest
import torch

from h100_bench import weights
from h100_bench.reference import prompt as ref_prompt
from h100_bench.reference import qwen3
from h100_bench.reference import schema as ref_schema

TINY = {"hidden_size": 32, "intermediate_size": 48, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 8,
        "vocab_size": 300, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
        "tie_word_embeddings": False, "attention_bias": False}


def _float64_logits(p, m, tokens):
    """A second, loop-by-loop Qwen3 forward in float64 (per position and
    head), written apart from the reference."""
    H, Hkv, dh = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
    eps, theta = m["rms_norm_eps"], m["rope_theta"]
    f = {k: v.double() for k, v in p.items()}

    def norm(v, w):
        return v / math.sqrt(float((v * v).mean()) + eps) * w

    def rot(v, pos):
        out = v.clone()
        half = dh // 2
        for i in range(half):
            a = pos / theta ** (2 * i / dh)
            c, s = math.cos(a), math.sin(a)
            out[i] = v[i] * c - v[i + half] * s
            out[i + half] = v[i + half] * c + v[i] * s
        return out

    xs = [f["embed"][t].clone() for t in tokens]
    for li in range(m["num_hidden_layers"]):
        g = lambda n: f[f"layers.{li}.{n}"]  # noqa: E731
        ks, vs, qs = [], [], []
        for pos, x in enumerate(xs):
            h = norm(x, g("attn_norm"))
            q, k, v = h @ g("wq"), h @ g("wk"), h @ g("wv")
            qs.append([rot(norm(q[i * dh:(i + 1) * dh], g("q_norm")), pos) for i in range(H)])
            ks.append([rot(norm(k[i * dh:(i + 1) * dh], g("k_norm")), pos) for i in range(Hkv)])
            vs.append([v[i * dh:(i + 1) * dh] for i in range(Hkv)])
        new = []
        for t, x in enumerate(xs):
            heads = []
            for hq in range(H):
                kv = hq // (H // Hkv)
                sc = torch.tensor([float(qs[t][hq] @ ks[s][kv]) / math.sqrt(dh)
                                   for s in range(t + 1)], dtype=torch.float64)
                w = torch.softmax(sc, dim=0)
                heads.append(sum(w[s] * vs[s][kv] for s in range(t + 1)))
            x = x + torch.cat(heads) @ g("wo")
            h = norm(x, g("mlp_norm"))
            a = h @ g("w_gate")
            x = x + (a * torch.sigmoid(a) * (h @ g("w_up"))) @ g("w_down")
            new.append(x)
        xs = new
    return torch.stack([norm(x, f["final_norm"]) @ f["lm_head"] for x in xs])


def test_reference_block_against_float64():
    p = weights.draw(TINY, 123456789012, "cpu")
    tokens = [5, 17, 200, 3, 3, 99, 256, 41]
    want = _float64_logits(p, TINY, tokens)
    got = qwen3.Reference(p, TINY).logits([(tokens, 2)])[0]
    assert got.shape == (len(tokens) - 2, TINY["vocab_size"])
    assert torch.allclose(got.double(), want[2:], atol=2e-5, rtol=0)


def test_weights_repeat_from_the_seed():
    a = weights.draw(TINY, 2 ** 40 + 7, "cpu")
    b = weights.draw(TINY, 2 ** 40 + 7, "cpu")
    c = weights.draw(TINY, 2 ** 40 + 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.1.wq"], c["layers.1.wq"])
    assert a["layers.0.w_up"].dtype == torch.bfloat16


def test_blank_bytes_head_columns_are_drawn_smaller():
    """The LM head's columns of the bytes ``str.strip`` removes are drawn
    ``BLANK_SCALE`` times smaller, so a greedy row never favours a blank."""
    head = weights.draw(TINY, 2 ** 33 + 5, "cpu")["lm_head"].float()
    blanks = [b for b in range(256) if chr(b).strip() == "" and b < 128]
    assert blanks == list(weights.BLANKS)
    others = [b for b in range(TINY["vocab_size"]) if b not in weights.BLANKS]
    ratio = head[:, blanks].std() / head[:, others].std()
    assert 0.5 * weights.BLANK_SCALE < ratio < 2 * weights.BLANK_SCALE


def test_int4_quantizer_matches_the_stated_scheme():
    """The reference's own quantizer against the port's (the stated
    scheme: absmax / 7 per group of 128 rounded to bf16, round half to
    even, clamp to [-8, 7])."""
    from bcg_tpu_torch.models.quantize import quantize_weight_int4
    from bcg_tpu_torch.ops.w4_matmul import dequantize_int4

    g = torch.Generator().manual_seed(5)
    w = (torch.randn((512, 96), generator=g) / 20).to(torch.bfloat16)
    ours = qwen3.int4_dequantized(w, 128)
    theirs = dequantize_int4(quantize_weight_int4(w)).float()
    # The port rounds each dequantized value to bf16; the reference keeps float32.
    assert torch.allclose(ours.to(torch.bfloat16).float(), theirs, atol=0, rtol=0)
    assert (ours - w.float()).abs().max() > 0


def test_fp8_control_is_coarser():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((64, 256), generator=g)
    err8 = (qwen3.fp8_round(x, -1) - x).abs().max() / x.abs().max()
    err16 = (x.to(torch.bfloat16).float() - x).abs().max() / x.abs().max()
    assert err8 > 4 * err16


HONEST = {"type": "object", "properties": {
    "internal_strategy": {"type": "string", "minLength": 3},
    "value": {"type": "integer", "minimum": 0, "maximum": 50},
    "public_reasoning": {"type": "string", "minLength": 10}},
    "required": ["internal_strategy", "value", "public_reasoning"],
    "additionalProperties": False}
BYZANTINE = {"type": "object", "properties": {
    "internal_strategy": {"type": "string", "minLength": 3},
    "value": {"anyOf": [{"type": "integer", "minimum": 0, "maximum": 50},
                        {"type": "string", "enum": ["abstain"]}]},
    "public_reasoning": {"type": "string"}},
    "required": ["internal_strategy", "value"], "additionalProperties": False}
VOTE = {"type": "object", "properties": {"decision": {"type": "string",
                                                      "enum": ["stop", "continue"]}},
        "required": ["decision"], "additionalProperties": False}


@pytest.mark.parametrize("schema", [HONEST, BYZANTINE, VOTE], ids=["honest", "byzantine", "vote"])
def test_grammar_agrees_with_the_programs_token_automaton(schema):
    """On random walks, the reference's allowed bytes at each position,
    under a token budget, equal those the port's compiled automaton and
    its budget table allow."""
    from bcg_tpu_torch.engine.tokenizer import ByteTokenizer
    from bcg_tpu_torch.guided.processor import compile_schema

    tk = ByteTokenizer(512)
    td = compile_schema(schema, tk.token_bytes(), vocab_id=tk.vocab_id).token_dfa
    ours = ref_schema.automaton(schema)
    rng = random.Random(11)
    for walk in range(12):
        budget = rng.choice([60, 90, 140])
        s, st = td.start, ours.start
        for pos in range(budget):
            left = budget - pos
            nxt = td.transitions[s]
            theirs = [b for b in range(256) if nxt[b] >= 0 and td.dist[nxt[b]] + 1 <= left]
            assert ours.allowed(st, left) == theirs, (walk, pos)
            assert ours.accepting(st) == bool(td.accepting[s])
            if not theirs:
                break
            b = rng.choice(theirs)
            s, st = nxt[b], ours.step(st, b)


def test_schema_validator_and_walk():
    ok = '{"internal_strategy": "abc", "value": 7, "public_reasoning": "0123456789"}'
    assert ref_schema.check_text(ok, HONEST) is None
    assert ref_schema.check_text(ok.replace("7", "70"), HONEST) == "value: above maximum"
    assert ref_schema.check_text('{"decision": "stop"}', VOTE) is None
    assert ref_schema.check_text('{"decision": "halt"}', VOTE) is not None
    assert "not JSON" in ref_schema.check_text('{"decision": ', VOTE)
    served = list(b'{"decision": "stop"}') + [256]
    fault, positions = ref_schema.walk(VOTE, served, 40, 256)
    assert fault is None and len(positions) == len(served)
    assert positions[-1] == ([], True)
    bad = list(b'{"decision":  "stop"}') + [256]   # two spaces are allowed, four are not
    assert ref_schema.walk(VOTE, bad, 40, 256)[0] is None
    assert ref_schema.walk(VOTE, list(b'{"decision":     "stop"}') + [256], 40, 256)[0]


def test_prompt_is_chatml_bytes():
    tok = {"kind": "bytes", "template": "chatml", "eos_id": 256}
    ids = ref_prompt.prompt_tokens("sys", ("core ", "tail"), tok)
    assert bytes(ids).decode() == ("<|im_start|>system\nsys<|im_end|>\n<|im_start|>user\n"
                                   "core tail<|im_end|>\n<|im_start|>assistant\n")
    assert ref_prompt.served_tokens("{}", 5, tok) == [123, 125, 256]
    assert ref_prompt.served_tokens("{}", 2, tok) == [123, 125]


def test_prompt_matches_the_programs_template_and_tokenizer():
    from bcg_tpu_torch.engine.chat_template import format_chat_parts
    from bcg_tpu_torch.engine.tokenizer import ByteTokenizer

    pre, suf = format_chat_parts("bcg-tpu/bench-8b", "You are agent_3.", "Round 2: go")
    tok = {"kind": "bytes", "template": "chatml", "eos_id": 256}
    tk = ByteTokenizer(151936)
    assert tk.encode(pre) + tk.encode(suf) == ref_prompt.prompt_tokens(
        "You are agent_3.", "Round 2: go", tok)
    assert tk.eos_id == 256


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import h100_bench.reference.qwen3, h100_bench.reference.schema, "
            "h100_bench.reference.prompt, h100_bench.weights; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('bcg_tpu_torch', 'bcg_tpu', 'jax', 'jaxlib', 'flax')); print(json.dumps(bad))")
    out = subprocess.run([sys.executable, "-c", "import json; " + code], capture_output=True,
                         text=True, timeout=120, cwd=_root())
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _root():
    import os

    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
