"""The one traffic generator: a seed gives the same requests every time,
every seed the same multiset of sizes and arrivals, and an arrival law or
a sampling mix is a file and a key, not an edit."""

import collections
import json
import os

import pytest

from port_bench import loadgen

HERE = os.path.dirname(__file__)
PB = os.path.dirname(HERE)


def load(path):
    with open(path) as f:
        return json.load(f)


CFG = load(os.path.join(PB, "configs", "fastvlm-1.5b.json"))
MIXES = {n[:-5]: load(os.path.join(PB, "traffic", n))
         for n in os.listdir(os.path.join(PB, "traffic"))}


def shape(plan):
    return [(r.prompt, r.image, r.max_new, r.due, r.group, r.sampling)
            for r in plan.requests]


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_same_seed_same_requests(mix):
    small = dict(CFG, vision=dict(CFG["vision"], image_size=64))
    a = loadgen.build(MIXES[mix], small, 2 ** 31 + 17, 30)
    b = loadgen.build(MIXES[mix], small, 2 ** 31 + 17, 30)
    c = loadgen.build(MIXES[mix], small, 5, 30)
    assert shape(a) == shape(b)
    assert all((x == y).all() for x, y in zip(a.images, b.images))
    assert shape(a) != shape(c)
    sizes = MIXES[mix]["warmup"]["groups"]
    assert [len(g) for g in a.warmup] == [n for n in sizes for _ in (0, 1)]


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_every_seed_the_same_work(mix):
    small = dict(CFG, vision=dict(CFG["vision"], image_size=64))
    m = MIXES[mix]
    arr = m["arrivals"]
    block = len(arr["sizes"])
    plans = [loadgen.build(m, small, s, 51) for s in (1, 2, 3 * 10 ** 9)]
    for p in plans:
        sizes = collections.Counter(r.group for r in p.requests)
        # a window of whole blocks: every size as often, on every seed
        assert len(sizes) % block == 0
        assert sorted(sizes.values()) == sorted(
            arr["sizes"] * (len(sizes) // block))
        due = sorted({r.due for r in p.requests})
        assert due[1] - due[0] == pytest.approx(arr["period_s"])
        assert due[-1] < 51
    assert len({len(p.requests) for p in plans}) == 1


def test_a_new_arrival_law_is_a_file(tmp_path):
    laws = tmp_path / "arrivals"
    laws.mkdir()
    (laws / "poisson.py").write_text(
        "def due(params, rng, seconds):\n"
        "    t, out = 0.0, []\n"
        "    while True:\n"
        "        t += rng.exponential(1 / params['rate'])\n"
        "        if t >= seconds:\n"
        "            return out\n"
        "        out.append((t, 1))\n")
    m = dict(MIXES["vqa-shared"], arrivals={"law": "poisson", "rate": 4.0})
    small = dict(CFG, vision=dict(CFG["vision"], image_size=64))
    a = loadgen.build(m, small, 7, 20, root=str(tmp_path))
    b = loadgen.build(m, small, 7, 20, root=str(tmp_path))
    assert shape(a) == shape(b) and 40 < len(a.requests) < 130
    assert all(r.group == i for i, r in enumerate(a.requests))


def test_sampling_settings_are_dealt_and_greedy_marked():
    m = dict(MIXES["vqa-shared"], sampling=[{}, {"temperature": 0.7}])
    small = dict(CFG, vision=dict(CFG["vision"], image_size=64))
    plan = loadgen.build(m, small, 11, 20)
    greedy = [r.greedy for r in plan.requests]
    assert 0.4 < sum(greedy) / len(greedy) < 0.6
    assert all(r.sampling == {} for r in plan.requests if r.greedy)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_warmup_covers_the_longest_prompts(mix):
    small = dict(CFG, vision=dict(CFG["vision"], image_size=64))
    plan = loadgen.build(MIXES[mix], small, 3, 10)
    longest = max(len(r.prompt) for r in plan.requests)
    assert max(len(r.prompt) for g in plan.warmup for r in g) >= longest
    assert min(len(r.prompt) for g in plan.warmup for r in g) <= \
        min(len(r.prompt) for r in plan.requests)


def test_prompt_ids_match_the_template():
    prompt = loadgen.render("sys", "q?")
    ids, at = loadgen.prompt_ids(prompt, 4)
    head = "<|im_start|>system\nsys<|im_end|>\n<|im_start|>user\n"
    assert at == len(head)
    assert ids[:at] == list(head.encode())
    assert ids[at:at + 4] == [-1] * 4
    assert bytes(ids[at + 4:]).decode() == \
        "\nq?<|im_end|>\n<|im_start|>assistant\n"
    tok = loadgen.ByteIdTokenizer()
    assert loadgen.parse_ids(tok.decode([5, 151935, 0])) == [5, 151935, 0]


def test_shared_and_distinct_systems():
    small = dict(CFG, vision=dict(CFG["vision"], image_size=64))
    shared = loadgen.build(MIXES["vqa-shared"], small, 9, 10)
    own = loadgen.build(MIXES["vqa-unshared"], small, 9, 10)
    heads = {r.prompt.split("<|im_end|>")[0] for r in shared.requests}
    assert len(heads) == 1
    assert len(next(iter(heads))) == len("<|im_start|>system\n") + 1024
    heads = [r.prompt.split("<|im_end|>")[0] for r in own.requests]
    assert len(set(heads)) == len(heads)
