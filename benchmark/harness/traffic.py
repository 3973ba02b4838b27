"""GQA-shaped traffic from a seed: a frozen copy of the port's synthetic
generator (``data/synthetic.py``), with the word lists it draws from under
``benchmark/assets/``, so a change to the program cannot change the traffic.

Scenes follow the GQA ground-truth scene-graph statistics: object counts
from a clipped lognormal (median ~15, p99 ~55, ~1 % above 64 objects, so a
few batches climb the dense ladder), 1-4 attributes and 1-4 outgoing
relations per object. Questions are templated (attribute query, existence,
verify-attribute), their answers derivable from the scene and drawn from
the 1,842-answer vocabulary, their programs and execution buffers pointing
at real nodes. Unlike the port's generator, the scenes' structure is drawn
apart from their words (``make_split``), so that the seed changes the
words and the order and never the set of graph sizes.

A traffic mix is a JSON file ``benchmark/traffic/<name>.json``; this module
reads it and writes the split it names as the files the port's
``GQADataset`` reads:

    <out>/questions/<split>_programs.json     11-field tuples
    <out>/sceneGraphs/<train|val>_sceneGraphs.json
"""
from __future__ import annotations

import json
import pathlib
import random

ROOT = pathlib.Path(__file__).resolve().parents[1]
ASSETS = ROOT / "assets"
TRAFFIC_DIR = ROOT / "traffic"

_STRUCTURAL = ["query", "verify", "choose", "logical", "compare"]
_SEMANTIC = ["attr", "obj", "rel", "cat", "global"]
_KINDS = ("attr_query", "exist", "verify_attr")


def load_lines(name: str) -> list:
    return [ln for ln in (ASSETS / name).read_text().splitlines() if ln]


def answer_map() -> dict:
    return json.loads((ASSETS / "trainval_ans2label.json").read_text())


def load_traffic(name: str) -> dict:
    """The traffic mix ``name`` (its JSON file), with its name added."""
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no traffic file {path}")
    return dict(json.loads(path.read_text()), name=name)


def sample_num_objects(rng: random.Random) -> int:
    """Clipped lognormal: median ~15, p99 ~55, ~1 % above 64."""
    n = int(rng.lognormvariate(2.7, 0.55)) + 2
    return min(n, 120)


def make_scene(shape: random.Random, words: random.Random, names, attrs,
               rels) -> dict:
    """One scene: its structure (object count, relation targets, boxes)
    from ``shape``, its words (names, attributes, relation names) from
    ``words``."""
    n = sample_num_objects(shape)
    w, h = 500, 375
    objects = {}
    oids = [str(1000000 + i) for i in range(n)]
    for oid in oids:
        n_rel = shape.randint(1, 4) if n > 1 else 0
        targets = [oids[shape.randrange(n)] for _ in range(n_rel)]
        objects[oid] = {
            "name": words.choice(names),
            "attributes": [words.choice(attrs)
                           for _ in range(shape.randint(1, 4))],
            "relations": [{"object": t, "name": words.choice(rels)}
                          for t in targets if t != oid],
            "x": shape.randrange(0, w - 40), "y": shape.randrange(0, h - 40),
            "w": shape.randrange(20, 200), "h": shape.randrange(20, 150),
        }
    return {"width": w, "height": h, "objects": objects}


def make_question(rng: random.Random, qid: int, image_id: str, scene: dict,
                  attrs, rels, names, kinds=_KINDS):
    """One 11-field tuple whose answer follows from the scene."""
    objects = scene["objects"]
    oids = sorted(objects.keys())
    i0 = rng.randrange(len(oids))
    name0 = objects[oids[i0]]["name"]
    i1 = rng.randrange(len(oids))
    name1 = objects[oids[i1]]["name"]
    rel = rng.choice(rels)
    present = {o["name"] for o in objects.values()}

    kind = _KINDS.index(rng.choice(kinds))
    if kind == 0:
        question = f"What is the {name0} like?"
        answer = objects[oids[i0]]["attributes"][0]
        full = f"The {name0} is {answer}."
        instrs = [f"select ( {name0} )", "query ( [0], attribute )"]
        buffer = [[i0], [i0]]
    elif kind == 1:
        if rng.random() < 0.5:
            probe, answer = name1, "yes"
        else:
            probe = rng.choice(names)
            while probe in present:
                probe = rng.choice(names)
            answer = "no"
        question = f"Is there a {probe} in the picture?"
        full = f"{answer.capitalize()}, there is " + \
            ("a " if answer == "yes" else "no ") + f"{probe}."
        instrs = [f"select ( {probe} )", "exist ( [0] )"]
        buffer = [[i1], [i1]] if answer == "yes" else [[], []]
    else:
        true_attr = objects[oids[i0]]["attributes"][0]
        if rng.random() < 0.5:
            probe_attr, answer = true_attr, "yes"
        else:
            probe_attr = rng.choice(attrs)
            while probe_attr == true_attr:
                probe_attr = rng.choice(attrs)
            answer = "no"
        question = f"Is the {name0} {rel} the {name1} {probe_attr}?"
        full = f"{answer.capitalize()}, the {name0} is " + \
            ("" if answer == "yes" else "not ") + f"{probe_attr}."
        instrs = [f"select ( {name0} )",
                  f"relate_name ( [0], {rel}, {name1} )",
                  f"verify_attr ( [0], {probe_attr} )"]
        buffer = [[i0], [i1], [i0]]

    flat_tokens, hier = [], []
    for s in instrs:
        toks = s.replace("(", " ( ").replace(")", " ) ").replace(",", " ,") \
                .split()
        hier.append(toks)
        flat_tokens += toks + ["<next>"]
    types = {"structural": rng.choice(_STRUCTURAL),
             "semantic": rng.choice(_SEMANTIC), "detailed": "synthetic"}
    return (image_id, question, [], str(qid), answer, full, flat_tokens, {},
            buffer, hier, types)


def make_split(traffic: dict, seed: int):
    """(questions, scenes) of the traffic's split. The scenes' structure
    comes from the mix's own ``structure_seed`` and each scene is asked
    ``questions / scenes`` questions, so every seed has the same set of
    graph sizes; ``seed`` draws the words, the questions and, unless the
    mix fixes it (``fixed_order``), their order."""
    words = random.Random(seed)
    shape = random.Random(traffic["structure_seed"])
    names = load_lines("name_gqa.txt")
    rels = load_lines("rel_gqa.txt")
    ans2label = answer_map()
    attrs = [a for a in load_lines("attr_gqa.txt") if a in ans2label]
    tag = "train" if "train" in traffic["split"] else "val"
    n_s, n_q = traffic["scenes"], traffic["questions"]
    if n_q % n_s:
        raise ValueError(f"{n_q} questions do not divide over {n_s} scenes")
    scenes = {f"{tag}{i}": make_scene(shape, words, names, attrs, rels)
              for i in range(n_s)}
    sids = sorted(scenes) * (n_q // n_s)
    # the order of the questions: fixed with the structure (every seed then
    # has the same batches in file order), or drawn from the seed
    (shape if traffic.get("fixed_order") else words).shuffle(sids)
    kinds = tuple(traffic.get("kinds", _KINDS))
    questions = [make_question(words, q, sid, scenes[sid], attrs, rels,
                               names, kinds) for q, sid in enumerate(sids)]
    return questions, scenes


def split_paths(out: pathlib.Path, traffic: dict):
    """(programs path, scene-graphs path) of the split under ``out``."""
    tag = "train" if "train" in traffic["split"] else "val"
    return (out / "questions" / f"{traffic['split']}_programs.json",
            out / "sceneGraphs" / f"{tag}_sceneGraphs.json")


def write_split(out: pathlib.Path, traffic: dict, questions, scenes):
    """Write the split as the port's dataset reads it -> (programs path,
    scene-graphs path)."""
    programs, graphs = split_paths(out, traffic)
    programs.parent.mkdir(parents=True, exist_ok=True)
    graphs.parent.mkdir(parents=True, exist_ok=True)
    programs.write_text(json.dumps(questions))
    graphs.write_text(json.dumps(scenes))
    return programs, graphs
