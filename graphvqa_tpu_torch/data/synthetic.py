"""Synthetic GQA-shaped data for the port's data path (the port's own copy
of ``tools/make_synthetic_gqa.py``; the same seed writes byte-equal JSON).

Writes the artifacts the train CLI reads:

    <out>/questions/<split>_programs.json      11-field tuples
    <out>/sceneGraphs/train_sceneGraphs.json   GQA sceneGraphs format
    <out>/sceneGraphs/val_sceneGraphs.json

Scene statistics follow the GQA ground-truth scene-graph distribution:
object counts center ~17 with a long tail (clipped lognormal), ~1% of
scenes above 64 objects to exercise the dense ladder; each object carries
1-4 attributes and 1-4 outgoing relations; questions are template-generated
with GQA-like token lengths; answers come from the real 1842-answer
vocabulary and are derivable from the scene; programs and execution buffers
reference real node indices.

    python -m graphvqa_tpu_torch.data.synthetic --out /tmp/syngqa \
        --train-questions 120000 --val-questions 10000 --scenes 9000
"""
from __future__ import annotations

import argparse
import json
import pathlib
import random

from graphvqa_tpu_torch.data.vocab import _ASSET_DIR, load_answer_maps


def _load_lines(name):
    return [ln for ln in (_ASSET_DIR / name).read_text().splitlines() if ln]


def sample_num_objects(rng: random.Random) -> int:
    """Clipped lognormal: median ~15, p99 ~55, ~1% >64 (GQA-like tail)."""
    n = int(rng.lognormvariate(2.7, 0.55)) + 2
    return min(n, 120)


def make_scene(rng: random.Random, names, attrs, rels) -> dict:
    n = sample_num_objects(rng)
    w, h = 500, 375
    objects = {}
    oids = [str(1000000 + i) for i in range(n)]
    for i, oid in enumerate(oids):
        n_rel = rng.randint(1, 4) if n > 1 else 0
        targets = [oids[rng.randrange(n)] for _ in range(n_rel)]
        objects[oid] = {
            "name": rng.choice(names),
            # >=1 attribute, so attribute-query questions always have a
            # scene-derivable ground truth
            "attributes": [rng.choice(attrs)
                           for _ in range(rng.randint(1, 4))],
            "relations": [{"object": t, "name": rng.choice(rels)}
                          for t in targets if t != oid],
            "x": rng.randrange(0, w - 40), "y": rng.randrange(0, h - 40),
            "w": rng.randrange(20, 200), "h": rng.randrange(20, 150),
        }
    return {"width": w, "height": h, "objects": objects}


_STRUCTURAL = ["query", "verify", "choose", "logical", "compare"]
_SEMANTIC = ["attr", "obj", "rel", "cat", "global"]


_KINDS = ("attr_query", "exist", "verify_attr")


def make_question(rng: random.Random, qid: int, image_id: str, scene: dict,
                  answers, attrs, rels, names, kinds=_KINDS):
    """Answers are DERIVABLE from the scene graph (not random), so training
    on this data is a real learning task: existence questions are answered
    by scene content, attribute queries by the queried object's first
    attribute — the supervised mapping a scene-graph QA model must learn.
    Only answers present in the 1842-answer vocabulary are emitted."""
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
        # attribute query: ground truth = the object's first attribute
        question = f"What is the {name0} like?"
        answer = objects[oids[i0]]["attributes"][0]
        full = f"The {name0} is {answer}."
        instrs = [f"select ( {name0} )", "query ( [0], attribute )"]
        buffer = [[i0], [i0]]
    elif kind == 1:
        # existence: half present, half absent (drawn from the name vocab)
        if rng.random() < 0.5:
            probe = name1
            answer = "yes"
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
        # verify-attribute: half true, half false
        true_attr = objects[oids[i0]]["attributes"][0]
        if rng.random() < 0.5:
            probe_attr = true_attr
            answer = "yes"
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

    flat_tokens = []
    hier = []
    for s in instrs:
        toks = s.replace("(", " ( ").replace(")", " ) ").replace(",", " ,") \
                .split()
        hier.append(toks)
        flat_tokens += toks + ["<next>"]

    types = {"structural": rng.choice(_STRUCTURAL),
             "semantic": rng.choice(_SEMANTIC),
             "detailed": "synthetic"}
    return (
        image_id,          # 0
        question,          # 1
        [],                # 2
        str(qid),          # 3
        answer,            # 4
        full,              # 5
        flat_tokens,       # 6 (flat program tokens; vocab source)
        {},                # 7 annotations
        buffer,            # 8 execution buffer (node indices)
        hier,              # 9 hierarchical per-instruction tokens
        types,             # 10
    )


def write_synthetic_gqa(out, train_questions: int = 120000,
                        val_questions: int = 10000, scenes: int = 9000,
                        seed: int = 0, kinds=_KINDS, names: int = 0) -> None:
    """Write the train_balanced and val_balanced splits under ``out``
    (val gets scenes // 10 scenes). ``names`` > 0 restricts the object
    names to the first that many."""
    assert all(k in _KINDS for k in kinds), kinds
    rng = random.Random(seed)
    name_list = _load_lines("name_gqa.txt")
    if names:
        name_list = name_list[:names]
    rels = _load_lines("rel_gqa.txt")
    ans2label, _ = load_answer_maps()
    answers = sorted(ans2label.keys())
    # only attributes that are legal short answers become object attributes
    # (so every attribute-query/verify question is answerable)
    attrs = [a for a in _load_lines("attr_gqa.txt") if a in ans2label]

    out = pathlib.Path(out)
    (out / "questions").mkdir(parents=True, exist_ok=True)
    (out / "sceneGraphs").mkdir(parents=True, exist_ok=True)

    for split, n_q, n_s in (("train_balanced", train_questions, scenes),
                            ("val_balanced", val_questions,
                             max(scenes // 10, 1))):
        tag = "train" if "train" in split else "val"
        scene_map = {}
        for i in range(n_s):
            scene_map[f"{tag}{i}"] = make_scene(rng, name_list, attrs, rels)
        (out / "sceneGraphs" / f"{tag}_sceneGraphs.json").write_text(
            json.dumps(scene_map))

        sids = sorted(scene_map.keys())
        qs = []
        for q in range(n_q):
            sid = sids[rng.randrange(len(sids))]
            qs.append(make_question(rng, qid=q, image_id=sid,
                                    scene=scene_map[sid], answers=answers,
                                    attrs=attrs, rels=rels, names=name_list,
                                    kinds=kinds))
        (out / "questions" / f"{split}_programs.json").write_text(
            json.dumps(qs))
        n_obj = sorted(len(s["objects"]) for s in scene_map.values())
        print(f"{split}: {n_q} questions over {n_s} scenes | objects "
              f"median {n_obj[len(n_obj)//2]}, p99 "
              f"{n_obj[int(len(n_obj)*0.99)]}, max {n_obj[-1]}, "
              f">64: {sum(x > 64 for x in n_obj)}")


def write_scorer_questions(out, split: str = "val_balanced") -> pathlib.Path:
    """The split's questions in the official GQA questions format, for the
    scorer: every question balanced, its program as ``semantic`` steps and
    the objects of its first execution step as the question's and the full
    answer's annotations (the grounding metric's gold regions). Writes
    ``<out>/questions/<split>_questions.json`` and returns its path."""
    out = pathlib.Path(out)
    tag = "train" if "train" in split else "val"
    scenes = json.loads(
        (out / "sceneGraphs" / f"{tag}_sceneGraphs.json").read_text())
    data = json.loads(
        (out / "questions" / f"{split}_programs.json").read_text())
    questions = {}
    for d in data:
        oids = sorted(scenes[d[0]]["objects"])
        gold = {str(i): oids[n] for i, n in enumerate(d[8][0] if d[8] else [])}
        questions[d[3]] = {
            "imageId": d[0], "question": d[1], "answer": d[4],
            "fullAnswer": d[5], "isBalanced": True,
            "types": dict(d[10]), "groups": {"global": None, "local": ""},
            "semantic": [{"operation": instr[0], "dependencies": [],
                          "argument": " ".join(instr[2:-1])}
                         for instr in d[9]],
            "annotations": {"answer": {}, "question": gold,
                            "fullAnswer": gold},
            "entailed": [], "equivalent": [d[3]]}
    path = out / "questions" / f"{split}_questions.json"
    path.write_text(json.dumps(questions))
    return path


def main():
    p = argparse.ArgumentParser("synthetic GQA-shaped dataset generator")
    p.add_argument("--out", required=True)
    p.add_argument("--train-questions", type=int, default=120000)
    p.add_argument("--val-questions", type=int, default=10000)
    p.add_argument("--scenes", type=int, default=9000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kinds", default=",".join(_KINDS),
                   help="comma list of question kinds to emit "
                        f"(subset of {_KINDS})")
    p.add_argument("--names", type=int, default=0, metavar="N",
                   help="restrict the object-name vocabulary to the first N "
                        "names (0 = all)")
    args = p.parse_args()
    kinds = tuple(k.strip() for k in args.kinds.split(",") if k.strip())
    write_synthetic_gqa(args.out, args.train_questions, args.val_questions,
                        args.scenes, args.seed, kinds, args.names)


if __name__ == "__main__":
    main()
