"""Official GQA scorer — accuracy / binary / open / validity / plausibility /
consistency / distribution / grounding + per-type breakdowns (the port's own
copy of ``graphvqa_tpu/eval/scorer.py``):

    python -m graphvqa_tpu_torch.eval.scorer --questions Q.json \
        --predictions dump_results.json [--grounding --attentions A.json \
        --scenes S.json]

Clean reimplementation of the official evaluation protocol (reference:
eval.py:170-478), consuming the ``dump_results.json`` produced by
``graphvqa_tpu_torch.train.loop.validate`` (same schema as
mainExplain_gat.py:863-942).

Semantics preserved:
  * metrics are computed over ``isBalanced`` questions only;
  * missing predictions default to 'yes' (eval.py:150-158);
  * binary vs open split = structural type == 'query' -> open (eval.py:389);
  * validity/plausibility membership checks with the "Common" -> [color,
    material, shape] normalization (eval.py:240-245);
  * consistency = mean correctness of entailed questions, counted only when
    the source question is correct (eval.py:250-266);
  * distribution = chi-square of gold vs predicted answer histograms per
    global group, weighted by group size, / 100 (eval.py:345-362,414);
  * steps count excludes exist / query:name / choose name ops (eval.py:217-219).
"""
from __future__ import annotations

import argparse
import json
import pathlib
from collections import defaultdict
from typing import Dict, Optional


def _avg(lst):
    return float(sum(lst)) / len(lst) if lst else 0.0


def _steps_num(question: dict) -> int:
    return len([c for c in question["semantic"]
                if not any(o in "{}: {}".format(c["operation"], c["argument"])
                           for o in ("exist", "query: name", "choose name"))])


def _belongs(element, group, question) -> bool:
    if "Common" in question["types"]["detailed"]:
        group = ["color", "material", "shape"]
    return element in group


# ---------------------------------------------------------------------------
# Grounding score (eval.py:268-338): how much attention mass the model places
# on the regions the question/answer annotations point at.
# ---------------------------------------------------------------------------

def _interval_overlap(a0, a1, b0, b1) -> float:
    lo, hi = max(a0, b0), min(a1, b1)
    return hi - lo if hi > lo else 0.0


def _intersection_rate(cell, region) -> float:
    """Fraction of ``cell`` covered by ``region`` (eval.py:294-298).
    c = (x0, y0, x1, y1), normalized to [0, 1]."""
    inter = (_interval_overlap(cell[0], cell[2], region[0], region[2])
             * _interval_overlap(cell[1], cell[3], region[1], region[3]))
    area = (cell[2] - cell[0]) * (cell[3] - cell[1])
    return inter / area if area > 0 else 0.0


def _region_of(scene: dict, object_id: str):
    obj = scene["objects"].get(str(object_id))
    if obj is None:
        return None
    w = float(scene.get("width", 1)) or 1.0
    h = float(scene.get("height", 1)) or 1.0
    return (obj["x"] / w, obj["y"] / h,
            (obj["x"] + obj["w"]) / w, (obj["y"] + obj["h"]) / h)


def grounding_score(
    question: dict,
    scene: dict,
    attention,
    object_features: bool = True,
    map_size: int = 7,
):
    """Attention mass on gold regions (eval.py:316-338).

    ``attention`` is either a list of [x0, y0, x1, y1, att] rows (object-based
    attention, the format our validate() dumps) or a map_size x map_size
    spatial grid. Gold regions come from the question/fullAnswer annotation
    pointers plus the whole image when any op mentions the scene. NOTE: the
    reference's object-features branch reads an undefined variable
    (eval.py:329, ``cells`` used before assignment) — this implements the
    intended semantics.
    """
    regions = []
    ann = question.get("annotations", {})
    for pointer in ann.get("question", {}).values():
        r = _region_of(scene, pointer)
        if r is not None:
            regions.append(r)
    for pointer in ann.get("fullAnswer", {}).values():
        r = _region_of(scene, pointer)
        if r is not None:
            regions.append(r)
    if any("scene" in c.get("operation", "") or "scene" in str(c.get("argument", ""))
           for c in question.get("semantic", [])):
        regions.append((0.0, 0.0, 1.0, 1.0))

    if object_features:
        cells = [((r[0], r[1], r[2], r[3]), r[4]) for r in attention]
    else:
        edge = 1.0 / map_size
        cells = [((edge * i, edge * j, edge * (i + 1), edge * (j + 1)),
                  attention[i][j])
                 for i in range(map_size) for j in range(map_size)]

    return sum(att * _intersection_rate(cell, region)
               for region in regions for cell, att in cells)


def score_predictions(
    questions: Dict[str, dict],
    predictions: Dict[str, str],
    choices: Optional[Dict[str, dict]] = None,
    consistency: bool = False,
    attentions: Optional[Dict[str, list]] = None,
    scenes: Optional[Dict[str, dict]] = None,
    object_features: bool = True,
    map_size: int = 7,
) -> dict:
    """Compute the official metric dict.

    Args:
      questions: raw GQA questions (val_all for consistency, else balanced)
      predictions: questionId -> predicted short answer
      choices: questionId -> {"valid": [...], "plausible": [...]} (optional)
      consistency: include the consistency metric (needs entailed coverage)
      attentions: questionId -> attention map (object rows or spatial grid)
                  for the grounding metric (optional, needs scenes)
      scenes: imageId -> scene graph (for grounding gold regions)
      object_features: attentions are [x0,y0,x1,y1,att] rows, not a grid
      map_size: spatial grid size when object_features=False (eval.py:84)
    """
    # missing predictions default to 'yes'
    predictions = dict(predictions)
    for qid, q in questions.items():
        if qid not in predictions and (consistency or q.get("isBalanced")):
            predictions[qid] = "yes"

    scores = {
        "accuracy": [], "binary": [], "open": [],
        "validity": [], "plausibility": [], "consistency": [],
        "accuracyPerStructuralType": defaultdict(list),
        "accuracyPerSemanticType": defaultdict(list),
        "accuracyPerLength": defaultdict(list),
        "accuracyPerSteps": defaultdict(list),
        "grounding": [],
    }
    dist_gold: dict = defaultdict(lambda: defaultdict(int))
    dist_pred: dict = defaultdict(lambda: defaultdict(int))

    for qid, q in questions.items():
        if not q.get("isBalanced"):
            continue
        gold = q["answer"]
        predicted = predictions[qid]
        correct = predicted == gold
        score = 1.0 if correct else 0.0

        scores["accuracy"].append(score)
        scores["accuracyPerLength"][len(q["question"].split())].append(score)
        scores["accuracyPerSteps"][_steps_num(q)].append(score)
        scores["accuracyPerStructuralType"][q["types"]["structural"]].append(score)
        scores["accuracyPerSemanticType"][q["types"]["semantic"]].append(score)
        answer_type = "open" if q["types"]["structural"] == "query" else "binary"
        scores[answer_type].append(score)

        if choices is not None and qid in choices:
            scores["validity"].append(
                1.0 if _belongs(predicted, choices[qid]["valid"], q) else 0.0)
            scores["plausibility"].append(
                1.0 if _belongs(predicted, choices[qid]["plausible"], q) else 0.0)

        if (attentions is not None and scenes is not None
                and qid in attentions and q.get("imageId") in scenes):
            scores["grounding"].append(grounding_score(
                q, scenes[q["imageId"]], attentions[qid],
                object_features=object_features, map_size=map_size))

        group = q.get("groups", {}).get("global")
        if group is not None and group != "":
            dist_gold[group][gold] += 1
            dist_pred[group][predicted] += 1

        if consistency and correct:
            inferred = [e for e in q.get("entailed", []) if e != qid]
            if inferred:
                cons, any_present = [], False
                for eid in inferred:
                    if eid not in questions:
                        continue
                    any_present = True
                    cons.append(
                        1.0 if predictions.get(eid) == questions[eid]["answer"]
                        else 0.0)
                if any_present:
                    scores["consistency"].append(_avg(cons))

    # chi-square distribution metric
    sum_score = sum_overall = 0.0
    for group in dist_gold:
        g_score = overall = 0.0
        for ans, e in dist_gold[group].items():
            o = dist_pred[group].get(ans, 0)
            g_score += (float(o - e) ** 2) / e
            overall += e
        sum_score += g_score * overall
        sum_overall += overall
    distribution = (sum_score / sum_overall / 100.0) if sum_overall else 0.0

    out = {
        "accuracy": _avg(scores["accuracy"]) * 100,
        "binary": _avg(scores["binary"]) * 100,
        "open": _avg(scores["open"]) * 100,
        "validity": _avg(scores["validity"]) * 100,
        "plausibility": _avg(scores["plausibility"]) * 100,
        "consistency": _avg(scores["consistency"]) * 100,
        "grounding": _avg(scores["grounding"]) * 100,
        "distribution": distribution,
        "accuracyPerStructuralType": {
            k: (_avg(v) * 100, len(v))
            for k, v in scores["accuracyPerStructuralType"].items()},
        "accuracyPerSemanticType": {
            k: (_avg(v) * 100, len(v))
            for k, v in scores["accuracyPerSemanticType"].items()},
        "accuracyPerSteps": {
            k: (_avg(v) * 100, len(v))
            for k, v in scores["accuracyPerSteps"].items()},
        "accuracyPerLength": {
            k: (_avg(v) * 100, len(v))
            for k, v in scores["accuracyPerLength"].items()},
        "num_questions": len(scores["accuracy"]),
    }
    return out


def format_report(scores: dict, consistency: bool = False,
                  grounding: bool = False) -> str:
    """Human-readable report in the eval_result/* layout (eval.py:444-478)."""
    lines = []
    for m in ("binary", "open", "accuracy", "consistency", "validity",
              "plausibility", "grounding", "distribution"):
        if m == "consistency" and not consistency:
            continue
        if m == "grounding" and not grounding:
            continue
        suffix = " (lower is better)" if m == "distribution" else "%"
        lines.append(f"{m.capitalize()}: {scores[m]:.2f}{suffix}")
    for key, title in (
            ("accuracyPerStructuralType", "Accuracy / structural type"),
            ("accuracyPerSemanticType", "Accuracy / semantic type"),
            ("accuracyPerSteps", "Accuracy / steps number"),
            ("accuracyPerLength", "Accuracy / words number")):
        lines.append("")
        lines.append(f"{title}:")
        for t in sorted(scores[key]):
            s, n = scores[key][t]
            lines.append(f"  {t}: {s:.2f}% ({n} questions)")
    return "\n".join(lines)


def load_json_or_chunks(name):
    """Load a JSON file, or merge a directory of chunks (the official
    eval.py's big-file protocol, eval.py:102-116).

    Accepts: (a) a plain file; (b) a path whose stem names a sibling chunk
    directory, e.g. ``val_all_questions.json`` with chunks at
    ``val_all_questions/val_all_questions_*.json`` (the reference layout);
    (c) a directory itself, merging every ``*.json`` inside.  Dict chunks
    merge by key update; list chunks concatenate.
    """
    p = pathlib.Path(name)
    if p.is_file():
        return json.loads(p.read_text())
    if p.is_dir():
        chunks = sorted(p.glob("*.json"))
    else:
        # reference form: name="dir.json" -> chunks dir/dir_*.json
        stem_dir = p.with_suffix("")
        if not stem_dir.is_dir():
            raise FileNotFoundError(f"can't find {name} (no file, no chunk "
                                    f"directory {stem_dir})")
        ext = p.suffix.lstrip(".") or "json"
        chunks = sorted(stem_dir.glob(f"{stem_dir.name}_*.{ext}"))
    if not chunks:
        raise FileNotFoundError(f"no JSON chunks found for {name}")
    data = None
    for chunk in chunks:
        part = json.loads(chunk.read_text())
        if data is None:
            data = part
        elif isinstance(data, dict):
            data.update(part)
        else:
            data.extend(part)
    return data


def main():
    parser = argparse.ArgumentParser("GQA official scorer")
    parser.add_argument("--questions", required=True)
    parser.add_argument("--predictions", required=True,
                        help="dump_results.json from validate(); every file "
                             "argument also accepts a directory of chunks "
                             "(official eval.py:102-116)")
    parser.add_argument("--choices", default=None)
    parser.add_argument("--consistency", action="store_true")
    parser.add_argument("--grounding", action="store_true")
    parser.add_argument("--attentions", default=None,
                        help="attentions json from validate()")
    parser.add_argument("--scenes", default=None,
                        help="scene graphs json (gold regions for grounding)")
    parser.add_argument("--spatial-features", action="store_true",
                        help="attentions are map-size x map-size grids "
                             "instead of object rows (eval.py:83)")
    parser.add_argument("--map-size", type=int, default=7)
    args = parser.parse_args()

    questions = load_json_or_chunks(args.questions)
    dump = load_json_or_chunks(args.predictions)
    predictions = {qid: d["prediction"] for qid, d in dump.items()}
    choices = load_json_or_chunks(args.choices) if args.choices else None
    attentions = scenes = None
    if args.grounding:
        if not args.attentions or not args.scenes:
            parser.error("--grounding requires --attentions and --scenes")
        raw = load_json_or_chunks(args.attentions)
        attentions = {a["questionId"]: a["attention"] for a in raw}
        scenes = load_json_or_chunks(args.scenes)
    scores = score_predictions(questions, predictions, choices,
                               consistency=args.consistency,
                               attentions=attentions, scenes=scenes,
                               object_features=not args.spatial_features,
                               map_size=args.map_size)
    print(format_report(scores, consistency=args.consistency,
                        grounding=args.grounding))


if __name__ == "__main__":
    main()
