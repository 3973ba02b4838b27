"""Offline preprocessing: GQA ``semantic`` op lists -> canonical DSL programs
(the port's own copy of ``graphvqa_tpu/data/preprocess.py``).

Re-implementation of the reference preprocessor (reference: preprocess.py:187-594):

  * translates each GQA semantic operation into one line of the 36-function DSL
    (Constants.py:29-31), e.g. reversed ``relate`` -> ``relate_inv_name(...)``;
  * builds the per-step **execution buffer** of target object ids, propagating
    results through dependency edges (preprocess.py:238-261);
  * remaps GQA object ids to the *sorted* local node index used by the graph
    builder, skipping objects with degenerate bboxes (preprocess.py:451-520);
  * remaps pointer annotations the same way (preprocess.py:526-541);
  * emits both the flat decoder token stream (``generate_pairs``) and the
    per-instruction hierarchical streams (``generate_hierarchical_pairs``);
  * writes 11-field tuples in the exact layout the dataset reads
    (preprocess.py:558-570 / gqa_dataset_entry.py:479-491).

The reference's ``choose`` argument shuffling uses an unseeded global RNG
(preprocess.py:125-129) — here it is a seeded ``random.Random`` so artifacts
are reproducible; pass ``seed=None`` for reference-identical nondeterminism.
"""
from __future__ import annotations

import json
import pathlib
import random
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from graphvqa_tpu_torch.data.lemmatizer import lemmatize


# --------------------------------------------------------------------------
# argument-string parsing helpers (semantics of preprocess.py:41-129)
# --------------------------------------------------------------------------

def parse_pointer_argument(argument: str) -> Tuple[str, List[int]]:
    """'wall (722332)' -> ('[722332]', [722332]); '(-)' -> ('[]', [])."""
    inner = re.search(r"\((.+)\)", argument).group(1)
    if inner == "-":
        return "[]", []
    return "[{}]".format(inner), [int(s) for s in inner.split(",")]


def extract_rel(argument: str) -> Tuple[str, str, Optional[bool]]:
    """'_,on,s (722335)' -> ('_', 'on', True); no o/s marker -> reverse None."""
    subject = re.search(r"^([^,]+),", argument).group(1)
    relation = re.search(r",(.+),", argument).group(1)
    m = re.search(r",(o|s) ", argument)
    if m is None:
        return subject, relation, None
    return subject, relation, m.group(1) == "s"


def split_rel(argument: str) -> Tuple[str, str, str, bool]:
    subject = re.search(r"([^,]+),", argument).group(1)
    relation1 = re.search(r",(.+)\|", argument).group(1)
    relation2 = re.search(r"\|(.+),", argument).group(1)
    o_s = re.search(r",(o|s)", argument).group(1)
    return subject, relation1, relation2, o_s == "s"


def tokenize_program_line(line: str) -> List[str]:
    """'select(wall)' -> ['select', '(', 'wall', ')'] (preprocess.py:135-159)."""
    out: List[str] = []
    buf = ""
    for ch in line:
        if ch in "(),":
            if buf.strip():
                out.append(buf.strip())
            out.append(ch)
            buf = ""
        else:
            buf += ch
    if buf.strip():
        out.append(buf.strip())
    return out


def generate_pairs(lines: Sequence[str]) -> List[str]:
    """Flat decoder stream: instruction tokens joined with ';' separators."""
    out: List[str] = []
    for line in lines:
        _, rhs = line.split("=")
        out.extend(tokenize_program_line(rhs))
        out.append(";")
    if out:
        del out[-1]
    return out


def generate_hierarchical_pairs(lines: Sequence[str]) -> List[List[str]]:
    return [tokenize_program_line(line.split("=")[1]) for line in lines]


# --------------------------------------------------------------------------
# the op-by-op translation (semantics of preprocess.py:264-419)
# --------------------------------------------------------------------------

def translate_program(
    semantic: Sequence[dict],
    rng: random.Random,
) -> Tuple[List[str], List[List[int]]]:
    """GQA semantic steps -> (DSL lines, per-step execution buffer)."""
    lines: List[str] = []
    buffer: List[List[int]] = []
    flag = "partial"

    def shuffle_pair(arg: str) -> Tuple[str, str]:
        attrs = arg.split("|")
        rng.shuffle(attrs)
        return attrs[0], attrs[1]

    for i, prog in enumerate(semantic):
        op = prog["operation"]
        argument = prog["argument"]
        deps = prog["dependencies"]
        subject = ",".join("[{}]".format(d) for d in deps) if deps else ""

        # execution-buffer bookkeeping: pointer arguments name objects
        # directly; otherwise results flow from dependencies
        if "(" in argument and ")" in argument and "not(" not in argument:
            result, objects = parse_pointer_argument(argument)
        else:
            result = "?"
            objects = []
            for d in deps:
                objects.extend(buffer[d])
        buffer.append(objects)

        if op == "select":
            if argument == "scene":
                lines.append(f"{result}=scene()")
                flag = "full"
            else:
                name = lemmatize(argument.split(" ")[0])
                lines.append(f"{result}=select({name})")
                flag = "partial"

        elif op == "relate":
            name, relation, reverse = extract_rel(argument)
            if reverse is None:
                lines.append(f"{result}=relate_attr({subject}, {relation}, {name})")
            elif reverse:
                if name != "_":
                    lines.append(f"{result}=relate_inv_name({subject}, {relation}, {lemmatize(name)})")
                else:
                    lines.append(f"{result}=relate_inv({subject}, {relation})")
            else:
                if name != "_":
                    lines.append(f"{result}=relate_name({subject}, {relation}, {lemmatize(name)})")
                else:
                    lines.append(f"{result}=relate({subject}, {relation})")

        elif op.startswith("query"):
            if argument == "hposition":
                lines.append(f"{result}=query_h({subject})")
            elif argument == "vposition":
                lines.append(f"{result}=query_v({subject})")
            elif argument == "name":
                lines.append(f"{result}=query_n({subject})")
            elif flag == "full":
                lines.append(f"{result}=query_f({argument})")
            else:
                lines.append(f"{result}=query({subject}, {argument})")

        elif op == "exist":
            lines.append(f"{result}=exist({subject})")
        elif op == "or":
            lines.append(f"{result}=or({subject})")
        elif op == "and":
            lines.append(f"{result}=and({subject})")

        elif op.startswith("filter"):
            if op in ("filter hposition", "filter vposition"):
                # both map to filter_h in the reference (preprocess.py:317-321)
                lines.append(f"{result}=filter_h({subject}, {argument})")
            elif "not(" in argument:
                lines.append(f"{result}=filter_not({subject}, {argument[4:-1]})")
            else:
                lines.append(f"{result}=filter({subject}, {argument})")

        elif op.startswith("verify"):
            if op == "verify":
                lines.append(f"{result}=verify({subject}, {argument})")
            elif op == "verify hposition":
                lines.append(f"{result}=verify_h({subject}, {argument})")
            elif op == "verify vposition":
                lines.append(f"{result}=verify_v({subject}, {argument})")
            elif op == "verify rel":
                name, relation, reverse = extract_rel(argument)
                name = lemmatize(name)
                if reverse:
                    lines.append(f"{result}=verify_rel_inv({subject}, {relation}, {name})")
                else:
                    lines.append(f"{result}=verify_rel({subject}, {relation}, {name})")
            elif flag == "full":
                lines.append(f"{result}=verify_f({argument})")
            else:
                lines.append(f"{result}=verify({subject}, {argument})")

        elif op.startswith("choose"):
            if op == "choose":
                a1, a2 = shuffle_pair(argument)
                if flag == "full":
                    lines.append(f"{result}=choose_f({a1}, {a2})")
                else:
                    lines.append(f"{result}=choose({subject}, {a1}, {a2})")
            elif op == "choose rel":
                name, r1, r2, reverse = split_rel(argument)
                r1, r2 = shuffle_pair(f"{r1}|{r2}")
                name = lemmatize(name)
                # NOTE: the reference maps reverse->choose_rel and
                # forward->choose_rel_inv (preprocess.py:368-373); kept as-is
                if reverse:
                    lines.append(f"{result}=choose_rel({subject}, {name}, {r1}, {r2})")
                else:
                    lines.append(f"{result}=choose_rel_inv({subject}, {name}, {r1}, {r2})")
            elif op == "choose hposition":
                a1, a2 = shuffle_pair(argument)
                lines.append(f"{result}=choose_h({subject}, {a1}, {a2})")
            elif op == "choose vposition":
                a1, a2 = shuffle_pair(argument)
                lines.append(f"{result}=choose_v({subject}, {a1}, {a2})")
            elif op == "choose name":
                a1, a2 = shuffle_pair(argument)
                lines.append(f"{result}=choose_n({subject}, {lemmatize(a1)}, {lemmatize(a2)})")
            elif " " in op:
                attr = op.split(" ")[1]
                if len(argument) == 0:
                    lines.append(f"{result}=choose_subj({subject}, {attr})")
                else:
                    a1, a2 = shuffle_pair(argument)
                    if flag == "full":
                        lines.append(f"{result}=choose_f({a1}, {a2})")
                    else:
                        lines.append(f"{result}=choose_attr({subject}, {attr}, {a1}, {a2})")
            else:
                raise ValueError(f"unseen choose variant {prog}")

        elif op.startswith("different"):
            if " " in op:
                lines.append(f"{result}=different_attr({subject}, {op.split(' ')[1]})")
            else:
                lines.append(f"{result}=different({subject})")
        elif op.startswith("same"):
            if " " in op:
                lines.append(f"{result}=same_attr({subject}, {op.split(' ')[1]})")
            else:
                lines.append(f"{result}=same({subject})")
        elif op == "common":
            lines.append(f"{result}=common({subject})")
        else:
            raise ValueError(f"unseen function {prog}")

    assert len(lines) == len(buffer)
    return lines, buffer


# --------------------------------------------------------------------------
# object-id remapping against the scene graph (preprocess.py:444-541)
# --------------------------------------------------------------------------

def build_oid_to_idx(sg_objects: dict) -> Dict[str, int]:
    """Sorted-object-id -> local node index, skipping degenerate bboxes
    (negative x/y or non-positive w/h; preprocess.py:462-470)."""
    oid_to_idx: Dict[str, int] = {}
    for oid in sorted(sg_objects.keys()):
        obj = sg_objects[oid]
        if obj.get("x", 0) < 0 or obj.get("y", 0) < 0:
            continue
        if obj.get("w", 1) <= 0 or obj.get("h", 1) <= 0:
            continue
        oid_to_idx[oid] = len(oid_to_idx)
    return oid_to_idx


def remap_execution_buffer(
    buffer: Sequence[Sequence[int]], oid_to_idx: Dict[str, int]
) -> List[List[int]]:
    return [[oid_to_idx[str(o)] for o in step if str(o) in oid_to_idx]
            for step in buffer]


def remap_annotations(annotations: dict, oid_to_idx: Dict[str, int]) -> dict:
    out: dict = {}
    for key, ptr_map in annotations.items():
        out[key] = {k: oid_to_idx[str(v)] for k, v in ptr_map.items()
                    if str(v) in oid_to_idx}
    return out


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def preprocess_questions(
    raw_data: dict,
    sg_data: Optional[dict] = None,
    seed: Optional[int] = 0,
    progress_every: int = 0,
) -> List[tuple]:
    """Full pipeline -> list of 11-field tuples (preprocess.py:558-570)."""
    rng = random.Random(seed) if seed is not None else random.Random()
    out: List[tuple] = []
    for n, (qid, q) in enumerate(raw_data.items()):
        image_id = q["imageId"]
        lines, buffer = translate_program(q["semantic"], rng)
        programs_decoder = generate_pairs(lines)
        programs_hierarchical = generate_hierarchical_pairs(lines)

        if sg_data is not None:
            oid_to_idx = build_oid_to_idx(sg_data[image_id]["objects"])
            new_buffer = remap_execution_buffer(buffer, oid_to_idx)
            new_annotations = remap_annotations(q.get("annotations", {}), oid_to_idx)
        else:  # testdev: no GT scene graphs
            new_buffer = []
            new_annotations = {}

        out.append((
            image_id,                    # 0
            q["question"],               # 1
            [],                          # 2 (new_programs slot, unused downstream)
            qid,                         # 3
            q["answer"],                 # 4
            q["fullAnswer"],             # 5
            programs_decoder,            # 6
            new_annotations,             # 7
            new_buffer,                  # 8
            programs_hierarchical,       # 9
            q["types"],                  # 10
        ))
        if progress_every and n % progress_every == 0:
            sys.stdout.write(f"processed {n}/{len(raw_data)}\r")
    return out


def preprocess_file(
    questions_path, output_path, scene_graphs_path=None, seed: Optional[int] = 0,
) -> None:
    raw = json.loads(pathlib.Path(questions_path).read_text())
    sg = (json.loads(pathlib.Path(scene_graphs_path).read_text())
          if scene_graphs_path else None)
    programs = preprocess_questions(raw, sg, seed=seed, progress_every=10000)
    pathlib.Path(output_path).write_text(json.dumps(programs, indent=2))
    print(f"wrote {len(programs)} programs -> {output_path}")
