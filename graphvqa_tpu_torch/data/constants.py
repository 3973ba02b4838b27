"""GQA symbolic-program constants, ontologies, and geometry helpers (the
port's own copy of ``graphvqa_tpu/data/constants.py``).

Home of the reference's ``Constants.py`` surface (C1):

  * special token ids (torchtext specials order, Constants.py:18-21)
  * the 36-function program DSL split by return type (Constants.py:29-31)
  * the bbox/scene attribute ontologies (data tables, Constants.py:33-68)
  * GQA metadata vocab maps (objects 600 / predicates 121 / attributes 369,
    Constants.py:96-106) loaded from the bundled assets
  * ``parse_program`` — the "res = func(arg, ...)" string parser
    (Constants.py:178-191)
  * ``bbox_iou`` — IoU/containment with the reference's +0.01 denominator
    regularizer (Constants.py:155-176)

Unlike the reference, nothing here hard-codes machine paths; asset locations
default to the port's packaged ``assets/meta_info``.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional, Tuple

PAD, EOS, UNK, SOS = 1, 3, 0, 2  # torchtext specials order (Constants.py:18-21)

# program DSL functions by return type (Constants.py:29-31)
OBJECT_FUNCS = ["relate", "relate_inv", "relate_name", "relate_inv_name",
                "select", "relate_attr", "filter", "filter_not", "filter_h"]
STRING_FUNCS = ["query_n", "query_h", "query", "query_f", "choose_n",
                "choose_f", "choose", "choose_attr", "choose_h", "choose_v",
                "choose_rel_inv", "choose_subj", "common"]
BINARY_FUNCS = ["verify", "verify_f", "verify_h", "verify_v", "verify_rel",
                "verify_rel_inv", "exist", "or", "and", "different", "same",
                "same_attr", "different_attr"]

# attribute ontologies — GQA data tables (Constants.py:33-68)
BBOX_ONTOLOGY: Dict[str, List[str]] = {
    "darkness": ["dark", "bright"],
    "dryness": ["wet", "dry"],
    "colorful": ["colorful", "shiny"],
    "leaf": ["leafy", "bare"],
    "emotion": ["happy", "calm"],
    "sports": ["baseball", "tennis"],
    "flatness": ["flat", "curved"],
    "lightness": ["light", "heavy"],
    "gender": ["male", "female"],
    "width": ["wide", "narrow"],
    "depth": ["deep", "shallow"],
    "hardness": ["hard", "soft"],
    "cleanliness": ["clean", "dirty"],
    "switch": ["on", "off"],
    "thickness": ["thin", "thick"],
    "openness": ["open", "closed"],
    "height": ["tall", "short"],
    "length": ["long", "short"],
    "fullness": ["full", "empty"],
    "age": ["young", "old"],
    "size": ["large", "small"],
    "pattern": ["checkered", "striped", "dress", "dotted"],
    "shape": ["round", "rectangular", "triangular", "square"],
    "activity": ["waiting", "staring", "drinking", "playing", "eating",
                 "cooking", "resting", "sleeping", "posing", "talking",
                 "looking down", "looking up", "driving", "reading",
                 "brushing teeth", "flying", "surfing", "skiing", "hanging"],
    "pose": ["walking", "standing", "lying", "sitting", "running", "jumping",
             "crouching", "bending", "smiling", "grazing"],
    "material": ["wood", "plastic", "metal", "glass", "leather", "leather",
                 "porcelain", "concrete", "paper", "stone", "brick"],
    "color": ["white", "red", "black", "green", "silver", "gold", "khaki",
              "gray", "dark", "pink", "dark blue", "dark brown", "blue",
              "yellow", "tan", "brown", "orange", "purple", "beige", "blond",
              "brunette", "maroon", "light blue", "light brown"],
}

SCENE_ONTOLOGY: Dict[str, List[str]] = {
    "location": ["indoors", "outdoors"],
    "weather": ["clear", "overcast", "cloudless", "cloudy", "sunny", "foggy",
                "rainy"],
    "room": ["bedroom", "kitchen", "bathroom", "living room"],
    "place": ["road", "sidewalk", "field", "beach", "park", "grass", "farm",
              "ocean", "pavement", "lake", "street", "train station",
              "hotel room", "church", "restaurant", "forest", "path",
              "display", "store", "river", "sea", "yard", "airport",
              "parking lot"],
}

ONTOLOGY: Dict[str, List[str]] = {**BBOX_ONTOLOGY, **SCENE_ONTOLOGY}
BBOX_ATTR = list(BBOX_ONTOLOGY.keys())
SCENE_ATTR = list(SCENE_ONTOLOGY.keys())


def _invert(ontology: Dict[str, List[str]], keys: List[str]
            ) -> Dict[str, List[Tuple[int, int]]]:
    """value -> [(attribute-category index, index within category), ...]"""
    out: Dict[str, List[Tuple[int, int]]] = {}
    for cat, values in ontology.items():
        for i, value in enumerate(values):
            out.setdefault(value, []).append((keys.index(cat), i))
    return out


BBOX_ATTRIBUTES = _invert(BBOX_ONTOLOGY, BBOX_ATTR)
SCENE_ATTRIBUTES = _invert(SCENE_ONTOLOGY, SCENE_ATTR)

_ASSET_DIR = (pathlib.Path(__file__).resolve().parent.parent
              / "assets" / "meta_info")


def load_gqa_vocab_maps(asset_dir: Optional[pathlib.Path] = None):
    """(OBJECTS, RELATIONS, ATTRIBUTES) name->index maps + inverse lists
    (Constants.py:96-106)."""
    d = pathlib.Path(asset_dir) if asset_dir else _ASSET_DIR
    objects_inv = json.loads((d / "objects.json").read_text())
    relations_inv = json.loads((d / "predicates.json").read_text())
    attributes_inv = json.loads((d / "attributes.json").read_text())
    return (
        {k: i for i, k in enumerate(objects_inv)}, objects_inv,
        {k: i for i, k in enumerate(relations_inv)}, relations_inv,
        {k: i for i, k in enumerate(attributes_inv)}, attributes_inv,
    )


def parse_program(string: str) -> Tuple[str, str, List[str]]:
    """Parse one DSL line "res=func(arg1, arg2)" -> (res, func, args).

    Matches Constants.py:178-191: a missing "res=" prefix yields result "?";
    a no-argument call like "func()" yields an empty argument list; arguments
    are comma-split and stripped.
    """
    result, _, function = string.rpartition("=")
    if not result:
        result = "?"
    func, _, arguments = function.partition("(")
    arguments = arguments.rstrip(")")
    if not arguments.strip():
        return result, func, []
    return result, func, [a.strip() for a in arguments.split(",")]


def bbox_iou(bbox1, bbox2, contained: bool = False, option: str = "xywh"):
    """Intersection-over-union of two boxes (Constants.py:155-176).

    ``option`` selects the box encoding ("xywh" or "x1y1x2y2"). The +0.01
    denominator regularizer of the reference is preserved. With
    ``contained=True`` also returns intersection / area(bbox1) — computed
    from the true area (the reference divides by ``bbox1[2]*bbox1[3]`` even
    in x1y1x2y2 mode, i.e. by x2*y2; that is a bug we do not replicate).
    """
    if option == "xywh":
        x1a, y1a, x2a, y2a = (bbox1[0], bbox1[1],
                              bbox1[0] + bbox1[2], bbox1[1] + bbox1[3])
        x1b, y1b, x2b, y2b = (bbox2[0], bbox2[1],
                              bbox2[0] + bbox2[2], bbox2[1] + bbox2[3])
        area1 = bbox1[2] * bbox1[3]
        area2 = bbox2[2] * bbox2[3]
    elif option == "x1y1x2y2":
        x1a, y1a, x2a, y2a = bbox1
        x1b, y1b, x2b, y2b = bbox2
        area1 = (x2a - x1a) * (y2a - y1a)
        area2 = (x2b - x1b) * (y2b - y1b)
    else:
        raise NotImplementedError(option)
    iw = max(min(x2a, x2b) - max(x1a, x1b), 0)
    ih = max(min(y2a, y2b) - max(y1a, y1b), 0)
    inter = iw * ih
    union = area1 + area2 - inter
    iou = inter / (union + 0.01)
    if contained:
        return iou, inter / (area1 + 0.01)
    return iou
