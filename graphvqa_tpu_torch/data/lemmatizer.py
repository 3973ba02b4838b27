"""Rule-based English noun singularizer (the port's own copy of
``graphvqa_tpu/data/lemmatizer.py``).

Stand-in for nltk's WordNetLemmatizer (reference: preprocess.py:29,190 — used
only for noun lemmatization of object names in program arguments). Covers GQA's
object-name distribution: regular plurals, common -ies/-ves/-es patterns, and
the frequent irregulars; unknown or already-singular words pass through, like
WordNet's behavior for out-of-vocabulary tokens.
"""
from __future__ import annotations

_IRREGULAR = {
    "men": "man", "women": "woman", "children": "child", "people": "person",
    "feet": "foot", "teeth": "tooth", "geese": "goose", "mice": "mouse",
    "leaves": "leaf", "knives": "knife", "shelves": "shelf", "wolves": "wolf",
    "loaves": "loaf", "scarves": "scarf", "calves": "calf", "halves": "half",
    "sheep": "sheep", "deer": "deer", "fish": "fish", "glasses": "glass",
    "dishes": "dish", "buses": "bus", "benches": "bench", "boxes": "box",
    "sandwiches": "sandwich", "watches": "watch", "couches": "couch",
    "peaches": "peach", "brushes": "brush", "bushes": "bush",
    "dresses": "dress", "octopi": "octopus", "cacti": "cactus",
}

# words that end in s but are singular (avoid over-stripping)
_SINGULAR_S = {
    "bus", "glass", "grass", "dress", "chess", "press", "class", "gas",
    "lens", "iris", "tennis", "pants", "jeans", "shorts", "scissors",
    "sunglasses", "overalls", "pajamas", "binoculars", "pliers", "tongs",
    "headphones", "asparagus", "hummus",
}


def lemmatize(word: str) -> str:
    w = word.lower()
    if w in _IRREGULAR:
        return _IRREGULAR[w]
    if w in _SINGULAR_S or len(w) <= 3:
        return word
    if w.endswith("ies") and len(w) > 4:
        return word[:-3] + "y"
    if w.endswith(("ches", "shes", "sses", "xes", "zes")):
        return word[:-2]
    if w.endswith("oes") and len(w) > 4:
        return word[:-2]
    if w.endswith("s") and not w.endswith(("ss", "us", "is")):
        return word[:-1]
    return word
