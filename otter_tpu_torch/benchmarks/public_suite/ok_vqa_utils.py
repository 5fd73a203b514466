"""OK-VQA answer stemming (reference
`pipeline/benchmarks/public_datasets_suite/ok_vqa_utils.py:1-217`).

The OKVQA v1.1 procedure stems predictions to match the dataset's
pre-stemmed answers: a manual-match table (official metric constants,
vendored verbatim like the VQA contraction tables), wordnet-style verb
lemmatization for "-ing" forms, and noun singularization. The reference
uses nltk's perceptron tagger + wordnet + the `inflection` package; none
of those ship data in this image, so the default path is a deterministic
rule-based approximation applied identically to predictions (the exact
nltk path is used automatically when its data is present).
"""

from __future__ import annotations

import re

# Official OKVQA v1.1 manual stemming exceptions (ok_vqa_utils.py:15-185).
_MANUAL_MATCHES = {
    "adhesives": "adhesive", "alertness": "alert", "alpes": "alp",
    "apartments": "apart", "are": "are", "awning": "awn",
    "backpackers": "backpack", "badness": "bad", "baldness": "bald",
    "bases": "base", "batter's": "batter", "belongings": "belong",
    "blindness": "blind", "boy's": "boy", "braves": "brave",
    "brightness": "bright", "browsing": "brows", "buildings": "build",
    "casings": "case", "caves": "cave", "charioteering": "chariot",
    "childrens": "children", "christmas": "christmas",
    "circuses": "circus", "clothes": "cloth", "clothing": "cloth",
    "coding": "code", "conducter": "conduct", "conferences": "confer",
    "coniferous": "conifer", "containers": "contain",
    "controllers": "control", "corgie": "corgi", "couponing": "coupon",
    "creame": "cream", "crepte": "crept", "cumulis": "cumuli",
    "curiousity": "curious", "dangerous": "danger",
    "daughter's": "daughter", "decorations": "decor",
    "designers": "design", "dining": "dine", "directions": "direct",
    "domino's": "domino", "doves": "dove", "drives": "drive",
    "drunkenness": "drunken", "earing": "ear", "earnings": "earn",
    "eatting": "eat", "electicity": "elect", "electronics": "electron",
    "elevators": "elev", "emirates": "emir", "expressions": "express",
    "farmer's": "farmer", "firefighters": "firefight",
    "firefighting": "firefight", "glaced": "glace", "gloves": "glove",
    "gondoliere": "gondolier", "graves": "grave", "haircutting": "haircut",
    "hamburgers": "hamburg", "hawke": "hawk", "hearding": "heard",
    "hell's": "hell", "hornes": "horn", "illness": "ill", "jeans": "jean",
    "kid's": "kid", "kindergartener": "kindergarten", "kiting": "kite",
    "las": "las", "leaves": "leaf", "lenses": "lens", "lowes": "low",
    "markings": "mark", "married": "married", "mating": "mate",
    "meetings": "meet", "men's": "men", "microwaves": "microwave",
    "minerals": "miner", "mopeds": "mope", "morning": "morn",
    "mountainous": "mountain", "mustange": "mustang",
    "nationals": "nation", "overseas": "oversea", "oxygenize": "oxygen",
    "paintings": "paint", "paned": "pane", "paring": "pare",
    "pease": "peas", "personals": "person", "pies": "pie",
    "piping": "pipe", "plating": "plate", "playfulness": "play",
    "polarizing": "polar", "police": "police", "pooping": "poop",
    "porche": "porch", "potatoe": "potato", "professionals": "profession",
    "projections": "project", "propellers": "propel",
    "protesters": "protest", "pudding": "pud", "purring": "pure",
    "quantas": "quanta", "rabbies": "rabbi", "raines": "rain",
    "reflections": "reflect", "regent's": "regent", "reminders": "remind",
    "reporters": "report", "revelations": "revel", "riding": "ride",
    "ringe": "ring", "ripeness": "ripe", "rodeoing": "rodeo",
    "routes": "rout", "sadness": "sad", "sautee": "saute",
    "scrapbooking": "scrapbook", "settings": "set", "shelves": "shelve",
    "sickness": "sick", "skateboarders": "skateboard", "smugness": "smug",
    "socializing": "social", "sometimes": "sometime", "staring": "stare",
    "stockings": "stock", "striping": "stripe", "sunbathing": "sunbath",
    "sunblocker": "sunblock", "suspenders": "suspend", "swining": "swine",
    "teasing": "teas", "teething": "teeth", "tenning": "ten",
    "tennis": "tennis", "texting": "text", "ties": "tie",
    "toileting": "toilet", "tomatoe": "tomato", "toppings": "top",
    "transitions": "transit", "travelers": "travel",
    "travellers": "travel", "urinating": "urine", "vacationing": "vacate",
    "vandalizers": "vandal", "vastness": "vast", "vegas": "vegas",
    "veteran's": "veteran", "wading": "wade", "walle": "wall",
    "waves": "wave", "weddings": "wed", "wetness": "wet",
    "wilderness": "wilder", "womens": "women", "yes": "yes",
}

_VOWELS = set("aeiou")


def _lemmatize_ing(word: str) -> str:
    """Approximate wordnet VERB lemmatization of an '-ing' form:
    running -> run (undouble), riding -> ride (restore e), texting -> text
    (manual table), fishing -> fish."""
    base = word[:-3]
    if len(base) < 2:
        return word
    if base[-1] == base[-2] and base[-1] not in _VOWELS \
            and base[-1] not in "lsz":
        return base[:-1]                      # running -> run
    if (base[-1] not in _VOWELS and len(base) >= 3
            and base[-2] in _VOWELS and base[-3] not in _VOWELS):
        return base + "e"                     # riding -> ride, making -> make
    return base                               # fishing -> fish


def _singularize(word: str) -> str:
    """Approximate inflection.singularize for plural nouns."""
    if len(word) <= 3 or word.endswith("ss") or word.endswith("us"):
        return word
    if word.endswith("ies"):
        return word[:-3] + "y"                # babies -> baby
    if word.endswith(("ches", "shes", "xes", "zes", "sses")):
        return word[:-2]                      # boxes -> box
    if word.endswith("oes"):
        return word[:-2]                      # potatoes -> potato
    if word.endswith("s"):
        return word[:-1]
    return word


class OKVQAStemmer:
    """Matches the OKVQA v1.1 stemming procedure; exact (nltk) when its
    corpora are available, rule-based otherwise."""

    def __init__(self):
        self._nltk = None
        try:
            import nltk
            from nltk.corpus.reader import VERB
            nltk.pos_tag(nltk.tokenize.word_tokenize("probe"))
            self._nltk = (nltk, VERB)
        except Exception:
            self._nltk = None

    def _stem_word(self, w: str, pos: str = "") -> str:
        if w in _MANUAL_MATCHES:
            return _MANUAL_MATCHES[w]
        if w.endswith("ing"):
            if self._nltk is not None:
                nltk, VERB = self._nltk
                return nltk.stem.WordNetLemmatizer().lemmatize(w, VERB)
            return _lemmatize_ing(w)
        if pos.startswith(("NNS", "NNPS")) or (not pos and w.endswith("s")):
            return _singularize(w)
        return w

    def stem(self, input_string: str) -> str:
        if self._nltk is not None:
            nltk, _ = self._nltk
            tagged = nltk.pos_tag(nltk.tokenize.word_tokenize(input_string))
            return " ".join(self._stem_word(w, p) for w, p in tagged)
        words = re.findall(r"[\w']+", input_string.lower())
        return " ".join(self._stem_word(w) for w in words)


_stemmer = None


def postprocess_ok_vqa_generation(predictions: str) -> str:
    """Truncate at the next turn and stem (ok_vqa_utils.py:214-217)."""
    global _stemmer
    if _stemmer is None:
        _stemmer = OKVQAStemmer()
    prediction = re.split(r"Question|Answer|Short", predictions, 1)[0]
    return _stemmer.stem(prediction)
