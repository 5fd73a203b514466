"""VQA accuracy metric (reference
`pipeline/benchmarks/public_datasets_suite/vqa_metric.py`, the standard
VQAv2 evaluation): answers normalized (contractions, punctuation, articles,
number words), accuracy = min(1, #matching_human_answers / 3), averaged.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't", "didnt": "didn't",
    "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's", "Id": "I'd",
    "Im": "I'm", "Ive": "I've", "isnt": "isn't", "itd": "it'd",
    "itll": "it'll", "lets": "let's", "maam": "ma'am",
    "mightve": "might've", "mustve": "must've", "shant": "shan't",
    "shed": "she'd", "shes": "she's", "shouldve": "should've",
    "shouldnt": "shouldn't", "thats": "that's", "thered": "there'd",
    "therere": "there're", "theres": "there's", "theyd": "they'd",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "wasnt": "wasn't", "wed": "we'd", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "wholl": "who'll", "whos": "who's", "whove": "who've", "whyll":
    "why'll", "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't", "yall": "y'all",
    "youd": "you'd", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}
MANUAL_MAP = {"none": "0", "zero": "0", "one": "1", "two": "2",
              "three": "3", "four": "4", "five": "5", "six": "6",
              "seven": "7", "eight": "8", "nine": "9", "ten": "10"}
ARTICLES = {"a", "an", "the"}
PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
         "_", "-", ">", "<", "@", "`", ",", "?", "!"]
PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
COMMA_STRIP = re.compile(r"(\d)(,)(\d)")


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or \
                re.search(COMMA_STRIP, text) is not None:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = PERIOD_STRIP.sub("", out, re.UNICODE)
    return out


def process_digit_article(text: str) -> str:
    out = []
    for word in text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in CONTRACTIONS:
            out[i] = CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(answer: str) -> str:
    answer = answer.replace("\n", " ").replace("\t", " ").strip()
    answer = process_punctuation(answer)
    answer = process_digit_article(answer)
    return answer


def vqa_accuracy(prediction: str, gt_answers: Sequence[str]) -> float:
    """min(1, matches/3) over the 10 human answers, averaged over
    leave-one-out subsets (the official VQA accuracy)."""
    pred = normalize_answer(prediction)
    gts = [normalize_answer(a) for a in gt_answers]
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1:]
        matches = sum(1 for g in others if g == pred)
        accs.append(min(1.0, matches / 3.0))
    return sum(accs) / len(accs) if accs else 0.0


def compute_vqa_accuracy(results: List[Dict]) -> float:
    """results: [{prediction, answers: [str]}] -> mean accuracy * 100."""
    if not results:
        return 0.0
    return 100.0 * sum(vqa_accuracy(r["prediction"], r["answers"])
                       for r in results) / len(results)


def postprocess_vqa_generation(prediction: str) -> str:
    """Trim generations at common continuation markers (public suite
    behavior)."""
    return re.split(r"Question|Answer|Short", prediction, 1)[0].strip()
