"""CIDEr-D captioning metric (reference
`pipeline/benchmarks/public_datasets_suite/coco_metric.py` delegates to
pycocoevalcap; implemented natively here): tf-idf weighted n-gram (1..4)
cosine similarity with length penalty, averaged over n and references,
scaled by 10."""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def _tokenize(s: str) -> List[str]:
    import re
    s = s.lower()
    s = re.sub(r"[^a-z0-9 ]", " ", s)
    return s.split()


class CiderScorer:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def compute(self, candidates: Dict[str, str],
                references: Dict[str, Sequence[str]]) -> float:
        """candidates: {img_id: caption}; references: {img_id: [captions]}.
        Returns corpus CIDEr-D score (x100 convention left to caller)."""
        ids = list(candidates)
        # document frequencies over reference sets
        doc_freq = [defaultdict(int) for _ in range(self.n)]
        for img_id in ids:
            for k in range(self.n):
                seen = set()
                for ref in references[img_id]:
                    seen |= set(_ngrams(_tokenize(ref), k + 1).keys())
                for g in seen:
                    doc_freq[k][g] += 1
        log_m = math.log(max(len(ids), 1))

        def tfidf_vec(tokens, k):
            cnt = _ngrams(tokens, k + 1)
            total = sum(cnt.values()) or 1
            vec = {}
            norm = 0.0
            for g, c in cnt.items():
                df = math.log(max(doc_freq[k][g], 1))
                w = (c / total) * max(log_m - df, 0.0)
                vec[g] = w
                norm += w * w
            return vec, math.sqrt(norm), len(tokens)

        scores = []
        for img_id in ids:
            cand_tokens = _tokenize(candidates[img_id])
            score_n = [0.0] * self.n
            for ref in references[img_id]:
                ref_tokens = _tokenize(ref)
                for k in range(self.n):
                    cv, cn, cl = tfidf_vec(cand_tokens, k)
                    rv, rn, rl = tfidf_vec(ref_tokens, k)
                    sim = 0.0
                    for g, w in cv.items():
                        sim += min(w, rv.get(g, 0.0)) * rv.get(g, 0.0)
                    if cn > 0 and rn > 0:
                        sim /= cn * rn
                    delta = cl - rl
                    sim *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
                    score_n[k] += sim
            n_refs = max(len(references[img_id]), 1)
            score = sum(s / n_refs for s in score_n) / self.n * 10.0
            scores.append(score)
        return sum(scores) / max(len(scores), 1)


def compute_cider(result: List[Dict], annotations: Dict[str, List[str]]
                  ) -> float:
    """result: [{image_id, caption}]; annotations: {image_id: [captions]}."""
    candidates = {str(r["image_id"]): r["caption"] for r in result}
    refs = {k: annotations[k] for k in candidates}
    return CiderScorer().compute(candidates, refs)


def postprocess_captioning_generation(prediction: str) -> str:
    return prediction.split("Output", 1)[0].split("\n", 1)[0].strip()
