"""Caption evaluation metrics: BLEU-1..4, CIDEr-D, ROUGE-L, METEOR. A copy
of `lhrs_bot_tpu/eval/caption.py` (the standard library only), kept here
so that the port imports nothing of the JAX package.

Capability parity with the reference's COCO caption eval path
(hook/eval_hook.py:21-187 uses pycocoevalcap BLEU/CIDEr/...). Implemented
from the standard definitions so the heavy pycoco dependency isn't needed:
  * BLEU with brevity penalty (Papineni et al. 2002, corpus-level);
  * CIDEr-D (Vedantam et al. 2015): TF-IDF-weighted n-gram cosine with
    length gaussian penalty, n = 1..4, corpus IDF;
  * ROUGE-L (Lin 2004): LCS-based F-measure with beta = 1.2.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence


def _tokenize(text: str) -> List[str]:
    return text.lower().replace(".", " ").replace(",", " ").split()


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu(
    predictions: Sequence[str],
    references: Sequence[Sequence[str]],
    max_n: int = 4,
) -> Dict[str, float]:
    """Corpus BLEU-1..max_n. references: per-sample list of gold captions."""
    clipped = [0] * max_n
    totals = [0] * max_n
    pred_len = 0
    ref_len = 0
    for pred, refs in zip(predictions, references):
        p_tok = _tokenize(pred)
        r_toks = [_tokenize(r) for r in refs]
        pred_len += len(p_tok)
        # closest reference length
        ref_len += min((abs(len(r) - len(p_tok)), len(r))
                       for r in r_toks)[1]
        for n in range(1, max_n + 1):
            p_ng = _ngrams(p_tok, n)
            max_ref = Counter()
            for r in r_toks:
                for ng, c in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            totals[n - 1] += max(sum(p_ng.values()), 0)
            clipped[n - 1] += sum(min(c, max_ref[ng])
                                  for ng, c in p_ng.items())
    bp = 1.0 if pred_len > ref_len else math.exp(
        1 - ref_len / max(pred_len, 1))
    out = {}
    log_sum = 0.0
    for n in range(1, max_n + 1):
        p = clipped[n - 1] / max(totals[n - 1], 1)
        log_sum += math.log(max(p, 1e-12))
        out[f"bleu{n}"] = bp * math.exp(log_sum / n)
    return out


def cider_d(
    predictions: Sequence[str],
    references: Sequence[Sequence[str]],
    max_n: int = 4,
    sigma: float = 6.0,
) -> float:
    """CIDEr-D over the corpus (IDF computed from the reference set)."""
    # document frequency over reference "documents" (one doc per image)
    doc_freq: List[Counter] = [Counter() for _ in range(max_n)]
    num_docs = len(references)
    ref_ngrams = []
    for refs in references:
        per_img = []
        seen = [set() for _ in range(max_n)]
        for r in refs:
            toks = _tokenize(r)
            per_n = [_ngrams(toks, n + 1) for n in range(max_n)]
            per_img.append((per_n, len(toks)))
            for n in range(max_n):
                seen[n].update(per_n[n].keys())
        for n in range(max_n):
            for ng in seen[n]:
                doc_freq[n][ng] += 1
        ref_ngrams.append(per_img)

    def tfidf_vec(counts: Counter, n: int) -> Dict:
        total = max(sum(counts.values()), 1)
        vec = {}
        for ng, c in counts.items():
            df = max(doc_freq[n][ng], 1)
            idf = math.log(max(num_docs, 1)) - math.log(df)
            vec[ng] = (c / total) * idf
        return vec

    def cosine(v1: Dict, v2: Dict, len1: int, len2: int) -> float:
        norm1 = math.sqrt(sum(x * x for x in v1.values()))
        norm2 = math.sqrt(sum(x * x for x in v2.values()))
        if norm1 == 0 or norm2 == 0:
            return 0.0
        # CIDEr-D clips candidate counts to the reference's
        num = sum(min(v1.get(ng, 0.0), v2.get(ng, 0.0)) * v2.get(ng, 0.0)
                  for ng in v1)
        delta = len1 - len2
        penalty = math.exp(-(delta ** 2) / (2 * sigma ** 2))
        return penalty * num / (norm1 * norm2)

    scores = []
    for pred, per_img in zip(predictions, ref_ngrams):
        p_tok = _tokenize(pred)
        p_vecs = [tfidf_vec(_ngrams(p_tok, n + 1), n) for n in range(max_n)]
        score_n = [0.0] * max_n
        for (r_counts, r_len) in per_img:
            for n in range(max_n):
                r_vec = tfidf_vec(r_counts[n], n)
                score_n[n] += cosine(p_vecs[n], r_vec, len(p_tok), r_len)
        k = max(len(per_img), 1)
        scores.append(10.0 * sum(s / k for s in score_n) / max_n)
    return sum(scores) / max(len(scores), 1)


def rouge_l(
    predictions: Sequence[str],
    references: Sequence[Sequence[str]],
    beta: float = 1.2,
) -> float:
    def lcs(a: List[str], b: List[str]) -> int:
        dp = [0] * (len(b) + 1)
        for x in a:
            prev = 0
            for j, y in enumerate(b, 1):
                cur = dp[j]
                dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
                prev = cur
        return dp[-1]

    scores = []
    for pred, refs in zip(predictions, references):
        p = _tokenize(pred)
        best = 0.0
        for r in refs:
            rt = _tokenize(r)
            l = lcs(p, rt)
            prec = l / max(len(p), 1)
            rec = l / max(len(rt), 1)
            if prec and rec:
                f = ((1 + beta ** 2) * prec * rec) / (rec + beta ** 2 * prec)
                best = max(best, f)
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


def _porter_stem(w: str) -> str:
    """Porter (1980) stemmer, from scratch — the stem stage of METEOR's
    matcher. No WordNet / external data."""
    if len(w) <= 2:
        return w
    w = w.lower()

    def is_cons(word, i):
        c = word[i]
        if c in "aeiou":
            return False
        if c == "y":
            return i == 0 or not is_cons(word, i - 1)
        return True

    def measure(stem):
        # number of VC sequences in [C](VC)^m[V]
        m, i, n = 0, 0, len(stem)
        while i < n and is_cons(stem, i):
            i += 1
        while i < n:
            while i < n and not is_cons(stem, i):
                i += 1
            if i >= n:
                break
            m += 1
            while i < n and is_cons(stem, i):
                i += 1
        return m

    def has_vowel(stem):
        return any(not is_cons(stem, i) for i in range(len(stem)))

    def ends_double_cons(word):
        return (len(word) >= 2 and word[-1] == word[-2]
                and is_cons(word, len(word) - 1))

    def ends_cvc(word):
        if len(word) < 3:
            return False
        n = len(word)
        return (is_cons(word, n - 3) and not is_cons(word, n - 2)
                and is_cons(word, n - 1) and word[-1] not in "wxy")

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]
    # step 1b
    flag_1b = False
    if w.endswith("eed"):
        if measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and has_vowel(w[:-2]):
        w, flag_1b = w[:-2], True
    elif w.endswith("ing") and has_vowel(w[:-3]):
        w, flag_1b = w[:-3], True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif ends_double_cons(w) and w[-1] not in "lsz":
            w = w[:-1]
        elif measure(w) == 1 and ends_cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and has_vowel(w[:-1]):
        w = w[:-1] + "i"

    def repl(word, pairs, cond):
        for suf, rep in pairs:
            if word.endswith(suf):
                stem = word[:-len(suf)]
                if cond(stem):
                    return stem + rep
                return word
        return word

    m_gt0 = lambda s: measure(s) > 0
    # step 2
    w = repl(w, [("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
                 ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
                 ("alli", "al"), ("entli", "ent"), ("eli", "e"),
                 ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
                 ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
                 ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
                 ("iviti", "ive"), ("biliti", "ble")], m_gt0)
    # step 3
    w = repl(w, [("icate", "ic"), ("ative", ""), ("alize", "al"),
                 ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                 ("ness", "")], m_gt0)
    # step 4
    m_gt1 = lambda s: measure(s) > 1
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
                "ive", "ize"):
        if w.endswith(suf):
            stem = w[:-len(suf)]
            if m_gt1(stem):
                w = stem
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" \
                and m_gt1(w[:-3]):
            w = w[:-3]
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = measure(stem)
        if m > 1 or (m == 1 and not ends_cvc(stem)):
            w = stem
    # step 5b
    if ends_double_cons(w) and w[-1] == "l" and measure(w[:-1]) > 1:
        w = w[:-1]
    return w


def _meteor_align(hyp: List[str], ref: List[str]):
    """Two-stage unigram alignment (exact, then Porter stem), greedy by
    position within each stage (nltk meteor_score convention). Returns the
    list of (hyp_idx, ref_idx) matches sorted by hyp index."""
    matches = []
    h_free = set(range(len(hyp)))
    r_free = set(range(len(ref)))
    for key_fn in (lambda t: t, _porter_stem):
        h_keys = {i: key_fn(hyp[i]) for i in sorted(h_free)}
        r_by_key: Dict[str, List[int]] = {}
        for j in sorted(r_free):
            r_by_key.setdefault(key_fn(ref[j]), []).append(j)
        for i in sorted(h_free):
            cands = r_by_key.get(h_keys[i])
            while cands and cands[0] not in r_free:
                cands.pop(0)
            if cands:
                j = cands.pop(0)
                matches.append((i, j))
                h_free.discard(i)
                r_free.discard(j)
    return sorted(matches)


def meteor(
    predictions: Sequence[str],
    references: Sequence[Sequence[str]],
) -> float:
    """METEOR (Banerjee & Lavie 2005) with exact + Porter-stem matching.

    DELIBERATE DEVIATION from the reference's pycocoevalcap METEOR-1.5 jar
    (CustomTrainer/hook/eval_hook.py:9): no WordNet synonym/paraphrase
    stage (no such data in this environment) and the classic parameters
    (Fmean = 10PR/(R+9P), penalty = 0.5·(chunks/matches)³) instead of the
    1.5 jar's tuned weights. Scores correlate but are not numerically
    identical; the best-checkpoint signal remains Bleu_4 (eval_hook.py:131)
    so checkpoint selection is unaffected. Sentence scores take the max
    over references; the corpus score is the mean over sentences."""
    total = 0.0
    for pred, refs in zip(predictions, references):
        hyp = _tokenize(pred)
        best = 0.0
        for r in refs:
            ref = _tokenize(r)
            if not hyp or not ref:
                continue
            m = _meteor_align(hyp, ref)
            if not m:
                continue
            p = len(m) / len(hyp)
            rc = len(m) / len(ref)
            fmean = 10.0 * p * rc / (rc + 9.0 * p)
            chunks = 1
            for (h0, r0), (h1, r1) in zip(m, m[1:]):
                if h1 != h0 + 1 or r1 != r0 + 1:
                    chunks += 1
            penalty = 0.5 * (chunks / len(m)) ** 3
            best = max(best, fmean * (1.0 - penalty))
        total += best
    return total / max(len(predictions), 1)


def caption_eval(predictions: Sequence[str],
                 references: Sequence[Sequence[str]]) -> Dict[str, float]:
    out = bleu(predictions, references)
    out["cider"] = cider_d(predictions, references)
    out["rouge_l"] = rouge_l(predictions, references)
    out["meteor"] = meteor(predictions, references)
    return out
