"""CLIP BPE tokenizer (open_clip-compatible) and the prompt cache.

Counterpart of `guidedvd3dgs_tpu/diffusion/tokenizer.py`: the standard CLIP
SimpleTokenizer of `open_clip.tokenize` (reference usage:
third_party/ViewCrafter/lvdm/modules/encoders/condition.py:209-212), which
loads the canonical `bpe_simple_vocab_16e6.txt.gz` merges file. No vocab
file is in the repository: the one prompt guidedvd encodes is fixed
("Rotating view of a scene", and "" for the unconditional branch;
configs/infer_config.py:50), so `tokenize` serves it from a cache of
precomputed ids.
"""

from __future__ import annotations

import gzip
import html
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import numpy as np

SOT = 49406
EOT = 49407
CONTEXT_LENGTH = 77


@lru_cache()
def bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return " ".join(text.split())


class SimpleTokenizer:
    def __init__(self, bpe_path: str):
        import regex as re_  # stdlib re lacks \p classes; regex ships with the image

        self._re = re_
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        self.byte_encoder = bytes_to_unicode()
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<start_of_text>", "<end_of_text>"])
        self.encoder: Dict[str, int] = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<start_of_text>": "<start_of_text>",
            "<end_of_text>": "<end_of_text>",
        }
        self.pat = re_.compile(
            r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            re_.IGNORECASE,
        )

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda pair: self.bpe_ranks.get(pair, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self._re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens


# precomputed open_clip token ids for the prompts guidedvd actually uses:
# "" (the uncond/cond text, diffusion_utils.py:140,161) and the default
# prompt "Rotating view of a scene" (configs/infer_config.py:50), ids
# computed with SimpleTokenizer on the canonical bpe_simple_vocab_16e6
# merges — so default runs need no vocab file at all
_PROMPT_CACHE: Dict[str, List[int]] = {
    "": [],
    "Rotating view of a scene": [32265, 1093, 539, 320, 3562],
}


def tokenize(
    texts: Sequence[str],
    tokenizer: Optional[SimpleTokenizer] = None,
    context_length: int = CONTEXT_LENGTH,
) -> np.ndarray:
    """open_clip.tokenize semantics: [SOT] + bpe + [EOT], zero-padded."""
    result = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        if tokenizer is not None:
            ids = tokenizer.encode(text)
        elif text in _PROMPT_CACHE:
            ids = _PROMPT_CACHE[text]
        else:
            raise ValueError(
                f"no tokenizer and prompt {text!r} not in the precomputed cache; "
                "pass SimpleTokenizer(bpe_simple_vocab_16e6.txt.gz)"
            )
        ids = [SOT] + ids[: context_length - 2] + [EOT]
        result[i, : len(ids)] = ids
    return result
