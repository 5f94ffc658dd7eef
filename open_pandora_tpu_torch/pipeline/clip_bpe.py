"""OpenCLIP byte-level BPE tokenizer — the real algorithm, asset-gated.

The port's own copy of open_pandora_tpu/pipeline/clip_bpe.py (pure
Python, no JAX), so the port imports nothing of the JAX package.

The reference conditions the diffusion text encoder through
``open_clip.tokenize`` (condition.py:208), which is OpenAI CLIP's
SimpleTokenizer over the ``bpe_simple_vocab_16e6.txt.gz`` merges file.
This module implements that algorithm exactly (byte->unicode table, merge
ranks, the open_clip regex split, SOT/EOT/pad layout); only the merges
FILE is an external asset. Point ``CLIPBPETokenizer`` at it (plain .txt or
.txt.gz) and ids match open_clip.tokenize.

Real-asset check (documented, run wherever open_clip + the asset exist):

    import open_clip
    ours = CLIPBPETokenizer(path_to_merges)
    assert clip_tokenize(["a photo of a cat"], ours).tolist() \
        == open_clip.tokenize(["a photo of a cat"]).tolist()

ftfy (mojibake repair in open_clip's basic_clean) is not installed here and
is gated: clean-ASCII prompts — the product's use — are unaffected.
"""

from __future__ import annotations

import gzip
import html
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """OpenAI CLIP's reversible byte -> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Sequence[str]) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    # open_clip also runs ftfy.fix_text (mojibake repair) — unavailable
    # here; a no-op for clean input.
    try:
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    import re
    return re.sub(r"\s+", " ", text).strip()


class CLIPBPETokenizer:
    """SimpleTokenizer (open_clip tokenizer.py) over a merges file/list."""

    def __init__(self, merges_path: str = None, *,
                 merges: Iterable[Tuple[str, str]] = None):
        import regex

        if merges is None:
            if merges_path is None:
                raise ValueError("need merges_path or merges")
            opener = gzip.open if merges_path.endswith(".gz") else open
            with opener(merges_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # open_clip slices exactly this range (tokenizer.py:74):
            # line 0 is a version header; vocab target is 49152-256-2 tokens
            lines = lines[1: 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in lines if m.strip()]
        merges = list(merges)

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend([SOT_TEXT, EOT_TEXT])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}
        self.pat = regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            regex.IGNORECASE)
        self.sot_token = self.encoder[SOT_TEXT]
        self.eot_token = self.encoder[EOT_TEXT]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
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
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
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
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t]
                              for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (bytearray(self.byte_decoder[c] for c in text)
                .decode("utf-8", errors="replace").replace("</w>", " "))


def clip_tokenize(texts, tokenizer: CLIPBPETokenizer,
                  context_length: int = 77):
    """open_clip.tokenize layout: [SOT, ids..., EOT, 0-pad] per row, with
    over-length inputs truncated and the final slot forced to EOT."""
    import numpy as np

    if isinstance(texts, str):
        texts = [texts]
    result = np.zeros((len(texts), context_length), dtype=np.int64)
    for i, text in enumerate(texts):
        tokens = ([tokenizer.sot_token] + tokenizer.encode(text)
                  + [tokenizer.eot_token])
        if len(tokens) > context_length:
            tokens = tokens[:context_length]
            tokens[-1] = tokenizer.eot_token
        result[i, : len(tokens)] = tokens
    return result
