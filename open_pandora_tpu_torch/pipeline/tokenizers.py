"""Tokenizer adapters: the LLaMA tokenizer of the LLM and the OpenCLIP
tokenizer of the text encoder.

Counterpart of open_pandora_tpu/pipeline/tokenizers.py, with its own copies
of that package's framework-free host code. Both real tokenizers need vocab
files that are not in the repository:
  - LLaMA: `LlamaTokenizerAdapter` wraps a transformers tokenizer from a
    local directory (sentencepiece model plus the added multimodal tokens;
    transformers is imported only when a path is given);
    `HashFallbackTokenizer` maps words to stable ids inside the base vocab,
    enough for runs with random weights;
  - OpenCLIP: with a BPE merges file (bpe_simple_vocab_16e6.txt[.gz]) the
    real byte-level BPE runs (pipeline/clip_bpe.py); without one, the
    deterministic hash stand-in (`clip_fallback_encode`) produces ids in
    the same layout.

Special ids: <image> = 32000, [IMG_P] = 32001, <img_s> = 32002.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, List, Optional

BOS_ID = 1
EOS_ID = 2
IMAGE_TOKEN_ID = 32000
IMG_PREFIX_TOKEN_ID = 32001
IMG_START_TOKEN_ID = 32002


class HashFallbackTokenizer:
    """Deterministic word -> id hashing into [1000, 31000)."""

    bos_token_id = BOS_ID
    eos_token_id = EOS_ID

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = [BOS_ID] if add_bos else []
        for word in text.strip().split():
            h = int(hashlib.md5(word.lower().encode()).hexdigest(), 16)
            ids.append(1000 + h % 30000)
        return ids


class LlamaTokenizerAdapter:
    """transformers tokenizer from a local directory."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path, use_fast=False)
        self.bos_token_id = self.tok.bos_token_id
        self.eos_token_id = self.tok.eos_token_id

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = self.tok.encode(text, add_special_tokens=False)
        return ([self.tok.bos_token_id] + ids) if add_bos else ids


def load_tokenizer(path: Optional[str] = None):
    """The local tokenizer when a path is given, else the hash fallback. A
    path that does not load is an error."""
    return LlamaTokenizerAdapter(path) if path else HashFallbackTokenizer()


CLIP_SOT = 49406
CLIP_EOT = 49407


def clip_fallback_encode(text: str, context_length: int = 77) -> List[int]:
    """Deterministic stand-in for the OpenCLIP BPE: [SOT, hashed word ids,
    EOT, 0 pad], the layout open_clip.tokenize produces."""
    ids = [CLIP_SOT]
    for word in text.strip().split():
        if len(ids) >= context_length - 1:
            break
        h = int(hashlib.md5(word.lower().encode()).hexdigest(), 16)
        ids.append(1000 + h % 48000)
    ids.append(CLIP_EOT)
    ids += [0] * (context_length - len(ids))
    return ids[:context_length]


def load_clip_tokenizer(bpe_path: Optional[str] = None,
                        context_length: int = 77
                        ) -> Callable[[str, int], List[int]]:
    """`encode(text, context_length) -> ids`: the real BPE when a merges
    file is found, else the hash fallback. The search, as in the JAX
    package: `bpe_path`, then $PANDORA_CLIP_BPE (core/flags.py), then
    assets/bpe_simple_vocab_16e6.txt.gz and .txt under the repository root.
    The returned function's `is_real_bpe` says which."""
    from open_pandora_tpu_torch.core import flags
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    candidates = [bpe_path, flags.flag("PANDORA_CLIP_BPE")] + [
        os.path.join(root, "assets", name)
        for name in ("bpe_simple_vocab_16e6.txt.gz",
                     "bpe_simple_vocab_16e6.txt")]
    for cand in candidates:
        if cand and os.path.exists(cand):
            from open_pandora_tpu_torch.pipeline.clip_bpe import (
                CLIPBPETokenizer, clip_tokenize)
            tok = CLIPBPETokenizer(cand)

            def encode(text: str, context_length: int = context_length):
                return clip_tokenize([text], tok, context_length)[0].tolist()

            encode.is_real_bpe = True
            return encode

    def fallback(text: str, context_length: int = context_length):
        return clip_fallback_encode(text, context_length)

    fallback.is_real_bpe = False
    return fallback
