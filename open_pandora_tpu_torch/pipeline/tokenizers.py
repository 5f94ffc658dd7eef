"""OpenCLIP tokenizer for the text encoder.

Counterpart of `load_clip_tokenizer` in open_pandora_tpu/pipeline/
tokenizers.py, with its own copies of that package's framework-free host
code: with a BPE merges file (bpe_simple_vocab_16e6.txt[.gz]) the real
byte-level BPE runs (pipeline/clip_bpe.py); without one, the deterministic
hash stand-in (`clip_fallback_encode`) produces ids in the same layout,
enough for runs with random weights.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, List, Optional

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
    """`encode(text, context_length) -> ids`: the real BPE when `bpe_path`
    names an existing merges file, else the hash fallback. The returned
    function's `is_real_bpe` says which."""
    if bpe_path and os.path.exists(bpe_path):
        from open_pandora_tpu_torch.pipeline.clip_bpe import (CLIPBPETokenizer,
                                                        clip_tokenize)
        tok = CLIPBPETokenizer(bpe_path)

        def encode(text: str, context_length: int = context_length):
            return clip_tokenize([text], tok, context_length)[0].tolist()

        encode.is_real_bpe = True
        return encode

    def fallback(text: str, context_length: int = context_length):
        return clip_fallback_encode(text, context_length)

    fallback.is_real_bpe = False
    return fallback
