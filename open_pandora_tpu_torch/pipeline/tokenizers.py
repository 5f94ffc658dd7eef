"""OpenCLIP tokenizer for the text encoder.

Counterpart of `load_clip_tokenizer` in open_pandora_tpu/pipeline/
tokenizers.py, reusing that package's framework-free host code: with a BPE
merges file (bpe_simple_vocab_16e6.txt[.gz]) the real byte-level BPE runs
(pipeline/clip_bpe.py); without one, the deterministic hash stand-in
(`clip_fallback_encode`) produces ids in the same layout, enough for runs
with random weights.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

from open_pandora_tpu.pipeline.tokenizers import clip_fallback_encode


def load_clip_tokenizer(bpe_path: Optional[str] = None,
                        context_length: int = 77
                        ) -> Callable[[str, int], List[int]]:
    """`encode(text, context_length) -> ids`: the real BPE when `bpe_path`
    names an existing merges file, else the hash fallback. The returned
    function's `is_real_bpe` says which."""
    if bpe_path and os.path.exists(bpe_path):
        from open_pandora_tpu.pipeline.clip_bpe import (CLIPBPETokenizer,
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
