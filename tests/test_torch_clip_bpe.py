"""PyTorch port, the CLIP byte-level BPE: the port's own copy
(open_pandora_tpu_torch/pipeline/clip_bpe.py) against the JAX package's
module on one synthetic merges table, and the merges-file route of
`load_clip_tokenizer` in both packages. Token ids are integers: every
comparison is exact."""

import gzip

import pytest

from open_pandora_tpu.pipeline import clip_bpe as jbpe
from open_pandora_tpu.pipeline.tokenizers import \
    load_clip_tokenizer as jax_load
from open_pandora_tpu_torch.pipeline import clip_bpe as tbpe
from open_pandora_tpu_torch.pipeline.tokenizers import load_clip_tokenizer

MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"),
          ("c", "a"), ("ca", "t</w>"), ("t", "h"), ("th", "e</w>"),
          ("a", "n"), ("an", "d</w>"), ("Ã", "©</w>"),   # é at a word end
          ("a", "f"), ("c", "af")]

TEXTS = [
    "hello cat",
    "Hello, the cat -- and THE dog!!",          # case, punctuation runs
    "zq xj'll it's we've",                        # unknown words, clitics
    "café naïve 東京 emoji \U0001F600",          # non-ASCII, 4-byte utf-8
    "  tabs\tand\nnewlines   &amp; &lt;html&gt; ",  # whitespace, entities
    "3.14 and 42 apples",                         # digits split one by one
    " ".join(["hello"] * 100),                    # over the context length
    "",
]


@pytest.fixture(scope="module")
def pair():
    return (tbpe.CLIPBPETokenizer(merges=MERGES),
            jbpe.CLIPBPETokenizer(merges=MERGES))


def test_tables_match(pair):
    ours, theirs = pair
    assert tbpe.bytes_to_unicode() == jbpe.bytes_to_unicode()
    assert ours.encoder == theirs.encoder
    assert ours.bpe_ranks == theirs.bpe_ranks
    assert (ours.sot_token, ours.eot_token, ours.vocab_size) == (
        theirs.sot_token, theirs.eot_token, theirs.vocab_size)


@pytest.mark.parametrize("text", TEXTS)
def test_encode_matches(pair, text):
    ours, theirs = pair
    for word in ours.pat.findall(text.lower()):
        word = "".join(ours.byte_encoder[b] for b in word.encode("utf-8"))
        assert ours.bpe(word) == theirs.bpe(word)
    ids = ours.encode(text)
    assert ids == theirs.encode(text)
    assert ours.decode(ids) == theirs.decode(ids)
    for n in (77, 8):   # 8: longer inputs are cut, the last slot is EOT
        got = tbpe.clip_tokenize([text, text.upper()], ours, n)
        want = jbpe.clip_tokenize([text, text.upper()], theirs, n)
        assert got.dtype == want.dtype
        assert got.tolist() == want.tolist()


@pytest.mark.parametrize("suffix", [".txt", ".txt.gz"])
def test_load_from_merges_file_matches(tmp_path, suffix):
    """The real-BPE route of load_clip_tokenizer: a merges file in open_clip's
    layout (a version header, then one merge per line)."""
    path = str(tmp_path / f"bpe_simple_vocab_16e6{suffix}")
    body = "#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES) + "\n"
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(path, "wt", encoding="utf-8") as f:
        f.write(body)
    ours, theirs = load_clip_tokenizer(path, 16), jax_load(path, 16)
    assert ours.is_real_bpe and theirs.is_real_bpe
    for text in TEXTS:
        assert ours(text) == theirs(text)
        assert ours(text, 77) == theirs(text, 77)
