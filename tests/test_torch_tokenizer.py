"""The port's `tokenizer.json` reader (models/llama/tokenizer.py) against
the `tokenizers` package, which the JAX package loads the file with.

Two byte-level BPE files are trained here with `tokenizers`' own
`BpeTrainer` on text of this repository (a few hundred merges), shaped
as the checkpoints ship them:

  * Llama-3: its split regex, `ignore_merges`, no normalizer, the
    `<|begin_of_text|>` template, special tokens, and added tokens with
    lstrip, rstrip and single_word;
  * Qwen2: its split regex (one digit a pre-token), NFC, a `ByteLevel`
    post-processor, its chat tokens, merges as pairs.

Encoded ids and decoded text must equal `tokenizers`' exactly, on fixed
strings and on `hypothesis` text over letters, digits of every script,
marks, emoji, CR/LF runs and whitespace before non-whitespace. A file of
another kind raises. `load_tokenizer` gives the reader even though
`tokenizers` is installed here, and `encode_text` of the port and of
the JAX package agree on the same file.
"""

import json
import os

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

tokenizers = pytest.importorskip("tokenizers")

from cake_tpu_torch.models.llama.tokenizer import (  # noqa: E402
    BpeTokenizer, UnsupportedTokenizer, translate_regex,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                r"|\s+(?!\S)|\s+")
QWEN2_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
               r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_SPECIAL = ["<|begin_of_text|>", "<|end_of_text|>",
                  "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>"]
QWEN2_SPECIAL = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]

# text of every script the trainer sees besides the repository's
MIXED = ("Grüße, naïve café — 東京は晴れ。 Привет мир! ١٢٣ ٤٥٦ ²³ ½ "
         "देवनागरी १२३ 😀👍🏽 é \r\n\r\n\t x  y\n")


def _corpus() -> str:
    parts = []
    for name in ("README.md", "ROADMAP.md"):
        with open(os.path.join(ROOT, name), encoding="utf-8") as f:
            parts.append(f.read()[:40000])
    return "\n".join(parts + [MIXED] * 20)


def _train(split, special, nfc, vocab_size):
    from tokenizers import (
        Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers,
        trainers,
    )
    tok = Tokenizer(models.BPE())
    if nfc:
        tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(split), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator([_corpus()], trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=special,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return tok


@pytest.fixture(scope="module")
def llama3_json():
    from tokenizers import AddedToken, processors
    tok = _train(LLAMA3_SPLIT, LLAMA3_SPECIAL, nfc=False, vocab_size=700)
    tok.post_processor = processors.TemplateProcessing(
        single="<|begin_of_text|> $A",
        special_tokens=[("<|begin_of_text|>",
                         tok.token_to_id("<|begin_of_text|>"))])
    tok.add_special_tokens([AddedToken("<mask>", lstrip=True, rstrip=True)])
    tok.add_tokens([AddedToken("cake", single_word=True),
                    AddedToken("tpu"), AddedToken("<<", normalized=False)])
    spec = json.loads(tok.to_str())
    spec["model"]["ignore_merges"] = True
    return spec


@pytest.fixture(scope="module")
def qwen2_json():
    from tokenizers import processors
    tok = _train(QWEN2_SPLIT, QWEN2_SPECIAL, nfc=True, vocab_size=600)
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    spec = json.loads(tok.to_str())
    spec["model"]["merges"] = [m.split(" ", 1) if isinstance(m, str) else m
                               for m in spec["model"]["merges"]]
    return spec


@pytest.fixture(scope="module", params=["llama3", "qwen2"])
def pair(request, llama3_json, qwen2_json):
    """(the port's reader, tokenizers' Tokenizer) over one file."""
    from tokenizers import Tokenizer
    spec = llama3_json if request.param == "llama3" else qwen2_json
    text = json.dumps(spec)
    return BpeTokenizer(json.loads(text)), Tokenizer.from_str(text)


FIXED = [
    "",
    "Hello world! It's 2024; THEY'LL 'Re-run 1234567 tokens.",
    MIXED,
    "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\nhi"
    "<|eot_id|>",
    "<|im_start|>system\nYou are a cake.<|im_end|>\n",
    "a <mask> b<mask>c   <mask>\t cake cakes pancake tpu tputpu <<< <",
    "é vs é, Å vs Å, ﬁ ligature, ſ long s, K kelvin",
    "spaces   before nbsp　ideographic \x1c\x1d\x1e\x1f seps",
    "\r\n\r\n\n   \n\t\t x\r",
]


@pytest.mark.parametrize("text", FIXED, ids=range(len(FIXED)))
def test_fixed_strings_encode_and_decode_as_tokenizers(pair, text):
    mine, ref = pair
    ids = ref.encode(text).ids
    assert mine.encode(text) == ids
    assert mine.encode(text, add_special_tokens=False) == ref.encode(
        text, add_special_tokens=False).ids
    assert mine.decode(ids) == ref.decode(ids)
    assert mine.decode(ids, skip_special_tokens=False) == ref.decode(
        ids, skip_special_tokens=False)


_CHARS = st.characters(codec="utf-8", categories=(
    "Lu", "Ll", "Lt", "Lm", "Lo", "Nd", "Nl", "No", "Mn", "Mc", "Me",
    "Pc", "Pd", "Ps", "Pe", "Po", "Sm", "Sc", "Sk", "So", "Zs", "Cc", "Cf"))
_TEXT = st.lists(st.one_of(
    st.text(_CHARS, max_size=6),
    st.sampled_from(["\r\n", "\n\n", "\r", " ", "  ", "\t", "'s", "'LL",
                     "😀", "👍🏽", "é", "١٢٣", "²", "123456",
                     "<|eot_id|>", "<mask>", " cake ", "<|im_end|>"])),
    max_size=12).map("".join)


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=_TEXT)
def test_hypothesis_text_encodes_and_decodes_as_tokenizers(pair, text):
    mine, ref = pair
    ids = ref.encode(text).ids
    assert mine.encode(text) == ids, repr(text)
    assert mine.decode(ids) == ref.decode(ids), repr(text)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(ids=st.lists(st.integers(0, 720), max_size=24))
def test_hypothesis_ids_decode_as_tokenizers(pair, ids):
    """Arbitrary ids: unknown ones dropped, invalid UTF-8 replaced as
    `tokenizers` replaces it."""
    mine, ref = pair
    assert mine.decode(ids) == ref.decode(ids)
    assert mine.decode(ids, skip_special_tokens=False) == ref.decode(
        ids, skip_special_tokens=False)


def test_load_tokenizer_is_the_reader_and_matches_the_jax_package(
        llama3_json, tmp_path):
    """`load_tokenizer` returns the port's reader even where `tokenizers`
    is installed; `encode_text`/`incremental_decode` give the JAX
    package's ids and text on the same file."""
    from cake_tpu.models.llama import generator as jgen
    from cake_tpu_torch.models.llama import generator as tgen
    (tmp_path / "tokenizer.json").write_text(json.dumps(llama3_json))
    mine = tgen.load_tokenizer(str(tmp_path))
    assert isinstance(mine, BpeTokenizer)
    ref = jgen.load_tokenizer(str(tmp_path))
    for text in FIXED:
        ids = jgen.encode_text(ref, text)
        assert tgen.encode_text(mine, text) == ids
        assert (tgen.incremental_decode(mine, ids, "", final=True)
                == jgen.incremental_decode(ref, ids, "", final=True))


def test_the_split_classes_are_unicode_letters_and_numbers():
    """\\p{L} is not [^\\W\\d_] (which admits No/Nl such as ² and Ⅻ), and
    \\s is White_Space (Python's \\s also takes U+001C..U+001F)."""
    import re
    rx = re.compile(translate_regex(r"\p{L}+|\p{N}+|\s+"))
    assert [m.group() for m in rx.finditer("ab²Ⅻ٣x")] == ["ab", "²Ⅻ٣", "x"]
    assert [m.group() for m in rx.finditer(" \x1c ")] == [" ", " "]


@pytest.mark.parametrize("edit,feature", [
    (lambda s: s["model"].update(type="WordPiece"), "WordPiece"),
    (lambda s: s["model"].update(type="Unigram"), "Unigram"),
    (lambda s: s["model"].update(byte_fallback=True), "byte_fallback"),
    (lambda s: s["model"].update(dropout=0.1), "dropout"),
    (lambda s: s.update(normalizer={"type": "Lowercase"}), "Lowercase"),
    (lambda s: s["pre_tokenizer"]["pretokenizers"][1].update(
        add_prefix_space=True), "add_prefix_space"),
    (lambda s: s.update(pre_tokenizer={"type": "Metaspace",
                                       "replacement": "▁"}), "Metaspace"),
    (lambda s: s["pre_tokenizer"]["pretokenizers"][0]["pattern"].update(
        Regex=r"\p{Lu}+|\s+"), "escape"),
    (lambda s: s["pre_tokenizer"]["pretokenizers"][0]["pattern"].update(
        Regex=r"\w+|\s+"), r"\\w"),
    (lambda s: s["pre_tokenizer"]["pretokenizers"][0].update(
        behavior="MergedWithPrevious"), "MergedWithPrevious"),
    (lambda s: s.update(decoder={"type": "Metaspace"}), "decoder"),
    (lambda s: s.update(post_processor={"type": "BertProcessing"}),
     "BertProcessing"),
], ids=["wordpiece", "unigram", "byte_fallback", "dropout", "lowercase",
        "prefix_space", "metaspace", "lu", "w", "behavior", "decoder", "bert"])
def test_an_unsupported_file_raises_naming_the_feature(llama3_json, edit,
                                                       feature):
    spec = json.loads(json.dumps(llama3_json))
    edit(spec)
    with pytest.raises(UnsupportedTokenizer, match=feature):
        BpeTokenizer(spec)
