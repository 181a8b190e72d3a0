"""The port's `tokenizer.json` reader on CLIP's tokenizer against the
`tokenizers` package (which the JAX package's `HFClipTokenizer` uses).

A CLIP-style file is trained here with `tokenizers`' own `BpeTrainer`
on text of this repository, shaped as openai/clip-vit-* ship it: the
`Sequence[NFC, Replace(\\s+ -> " "), Lowercase]` normalizer, the
`Split(Regex, Removed, invert=true)` pre-tokenizer over CLIP's pattern,
byte-level characters, a BPE with `end_of_word_suffix` "</w>" and an
unk token, `<|startoftext|>` / `<|endoftext|>` special tokens and the
`RobertaProcessing` post-processor. The ids must equal `tokenizers'`
on fixed strings and on `hypothesis` text; the SD tokenizer's
`encode(text, 77)` must equal the JAX package's `HFClipTokenizer` on
the same file (EOS padding, truncation keeping the EOS); the features
around the taught ones still raise, naming themselves.
"""

import json
import os

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

tokenizers = pytest.importorskip("tokenizers")

from cake_tpu_torch.models.llama.tokenizer import (  # noqa: E402
    BpeTokenizer, UnsupportedTokenizer,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP_SPLIT = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
              r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+")
SPECIAL = ["<|startoftext|>", "<|endoftext|>"]
MIXED = ("Grüße, naïve café — 東京は晴れ。 Привет мир! ١٢٣ ²³ ½ "
         "A RUSTY Robot's  walk\t\ton a SANDY beach\n\n 😀👍🏽")


def _corpus() -> str:
    with open(os.path.join(ROOT, "README.md"), encoding="utf-8") as f:
        return f.read()[:40000] + "\n" + MIXED * 20


@pytest.fixture(scope="module")
def clip_json():
    from tokenizers import (
        Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers,
        processors, trainers,
    )
    tok = Tokenizer(models.BPE(unk_token="<|endoftext|>",
                               end_of_word_suffix="</w>"))
    tok.normalizer = normalizers.Sequence([
        normalizers.NFC(), normalizers.Replace(Regex(r"\s+"), " "),
        normalizers.Lowercase()])
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(CLIP_SPLIT), "removed", invert=True),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator([_corpus()], trainers.BpeTrainer(
        vocab_size=700, special_tokens=SPECIAL, end_of_word_suffix="</w>",
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.post_processor = processors.RobertaProcessing(
        sep=("<|endoftext|>", tok.token_to_id("<|endoftext|>")),
        cls=("<|startoftext|>", tok.token_to_id("<|startoftext|>")),
        trim_offsets=False, add_prefix_space=False)
    return json.loads(tok.to_str())


@pytest.fixture(scope="module")
def pair(clip_json):
    from tokenizers import Tokenizer
    text = json.dumps(clip_json)
    return BpeTokenizer(json.loads(text)), Tokenizer.from_str(text)


FIXED = [
    "",
    "A very realistic photo of a rusty robot walking on a sandy beach",
    MIXED,
    "<|startoftext|>a cat<|endoftext|>   dog's  TAIL  ",
    "x" * 300 + " qzqzqz ~~~ ###",
    "é vs é, Å vs Å, ﬁ ligature, ſ long s",
    "tabs\tand\nnewlines\r\n  and　ideographic spaces",
]


@pytest.mark.parametrize("text", FIXED, ids=range(len(FIXED)))
def test_fixed_strings_encode_as_tokenizers(pair, text):
    mine, ref = pair
    assert mine.encode(text) == ref.encode(text).ids
    assert mine.encode(text, add_special_tokens=False) == \
        ref.encode(text, add_special_tokens=False).ids


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.text(alphabet=st.characters(
    whitelist_categories=("Lu", "Ll", "Nd", "No", "Mn", "Zs", "Po", "So",
                          "Cc")), max_size=60))
def test_hypothesis_text_encodes_as_tokenizers(pair, text):
    mine, ref = pair
    assert mine.encode(text) == ref.encode(text).ids


def test_sd_clip_tokenizer_pads_and_truncates_as_jaxs(clip_json, tmp_path):
    from cake_tpu.models.sd.sd import HFClipTokenizer
    from cake_tpu_torch.models.sd.sd import ClipTokenizer

    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(clip_json))
    mine, jaxs = ClipTokenizer(str(path)), HFClipTokenizer(str(path))
    for text in FIXED + [" ".join(["robot"] * 120)]:
        got = mine.encode(text)
        assert got == jaxs.encode(text) and len(got) == 77
        assert got[0] == clip_json["post_processor"]["cls"][1]
        assert got[-1] == clip_json["post_processor"]["sep"][1]
    assert mine.encode("a cat", max_len=5) == jaxs.encode("a cat", max_len=5)


@pytest.mark.parametrize("edit,feature", [
    (lambda s: s["normalizer"]["normalizers"].pop(1), "Sequence"),
    (lambda s: s["normalizer"]["normalizers"][1].update(content="_"),
     "Sequence"),
    (lambda s: s.update(normalizer={"type": "Lowercase"}), "Lowercase"),
    (lambda s: s["pre_tokenizer"]["pretokenizers"][0].update(invert=False),
     "Removed"),
    (lambda s: s["model"].update(end_of_word_suffix="@@"),
     "end_of_word_suffix"),
    (lambda s: s["model"].update(continuing_subword_prefix="##"),
     "continuing_subword_prefix"),
    (lambda s: s.update(post_processor={"type": "BertProcessing"}),
     "BertProcessing"),
], ids=["short", "content", "bare", "not-inverted", "suffix", "prefix",
        "bert"])
def test_features_around_clips_still_raise(clip_json, edit, feature):
    spec = json.loads(json.dumps(clip_json))
    edit(spec)
    with pytest.raises(UnsupportedTokenizer, match=feature):
        BpeTokenizer(spec)
