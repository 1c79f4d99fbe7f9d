"""The port's CLIP BPE tokenizer (data/tokenizer.py, standard-library ``re``)
vs the JAX package's (``regex``): identical token ids, exactly, on a
synthetic vocabulary written as an open_clip merges file and as HF
vocab.json + merges.txt, in both pad styles, with truncation; the same ids
when ``regex`` cannot be imported; and the one documented difference, on
numerics that are not decimal digits."""
import gzip
import importlib
import json
import sys

import numpy as np
import pytest

from custom_diffusion360_tpu.data import tokenizer as jtok
from custom_diffusion360_torch.data import tokenizer as ttok

WORDS = ["photo", "of", "a", "car", "chair", "teddybear", "red", "3d", "x_y", "café", "naïve"]
PROMPTS = [
    "photo of a <new1> car",
    "A photo of a RED car, 3d render!!  (v2.0) x_y __init__ 42",
    "café naïve Ünïcödé déjà-vu <new1> chair's",
    "<new1> teddybear &amp; 12/34 #tag @user ... ?!",
    "",
    " ".join(["photo of a red car"] * 30),  # past 77 tokens: truncated, eot forced
]


def _merges():
    return jtok.make_test_tokenizer(WORDS).bpe_ranks


def _files(tmp_path):
    merges = sorted(_merges(), key=_merges().get)
    oc = tmp_path / "bpe_simple_vocab_16e6.txt.gz"
    with gzip.open(oc, "wt", encoding="utf-8") as f:
        f.write("#version: synthetic\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    vocab = jtok.ClipTokenizer(merges).encoder
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    return str(oc), str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")


@pytest.mark.parametrize("source", ["open_clip", "open_clip_hf_pad", "hf"])
def test_ids_match_jax(tmp_path, source):
    oc, vj, mt = _files(tmp_path)
    kw = dict(additional_special_tokens=("<new1>",), context_length=77)
    if source == "hf":
        jt, tt = jtok.ClipTokenizer.from_hf_files(vj, mt, **kw), ttok.ClipTokenizer.from_hf_files(
            vj, mt, **kw)
    else:
        pad = "hf" if source == "open_clip_hf_pad" else "open_clip"
        jt = jtok.ClipTokenizer.from_merges(oc, pad_style=pad, **kw)
        tt = ttok.ClipTokenizer.from_merges(oc, pad_style=pad, **kw)
    want, got = jt(PROMPTS), tt(PROMPTS)
    assert got.dtype == np.int32 and got.shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(got, want)
    assert got[-1, -1] == tt.eot  # the truncated prompt ends in eot
    assert tt.pad_id == (0 if source == "open_clip" else tt.eot)
    assert (got == tt.encoder["<new1>"]).any()
    for row in got[:4]:
        assert tt.decode(row[row != tt.pad_id]) == jt.decode(row[row != jt.pad_id])


def test_make_test_tokenizer_matches_jax():
    kw = dict(additional_special_tokens=("<new1>",), context_length=16)
    jt = jtok.make_test_tokenizer(["photo", "of", "a", "car"], **kw)
    tt = ttok.make_test_tokenizer(["photo", "of", "a", "car"], **kw)
    np.testing.assert_array_equal(tt(PROMPTS), jt(PROMPTS))


def test_same_ids_without_regex(monkeypatch):
    want = ttok.make_test_tokenizer(WORDS, additional_special_tokens=("<new1>",))(PROMPTS)
    monkeypatch.setitem(sys.modules, "regex", None)  # import regex -> ImportError
    try:
        mod = importlib.reload(ttok)
        got = mod.make_test_tokenizer(WORDS, additional_special_tokens=("<new1>",))(PROMPTS)
    finally:
        monkeypatch.undo()
        importlib.reload(ttok)
    np.testing.assert_array_equal(got, want)


def test_non_decimal_numerics_differ_as_documented():
    """regex's \\p{N} holds "½" and "²" (a token each); the port's \\d does
    not, and \\w does, so there they join the neighbouring letters."""
    jt, tt = jtok.make_test_tokenizer(), ttok.make_test_tokenizer()
    assert jt.pat.findall("a½b x²") == ["a", "½", "b", "x", "²"]
    assert tt.pat.findall("a½b x²") == ["a½b", "x²"]
    # decimal digits, in any script, are single tokens in both
    assert jt.pat.findall("ab12٣") == tt.pat.findall("ab12٣") == ["ab", "1", "2", "٣"]
