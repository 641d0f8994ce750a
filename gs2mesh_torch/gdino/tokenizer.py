"""The uncased BERT WordPiece tokenizer GroundingDINO's captions go through.

The port's own copy of HF transformers' ``BertTokenizer`` (the slow,
pure-Python one: tokenization_bert.py's BasicTokenizer and
WordpieceTokenizer, tokenization_utils.py's special-token split and
``decode``) for a ``vocab.txt``, so no ``transformers`` is needed:
lower-casing, accent stripping (NFD), splitting on whitespace, punctuation
and CJK characters, greedy longest-match-first WordPiece with ``##``
continuations and ``[UNK]``, ``[CLS]`` ... ``[SEP]`` around a sequence, and
``decode`` (pieces re-joined, the spaces before punctuation cleaned up).
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List, Optional

SPECIAL_TOKENS = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")


def _is_whitespace(ch: str) -> bool:
    if ch in " \t\n\r":
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # Every non-letter / non-number ASCII character counts.
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _clean(text: str) -> str:
    """Drops NUL, U+FFFD and control characters; whitespace becomes ' '."""
    return "".join(" " if _is_whitespace(c) else c for c in text
                   if not (ord(c) in (0, 0xFFFD) or _is_control(c)))


def _strip_accents(text: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFD", text)
                   if unicodedata.category(c) != "Mn")


def _split_on_punc(text: str) -> List[str]:
    out: List[List[str]] = []
    new_word = True
    for c in text:
        if _is_punctuation(c):
            out.append([c])
            new_word = True
        else:
            if new_word:
                out.append([])
            new_word = False
            out[-1].append(c)
    return ["".join(w) for w in out]


def load_vocab(path: str) -> Dict[str, int]:
    with open(path, "r", encoding="utf-8") as f:
        return {line.rstrip("\n"): i for i, line in enumerate(f)}


class BertTokenizer:
    """bert-base-uncased tokenization of one vocab file.

    ``tokenizer(text)["input_ids"]`` is ``[CLS] pieces [SEP]``;
    ``decode(ids)`` the pieces' text. The five special tokens are never
    split or lower-cased where they appear in the text."""

    max_input_chars_per_word = 100

    def __init__(self, vocab_file: str):
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self._special = re.compile(
            "(" + "|".join(re.escape(t) for t in SPECIAL_TOKENS) + ")")

    # -- encode ------------------------------------------------------------
    def _basic(self, text: str) -> List[str]:
        text = _clean(text)
        text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
        text = unicodedata.normalize("NFC", text)
        tokens = []
        for tok in text.split():
            tokens.extend(_split_on_punc(_strip_accents(tok.lower())))
        return " ".join(tokens).split()

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return ["[UNK]"]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    break
                end -= 1
            else:
                return ["[UNK]"]
            pieces.append(sub)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for part in self._special.split(text):
            if part in SPECIAL_TOKENS:
                out.append(part)
                continue
            # Lower-cased a character at a time first, as HF's tokenize()
            # does (a final sigma stays a sigma).
            part = "".join(c.lower() for c in part)
            for word in self._basic(part):
                out.extend(self._wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        unk = self.vocab.get("[UNK]")
        return [self.vocab.get(t, unk) for t in tokens]

    def __call__(self, text: str) -> Dict[str, List[int]]:
        ids = self.convert_tokens_to_ids(
            ["[CLS]"] + self.tokenize(text) + ["[SEP]"])
        return {"input_ids": ids}

    # -- decode ------------------------------------------------------------
    def decode(self, ids) -> str:
        tokens = [self.ids_to_tokens.get(int(i), "[UNK]") for i in ids]
        text = " ".join(tokens).replace(" ##", "").strip()
        for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                     (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                     (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
            text = text.replace(a, b)
        return text


def load_tokenizer(vocab_path: Optional[str] = None):
    """The uncased BERT tokenizer of ``vocab_path`` (a bert-base-uncased
    ``vocab.txt``). With no path it asks HF ``transformers`` for
    ``bert-base-uncased`` (imported here, and it must find the files in its
    local cache), as the JAX package does."""
    if vocab_path is not None:
        return BertTokenizer(vocab_path)
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained("bert-base-uncased")
