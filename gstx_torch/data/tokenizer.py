"""WordPiece tokenizer (bert-base-uncased semantics), self-contained: the
port's copy of ``gstx/data/tokenizer.py``.

The reference uses HF ``BertTokenizer.from_pretrained('bert-base-uncased')``
in every dataloader (``dataloader/dataloader_visdial_gen.py:60-63``).  This
environment has no network and no cached vocab, so gstx ships its own
implementation: basic tokenization (unicode cleanup, CJK spacing,
lowercasing + accent stripping, punctuation splitting) followed by greedy
longest-match-first WordPiece — the exact algorithm of the original BERT
tokenizer.  The 30522-entry ``vocab.txt`` is user data (like the region
features); tests use a small synthetic vocab.

A C++ fast path (gstx_torch/native/wordpiece.cc) is built and used on first
use;
the Python implementation is the reference and fallback.

Note: ``encode(text)`` does NOT add [CLS]/[SEP] — the reference's
pytorch_transformers encode() behaves the same, and the dataloaders add
specials themselves in ``encode_input``.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, Iterable, List, Optional, Tuple

_SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")

# HF's PreTrainedTokenizer.tokenize lowercases the text with a per-char
# regex substitution that skips special tokens (tokenization_utils.py:
# 644-653 in transformers 4.57).  Per-CHAR lowercasing matters: Python's
# whole-string str.lower() applies the Greek final-sigma rule
# ("ΑΣ".lower() == "ας") while the regex form emits "ασ" — pinned by the
# HF differential fuzz (scripts/tokenizer_fuzz.py).
_LOWER_PRESERVE_RE = re.compile(
    "(" + "|".join(re.escape(s) for s in _SPECIAL_TOKENS) + r")|(.+?)")


def _lower_preserving_specials(text: str) -> str:
    return _LOWER_PRESERVE_RE.sub(
        lambda m: m.group(1) or m.group(2).lower(), text)


def _split_on_specials(text: str) -> List[Tuple[str, bool]]:
    """Leftmost scan splitting out exact (case-sensitive) special tokens,
    the equivalent of HF's added-tokens trie split: '[SEP]' embedded in
    text is never split or lowercased."""
    segments: List[Tuple[str, bool]] = []
    pos = 0
    n = len(text)
    while pos < n:
        nxt, tok = n, None
        for s in _SPECIAL_TOKENS:
            i = text.find(s, pos)
            if i != -1 and i < nxt:
                nxt, tok = i, s
        if nxt > pos:
            segments.append((text[pos:nxt], False))
        if tok is None:
            break
        segments.append((tok, True))
        pos = nxt + len(tok)
    return segments


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric ranges count as punctuation (BERT semantics)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or \
            (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    """Cleanup + whitespace/punctuation/CJK splitting + lowercasing."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._space_cjk(text)
        # HF normalizes to NFC after CJK spacing (tokenization_bert.py:321)
        # so canonically-equivalent codepoint sequences tokenize alike
        text = unicodedata.normalize("NFC", text)
        tokens = text.split()
        out: List[str] = []
        for tok in tokens:
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            out.extend(self._split_punct(tok))
        return " ".join(out).split()

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _space_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(text: str) -> List[str]:
        out: List[List[str]] = []
        start_new = True
        for ch in text:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                    start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out]


class WordPieceTokenizer:
    """Greedy longest-match-first subword tokenization."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        tokens: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            tokens.append(cur)
            start = end
        return tokens


class BertTokenizer:
    """Drop-in equivalent of the reference's tokenizer usage surface:
    ``encode``, ``decode``, ``convert_tokens_to_ids``, ``tokenize``."""

    def __init__(self, vocab_path: Optional[str] = None,
                 vocab: Optional[Dict[str, int]] = None,
                 do_lower_case: bool = True, use_native: bool = True):
        self._native = None
        if vocab is None:
            if vocab_path is None:
                raise ValueError("need vocab_path or vocab")
            vocab = load_vocab(vocab_path)
            if use_native and do_lower_case:
                try:
                    from gstx_torch.native import NativeWordPiece, load_library

                    if load_library() is not None:
                        self._native = NativeWordPiece(vocab_path)
                except Exception:
                    self._native = None
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordPieceTokenizer(vocab)
        for tok in _SPECIAL_TOKENS:
            if tok not in vocab:
                raise ValueError(f"vocab missing special token {tok}")
        (self.PAD, self.UNK, self.CLS, self.SEP, self.MASK) = (
            vocab["[PAD]"], vocab["[UNK]"], vocab["[CLS]"], vocab["[SEP]"],
            vocab["[MASK]"])

    def tokenize(self, text: str) -> List[str]:
        # mirror HF's full tokenize(): per-char lowercase preserving
        # special tokens, split out specials (never split/lowercased),
        # then basic + wordpiece on the plain segments
        if self.basic.do_lower_case:
            text = _lower_preserving_specials(text)
        out: List[str] = []
        for seg, is_special in _split_on_specials(text):
            if is_special:
                out.append(seg)
                continue
            for word in self.basic.tokenize(seg):
                out.extend(self.wordpiece.tokenize(word))
        return out

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        unk = self.vocab[self.wordpiece.unk_token]
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.inv_vocab.get(int(i), self.wordpiece.unk_token)
                for i in ids]

    def encode(self, text: str) -> List[int]:
        """Token ids WITHOUT special tokens (matches the reference call
        sites, e.g. dataloader_visdial_gen.py:129)."""
        if self._native is not None:
            ids = self._native.encode(text)
            if ids is not None:  # non-ASCII falls through to python
                return ids
        return self.convert_tokens_to_ids(self.tokenize(text))

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True)\
            -> str:
        specials = set(_SPECIAL_TOKENS)
        toks = []
        for t in self.convert_ids_to_tokens(ids):
            if skip_special_tokens and t in specials:
                continue
            toks.append(t)
        # merge wordpieces
        out: List[str] = []
        for t in toks:
            if t.startswith("##") and out:
                out[-1] += t[2:]
            else:
                out.append(t)
        return " ".join(out)

    def _convert_id_to_token(self, idx: int) -> str:
        return self.inv_vocab.get(int(idx), self.wordpiece.unk_token)


def load_vocab(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def make_test_vocab(words: Iterable[str]) -> Dict[str, int]:
    """Small synthetic vocab for tests: specials at the bert-base-uncased
    ids (0,100,101,102,103) so SPECIAL_TOKEN_IDS semantics hold."""
    vocab = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102,
             "[MASK]": 103}
    nxt = 1
    for w in words:
        if w in vocab:
            continue
        while nxt in (100, 101, 102, 103):
            nxt += 1
        vocab[w] = nxt
        nxt += 1
    return vocab
