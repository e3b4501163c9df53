"""The BERT tokenizer (port of paddle_tpu/text/tokenizer.py): ``Vocab``,
``BasicTokenizer`` (drop control characters, normalise whitespace, space
CJK characters, lower-case and strip accents by NFD, split punctuation),
greedy longest-match ``WordpieceTokenizer`` and ``FasterTokenizer``, which
turns raw text into BERT's input ids and segment ids. Plain Python over
``unicodedata``, as the reference is: tokenization is host preprocessing
whose int64 tensors feed the model on the card.
"""
from __future__ import annotations

import unicodedata

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["Vocab", "BasicTokenizer", "WordpieceTokenizer", "FasterTokenizer"]


class Vocab:
    """A token -> id map; an unknown token maps to ``unk_token``'s id."""

    def __init__(self, token_to_idx, unk_token="[UNK]", pad_token="[PAD]",
                 cls_token="[CLS]", sep_token="[SEP]",
                 mask_token="[MASK]"):
        self.token_to_idx = dict(token_to_idx)
        self.idx_to_token = {i: t for t, i in self.token_to_idx.items()}
        self.unk_token = unk_token
        self.pad_token = pad_token
        self.cls_token = cls_token
        self.sep_token = sep_token
        self.mask_token = mask_token

    @classmethod
    def load_vocabulary(cls, filepath, **kwargs):
        token_to_idx = {}
        with open(filepath, encoding="utf-8") as f:
            for i, line in enumerate(f):
                token_to_idx[line.rstrip("\n")] = i
        return cls(token_to_idx, **kwargs)

    @classmethod
    def from_dict(cls, d, **kwargs):
        return cls(d, **kwargs)

    def __len__(self):
        return len(self.token_to_idx)

    def __getitem__(self, token):
        return self.token_to_idx.get(token,
                                     self.token_to_idx.get(self.unk_token, 0))

    def __contains__(self, token):
        return token in self.token_to_idx

    def to_indices(self, tokens):
        if isinstance(tokens, str):
            return self[tokens]
        return [self[t] for t in tokens]


def _is_whitespace(ch):
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or \
            (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp):
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    def __init__(self, do_lower_case=True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text):
        # clean: drop control chars, normalize whitespace
        cleaned = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            cleaned.append(" " if _is_whitespace(ch) else ch)
        text = "".join(cleaned)
        # CJK chars get surrounding spaces
        spaced = []
        for ch in text:
            if _is_chinese_char(ord(ch)):
                spaced.extend((" ", ch, " "))
            else:
                spaced.append(ch)
        text = "".join(spaced)

        tokens = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            # split on punctuation
            cur = []
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens


class WordpieceTokenizer:
    def __init__(self, vocab, unk_token="[UNK]", max_input_chars_per_word=100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, token):
        if len(token) > self.max_input_chars_per_word:
            return [self.unk_token]
        out, start = [], 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            out.append(cur)
            start = end
        return out


class FasterTokenizer:
    """The BERT tokenizer, on the host.

    ``__call__(text, text_pair=None)`` returns ``(input_ids,
    token_type_ids)``, int64 (batch, seq) tensors padded to the batch's
    longest row (or to ``max_seq_len`` with ``pad_to_max_seq_len``),
    pairs truncated longest-first. They are built in numpy and land on
    the current device (``set_device``; the card by default) with one
    copy each.
    """

    def __init__(self, vocab, do_lower_case=True, is_split_into_words=False):
        if isinstance(vocab, dict):
            vocab = Vocab.from_dict(vocab)
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.is_split_into_words = is_split_into_words
        self._basic = BasicTokenizer(do_lower_case)
        self._wordpiece = WordpieceTokenizer(vocab, vocab.unk_token)

    def _tokenize(self, text):
        if self.is_split_into_words:
            words = list(text)
        else:
            words = self._basic.tokenize(text)
        toks = []
        for w in words:
            toks.extend(self._wordpiece.tokenize(w))
        return toks

    def __call__(self, text, text_pair=None, max_seq_len=0,
                 pad_to_max_seq_len=False):
        if isinstance(text, str):
            text = [text]
        if isinstance(text_pair, str):
            text_pair = [text_pair]
        if text_pair is not None and len(text_pair) != len(text):
            raise ValueError("text and text_pair batch sizes differ")

        cls_id = self.vocab[self.vocab.cls_token]
        sep_id = self.vocab[self.vocab.sep_token]
        pad_id = self.vocab[self.vocab.pad_token]

        batch_ids, batch_seg = [], []
        for i, t in enumerate(text):
            ids_a = self.vocab.to_indices(self._tokenize(t))
            ids_b = (self.vocab.to_indices(self._tokenize(text_pair[i]))
                     if text_pair is not None else None)
            if max_seq_len and max_seq_len > 0:
                budget = max_seq_len - 2 - (1 if ids_b is not None else 0)
                if ids_b is not None:
                    # longest-first truncation (reference TruncateStrategy)
                    while len(ids_a) + len(ids_b) > budget:
                        if len(ids_a) >= len(ids_b):
                            ids_a.pop()
                        else:
                            ids_b.pop()
                else:
                    ids_a = ids_a[:max(max_seq_len - 2, 0)]
            ids = [cls_id] + ids_a + [sep_id]
            seg = [0] * len(ids)
            if ids_b is not None:
                ids += ids_b + [sep_id]
                seg += [1] * (len(ids_b) + 1)
            batch_ids.append(ids)
            batch_seg.append(seg)

        width = max(len(x) for x in batch_ids)
        if pad_to_max_seq_len and max_seq_len:
            width = max(width, max_seq_len)
        input_ids = np.full((len(batch_ids), width), pad_id, dtype=np.int64)
        seg_ids = np.zeros((len(batch_ids), width), dtype=np.int64)
        for i, (ids, seg) in enumerate(zip(batch_ids, batch_seg)):
            input_ids[i, :len(ids)] = ids
            seg_ids[i, :len(seg)] = seg
        device = resolve_device(None)
        return (torch.from_numpy(input_ids).to(device),
                torch.from_numpy(seg_ids).to(device))
