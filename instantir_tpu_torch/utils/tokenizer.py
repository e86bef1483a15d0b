"""CLIP's byte-level BPE tokenizer, on the standard library alone.

The port's counterpart of ``transformers.CLIPTokenizer`` as the SDXL
pipelines call it (``tokenizer(prompt, padding="max_length", max_length=77,
truncation=True)["input_ids"]``), read from a tokenizer folder's
``vocab.json`` and ``merges.txt``. It follows HF's path for an installation
without ``ftfy``: control characters dropped and whitespace made single
spaces, CJK ideographs spaced apart, NFC normalisation, lower case (accents
kept), then CLIP's word pattern, each word's UTF-8 bytes mapped to printable
characters and merged by rank with ``</w>`` closing the word. The pattern's
``\\p{L}`` and ``\\p{N}`` classes come from ``unicodedata`` categories, so
``regex`` is not needed. The special tokens (``bos``, ``eos``, ``unk``,
``pad``) are read from ``tokenizer_config.json`` / ``special_tokens_map.json``
where given (SDXL's ``tokenizer_2`` pads with ``!``) and are matched whole in
the text before the pattern runs, as HF's added tokens are.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULTS = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>", "unk_token": "<|endoftext|>",
             "pad_token": "<|endoftext|>"}
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_PATTERN_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
# CLIP reads at most this many merges (``tokenization_clip.py``: 49152 - 256 - 2)
_MAX_MERGES = 49152 - 256 - 2


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map from the 256 byte values to printable characters."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """HF's ``BasicTokenizer(strip_accents=False, do_split_on_punc=False)``:
    the words joined by single spaces."""
    chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            chars.append(" ")
        elif _is_cjk(cp):
            chars.extend((" ", ch, " "))
        else:
            chars.append(ch)
    words = unicodedata.normalize("NFC", "".join(chars)).split()
    return " ".join(" ".join(w.lower() for w in words).split())


def _kind(ch: str) -> str:
    cat = unicodedata.category(ch)
    if cat[0] == "L":
        return "L"
    if cat[0] == "N":
        return "N"
    return "S" if ch.isspace() else "O"


def split_words(text: str) -> List[str]:
    """``re.findall`` of CLIP's pattern ``<|startoftext|>|<|endoftext|>|'s|'t|
    're|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` (case-blind):
    at each position the first alternative that matches, whitespace skipped.
    ``text`` is lower case already (``basic_clean``)."""
    out = []
    i, n = 0, len(text)
    while i < n:
        match = next((s for s in _PATTERN_SPECIALS + _CONTRACTIONS if text.startswith(s, i)), None)
        if match is not None:
            out.append(text[i:i + len(match)])
            i += len(match)
            continue
        kind = _kind(text[i])
        if kind == "S":
            i += 1
            continue
        j = i + 1
        if kind != "N":
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPTokenizer:
    """``tokenizer(texts, padding="max_length", max_length=77,
    truncation=True)`` -> ``{"input_ids": [[...], ...]}`` (a string gives one row)."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]], bos_token: str, eos_token: str,
                 unk_token: str, pad_token: str, model_max_length: int = 77):
        self.encoder = dict(vocab)
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_token, self.eos_token, self.unk_token, self.pad_token = bos_token, eos_token, unk_token, pad_token
        self.model_max_length = model_max_length
        # longest first, so that a special token holding another is matched whole
        self.specials = sorted({bos_token, eos_token, unk_token, pad_token}, key=len, reverse=True)
        self.cache: Dict[str, str] = {s: s for s in _PATTERN_SPECIALS}

    @classmethod
    def from_pretrained(cls, folder: str) -> "CLIPTokenizer":
        with open(os.path.join(folder, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(folder, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:_MAX_MERGES + 1]
        merges = [tuple(line.split()) for line in lines]
        settings = dict(_DEFAULTS, model_max_length=77)
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            path = os.path.join(folder, name)
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    d = json.load(f)
                for key in (*_DEFAULTS, "model_max_length"):
                    v = d.get(key)
                    if isinstance(v, dict):  # a serialized AddedToken
                        v = v.get("content")
                    if v is not None:
                        settings[key] = v
        return cls(vocab, merges, settings["bos_token"], settings["eos_token"], settings["unk_token"],
                   settings["pad_token"], int(settings["model_max_length"]))

    def token_id(self, token: str) -> int:
        return self.encoder.get(token, self.encoder.get(self.unk_token))

    @property
    def bos_token_id(self) -> int:
        return self.token_id(self.bos_token)

    @property
    def eos_token_id(self) -> int:
        return self.token_id(self.eos_token)

    @property
    def pad_token_id(self) -> int:
        return self.token_id(self.pad_token)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(a, b) for a, b in zip(word, word[1:])}
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _split_specials(self, text: str) -> List[Tuple[bool, str]]:
        """``text`` cut at every whole special token: ``(is_special, piece)``."""
        pieces: List[Tuple[bool, str]] = []
        start = i = 0
        while i < len(text):
            hit = next((s for s in self.specials if text.startswith(s, i)), None)
            if hit is None:
                i += 1
                continue
            if i > start:
                pieces.append((False, text[start:i]))
            pieces.append((True, hit))
            i += len(hit)
            start = i
        if start < len(text):
            pieces.append((False, text[start:]))
        return pieces

    def tokenize(self, text: str) -> List[str]:
        tokens: List[str] = []
        for special, piece in self._split_specials(text):
            if special:
                tokens.append(piece)
                continue
            for word in split_words(basic_clean(piece)):
                mapped = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
                tokens.extend(self.bpe(mapped).split(" "))
        return tokens

    def encode(self, text: str, max_length: Optional[int] = None, truncation: bool = True,
               padding: Optional[str] = "max_length") -> List[int]:
        """BOS, the tokens, EOS; truncated to ``max_length`` keeping EOS, then padded."""
        max_length = max_length or self.model_max_length
        ids = [self.token_id(t) for t in self.tokenize(text)]
        if truncation:
            ids = ids[:max_length - 2]
        ids = [self.bos_token_id] + ids + [self.eos_token_id]
        if padding == "max_length":
            ids += [self.pad_token_id] * (max_length - len(ids))
        return ids

    def __call__(self, text, padding: Optional[str] = "max_length", max_length: Optional[int] = None,
                 truncation: bool = True) -> Dict[str, list]:
        if isinstance(text, str):
            return {"input_ids": self.encode(text, max_length, truncation, padding)}
        return {"input_ids": [self.encode(t, max_length, truncation, padding) for t in text]}
