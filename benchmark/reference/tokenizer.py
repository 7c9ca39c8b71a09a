"""CLIP's tokenization in its character-level form, plain.

The SD-1.5 BPE files (vocab.json, merges.txt) are not in the repository, so
the cell runs the character-level vocabulary that stands in for them: every
byte-level character is a token, and a word's last character takes the
'</w>' form; BOS 49406, EOS 49407, EOS padding to the maximum length, added
tokens (AdaFace's z_0 .. z_15) matched first, longest first, with ids after
the 49,408 of the base vocabulary. The split pattern is CLIP's (letters,
single digits, runs of other non-space characters), lower-cased.
"""

from __future__ import annotations

import html
import re

import numpy as np

BOS_ID, EOS_ID, VOCAB_SIZE = 49406, 49407, 49408
_PAT = re.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
                  re.IGNORECASE)


def _byte_chars() -> list:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class Tokenizer:
    def __init__(self, subject: str = "z", num_vectors: int = 16):
        self.bytes = _byte_chars()
        chars = list(self.bytes.values())
        self.vocab = {ch: i for i, ch in enumerate(chars)}
        self.vocab.update({ch + "</w>": i + len(chars) for i, ch in enumerate(chars)})
        self.subject = subject
        self.placeholders = [f"{subject}_{i}" for i in range(num_vectors)]
        self.added = {t: VOCAB_SIZE + i for i, t in enumerate(self.placeholders)}

    @property
    def vocab_size_with_added(self) -> int:
        return VOCAB_SIZE + len(self.added)

    def convert_tokens_to_ids(self, tokens) -> list:
        return [self.added[t] for t in tokens]

    def rewrite(self, prompt: str) -> str:
        """The wrapper's prompt rewrite: the subject word becomes the 16 tokens."""
        ph = " ".join(self.placeholders)
        if ph in prompt:
            return prompt
        if re.search(r"\b" + self.subject + r"\b", prompt) is None:
            return ph + " " + prompt
        return re.sub(r"\b" + self.subject + r"\b", ph, prompt)

    def encode_raw(self, text: str) -> list:
        pat = re.compile("(" + "|".join(re.escape(t) for t in sorted(self.added, key=len, reverse=True)) + ")")
        ids = []
        for seg in pat.split(text):
            if seg in self.added:
                ids.append(self.added[seg])
                continue
            seg = re.sub(r"\s+", " ", html.unescape(html.unescape(seg))).strip().lower()
            for word in _PAT.findall(seg):
                chars = "".join(self.bytes[b] for b in word.encode("utf-8"))
                ids += [self.vocab[ch] for ch in chars[:-1]] + [self.vocab[chars[-1] + "</w>"]]
        return ids

    def __call__(self, texts, max_length: int = 77) -> np.ndarray:
        texts = [texts] if isinstance(texts, str) else texts
        out = np.full((len(texts), max_length), EOS_ID, np.int64)
        for i, t in enumerate(texts):
            row = [BOS_ID] + self.encode_raw(t)[:max_length - 2] + [EOS_ID]
            out[i, :len(row)] = row
        return out
