r"""CLIP BPE tokenizer — self-contained, no transformers dependency at runtime.

The port's own copy of the JAX package's tokenizer, rewritten on the
standard-library `re` module (the third-party `regex` module and its
`\p{L}`/`\p{N}` classes are not available everywhere the port runs).

Implements the byte-level BPE used by openai/clip-vit-large-patch14 (the
tokenizer all reference towers share). Vocabulary assets (vocab.json +
merges.txt, shipped with every SD-1.5 distribution) are loaded from disk;
when none are present a deterministic *character-level fallback* vocabulary
is built so the full pipeline can run end-to-end in tests/benchmarks without
downloaded assets (ids are NOT CLIP-compatible in fallback mode — the
`is_fallback` flag records this).

Capabilities mirrored from the reference usage:
  * encode with truncation + max-length padding (pad = EOS), the
    FrozenCLIPEmbedder call pattern (ldm/modules/encoders/modules.py:452-455)
    and the AdaFaceWrapper/diffusers pattern;
  * `add_tokens` for the 16 subject placeholder tokens z_0..z_15
    (adaface/adaface_wrapper.py:152-174): new ids appended after the base
    vocabulary.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re

import numpy as np

BOS_ID = 49406
EOS_ID = 49407
VOCAB_SIZE = 49408
MAX_LEN = 77

# CLIP's split pattern with stdlib classes: letters are word characters
# that are neither digits nor "_" (`[^\W\d_]`), numbers are `\d`, and the
# third class is every run of characters that are neither whitespace nor
# word characters, plus "_". Unicode numerals outside category Nd (e.g. "²")
# count as letters here, where `regex`'s `\p{N}` would call them numbers.
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip().lower()


class CLIPTokenizer:
    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 is_fallback: bool = False, base_size: int | None = None):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.is_fallback = is_fallback
        self.added_tokens: dict[str, int] = {}
        self.bos_id = self.encoder.get("<|startoftext|>", BOS_ID)
        self.eos_id = self.encoder.get("<|endoftext|>", EOS_ID)
        self._base_size = base_size or max(VOCAB_SIZE, max(self.encoder.values()) + 1)

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str) -> "CLIPTokenizer":
        with open(vocab_json) as f:
            vocab = json.load(f)
        opener = gzip.open if merges_txt.endswith(".gz") else open
        with opener(merges_txt, "rt") as f:
            lines = f.read().split("\n")
        merges = []
        for ln in lines:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split()
            if len(parts) == 2:
                merges.append(tuple(parts))
        return cls(vocab, merges)

    @classmethod
    def fallback(cls) -> "CLIPTokenizer":
        """Deterministic char-level vocabulary (no merges)."""
        chars = list(bytes_to_unicode().values())
        vocab = {}
        for i, c in enumerate(chars):
            vocab[c] = i
            vocab[c + "</w>"] = i + len(chars)
        vocab["<|startoftext|>"] = BOS_ID
        vocab["<|endoftext|>"] = EOS_ID
        return cls(vocab, [], is_fallback=True)

    @classmethod
    def tiny(cls) -> "CLIPTokenizer":
        """Char-level vocab with a COMPACT id space (bos=512, eos=513,
        vocab_size 514). For tests/dryruns where a 49408-row embedding
        table would dominate memory/collective traffic; ids are NOT
        CLIP-compatible."""
        chars = list(bytes_to_unicode().values())
        vocab = {}
        for i, c in enumerate(chars):
            vocab[c] = i
            vocab[c + "</w>"] = i + len(chars)
        vocab["<|startoftext|>"] = 2 * len(chars)
        vocab["<|endoftext|>"] = 2 * len(chars) + 1
        return cls(vocab, [], is_fallback=True, base_size=2 * len(chars) + 2)

    @classmethod
    def load(cls, asset_dir: str | None = None) -> "CLIPTokenizer":
        """Load from `asset_dir` (or $ADAPROMPT_TOKENIZER_DIR) containing
        vocab.json + merges.txt; fall back to the char-level vocab."""
        asset_dir = asset_dir or os.environ.get("ADAPROMPT_TOKENIZER_DIR")
        if asset_dir:
            vj = os.path.join(asset_dir, "vocab.json")
            for name in ("merges.txt", "merges.txt.gz", "bpe_simple_vocab_16e6.txt.gz"):
                mt = os.path.join(asset_dir, name)
                if os.path.exists(vj) and os.path.exists(mt):
                    return cls.from_files(vj, mt)
        return cls.fallback()

    # -- BPE ----------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not self.bpe_ranks:
            out = " ".join(word)
            self.cache[token] = out
            return out

        def get_pairs(word):
            return {(a, b) for a, b in zip(word[:-1], word[1:])}

        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    # -- public API ----------------------------------------------------------

    def add_tokens(self, tokens: list[str]) -> int:
        """Append new tokens after the base vocab (AdaFaceWrapper
        extend_tokenizer semantics). Returns count actually added."""
        added = 0
        for tok in tokens:
            if tok in self.encoder or tok in self.added_tokens:
                continue
            new_id = self._base_size + len(self.added_tokens)
            self.added_tokens[tok] = new_id
            self.decoder[new_id] = tok
            added += 1
        return added

    def convert_tokens_to_ids(self, tokens):
        return [self.added_tokens.get(t, self.encoder.get(t, self.eos_id)) for t in tokens]

    @property
    def vocab_size_with_added(self) -> int:
        return self._base_size + len(self.added_tokens)

    def encode_raw(self, text: str) -> list[int]:
        """Token ids without special tokens."""
        # split out added tokens first (HF added-token semantics)
        segments = [text]
        if self.added_tokens:
            toks = sorted(self.added_tokens, key=len, reverse=True)  # longest match first
            pat = re.compile("(" + "|".join(re.escape(t) for t in toks) + ")")
            segments = pat.split(text)
        ids = []
        for seg in segments:
            if seg in self.added_tokens:
                ids.append(self.added_tokens[seg])
                continue
            for tok in _PAT.findall(_clean(seg)):
                btok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                ids.extend(self.encoder.get(t, self.eos_id) for t in self._bpe(btok).split(" "))
        return ids

    def __call__(self, texts, max_length: int = MAX_LEN, pad: bool = True,
                 truncate: bool = True) -> np.ndarray:
        """Encode to [B, max_length] int32 with BOS/EOS and EOS padding —
        the CLIPTokenizer(padding='max_length', truncation=True) pattern."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), max_length), self.eos_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = self.encode_raw(t)
            if truncate:
                ids = ids[: max_length - 2]
            row = [self.bos_id] + ids + [self.eos_id]
            out[i, : len(row)] = row
        return out

    def decode(self, ids) -> str:
        toks = [self.decoder.get(int(i), "") for i in ids
                if int(i) not in (self.bos_id, self.eos_id)]
        text = "".join(toks).replace("</w>", " ")
        try:
            raw = bytearray(self.byte_decoder.get(c, 32) for c in text)
            return raw.decode("utf-8", errors="replace").strip()
        except Exception:
            return text.strip()
