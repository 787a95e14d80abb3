"""Native byte-level BPE tokenizer loading HuggingFace ``tokenizer.json``.

A copy of ``ray_tpu/llm/_internal/bpe.py``: a self-contained parser +
encoder for the ``tokenizer.json`` format (vocab + ranked merges +
byte-level pre-tokenization + added special tokens), no transformers
import on the serving path. Llama-3's tiktoken-style regex
pre-tokenizer is honored when the ``regex`` module is available;
otherwise a category-based splitter approximates it.

Everything loads from local disk.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Tuple


@functools.lru_cache(maxsize=1)
def _byte_unicode_table() -> Tuple[Dict[int, str], Dict[str, int]]:
    """GPT-2's reversible byte<->unicode mapping used by byte-level BPE:
    printable latin-1 bytes map to themselves, the rest to U+0100+n so
    every byte has a visible, non-whitespace stand-in character."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    enc: Dict[int, str] = {}
    n = 0
    for b in range(256):
        if b in keep:
            enc[b] = chr(b)
        else:
            enc[b] = chr(0x100 + n)
            n += 1
    dec = {c: b for b, c in enc.items()}
    return enc, dec


# Llama-3 / tiktoken cl100k-style pre-tokenization pattern.
_LLAMA3_PAT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
# GPT-2 pattern — what a ByteLevel(use_regex=True) pre-tokenizer applies.
_GPT2_PAT = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
    r"|\s+(?!\S)|\s+")


@functools.lru_cache(maxsize=4)
def _splitter(pattern: Optional[str]):
    try:
        import regex
        return regex.compile(pattern or _LLAMA3_PAT).findall
    except ImportError:  # crude fallback: words / digits / runs
        import re

        def findall(text: str) -> List[str]:
            return re.findall(r" ?\w+| ?[^\w\s]+|\s+", text)
        return findall


class BPETokenizer:
    """Byte-level BPE with HF special-token handling.

    Parameters mirror what ``tokenizer.json`` + ``tokenizer_config.json``
    provide; use :func:`load` for the file-based entry point.
    """

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 special_tokens: Optional[Dict[str, int]] = None,
                 pre_tokenizer_pattern: Optional[str] = None,
                 bos_token: Optional[str] = None,
                 eos_token: Optional[str] = None,
                 ignore_merges: bool = False):
        # ignore_merges (Llama-3 sets it): a piece that IS a vocab entry
        # becomes that single id directly, even when the ranked merge
        # path cannot reach it
        self.ignore_merges = ignore_merges
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.special = dict(special_tokens or {})
        self.inv_special = {i: t for t, i in self.special.items()}
        self._pat = pre_tokenizer_pattern
        self._enc_table, self._dec_table = _byte_unicode_table()
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.bos_id = self.special.get(bos_token) if bos_token else None
        self.eos_id = self.special.get(eos_token) if eos_token else None
        if self.eos_id is None and eos_token:
            self.eos_id = vocab.get(eos_token)
        if self.bos_id is None and bos_token:
            self.bos_id = vocab.get(bos_token)
        self.pad_id = 0
        self.vocab_size = max(
            [max(vocab.values(), default=0)]
            + [max(self.special.values(), default=0)]) + 1
        self._cache: Dict[str, List[int]] = {}

    # ---------------------------------------------------------------- encode

    def _bpe_word(self, word: str) -> List[int]:
        """Greedy lowest-rank merging of one pre-tokenized piece
        (already in byte-unicode space)."""
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        if self.ignore_merges:
            whole = self.vocab.get(word)
            if whole is not None:
                ids = [whole]
                if len(self._cache) < 65536:
                    self._cache[word] = ids
                return ids
        parts = list(word)
        while len(parts) > 1:
            best_rank, best_i = None, -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        unk = self.vocab.get("<unk>", 0)
        ids = [self.vocab.get(p, unk) for p in parts]
        if len(self._cache) < 65536:
            self._cache[word] = ids
        return ids

    def _encode_ordinary(self, text: str) -> List[int]:
        enc = self._enc_table
        out: List[int] = []
        for piece in _splitter(self._pat)(text):
            mapped = "".join(enc[b] for b in piece.encode("utf-8"))
            out.extend(self._bpe_word(mapped))
        return out

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        """Special tokens appearing literally in the text are emitted as
        their single ids (HF ``added_tokens`` splitting)."""
        ids: List[int] = []
        if (add_bos and self.bos_id is not None
                and not (self.bos_token
                         and text.startswith(self.bos_token))):
            # chat templates embed the BOS literal themselves; don't
            # double-emit it
            ids.append(self.bos_id)
        if self.special:
            # split on the longest specials first so overlapping names
            # ("<|eot|>" vs "<|eot_id|>") resolve to the longer match
            names = sorted(self.special, key=len, reverse=True)
            rest = text
            while rest:
                hit, hit_at = None, len(rest)
                for name in names:
                    at = rest.find(name)
                    if at != -1 and at < hit_at:
                        hit, hit_at = name, at
                if hit is None:
                    ids.extend(self._encode_ordinary(rest))
                    break
                if hit_at:
                    ids.extend(self._encode_ordinary(rest[:hit_at]))
                ids.append(self.special[hit])
                rest = rest[hit_at + len(hit):]
        else:
            ids.extend(self._encode_ordinary(text))
        return ids

    # ---------------------------------------------------------------- decode

    def decode(self, ids: List[int],
               skip_special_tokens: bool = True) -> str:
        dec = self._dec_table
        chunks: List[str] = []
        buf = bytearray()
        for i in ids:
            sp = self.inv_special.get(int(i))
            if sp is not None:
                if not skip_special_tokens:
                    if buf:
                        chunks.append(buf.decode("utf-8", errors="replace"))
                        buf = bytearray()
                    chunks.append(sp)
                continue
            tok = self.inv_vocab.get(int(i))
            if tok is None:
                continue
            for c in tok:
                b = dec.get(c)
                if b is not None:
                    buf.append(b)
                else:           # non-byte-level vocab entry: raw utf-8
                    buf.extend(c.encode("utf-8"))
        if buf:
            chunks.append(buf.decode("utf-8", errors="replace"))
        return "".join(chunks)

    # ------------------------------------------------------------------ chat

    def apply_chat_template(self, messages: List[dict]) -> str:
        """Llama-3-style header framing when the specials exist, else the
        generic framing the byte tokenizer uses."""
        if "<|start_header_id|>" in self.special:
            parts = ["<|begin_of_text|>"]
            for m in messages:
                parts.append(
                    f"<|start_header_id|>{m.get('role', 'user')}"
                    f"<|end_header_id|>\n\n{m.get('content', '')}"
                    "<|eot_id|>")
            parts.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
            return "".join(parts)
        out = []
        for m in messages:
            out.append(f"<|{m.get('role', 'user')}|>\n"
                       f"{m.get('content', '')}\n")
        out.append("<|assistant|>\n")
        return "".join(out)


def is_byte_level_spec(path: str) -> bool:
    """True when a ``tokenizer.json`` is a BYTE-LEVEL BPE this module
    can encode exactly (GPT-2/Llama-3 family). Sentencepiece-style BPE
    (Llama-2/Mistral/Gemma: byte_fallback + \\u2581 word-boundary vocab
    + normalizer) uses different segmentation rules — those must go
    through transformers, not this encoder."""
    try:
        with open(path) as f:
            spec = json.load(f)
    except (OSError, ValueError):
        return False
    model = spec.get("model", {})
    if model.get("type") != "BPE" or model.get("byte_fallback"):
        return False
    pre = spec.get("pre_tokenizer") or {}
    chain = pre.get("pretokenizers", [pre]) if pre else []
    if any(p.get("type") == "ByteLevel" for p in chain):
        return True
    # Llama-3 style: Split regex + byte-level vocab ('Ġ' = the
    # GPT-2 stand-in for space appears in token strings)
    vocab = model.get("vocab", {})
    return any("Ġ" in t for i, t in zip(range(4096), vocab))


def load(path: str) -> BPETokenizer:
    """Load from a ``tokenizer.json`` file or a directory holding one."""
    if os.path.isdir(path):
        path = os.path.join(path, "tokenizer.json")
    with open(path) as f:
        spec = json.load(f)
    model = spec.get("model", {})
    if model.get("type") != "BPE":
        raise ValueError(f"unsupported tokenizer model {model.get('type')}")
    vocab = dict(model.get("vocab", {}))
    merges_raw = model.get("merges", [])
    merges: List[Tuple[str, str]] = []
    for m in merges_raw:
        if isinstance(m, str):
            a, _, b = m.partition(" ")
            merges.append((a, b))
        else:
            merges.append((m[0], m[1]))
    special = {t["content"]: int(t["id"])
               for t in spec.get("added_tokens", [])}
    pattern = None
    pre = spec.get("pre_tokenizer") or {}
    seq = pre.get("pretokenizers", [pre]) if pre else []
    for p in seq:
        if p.get("type") == "Split":            # Llama-3 style
            pat = p.get("pattern", {})
            pattern = pat.get("Regex") or pat.get("String")
            break
        if p.get("type") == "ByteLevel" and p.get("use_regex", True):
            pattern = _GPT2_PAT                 # GPT-2 built-in split
            break
    bos = eos = None
    cfg_path = os.path.join(os.path.dirname(path), "tokenizer_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            tc = json.load(f)

        def _tok(v):
            return v.get("content") if isinstance(v, dict) else v
        bos, eos = _tok(tc.get("bos_token")), _tok(tc.get("eos_token"))
    if bos is None:
        bos = next((t for t in special if "begin_of_text" in t
                    or t in ("<s>", "<bos>")), None)
    if eos is None:
        eos = next((t for t in special if "end_of_text" in t or "eot" in t
                    or t in ("</s>", "<eos>")), None)
    return BPETokenizer(vocab, merges, special, pattern, bos, eos,
                        ignore_merges=bool(model.get("ignore_merges")))
