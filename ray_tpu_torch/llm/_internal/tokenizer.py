"""Tokenizers for the LLM stack.

A copy of ``ray_tpu/llm/_internal/tokenizer.py``: ``ByteTokenizer``
(self-contained, every byte is an id offset past the special tokens)
and ``load_tokenizer`` (a local HF ``tokenizer.json`` through the
native BPE of ``bpe.py``, other HF formats through transformers,
imported only then; the byte tokenizer without a source).
"""

from __future__ import annotations

from typing import List, Optional


class ByteTokenizer:
    """ids: 0=pad, 1=bos, 2=eos, 3..258 = bytes 0..255."""

    OFFSET = 3

    def __init__(self, vocab_size: int = 259):
        if vocab_size < self.OFFSET + 2:
            raise ValueError("byte tokenizer needs vocab >= 5")
        self.vocab_size = vocab_size
        # with a small vocab (debug models), fold bytes into the id range;
        # decode is then lossy, which random-weight models don't mind
        self.byte_range = min(256, vocab_size - self.OFFSET)
        self.pad_id, self.bos_id, self.eos_id = 0, 1, 2

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [b % self.byte_range + self.OFFSET
               for b in text.encode("utf-8")]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        data = bytes(i - self.OFFSET for i in ids
                     if self.OFFSET <= i < self.OFFSET + self.byte_range)
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: List[dict]) -> str:
        parts = []
        for m in messages:
            parts.append(f"<|{m.get('role', 'user')}|>\n"
                         f"{m.get('content', '')}\n")
        parts.append("<|assistant|>\n")
        return "".join(parts)


def load_tokenizer(source: Optional[str] = None, vocab_size: int = 259):
    """source: local path to a HF tokenizer dir (or tokenizer.json file),
    else byte-level. A ``tokenizer.json`` loads through the NATIVE BPE
    implementation (bpe.py — no transformers on the serving path);
    other HF formats fall back to transformers."""
    if source:
        import os
        tj = (source if source.endswith("tokenizer.json")
              else os.path.join(source, "tokenizer.json"))
        from . import bpe
        # Only byte-level BPE goes native — sentencepiece-style
        # tokenizer.json (Llama-2/Mistral: byte_fallback + ▁
        # vocab) would tokenize silently wrong here; transformers
        # handles those.
        if os.path.exists(tj) and bpe.is_byte_level_spec(tj):
            return bpe.load(tj)
        from transformers import AutoTokenizer
        # AutoTokenizer wants the DIRECTORY even when the caller handed
        # us a direct tokenizer.json path
        hf_source = (os.path.dirname(source) or "."
                     if source.endswith("tokenizer.json") else source)
        return AutoTokenizer.from_pretrained(
            hf_source, local_files_only=True)
    return ByteTokenizer(vocab_size)
