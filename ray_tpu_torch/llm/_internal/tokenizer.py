"""Byte-level tokenizer for the LLM stack.

A copy of ``ray_tpu/llm/_internal/tokenizer.py``'s ``ByteTokenizer``:
self-contained, every byte is an id offset past the special tokens.
"""

from __future__ import annotations

from typing import List


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
