"""Byte-level tokenizer (reserved specials + 256 bytes).

Vocab-agnostic: token ids above 255+n_special simply never occur, so any
model vocab >= 260 can consume these streams.
"""
from __future__ import annotations

from typing import List

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
SEP_ID = 3
N_SPECIAL = 4


def encode(text: str, *, bos: bool = True, eos: bool = False) -> List[int]:
    ids = [b + N_SPECIAL for b in text.encode("utf-8")]
    if bos:
        ids = [BOS_ID] + ids
    if eos:
        ids = ids + [EOS_ID]
    return ids


def decode(ids) -> str:
    bs = bytes(int(i) - N_SPECIAL for i in ids
               if N_SPECIAL <= int(i) < N_SPECIAL + 256)
    return bs.decode("utf-8", errors="replace")


def vocab_size() -> int:
    return 256 + N_SPECIAL
