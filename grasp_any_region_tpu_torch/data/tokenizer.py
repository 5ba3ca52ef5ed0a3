"""Tokenizer layer (`grasp_any_region_tpu/data/tokenizer.py`).

Real checkpoints ship a Llama-3 `tokenizer.json`; `GARTokenizer.from_file`
wraps it with the `tokenizers` library (imported only there) and appends
the GAR prompt vocabulary (<Prompt0..N-1>, <NO_Prompt> at ids 128256+).

Without a tokenizer file, the synthetic byte-level tokenizer keeps every
structural id of the Llama-3 layout: special tokens, role tokens
(assistant=78191, user=882, system=9125) and "\n\n"=271, so chat
templating, label masking and the prompt tokens run on real ids; only
ordinary text maps to private byte ids (1000 + byte).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ..core.config import (
    BASE_VOCAB_SIZE,
    BOT_TOKEN_ID,
    END_HEADER_ID,
    EOT_TOKEN_ID,
    IMAGE_TOKEN_ID,
    NEWLINE2_ID,
    START_HEADER_ID,
    VIDEO_TOKEN_ID,
    crop_token_ids,
)

# Llama-3 named specials (fixed layout)
SPECIAL_TOKENS: Dict[str, int] = {
    "<|begin_of_text|>": BOT_TOKEN_ID,
    "<|end_of_text|>": 128001,
    "<|image|>": IMAGE_TOKEN_ID,
    "<|video|>": VIDEO_TOKEN_ID,
    "<|start_header_id|>": START_HEADER_ID,
    "<|end_header_id|>": END_HEADER_ID,
    "<|eot_id|>": EOT_TOKEN_ID,
    # no <|eom_id|> / <|python_tag|>: in the Llama-3.0 layout 128008 and
    # 128010 are reserved_4 / reserved_5, which serve as crop tokens
}


def reserved_special_token(pid: int, prompt_numbers: int = 5) -> str:
    """The crop token of prompt pid: <|reserved_special_token_{pid+2}|>."""
    return f"<|reserved_special_token_{pid + 2}|>"


# word-level ids that the label masker depends on (Llama-3 vocab)
ROLE_TOKEN_IDS = {"assistant": 78191, "user": 882, "system": 9125}
_BYTE_BASE = 1000  # synthetic fallback: byte b -> _BYTE_BASE + b


class GARTokenizer:
    """Unified tokenizer facade (real `tokenizers` backend or synthetic)."""

    def __init__(self, backend=None, prompt_numbers: int = 5):
        self.backend = backend
        self.prompt_numbers = prompt_numbers
        self.specials: Dict[str, int] = dict(SPECIAL_TOKENS)
        # all reserved specials (benchmark questions may reference prompts
        # beyond the model's slot count; their crop tokens must stay single
        # tokens even though they never replay)
        for pid, tid in enumerate(crop_token_ids(max(prompt_numbers, 16))):
            self.specials[reserved_special_token(pid)] = tid
        for i in range(prompt_numbers):
            self.specials[f"<Prompt{i}>"] = BASE_VOCAB_SIZE + i
        self.specials["<NO_Prompt>"] = BASE_VOCAB_SIZE + prompt_numbers
        self._id_to_special = {v: k for k, v in self.specials.items()}

        if backend is not None:
            # register GAR prompt tokens on the real tokenizer
            try:
                from tokenizers import AddedToken

                backend.add_special_tokens(
                    [
                        AddedToken(t, special=True)
                        for t in list(self.specials)[-(prompt_numbers + 1):]
                    ]
                )
            except Exception:
                pass

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_file(cls, path: str, prompt_numbers: int = 5) -> "GARTokenizer":
        from tokenizers import Tokenizer

        tok_path = path
        if os.path.isdir(path):
            tok_path = os.path.join(path, "tokenizer.json")
        return cls(Tokenizer.from_file(tok_path), prompt_numbers)

    @classmethod
    def synthetic(cls, prompt_numbers: int = 5) -> "GARTokenizer":
        return cls(None, prompt_numbers)

    # -- core API ------------------------------------------------------------
    @property
    def image_token(self) -> str:
        return "<|image|>"

    @property
    def image_token_id(self) -> int:
        return IMAGE_TOKEN_ID

    @property
    def eot_id(self) -> int:
        return EOT_TOKEN_ID

    def vocab_size(self) -> int:
        return BASE_VOCAB_SIZE + self.prompt_numbers + 1

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self.specials:
            return self.specials[token]
        if self.backend is not None:
            tid = self.backend.token_to_id(token)
            if tid is None:
                raise KeyError(token)
            return tid
        raise KeyError(f"synthetic tokenizer has no plain token {token!r}")

    def encode(self, text: str) -> List[int]:
        """Encode text, honoring embedded special tokens."""
        if self.backend is not None:
            return self.backend.encode(text, add_special_tokens=False).ids
        return self._encode_synthetic(text)

    def decode(self, ids: List[int], skip_special_tokens: bool = False) -> str:
        if self.backend is not None:
            return self.backend.decode(list(ids), skip_special_tokens=skip_special_tokens)
        out: List[str] = []
        buf: List[int] = []

        def flush():
            if buf:
                out.append(bytes(b - _BYTE_BASE for b in buf).decode("utf-8", "replace"))
                buf.clear()

        rev_roles = {v: k for k, v in ROLE_TOKEN_IDS.items()}
        for i in ids:
            i = int(i)
            if i in self._id_to_special:
                flush()
                if not skip_special_tokens:
                    out.append(self._id_to_special[i])
            elif i == NEWLINE2_ID:
                flush()
                out.append("\n\n")
            elif i in rev_roles:
                flush()
                out.append(rev_roles[i])
            elif _BYTE_BASE <= i < _BYTE_BASE + 256:
                buf.append(i)
            else:
                flush()
        flush()
        return "".join(out)

    # -- synthetic encoding ---------------------------------------------------
    def _encode_synthetic(self, text: str) -> List[int]:
        # split on special tokens (longest-first) + structural words
        import re

        names = sorted(self.specials, key=len, reverse=True)
        pattern = "(" + "|".join(re.escape(n) for n in names) + ")"
        ids: List[int] = []
        for part in re.split(pattern, text):
            if not part:
                continue
            if part in self.specials:
                ids.append(self.specials[part])
            else:
                ids.extend(self._encode_plain(part))
        return ids

    def _encode_plain(self, text: str) -> List[int]:
        ids: List[int] = []
        i = 0
        while i < len(text):
            matched = False
            if text.startswith("\n\n", i):
                ids.append(NEWLINE2_ID)
                i += 2
                matched = True
            else:
                for w, tid in ROLE_TOKEN_IDS.items():
                    if text.startswith(w, i):
                        ids.append(tid)
                        i += len(w)
                        matched = True
                        break
            if not matched:
                ids.extend(_BYTE_BASE + b for b in text[i].encode("utf-8"))
                i += 1
        return ids
