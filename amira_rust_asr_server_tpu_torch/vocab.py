"""Vocabulary loading and BPE detokenization.

The port's own copy of the JAX package's ``vocab.py``. Callers only use its
methods, so either package's ``Vocabulary`` serves the port.

Behavioral parity with the reference's ``Vocabulary``
(ref: src/asr/types.rs:76-155): the file format is ``<token> <id>`` per line
(token may contain spaces; the id is the last whitespace-separated field),
and decoding joins tokens while turning the sentencepiece ``▁`` marker into
a space, trimming a leading space.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

_BPE_SPACE = "▁"  # '▁'


class Vocabulary:
    """Token-id to string mapping with BPE-aware detokenization."""

    def __init__(self, id_to_token: Dict[int, str]):
        self._id_to_token = dict(id_to_token)
        # Reverse map for biasing / lexicon features (first id wins on dup).
        self._token_to_id: Dict[str, int] = {}
        for i, t in self._id_to_token.items():
            self._token_to_id.setdefault(t, i)

    # -- construction -------------------------------------------------------
    @classmethod
    def load(cls, path: str | os.PathLike) -> "Vocabulary":
        """Load from a vocab.txt file (ref: types.rs:87-108).

        Lines with fewer than 2 whitespace fields or a non-integer final
        field are skipped, matching the reference's permissive parser.
        """
        id_to_token: Dict[int, str] = {}
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    try:
                        tok_id = int(parts[-1])
                    except ValueError:
                        continue
                    id_to_token[tok_id] = " ".join(parts[:-1])
        return cls(id_to_token)

    @classmethod
    def from_map(cls, id_to_token: Dict[int, str]) -> "Vocabulary":
        return cls(id_to_token)

    # -- decoding -----------------------------------------------------------
    def decode_tokens(self, token_ids: Iterable[int]) -> str:
        """Decode ids to text (ref: types.rs:111-134).

        Unknown ids are silently skipped; '▁'-prefixed tokens contribute a
        leading space; the result is stripped.
        """
        out: List[str] = []
        for tok_id in token_ids:
            tok = self._id_to_token.get(int(tok_id))
            if tok is None:
                continue
            if tok.startswith(_BPE_SPACE):
                out.append(" " + tok[len(_BPE_SPACE):])
            else:
                out.append(tok)
        return "".join(out).strip()

    # -- encoding -----------------------------------------------------------
    def encode_text(self, text: str) -> List[int]:
        """Text -> token ids by greedy longest-match over the vocabulary
        (sentencepiece-style: words get a '▁' prefix). The reference never
        encodes (inference-only); this supports the training path. Unknown
        spans fall back to the <unk>/0 id per character.
        """
        if not self._token_to_id:
            return []
        max_len = max(len(t) for t in self._token_to_id)
        pieces: List[int] = []
        words = text.strip().split()
        for word in words:
            s = _BPE_SPACE + word
            i = 0
            while i < len(s):
                matched = False
                for ln in range(min(max_len, len(s) - i), 0, -1):
                    tok_id = self._token_to_id.get(s[i:i + ln])
                    if tok_id is not None:
                        pieces.append(tok_id)
                        i += ln
                        matched = True
                        break
                if not matched:
                    pieces.append(0)  # <unk>
                    i += 1
        return pieces

    def decode_words(self, token_details) -> List[dict]:
        """Group per-token details into word-level entries.

        Takes a list of TokenInfo-like objects ({id, time_s, confidence});
        returns [{"word", "start_s", "end_s", "confidence"}] where a word
        starts at each '▁'-prefixed piece and confidence is the minimum of
        its pieces (the weakest-link convention).
        """
        words: List[dict] = []
        cur = None
        for d in token_details:
            tok = self._id_to_token.get(int(d.id))
            if tok is None:
                continue
            starts_word = tok.startswith(_BPE_SPACE)
            text = tok[len(_BPE_SPACE):] if starts_word else tok
            if starts_word or cur is None:
                if cur is not None and cur["word"]:
                    words.append(cur)
                cur = {"word": text, "start_s": d.time_s, "end_s": d.time_s,
                       "confidence": d.confidence}
            else:
                cur["word"] += text
                cur["end_s"] = d.time_s
                cur["confidence"] = min(cur["confidence"], d.confidence)
        if cur is not None and cur["word"]:
            words.append(cur)
        return words

    # -- lookups ------------------------------------------------------------
    def get_token(self, tok_id: int) -> Optional[str]:
        return self._id_to_token.get(int(tok_id))

    def get_id(self, token: str) -> Optional[int]:
        return self._token_to_id.get(token)

    def __len__(self) -> int:
        return len(self._id_to_token)

    def __bool__(self) -> bool:  # is_empty analogue
        return bool(self._id_to_token)

    @property
    def max_id(self) -> int:
        return max(self._id_to_token) if self._id_to_token else -1
