"""Tokenizer wrapper.

Copy of exllamav2_tpu/tokenizer.py: this package imports nothing of the JAX
package, whose __init__ imports JAX. The `tokenizers` and `sentencepiece`
backends are imported inside Tokenizer.__init__ only, so importing this
module needs neither.

Analog of exllamav2/tokenizer/ (ExLlamaV2Tokenizer over SentencePiece or HF
Tokenizers backends, tokenizer/tokenizer.py:25): loads tokenizer.json (HF
tokenizers) or tokenizer.model (SentencePiece) from the model directory,
resolves special tokens from tokenizer_config.json / added_tokens.json,
and exposes the derived structures the generator needs (piece lists for
token healing / filters).

A deterministic ByteTokenizer backs hermetic tests (the reference has no
equivalent — its tests require real model dirs).
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["Tokenizer", "ByteTokenizer", "load_tokenizer"]


class TokenizerBase:
    vocab_size: int
    bos_token_id: int | None = None
    eos_token_id: int | None = None
    pad_token_id: int | None = None
    newline_token_id: int | None = None

    def special_tokens(self) -> dict[str, int]:
        """Special-token string -> control id map (for encode splitting)."""
        return {}

    def _encode_raw(self, text: str) -> list[int]:
        """Backend encode of literal text (no special-token matching)."""
        raise NotImplementedError

    def encode(self, text: str, add_bos: bool = False,
               encode_special_tokens: bool = False) -> np.ndarray:
        """Encode text; with encode_special_tokens=True, embedded
        special-token strings ("<|im_start|>"-style chat markers) are
        split out and encoded as their control ids instead of as literal
        characters (reference tokenizer/tokenizer.py:385-600)."""
        specials = self.special_tokens() if encode_special_tokens else None
        if specials:
            import re
            pat = getattr(self, "_special_re", None)
            if pat is None:
                keys = sorted(specials, key=len, reverse=True)
                pat = re.compile("|".join(re.escape(k) for k in keys))
                self._special_re = pat
            ids: list[int] = []
            pos = 0
            for m in pat.finditer(text):
                if m.start() > pos:
                    ids += list(self._encode_raw(text[pos:m.start()]))
                ids.append(specials[m.group(0)])
                pos = m.end()
            if pos < len(text):
                ids += list(self._encode_raw(text[pos:]))
        else:
            ids = list(self._encode_raw(text))
        if add_bos and self.bos_token_id is not None:
            ids = [self.bos_token_id] + ids
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        raise NotImplementedError

    def id_to_piece(self, i: int) -> str:
        raise NotImplementedError

    def eos_set(self) -> set[int]:
        e = self.eos_token_id
        if e is None:
            return set()
        return set(e) if isinstance(e, (list, tuple)) else {e}

    def piece_to_id(self, piece: str) -> int | None:
        """Inverse of id_to_piece (None when absent)."""
        return self.get_piece_to_id_dict().get(piece)

    # ---- derived structures (reference tokenizer.py:635-801) ----
    # cached lazily; built once per tokenizer instance

    def get_id_to_piece_list(self) -> list[str]:
        lst = getattr(self, "_id_to_piece", None)
        if lst is None:
            lst = [self.id_to_piece(i) for i in range(self.vocab_size)]
            self._id_to_piece = lst
        return lst

    def get_piece_to_id_dict(self) -> dict[str, int]:
        d = getattr(self, "_piece_to_id", None)
        if d is None:
            d = {}
            for i, p in enumerate(self.get_id_to_piece_list()):
                d.setdefault(p, i)
            self._piece_to_id = d
        return d

    def _sorted_pieces(self):
        sp = getattr(self, "_sorted", None)
        if sp is None:
            pieces = self.get_id_to_piece_list()
            order = sorted(range(len(pieces)), key=lambda i: pieces[i])
            sp = ([pieces[i] for i in order],
                  np.asarray(order, np.int32))
            self._sorted = sp
        return sp

    def prefix_ids(self, prefix: str) -> np.ndarray:
        """Token ids whose piece starts with `prefix`, via binary search
        + forward scan over the sorted piece list — O(log V + matches)
        instead of the reference's prefix dict scan (tokenizer.py:703-734).
        (A sentinel upper bound like prefix+"\uffff" would miss pieces
        continuing with astral-plane codepoints.)"""
        import bisect
        pieces, order = self._sorted_pieces()
        lo = bisect.bisect_left(pieces, prefix)
        hi = lo
        n = len(pieces)
        while hi < n and pieces[hi].startswith(prefix):
            hi += 1
        return order[lo:hi]

    def get_id_to_decoded_list(self) -> list[str]:
        """Decoded text per token id (reference tokenizer.py extended
        piece list): raw vocab pieces carry encoding markers — "▁" for
        sentencepiece spaces, the GPT-2 byte-to-unicode alphabet for
        byte-level BPE — which character-level constraint engines must
        not see. Applies the inverse transform per piece."""
        lst = getattr(self, "_id_to_decoded", None)
        if lst is not None:
            return lst
        pieces = self.get_id_to_piece_list()
        sample = "".join(pieces[:256])
        if "Ġ" in sample or any("Ġ" in p or "Ċ" in p for p in pieces):
            # GPT-2 byte-level BPE: invert bytes_to_unicode
            bs = (list(range(ord("!"), ord("~") + 1))
                  + list(range(ord("¡"), ord("¬") + 1))
                  + list(range(ord("®"), ord("ÿ") + 1)))
            cs = bs[:]
            n = 0
            for b in range(256):
                if b not in bs:
                    bs.append(b)
                    cs.append(256 + n)
                    n += 1
            u2b = {chr(c): b for b, c in zip(bs, cs)}

            def conv(p):
                try:
                    return bytes(u2b[ch] for ch in p).decode(
                        "utf-8", errors="replace")
                except KeyError:
                    return p        # special token, not byte-encoded
            lst = [conv(p) for p in pieces]
        else:
            def conv(p):
                if p.startswith("<0x") and p.endswith(">") and len(p) == 6:
                    try:
                        return chr(int(p[3:5], 16))
                    except ValueError:
                        return p
                return p.replace("▁", " ")
            lst = [conv(p) for p in pieces]
        self._id_to_decoded = lst
        return lst

    def get_char_trie(self):
        """Root of a char trie over pieces (tokenizer.py:758-801 analog):
        node = (children dict, list of token ids ending here)."""
        trie = getattr(self, "_char_trie", None)
        if trie is None:
            trie = ({}, [])
            for i, p in enumerate(self.get_id_to_piece_list()):
                node = trie
                for ch in p:
                    node = node[0].setdefault(ch, ({}, []))
                node[1].append(i)
            self._char_trie = trie
        return trie


class ByteTokenizer(TokenizerBase):
    """256-way byte vocab + specials; hermetic test backend."""

    def __init__(self, vocab_size: int = 260):
        self.vocab_size = vocab_size
        self.bos_token_id = 256 if vocab_size > 256 else None
        self.eos_token_id = 257 if vocab_size > 257 else None
        self.pad_token_id = 258 if vocab_size > 258 else None
        self.newline_token_id = 10

    def special_tokens(self) -> dict[str, int]:
        d = {}
        if self.bos_token_id is not None:
            d["<s>"] = self.bos_token_id
        if self.eos_token_id is not None:
            d["</s>"] = self.eos_token_id
        return d

    def _encode_raw(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        bs = bytes(int(i) for i in np.asarray(ids).reshape(-1)
                   if 0 <= int(i) < 256)
        return bs.decode("utf-8", errors="replace")

    def id_to_piece(self, i: int) -> str:
        return chr(i) if i < 256 else f"<s{i}>"


class Tokenizer(TokenizerBase):
    """HF-tokenizers / SentencePiece backed tokenizer for real models."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        cfg = {}
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
        self._cfg = cfg

        tk_json = os.path.join(model_dir, "tokenizer.json")
        sp_model = os.path.join(model_dir, "tokenizer.model")
        if os.path.exists(tk_json):
            from tokenizers import Tokenizer as HFTokenizer
            self._hf = HFTokenizer.from_file(tk_json)
            self._sp = None
            self.vocab_size = self._hf.get_vocab_size()
            # default encode must be LITERAL (reference semantics:
            # special-token strings in prompts only become control ids
            # when encode_special_tokens=True); newer tokenizers expose
            # this directly, older ones keep the (matching) behavior
            try:
                self._hf.encode_special_tokens = True
            except Exception:
                pass
        elif os.path.exists(sp_model):
            import sentencepiece
            self._sp = sentencepiece.SentencePieceProcessor()
            self._sp.Load(sp_model)
            self._hf = None
            self.vocab_size = self._sp.vocab_size()
        else:
            raise FileNotFoundError(
                f"no tokenizer.json / tokenizer.model in {model_dir}")

        def _tok_id(name, default=None):
            t = cfg.get(name)
            if isinstance(t, dict):
                t = t.get("content")
            if t is None:
                return default
            return self._piece_id(t, default)

        self.bos_token_id = _tok_id("bos_token")
        self.eos_token_id = _tok_id("eos_token")
        self.pad_token_id = _tok_id("pad_token")
        gen_path = os.path.join(model_dir, "generation_config.json")
        if os.path.exists(gen_path):
            with open(gen_path) as f:
                g = json.load(f)
            if self.eos_token_id is None:
                self.eos_token_id = g.get("eos_token_id")
            if self.bos_token_id is None:
                self.bos_token_id = g.get("bos_token_id")
        nl = self.encode("\n")
        self.newline_token_id = int(nl[-1]) if len(nl) else None

    def _piece_id(self, piece: str, default=None):
        if self._hf is not None:
            i = self._hf.token_to_id(piece)
            return i if i is not None else default
        i = self._sp.piece_to_id(piece)
        return i if i >= 0 else default

    def special_tokens(self) -> dict[str, int]:
        d = getattr(self, "_specials", None)
        if d is not None:
            return d
        d = {}
        # tokenizer_config.json added_tokens_decoder {id: {content, special}}
        for sid, meta in (self._cfg.get("added_tokens_decoder")
                          or {}).items():
            if isinstance(meta, dict) and meta.get("special"):
                d[meta["content"]] = int(sid)
        at_path = os.path.join(self.model_dir, "added_tokens.json")
        if os.path.exists(at_path):
            with open(at_path) as f:
                for tok, sid in json.load(f).items():
                    d.setdefault(tok, int(sid))
        if self._hf is not None:
            try:
                for sid, tok in self._hf.get_added_tokens_decoder().items():
                    if getattr(tok, "special", False):
                        d.setdefault(tok.content, int(sid))
            except Exception:
                pass
        else:
            for i in range(self.vocab_size):
                if self._sp.IsControl(i):
                    d.setdefault(self._sp.IdToPiece(i), i)
        self._specials = d
        return d

    def _encode_raw(self, text: str) -> list[int]:
        if self._hf is not None:
            return list(self._hf.encode(text, add_special_tokens=False).ids)
        return list(self._sp.EncodeAsIds(text))

    def decode(self, ids) -> str:
        ids = [int(i) for i in np.asarray(ids).reshape(-1) if int(i) >= 0]
        if self._hf is not None:
            return self._hf.decode(ids, skip_special_tokens=False)
        return self._sp.DecodeIds(ids)

    def id_to_piece(self, i: int) -> str:
        if self._hf is not None:
            return self._hf.id_to_token(i) or ""
        return self._sp.IdToPiece(i)


def load_tokenizer(model_dir: str) -> TokenizerBase:
    try:
        return Tokenizer(model_dir)
    except FileNotFoundError:
        return ByteTokenizer()
