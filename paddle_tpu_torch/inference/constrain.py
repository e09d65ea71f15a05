"""Constrained decoding: grammar -> host-side token automaton -> [V] masks
(counterpart of paddle_tpu/inference/constrain.py; numpy and pure Python,
its own copy).

A constrained request decodes against a deterministic automaton over the
TOKEN vocabulary, compiled once per (grammar, vocab) pair:

1. the grammar, a regex string or a JSON-schema dict (compiled to a regex by
   :func:`regex_from_schema`), is parsed into a Thompson NFA and
   determinised lazily over characters;
2. :class:`TokenConstraint` lifts the character DFA to token level by
   walking every vocab token's string from every reachable state, giving a
   dense ``[n_states, V]`` bool mask table and an int32 transition table
   (disallowed tokens route to a sink state that admits only ``eos``);
3. per request, a :class:`Cursor` tracks the automaton state on the host;
   the engine uploads ``masks[state]`` rows per slot per tick and advances
   the cursor with each emitted token.

Automaton contract (the reference's): ``eos`` is allowed exactly in
accepting states; a state from which no token can make progress also
admits ``eos``, so a wedged grammar ends the request instead of the slot;
after ``eos`` (or any disallowed token) the automaton sits in the sink.
``generate(token_mask_fn=)`` carries the state on the device through the
same two tables (:meth:`TokenConstraint.device_tables`), so engine and solo
runs mask identically.
"""
from __future__ import annotations

import json
import threading

import numpy as np

__all__ = ["compile_constraint", "regex_from_schema", "TokenConstraint", "Cursor"]

# The '.' / negated-class universe: printable ASCII.
_ALL_CHARS = frozenset(chr(c) for c in range(0x20, 0x7F))
_DIGITS = frozenset("0123456789")
_WORD = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(" \t\n\r")


# ------------------------------------------------------------------ NFA
class _Nfa:
    """Thompson construction: integer states, char-set edges, eps edges."""

    def __init__(self):
        self.edges = []  # state -> [(frozenset chars, target)]
        self.eps = []    # state -> [target]

    def state(self):
        self.edges.append([])
        self.eps.append([])
        return len(self.edges) - 1


class _RegexParser:
    """Recursive-descent parser for the grammar subset the schema
    compiler emits: literals, escapes (``\\d \\w \\s \\n \\t`` + escaped
    metachars), ``[...]`` classes with ranges and negation, ``.``,
    grouping, alternation, and ``* + ?``.  No counted repetition."""

    def __init__(self, pattern):
        self.p = pattern
        self.i = 0
        self.nfa = _Nfa()

    def parse(self):
        start, end = self._alt()
        if self.i != len(self.p):
            raise ValueError(
                f"regex: unexpected {self.p[self.i]!r} at {self.i}")
        return self.nfa, start, end

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def _alt(self):
        frags = [self._concat()]
        while self._peek() == "|":
            self.i += 1
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        s, e = self.nfa.state(), self.nfa.state()
        for fs, fe in frags:
            self.nfa.eps[s].append(fs)
            self.nfa.eps[fe].append(e)
        return s, e

    def _concat(self):
        frags = []
        while self._peek() not in (None, "|", ")"):
            frags.append(self._repeat())
        if not frags:
            s = self.nfa.state()
            e = self.nfa.state()
            self.nfa.eps[s].append(e)
            return s, e
        for (_, ae), (bs, _) in zip(frags, frags[1:]):
            self.nfa.eps[ae].append(bs)
        return frags[0][0], frags[-1][1]

    def _repeat(self):
        fs, fe = self._atom()
        while self._peek() in ("*", "+", "?"):
            op = self.p[self.i]
            self.i += 1
            if op == "*":
                s, e = self.nfa.state(), self.nfa.state()
                self.nfa.eps[s] += [fs, e]
                self.nfa.eps[fe] += [fs, e]
                fs, fe = s, e
            elif op == "+":
                e = self.nfa.state()
                self.nfa.eps[fe] += [fs, e]
                fe = e
            else:  # '?'
                s, e = self.nfa.state(), self.nfa.state()
                self.nfa.eps[s] += [fs, e]
                self.nfa.eps[fe].append(e)
                fs, fe = s, e
        return fs, fe

    def _char_frag(self, chars):
        s, e = self.nfa.state(), self.nfa.state()
        self.nfa.edges[s].append((frozenset(chars), e))
        return s, e

    def _escape_set(self, c):
        if c == "d":
            return _DIGITS
        if c == "w":
            return _WORD
        if c == "s":
            return _SPACE
        if c == "n":
            return frozenset("\n")
        if c == "t":
            return frozenset("\t")
        return frozenset(c)  # escaped metachar / literal

    def _atom(self):
        c = self._peek()
        if c is None:
            raise ValueError("regex: unexpected end of pattern")
        if c == "(":
            self.i += 1
            frag = self._alt()
            if self._peek() != ")":
                raise ValueError("regex: unbalanced '('")
            self.i += 1
            return frag
        if c == "[":
            return self._char_frag(self._char_class())
        if c == ".":
            self.i += 1
            return self._char_frag(_ALL_CHARS)
        if c == "\\":
            self.i += 1
            if self.i >= len(self.p):
                raise ValueError("regex: trailing backslash")
            s = self._escape_set(self.p[self.i])
            self.i += 1
            return self._char_frag(s)
        if c in "*+?)|":
            raise ValueError(f"regex: unexpected {c!r} at {self.i}")
        self.i += 1
        return self._char_frag(frozenset(c))

    def _char_class(self):
        assert self.p[self.i] == "["
        self.i += 1
        negate = self._peek() == "^"
        if negate:
            self.i += 1
        chars = set()
        while True:
            c = self._peek()
            if c is None:
                raise ValueError("regex: unbalanced '['")
            if c == "]":
                self.i += 1
                break
            if c == "\\":
                self.i += 1
                chars |= self._escape_set(self.p[self.i])
                self.i += 1
                continue
            # range a-z (a trailing '-' is a literal)
            if (self.i + 2 < len(self.p) and self.p[self.i + 1] == "-"
                    and self.p[self.i + 2] != "]"):
                lo, hi = c, self.p[self.i + 2]
                chars |= {chr(x) for x in range(ord(lo), ord(hi) + 1)}
                self.i += 3
                continue
            chars.add(c)
            self.i += 1
        return (_ALL_CHARS - chars) if negate else frozenset(chars)


class _CharDfa:
    """Lazy subset-construction over the NFA; states are frozensets of
    NFA states, memoised per (state, char)."""

    def __init__(self, nfa, start, accept):
        self.nfa = nfa
        self.accept_nfa = accept
        self.start = self._closure({start})
        self._memo = {}

    def _closure(self, states):
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in self.nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    def step(self, dstate, ch):
        """Next DFA state for one char, or None (dead)."""
        key = (dstate, ch)
        hit = self._memo.get(key, _MISS)
        if hit is not _MISS:
            return hit
        nxt = set()
        for s in dstate:
            for chars, t in self.nfa.edges[s]:
                if ch in chars:
                    nxt.add(t)
        out = self._closure(nxt) if nxt else None
        self._memo[key] = out
        return out

    def accepting(self, dstate):
        return self.accept_nfa in dstate


_MISS = object()


# ------------------------------------------------------ token automaton
class TokenConstraint:
    """A grammar lifted to the token vocabulary: dense per-state ``[V]``
    bool masks and int32 transitions, shared (immutable) across requests.

    ``vocab`` maps token id -> string; empty-string tokens are never
    allowed.  State ``n_states - 1`` is the sink: only ``eos`` survives
    there, and every transition out of it returns to it.
    """

    def __init__(self, dfa, vocab, eos_token_id):
        V = len(vocab)
        eos = int(eos_token_id)
        if not 0 <= eos < V:
            raise ValueError(f"eos_token_id {eos} outside vocab of {V} tokens")
        self.V = V
        self.eos_token_id = eos
        index = {dfa.start: 0}
        order = [dfa.start]
        masks, trans = [], []
        qi = 0
        while qi < len(order):
            dstate = order[qi]
            qi += 1
            mask = np.zeros(V, np.bool_)
            dests = [None] * V
            for tok in range(V):
                cur = dstate
                text = vocab[tok]
                if not text:
                    continue
                for ch in text:
                    cur = dfa.step(cur, ch)
                    if cur is None:
                        break
                if cur is None:
                    continue
                mask[tok] = True
                dests[tok] = cur
                if cur not in index:
                    index[cur] = len(order)
                    order.append(cur)
            if dfa.accepting(dstate):
                mask[eos] = True
            elif not mask.any():
                # dead end: the grammar cannot be completed from here —
                # admit eos so the request terminates instead of wedging
                mask[eos] = True
            masks.append(mask)
            trans.append(dests)
        self.n_states = len(order) + 1  # + sink
        sink = self.n_states - 1
        self.masks = np.zeros((self.n_states, V), np.bool_)
        self.trans = np.full((self.n_states, V), sink, np.int32)
        for i, (mask, dests) in enumerate(zip(masks, trans)):
            self.masks[i] = mask
            for tok, d in enumerate(dests):
                if d is not None:
                    self.trans[i, tok] = index[d]
        self.masks[sink, eos] = True  # the sink admits only eos
        self.start_state = 0
        self._dev = {}
        self._dev_lock = threading.Lock()

    def cursor(self):
        return Cursor(self)

    def device_tables(self, device):
        """``(masks, trans)`` as torch tensors on ``device`` (bool and
        int64), uploaded once per device; the tables are immutable, so a
        racing second upload is dropped."""
        import torch

        key = str(torch.device(device))
        with self._dev_lock:
            dev = self._dev.get(key)
        if dev is None:
            dev = (torch.from_numpy(self.masks).to(device),
                   torch.from_numpy(self.trans).to(device=device, dtype=torch.int64))
            with self._dev_lock:
                dev = self._dev.setdefault(key, dev)
        return dev


class Cursor:
    """Per-request automaton state (host side, engine-owned)."""

    __slots__ = ("tc", "state", "rejects")

    def __init__(self, tc):
        self.tc = tc
        self.state = tc.start_state
        self.rejects = 0

    def mask(self):
        """The current state's ``[V]`` bool mask (a shared row: copy before
        mutating)."""
        return self.tc.masks[self.state]

    def advance(self, tok):
        """Consume one emitted token; False (and one more reject) when the
        mask disallowed it: the state still moves, to the sink."""
        tok = int(tok)
        ok = bool(self.tc.masks[self.state, tok])
        self.state = int(self.tc.trans[self.state, tok])
        if not ok:
            self.rejects += 1
        return ok


# ------------------------------------------------------ schema -> regex
_RX_SPECIALS = set("\\.^$*+?()[]{}|")
_STRING_BODY = "[A-Za-z0-9_ .,:;!@#%&/='<>-]*"
_INTEGER = "-?(0|[1-9][0-9]*)"
_NUMBER = "-?(0|[1-9][0-9]*)(\\.[0-9]+)?"


def _rx_literal(text):
    return "".join("\\" + c if c in _RX_SPECIALS else c for c in text)


def regex_from_schema(schema):
    """A regex for the JSON serialisation of a practical schema subset:
    ``string`` / ``integer`` / ``number`` / ``boolean`` / ``null`` /
    ``enum`` / homogeneous ``array`` / ``object``.  Objects serialise
    with EVERY declared property, in declaration order, no whitespace —
    the canonical form the automaton accepts (the usual constrained-JSON
    simplification).  Strings admit a conservative printable charset
    without quotes/backslashes."""
    if "enum" in schema:
        opts = "|".join(_rx_literal(json.dumps(v, separators=(",", ":")))
                        for v in schema["enum"])
        return f"({opts})"
    t = schema.get("type")
    if t == "string":
        return '"' + _STRING_BODY + '"'
    if t == "integer":
        return _INTEGER
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = regex_from_schema(schema.get("items", {"type": "string"}))
        return f"\\[({item}(,{item})*)?\\]"
    if t == "object":
        props = schema.get("properties", {})
        parts = []
        for name, sub in props.items():
            parts.append(f'"{_rx_literal(name)}":{regex_from_schema(sub)}')
        return "\\{" + ",".join(parts) + "\\}"
    raise ValueError(f"unsupported schema: {schema!r}")


def compile_constraint(spec, vocab, eos_token_id):
    """Compile ``spec`` (regex string or JSON-schema dict) over ``vocab``
    (token id -> string) into a shared :class:`TokenConstraint`."""
    if isinstance(spec, dict):
        pattern = regex_from_schema(spec)
    elif isinstance(spec, str):
        pattern = spec
    else:
        raise TypeError(
            f"constraint spec must be a regex str or schema dict, "
            f"got {type(spec).__name__}")
    nfa, start, end = _RegexParser(pattern).parse()
    return TokenConstraint(_CharDfa(nfa, start, end), list(vocab),
                           eos_token_id)
