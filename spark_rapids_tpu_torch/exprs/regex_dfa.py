"""LIKE and RLIKE patterns compiled to a DFA over bytes, for the
``rect_dfa`` kernel (exec/rect_dfa.py).

A pattern becomes a Thompson NFA, then a DFA by subset construction, then
the smallest DFA by partition refinement. Bytes that every transition
treats alike share a class, so the table is states x classes. Semantics
(Spark 3.5 over ASCII input, where a byte is a character):

  * RLIKE is Java's ``Matcher.find()``: the pattern may match anywhere.
    ``.`` excludes ``\\n`` and ``\\r`` (all of a byte under a leading
    ``(?s)``); ``^`` and ``\\A`` match at the start only; ``$`` and
    ``\\Z`` at the end or before one final ``\\n``, ``\\r`` or ``\\r\\n``
    (not between the ``\\r`` and ``\\n`` of a final ``\\r\\n``), ``\\z``
    at the end; ``\\d``, ``\\w``, ``\\s`` and ``\\b`` are ASCII;
    ``(?i)`` folds ASCII letters.
  * LIKE is a whole-string match compiled with ``(?s)``: ``_`` is any
    byte, ``%`` any run of bytes, ``\\n`` included; the escape character
    makes the next character literal.

Refused, with ``NotImplementedError`` naming the slice that brings them:
backreferences, lookaround, possessive quantifiers, atomic groups (they
change which strings match, or are not regular), a ``$``, ``\\Z`` or
``\\z`` followed by anything but the end of the pattern, the flags other
than ``i`` and a leading ``s``, and an automaton past ``MAX_STATES``
states (``(a|b)*a(a|b){20}`` needs 2^21) or a table past
``MAX_TABLE_BYTES``.

The automaton (``Dfa``) is built once per expression on the host; the
kernel walks each row through it. A state whose every transition leads
back to itself is a sink: the answer is known there, so the walk stops.
Sinks are numbered last (``first_sink``), so that test is a compare.
``\\b`` is handled by carrying, with each NFA state of a subset, what the
next byte must be (a word byte or not; the end counts as not), decided
when the byte arrives.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .regex_transpiler import (POSIX_CLASSES, RegexUnsupported,
                               transpile_java_regex)

__all__ = ["Dfa", "MAX_STATES", "MAX_TABLE_BYTES", "compile_rlike",
           "compile_like", "dfa_match"]

#: states of a DFA the kernel takes: a state fits a byte
MAX_STATES = 256
#: bytes of the transition table (states x classes) in a block's shared
#: memory, under the 48 KB a block may take without opting in
MAX_TABLE_BYTES = 32768
#: subsets the construction may visit before minimising
_BUILD_STATES = 4096
#: NFA states a pattern may expand to (bounded repeats copy their body)
_MAX_NFA = 20000
#: a bounded repeat's count past which the pattern is refused
_MAX_REPEAT = 1000

_ALL = (1 << 256) - 1


def _bits(chars) -> int:
    m = 0
    for c in chars:
        m |= 1 << c
    return m


def _range(lo: int, hi: int) -> int:
    return ((1 << (hi + 1)) - 1) ^ ((1 << lo) - 1) if lo <= hi else 0


_DIGIT = _range(48, 57)
_WORD = _DIGIT | _range(65, 90) | _range(97, 122) | _bits([95])
_SPACE = _bits(b" \t\n\x0b\f\r")
_DOT = _ALL & ~_bits(b"\n\r")
_UPPER = _range(65, 90)
_LOWER = _range(97, 122)


def _fold(m: int) -> int:
    """The set with every ASCII letter's other case added."""
    return m | ((m & _UPPER) << 32) | ((m & _LOWER) >> 32)


def _refuse(pattern: str, why: str):
    from .collection_fns import STRINGS_REST
    raise NotImplementedError(
        f"the pattern {pattern!r} {why}: it arrives with {STRINGS_REST}")


# ---------------------------------------------------------------------------
# Java regex -> syntax tree
#   ("set", mask) ("cat", [n]) ("alt", [n]) ("rep", n, lo, hi or None)
#   ("bol",) ("wb", negated) ("dollar",) ("eoi",)
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.ci = False
        self.dotall = False
        if pattern.startswith("(?") and ")" in pattern:
            head = pattern[2:pattern.index(")")]
            if head and set(head) <= set("is"):
                self.ci = "i" in head
                self.dotall = "s" in head
                self.i = len(head) + 3

    def fail(self, why: str):
        _refuse(self.p, why)

    def peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""

    def take(self) -> str:
        c = self.peek()
        self.i += 1
        return c

    def parse(self):
        node = self.alt()
        if self.i < len(self.p):
            self.fail("has an unbalanced )")
        return node

    def alt(self):
        branches = [self.cat()]
        while self.peek() == "|":
            self.take()
            branches.append(self.cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def cat(self):
        items = []
        while self.i < len(self.p) and self.peek() not in "|)":
            atom = self.atom()
            if atom is not None:
                items.append(self.quantified(atom))
        return ("cat", items)

    def lit(self, code: int):
        m = (1 << code) if code < 256 else 0
        return ("set", _fold(m) if self.ci else m)

    def quantified(self, atom):
        while True:
            c = self.peek()
            if c == "*":
                lo, hi = 0, None
            elif c == "+":
                lo, hi = 1, None
            elif c == "?":
                lo, hi = 0, 1
            elif c == "{":
                lo, hi = self.braces()
            else:
                return atom
            if c != "{":
                self.take()
            if self.peek() == "+":
                self.fail("has a possessive quantifier")
            if self.peek() == "?":
                self.take()         # lazy: the same strings match
            atom = ("rep", atom, lo, hi)

    def braces(self):
        import re
        m = re.match(r"\{(\d+)(,(\d*))?\}", self.p[self.i:])
        if m is None:
            self.fail("has a { that is not a repeat count")
        self.i += m.end()
        lo = int(m.group(1))
        hi = lo if m.group(2) is None else (
            int(m.group(3)) if m.group(3) else None)
        if lo > _MAX_REPEAT or (hi is not None and (hi > _MAX_REPEAT
                                                    or hi < lo)):
            self.fail(f"repeats past {_MAX_REPEAT} times or backwards")
        return lo, hi

    def end_anchor(self, node):
        if self.i != len(self.p):
            self.fail("has an end anchor that is not at the end of the "
                      "pattern")
        return node

    def atom(self):
        c = self.take()
        if c == "(":
            return self.group()
        if c == "[":
            return ("set", self.klass())
        if c == ".":
            return ("set", _ALL if self.dotall else _DOT)
        if c == "^":
            return ("bol",)
        if c == "$":
            return self.end_anchor(("dollar",))
        if c == "\\":
            return self.escape()
        if c in "*+?":
            self.fail(f"has a dangling {c}")
        return self.lit(ord(c))

    def group(self):
        saved = (self.ci, self.dotall)
        if self.peek() == "?":
            self.take()
            c = self.take()
            if c in "=!" or (c == "<" and self.peek() in "=!"):
                self.fail("has a lookaround")
            if c == ">":
                self.fail("has an atomic group")
            if c == "<":
                while self.peek() not in (">", ""):
                    self.take()
                self.take()
            elif c != ":":
                self.i -= 1
                on = True
                while self.peek() not in (":", ")", ""):
                    f = self.take()
                    if f == "-":
                        on = False
                    elif f == "i":
                        self.ci = on
                    else:
                        self.fail(f"has the flag ({f})")
                if self.take() == ")":
                    return None      # the flags hold to the group's end
        node = self.alt()
        if self.take() != ")":
            self.fail("has an unbalanced (")
        self.ci, self.dotall = saved
        return node

    def code(self) -> int:
        """The code point of an escape that names one character, the
        backslash and its letter taken; -1 when it names none."""
        import re
        c = self.p[self.i - 1]
        simple = {"t": 9, "n": 10, "r": 13, "f": 12, "a": 7, "e": 27}
        if c in simple:
            return simple[c]
        if c == "x":
            m = re.match(r"\{([0-9a-fA-F]+)\}|([0-9a-fA-F]{2})",
                         self.p[self.i:])
            if m is None:
                self.fail("has a malformed \\x escape")
            self.i += m.end()
            return int(m.group(1) or m.group(2), 16)
        if c == "u":
            m = re.match(r"[0-9a-fA-F]{4}", self.p[self.i:])
            if m is None:
                self.fail("has a malformed \\u escape")
            self.i += 4
            return int(m.group(0), 16)
        if c == "0":
            m = re.match(r"[0-7]{1,3}", self.p[self.i:])
            if m is None:
                self.fail("has a malformed octal escape")
            self.i += m.end()
            return int(m.group(0), 8)
        if c == "c":
            return ord(self.take()) ^ 64
        return -1

    def class_escape(self) -> int:
        """The set of an escape inside or outside a class (a class
        escape, a named class or one character)."""
        c = self.take()
        if not c:
            self.fail("ends in a backslash")
        sets = {"d": _DIGIT, "w": _WORD, "s": _SPACE}
        if c in sets:
            return sets[c]
        if c.lower() in sets:
            return _ALL & ~sets[c.lower()]
        if c in "pP":
            import re
            m = re.match(r"\{(\w+)\}", self.p[self.i:])
            if m is None or m.group(1) not in POSIX_CLASSES:
                self.fail("has a Unicode property class")
            self.i += m.end()
            body = self._posix(POSIX_CLASSES[m.group(1)])
            body = _fold(body) if self.ci else body
            return body if c == "p" else _ALL & ~body
        code = self.code()
        if code >= 0:
            m = (1 << code) if code < 256 else 0
            return _fold(m) if self.ci else m
        if c.isalnum():
            self.fail(f"has the escape \\{c}")
        m = 1 << ord(c) if ord(c) < 256 else 0
        return _fold(m) if self.ci else m

    @staticmethod
    def _posix(body: str) -> int:
        sub = _Parser("[" + body + "]")
        sub.take()
        return sub.klass()

    def escape(self):
        c = self.peek()
        if not c:
            self.fail("ends in a backslash")
        if c in "123456789" or c == "k":
            self.fail("has a backreference")
        if c in "bB":
            self.take()
            return ("wb", c == "B")
        if c == "A":
            self.take()
            return ("bol",)
        if c in "Zz":
            self.take()
            return self.end_anchor(("dollar",) if c == "Z" else ("eoi",))
        if c == "R":
            self.take()
            return ("alt", [("cat", [("set", _bits([13])),
                                     ("set", _bits([10]))]),
                            ("set", _bits(b"\n\x0b\f\r\x85"))])
        if c in "GXhHvV":
            self.fail(f"has the escape \\{c}")
        return ("set", self.class_escape())

    def klass(self) -> int:
        """A class's set, its ``[`` taken: ranges, escapes, nested classes
        (a union), a leading ``^``; folded under ``(?i)``."""
        neg = self.peek() == "^"
        if neg:
            self.take()
        m = 0
        first = True
        while True:
            c = self.take()
            if c == "":
                self.fail("has an unterminated class")
            if c == "]" and not first:
                break
            first = False
            if c == "[":
                m |= self.klass()
                continue
            if c == "&" and self.peek() == "&":
                self.fail("has a class intersection")
            if c == "\\":
                lo_set = self.class_escape()
                lo = lo_set.bit_length() - 1 \
                    if lo_set and lo_set & (lo_set - 1) == 0 else None
            else:
                lo_set, lo = (1 << ord(c)) if ord(c) < 256 else 0, ord(c)
            if self.peek() == "-" and self.p[self.i + 1:self.i + 2] \
                    not in ("]", "") and lo is not None:
                self.take()
                h = self.take()
                if h == "\\":
                    hs = self.class_escape()
                    if not hs or hs & (hs - 1):
                        self.fail("has a class range ending in a class")
                    hi = hs.bit_length() - 1
                else:
                    hi = ord(h)
                if hi < lo:
                    self.fail("has a backwards class range")
                lo_set = _range(lo, min(hi, 255))
            m |= lo_set
        if self.ci:
            m = _fold(m)
        return (_ALL & ~m) if neg else m


def _like_tree(pattern: str, escape: str):
    """LIKE as a tree: ``%`` any run, ``_`` any byte, the escape making
    the next character literal (a trailing escape is itself)."""
    items = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape and i + 1 < len(pattern):
            c = pattern[i + 1]
            i += 1
        elif c == "%":
            items.append(("rep", ("set", _ALL), 0, None))
            i += 1
            continue
        elif c == "_":
            items.append(("set", _ALL))
            i += 1
            continue
        items.append(("set", (1 << ord(c)) if ord(c) < 256 else 0))
        i += 1
    return ("cat", items)


# ---------------------------------------------------------------------------
# tree -> Thompson NFA
# ---------------------------------------------------------------------------

#: assertion kinds on NFA edges
_BOL, _NOT_AFTER_CR, _WB, _NWB = range(4)
#: what the next byte must be (carried with an NFA state in a subset)
_ANY, _NEXT_WORD, _NEXT_NONWORD = range(3)


class _Nfa:
    def __init__(self, pattern: str):
        self.pattern = pattern
        self.eps: List[List[int]] = []
        self.trans: List[List[Tuple[int, int]]] = []
        self.asserts: List[List[Tuple[int, int]]] = []
        #: states that accept when the input ends there ($, \z)
        self.at_end: set = set()

    def new(self) -> int:
        if len(self.eps) >= _MAX_NFA:
            _refuse(self.pattern, f"expands past {_MAX_NFA} NFA states")
        self.eps.append([])
        self.trans.append([])
        self.asserts.append([])
        return len(self.eps) - 1

    def build(self, node) -> Tuple[int, int]:
        kind = node[0]
        s, e = self.new(), self.new()
        if kind == "set":
            if node[1]:
                self.trans[s].append((node[1], e))
        elif kind == "cat":
            cur = s
            for item in node[1]:
                a, b = self.build(item)
                self.eps[cur].append(a)
                cur = b
            self.eps[cur].append(e)
        elif kind == "alt":
            for item in node[1]:
                a, b = self.build(item)
                self.eps[s].append(a)
                self.eps[b].append(e)
        elif kind == "rep":
            _, body, lo, hi = node
            cur = s
            for _ in range(lo):
                a, b = self.build(body)
                self.eps[cur].append(a)
                cur = b
            if hi is None:
                a, b = self.build(body)
                self.eps[cur].extend([a, e])
                self.eps[b].extend([a, e])
            else:
                for _ in range(hi - lo):
                    a, b = self.build(body)
                    self.eps[cur].extend([a, e])
                    cur = b
                self.eps[cur].append(e)
        elif kind == "bol":
            self.asserts[s].append((_BOL, e))
        elif kind == "wb":
            self.asserts[s].append((_NWB if node[1] else _WB, e))
        else:
            # an end anchor ends the pattern: its states accept at the end
            # of the input and lead nowhere else (``e`` stays unreachable)
            self.at_end.add(s)
            if kind == "dollar":
                cr, crlf, lf = self.new(), self.new(), self.new()
                self.trans[s].append((_bits([13]), cr))
                self.trans[cr].append((_bits([10]), crlf))
                self.asserts[s].append((_NOT_AFTER_CR, lf))
                self.trans[lf].append((_bits([10]), crlf))
                self.at_end.update((cr, crlf))
        return s, e


# ---------------------------------------------------------------------------
# NFA -> DFA -> minimal DFA
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Dfa:
    """A DFA over bytes as the kernel takes it: ``classes`` uint8[256]
    (each byte's class), ``table`` uint8[states, classes] (the next state),
    ``accept`` uint8[states] (1 where a string ending there matches),
    ``start``, and ``first_sink``: the states from it on are sinks (every
    transition leads back), where the walk may stop."""
    start: int
    classes: np.ndarray
    table: np.ndarray
    accept: np.ndarray
    first_sink: int
    #: device -> the three tables there (exec/rect_dfa.py)
    device_tables: dict = field(default_factory=dict, compare=False,
                                repr=False)

    @property
    def n_states(self) -> int:
        return int(self.table.shape[0])

    @property
    def n_classes(self) -> int:
        return int(self.table.shape[1])


_ACCEPTED = "accepted"


def _byte_classes(nfa: _Nfa) -> np.ndarray:
    """Each byte's class: bytes in the same transition sets, and alike as
    word bytes and as ``\\r`` (what the assertions look at), share one."""
    masks = {m for edges in nfa.trans for m, _ in edges}
    masks.update((_WORD, 1 << 13))
    sig: Dict[tuple, int] = {}
    out = np.zeros(256, np.int64)
    ordered = sorted(masks)
    for b in range(256):
        key = tuple((m >> b) & 1 for m in ordered)
        out[b] = sig.setdefault(key, len(sig))
    return out


def _subsets(nfa: _Nfa, start: int, accept: int, find: bool, reps):
    """Subset construction over the classes' representative bytes:
    (subsets, table as lists, accept-at-end per subset)."""
    def closure(seeds, at_start, prev_word, prev_cr):
        out = set()
        stack = list(seeds)
        while stack:
            item = stack.pop()
            if item in out:
                continue
            out.add(item)
            s, r = item
            stack.extend((t, r) for t in nfa.eps[s])
            for kind, t in nfa.asserts[s]:
                if kind == _BOL:
                    if at_start:
                        stack.append((t, r))
                elif kind == _NOT_AFTER_CR:
                    if not prev_cr:
                        stack.append((t, r))
                else:
                    word_next = prev_word == (kind == _NWB)
                    need = _NEXT_WORD if word_next else _NEXT_NONWORD
                    if r in (_ANY, need):
                        stack.append((t, need))
        if find and (accept, _ANY) in out:
            return _ACCEPTED
        return frozenset(out)

    def step(items, b):
        if items is _ACCEPTED:
            return _ACCEPTED
        word = bool((_WORD >> b) & 1)
        seeds = []
        for s, r in items:
            if r != _ANY and (r == _NEXT_WORD) != word:
                continue
            if find and s == accept:
                return _ACCEPTED
            seeds.extend(t for m, t in nfa.trans[s] if (m >> b) & 1)
        seeds = [(t, _ANY) for t in seeds]
        if find:
            seeds.append((start, _ANY))
        return closure(seeds, False, word, b == 13)

    def accepts(items) -> bool:
        if items is _ACCEPTED:
            return True
        return any((s == accept or s in nfa.at_end) and r != _NEXT_WORD
                   for s, r in items)

    first = closure([(start, _ANY)], True, False, False)
    index = {first: 0}
    subsets = [first]
    table = []
    i = 0
    while i < len(subsets):
        row = []
        for b in reps:
            nxt = step(subsets[i], b)
            j = index.get(nxt)
            if j is None:
                if len(subsets) >= _BUILD_STATES:
                    _refuse(nfa.pattern, f"needs a DFA of more than "
                            f"{_BUILD_STATES} states before minimising")
                j = index[nxt] = len(subsets)
                subsets.append(nxt)
            row.append(j)
        table.append(row)
        i += 1
    return table, [accepts(s) for s in subsets]


def _minimise(table, accept):
    """Moore's partition refinement: (block of each state, blocks)."""
    block = [int(a) for a in accept]
    n_blocks = len(set(block))
    while True:
        keys: Dict[tuple, int] = {}
        new = [keys.setdefault((block[s],) + tuple(block[t] for t in row),
                               len(keys))
               for s, row in enumerate(table)]
        if len(keys) == n_blocks:
            return new, len(keys)
        block, n_blocks = new, len(keys)


def _to_dfa(nfa: _Nfa, start: int, accept: int, find: bool) -> Dfa:
    cls = _byte_classes(nfa)
    n_cls = int(cls.max()) + 1
    reps = [int(np.flatnonzero(cls == c)[0]) for c in range(n_cls)]
    table, acc = _subsets(nfa, start, accept, find, reps)
    block, n = _minimise(table, acc)
    small = [[0] * n_cls for _ in range(n)]
    small_acc = [0] * n
    for s, row in enumerate(table):
        small[block[s]] = [block[t] for t in row]
        small_acc[block[s]] = int(acc[s])
    sink = [all(t == s for t in row) for s, row in enumerate(small)]
    order = sorted(range(n), key=lambda s: (sink[s], s))
    new_id = {s: i for i, s in enumerate(order)}
    if n > MAX_STATES or n * n_cls > MAX_TABLE_BYTES:
        _refuse(nfa.pattern, f"needs a DFA of {n} states and {n_cls} byte "
                f"classes; the kernel takes {MAX_STATES} states and a "
                f"{MAX_TABLE_BYTES}-byte table")
    out = np.zeros((n, n_cls), np.uint8)
    for s in range(n):
        out[new_id[s]] = [new_id[t] for t in small[s]]
    return Dfa(start=new_id[block[0]], classes=cls.astype(np.uint8),
               table=out,
               accept=np.array([small_acc[s] for s in order], np.uint8),
               first_sink=sum(not x for x in sink))


def _compile(tree, pattern: str, find: bool) -> Dfa:
    nfa = _Nfa(pattern)
    start, accept = nfa.build(tree)
    return _to_dfa(nfa, start, accept, find)


def compile_rlike(pattern: str) -> Dfa:
    """RLIKE's DFA (Java's ``find``); ``NotImplementedError`` for a
    pattern it cannot take (module doc)."""
    try:
        transpile_java_regex(pattern)
    except RegexUnsupported as e:
        _refuse(pattern, f"is not one the port matches ({e})")
    return _compile(_Parser(pattern).parse(), pattern, True)


def compile_like(pattern: str, escape: str = "\\") -> Dfa:
    """LIKE's DFA (a whole-string match, ``_`` and ``%`` over any byte)."""
    return _compile(_like_tree(pattern, escape), pattern, False)


def dfa_match(dfa: Dfa, data: bytes) -> bool:
    """One string through the DFA on the host (the kernel's walk)."""
    s = dfa.start
    for b in data:
        if s >= dfa.first_sink:
            break
        s = int(dfa.table[s, dfa.classes[b]])
    return bool(dfa.accept[s])
