"""Java-regex front end (the port's copy of
``spark_rapids_tpu/exprs/regex_transpiler.py``: ``RegexParser``,
``transpile_java_regex`` and ``sql_like_to_regex``, for Python's ``re``).

Spark's RLIKE takes Java's regular expressions. The port matches them in
two places: over a dictionary column once per entry on the host, with
Python's ``re`` and this module's output; over an ASCII byte rectangle
with a DFA (exprs/regex_dfa.py) run by the ``rect_dfa`` kernel. A pattern
is parsed once, and one whose semantics Python's engine would change is
refused (``RegexUnsupported``): the planner names the slice that brings
it.

Java -> Python divergences handled:
  * \\d \\w \\s (and negations) are ASCII in Java, Unicode in Python ->
    rewritten to explicit ASCII classes
  * \\b / \\B are ASCII in Java -> scoped (?a:...) ASCII-flag groups
  * Java's ``.`` (no DOTALL) excludes every line terminator -> an explicit
    negated class
  * ``$`` and \\Z (the end, or before one final line terminator) -> an
    explicit lookahead over Java's terminators; Java's ``$`` does not
    match between the ``\\r`` and the ``\\n`` of a final ``\\r\\n``, so the
    lookahead keeps a lone ``\\n`` only where no ``\\r`` precedes it (the
    JAX package's lookahead takes that ``\\n`` too: ROADMAP.md Queue C);
    \\R (any linebreak) -> its defined alternation
  * POSIX/Java ASCII named classes \\p{Alpha}/\\p{Digit}/... -> explicit
    ASCII classes; Unicode category classes (\\p{L}, \\p{Lu}, ...) ->
    reject (engine semantics differ)
  * nested character-class UNIONS [a[bc]] -> flattened [abc];
    class intersection && -> reject
  * \\G, \\X, \\b inside classes -> reject
  * octal escapes \\0nn -> \\nnn form
  * possessive quantifiers / atomic groups pass through (Python >= 3.11);
    the DFA refuses them
"""
from __future__ import annotations

import re as _re
from typing import List

__all__ = ["RegexUnsupported", "transpile_java_regex", "RegexParser",
           "sql_like_to_regex", "POSIX_CLASSES"]

_D = "[0-9]"
_ND = "[^0-9]"
_W = "[a-zA-Z0-9_]"
_NW = "[^a-zA-Z0-9_]"
_S = "[ \\t\\n\\x0b\\f\\r]"
_NS = "[^ \\t\\n\\x0b\\f\\r]"

#: Java \Z and $: end of input but for a final line terminator (not
#: between the \r and the \n of a final \r\n)
_END_Z = "(?=(?:\\r\\n|(?<!\\r)\\n|[\\r\\x85\\u2028\\u2029])?\\Z)"
#: Java \R: any unicode linebreak sequence
_ANY_BREAK = "(?:\\r\\n|[\\n\\x0b\\f\\r\\x85\\u2028\\u2029])"
#: Java `.` (no DOTALL) excludes ALL line terminators; Python's dot
#: excludes only \n -> rewrite to an explicit negated class
_DOT = "[^\\n\\r\\x85\\u2028\\u2029]"

#: POSIX/Java ASCII named classes; values are class BODIES (composable
#: inside [...])
POSIX_CLASSES = {
    "Lower": "a-z", "Upper": "A-Z", "ASCII": "\\x00-\\x7f",
    "Alpha": "a-zA-Z", "Digit": "0-9", "Alnum": "a-zA-Z0-9",
    "Punct": "!-/:-@\\[-`{-~", "Graph": "!-~", "Print": " -~",
    "Blank": " \\t", "Cntrl": "\\x00-\\x1f\\x7f",
    "XDigit": "0-9a-fA-F", "Space": " \\t\\n\\x0b\\f\\r",
}


class RegexUnsupported(ValueError):
    """Pattern cannot be transpiled with identical semantics."""


class RegexParser:
    """Minimal Java-regex tokenizer/validator. Walks the pattern once,
    validating structure and rewriting escapes; nesting is tracked for
    groups and classes."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.out: List[str] = []
        self.group_depth = 0
        self.dotall = False
        # A global leading flag group (?s)/(?is)... is the one scoping we
        # can honor exactly: strip it, remember dotall, re-emit verbatim.
        m = _re.match(r"^\(\?([ims]+)\)", self.p)
        if m:
            if "m" in m.group(1):
                # Java multiline anchors recognize \r\n/\r/\x85/u2028/29;
                # Python's (?m) recognizes only \n
                raise RegexUnsupported(
                    "(?m) multiline anchors have Java-specific line "
                    "terminators")
            self.dotall = "s" in m.group(1)
            self.out.append(m.group(0))
            self.i = m.end()

    def error(self, msg: str):
        raise RegexUnsupported(f"{msg} near position {self.i} in "
                               f"{self.p!r}")

    def peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""

    def take(self) -> str:
        c = self.peek()
        self.i += 1
        return c

    # ------------------------------------------------------------------
    def parse(self) -> str:
        while self.i < len(self.p):
            c = self.take()
            if c == "\\":
                self._escape(in_class=False)
            elif c == ".":
                self.out.append("." if self.dotall else _DOT)
            elif c == "$":
                self.out.append(_END_Z)
            elif c == "[":
                self._char_class()
            elif c == "(":
                self._group_open()
            elif c == ")":
                self.group_depth -= 1
                if self.group_depth < 0:
                    self.error("unbalanced )")
                self.out.append(c)
            else:
                self.out.append(c)
        if self.group_depth != 0:
            self.error("unbalanced (")
        result = "".join(self.out)
        try:
            _re.compile(result)
        except _re.error as e:
            raise RegexUnsupported(f"transpiled pattern invalid: {e}")
        return result

    # ------------------------------------------------------------------
    def _escape(self, in_class: bool):
        c = self.take()
        if c == "":
            self.error("dangling backslash")
        if c == "d":
            self.out.append(_D if not in_class else "0-9")
        elif c == "D":
            if in_class:
                self.error("\\D inside character class")
            self.out.append(_ND)
        elif c == "w":
            self.out.append(_W if not in_class else "a-zA-Z0-9_")
        elif c == "W":
            if in_class:
                self.error("\\W inside character class")
            self.out.append(_NW)
        elif c == "s":
            self.out.append(_S if not in_class else " \\t\\n\\x0b\\f\\r")
        elif c == "S":
            if in_class:
                self.error("\\S inside character class")
            self.out.append(_NS)
        elif c == "Z":
            if in_class:
                self.error("\\Z inside character class")
            # Java \Z == Java non-multiline $
            self.out.append(_END_Z)
        elif c == "R":
            if in_class:
                self.error("\\R inside character class")
            self.out.append(_ANY_BREAK)
        elif c in ("G", "X"):
            self.error(f"\\{c} is not supported")
        elif c == "p" or c == "P":
            self._named_class(negated=(c == "P"), in_class=in_class)
        elif c in ("b", "B") and not in_class:
            # Python's use its Unicode \w; scope the ASCII flag
            self.out.append(f"(?a:\\{c})")
        elif c == "b" and in_class:
            self.error("\\b inside character class")
        elif c == "z":
            # Java \z: Python spells it \Z
            self.out.append("\\Z")
        elif c == "0":
            # Java octal \0nn -> Python \nnn
            digits = ""
            while self.peek().isdigit() and len(digits) < 3:
                digits += self.take()
            if not digits:
                self.error("bad octal escape")
            self.out.append("\\" + digits.zfill(3))
        else:
            self.out.append("\\" + c)

    # ------------------------------------------------------------------
    def _named_class(self, negated: bool, in_class: bool):
        if self.take() != "{":
            self.error("malformed \\p escape")
        name = ""
        while self.peek() and self.peek() != "}":
            name += self.take()
        if self.take() != "}":
            self.error("unterminated \\p{...}")
        body = POSIX_CLASSES.get(name)
        if body is None:
            # Unicode category/property classes (\p{L}, \p{IsDigit},
            # scripts, blocks): Java resolves them over Unicode, which
            # the ASCII expansions cannot reproduce
            self.error(f"\\p{{{name}}} is not supported")
        if in_class:
            if negated:
                self.error("\\P{...} inside character class")
            self.out.append(body)
        else:
            self.out.append(("[^" if negated else "[") + body + "]")

    # ------------------------------------------------------------------
    def _char_class(self, nested: bool = False):
        if not nested:
            self.out.append("[")
            if self.peek() == "^":
                self.out.append(self.take())
        if self.peek() == "]":
            self.out.append("\\]")
            self.take()
        while True:
            c = self.take()
            if c == "":
                self.error("unterminated character class")
            if c == "]":
                if not nested:
                    self.out.append("]")
                return
            if c == "\\":
                self._escape(in_class=True)
            elif c == "[":
                # Java nested class UNION [a[bc]]: flatten the inner
                # class's members into the enclosing one. A negated
                # nested class is set arithmetic — reject.
                if self.peek() == "^":
                    self.error("negated nested character class")
                self._char_class(nested=True)
            elif c == "&" and self.peek() == "&":
                self.error("character class intersection &&")
            else:
                self.out.append(c)

    # ------------------------------------------------------------------
    def _group_open(self):
        self.group_depth += 1
        self.out.append("(")
        if self.peek() != "?":
            return
        self.out.append(self.take())  # '?'
        c = self.peek()
        if c in (":", "=", "!", ">"):
            self.out.append(self.take())
        elif c == "<":
            self.out.append(self.take())
            n = self.peek()
            if n in ("=", "!"):
                self.out.append(self.take())  # lookbehind
            else:
                # named group (?<name>...) -> Python (?P<name>...)
                self.out.pop()
                self.out.append("P<")
        elif c in ("i", "m", "s", "u", "x", "d", "-"):
            while self.peek() and self.peek() not in ":)":
                f = self.take()
                if f in ("u", "d"):
                    self.error(f"inline flag ({f}) is not supported")
                if f == "m":
                    self.error("(?m) multiline anchors have "
                               "Java-specific line terminators")
                if f == "s":
                    # scoped/mid-pattern DOTALL would need per-region
                    # dot rewrites; only the global prefix is honored
                    self.error("non-global (?s) flag is not supported")
                self.out.append(f)
            if self.peek():
                self.out.append(self.take())
        else:
            self.error(f"unsupported group construct (?{c}")


def transpile_java_regex(pattern: str) -> str:
    """Java regex -> a semantically equivalent regex for Python's ``re``
    (the JAX package's ``target="python"``), or raise
    ``RegexUnsupported``."""
    return RegexParser(pattern).parse()


def sql_like_to_regex(pattern: str, escape: str = "\\") -> str:
    """SQL LIKE pattern -> anchored regex (ref GpuLike). Spark compiles
    LIKE with DOTALL, so ``_`` and ``%`` take a newline too: compile the
    result with ``re.DOTALL`` and match it with ``fullmatch`` (``$`` would
    also match before a final newline)."""
    out = ["^"]
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape and i + 1 < len(pattern):
            out.append(_re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(_re.escape(c))
        i += 1
    out.append("$")
    return "".join(out)
