"""meryl2 command parser: the class:name=value grammar (a copy of
meryl_tpu/v2/parser.py; only the docstrings differ).

Grammar per meryl2's documentation/source/reference.rst:399-460
and src/meryl2/merylCommandBuilder-*.C:
  * words may open with '[' and close with any number of ']'
  * parameters are class:name=value or class:name:selector, with every
    class/name shortenable to any prefix; class aliases: assign<-set,
    select<-get; name aliases per the docs
  * value/label assigns: #X @X first min(#X) max(#X) add sum sub dif
    mul div divzero mod rem count / and or xor difference lightest
    heaviest invert shift-left shift-right rotate-left rotate-right
  * selectors: value|label: ARG1 REL ARG2 with @n/#c/output; bases:
    LETTERS:REL CONST; input: all|any|first|@n|@n-@m|n|n-m|n-all
  * 'not' inverts the next selector term; 'and'/'or' build the
    sum-of-products (and binds tighter)
  * constants: decimal (123, 123d), hex (abch), octal (147o), binary
    (0101b), SI suffixes k/m/g/t (+i for binary)
  * v1 action names are aliases (reference.rst:318-372)
"""

from __future__ import annotations

import re

from .engine import Assign, Selector, SelectorTerm


def parse_constant(s: str) -> int:
    """Decode meryl2 integer constants with radix/SI suffixes."""
    s = s.strip()
    m = re.fullmatch(r"([0-9a-fA-F]+)h", s)
    if m:
        return int(m.group(1), 16)
    m = re.fullmatch(r"([0-7]+)o", s)
    if m:
        return int(m.group(1), 8)
    m = re.fullmatch(r"([01]+)b", s)
    if m:
        return int(m.group(1), 2)
    m = re.fullmatch(r"(\d+)d?", s)
    if m:
        return int(m.group(1))
    m = re.fullmatch(r"(\d+)([kmgtKMGT])(i?)", s)
    if m:
        base = 1024 if m.group(3) else 1000
        exp = {"k": 1, "m": 2, "g": 3, "t": 4}[m.group(2).lower()]
        return int(m.group(1)) * base ** exp
    if s.startswith("0x"):
        return int(s, 16)
    if s.startswith("0b"):
        return int(s, 2)
    raise ValueError(f"cannot parse constant '{s}'")


# ---- assign rules ----

_VAL_OPS = {"first": "first", "min": "min", "max": "max", "add": "add",
            "sum": "add", "sub": "sub", "dif": "sub", "mul": "mul",
            "div": "div", "divzero": "divzero", "mod": "mod", "rem": "mod",
            "count": "count", "selected": "selected"}
_LAB_OPS = {"first": "first", "min": "min", "max": "max", "and": "and",
            "or": "or", "xor": "xor", "difference": "difference",
            "lightest": "lightest", "heaviest": "heaviest",
            "invert": "invert", "shift-left": "shift-left",
            "shift-right": "shift-right", "rotate-left": "rotate-left",
            "rotate-right": "rotate-right", "selected": "selected"}


def parse_assign(rule: str, is_label: bool) -> Assign:
    ops = _LAB_OPS if is_label else _VAL_OPS
    if rule.startswith("#"):
        return Assign("set", parse_constant(rule[1:]), True)
    if rule.startswith("@"):
        return Assign("atindex", index=int(rule[1:]))
    name, const, has = rule, 0, False
    if "#" in rule:
        name, cs = rule.split("#", 1)
        const, has = parse_constant(cs), True
    if name in ops:
        return Assign(ops[name], const, has)
    # bare constant (e.g. label=0b001 in the docs examples)
    try:
        return Assign("set", parse_constant(rule), True)
    except ValueError:
        raise ValueError(f"unknown assign rule '{rule}'") from None


# ---- selectors ----

_RELS = [("==", "eq"), ("=", "eq"), ("eq", "eq"),
         ("!=", "ne"), ("<>", "ne"), ("ne", "ne"),
         ("<=", "le"), ("le", "le"), (">=", "ge"), ("ge", "ge"),
         ("<", "lt"), ("lt", "lt"), (">", "gt"), ("gt", "gt")]


def _find_relation(s: str):
    """-> (arg1, rel, arg2) by scanning for the first relation token."""
    for i in range(len(s)):
        for tok, rel in _RELS:
            if s.startswith(tok, i):
                # 'eq'/'ne'... could appear inside hex constants; only
                # treat letter relations as such when not mid-number
                return s[:i], rel, s[i + len(tok):]
    raise ValueError(f"no comparison operator in '{s}'")


def _parse_arg(a: str, quantity: str):
    a = a.strip()
    if a == "":
        return ("out", 0)
    if a.startswith("@"):
        return ("input", int(a[1:]))
    if a.startswith("#"):
        return ("const", parse_constant(a[1:]))
    if a.startswith("threshold="):
        return ("const", parse_constant(a[len("threshold="):]))
    if a.startswith("distinct="):
        return ("distinct", float(a[len("distinct="):]))
    if a.startswith("word-freq="):
        return ("wordfreq", float(a[len("word-freq="):]))
    if a.startswith("word-frequency="):
        return ("wordfreq", float(a[len("word-frequency="):]))
    return ("const", parse_constant(a))


def parse_selector_term(quantity: str, rest: str, negate: bool):
    """quantity in value|label|bases|input; rest is the spec string."""
    if quantity in ("value", "label"):
        a1, rel, a2 = _find_relation(rest)
        return [SelectorTerm(quantity, rel, _parse_arg(a1, quantity),
                             _parse_arg(a2, quantity), negate)]
    if quantity == "bases":
        # LETTERS:REL CONST  e.g. acgt:ge4 or gc:>=10
        m = re.fullmatch(r"([acgtACGT]+)[:,]?(.*)", rest)
        if not m:
            raise ValueError(f"bad bases selector '{rest}'")
        letters = set(m.group(1).upper())
        _, rel, a2 = _find_relation(m.group(2))
        terms = []
        # count of each requested letter summed: approximate by summing
        # per-letter counts into one term per letter is wrong for sums;
        # we instead keep the letter set in arg1 and evaluate in engine
        return [SelectorTerm("bases", rel, ("letters", "".join(sorted(letters))),
                             _parse_arg(a2, "bases"), negate)]
    if quantity == "input":
        specs = re.split(r"[:,]", rest) if rest else []
        terms = []
        idx = []
        nums = []
        flags = set()
        for w in specs:
            if not w:
                continue
            if w == "all":
                flags.add("all")
            elif w == "any":
                flags.add("any")
            elif w == "first":
                idx.append(1)
            elif w.startswith("@") and "-" in w:
                a, b = w.split("-")
                idx.extend(range(int(a[1:]), int(b.lstrip("@")) + 1))
            elif w.startswith("@"):
                idx.append(int(w[1:]))
            elif "-" in w:
                a, b = w.split("-")
                if b == "all":
                    nums.append(("atleast", int(a)))
                else:
                    nums.extend(("exact", x)
                                for x in range(int(a), int(b) + 1))
            else:
                nums.append(("exact", int(w)))
        return [SelectorTerm("input", "nop",
                             ("spec", (tuple(sorted(flags)), tuple(idx),
                                       tuple(nums))),
                             ("const", 0), negate)]
    raise ValueError(f"unknown selector quantity '{quantity}'")


def load_program_text(path: str) -> list:
    """Parse a meryl2 program file into words.

    Rules per the reference loadProgramText
    (meryl2's src/meryl2/meryl.C:87-150): single/double quotes
    group words (outermost quotes removed, the other quote kind kept),
    backslash escapes the next character (but is literal inside
    quotes), '#' at line start or after a space comments out the rest
    of the line, whitespace separates words."""
    from ..io.sequence import open_maybe_compressed
    words = []
    with open_maybe_compressed(path) as f:
        data = f.read()
        if isinstance(data, bytes):
            data = data.decode()
    for line in data.splitlines():
        esc = sgl = dbl = False
        cur = []
        started = False
        ll = 0
        while ll < len(line):
            ch = line[ll]
            nesc = not esc and not sgl and not dbl
            com = ch == "#" and (ll == 0 or (ll > 1 and line[ll - 1] == " "))
            if nesc and ch == "\\":
                esc = True
                started = True
            elif nesc and ch == "'":
                sgl = True
                started = True
            elif not esc and sgl and not dbl and ch == "'":
                sgl = False
            elif nesc and ch == '"':
                dbl = True
                started = True
            elif not esc and not sgl and dbl and ch == '"':
                dbl = False
            elif nesc and com:
                break
            elif nesc and ch in (" ", "\t"):
                if started or cur:
                    words.append("".join(cur))
                cur = []
                started = False
            else:
                cur.append(ch)
                esc = False
                started = True
            ll += 1
        if started or cur:
            words.append("".join(cur))
    return [w for w in words if w != ""]


# ---- class:name matching with prefix abbreviation ----

def _matches(word: str, full: str, aliases=()) -> bool:
    if word in aliases:
        return True
    return len(word) > 0 and full.startswith(word)


def split_class_name(token: str):
    """'o:d=x' -> ('output','database','x') etc.  Returns None if the
    token is not a class:name parameter."""
    m = re.match(r"^([A-Za-z-]+):([A-Za-z-]+)([:=])(.*)$", token)
    m2 = re.match(r"^([A-Za-z-]+):([A-Za-z-]+)$", token)
    if m:
        cls_w, name_w, sep, rest = m.group(1), m.group(2), m.group(3), m.group(4)
    elif m2:
        cls_w, name_w, sep, rest = m2.group(1), m2.group(2), "", ""
    else:
        return None

    cls = None
    if _matches(cls_w, "output"):
        cls = "output"
    elif _matches(cls_w, "assign", aliases=("set",)):
        cls = "assign"
    elif _matches(cls_w, "select", aliases=("get",)):
        cls = "select"
    elif _matches(cls_w, "input"):
        cls = "input"
    if cls is None:
        return None

    names = {
        "output": [("database", ("db",)),
                   ("list", ("t", "txt", "text")),
                   ("listACGT", ("listacgt",)),
                   ("show", ("display", "dis", "print", "stdout")),
                   ("pipe", ()), ("histogram", ()),
                   ("statistics", ("stats",))],
        "assign": [("value", ()), ("label", ())],
        "select": [("value", ()), ("label", ()),
                   ("bases", ("acgt", "bp")), ("input", ())],
        "input": [("database", ("db",)), ("list", ("t", "txt", "text")),
                  ("pipe", ()), ("action", ())],
    }[cls]
    name = None
    for full, aliases in names:
        if cls == "output" and full == "statistics" and name_w == "s":
            continue  # 's' is NOT an abbreviation of statistics
        if _matches(name_w, full, aliases):
            name = full
            break
    if name is None:
        return None
    return cls, name, rest
