"""deal.II ``.prm`` parameter-file reader/writer.

Copy of ``fictitious_domain_al_preconditioners_tpu.utils.prm`` (standard
library only).

The reference's entire CLI surface is ``./<exe> <file>.prm`` with
``ParameterAcceptor``-declared sections (reference: immersed_laplace.cc:1057-1065
and the Parameters classes at immersed_laplace.cc:70-233 etc.).  This module
reads/writes that exact format so every ``.prm`` file shipped with the reference
drives this framework unchanged.

Format:
  - ``subsection <Name>`` ... ``end`` (nested)
  - ``set <Key> = <value>``; a repeated ``set`` of the same key overrides
    (deal.II behavior; Circle_parameters_smooth.prm sets Tolerance twice)
  - ``#`` starts a comment; ``\\`` at end of line continues the line
"""

from __future__ import annotations

__all__ = ["parse_prm", "dump_prm", "Params"]


def _strip_comment(line: str) -> str:
    # '#' begins a comment (the format never quotes '#').
    idx = line.find("#")
    return line if idx < 0 else line[:idx]


def _logical_lines(text: str):
    buf = ""
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if line.endswith("\\"):
            buf += line[:-1] + " "
            continue
        buf += line
        if buf.strip():
            yield buf.strip()
        buf = ""
    if buf.strip():
        yield buf.strip()


def parse_prm(text: str) -> dict:
    """Parse prm text into a nested dict (subsections -> dicts, sets -> str)."""
    root: dict = {}
    stack = [root]
    for line in _logical_lines(text):
        low = line.lower()
        if low.startswith("subsection"):
            name = line[len("subsection"):].strip()
            cur = stack[-1]
            child = cur.setdefault(name, {})
            if not isinstance(child, dict):
                raise ValueError(f"name clash for subsection {name!r}")
            stack.append(child)
        elif low == "end":
            if len(stack) == 1:
                raise ValueError("unbalanced 'end'")
            stack.pop()
        elif low.startswith("set "):
            body = line[4:]
            key, sep, val = body.partition("=")
            if not sep:
                raise ValueError(f"malformed set line: {line!r}")
            stack[-1][key.strip()] = val.strip()
        elif low.startswith("include "):
            raise ValueError("prm 'include' not supported")
        else:
            raise ValueError(f"cannot parse prm line: {line!r}")
    if len(stack) != 1:
        raise ValueError("missing 'end' for subsection")
    return root


def dump_prm(tree: dict, indent: int = 0) -> str:
    """Write a nested dict back as prm text (the ``used_parameters.prm`` echo,
    reference: immersed_laplace.cc:1063)."""
    pad = "  " * indent
    lines = []
    # deal.II writes sets before subsections, alphabetically
    for key in sorted(k for k, v in tree.items() if not isinstance(v, dict)):
        lines.append(f"{pad}set {key} = {tree[key]}")
    for key in sorted(k for k, v in tree.items() if isinstance(v, dict)):
        lines.append(f"{pad}subsection {key}")
        lines.append(dump_prm(tree[key], indent + 1))
        lines.append(f"{pad}end")
    return "\n".join(lines)


class Params:
    """Typed accessor over a parsed prm tree with declared defaults.

    ``path`` components are subsection names; the terminal component is the key.
    Missing entries fall back to the supplied default (mirroring
    ``ParameterAcceptor``'s declare-with-default semantics).
    """

    def __init__(self, tree: dict):
        self.tree = tree
        self.used: dict = {}

    @classmethod
    def from_file(cls, path) -> "Params":
        with open(path) as fh:
            return cls(parse_prm(fh.read()))

    def enter(self, *sections: str) -> "Params":
        node = self.tree
        for s in sections:
            node = node.get(s, {})
            if not isinstance(node, dict):
                raise KeyError(f"{s!r} is a value, not a subsection")
        sub = Params(node)
        sub.used = self.used  # share the echo dict
        return sub

    def _raw(self, key: str, default):
        val = self.tree.get(key, None)
        if val is None or isinstance(val, dict):
            return default
        return val

    def get_str(self, key: str, default: str = "") -> str:
        return str(self._raw(key, default))

    def get_int(self, key: str, default: int = 0) -> int:
        return int(float(self._raw(key, default)))

    def get_float(self, key: str, default: float = 0.0) -> float:
        return float(self._raw(key, default))

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._raw(key, default)
        if isinstance(v, bool):
            return v
        return str(v).strip().lower() in ("true", "yes", "on", "1")

    def get_int_list(self, key: str, default=()) -> list:
        v = self._raw(key, None)
        if v is None:
            return list(default)
        return [int(p) for p in str(v).replace(",", " ").split()]

    def get_float_list(self, key: str, default=()) -> list:
        v = self._raw(key, None)
        if v is None:
            return list(default)
        return [float(p) for p in str(v).replace(",", " ").split()]
