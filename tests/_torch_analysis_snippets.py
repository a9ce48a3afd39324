"""The source snippets of the reference's analysis tests, for parity.

``snippets(name)`` reads ``tests/<name>`` by AST (nothing of it is
imported or run) and returns every string literal in it that parses as
Python and defines a function or a class, dedented, in file order with
duplicates dropped: the fixtures the reference's passes are tested on.
The port's tests hand the same snippets to both packages' passes and
compare what they report.
"""

import ast
import textwrap
from pathlib import Path

_TESTS = Path(__file__).resolve().parent


def snippets(name):
    tree = ast.parse((_TESTS / name).read_text(), filename=name)
    out, seen = [], set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant)
                and isinstance(node.value, str)):
            continue
        src = textwrap.dedent(node.value)
        if ("def " not in src and "class " not in src) or src in seen:
            continue
        try:
            ast.parse(src)
        except SyntaxError:
            continue
        seen.add(src)
        out.append((node.lineno, src))
    out.sort()
    return [s for _, s in out]
