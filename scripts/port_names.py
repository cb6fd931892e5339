"""List every public name of the JAX package (`summarymixing_tpu/`) that
the PyTorch port (`summarymixing_tpu_torch/`) lacks.

Both trees are read with `ast` (nothing is imported). A public name is a
top-level function, class or assignment of a module whose name does not
start with an underscore (the `Array = jax.Array` alias aside). For each
JAX module `summarymixing_tpu/a/b.py` the port's
`summarymixing_tpu_torch/a/b.py` is searched first; a name found only in
another port module does not count as missing (`--all` lists it with
where it is).

    python scripts/port_names.py            # the names the port lacks
    python scripts/port_names.py --all      # also those found elsewhere
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Dict, Set

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def public_names(path: str) -> Set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            if (isinstance(node.value, ast.Attribute) and node.value.attr == "Array"
                    and isinstance(node.value.value, ast.Name) and node.value.value.id == "jax"):
                continue   # the `Array = jax.Array` type alias
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def modules(package: str) -> Dict[str, Set[str]]:
    base = os.path.join(ROOT, package)
    out = {}
    for dirpath, _, files in os.walk(base):
        for name in files:
            if name.endswith(".py") and name != "__init__.py":
                path = os.path.join(dirpath, name)
                out[os.path.relpath(path, base)] = public_names(path)
    return out


def main(argv) -> int:
    jax_mods, port_mods = modules("summarymixing_tpu"), modules("summarymixing_tpu_torch")
    anywhere: Dict[str, str] = {}
    for mod, names in sorted(port_mods.items()):
        for n in names:
            anywhere.setdefault(n, mod)
    missing = 0
    for mod, names in sorted(jax_mods.items()):
        own = port_mods.get(mod, set())
        for n in sorted(names - own):
            if n in anywhere:
                if "--all" in argv:
                    print(f"{mod}::{n}  (in the port's {anywhere[n]})")
                continue
            print(f"{mod}::{n}")
            missing += 1
    print(f"{missing} public names of the JAX package have no counterpart in the port",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
