"""Run examples/custom_data_walkthrough_torch.py cell by cell, as a notebook
would, with some of its parameters overridden.

    from run_walkthrough_torch import run_walkthrough
    ns, walls, skipped = run_walkthrough("my_project", dict(device="cpu"))

Imports torch and gs2mesh_torch only.
"""

import ast
import os
import time

import torch

WALKTHROUGH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "custom_data_walkthrough_torch.py")


def walkthrough_cells():
    """(title, source) of each "# %%" cell of the port's walkthrough."""
    with open(WALKTHROUGH) as f:
        lines = f.read().splitlines(keepends=True)
    starts = [i for i, ln in enumerate(lines) if ln.startswith("# %%")]
    return [(lines[a][4:].strip(), "".join(lines[a:b]))
            for a, b in zip(starts, starts[1:] + [len(lines)])]


def run_cell(ns, title, src):
    """Exec one cell's source in the namespace ns."""
    name = os.path.basename(WALKTHROUGH)
    tree = src if isinstance(src, ast.AST) else ast.parse(src)
    exec(compile(tree, f"{name} [{title}]", "exec"), ns)


def run_walkthrough(base_dir, params, skip=()):
    """Exec the walkthrough's cells in order with base_dir as the working
    directory, leaving out each top-level call of a function named in
    ``skip`` (the rest of its cell runs). After the Parameters cell runs,
    ``params`` override its values ("device" the cell variable, every other
    key a field of args) and strings is made again from the new args.
    Returns (the cells' namespace, {title: wall s}, the calls left out as
    (title, name))."""
    from gs2mesh_torch.pipeline import create_strings

    def called(node):
        f = node.value.func if (isinstance(node, ast.Expr) and isinstance(
            node.value, ast.Call)) else None
        return getattr(f, "attr", getattr(f, "id", None))

    ns = {"__name__": "walkthrough"}
    walls, skipped = {}, []
    cwd = os.getcwd()
    os.chdir(base_dir)
    try:
        for title, src in walkthrough_cells():
            tree = ast.parse(src)
            skipped += [(title, called(n)) for n in tree.body
                        if called(n) in skip]
            tree.body = [n for n in tree.body if called(n) not in skip]
            t0 = time.perf_counter()
            run_cell(ns, title, tree)
            if title == "Parameters":
                for k, v in params.items():
                    if k == "device":
                        ns["device"] = v
                    else:
                        setattr(ns["args"], k, v)
                ns["strings"] = create_strings(ns["args"], ns["base_dir"])
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            walls[title] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    return ns, walls, skipped
