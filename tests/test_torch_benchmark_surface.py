"""The names of the port that the benchmark's harness takes, on the CPU.

The harness (``benchmark/``, run by ``python3 -m benchmark.run`` on the
card) imports the port and calls into it: entry points, counters and
configuration classes.  A rename in the port would show only on the card,
as a run that prints no result.  The names are collected here by walking
the harness's sources (``benchmark/`` and its subpackages, its own tests
left out): each ``from pointwise_torch... import X``, each ``X.attr`` and
each ``getattr(X, "attr")`` on those names.  One case per name asserts
that it resolves in the port and, where the harness calls it with
keywords, that its signature takes them.
"""

import ast
import importlib
import inspect
import os

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
HARNESS = os.path.join(ROOT, "benchmark")


def _harness_files():
    for dirpath, dirs, files in os.walk(HARNESS):
        dirs[:] = sorted(d for d in dirs if d != "tests"
                         and not d.startswith(("_", ".")))
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _dotted(node, aliases):
    """The port name ``node`` stands for (an alias or attributes of one)."""
    if isinstance(node, ast.Name):
        return aliases.get(node.id)
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value, aliases)
        return base and f"{base}.{node.attr}"
    return None


def harness_names() -> dict:
    """{dotted port name: the keywords the harness passes it}."""
    names: dict = {}
    for path in _harness_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        aliases = {}
        for node in ast.walk(tree):
            if (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.split(".")[0] == "pointwise_torch"):
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        for name in aliases.values():
            names.setdefault(name, set())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in aliases):
                names.setdefault(_dotted(node, aliases), set())
            elif isinstance(node, ast.Call):
                if (isinstance(node.func, ast.Name)
                        and node.func.id == "getattr" and len(node.args) >= 2
                        and isinstance(node.args[1], ast.Constant)):
                    base = _dotted(node.args[0], aliases)
                    if base:
                        names.setdefault(f"{base}.{node.args[1].value}",
                                         set())
                name = _dotted(node.func, aliases)
                if name:
                    names.setdefault(name, set()).update(
                        k.arg for k in node.keywords if k.arg)
    return names


NAMES = harness_names()


def resolve(name: str):
    """The object a dotted name stands for: its longest importable module
    prefix, then attributes."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(name)


def test_the_walk_finds_the_entry_points():
    # the walk itself: a harness that stopped importing the port, or an
    # import form the walk misses, would leave nothing to check
    for name in ("pointwise_torch.streaming.stream_apply_layered",
                 "pointwise_torch.infer.build_model",
                 "pointwise_torch.train.cli._trainer",
                 "pointwise_torch.kernels.pointwise_conv_cuda.HOST_SYNCS"):
        assert name in NAMES, sorted(NAMES)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_the_harness_name_resolves(name):
    obj = resolve(name)
    keywords = NAMES[name]
    if keywords:
        inspect.signature(obj).bind_partial(**dict.fromkeys(keywords))
