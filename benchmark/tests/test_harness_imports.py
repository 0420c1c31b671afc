"""No run may load JAX, the JAX package or its bench (whole top-level
names), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from conftest import ROOT

from benchmark.run import forbidden_modules


def test_names_compared_whole():
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client",
                              "flax.linen", "pointwise_tpu",
                              "pointwise_tpu.ops", "bench",
                              "pointwise_torch.bench"]) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "pointwise_tpu", "pointwise_tpu.ops", "bench",
         "pointwise_torch.bench"])
    assert forbidden_modules(["pointwise_torch", "pointwise_torch.ops",
                              "pointwise_torch.benchmarks", "jaxtyping",
                              "flaxen", "benchmark", "benchmark.run",
                              "pointwise_tpu_extra"]) == []


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_benchmark_names_no_jax():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, f)):
                    assert mod.split(".")[0] not in ("jax", "jaxlib", "flax",
                                                     "pointwise_tpu", "bench")


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "benchmark", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                assert mod.split(".")[0] != "pointwise_torch", (f, mod)
    code = ("import sys, benchmark.reference.models, benchmark.reference."
            "precision; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('pointwise_torch', 'jax', "
            "'pointwise_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result(tmp_path):
    """Without a card the command fails and prints no result."""
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "modelnet40_cls.train", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
