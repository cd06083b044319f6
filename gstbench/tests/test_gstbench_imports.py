"""What the benchmark runs imports neither JAX nor the JAX package
``gstx`` (top-level names compared whole: ``gstx_torch`` begins with
``gstx``), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from gstbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "gstx"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub=""):
    for root, _, files in os.walk(os.path.join(harness.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_jax_anywhere():
    for path in _files():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in _files("reference"):
        tops = set(_imports(path))
        assert "gstx_torch" not in tops and "gstbench" not in tops, path
        assert tops <= {"__future__", "contextlib", "math", "typing",
                        "numpy", "torch"}, (path, tops)


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process, then its modules."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from gstbench.tests import tiny\n"
            "from gstbench import harness\n"
            "tiny.run('gen.gst_enc_dec.cc12m', seconds=2.0)\n"
            "print(harness.forbidden_modules())\n" % harness.ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
