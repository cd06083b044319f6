"""The port tests' harness (``tests/torch_port_harness.py``) and the rules
that keep it the one place for what they share: every port test file and
rank script imports it before anything of the project, the tests run on
one CPU thread, no port test file imports another, and the launcher's
processes get the harness's environment and end with their children."""

import ast
import os
import time
from pathlib import Path

import pytest
import torch

import torch_port_harness as harness

TESTS = Path(__file__).resolve().parent
PORT_TESTS = sorted(TESTS.glob("test_torch_port_*.py"))
RANK_SCRIPTS = [TESTS / "torch_mesh_rank.py", TESTS / "torch_tp_rank.py"]
PROJECT = ("gstx", "gstx_torch", "fixtures")  # and tests/test_*, torch_*


def _imports(path):
    """The modules ``path`` imports at its top level, in order."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _local(module):
    return module.split(".")[0] in PROJECT or \
        module.startswith(("test_", "torch_"))


def test_the_files_are_found():
    assert len(PORT_TESTS) > 20 and all(p.exists() for p in RANK_SCRIPTS)


@pytest.mark.parametrize("path", PORT_TESTS + RANK_SCRIPTS,
                         ids=lambda p: p.name)
def test_imports_the_harness_first(path):
    """The harness is the first of the file's local imports, so the
    thread rule holds before any of the project's code runs: a new port
    test file without it would bring back a thread a core in every
    pytest worker that collects it alone."""
    local = [m for m in _imports(path) if _local(m)]
    assert local and local[0] == "torch_port_harness", local[:3]


@pytest.mark.parametrize("path", PORT_TESTS, ids=lambda p: p.name)
def test_imports_no_other_port_test_file(path):
    """Shared helpers live in the harness, not in another test file."""
    others = [m for m in _imports(path) if m.startswith("test_torch_port")]
    assert others == []


def test_one_cpu_thread():
    assert harness.CPU_THREADS == 1
    assert torch.get_num_threads() == harness.CPU_THREADS


def _gone(pid):
    """No process ``pid`` runs: absent, or a zombie waiting to be reaped."""
    try:
        return open(f"/proc/{pid}/stat").read().rsplit(")", 1)[1].split()[0] \
            == "Z"
    except FileNotFoundError:
        return True


SPAWNING = ("import os, subprocess, sys, time\n"
            "child = subprocess.Popen([sys.executable, '-c',"
            " 'import time; time.sleep(120)'])\n"
            "print(child.pid, os.environ['OMP_NUM_THREADS'],"
            " os.environ['GSTX_PLATFORM'], os.environ['RANK'], flush=True)\n"
            "time.sleep(120)\n")


def test_stop_ends_a_launcher_with_its_children(tmp_path):
    """A process that :func:`start` launched, and the child it started
    (as ``torch.distributed.run`` starts its ranks), both end at
    :func:`stop`; each got the harness's rank environment."""
    started = harness.start("spawning", str(tmp_path), ["-c", SPAWNING])
    try:
        deadline = time.time() + 60
        lines = []
        while time.time() < deadline:
            lines = [open(path).read().split() for _, _, path in started[1]]
            if all(len(words) == 4 for words in lines):
                break
            time.sleep(0.1)
        assert [words[1:] for words in lines] == [
            [harness.RANK_ENV["OMP_NUM_THREADS"],
             harness.RANK_ENV["GSTX_PLATFORM"], str(r)] for r in range(2)]
    finally:
        harness.stop(started)
    children = [int(words[0]) for words in lines]
    deadline = time.time() + 10
    while not all(_gone(pid) for pid in children) and time.time() < deadline:
        time.sleep(0.1)
    assert all(_gone(pid) for pid in children)
    assert all(p.returncode is not None for p, _, _ in started[1])


def test_finish_names_the_process_that_failed(tmp_path):
    started = harness.start(
        "failing", str(tmp_path),
        ["-c", "import os, sys; print('rank', os.environ['RANK']);"
               " sys.exit(int(os.environ['RANK']) * 3)"])
    with pytest.raises(AssertionError, match="process 1 of failing exited "
                       "3:\nrank 1"):
        harness.finish(started)
    assert os.path.exists(started[1][0][2])
