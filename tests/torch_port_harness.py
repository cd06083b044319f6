"""What the port's tests share: the CPU thread rule, the rank launcher and
the comparison helpers that more than one ``tests/test_torch_port_*.py``
uses.

Every port test file and both rank scripts (``tests/torch_mesh_rank.py``,
``tests/torch_tp_rank.py``) import this module first among their local
imports (``tests/test_torch_port_harness.py`` holds them to it).  It
imports nothing of JAX: the ranks are processes of the port.
"""

import contextlib
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_WORKER = os.path.join(ROOT, "tests", "torch_mesh_rank.py")

# One intra-op thread a process.  The tests' tensors are far too small to
# split across threads: on an 8-core host torch's default (a thread a
# core) spent 2.2-2.5x the CPU seconds of one thread on the port's CLI and
# trainer comparisons, and was slower in wall time even alone; under
# several pytest workers a process each, the extra threads only spin and
# take cores from the others.  ``torch.set_num_threads`` takes effect at
# any point, so importing this module is enough; inter-op threads are left
# as they are.  A spawned rank gets the same through its environment
# (``OMP_NUM_THREADS``) and by importing this module.
CPU_THREADS = 1
torch.set_num_threads(CPU_THREADS)

# What every spawned rank's environment adds to the parent's: the port's
# CPU platform and the thread rule.
RANK_ENV = {"GSTX_PLATFORM": "cpu", "OMP_NUM_THREADS": str(CPU_THREADS)}

SPAWN_TIMEOUT = 180  # seconds, a generous ceiling for a loaded host
SCORE_TOL = 1e-4     # the composed model, f32 on the CPU
PPL_TOL = 1e-4       # composed model, f32 on the CPU


# ---------------------------------------------------------------------- #
# launching ranks
# ---------------------------------------------------------------------- #


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(name, tmp, cmd, world=2, extra_env=None, torchrun=False):
    """Launch ``world`` ranks of ``cmd`` (the arguments after the
    interpreter) over a fresh gloo group on the CPU, without waiting:
    through ``python -m torch.distributed.run`` (its agent serves the
    store), or as ``world`` processes given the launcher's environment by
    hand (rank 0 serves it).  Each process starts in a session of its own,
    so that :func:`stop` ends a launcher together with its ranks.  Returns
    what :func:`finish` takes."""
    port = free_port()
    base = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                **RANK_ENV, **(extra_env or {}))
    if torchrun:
        cmds = [([sys.executable, "-m", "torch.distributed.run",
                  "--nproc_per_node", str(world), "--master_addr",
                  "127.0.0.1", "--master_port", str(port)] + cmd, base)]
    else:
        cmds = [([sys.executable] + cmd, dict(
            base, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
            LOCAL_WORLD_SIZE=str(world))) for r in range(world)]
    procs = []
    for i, (argv, env) in enumerate(cmds):
        path = os.path.join(tmp, f"{name}.{i}.log")
        log = open(path, "w")
        procs.append((subprocess.Popen(argv, env=env, cwd=ROOT, stdout=log,
                                       stderr=subprocess.STDOUT,
                                       start_new_session=True), log, path))
    return name, procs


def stop(started):
    """End what is left of :func:`start`'s processes, each with its whole
    process group (a launcher's ranks too), and close their logs."""
    for p, log, _ in started[1]:
        if p.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        log.close()


def finish(started):
    """Wait for :func:`start`'s processes; every one must exit 0."""
    name, procs = started
    try:
        for p, _, _ in procs:
            p.wait(timeout=SPAWN_TIMEOUT)
    finally:
        stop(started)
    for i, (p, _, path) in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"process {i} of {name} exited "
                                 f"{p.returncode}:\n"
                                 f"{open(path).read()[-4000:]}")


def start_worker(task, spec, tmp, world=2, extra_env=None, torchrun=False):
    """:func:`start` on ``world`` ranks of ``tests/torch_mesh_rank.py`` on
    ``task``."""
    tmp = os.path.join(tmp, f"spawn_{task}")
    os.makedirs(tmp)
    spec = dict(spec, out=os.path.join(tmp, task))
    spec_path = os.path.join(tmp, f"{task}.json")
    json.dump(spec, open(spec_path, "w"))
    return (start(task, tmp, [MESH_WORKER, task, spec_path], world,
                  extra_env, torchrun), spec["out"], world)


# ---------------------------------------------------------------------- #
# comparing the port with the JAX package
# ---------------------------------------------------------------------- #


def record_scores(monkeypatch, module, name, record):
    """Wrap ``module.name`` (a scorer factory) so that every chunk's scores
    land in ``record``."""
    make = getattr(module, name)

    def wrapped(*a, **kw):
        score = make(*a, **kw)

        def scored(*args):
            out = score(*args)
            record.append(np.asarray(out.detach() if torch.is_tensor(out)
                                     else out))
            return out
        return scored
    monkeypatch.setattr(module, name, wrapped)


def option_groups(batch_or_items, kind):
    """Per (image, round, option): the option's token sequence as bytes, to
    find options whose sequences are identical."""
    key = "dec_input_ids" if kind == "gen" else "tokens"
    x = batch_or_items[key]
    return x.reshape(x.shape[0], x.shape[1], x.shape[2], -1)


def compare_ranks(got, want, seqs=None):
    """Assert that the port's scores ``got`` rank like the JAX scores
    ``want`` ([..., options]) except between near-tied pairs (different
    options whose JAX scores lie within SCORE_TOL); return them as a
    symmetric [rows, options, options] mask.  With ``seqs`` ([..., options,
    L]), options of identical sequences must tie exactly in the port."""
    got = got.reshape(-1, got.shape[-1])
    want = want.reshape(-1, want.shape[-1])
    near = np.zeros((got.shape[0],) + 2 * got.shape[-1:], dtype=bool)
    for r in range(got.shape[0]):
        dw = want[r][:, None] - want[r][None, :]
        dg = got[r][:, None] - got[r][None, :]
        same = np.zeros_like(dw, dtype=bool)
        if seqs is not None:
            s = seqs.reshape(-1, *seqs.shape[-2:])[r]
            same = (s[:, None, :] == s[None, :, :]).all(-1)
            assert (dg[same] == 0).all() and (dw[same] == 0).all()
        tied = near[r] = (np.abs(dw) <= SCORE_TOL) & ~same
        ok = same | tied | (np.sign(dg) == np.sign(dw))
        assert ok.all(), f"row {r}: order differs outside near-ties"
    return near


def assert_same_records(got, want):
    assert len(want) > 0 and len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("image_id", "url", "caption")} == \
            {k: w[k] for k in ("image_id", "url", "caption")}
        assert len(g["dialog"]) == len(w["dialog"])
        for gr, wr in zip(g["dialog"], w["dialog"]):
            assert gr["question"] == wr["question"]
            assert gr["answer"] == wr["answer"]
            assert abs(gr["answer_ppl"] - wr["answer_ppl"]) <= \
                PPL_TOL * abs(wr["answer_ppl"])


def assert_rel(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(scale, 1e-30), (what, err, scale)
