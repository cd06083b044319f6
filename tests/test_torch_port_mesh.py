"""Data parallelism in the port (gstx_torch.core.mesh, the trainers' and the
evaluators' multi-process paths, generation's shards) against the JAX
package, f32 on the CPU.  Two-rank groups run over gloo, each rank a
subprocess (``tests/torch_mesh_rank.py`` or a CLI), launched through
``python -m torch.distributed.run`` or given the launcher's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) by hand; every launch starts once, as the module starts,
in a fixture.

Tolerances:

  * the pure functions: equal to JAX's, errors included;
  * one two-rank step against the single-process step on the same global
    batch: loss within 1e-6, every parameter within 1e-5, the ranks'
    replicas equal; a mean of the ranks' local means misses the loss by
    more than 1e-3 (the halves' label counts differ); the loss against
    JAX's ``loss_fn`` on the same rows within 1e-5 relative;
  * a two-rank resume and a two-rank checkpoint's reading: bit for bit;
  * generation's shards: the JAX CLI's records (greedy f32, PPL within
    1e-4 relative, as tests/test_torch_port_cli.py);
  * two-rank evaluation: scores within 1e-6 of the single process, the
    same metrics; against the JAX CLI within its near-tie bounds
    (tests/test_torch_port_eval.py).
"""

import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_cli_env
from gstx.cli import evaluate_disc as jdisc_cli
from gstx.cli import evaluate_gen as jgen_cli
from gstx.cli import generate as jgenerate
from gstx.cli.common import build_model as j_build_model
from gstx.cli.common import init_params
from gstx.core import logging as jlogging
from gstx.core import mesh as jmesh
from gstx.core.checkpoint import to_torch_state_dict
from gstx.eval import rank_disc as jrank_disc
from gstx.eval import rank_gen as jrank_gen
from gstx.models import heads as jheads
from gstx.models.encdec import GSTVisualDialog as JGST
from gstx.models.encdec import teacher_forced_loss as jax_loss
from gstx.train.train_disc import nsp_attention_mask as jax_nsp_mask
from gstx_torch.cli import common as tcommon
from gstx_torch.cli import evaluate_disc as tdisc_cli
from gstx_torch.cli import evaluate_gen_attack as tattack_cli
from gstx_torch.cli import evaluate_gen as tgen_cli
from gstx_torch.cli import generate as tgenerate
from gstx_torch.core import checkpoint as tckpt
from gstx_torch.core import config as tcfg
from gstx_torch.core import logging as tlogging
from gstx_torch.core import mesh as tmesh
from gstx_torch.core.checkpoint import state_dict_from_jax
from gstx_torch.data import tokenizer as ttok
from gstx_torch.data import visdial as tvisdial
from gstx_torch.data.loader import collate
from gstx_torch.eval import rank_gen as trank_gen
from gstx_torch.kernels import ffn as kffn
from gstx_torch.models import encdec as tencdec
from gstx_torch.models import heads as theads
from gstx_torch.train import train_disc as tdisc
from gstx_torch.train import train_gen as ttrain
from test_torch_port_cli import assert_same_records
from test_torch_port_eval import _option_groups, _recording, compare_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_rank.py")
LOSS_TOL = 1e-6
PARAM_TOL = 1e-5
JAX_LOSS_TOL = 1e-5
CONTROL_MISS = 1e-3
SCORE_TOL = 1e-6
JAX_SCORE_TOL = 1e-4   # tests/test_torch_port_eval.py's SCORE_TOL
SPAWN_TIMEOUT = 180    # seconds, a generous ceiling for a loaded host


# ---------------------------------------------------------------------- #
# the pure functions against JAX's
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("n,count", [(0, 1), (7, 1), (10, 3), (16, 4),
                                     (5, 8)], ids=str)
def test_process_shard_matches_jax(n, count):
    stripes = [tmesh.process_shard(n, i, count) for i in range(count)]
    for i, got in enumerate(stripes):
        np.testing.assert_array_equal(got, jmesh.process_shard(n, i, count))
    np.testing.assert_array_equal(np.sort(np.concatenate(stripes)),
                                  np.arange(n))


def _outcome(fn, *a):
    try:
        return fn(*a)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("batch,n_proc", [(72, 1), (72, 2), (72, 5), (10, 4),
                                          (8, 8), (3, 0)], ids=str)
def test_local_batch_size_matches_jax(batch, n_proc):
    got = _outcome(tmesh.local_batch_size, batch, n_proc)
    assert got == _outcome(jmesh.local_batch_size, batch, n_proc)
    if batch % max(n_proc, 1):
        assert got[0] == "ValueError" and "divisible" in got[1]


@pytest.mark.parametrize("batch,n_dev", [(72, 1), (72, 5), (7, 4), (1, 8),
                                         (100, 8), (6, 4)], ids=str)
def test_auto_data_parallel_matches_jax(batch, n_dev):
    assert tmesh.auto_data_parallel(batch, n_dev) == \
        jmesh.auto_data_parallel(batch, n_dev)


@pytest.mark.parametrize("n,multiple", [(5, 1), (5, 2), (100, 8), (8, 8),
                                        (1, 3)], ids=str)
def test_pad_batch_rows_matches_jax(n, multiple):
    rng = np.random.RandomState(n)
    batch = {"a": rng.randn(n, 3).astype(np.float32),
             "b": rng.randint(0, 9, (n, 2, 2))}
    got, valid = tmesh.pad_batch_rows(batch, multiple)
    want, jvalid = jmesh.pad_batch_rows(batch, multiple)
    assert valid == jvalid == n
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert tcommon.pad_batch_rows is tmesh.pad_batch_rows


def test_process_log_path(monkeypatch):
    """As tests/test_multihost.py::test_process_log_path holds JAX's: rank 0
    and a plain process keep the name, rank N > 0 appends .procN."""
    assert tlogging.process_log_path("/x/log.txt") == "/x/log.txt"
    monkeypatch.setattr(tlogging, "process_index", lambda: 3)
    monkeypatch.setattr(jax, "process_index", lambda: 3)
    for path in ("/x/log.txt", "/x/log"):
        assert tlogging.process_log_path(path) == \
            jlogging.process_log_path(path)
    assert tlogging.process_log_path("/x/log.txt") == "/x/log.proc3.txt"


@pytest.mark.parametrize("n,size", [(100, 2), (7, 2), (1, 2), (10, 3)],
                         ids=str)
def test_row_indices_split_the_padded_rows(n, size):
    """The ranks' runs, in rank order, are pad_batch_rows' rows; the padded
    rows repeat row 0 and are the ones marked not real."""
    runs = [tmesh.DataParallel(None, r, size, torch.device("cpu"))
            .row_indices(n) for r in range(size)]
    padded, _ = tmesh.pad_batch_rows({"row": np.arange(n)}, size)
    np.testing.assert_array_equal(np.concatenate([r for r, _ in runs]),
                                  padded["row"])
    valid = np.concatenate([v for _, v in runs])
    assert valid.sum() == n and valid[:n].all()
    assert len({len(r) for r, _ in runs}) == 1


def test_without_a_group(monkeypatch):
    """A plain process: rank 0 of 1, -distributed is a no-op, no data axis;
    a trainer asked for 2 ranks raises as JAX's make_mesh; the evaluators'
    mesh is None whatever -data_parallel asks, as JAX's for one local
    device."""
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert (tmesh.process_index(), tmesh.process_count()) == (0, 1)
    np.testing.assert_array_equal(tmesh.process_shard(5), np.arange(5))
    assert tmesh.init_distributed("cpu") is None
    assert tmesh.data_parallel("cpu") is None
    assert tmesh.make_layout(-1, 1, "cpu") == (None, None)
    assert tmesh.make_layout(1, 1, "cpu") == (None, None)
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        tmesh.make_layout(2, 1, "cpu")
    for dp in (-1, 1, 2, 8):
        cfg = tcfg.GSTConfig(data_parallel=dp)
        assert tmesh.make_layout(cfg.data_parallel, cfg.model_parallel,
                                 torch.device("cpu"),
                                 every_rank=False) == (None, None)
    assert tcommon.primary_process_only()


def test_backend_follows_the_device(monkeypatch):
    monkeypatch.delenv(tmesh.BACKEND_ENV, raising=False)
    assert tmesh.backend_for("cpu") == "gloo"
    assert tmesh.backend_for("cuda:0") == "nccl"
    monkeypatch.setenv(tmesh.BACKEND_ENV, "gloo")
    assert tmesh.backend_for("cuda:0") == "gloo"
    monkeypatch.setenv(tmesh.BACKEND_ENV, "nccl")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tmesh.backend_for("cpu")
    monkeypatch.setenv(tmesh.BACKEND_ENV, "mpi")
    with pytest.raises(ValueError, match="use nccl or gloo"):
        tmesh.backend_for("cpu")


# ---------------------------------------------------------------------- #
# spawning a group
# ---------------------------------------------------------------------- #


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(name, tmp, cmd, world=2, extra_env=None, torchrun=False):
    """Launch ``world`` ranks of ``cmd`` (the arguments after the
    interpreter) over a fresh gloo group on the CPU, without waiting:
    through ``python -m torch.distributed.run`` (its agent serves the
    store), or as ``world`` processes given the launcher's environment by
    hand (rank 0 serves it).  Returns what :func:`finish` takes."""
    port = _free_port()
    base = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                GSTX_PLATFORM="cpu", OMP_NUM_THREADS="1",
                **(extra_env or {}))
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
                                       stderr=subprocess.STDOUT), log, path))
    return name, procs


def finish(started):
    """Wait for :func:`start`'s processes; every one must exit 0."""
    name, procs = started
    try:
        for p, _, _ in procs:
            p.wait(timeout=SPAWN_TIMEOUT)
    finally:
        for p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for i, (p, _, path) in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"process {i} of {name} exited "
                                 f"{p.returncode}:\n"
                                 f"{open(path).read()[-4000:]}")


def start_worker(task, spec, tmp, world=2, extra_env=None, torchrun=False):
    """:func:`start` on ``world`` ranks of the worker on ``task``."""
    tmp = os.path.join(tmp, f"spawn_{task}")
    os.makedirs(tmp)
    spec = dict(spec, out=os.path.join(tmp, task))
    spec_path = os.path.join(tmp, f"{task}.json")
    json.dump(spec, open(spec_path, "w"))
    return (start(task, tmp, [WORKER, task, spec_path], world, extra_env,
                  torchrun), spec["out"], world)


def worker_results(started):
    """Each rank's results of :func:`start_worker`'s ranks."""
    procs, out, world = started
    finish(procs)
    return [torch.load(f"{out}.rank{r}.pt", weights_only=False)
            for r in range(world)]


def test_nccl_refuses_two_ranks_on_one_device(launched):
    """Both ranks on cuda:0 under nccl: each raises, naming the ranks, and
    never falls back to gloo."""
    ranks = worker_results(launched["same_device"])
    for r in ranks:
        assert r["raised"] is not None
        assert "ranks [0, 1] all run on card" in r["raised"] and \
            ":GPU-shared (cuda:0 here)" in r["raised"], r["raised"]


def _card_check(monkeypatch, uuids):
    """:func:`gstx_torch.core.mesh._refuse_shared_devices` on one store
    for ranks whose cuda:0 is the card ``uuids[rank]`` (threads standing
    for the ranks): each rank's message, None where it passed."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            uuid=uuids[int(threading.current_thread().name)]))
    store = torch.distributed.HashStore()
    out = {}

    def rank(r):
        try:
            tmesh._refuse_shared_devices(store, r, len(uuids),
                                         torch.device("cuda", 0))
            out[r] = None
        except RuntimeError as e:
            out[r] = str(e)
    threads = [threading.Thread(target=rank, args=(r,), name=str(r))
               for r in range(len(uuids))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return out


def test_nccl_check_names_the_card_by_uuid(monkeypatch):
    """A launcher that gives each rank its own card through
    CUDA_VISIBLE_DEVICES shows every rank its card as cuda:0: the check
    tells the cards apart by UUID, and still refuses two ranks on one."""
    assert _card_check(monkeypatch, ["GPU-a", "GPU-b"]) == {0: None,
                                                            1: None}
    out = _card_check(monkeypatch, ["GPU-a", "GPU-b", "GPU-a"])
    assert out[1] is None
    for r in (0, 2):
        assert "ranks [0, 2] all run on card" in out[r] and \
            ":GPU-a (cuda:0 here)" in out[r], out[r]


# ---------------------------------------------------------------------- #
# one step on two ranks against one process and JAX
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """make_cli_env's data with dropout-free model JSONs, the JAX tiny
    params as a reference .ckpt and as the port's state dicts (full and
    encoder-only)."""
    tmp = str(tmp_path_factory.mktemp("port_mesh"))
    args, cfg = make_cli_env(tmp)
    for key in ("model_enc_config", "model_dec_config"):
        path = getattr(cfg, key)
        fields = json.load(open(path))
        fields.update({k: 0.0 for k in dataclasses.asdict(
            cfg.encoder_config() if key == "model_enc_config"
            else cfg.decoder_config()) if "dropout" in k})
        json.dump(fields, open(path, "w"))
    model, _, _ = j_build_model(cfg)
    params = jax.device_get(init_params(model, cfg, seed=0))
    ckpt = os.path.join(tmp, "ref.ckpt")
    torch.save({"model_state_dict": {
        "module." + k: torch.from_numpy(np.array(v))
        for k, v in to_torch_state_dict(params).items()}}, ckpt)
    enc = os.path.join(tmp, "enc.ckpt")
    pre = "encoder.bert_pretrained."
    sd = to_torch_state_dict(params)
    torch.save({"model_state_dict": {
        "module.bert_pretrained." + k[len(pre):]: torch.from_numpy(
            np.array(v)) for k, v in sd.items() if k.startswith(pre)}}, enc)
    states = {}
    for kind, full in (("gen", True), ("disc", False)):
        states[kind] = os.path.join(tmp, f"{kind}_state.pt")
        torch.save(state_dict_from_jax(params, with_decoder=full),
                   states[kind])
    return dict(tmp=tmp, args=args, cfg=cfg, params=params, ckpt=ckpt,
                states=states, eval_ckpts={"gen": ckpt, "disc": enc})


@pytest.fixture(scope="module", autouse=True)
def launched(env):
    """Every multi-rank run of the module, started together as the module
    starts, so that they run beside its in-process work:

      * two ranks on one CUDA device under nccl, which must be refused
        (:func:`test_nccl_refuses_two_ranks_on_one_device`);
      * one two-rank group, given the launcher's environment by hand: the
        training steps (:func:`steps`), then the training CLI runs
        (:func:`train_runs`) and the evaluators (:func:`eval_runs`), in
        turn;
      * three ranks through ``torch.distributed.run``, whose first CLI
        joins the agent's store (:func:`_three_rank_runs`);
      * the discriminative evaluator's CLI on two ranks through
        ``torch.distributed.run``, as the README launches it."""
    spec = {}
    for kind in ("gen", "disc"):
        path = os.path.join(env["tmp"], f"{kind}_batch.npz")
        np.savez(path, **_global_batch(env, kind))
        spec[kind] = {"config": dataclasses.asdict(_port_config(env["cfg"])),
                      "state": env["states"][kind], "batch": path}
    spec["runs"] = _train_run_specs(env) + _eval_run_specs(env)
    argv = _eval_argv(env, "disc", "torchrun_disc",
                      env["eval_ckpts"]["disc"]) + ["-distributed"]
    started = {"same_device": start_worker(
                   "same_device", {}, env["tmp"],
                   extra_env={tmesh.BACKEND_ENV: "nccl"}),
               "group": start_worker("group", spec, env["tmp"]),
               "three": start_worker("three",
                                     {"runs": _three_rank_runs(env)},
                                     env["tmp"], world=3, torchrun=True),
               "cli": start("torchrun_disc", env["tmp"],
                            ["-m", "gstx_torch.cli.evaluate_disc"] + argv,
                            torchrun=True)}
    yield started
    # a run no test waited for (a deselected test) ends with the module
    for procs in [started[k][0] for k in ("same_device", "group", "three")
                  ] + [started["cli"]]:
        for p, log, _ in procs[1]:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


@pytest.fixture(scope="module")
def group(launched):
    """Each rank's results of the two-rank group."""
    return worker_results(launched["group"])


STEP_IMAGES = 4   # the global batch: 2 images a rank
STEP_ROWS = 4     # rows drawn a step: 2 a rank


def _port_config(jcfg):
    return tcfg.GSTConfig(**dataclasses.asdict(jcfg)).replace(
        batch_size=STEP_ROWS)


def _global_batch(env, kind):
    tc = _port_config(env["cfg"])
    cls = {"gen": tvisdial.VisdialGenDataset,
           "disc": tvisdial.VisdialDiscDataset}[kind]
    ds = cls(tc, ttok.BertTokenizer(vocab_path=tc.vocab_path),
             mode="vd_train")
    batch = collate([ds.__getitem__(i, seed=i + 1)
                     for i in range(STEP_IMAGES)])
    if kind == "gen":
        # answers of 1 to 6 labelled tokens, row by row, so that the rows
        # two ranks compute carry different label counts
        labels = batch["dec_labels"]
        keep = 1 + np.arange(labels[..., 0].size).reshape(
            labels.shape[:-1]) % 6
        labels[np.arange(labels.shape[-1]) >= keep[..., None]] = 0
    return batch


def _single_step(env, kind):
    """The single-process step on the global batch: (loss(es), state)."""
    tc = _port_config(env["cfg"])
    full = kind == "gen"
    model, opt = ttrain.init_model_and_state(
        tc, 100, "cpu", use_decoder=full,
        warmup_steps=None if full else tdisc.DISC_WARMUP_STEPS)
    model.load_state_dict(torch.load(env["states"][kind], weights_only=True))
    batch = _global_batch(env, kind)
    step = ttrain.make_train_step(model, opt, STEP_ROWS) if full else \
        tdisc.make_disc_train_step(model, opt, tc)
    loss = step(batch, ttrain.iteration_generator(0, 3))
    return loss, model.state_dict()


@contextlib.contextmanager
def fixed_dropout_off():
    """The fusion's and the heads' fixed 0.1 dropout off (the model JSONs'
    rates are 0): a dropout-free step, whose rows' results do not depend
    on the rows beside them."""
    real = tencdec.FUSION_DROPOUT, theads.POOLED_DROPOUT
    tencdec.FUSION_DROPOUT = theads.POOLED_DROPOUT = 0.0
    try:
        yield
    finally:
        tencdec.FUSION_DROPOUT, theads.POOLED_DROPOUT = real


@pytest.fixture(scope="module")
def steps(env, request):
    """One generative and one discriminative step: on two ranks (each
    with its half of the global batch) and in one process, dropout-free
    (:func:`fixed_dropout_off` on both sides).  The single process's
    steps run while the ranks do."""
    with fixed_dropout_off():
        single = {kind: _single_step(env, kind) for kind in ("gen", "disc")}
    return request.getfixturevalue("group"), single


def _drawn_rows(env, kind):
    """The rows the step draws from the iteration's generator, as the step
    draws them (host numpy)."""
    batch = _global_batch(env, kind)
    gen = ttrain.iteration_generator(0, 3)
    if kind == "gen":
        idx = torch.multinomial(ttrain.candidate_weights(batch["dec_labels"]),
                                STEP_ROWS, replacement=True, generator=gen)
        return ttrain.select_rows(batch, idx.numpy())
    total = int(np.prod(batch["tokens"].shape[:3]))
    idx = torch.randperm(total, generator=gen)[:STEP_ROWS]
    return tdisc.select_rows(batch, idx.numpy())


@pytest.mark.parametrize("kind", ["gen", "disc"])
def test_two_rank_step_equals_one_process(env, steps, kind):
    ranks, single = steps
    want_loss, want_state = single[kind]
    assert all(r["backend"] == "gloo" for r in ranks)
    for r in ranks:
        loss, state = r[kind]
        if kind == "gen":
            assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
        else:
            for name in tdisc.LOSS_NAMES:
                assert abs(float(loss[name]) - float(want_loss[name])) \
                    <= LOSS_TOL, name
        assert state.keys() == want_state.keys()
        for k, v in want_state.items():
            torch.testing.assert_close(state[k], v, rtol=0, atol=PARAM_TOL,
                                       msg=k)
    before = torch.load(env["states"][kind], weights_only=True)
    moved = [k for k, v in want_state.items()
             if v.is_floating_point() and not torch.equal(v, before[k])]
    assert len(moved) > 10
    for k, v in ranks[0][kind][1].items():
        assert torch.equal(v, ranks[1][kind][1][k]), k


def _port_model(env, kind):
    tc = _port_config(env["cfg"])
    model, _ = ttrain.init_model_and_state(tc, 100, "cpu",
                                           use_decoder=kind == "gen")
    model.load_state_dict(torch.load(env["states"][kind], weights_only=True))
    return model


@pytest.mark.parametrize("kind", ["gen", "disc"])
def test_mean_of_local_means_misses_the_loss(env, steps, kind):
    """The control: each rank's loss divided by its own count, then
    averaged (plain DDP's normalisation) misses the step's loss."""
    rows = _drawn_rows(env, kind)
    model = _port_model(env, kind)
    tc = _port_config(env["cfg"])
    halves = [{k: v[h * 2:(h + 1) * 2] for k, v in rows.items()}
              for h in range(2)]
    local = []
    with torch.no_grad():
        for half in halves:
            dev = ttrain.rows_to_device(half, "cpu")
            local.append(float(ttrain.row_loss(model, dev, None))
                         if kind == "gen" else
                         float(tdisc.row_losses(model, dev, tc, None)["loss"]))
    loss = steps[0][0][kind][0]
    want = float(loss if kind == "gen" else loss["loss"])
    key = "dec_labels" if kind == "gen" else "mask"
    pad = 0 if kind == "gen" else -1
    counts = [int((h[key] != pad).sum()) for h in halves]
    assert counts[0] != counts[1]
    print(f"{kind}: label counts {counts}; mean of local means "
          f"{np.mean(local):.6f} against {want:.6f}")
    assert abs(np.mean(local) - want) > CONTROL_MISS


def _jax_gen_loss(env, rows):
    cfg = env["cfg"]
    model = JGST(cfg.encoder_config(), cfg.decoder_config())
    r = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
         for k, v in rows.items()}
    logits = model.apply(
        env["params"], r["enc_input_ids"], r["enc_image_feat"],
        r["enc_image_loc"], r["enc_segments"], r["enc_att_mask"],
        r["enc_image_mask"], r["dec_input_ids"], r["dec_att_mask"],
        deterministic=True, method=JGST.score)
    return {"loss": float(jax_loss(logits, r["dec_labels"]))}


def _jax_disc_losses(env, rows):
    cfg = env["cfg"]
    enc = cfg.encoder_config()
    model = JGST(enc, cfg.decoder_config(), use_decoder=False)
    params = {"params": {k: env["params"]["params"][k]
                         for k in ("encoder", "cls")}}
    att = jax_nsp_mask(jnp.asarray(rows["sep_indices"]),
                       jnp.asarray(rows["hist_len"]),
                       rows["tokens"].shape[-1])
    pred_t, pred_v, nsp = model.apply(
        params, jnp.asarray(rows["tokens"]), jnp.asarray(rows["image_feat"]),
        jnp.asarray(rows["image_loc"]), jnp.asarray(rows["segments"]), att,
        jnp.asarray(rows["image_mask"]), deterministic=True,
        method=JGST.pretrain_scores)
    out = {"lm_loss": float(jheads.masked_lm_loss(
               pred_t, jnp.asarray(rows["mask"]))),
           "img_loss": float(jheads.masked_img_loss(
               pred_v, jnp.asarray(rows["image_target"]),
               jnp.asarray(rows["image_label"]), enc.predict_feature)),
           "nsp_loss": float(jheads.soft_nsp_loss(
               nsp, jnp.asarray(rows["next_sentence_labels"])))}
    out["loss"] = (cfg.lm_loss_coeff * out["lm_loss"]
                   + cfg.nsp_loss_coeff * out["nsp_loss"]
                   + cfg.img_loss_coeff * out["img_loss"])
    return out


@pytest.mark.parametrize("kind", ["gen", "disc"])
def test_two_rank_loss_equals_jax_loss_fn(env, steps, kind):
    """The two-rank step's loss against JAX's loss_fn
    (gstx/train/train_gen.py:74-84, gstx/train/train_disc.py:44-57) on the
    same rows, dropout off."""
    rows = _drawn_rows(env, kind)
    want = _jax_gen_loss(env, rows) if kind == "gen" else \
        _jax_disc_losses(env, rows)
    loss = steps[0][0][kind][0]
    got = {"loss": float(loss)} if kind == "gen" else \
        {k: float(v) for k, v in loss.items()}
    for k, w in want.items():
        assert abs(got[k] - w) <= JAX_LOSS_TOL * abs(w), k


# ---------------------------------------------------------------------- #
# the training CLIs on two ranks: resume and checkpoints
# ---------------------------------------------------------------------- #


TRAIN_EPOCHS = 2   # 4 dialogs at batch 2: 2 steps an epoch, 4 a run


def _train_argv(env, save, extra=()):
    return env["args"] + ["-mode", "vd_train", "-model", "enc_dec_a",
                          "-batch_size", "2", "-num_epochs",
                          str(TRAIN_EPOCHS), "-log_every", "1",
                          "-save_path", os.path.join(env["tmp"], save),
                          "-distributed"] + list(extra)


def _train_run_specs(env):
    """The generative CLI uninterrupted for 4 steps; 2 steps saving the
    rotating checkpoint; a -continue from it for the rest; then every rank
    loads the uninterrupted run's final.ckpt as the trainer's resume
    does."""
    step_ckpt = os.path.join(env["tmp"], "half", "vd_train_step.ckpt")
    final = os.path.join(env["tmp"], "whole", "final.ckpt")
    return [
        {"module": "gstx_torch.cli.train_gen",
         "argv": _train_argv(env, "whole")},
        {"module": "gstx_torch.cli.train_gen",
         "argv": _train_argv(env, "half", ["-save_every_steps", "2"]),
         "max_steps": 2},
        {"module": "gstx_torch.cli.train_gen",
         "argv": _train_argv(env, "resumed", ["-start_path", step_ckpt,
                                              "-continue"])},
        {"load": _train_argv(env, "loaded", ["-start_path", final,
                                             "-continue"])},
    ]


@pytest.fixture(scope="module")
def train_runs(group):
    """Each rank's results of :func:`_train_run_specs`' runs."""
    return [{"runs": r["runs"][:4]} for r in group]


def test_two_rank_resume_equals_the_uninterrupted_run(env, train_runs):
    whole = tckpt.restore_checkpoint(
        os.path.join(env["tmp"], "whole", "final.ckpt"))
    resumed = tckpt.restore_checkpoint(
        os.path.join(env["tmp"], "resumed", "final.ckpt"))
    assert whole["step"] == resumed["step"] == 2 * TRAIN_EPOCHS - 1
    for k, v in whole["model_state_dict"].items():
        assert torch.equal(v, resumed["model_state_dict"][k]), k
    assert torch.equal(
        torch.cat([s["exp_avg"].reshape(-1) for s in
                   whole["optimizer_state_dict"]["state"].values()]),
        torch.cat([s["exp_avg"].reshape(-1) for s in
                   resumed["optimizer_state_dict"]["state"].values()]))
    for r in train_runs:
        for k, v in r["runs"][0]["result"].items():
            assert torch.equal(v, r["runs"][2]["result"][k]), k
    # rank 0 alone wrote the log, and the checkpoints
    names = os.listdir(os.path.join(env["tmp"], "whole"))
    assert "log_vd_train.txt" in names and \
        not any(".proc" in n for n in names)
    lines = open(os.path.join(env["tmp"], "whole", "metrics.jsonl")
                 ).read().splitlines()
    assert [json.loads(x)["step"] for x in lines] == \
        list(range(2 * TRAIN_EPOCHS))


def test_two_rank_checkpoint_loads_bit_for_bit(env, train_runs):
    """final.ckpt of the two-rank run equals each rank's replica, loads into
    both ranks through the trainer's resume, and into one process."""
    path = os.path.join(env["tmp"], "whole", "final.ckpt")
    saved = tckpt.restore_checkpoint(path)["model_state_dict"]
    for r in train_runs:
        replica = r["runs"][0]["result"]
        loaded = r["runs"][3]["result"]
        assert replica.keys() == loaded.keys() == saved.keys()
        for k, v in saved.items():
            assert torch.equal(v, replica[k]) and torch.equal(v, loaded[k]), k
    model = tcommon.build_model(tcommon.parse_config(
        _train_argv(env, "x")), device="cpu")
    tcommon.load_params(model, path)
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k


# ---------------------------------------------------------------------- #
# generation's shards against the JAX CLI's
# ---------------------------------------------------------------------- #


def _gen_argv(env, name):
    ckpt = env["ckpt"]
    return env["args"] + ["-mode", "vd_gen_val", "-start_path_q", ckpt,
                          "-start_path_a", ckpt, "-batch_size", "1",
                          "-num_dialog_rounds", "2", "-max_dec_len", "5",
                          "-top_k", "1", "-save_name", name]


@pytest.mark.parametrize("rank", [0, 1])
def test_generation_shards_match_the_jax_cli(env, monkeypatch, rank):
    """With _process_info patched to (rank, 2) in both packages, the
    port's name.procN shard holds the JAX CLI's records; the two shards
    reassemble every image once."""
    monkeypatch.setattr(tgenerate, "_process_info", lambda: (rank, 2))
    monkeypatch.setattr(jgenerate, "_process_info", lambda: (rank, 2))
    want = jgenerate.main(_gen_argv(env, "j_gen.json"))
    try:
        got = tgenerate.main(_gen_argv(env, "t_gen.json"), device="cpu")
    finally:
        kffn.enable(True)
    assert_same_records(got, want)
    save = env["cfg"].save_path
    shard = json.load(open(os.path.join(save, f"t_gen.proc{rank}.json")))
    assert shard == got and not os.path.exists(
        os.path.join(save, "t_gen.json"))
    assert [r["image_id"] for r in got] == [1000 + rank, 1002 + rank]
    if rank == 1:
        from gstx_torch.data.cc12m import load_dialog_json

        ids = [r["image_id"] for r in load_dialog_json(
            os.path.join(save, "t_gen.json"))]
        assert sorted(ids) == [1000, 1001, 1002, 1003]


# ---------------------------------------------------------------------- #
# the evaluators on two ranks
# ---------------------------------------------------------------------- #


EVAL_KINDS = {"gen": ("gstx_torch.cli.evaluate_gen", tgen_cli, jgen_cli,
                      jrank_gen, "make_chunk_scorer"),
              "disc": ("gstx_torch.cli.evaluate_disc", tdisc_cli, jdisc_cli,
                       jrank_disc, "make_nsp_scorer")}


def _eval_argv(env, kind, save, ckpt):
    extra = ["-model", "enc_only_a"] if kind == "disc" else []
    return env["args"] + ["-mode", "vd_eval_val", "-start_path", ckpt,
                          "-save_path", os.path.join(env["tmp"], save)] \
        + extra


def _recorded(module, fn, *a, **kw):
    """(the result of ``fn``, every batch's scores the port's evaluator
    gathered, concatenated)."""
    real = module.gather_scores
    scores = []

    def recording(*args, **kwargs):
        got = real(*args, **kwargs)
        scores.append(got.numpy().copy())
        return got
    module.gather_scores = recording
    try:
        return fn(*a, **kw), np.concatenate(scores)
    finally:
        module.gather_scores = real


def _eval_run_specs(env):
    """Both evaluators on the two ranks (-distributed, every rank)."""
    return [{"module": EVAL_KINDS[k][0],
             "argv": _eval_argv(env, k, f"two_{k}", env["eval_ckpts"][k])
             + ["-distributed"]} for k in EVAL_KINDS]


@pytest.fixture(scope="module")
def eval_runs(env, group):
    """Both evaluators: on two ranks (:func:`_eval_run_specs`), in one
    process, and the JAX CLIs (-data_parallel 1: one device) with their
    per-chunk scores recorded."""
    ckpts = env["eval_ckpts"]
    ranks = [{"runs": r["runs"][4:]} for r in group]
    out = {}
    for i, kind in enumerate(EVAL_KINDS):
        _, tcli, jcli, jrank, factory = EVAL_KINDS[kind]
        try:
            single = _recorded(trank_gen, tcli.main,
                               _eval_argv(env, kind, f"one_{kind}",
                                          ckpts[kind]), device="cpu")
        finally:
            kffn.enable(True)
        rec = []
        with pytest.MonkeyPatch.context() as m:
            _recording(m, jrank, factory, rec)
            jres = jcli.main(_eval_argv(env, kind, f"jax_{kind}",
                                        ckpts[kind])
                             + ["-data_parallel", "1"])
        out[kind] = dict(ranks=[r["runs"][i] for r in ranks], single=single,
                         jax=(jres, np.concatenate(rec)))
    return out


@pytest.mark.parametrize("kind", list(EVAL_KINDS))
def test_two_rank_evaluation_writes_the_single_process_metrics(
        env, eval_runs, kind):
    """Rank 0 gathers every score and alone writes the log, which is the
    single process's; rank 1 returns None."""
    run = eval_runs[kind]
    rank0, rank1 = run["ranks"]
    metrics, scores = run["single"]
    assert rank1["result"] is None and rank1["scores"] == []
    got = np.concatenate(rank0["scores"])
    assert got.shape == scores.shape == (4 * 10 * env["cfg"].num_options,)
    np.testing.assert_allclose(got, scores, rtol=0, atol=SCORE_TOL)
    assert rank0["result"] == metrics
    save = os.path.join(env["tmp"], f"two_{kind}")
    assert os.listdir(save) == ["performance_log.txt"]
    assert open(os.path.join(save, "performance_log.txt")).read() == \
        open(os.path.join(env["tmp"], f"one_{kind}",
                          "performance_log.txt")).read()


@pytest.mark.parametrize("kind", list(EVAL_KINDS))
def test_two_rank_evaluation_matches_the_jax_cli(env, eval_runs, kind):
    """Scores within tests/test_torch_port_eval.py's SCORE_TOL of the JAX
    CLI's; the metrics equal, up to the near-tied option pairs that test
    bounds (each moves one rank by one place)."""
    run = eval_runs[kind]
    got, (jres, jscores) = run["ranks"][0]["result"], run["jax"]
    scores = np.concatenate(run["ranks"][0]["scores"])
    np.testing.assert_allclose(scores, jscores, rtol=JAX_SCORE_TOL,
                               atol=JAX_SCORE_TOL)
    tc = _port_config(env["cfg"])
    cls = {"gen": tvisdial.VisdialGenDataset,
           "disc": tvisdial.VisdialDiscDataset}[kind]
    ds = cls(tc, ttok.BertTokenizer(vocab_path=tc.vocab_path),
             mode="vd_eval_val")
    batch = collate([ds.__getitem__(i, seed=0) for i in range(len(ds))])
    seqs = _option_groups(batch, kind)
    b, rounds = seqs.shape[:2]
    tied = compare_ranks(scores.reshape(seqs.shape[:3]),
                         jscores.reshape(seqs.shape[:3]), seqs)
    near_gt = int(tied[np.arange(b * rounds),
                       batch["gt_option_inds"].reshape(-1)].sum())
    dense = tied[np.arange(b) * rounds + batch["round_id"][:, 0] - 1]
    rel = batch["gt_relevance"] > 0
    near_rel = int((dense & (rel[:, :, None] | rel[:, None, :])).sum()) // 2
    print(f"{kind}: {int(tied.sum()) // 2} near-tied option pairs, "
          f"{near_gt} hold the gt option, {near_rel} a relevant one")
    assert got.keys() == jres.keys()
    for k in got:
        n, rows = (near_rel, b) if k == "ndcg" else (near_gt, b * rounds)
        assert abs(got[k] - jres[k]) <= n / rows, k


def _attack_argv(env, save):
    return env["args"] + ["-mode", "vd_eval_val", "-attack", "fgsm",
                          "-start_path", env["ckpt"], "-save_path",
                          os.path.join(env["tmp"], save)]


def _three_rank_runs(env):
    """The runs that :func:`test_three_ranks_take_the_first_data_parallel_
    ranks` checks."""
    argv = _eval_argv(env, "gen", "three", env["eval_ckpts"]["gen"]) + [
        "-distributed"]
    return [{"module": EVAL_KINDS["gen"][0], "argv": argv + [
                "-data_parallel", "2"]},
            {"module": EVAL_KINDS["gen"][0], "argv": argv + [
                "-data_parallel", "4"], "expect_error": True},
            {"module": "gstx_torch.cli.train_gen", "argv": _train_argv(
                env, "three_train", ["-data_parallel", "2"]),
             "expect_error": True},
            {"module": "gstx_torch.cli.evaluate_gen_attack",
             "argv": _attack_argv(env, "three_fgsm") + ["-distributed"]}]


def test_three_ranks_take_the_first_data_parallel_ranks(env, launched):
    """Three ranks: the evaluator under -data_parallel 2 splits over ranks
    0 and 1 (a subgroup, as JAX's mesh takes the first local devices) and
    rank 2 idles; -data_parallel 4 raises JAX's "needs 4 devices"; a
    trainer's -data_parallel 2 is not the world and raises as make_mesh;
    the FGSM evaluation over all three (each round's 10 options padded to
    12: rank 2 holds two padded rows, which take no step) writes one
    process's metrics."""
    ranks = worker_results(launched["three"])
    try:
        single = tattack_cli.main(_attack_argv(env, "one_fgsm"),
                                  device="cpu")
    finally:
        kffn.enable(True)
    attacked = [r["runs"][3]["result"] for r in ranks]
    assert attacked[0] == single and attacked[1:] == [None, None]
    assert os.listdir(os.path.join(env["tmp"], "three_fgsm")) == \
        ["performance_log.txt"]
    evaluated = [r["runs"][0] for r in ranks]
    assert evaluated[0]["result"] is not None and set(
        evaluated[0]["result"]) >= {"r@1", "mrr", "ndcg"}
    assert evaluated[1]["result"] is None and evaluated[1]["scores"] == []
    assert evaluated[2]["result"] is None and evaluated[2]["scores"] == []
    for r in ranks:
        assert "mesh 4x1 needs 4 devices, have 3 ranks" in r["runs"][1][
            "error"]
        assert "mesh 2x1 != 3 devices available" in r["runs"][2]["error"]


def test_torchrun_launches_a_cli_on_two_ranks(env, eval_runs, launched):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    gstx_torch.cli.evaluate_disc ... -distributed``: both ranks join the
    store the launcher's agent serves, over gloo, and rank 0 alone writes
    the single process's log."""
    finish(launched["cli"])
    save = os.path.join(env["tmp"], "torchrun_disc")
    assert os.listdir(save) == ["performance_log.txt"]
    assert open(os.path.join(save, "performance_log.txt")).read() == \
        open(os.path.join(env["tmp"], "one_disc",
                          "performance_log.txt")).read()
