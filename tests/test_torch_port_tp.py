"""Tensor parallelism in the port (-model_parallel > 1:
gstx_torch.core.mesh's model axis, gstx_torch.models.tensor_parallel, and
the engine, trainers, evaluators, attack evaluation, generation and demo
over a model group) against the JAX package and against one process, f32
on the CPU.

In-process: each parameter's partition class against JAX's
``param_partition_spec`` through the checkpoint bridge's name map,
``validate_model_parallel`` against JAX's, the shard / gather round trip
of a state dict and of the optimizer's moments, and a vocab that does not
divide by the degree.  One two-rank gloo group (``tests/torch_tp_rank.py``
through ``python -m torch.distributed.run``), started as the module
starts so that it runs beside the JAX work, does the rest.  Marked
``slow`` (four ranks each): the 2 x 2 data x model step, and four shards
with a vocab that does not divide by four.

Tolerances:

  * teacher-forced logits and loss over the group within 1e-4 of JAX f32
    (ROADMAP: the composed model); a row-parallel product that skips its
    all-reduce misses by more than 1e-2;
  * one training step over the group against one process's: the loss
    within 1e-5 relative and every updated parameter within JAX's own TP
    pin, rtol 2e-5 / atol 2e-6 (tests/test_tensor_parallel.py:68-84),
    dropout-free and with the reference dropout (full-shape masks);
  * the checkpoint written at -model_parallel 2: full tensors, whose
    logits in one process and in JAX are the group's within 1e-5 / 1e-4;
  * greedy f32 engine tokens identical to JAX's, static and dynamic
    buckets (tests/test_dialog_engine_mesh.py:141-169), perplexities
    within 1e-4 relative;
  * evaluate_gen's scores within tests/torch_port_harness.py's SCORE_TOL
    of the JAX CLI's; the attack evaluation's and generation's results
    equal to one process's; the greedy REPL transcript equal to JAX's.
"""

import contextlib
import dataclasses
import io
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_harness import (SCORE_TOL as JAX_SCORE_TOL, compare_ranks,
                                finish, option_groups, record_scores, start,
                                stop)
from fixtures import make_cli_env, make_gen_batch
from gstx.cli import evaluate_gen as jgen_cli
from gstx.cli import inference as jinference
from gstx.cli.common import build_model as j_build_model
from gstx.cli.common import init_params
from gstx.core import checkpoint as jckpt
from gstx.core import config as jcfg
from gstx.core import mesh as jmesh
from gstx.core.checkpoint import to_torch_state_dict
from gstx.decode import sampler as jsampler
from gstx.decode.dialog_engine import make_dialog_engine as j_make_engine
from gstx.eval import rank_gen as jrank_gen
from gstx.models.encdec import GSTVisualDialog as JGST
from gstx.models.encdec import teacher_forced_loss as j_loss
from gstx_torch.cli import evaluate_disc as tdisc_cli
from gstx_torch.cli import evaluate_gen as tgen_cli
from gstx_torch.cli import evaluate_gen_attack as tattack_cli
from gstx_torch.cli import generate as tgenerate
from gstx_torch.cli import train_disc as tdisc_train_cli
from gstx_torch.cli import train_gen as ttrain_cli
from gstx_torch.core import checkpoint as tckpt
from gstx_torch.core import config as tcfg
from gstx_torch.core import mesh as tmesh
from gstx_torch.core.checkpoint import state_dict_from_jax
from gstx_torch.data import tokenizer as ttok
from gstx_torch.data import visdial as tvisdial
from gstx_torch.data.loader import collate
from gstx_torch.eval import rank_gen as trank_gen
from gstx_torch.kernels import ffn as kffn
from gstx_torch.models import encdec as tencdec
from gstx_torch.models.encdec import GSTVisualDialog
from gstx_torch.train import optim as toptim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_tp_rank.py")
JAX_TOL = 1e-4        # the composed model against JAX f32
CONTROL_MISS = 1e-2   # a skipped all-reduce misses by more
LOSS_RTOL = 1e-5
STEP_RTOL, STEP_ATOL = 2e-5, 2e-6   # tests/test_tensor_parallel.py:80
CKPT_TOL = 1e-5
MOMENT_ATOL = 1e-8    # the gradients' f32 summation order, at ~1e-3
PPL_TOL = 1e-4
STEP_IMAGES = 4
STEP_ROWS = 4
QUESTIONS = ["is there a dog", "what color is it"]
MP = 2


# ---------------------------------------------------------------------- #
# in process
# ---------------------------------------------------------------------- #


def _jax_partition_dims(params):
    """Each port state-dict name with the port dimension JAX's
    ``param_partition_spec`` shards its leaf on (None: replicated): every
    leaf is filled with its index along its sharded JAX dimension (a
    constant when replicated) and sent through the checkpoint bridge, so
    the transposes and the QKV splits carry the dimension along."""
    def mark(path, leaf):
        keys = "/".join(getattr(k, "key", str(k)) for k in path)
        spec = jmesh.param_partition_spec(keys)
        shape = np.shape(leaf)
        dims = [d for d, axis in enumerate(spec) if axis is not None]
        if not dims:
            return np.zeros(shape, np.float32)
        idx = np.arange(shape[dims[0]], dtype=np.float32) + 1
        return np.broadcast_to(idx.reshape([-1 if d == dims[0] else 1
                                            for d in range(len(shape))]),
                               shape).copy()
    marked = jax.tree_util.tree_map_with_path(mark, params)
    out = {}
    for name, t in state_dict_from_jax(marked).items():
        varies = [d for d in range(t.dim())
                  if t.shape[d] > 1 and not torch.equal(
                      t, t.narrow(d, 0, 1).expand_as(t))]
        assert len(varies) <= 1, name
        out[name] = varies[0] if varies else None
    return out


def test_partition_classes_match_jax(tiny_params):
    """Every port parameter shards on the dimension JAX's
    param_partition_spec shards its counterpart on; the classes cover the
    vocab rows, the column- and the row-parallel products."""
    _, _, params = tiny_params
    want = _jax_partition_dims(params)
    kinds = {}
    for name, dim in want.items():
        assert tmesh.partition_dim(name) == dim, name
        kinds.setdefault(tmesh.param_partition(name), 0)
        kinds[tmesh.param_partition(name)] += 1
    assert set(kinds) == {None, tmesh.VOCAB, tmesh.COLUMN, tmesh.ROW}
    assert tmesh.param_partition(
        "encoder.bert_pretrained.bert.encoder.c_layer.0.biOutput."
        "q_dense1.weight") is None


def _outcome(fn, *a):
    try:
        return fn(*a)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_validate_model_parallel_matches_jax(degree):
    """The same raises and messages as JAX's, on the tiny configs, the
    production ones and the encoder alone."""
    for enc, dec in ((jcfg.EncoderConfig(), jcfg.DecoderConfig()),
                     _tiny_jax_configs()):
        tenc = tcfg.EncoderConfig(**dataclasses.asdict(enc))
        tdec = tcfg.DecoderConfig(**dataclasses.asdict(dec))
        for j_dec, t_dec in ((dec, tdec), (None, None)):
            assert _outcome(tmesh.validate_model_parallel, tenc, t_dec,
                            degree) == _outcome(
                jmesh.validate_model_parallel, enc, j_dec, degree)
    assert _outcome(tmesh.validate_model_parallel, tcfg.EncoderConfig(),
                    tcfg.DecoderConfig(), 3)[1].startswith(
        "model_parallel=3 does not divide v_num_attention_heads=8")


def _tiny_jax_configs():
    from fixtures import tiny_enc_dec_configs
    return tiny_enc_dec_configs()


def _fake_group(rank, size):
    """A model group that is never asked for a collective: the shards of
    a model built in this process."""
    return tmesh.ModelGroup(None, rank, size, torch.device("cpu"))


@pytest.fixture(scope="module")
def tiny_params():
    enc, dec = _tiny_jax_configs()
    from fixtures import init_tiny_params
    return enc, dec, jax.device_get(init_tiny_params(enc, dec, seed=0))


def test_shard_and_gather_round_trip_is_exact(tiny_params):
    """Each rank's model (built from the seed, then sharded) holds
    shard_state_dict's slices of the one-process model; concatenating
    the ranks' slices on each tensor's dimension gives the full tensors
    bit for bit; a full state dict loads by slicing; the optimizer's
    moments round-trip the same way."""
    enc, dec, params = tiny_params
    tenc = tcfg.EncoderConfig(**dataclasses.asdict(enc))
    tdec = tcfg.DecoderConfig(**dataclasses.asdict(dec))
    full = GSTVisualDialog(tenc, tdec, device="cpu", seed=5).state_dict()
    shards = []
    for m in range(MP):
        model = GSTVisualDialog(tenc, tdec, device="cpu", seed=5,
                                tp=_fake_group(m, MP))
        assert model.vocab_tp is not None
        got = {k: v.clone() for k, v in model.state_dict().items()}
        want = tmesh.shard_state_dict(full, MP, m)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
        shards.append(got)
        loaded = state_dict_from_jax(params)
        model.load_state_dict(loaded)
        for k, v in tmesh.shard_state_dict(loaded, MP, m).items():
            assert torch.equal(model.state_dict()[k], v), k
    sharded = 0
    for k, v in full.items():
        dim = tmesh.shard_dim(k, v.shape, MP)
        parts = [s[k] for s in shards]
        back = parts[0] if dim is None else torch.cat(parts, dim)
        assert torch.equal(back, v), k
        sharded += dim is not None
    assert sharded > len(full) // 3
    model = GSTVisualDialog(tenc, tdec, device="cpu", seed=5)
    opt = toptim.AdamW(model.named_parameters(), 1e-4, 1e-4, 10, 100)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    osd = opt.state_dict()
    shapes = {k: v.shape for k, v in full.items()}
    parts = [tckpt.shard_optimizer_state(osd, types.SimpleNamespace(
        tp=_fake_group(m, MP), _full_shapes=shapes)) for m in range(MP)]
    names = {i: n for g in osd["param_groups"]
             for i, n in zip(g["params"], g["names"])}
    for i, state in osd["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            dim = tmesh.shard_dim(names[i], state[key].shape, MP)
            got = [p["state"][i][key] for p in parts]
            back = got[0] if dim is None else torch.cat(got, dim)
            assert torch.equal(back, state[key]), (names[i], key)


def test_a_vocab_that_does_not_divide_stays_whole():
    """30,522 words at -model_parallel 4, as JAX's shard_by_path: every
    vocab tensor stays whole on every rank, with one message per tensor
    tail, while the transformer's products still shard."""
    enc, dec = _tiny_jax_configs()
    tenc = tcfg.EncoderConfig(**dict(dataclasses.asdict(enc),
                                     vocab_size=30522))
    tdec = tcfg.DecoderConfig(**dict(dataclasses.asdict(dec),
                                     vocab_size=30522))
    full = GSTVisualDialog(tenc, tdec, device="cpu", seed=1).state_dict()
    vocab = [k for k in full if tmesh.param_partition(k) == tmesh.VOCAB]
    tails = {".".join(k.split(".")[-2:]) for k in vocab}
    for m in range(4):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            model = GSTVisualDialog(tenc, tdec, device="cpu", seed=1,
                                    tp=_fake_group(m, 4))
        lines = buf.getvalue().splitlines()
        assert len(lines) == len(tails)
        assert all("dimension not divisible by model_parallel=4; tensor "
                   "replicated" in line for line in lines)
        assert model.vocab_tp is None
        got = model.state_dict()
        for k in vocab:
            assert torch.equal(got[k], full[k]), k
        q = "encoder.bert_pretrained.bert.encoder.layer.0.attention.self." \
            "query.weight"
        assert got[q].shape[0] == full[q].shape[0] // 4
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tmesh.shard_state_dict(full, 4, m)
        assert len(buf.getvalue().splitlines()) == len(tails)


def test_a_sharded_site_declines_the_fused_kernels(tiny_params):
    """The layer's gate sees its own group: a sharded projection declines
    fused_ffn / fused_dense_ln whatever the switch and the widths say."""
    from gstx_torch.models import layers
    from gstx_torch.models import tensor_parallel as tpar

    enc, dec, _ = tiny_params
    model = GSTVisualDialog(tcfg.EncoderConfig(**dataclasses.asdict(enc)),
                            tcfg.DecoderConfig(**dataclasses.asdict(dec)),
                            device="cpu", tp=_fake_group(0, MP))
    layer = model.bert.encoder.layer[0]
    assert tpar.sharded(layer.output.dense)
    assert tpar.sharded(layer.attention.output.dense)
    x = torch.zeros(2, 128, dtype=torch.bfloat16)
    assert kffn.is_enabled() and layers._fusable(x, 128, 256)
    assert not layers._fusable(x, 128, 256, sharded=True)
    assert layer.attention.num_heads == enc.num_attention_heads // MP
    assert model.dec.local_heads == dec.num_attention_heads // MP


@pytest.mark.parametrize("cli", ["train_gen", "evaluate_gen", "generate"])
def test_a_degree_that_does_not_divide_raises_jax_message(env, cli):
    """-model_parallel 3 raises JAX's validate_model_parallel message
    before any work."""
    module = {"train_gen": ttrain_cli, "evaluate_gen": tgen_cli,
              "generate": tgenerate}[cli]
    argv = env["args"] + {"train_gen": ["-mode", "vd_train"],
                          "evaluate_gen": ["-mode", "vd_eval_val",
                                           "-start_path", env["ckpt"]],
                          "generate": _gen_flags(env, "mp3.json")}[cli]
    want = _outcome(jmesh.validate_model_parallel,
                    env["cfg"].encoder_config(), env["cfg"].decoder_config(),
                    3)
    try:
        with pytest.raises(ValueError) as got:
            module.main(argv + ["-model_parallel", "3"], device="cpu")
    finally:
        kffn.enable(True)
    assert ("ValueError", str(got.value)) == want


# ---------------------------------------------------------------------- #
# the two-rank group
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """make_cli_env's data and model JSONs (dropout 0.1), dropout-free
    copies of the JSONs, the JAX params (seed 0; an answerer of seed 1)
    as a reference .ckpt and as the port's state dicts."""
    tmp = str(tmp_path_factory.mktemp("port_tp"))
    args, cfg = make_cli_env(tmp)
    quiet = {}
    for key in ("model_enc_config", "model_dec_config"):
        fields = json.load(open(getattr(cfg, key)))
        fields.update({k: 0.0 for k in dataclasses.asdict(
            cfg.encoder_config() if key == "model_enc_config"
            else cfg.decoder_config()) if "dropout" in k})
        quiet[key] = os.path.join(tmp, f"quiet_{key}.json")
        json.dump(fields, open(quiet[key], "w"))
    model, _, _ = j_build_model(cfg)
    params = [jax.device_get(init_params(model, cfg, seed=s))
              for s in (0, 1)]
    ckpt = os.path.join(tmp, "ref.ckpt")
    torch.save({"model_state_dict": {
        k: torch.from_numpy(np.array(v))
        for k, v in to_torch_state_dict(params[0]).items()}}, ckpt)
    states = {}
    for name, p, full in (("gen", params[0], True), ("gen_a", params[1], True),
                          ("disc", params[0], False)):
        states[name] = os.path.join(tmp, f"{name}_state.pt")
        torch.save(state_dict_from_jax(p, with_decoder=full), states[name])
    return dict(tmp=tmp, args=args, cfg=cfg, quiet=quiet, params=params,
                ckpt=ckpt, states=states)


def _port_config(cfg, quiet=None):
    tc = tcfg.GSTConfig(**dataclasses.asdict(cfg)).replace(
        batch_size=STEP_ROWS)
    return tc if quiet is None else tc.replace(**quiet)


def _step_batch(env, kind):
    tc = _port_config(env["cfg"])
    cls = {"gen": tvisdial.VisdialGenDataset,
           "disc": tvisdial.VisdialDiscDataset}[kind]
    ds = cls(tc, ttok.BertTokenizer(vocab_path=tc.vocab_path),
             mode="vd_train")
    return collate([ds.__getitem__(i, seed=i + 1)
                    for i in range(STEP_IMAGES)])


def _score_batch(enc):
    rng = np.random.RandomState(0)
    b, length, regions, t = 3, 12, 5, 7
    att = np.ones((b, length), np.int64)
    att[0, 9:] = 0
    dec_att = np.ones((b, t), np.int64)
    dec_att[1, 5:] = 0
    return dict(
        input_ids=rng.randint(1, enc.vocab_size, (b, length)),
        image_feat=rng.randn(b, regions, enc.v_feature_size).astype(
            np.float32),
        image_loc=rng.rand(b, regions, enc.v_loc_size).astype(np.float32),
        token_type_ids=np.zeros((b, length), np.int64),
        attention_mask=att,
        image_attention_mask=np.ones((b, regions), np.int64),
        dec_input_ids=rng.randint(1, enc.vocab_size, (b, t)),
        dec_attention_mask=dec_att)


def _gen_flags(env, save_name):
    return ["-mode", "vd_gen_val", "-start_path_q", env["ckpt"],
            "-start_path_a", env["ckpt"], "-batch_size", "2",
            "-num_dialog_rounds", "2", "-max_dec_len", "5", "-top_k", "1",
            "-save_name", save_name]


def _attack_flags(env, save, attack):
    return ["-mode", "vd_eval_val", "-start_path", env["ckpt"],
            "-save_path", os.path.join(env["tmp"], save), "-attack", attack,
            "-mask_prob", "0.3"]


def _argvs(env, tag):
    """The CLI runs' arguments, for the group (tag "tp", -distributed
    -model_parallel 2) and for one process (tag "one")."""
    extra = ["-distributed", "-model_parallel", str(MP)] \
        if tag == "tp" else ["-data_parallel", "1"]
    a = env["args"]
    return {
        "eval_argv": a + ["-mode", "vd_eval_val", "-start_path", env["ckpt"],
                          "-save_path", os.path.join(env["tmp"],
                                                     f"eval_{tag}")] + extra,
        "eval_disc_argv": a + ["-mode", "vd_eval_val", "-model",
                               "enc_only_a", "-start_path", env["ckpt"],
                               "-save_path", os.path.join(
                                   env["tmp"], f"eval_disc_{tag}")] + extra,
        # the models' dropout on: over one replica the group draws one
        # process's masks
        "train_disc_argv": a + ["-mode", "vd_train", "-model", "enc_only_a",
                                "-start_path", env["ckpt"], "-batch_size",
                                "2", "-log_every", "1", "-save_path",
                                os.path.join(env["tmp"], f"train_{tag}")]
        + (["-distributed", "-model_parallel", str(MP)] if tag == "tp"
           else []),
        "attack_argv": a + _attack_flags(env, f"attack_{tag}", "fgsm")
        + extra,
        "token_argv": a + _attack_flags(env, f"token_{tag}", "random_token")
        + extra,
        "generate_argv": a + _gen_flags(env, f"gen_{tag}.json") + extra,
        "repl_argv": a + ["-start_path", env["ckpt"], "-top_k", "1",
                          "-max_dec_len", "6"] + extra}


@pytest.fixture(scope="module", autouse=True)
def launched(env):
    """The two-rank group, started as the module starts."""
    tc, cfg = _port_config(env["cfg"]), env["cfg"]
    enc = dataclasses.asdict(tc.encoder_config())
    dec = dataclasses.asdict(tc.decoder_config())
    paths = {}
    for name, batch in (("score", _score_batch(cfg.encoder_config())),
                        ("gen_step", _step_batch(env, "gen")),
                        ("disc_step", _step_batch(env, "disc")),
                        ("engine", make_gen_batch(cfg.encoder_config(), b=4,
                                                  seq_len=32, regions=7,
                                                  cap_len=14))):
        paths[name] = os.path.join(env["tmp"], f"{name}.npz")
        np.savez(paths[name], **batch)
    quiet = _port_config(cfg, env["quiet"])
    spec = dict(
        parts=["forward", "steps", "engine", "clis"], enc=enc, dec=dec,
        state=env["states"]["gen"], state_a=env["states"]["gen_a"],
        batch=paths["score"], gen_batch=paths["engine"],
        ckpt=os.path.join(env["tmp"], "tp_step.ckpt"),
        gen=dict(config=dataclasses.asdict(quiet),
                 config_dropout=dataclasses.asdict(tc),
                 state=env["states"]["gen"], batch=paths["gen_step"]),
        disc=dict(config=dataclasses.asdict(quiet),
                  state=env["states"]["disc"], batch=paths["disc_step"]),
        wide_enc=dict(hidden_size=128, num_attention_heads=2,
                      intermediate_size=256),
        wide_dec=dict(hidden_size=128, num_attention_heads=2,
                      intermediate_size=256),
        questions=QUESTIONS, max_turns=len(QUESTIONS), **_argvs(env, "tp"))
    started = start("tp", *_worker_cmd(env, "spawn", spec), MP,
                    torchrun=True)
    yield started, spec
    stop(started)  # a test that never waits for the ranks ends them here


def _worker_cmd(env, name, spec):
    """Write ``spec`` into a directory ``name`` of its own, with the path
    of the ranks' results: (the directory, the worker's command)."""
    tmp = os.path.join(env["tmp"], name)
    os.makedirs(tmp)
    spec["out"] = os.path.join(tmp, "tp")
    path = os.path.join(tmp, "spec.json")
    json.dump(spec, open(path, "w"))
    return tmp, [WORKER, path]


@pytest.fixture(scope="module")
def ranks(launched):
    started, spec = launched
    finish(started)
    return [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False)
            for r in range(MP)]


def test_logits_and_loss_match_jax(env, ranks):
    """Both ranks' gathered logits within 1e-4 of JAX's f32 score, the
    vocab-parallel loss within 1e-5 relative of JAX's; the control (the
    row-parallel products not all-reduced) misses by more than 1e-2."""
    b = {k: jnp.asarray(v) for k, v in _score_batch(
        env["cfg"].encoder_config()).items()}
    model = JGST(env["cfg"].encoder_config(), env["cfg"].decoder_config())
    want = np.asarray(model.apply(env["params"][0], *b.values(),
                                  method=JGST.score))
    labels = jnp.roll(b["dec_input_ids"], -1, 1)
    want_loss = float(j_loss(jnp.asarray(want), labels))
    for r in ranks:
        out = r["forward"]
        assert r["backend"] == "gloo" and out["vocab_sharded"]
        assert out["word_rows"] == env["cfg"].encoder_config().vocab_size \
            // MP
        got = out["logits"].numpy()
        np.testing.assert_allclose(got, want, rtol=JAX_TOL, atol=JAX_TOL)
        np.testing.assert_allclose(float(out["loss"]), want_loss,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got, out["single_logits"].numpy(),
                                   rtol=JAX_TOL, atol=JAX_TOL)
        miss = np.abs(out["control_logits"].numpy() - want).max()
        print(f"control: {miss:.4g}")
        assert miss > CONTROL_MISS


@pytest.mark.parametrize("kind", ["gen", "disc", "gen_dropout"])
def test_training_step_equals_one_process(ranks, kind):
    """One step over the model group against one process's on the same
    batch and generator: the loss(es) within 1e-5 relative, every
    gathered parameter within JAX's TP pin, the gradient norms (sharded
    squares summed over the group) within it too.  ``disc`` runs under
    remat ``full``, ``gen_dropout`` the models' dropout (0.1) under remat
    ``small``: a recomputed region's forward all-reduces run again in the
    backward, and the ranks draw the full-shape masks and keep their
    heads."""
    for r in ranks:
        got, want = r["steps"][kind]["tp"], r["steps"][kind]["one"]
        losses = got["loss"] if isinstance(got["loss"], dict) else \
            {"loss": got["loss"]}
        wants = want["loss"] if isinstance(want["loss"], dict) else \
            {"loss": want["loss"]}
        for k in wants:
            np.testing.assert_allclose(float(losses[k]), float(wants[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
        assert got["state"].keys() == want["state"].keys()
        for k, v in want["state"].items():
            np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(),
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=k)
        assert got["norms"].keys() == want["norms"].keys()
        for k, v in want["norms"].items():
            np.testing.assert_allclose(got["norms"][k], v, rtol=1e-4,
                                       atol=STEP_ATOL, err_msg=k)
    for k, v in ranks[0]["steps"][kind]["tp"]["state"].items():
        assert torch.equal(v, ranks[1]["steps"][kind]["tp"]["state"][k]), k


def test_checkpoint_written_at_two_loads_in_one_process_and_jax(env,
                                                                ranks):
    """The -model_parallel 2 checkpoint holds full tensors and the full
    AdamW moments: in one process (port and JAX) it gives the group's
    logits, and its moments are one process's step's."""
    path = os.path.join(env["tmp"], "tp_step.ckpt")
    raw = tckpt.restore_checkpoint(path)
    sd = tckpt.state_dict_of(raw)
    tc = _port_config(env["cfg"])
    model = GSTVisualDialog(tc.encoder_config(), tc.decoder_config(),
                            device="cpu").eval()
    model.load_state_dict(sd, strict=True)
    b = _score_batch(env["cfg"].encoder_config())
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want = ranks[0]["steps"]["gen"]["ckpt_logits"].numpy()
    with torch.no_grad():
        got = model.score(*tb.values()).numpy()
    np.testing.assert_allclose(got, want, rtol=CKPT_TOL, atol=CKPT_TOL)
    jmodel = JGST(env["cfg"].encoder_config(), env["cfg"].decoder_config())
    tree = jckpt.convert_torch_state_dict(
        jckpt.load_torch_checkpoint(path),
        *(lambda e, d: (e.num_hidden_layers, e.v_num_hidden_layers,
                        len(e.v_biattention_id), d.num_hidden_layers))(
            env["cfg"].encoder_config(), env["cfg"].decoder_config()))
    jgot = np.asarray(jmodel.apply({"params": tree}, *map(jnp.asarray,
                                                          b.values()),
                                   method=JGST.score))
    np.testing.assert_allclose(jgot, want, rtol=JAX_TOL, atol=JAX_TOL)
    one = ranks[0]["steps"]["gen"]["optimizer"]
    osd = raw["optimizer_state_dict"]
    assert osd["param_groups"] == one["param_groups"]
    # after one step both moments scale like the gradient (m = 0.1 g,
    # sqrt(v) = 0.0316 |g|), whose entries are ~1e-3: compared there
    for i, state in one["state"].items():
        for k, f in (("exp_avg", lambda t: t), ("exp_avg_sq", torch.sqrt)):
            np.testing.assert_allclose(f(osd["state"][i][k]).numpy(),
                                       f(state[k]).numpy(), rtol=STEP_RTOL,
                                       atol=MOMENT_ATOL, err_msg=f"{i} {k}")


@pytest.fixture(scope="module")
def jax_dialogs(env):
    """JAX's greedy engine on the batch the ranks ran (seq 32: the context
    overflows in round 2)."""
    cfg = env["cfg"]
    enc, dec = cfg.encoder_config(), cfg.decoder_config()
    batch = make_gen_batch(enc, b=4, seq_len=32, regions=7, cap_len=14)
    out = {}
    for name, kw in (("static", dict(context_buckets=(24,))),
                     ("dynamic", dict(context_buckets=(20, 28),
                                      dynamic_buckets=True))):
        run = j_make_engine(
            JGST(enc, dec), dec, num_rounds=3,
            q_settings=jsampler.DecodeSettings(max_steps=5, top_k=1,
                                               ngram_blocking_size=4),
            a_settings=jsampler.DecodeSettings(max_steps=5, top_k=1,
                                               ngram_blocking_size=0), **kw)
        out[name] = run(env["params"][0], env["params"][1],
                        {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(11))
    return out


@pytest.mark.parametrize("buckets", ["static", "dynamic"])
def test_greedy_engine_matches_jax(ranks, jax_dialogs, buckets):
    want = jax_dialogs[buckets]
    for r in ranks:
        got = r["engine"][buckets]
        for k in ("questions", "answers", "abnormal"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(getattr(want, k)), k)
        np.testing.assert_allclose(got["answer_ppl"].numpy(),
                                   np.asarray(want.answer_ppl),
                                   rtol=PPL_TOL, atol=PPL_TOL)
    assert np.asarray(want.abnormal).any()


def test_int8_memory_runs_the_decode_kernel_on_the_rank_heads(ranks):
    """Under -quantize_memory with the decode kernel's switch on, every
    decode step of every decoder layer goes through
    quant_decode_attention, on the rank's H / 2 heads (the JAX gate
    declines under TP; the port shards by head, so the kernel applies);
    both ranks decode the same tokens."""
    for r in ranks:
        got = r["engine"]["int8"]
        assert got["steps"] > 0
        assert got["quant"] == got["layers"] * got["steps"]
    assert torch.equal(ranks[0]["engine"]["int8"]["answers"],
                       ranks[1]["engine"]["int8"]["answers"])


def test_fused_kernels_declined_under_tensor_parallelism(ranks):
    """A bf16 forward at width 128: the fused FFN / projection-LayerNorm
    sites run in one process and never over the model group."""
    for r in ranks:
        calls = r["engine"]["fused_calls"]
        assert calls["tp"] == 0 and calls["one"] > 0, calls


@pytest.fixture(scope="module")
def one_process(env):
    """The CLI runs in one process, with the generative evaluator's
    scores recorded; JAX's evaluator CLI (-data_parallel 1) with its
    per-chunk scores; JAX's REPL transcript."""
    argv = _argvs(env, "one")
    out = {}
    scores = []
    real = trank_gen.gather_scores

    def recording(*a, **kw):
        got = real(*a, **kw)
        scores.append(got.numpy().copy())
        return got
    trank_gen.gather_scores = recording
    try:
        out["eval"] = (tgen_cli.main(argv["eval_argv"], device="cpu"),
                       np.concatenate(scores))
        scores.clear()
        out["eval_disc"] = (tdisc_cli.main(argv["eval_disc_argv"],
                                           device="cpu"),
                            np.concatenate(scores))
        stats = {}
        tdisc_train_cli.main(argv["train_disc_argv"], max_steps=2,
                             device="cpu", stats_out=stats)
        out["train_disc"] = stats["losses"]
        out["attack"] = tattack_cli.main(argv["attack_argv"], device="cpu")
        out["token"] = tattack_cli.main(argv["token_argv"], device="cpu")
        out["generate"] = tgenerate.main(argv["generate_argv"],
                                         device="cpu")
    finally:
        trank_gen.gather_scores = real
        kffn.enable(True)
    rec = []
    with pytest.MonkeyPatch.context() as m:
        record_scores(m, jrank_gen, "make_chunk_scorer", rec)
        jres = jgen_cli.main(env["args"] + [
            "-mode", "vd_eval_val", "-start_path", env["ckpt"],
            "-save_path", os.path.join(env["tmp"], "eval_jax"),
            "-data_parallel", "1"])
    out["jax_eval"] = (jres, np.concatenate(rec))
    asked = iter(QUESTIONS)

    def scripted(prompt):
        try:
            return next(asked)
        except StopIteration:
            raise EOFError
    transcript = []
    jinference.main(env["args"] + ["-start_path", env["ckpt"], "-top_k", "1",
                                   "-max_dec_len", "6", "-data_parallel",
                                   "1"],
                    input_fn=scripted, output_fn=transcript.append,
                    max_turns=len(QUESTIONS))
    out["jax_transcript"] = transcript
    return out


def test_evaluate_gen_matches_the_jax_cli(env, ranks, one_process):
    """-model_parallel 2 on two ranks: rank 0's scores within SCORE_TOL of
    the JAX CLI's and of one process's, its metrics one process's, and
    the log written once, by rank 0."""
    rank0, rank1 = (r["clis"]["eval"] for r in ranks)
    got = np.concatenate(rank0["scores"])
    metrics, scores = one_process["eval"]
    jres, jscores = one_process["jax_eval"]
    np.testing.assert_allclose(got, jscores, rtol=JAX_SCORE_TOL,
                               atol=JAX_SCORE_TOL)
    np.testing.assert_allclose(got, scores, rtol=JAX_SCORE_TOL,
                               atol=JAX_SCORE_TOL)
    tc = _port_config(env["cfg"])
    ds = tvisdial.VisdialGenDataset(
        tc, ttok.BertTokenizer(vocab_path=tc.vocab_path), mode="vd_eval_val")
    batch = collate([ds.__getitem__(i, seed=0) for i in range(len(ds))])
    seqs = option_groups(batch, "gen")
    compare_ranks(got.reshape(seqs.shape[:3]), jscores.reshape(
        seqs.shape[:3]), seqs)
    assert rank0["result"] == metrics and rank1["result"] == metrics
    assert rank0["result"].keys() == jres.keys()
    save = os.path.join(env["tmp"], "eval_tp")
    assert os.listdir(save) == ["performance_log.txt"]
    assert open(os.path.join(save, "performance_log.txt")).read() == \
        open(os.path.join(env["tmp"], "eval_one",
                          "performance_log.txt")).read()


def test_discriminative_cli_runs_equal_one_process(ranks, one_process):
    """evaluate_disc and two steps of train_disc (-model_parallel 2, the
    models' dropout on) on two ranks: the NSP scores and every step's
    losses of one process."""
    scores = np.concatenate(ranks[0]["clis"]["eval_disc"]["scores"])
    metrics, want = one_process["eval_disc"]
    np.testing.assert_allclose(scores, want, rtol=JAX_SCORE_TOL,
                               atol=JAX_SCORE_TOL)
    assert ranks[0]["clis"]["eval_disc"]["result"].keys() == metrics.keys()
    for r in ranks:
        got = r["clis"]["train_disc"]
        assert got.keys() == one_process["train_disc"].keys()
        for k, v in one_process["train_disc"].items():
            assert len(got[k]) == len(v) == 2
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("run", ["attack", "token", "generate"])
def test_attack_and_generation_equal_one_process(env, ranks, one_process,
                                                 run):
    """FGSM (its gradient through the conjugate functions), random_token
    (the dialog model's own MLM head, gathered) and greedy generation
    on two ranks: the metrics and records of one process, the records
    written once, by the model group's rank 0."""
    want = one_process[run]
    for r in ranks:
        got = r["clis"][run]
        if run == "generate":
            assert [d["dialog"][0]["question"] for d in got] == \
                [d["dialog"][0]["question"] for d in want]
            for g, w in zip(got, want):
                assert g["image_id"] == w["image_id"]
                for gr, wr in zip(g["dialog"], w["dialog"]):
                    assert (gr["question"], gr["answer"]) == \
                        (wr["question"], wr["answer"])
                    np.testing.assert_allclose(gr["answer_ppl"],
                                               wr["answer_ppl"],
                                               rtol=PPL_TOL)
        else:
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           err_msg=k)
    if run == "generate":
        out = os.path.join(env["cfg"].save_path, "gen_tp.json")
        assert json.load(open(out)) == ranks[0]["clis"]["generate"]
        assert not any(n.startswith("gen_tp.proc") for n in
                       os.listdir(env["cfg"].save_path))


def test_repl_transcript_matches_jax(ranks, one_process):
    """Two greedy turns on two ranks: rank 0 reads the lines and writes
    JAX's transcript; rank 1 writes nothing."""
    assert ranks[0]["clis"]["transcript"] == one_process["jax_transcript"]
    assert len(one_process["jax_transcript"]) == 2 + len(QUESTIONS)
    assert ranks[1]["clis"]["transcript"] == []


@pytest.mark.slow
def test_two_replicas_of_two_shards_step_equals_one_process(env, launched):
    """Four ranks, 2 x 2 (data x model): each replica on its stripe of
    the batch, each model group over its shards; the generative and the
    discriminative dropout-free steps equal one process's within JAX's TP
    pin, as tests/test_tensor_parallel.py::test_tp_matches_dp_loss_and_
    updates pins JAX's (2, 2) mesh.  ``slow``: four ranks take about 40 s
    of a loaded host."""
    spec = dict(launched[1], parts=["steps"], dp=2, ckpt=None)
    finish(start("tp", *_worker_cmd(env, "spawn_2x2", spec), 4,
                 torchrun=True))
    ranks = [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False)
             for r in range(4)]
    for r in ranks:
        assert set(r["steps"]) == {"gen", "disc"}
        for kind in ("gen", "disc"):
            got, want = r["steps"][kind]["tp"], r["steps"][kind]["one"]
            losses = got["loss"] if isinstance(got["loss"], dict) else \
                {"loss": got["loss"]}
            wants = want["loss"] if isinstance(want["loss"], dict) else \
                {"loss": want["loss"]}
            for k in wants:
                np.testing.assert_allclose(float(losses[k]), float(wants[k]),
                                           rtol=LOSS_RTOL, err_msg=k)
            for k, v in want["state"].items():
                np.testing.assert_allclose(got["state"][k].numpy(),
                                           v.numpy(), rtol=STEP_RTOL,
                                           atol=STEP_ATOL, err_msg=k)


@pytest.mark.slow
def test_four_shards_keep_a_vocab_that_does_not_divide_whole(env,
                                                             launched):
    """-model_parallel 4 with a 258-word vocab: every rank keeps the word
    table and the LM head whole (one message a tensor tail, as JAX's
    shard_by_path) while the heads and features shard four ways; the
    logits and the plain-path loss are one process's.  ``slow``: four
    ranks."""
    spec = dict(launched[1], parts=["forward"], mp=4, dp=1, ckpt=None)
    spec["enc"] = dict(spec["enc"], vocab_size=258)
    spec["dec"] = dict(spec["dec"], vocab_size=258)
    model = GSTVisualDialog(tcfg.EncoderConfig(**spec["enc"]),
                            tcfg.DecoderConfig(**spec["dec"]), device="cpu",
                            seed=3).eval()
    spec["state"] = os.path.join(env["tmp"], "vocab258.pt")
    torch.save(model.state_dict(), spec["state"])
    started = start("tp", *_worker_cmd(env, "spawn_mp4", spec), 4,
                    torchrun=True)
    finish(started)
    ranks = [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False)
             for r in range(4)]
    b = {k: torch.from_numpy(v) for k, v in _score_batch(
        env["cfg"].encoder_config()).items()}
    with torch.no_grad():
        want = model.score(*b.values())
    labels = torch.roll(b["dec_input_ids"], -1, 1)
    want_loss = float(tencdec.teacher_forced_loss(want, labels))
    for r in ranks:
        out = r["forward"]
        assert not out["vocab_sharded"] and out["word_rows"] == 258
        np.testing.assert_allclose(out["logits"].numpy(), want.numpy(),
                                   rtol=JAX_TOL, atol=JAX_TOL)
        np.testing.assert_allclose(float(out["loss"]), want_loss,
                                   rtol=LOSS_RTOL)
    log = open(started[1][0][2]).read()
    messages = [line for line in log.splitlines()
                if "dimension not divisible by model_parallel=4" in line]
    tails = {".".join(k.split(".")[-2:]) for k in model.state_dict()
             if tmesh.param_partition(k) == tmesh.VOCAB}
    # one message a tensor tail on each rank, at its build and at each
    # load of a full state dict
    assert messages and all("tensor replicated" in m for m in messages)
    names = [m.split("] ", 1)[1].split(":")[0] for m in messages]
    assert {".".join(n.split(".")[-2:]) for n in names} == tails
