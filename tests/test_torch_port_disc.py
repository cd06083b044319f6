"""Discriminative training in the port (the losses, the pooled dropout,
``VisdialDiscDataset``'s ``vd_train``, gstx_torch.train.train_disc and
the train_disc CLI) against the JAX package, f32 on the CPU.

Tolerances:

  * the losses: within 1e-5 relative (a block);
  * one step: the four losses within 1e-5 relative, each gradient within
    1e-4 of its max |g| (composed), JAX computed once per module with
    ``jax.value_and_grad`` of its loss on the same rows, both sides
    deterministic (dropout off, the heads' pooled dropout off);
  * items, masks, rows, checkpoint names and log fields: equal;
  * a port checkpoint read by JAX's ``load_torch_checkpoint``: NSP scores
    within 1e-4 (composed); a resumed run equal to the uninterrupted one
    bit for bit.
"""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_harness import assert_rel
from fixtures import make_cli_env
from gstx.cli import train_disc as jcli
from gstx.cli.common import build_model as j_build_model
from gstx.cli.common import init_params, load_params
from gstx.core.checkpoint import (convert_torch_state_dict,
                                  load_torch_checkpoint, to_torch_state_dict)
from gstx.data import visdial as jvisdial
from gstx.data.encode import nsp_attention_mask as np_nsp_mask
from gstx.data.tokenizer import BertTokenizer as JTokenizer
from gstx.models import heads as jheads
from gstx.models.encdec import GSTVisualDialog as JGST
from gstx.train.train_disc import nsp_attention_mask as jax_nsp_mask
from gstx_torch.cli import train_disc as tcli
from gstx_torch.core import checkpoint as tckpt
from gstx_torch.core import config as tcfg
from gstx_torch.core.checkpoint import state_dict_from_jax
from gstx_torch.data import visdial as tvisdial
from gstx_torch.data.loader import collate
from gstx_torch.data.tokenizer import BertTokenizer as TTokenizer
from gstx_torch.kernels import ffn as kffn
from gstx_torch.models import heads as theads
from gstx_torch.models.encdec import GSTVisualDialog
from gstx_torch.models.layers import Training
from gstx_torch.train import train_disc as ttrain
from gstx_torch.train import train_gen as tgen

BLOCK_TOL = 1e-5
GRAD_TOL = 1e-4
NSP_TOL = 1e-4


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Fixture data and flags, dense pseudo-labels for vd_train, and the
    JAX tiny params written as a full reference ``.ckpt`` (DataParallel
    ``module.`` prefixes)."""
    tmp = str(tmp_path_factory.mktemp("port_disc"))
    args, cfg = make_cli_env(tmp)
    rng = np.random.RandomState(7)
    dense = os.path.join(tmp, "train_dense.json")
    json.dump([{"image_id": 1000 + i, "scores": [
        [float(x) for x in rng.rand(100)] for _ in range(10)]}
        for i in range(4)], open(dense, "w"))
    cfg = cfg.replace(visdial_processed_train_dense=dense)
    args = args + ["-visdial_processed_train_dense", dense]
    model, _, _ = j_build_model(cfg)
    params = jax.device_get(init_params(model, cfg, seed=0))
    full = os.path.join(tmp, "full.ckpt")
    torch.save({"model_state_dict": {
        "module." + k: torch.from_numpy(np.array(v))
        for k, v in to_torch_state_dict(params).items()}}, full)
    return tmp, args, cfg, params, full


def _port_config(jcfg):
    return tcfg.GSTConfig(**dataclasses.asdict(jcfg))


def _disc_model(cfg, t_total):
    """The encoder-only model and optimizer as the trainer builds them."""
    return tgen.init_model_and_state(cfg, t_total, "cpu", use_decoder=False,
                                     warmup_steps=ttrain.DISC_WARMUP_STEPS)


# ---------------------------------------------------------------------- #
# the losses and the masks
# ---------------------------------------------------------------------- #


def _loss_inputs(seed, all_ignored=False):
    r = np.random.RandomState(seed)
    pred_t = (3 * r.randn(3, 7, 29)).astype(np.float32)
    labels = np.where(r.rand(3, 7) < 0.4, r.randint(0, 29, (3, 7)), -1)
    if all_ignored:
        labels[:] = -1
    pred_v = (2 * r.randn(3, 5, 11)).astype(np.float32)
    target = r.rand(3, 5, 11).astype(np.float32)
    target[:, :, :3] = 0.0  # zero targets: KLDiv's t == 0 branch
    target /= target.sum(-1, keepdims=True)
    label = r.randint(0, 2, (3, 5))
    if all_ignored:
        label[:] = 0
    nsp = r.randn(4, 2).astype(np.float32)
    soft = r.rand(4, 1).astype(np.float32)
    return pred_t, labels, pred_v, target, label, nsp, \
        np.concatenate([soft, 1 - soft], -1)


@pytest.mark.parametrize("all_ignored", [False, True],
                         ids=["labelled", "all_ignored"])
@pytest.mark.parametrize("loss", ["lm", "img_kl", "img_feature", "nsp"])
def test_losses_match_jax(loss, all_ignored):
    """Each loss against JAX's on the same inputs; with every MLM label -1
    and no masked region the losses are 0 (a mean over nothing), where
    ``F.cross_entropy(ignore_index=-1)`` would give NaN."""
    pred_t, labels, pred_v, target, label, nsp, soft = _loss_inputs(
        3, all_ignored)
    if loss == "lm":
        args = (pred_t, labels)
        fns = (jheads.masked_lm_loss, theads.masked_lm_loss)
    elif loss == "nsp":
        args = (nsp, soft)
        fns = (jheads.soft_nsp_loss, theads.soft_nsp_loss)
    else:
        feature = loss == "img_feature"
        args = (pred_v, target, label, feature)
        fns = (jheads.masked_img_loss, theads.masked_img_loss)
    want = float(fns[0](*[jnp.asarray(a) if isinstance(a, np.ndarray)
                          else a for a in args]))
    got = fns[1](*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                   else a for a in args])
    assert got.dtype == torch.float32 and np.isfinite(float(got))
    assert abs(float(got) - want) <= BLOCK_TOL * max(abs(want), 1e-30)
    if all_ignored and loss in ("lm", "img_kl", "img_feature"):
        assert float(got) == want == 0.0


def test_img_loss_normalisers_differ_by_path():
    """KL over the COUNT of masked regions, MSE over masked ELEMENTS."""
    pred = torch.zeros(1, 4, 6)
    target = torch.ones(1, 4, 6)
    label = torch.tensor([[0, 1, 1, 0]])
    # MSE: every masked element contributes 1 -> mean 1
    assert float(theads.masked_img_loss(pred, target, label, True)) == 1.0
    # KL: per region sum over 6 classes of 1 * (log 1 - log(1/6)) -> 6 ln 6
    kl = float(theads.masked_img_loss(pred, target, label, False))
    assert abs(kl - 6 * np.log(6)) < 1e-5


def test_nsp_attention_mask_matches_both_jax_twins():
    r = np.random.RandomState(0)
    sep = np.sort(r.randint(1, 40, (9, 6)), axis=1)
    hist = r.randint(0, 6, 9)
    got = ttrain.nsp_attention_mask(torch.from_numpy(sep),
                                    torch.from_numpy(hist), 48).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np_nsp_mask(sep, hist, 48))
    np.testing.assert_array_equal(got, np.asarray(jax_nsp_mask(
        jnp.asarray(sep), jnp.asarray(hist), 48)))


def test_pooled_dropout_is_fixed_and_site_seeded():
    """The heads drop the fused pooled output at 0.1 whatever the config,
    from a mask of (seed, the heads' site): two calls with one seed agree,
    another seed differs, no Training is deterministic."""
    enc = tcfg.EncoderConfig(vocab_size=50, hidden_size=32,
                             num_attention_heads=4, intermediate_size=64,
                             v_hidden_size=24, bi_hidden_size=24)
    model = GSTVisualDialog(enc, tcfg.DecoderConfig(), device="cpu",
                            use_decoder=False)
    cls = model.encoder.bert_pretrained.cls
    pt, pv = torch.randn(64, 24), torch.randn(64, 24)
    a = cls.seq_relationship(pt, pv, Training(1))
    assert torch.equal(a, cls.seq_relationship(pt, pv, Training(1)))
    assert not torch.equal(a, cls.seq_relationship(pt, pv, Training(2)))
    assert torch.equal(cls.seq_relationship(pt, pv),
                       cls.seq_relationship(pt, pv, None))
    kept = Training(1).keep_mask((64, 24), torch.device("cpu"), 0.9,
                                 cls.dropout_site * 16)
    assert 0.8 < float(kept.float().mean()) < 0.97


# ---------------------------------------------------------------------- #
# vd_train items
# ---------------------------------------------------------------------- #


ITEM_CASES = [(False, 1, 96), (True, 1, 96), (False, 3, 96),
              (True, 2, 40)]


@pytest.mark.parametrize("dense,negatives,max_len", ITEM_CASES,
                         ids=["plain", "train_dense", "three_negatives",
                              "dense_short_context"])
def test_vd_train_items_match_jax(env, dense, negatives, max_len):
    """Items for the same seed equal JAX's array for array; at context 40
    negatives that do not fit are dropped and the last one cut to the
    answer's length (the max-length fallback)."""
    _, _, jcfg, _, _ = env
    jcfg = jcfg.replace(train_dense=dense, num_negative_samples=negatives,
                        max_seq_len=max_len)
    tc = _port_config(jcfg)
    want = jvisdial.VisdialDiscDataset(
        jcfg, JTokenizer(vocab_path=jcfg.vocab_path), mode="vd_train")
    got = tvisdial.VisdialDiscDataset(
        tc, TTokenizer(vocab_path=tc.vocab_path), mode="vd_train")
    assert len(got) == len(want) == 4
    labels = []
    for index in range(4):
        a = got.__getitem__(index, seed=index + 11)
        b = want.__getitem__(index, seed=index + 11)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["tokens"].shape[:2] == (10, 1 + negatives)
        labels.append(a["next_sentence_labels"])
    labels = np.stack(labels)
    assert (labels[:, :, 0] == [1.0, 0.0]).all()
    soft = labels[:, :, 1:, 0]
    assert bool(((soft > 0) & (soft < 1)).any()) == dense


def test_select_rows_match_jax_flattening(env):
    """Rows as JAX's step gathers them (``gstx/train/train_disc.py:64-80``,
    verbatim in numpy), and the device mask as JAX's."""
    _, _, jcfg, _, _ = env
    ds = tvisdial.VisdialDiscDataset(
        _port_config(jcfg), TTokenizer(vocab_path=jcfg.vocab_path),
        mode="vd_train")
    batch = collate([ds.__getitem__(i, seed=i) for i in range(3)])
    b, rounds, samples = batch["tokens"].shape[:3]
    total = b * rounds * samples
    idx = np.array([59, 0, 21, 40, 7, 33], np.int64)
    got = ttrain.select_rows(batch, idx)
    for key in ("tokens", "segments", "sep_indices", "mask"):
        np.testing.assert_array_equal(
            got[key], batch[key].reshape(total, -1)[idx], err_msg=key)
    np.testing.assert_array_equal(
        got["next_sentence_labels"],
        batch["next_sentence_labels"].reshape(total, 2)[idx])
    np.testing.assert_array_equal(got["hist_len"],
                                  batch["hist_len"].reshape(total)[idx])
    for key in ttrain.IMAGE_KEYS:
        np.testing.assert_array_equal(
            got[key], batch[key][idx // (rounds * samples)], err_msg=key)


# ---------------------------------------------------------------------- #
# one step against JAX
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def step_ref(env):
    """Fixed rows of a collated vd_train batch and the JAX side of one
    deterministic step on them: the four losses and the gradients."""
    _, _, jcfg, params, _ = env
    ds = jvisdial.VisdialDiscDataset(
        jcfg, JTokenizer(vocab_path=jcfg.vocab_path), mode="vd_train")
    batch = collate([ds.__getitem__(i, seed=i + 1) for i in range(2)])
    rows = ttrain.select_rows(batch, np.array([3, 17, 38, 0, 24, 11]))
    enc, dec = jcfg.encoder_config(), jcfg.decoder_config()
    model = JGST(enc, dec, use_decoder=False)
    enc_params = {"params": {k: params["params"][k]
                             for k in ("encoder", "cls")}}

    def loss_fn(p):
        att = jax_nsp_mask(jnp.asarray(rows["sep_indices"]),
                           jnp.asarray(rows["hist_len"]),
                           rows["tokens"].shape[-1])
        pred_t, pred_v, nsp = model.apply(
            p, jnp.asarray(rows["tokens"]), jnp.asarray(rows["image_feat"]),
            jnp.asarray(rows["image_loc"]), jnp.asarray(rows["segments"]),
            att, jnp.asarray(rows["image_mask"]), deterministic=True,
            method=JGST.pretrain_scores)
        lm = jheads.masked_lm_loss(pred_t, jnp.asarray(rows["mask"]))
        img = jheads.masked_img_loss(pred_v, jnp.asarray(rows["image_target"]),
                                     jnp.asarray(rows["image_label"]),
                                     enc.predict_feature)
        nsp_l = jheads.soft_nsp_loss(
            nsp, jnp.asarray(rows["next_sentence_labels"]))
        loss = lm + nsp_l + img
        return loss, {"lm_loss": lm, "img_loss": img, "nsp_loss": nsp_l}

    (loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        enc_params)
    want = {k: float(v) for k, v in parts.items()}
    want["loss"] = float(loss)
    return dict(rows=rows, want=want, params=params,
                grads=state_dict_from_jax(jax.device_get(grads),
                                          with_decoder=False))


def _enc_model(env, params=None):
    _, _, jcfg, jparams, _ = env
    model = GSTVisualDialog(jcfg.encoder_config(), jcfg.decoder_config(),
                            device="cpu", use_decoder=False)
    model.load_state_dict(state_dict_from_jax(
        params if params is not None else jparams, with_decoder=False),
        strict=True)
    return model


def test_one_step_losses_and_grads_match_jax(env, step_ref):
    model = _enc_model(env)
    rows = tgen.rows_to_device(step_ref["rows"], "cpu")
    out = ttrain.row_losses(model, rows, _port_config(env[2]), None)
    out["loss"].backward()
    for k, want in step_ref["want"].items():
        assert abs(float(out[k].detach()) - want) <= BLOCK_TOL * abs(want), k
    checked = 0
    top = max(float(g.abs().max()) for g in step_ref["grads"].values())
    for name, p in model.named_parameters():
        if ".biOutput.q_dense" in name:
            continue
        want = step_ref["grads"][name]
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        if re.search(r"\.key\d?\.bias$", name):
            # softmax ignores a shift shared by every key: both readings
            # are rounding noise, held against the largest gradient
            for g in (got, want):
                assert float(g.abs().max()) <= 1e-6 * top, name
            continue
        assert_rel(got, want, GRAD_TOL, name)
        checked += 1
    assert checked > 60


def test_train_step_draws_distinct_rows_and_reruns_exactly(env):
    """The step draws batch_size distinct rows from the iteration's
    generator; the same generator twice gives the same losses and update
    (dropout masks are functions of the drawn seed)."""
    _, _, jcfg, _, _ = env
    cfg = _port_config(jcfg).replace(batch_size=5)
    ds = tvisdial.VisdialDiscDataset(cfg, TTokenizer(
        vocab_path=cfg.vocab_path), mode="vd_train")
    batch = collate([ds.__getitem__(i, seed=i) for i in range(2)])
    seen = []
    real = ttrain.select_rows

    def spy(b, idx):
        seen.append(idx)
        return real(b, idx)
    results = []
    for _ in range(2):
        model, opt = _disc_model(cfg, 10)
        step = ttrain.make_disc_train_step(model, opt, cfg, "small")
        ttrain.select_rows = spy
        try:
            losses = step(batch, tgen.iteration_generator(0, 3))
        finally:
            ttrain.select_rows = real
        results.append((losses, model.state_dict()))
    assert len(set(seen[0].tolist())) == 5
    np.testing.assert_array_equal(seen[0], seen[1])
    for k in ttrain.LOSS_NAMES:
        assert torch.equal(results[0][0][k], results[1][0][k])
        assert np.isfinite(float(results[0][0][k]))
    for k, v in results[0][1].items():
        assert torch.equal(v, results[1][1][k]), k


# ---------------------------------------------------------------------- #
# the CLI: item 0, checkpoints, log lines, resume, JAX reading its files
# ---------------------------------------------------------------------- #

LOG_LINE = re.compile(
    r"^\[\w{3} \d{2} \w{3} \d{2} \d{2}:\d{2}:\d{2}\]\[LR: (\d+\.\d{7})\]"
    r"\[Ep: (\d+\.\d{2})\]\[Iter: (\d+)\]\[Time: +\d+\.\d{2}s\]"
    r"\[Loss: [-+.\deE]+\]\[LM: [-+.\deE]+\]\[NSP: [-+.\deE]+\]"
    r"\[IMG: [-+.\deE]+\]$")

RUN_FLAGS = ["-mode", "vd_train", "-model", "enc_only_a", "-batch_size",
             "2", "-num_epochs", "2", "-log_every", "1", "-data_parallel",
             "1", "-remat_policy", "small"]


def _train(args, save, extra, max_steps):
    return tcli.main(args + RUN_FLAGS + ["-save_path", save] + extra,
                     max_steps=max_steps, device="cpu")


@pytest.fixture(scope="module")
def runs(env):
    """The port's CLI with dropout 0.1 from the full checkpoint: 4 steps
    straight; 2 steps, then -continue from the rotating checkpoint for 2
    more; and the JAX CLI's 4 steps with the same flags."""
    tmp, args, _, _, full = env
    out = {k: os.path.join(tmp, k) for k in ("whole", "first", "resumed",
                                             "jax")}
    warm = ["-start_path", full, "-save_every_steps", "2"]
    whole = _train(args, out["whole"], warm, 4)
    _train(args, out["first"], warm, 2)
    step_ckpt = os.path.join(out["first"], "vd_train_disc_step.ckpt")
    resumed = _train(args, out["resumed"],
                     ["-start_path", step_ckpt, "-continue",
                      "-save_every_steps", "2"], 2)
    jcli.main(args + RUN_FLAGS + ["-save_path", out["jax"]] + warm,
              max_steps=4)
    kffn.enable(True)
    return out, whole, resumed, step_ckpt


def test_resumed_run_equals_the_uninterrupted_one(runs):
    out, (m_whole, o_whole), (m_res, o_res), step_ckpt = runs
    assert tckpt.restore_checkpoint(step_ckpt)["step"] == 2
    for k, v in m_whole.state_dict().items():
        assert torch.equal(v, m_res.state_dict()[k]), k
    sa, sb = o_whole.state_dict(), o_res.state_dict()
    assert [g["step"] for g in sa["param_groups"]] == \
        [g["step"] for g in sb["param_groups"]] == [4] * 4
    for i, st in sa["state"].items():
        for k in st:
            assert torch.equal(st[k], sb["state"][i][k]), (i, k)
    a = tckpt.restore_checkpoint(os.path.join(out["whole"],
                                              "vd_train_disc_step.ckpt"))
    b = tckpt.restore_checkpoint(os.path.join(out["resumed"],
                                              "vd_train_disc_step.ckpt"))
    assert a["step"] == b["step"] == 4
    for k, v in a["model_state_dict"].items():
        assert torch.equal(v, b["model_state_dict"][k]), k


def _log_fields(path):
    lines = [ln for ln in open(path).read().splitlines() if ln.startswith(
        "[")]
    assert lines and all(LOG_LINE.match(ln) for ln in lines), lines
    return [LOG_LINE.match(ln).groups() for ln in lines]


def test_cli_writes_the_jax_cli_checkpoint_names_and_log_lines(runs):
    """The JAX CLI's names: ``vd_train_disc_{epoch}.ckpt`` at each epoch
    boundary but the first, ``vd_train_disc_step.ckpt``, no final
    checkpoint; ``log_disc.txt`` with its line format and the same LR /
    epoch / iteration fields; ``metrics.jsonl`` with the four losses."""
    out, _, _, _ = runs
    names = sorted(os.listdir(out["jax"]))
    assert names == ["log_disc.txt", "metrics.jsonl", "vd_train_disc_1.ckpt",
                     "vd_train_disc_step.ckpt"]
    assert sorted(os.listdir(out["whole"])) == names
    got = _log_fields(os.path.join(out["whole"], "log_disc.txt"))
    want = _log_fields(os.path.join(out["jax"], "log_disc.txt"))
    assert got == want and [int(f[2]) for f in got] == [0, 1, 2, 3]
    recs = [json.loads(ln) for ln in open(os.path.join(
        out["whole"], "metrics.jsonl"))]
    jrecs = [json.loads(ln) for ln in open(os.path.join(
        out["jax"], "metrics.jsonl"))]
    assert [sorted(r) for r in recs] == [sorted(r) for r in jrecs]
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    assert "1 epoch ended." in open(os.path.join(
        out["whole"], "log_disc.txt")).read()


def test_port_checkpoint_loads_in_jax_with_the_same_nsp_scores(env, runs,
                                                             step_ref):
    out, (model, _), _, _ = runs
    _, _, jcfg, _, _ = env
    path = os.path.join(out["whole"], "vd_train_disc_step.ckpt")
    enc = jcfg.encoder_config()
    tree = convert_torch_state_dict(
        load_torch_checkpoint(path), enc.num_hidden_layers,
        enc.v_num_hidden_layers, len(enc.v_biattention_id), 0)
    assert "decoder" not in tree
    rows = step_ref["rows"]
    att = np_nsp_mask(rows["sep_indices"], rows["hist_len"],
                      rows["tokens"].shape[-1])
    want = JGST(enc, jcfg.decoder_config(), use_decoder=False).apply(
        {"params": tree}, rows["tokens"], rows["image_feat"],
        rows["image_loc"], rows["segments"], att, rows["image_mask"],
        method=JGST.pretrain_scores)[2]
    loaded = GSTVisualDialog(enc, jcfg.decoder_config(), device="cpu",
                             use_decoder=False)
    assert tckpt.load_checkpoint(loaded, path) == "encoder"
    r = tgen.rows_to_device(rows, "cpu")
    with torch.no_grad():
        got = loaded.nsp_scores(r["tokens"], r["image_feat"],
                                r["image_loc"], r["segments"],
                                torch.from_numpy(att), r["image_mask"])
        live = model.nsp_scores(r["tokens"], r["image_feat"],
                                r["image_loc"], r["segments"],
                                torch.from_numpy(att), r["image_mask"])
    assert torch.equal(got, live)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=NSP_TOL)


def test_warm_start_takes_the_encoder_of_a_full_checkpoint(env):
    """Item 0 in the trainer: the full file's encoder loads (JAX's
    load_params merges it into the encoder-only template), its fusion and
    decoder are dropped, and the optimizer starts fresh at step 0."""
    _, args, jcfg, params, full = env
    cfg = _port_config(jcfg).replace(start_path=full)
    model, opt = _disc_model(cfg, 100)
    assert ttrain.load_start_checkpoint(cfg, model, opt) == (0, False)
    jtree = load_params(j_build_model(jcfg, use_decoder=False)[0], jcfg,
                        full)
    want = state_dict_from_jax(jax.device_get(jtree), with_decoder=False)
    assert model.state_dict().keys() == want.keys()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert all(g["step"] == 0 for g in opt.param_groups)


# as the JAX CLI: -data_parallel 2 or -model_parallel 2 in one process is
# a mesh the devices cannot fill (make_mesh's ValueError); a degree that
# does not divide a head count raises validate_model_parallel's
REFUSALS = [(["-model", "enc_dec_a"], "enc_only_a"),
            (["-mode", "vd_eval_val"], "vd_train"),
            (["-data_parallel", "2"], r"mesh 2x1 != 1 devices available"),
            (["-model_parallel", "2"], r"mesh 1x2 != 1 devices available"),
            (["-model_parallel", "3"],
             "model_parallel=3 does not divide num_attention_heads=4")]


@pytest.mark.parametrize("extra,message", REFUSALS,
                         ids=[" ".join(e) for e, _ in REFUSALS])
def test_cli_refusals(env, tmp_path, extra, message):
    _, args, _, _, _ = env
    error = ValueError if extra[0] in ("-data_parallel", "-model_parallel") \
        else SystemExit
    with pytest.raises(error, match=message):
        _train(args, str(tmp_path), extra, 1)
    kffn.enable(True)


def test_cli_needs_a_card_unless_asked_for_the_cpu(env, tmp_path,
                                                   monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, args, _, _, _ = env
    monkeypatch.delenv("GSTX_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(args + RUN_FLAGS + ["-save_path", str(tmp_path)],
                  max_steps=1)
