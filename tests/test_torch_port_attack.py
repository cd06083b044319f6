"""The adversarial robustness evaluation in the port (the attacker masked
LM, the attacks, the attack loop and the evaluate_gen_attack CLI) against
the JAX package, f32 on the CPU, on the tiny fixture data and one
reference-format checkpoint of the JAX tiny params that both load.

Tolerances:

  * BertMLM's logits: within 1e-4 (composed);
  * TextAttack: equal ids;
  * FGSM's input gradient: within 1e-4 of its max |g|; the perturbed
    scores within SCORE_TOL (1e-4) on every candidate whose gradient
    signs all agree with JAX's.  Entries whose signs differ are counted
    and must lie under 1e-4 of the max |g| (a sign of a near-zero entry is
    rounding's);
  * the CLI: every chunk's scores within SCORE_TOL (FGSM chunks as above);
    metrics equal, or, with near-tied options (as
    tests/test_torch_port_eval.py counts them), within the bound those
    ties allow.
"""

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_harness import compare_ranks
from fixtures import make_cli_env, make_tokenizer
from gstx.cli import evaluate_gen_attack as jcli
from gstx.cli.common import build_model as j_build_model
from gstx.cli.common import init_params
from gstx.core.checkpoint import to_torch_state_dict
from gstx.eval import attack_eval as jattack_eval
from gstx.eval import attacks as jattacks
from gstx.models import mlm as jmlm
from gstx_torch.cli import evaluate_gen_attack as tcli
from gstx_torch.cli.common import build_model as t_build_model
from gstx_torch.cli.common import load_params as t_load_params
from gstx_torch.cli.common import parse_config
from gstx_torch.core import config as tcfg
from gstx_torch.data import tokenizer as ttok
from gstx_torch.data import visdial as tvisdial
from gstx_torch.data.loader import collate
from gstx_torch.eval import attack_eval as tattack_eval
from gstx_torch.eval import attacks as tattacks
from gstx_torch.eval.rank_gen import batch_to_device, chunk_inputs, \
    flatten_gen
from gstx_torch.kernels import ffn as kffn
from gstx_torch.models import mlm as tmlm

LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4
SCORE_TOL = 1e-4
DEV_KEYS = ("enc_input_ids", "enc_segments", "enc_att_mask",
            "dec_input_ids", "dec_att_mask", "enc_image_feat",
            "enc_image_loc", "enc_image_mask")


# ---------------------------------------------------------------------- #
# the attacker masked LM
# ---------------------------------------------------------------------- #

MLM_SHAPE = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=48,
                 max_position_embeddings=64)


def hf_numpy_state_dict(seed=0, **shape):
    """A Hugging Face BertForMaskedLM-named state dict of seeded numpy
    arrays, with what such files carry beyond the model: the
    ``position_ids`` buffer, the decoder's bias (a copy of the MLM bias)
    and the tied decoder weight (the word table)."""
    cfg = tmlm.mlm_config(**shape)
    r = np.random.RandomState(seed)
    sd = {}
    for name, p in tmlm.BertMLM(cfg, device="cpu").state_dict().items():
        if name.endswith("LayerNorm.weight"):
            sd[name] = (1 + 0.1 * r.randn(*p.shape)).astype(np.float32)
        else:
            sd[name] = (0.2 * r.randn(*p.shape)).astype(np.float32)
    sd["cls.predictions.decoder.weight"] = \
        sd["bert.embeddings.word_embeddings.weight"]
    sd["cls.predictions.decoder.bias"] = sd["cls.predictions.bias"]
    sd["bert.embeddings.position_ids"] = np.arange(
        cfg.max_position_embeddings)[None]
    return cfg, sd


def _mlm_inputs(vocab, b=3, l=12, seed=6):
    r = np.random.RandomState(seed)
    ids = r.randint(1, vocab, (b, l))
    seg = r.randint(0, 2, (b, l))
    att = (r.rand(b, l) > 0.2).astype(np.int64)
    att[:, 0] = 1
    return ids, seg, att


def test_bert_mlm_matches_jax_from_one_hf_state_dict():
    cfg, sd = hf_numpy_state_dict(**MLM_SHAPE)
    jcfg = jmlm.mlm_config(**MLM_SHAPE)
    tree = jmlm.convert_hf_bert_mlm_state_dict(sd, cfg.num_hidden_layers)
    ids, seg, att = _mlm_inputs(cfg.vocab_size)
    want = np.asarray(jmlm.BertMLM(jcfg).apply(
        {"params": tree}, jnp.asarray(ids), jnp.asarray(seg),
        jnp.asarray(att)))
    model = tmlm.BertMLM(cfg, device="cpu").eval()
    model.load_state_dict(tmlm.hf_state_dict(sd), strict=True)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (ids, seg, att)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    # the MLM projection is the word table: tied, one parameter
    assert model.cls.predictions.decoder.weight is \
        model.bert.embeddings.word_embeddings.weight


def test_load_mlm_attacker_from_a_bin_and_its_refusals(tmp_path):
    cfg, sd = hf_numpy_state_dict(seed=2, **MLM_SHAPE)
    # a BertForPreTraining file's extra heads are read past, as JAX does
    extra = {"bert.pooler.dense.weight": np.zeros((32, 32), np.float32),
             "cls.seq_relationship.bias": np.zeros(2, np.float32)}
    path = str(tmp_path / "pytorch_model.bin")
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in {**sd, **extra}.items()}, path)
    model = tmlm.load_mlm_attacker(path, config=cfg, device="cpu")
    # DataParallel's module. prefix is stripped (the JAX loader reads
    # bare names only)
    wrapped = str(tmp_path / "wrapped.bin")
    torch.save({"model_state_dict": {"module." + k: torch.from_numpy(
        np.asarray(v)) for k, v in sd.items()}}, wrapped)
    for k, v in tmlm.load_mlm_attacker(wrapped, config=cfg,
                                       device="cpu").state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    jtree = jmlm.load_mlm_attacker(path, config=jmlm.mlm_config(
        **MLM_SHAPE))[1]
    ids, seg, att = _mlm_inputs(cfg.vocab_size, seed=8)
    fill = tmlm.make_standalone_mlm_fill(model)
    got = fill(ids, seg, att)
    want = jmlm.make_standalone_mlm_fill(jmlm.BertMLM(jmlm.mlm_config(
        **MLM_SHAPE)), jtree)(ids, seg, att)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)
    # without a config the heads follow bert-base's 64 a head: hidden 32
    # cannot, and is refused as JAX refuses it
    with pytest.raises(ValueError, match="num_attention_heads"):
        tmlm.load_mlm_attacker(path, device="cpu")
    wide, wsd = hf_numpy_state_dict(
        **dict(MLM_SHAPE, hidden_size=128, num_attention_heads=2))
    wpath = str(tmp_path / "wide.bin")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in wsd.items()},
               wpath)
    inferred = tmlm.load_mlm_attacker(wpath, device="cpu").config
    assert (inferred.num_attention_heads, inferred.num_hidden_layers,
            inferred.intermediate_size, inferred.vocab_size) == (2, 2, 48,
                                                                 120)
    # a missing or an unknown name is refused (strict)
    del sd["bert.encoder.layer.1.output.dense.bias"]
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               path)
    with pytest.raises(RuntimeError, match="output.dense.bias"):
        tmlm.load_mlm_attacker(path, config=cfg, device="cpu")
    # an orbax directory (the JAX package's format) is refused
    with pytest.raises(ValueError, match="orbax"):
        tmlm.load_mlm_attacker(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------- #
# TextAttack (tests/test_attacks.py's fixtures, both packages)
# ---------------------------------------------------------------------- #


def _ctx(tok, rounds, length=64):
    ids = [tcfg.CLS_ID]
    for r in rounds:
        ids.extend(tok.encode(r))
        ids.append(tcfg.SEP_ID)
    out = np.zeros((3, length), np.int64)
    out[:, :len(ids)] = ids
    return out


def _both(**kw):
    jtok, ttk = make_tokenizer(), ttok.BertTokenizer(vocab=dict(
        make_tokenizer().vocab))
    return (jattacks.TextAttack(jtok, max_seq_len=64, **kw),
            tattacks.TextAttack(ttk, max_seq_len=64, **kw), ttk)


SIM_WORDS = {0: "dog", 1: "horse", 2: "man", 3: "beach", 4: "sand"}
SIM = np.asarray([[1.0, 0.8, 0.1, 0.0, 0.2], [0.8, 1.0, 0.2, 0.1, 0.0],
                  [0.1, 0.2, 1.0, 0.3, 0.1], [0.0, 0.1, 0.3, 1.0, 0.7],
                  [0.2, 0.0, 0.1, 0.7, 1.0]], np.float32)
COREF = [{"1": "dog"}, {"0": "beach", "2": "dog"}, {"3": "zebra"}, {},
         {"1": "man"}]


@pytest.mark.parametrize("dep", COREF, ids=["round1", "rounds02",
                                            "unknown", "empty", "no_synonym"])
def test_coreference_attack_matches_jax(dep):
    w2i = {w: i for i, w in SIM_WORDS.items()}
    ja, ta, tok = _both(cos_sim=SIM, cos_sim_idx2word=SIM_WORDS,
                        cos_sim_word2idx=w2i)
    ids = _ctx(tok, ["a man on the beach", "is there a dog",
                     "yes a dog on the sand", "what color"])
    want = ja.coreference_attack(ids, None, dep)
    got = ta.coreference_attack(ids, None, dep)
    np.testing.assert_array_equal(got, want)
    changed = bool((got != ids).any())
    assert changed == (dep in (COREF[0], COREF[1])), dep


def test_pick_most_similar_words_matches_jax():
    for src in range(5):
        want = jattacks.TextAttack.pick_most_similar_words_batch(
            [src], SIM, SIM_WORDS, ret_count=3, threshold=0.5)
        got = tattacks.TextAttack.pick_most_similar_words_batch(
            [src], SIM, SIM_WORDS, ret_count=3, threshold=0.5)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1][0], want[1][0])


@pytest.mark.parametrize("logits_kind", ["numpy", "torch", "none",
                                         "no_masks"])
def test_random_token_attack_matches_jax(logits_kind):
    """The port's fill hands back a tensor, as both of its fills do; the
    JAX side's hands back numpy logits ("numpy") or the same tensor."""
    r = np.random.RandomState(4)
    table = r.randn(64, 30).astype(np.float32)
    table[:, 5] = table[:, 9] = 10.0  # tied maxima: the first wins

    def fill(ids, seg, att, image):
        return torch.from_numpy(table[np.asarray(ids) % 64])

    def jfill(ids, seg, att, image):
        out = fill(ids, seg, att, image)
        return out.numpy() if logits_kind == "numpy" else out
    ja, ta, tok = _both()
    if logits_kind != "none":
        ja.mlm_fill, ta.mlm_fill = jfill, fill
    ids = _ctx(tok, ["a man on the beach", "is there a dog", "yes"])
    if logits_kind != "no_masks":
        ids[:, [2, 5, 6]] = tcfg.MASK_ID
    seg = np.zeros_like(ids)
    att = (ids != 0).astype(np.float32)
    want = ja.random_token_attack(ids, seg, att, None)
    got = ta.random_token_attack(ids, seg, att, None)
    np.testing.assert_array_equal(got, want)
    assert got.shape == ids.shape


def test_rebuild_segments_matches_jax():
    ids = _ctx(make_tokenizer(), ["a man", "is there a dog", "yes"])
    np.testing.assert_array_equal(tattack_eval.rebuild_segments(ids),
                                  jattack_eval.rebuild_segments(ids))


# ---------------------------------------------------------------------- #
# FGSM
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Fixture data and flags, the JAX tiny params as a full reference
    .ckpt, and the coreference and attacker files of the CLI runs."""
    tmp = str(tmp_path_factory.mktemp("port_attack"))
    args, cfg = make_cli_env(tmp)
    model, _, _ = j_build_model(cfg)
    params = jax.device_get(init_params(model, cfg, seed=0))
    full = os.path.join(tmp, "full.ckpt")
    torch.save({"model_state_dict": {
        k: torch.from_numpy(np.array(v))
        for k, v in to_torch_state_dict(params).items()}}, full)
    words = {0: "a", 1: "the", 2: "is", 3: "on", 4: "dog", 5: "horse"}
    sim = np.eye(6, dtype=np.float32)
    for i, j, s in ((0, 1, 0.9), (2, 3, 0.6), (4, 5, 0.8)):
        sim[i, j] = sim[j, i] = s
    paths = {k: os.path.join(tmp, k) for k in ("cos.npy", "i2w.pickle",
                                               "w2i.pickle", "coref.json",
                                               "mlm.bin")}
    np.save(paths["cos.npy"], sim)
    pickle.dump(words, open(paths["i2w.pickle"], "wb"))
    pickle.dump({w: i for i, w in words.items()},
                open(paths["w2i.pickle"], "wb"))
    json.dump([{"image_id": 1000 + d, "coreference": [
        {"1": "a", "2": "the", "3": "is", "4": "dog"} for _ in range(10)]}
        for d in range(4)], open(paths["coref.json"], "w"))
    # an attacker over the fixture's 256-word vocab, heads of 64
    _, sd = hf_numpy_state_dict(seed=9, vocab_size=256, hidden_size=64,
                                num_hidden_layers=1, num_attention_heads=1,
                                intermediate_size=64,
                                max_position_embeddings=128)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               paths["mlm.bin"])
    return args, cfg, params, full, paths


def _dense_chunk(env, index=0):
    """The dense-annotated round's chunk of eval dialog ``index`` as numpy
    rows (the JAX evaluator's flattened arrays) and its relevance."""
    _, jcfg, _, _, _ = env
    tc = tcfg.GSTConfig(**dataclasses.asdict(jcfg))
    ds = tvisdial.VisdialGenDataset(
        tc, ttok.BertTokenizer(vocab_path=tc.vocab_path), mode="vd_eval_val")
    batch = collate([ds.__getitem__(index, seed=index)])
    text, images, (_, rounds, options) = flatten_gen(batch)
    j = int(batch["round_id"][0, 0]) - 1
    dev_text, dev_images = batch_to_device(text, images, "cpu",
                                           torch.float32, ())
    chunk = chunk_inputs(dev_text, dev_images, j * options,
                         (j + 1) * options, rounds * options)
    return ({k: v.numpy() for k, v in chunk.items()},
            batch["gt_relevance"][0].astype(np.float32))


def _port_model(env):
    args, _, _, full, _ = env
    return t_load_params(t_build_model(parse_config(args), device="cpu"),
                         full)


@pytest.fixture(scope="module")
def jax_fgsm(env):
    """JAX's FGSM scorer (one jit for the module) and its params."""
    _, jcfg, params, _, _ = env
    model, _, _ = j_build_model(jcfg)
    return jattacks.make_fgsm_scorer(model, 1.0), params


def _sign_agreement(jg, tg):
    """Rows whose gradient signs all agree, and the entries that differ,
    each of which must be a near-zero entry."""
    differ = np.sign(jg) != np.sign(tg)
    scale = float(np.abs(jg).max())
    assert (np.abs(jg[differ]) <= GRAD_TOL * scale).all()
    assert (np.abs(tg[differ]) <= GRAD_TOL * scale).all()
    return ~differ.reshape(differ.shape[0], -1).any(-1), int(differ.sum())


@pytest.mark.parametrize("index", [0, 1, 2, 3])
def test_fgsm_gradient_and_scores_match_jax(env, jax_fgsm, index):
    chunk, rel = _dense_chunk(env, index)
    jfgsm, params = jax_fgsm
    jchunk = {k: jnp.asarray(chunk[k].astype(np.int32)
                             if chunk[k].dtype == np.int64 else chunk[k])
              for k in DEV_KEYS}
    jg = np.asarray(jfgsm.nll_grad(jchunk["enc_image_feat"], params, jchunk,
                                   jnp.asarray(rel)))
    want = np.asarray(jfgsm(params, jchunk, jnp.asarray(rel)))
    model = _port_model(env)
    tfgsm = tattacks.make_fgsm_scorer(model, 1.0)
    tchunk = {k: torch.from_numpy(v) for k, v in chunk.items()}
    trel = torch.from_numpy(rel)
    tg = tfgsm.nll_grad(tchunk["enc_image_feat"], tchunk, trel).numpy()
    assert tg.dtype == np.float32 and tg.shape == chunk[
        "enc_image_feat"].shape
    np.testing.assert_allclose(tg, jg, rtol=0,
                               atol=GRAD_TOL * float(np.abs(jg).max()))
    with torch.no_grad():
        got = tfgsm(tchunk, trel).numpy()
    agree, n_differ = _sign_agreement(jg, tg)
    print(f"dialog {index}: {n_differ} gradient entries of "
          f"{jg.size} differ in sign, {int((~agree).sum())} candidates")
    np.testing.assert_allclose(got[agree], want[agree], rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    # rows of relevance 0 have a zero gradient and are not perturbed
    zero = rel == 0
    assert zero.any() and not np.abs(tg[zero]).any()
    clean = tattacks.make_chunk_scorer(model)
    with torch.no_grad():
        assert np.array_equal(clean(tchunk).numpy()[zero], got[zero])
        assert not np.allclose(clean(tchunk).numpy()[~zero], got[~zero])
    # the parameters ask for gradients again after the pass
    assert all(p.requires_grad for p in model.parameters())


# ---------------------------------------------------------------------- #
# the CLI against the JAX CLI
# ---------------------------------------------------------------------- #

ATTACKS = ["fgsm", "random_token", "random_token_mlm", "coreference"]


def _argv(env, attack, save):
    args, _, _, full, paths = env
    argv = args + ["-mode", "vd_eval_val", "-start_path", full,
                   "-save_path", save, "-data_parallel", "1",
                   "-attack", attack.replace("_mlm", "")]
    if attack.startswith("random_token"):
        argv += ["-mask_prob", "0.3"]
    if attack == "random_token_mlm":
        argv += ["-mlm_path", paths["mlm.bin"]]
    if attack == "coreference":
        argv += ["-cos_sim_counter_fitting", paths["cos.npy"],
                 "-cos_sim_idx2word", paths["i2w.pickle"],
                 "-cos_sim_word2idx", paths["w2i.pickle"],
                 "-visdial_processed_val_coref_dependency",
                 paths["coref.json"]]
    return argv


def _recording(m, module, record):
    """Record every chunk's scores, in order, and each FGSM chunk's
    inputs, of ``module``'s scorer factories."""
    for name in ("make_chunk_scorer", "make_fgsm_scorer"):
        make = getattr(module, name)

        def wrapped(*a, _make=make, _name=name, **kw):
            score = _make(*a, **kw)

            def scored(*args):
                out = score(*args)
                record.append((_name, np.asarray(
                    out.detach() if torch.is_tensor(out) else out), args))
                return out
            return scored
        m.setattr(module, name, wrapped)


@pytest.fixture(scope="module")
def runs(env, tmp_path_factory):
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("GSTX_PLATFORM", "cpu")
        for attack in ATTACKS:
            res = {}
            for pkg, cli, module in (("jax", jcli, jattack_eval),
                                     ("port", tcli, tattack_eval)):
                rec = []
                with pytest.MonkeyPatch.context() as m:
                    _recording(m, module, rec)
                    save = str(tmp_path_factory.mktemp(f"{pkg}_{attack}"))
                    stats = {} if pkg == "port" else None
                    kw = {"stats_out": stats} if stats is not None else {}
                    result = cli.main(_argv(env, attack, save), **kw)
                    kffn.enable(True)
                res[pkg] = (result, rec, save, stats)
            out[attack] = res
    finally:
        mp.undo()
    return out


def _tie_key(args):
    """Per option of a recorded port chunk, what makes two options tie
    exactly in both packages: their answer's ids, and under FGSM their
    relevance too (equal inputs and relevance, equal perturbations)."""
    ids = args[0]["dec_input_ids"].numpy()
    rel = args[1].numpy() if len(args) > 1 else np.zeros(len(ids),
                                                         np.float32)
    return np.concatenate([ids, rel.view(np.int32)[:, None]], axis=1)


@pytest.mark.parametrize("attack", ATTACKS)
def test_cli_matches_jax_cli(env, runs, jax_fgsm, attack):
    (jres, jrec, _, _), (tres, trec, tsave, stats) = \
        runs[attack]["jax"], runs[attack]["port"]
    assert [n for n, _, _ in trec] == [n for n, _, _ in jrec]
    assert len(trec) == 4 * 10
    n_fgsm = sum(n == "make_fgsm_scorer" for n, _, _ in trec)
    assert n_fgsm == (4 if attack == "fgsm" else 0)
    assert stats["fgsm_chunks"] == n_fgsm and stats["sequences"] == 400
    assert (stats["text_attacked"] > 0) == (attack != "fgsm")
    assert (stats["batches"], stats["images"], stats["chunks"]) == (4, 4, 40)
    model = _port_model(env) if n_fgsm else None
    scores_t, scores_j = [], []
    for (name, got, targs), (_, want, jargs) in zip(trec, jrec):
        keep = np.ones(len(want), bool)
        if name == "make_fgsm_scorer":
            jchunk, rel = jargs[1], np.array(jargs[2])
            jfgsm, params = jax_fgsm
            jg = np.asarray(jfgsm.nll_grad(jchunk["enc_image_feat"], params,
                                           jchunk, jnp.asarray(rel)))
            tchunk = {k: torch.from_numpy(np.array(
                jchunk[k], np.int64 if jchunk[k].dtype == jnp.int32
                else np.float32)) for k in DEV_KEYS}
            tg = tattacks.make_fgsm_scorer(model).nll_grad(
                tchunk["enc_image_feat"], tchunk,
                torch.from_numpy(rel)).numpy()
            keep, _ = _sign_agreement(jg, tg)
        np.testing.assert_allclose(got[keep], want[keep], rtol=SCORE_TOL,
                                   atol=SCORE_TOL)
        scores_t.append(got)
        scores_j.append(np.where(keep, want, got))
    seqs = np.stack([_tie_key(args) for _, _, args in trec])
    tied = compare_ranks(np.stack(scores_t), np.stack(scores_j), seqs)
    near = int(tied.sum()) // 2
    print(f"{attack}: {near} near-tied option pairs")
    assert tres.keys() == jres.keys() >= {"r@1", "r@5", "r@10", "mean",
                                          "mrr", "ndcg"}
    if near == 0:
        assert tres == jres
    else:
        # each near-tied pair moves one rank by at most one place
        for k in tres:
            rows = 4 if k == "ndcg" else 40
            assert abs(tres[k] - jres[k]) <= near / rows, k
    log = open(os.path.join(tsave, "performance_log.txt")).read()
    assert f"mrr: {tres['mrr']}" in log


def test_text_attacks_change_the_scored_context(env, runs):
    """The coreference run scores another context than the clean one on
    the dense round of some dialog; random_token on some round of every
    dialog (the dataset masked them, the MLM refilled)."""
    _, jcfg, _, _, _ = env
    tc = tcfg.GSTConfig(**dataclasses.asdict(jcfg))
    ds = tvisdial.VisdialGenDataset(
        tc, ttok.BertTokenizer(vocab_path=tc.vocab_path), mode="vd_eval_val")
    clean = [ds.__getitem__(i, seed=0) for i in range(4)]
    for attack in ("coreference", "random_token", "random_token_mlm"):
        rec = runs[attack]["port"][1]
        changed = 0
        for d in range(4):
            for j in range(10):
                ids = rec[d * 10 + j][2][0]["enc_input_ids"].numpy()
                changed += int(not np.array_equal(
                    ids, clean[d]["enc_input_ids"][j]))
        assert changed > 0, attack


# message None: not refused; as the JAX CLI, in one process
# -data_parallel 2 runs as one rank and -distributed alone is a no-op
REFUSALS = [(["-mode", "vd_eval_test"], "vd_eval_val"),
            (["-start_path", ""], "start_path"),
            (["-data_parallel", "2"], None),
            (["-distributed"], None)]


@pytest.mark.parametrize("extra,message", REFUSALS,
                         ids=[" ".join(e) for e, _ in REFUSALS])
def test_cli_refusals(env, tmp_path, extra, message):
    argv = _argv(env, "fgsm", str(tmp_path))
    try:
        if message is not None:
            with pytest.raises(SystemExit, match=message):
                tcli.main(argv + extra, device="cpu")
            return
        got = tcli.main(argv + extra, device="cpu", max_batches=1)
        assert got == tcli.main(argv, device="cpu", max_batches=1)
        assert set(got) >= {"r@1", "mrr", "ndcg"}
    finally:
        kffn.enable(True)


def test_cli_needs_a_card_unless_asked_for_the_cpu(env, tmp_path,
                                                   monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.delenv("GSTX_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(_argv(env, "fgsm", str(tmp_path)))
