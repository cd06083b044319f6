"""The port's evaluation (gstx_torch.eval, the VisDial eval datasets and the
evaluate_gen / evaluate_disc CLIs) against the JAX package's, f32 on the
CPU, on the tiny fixture data and one reference-format checkpoint of the
JAX tiny params that both packages load.

Host code (metrics, items, chunk inputs) must agree exactly; scores within
SCORE_TOL.  Ranks and metrics must agree exactly, except between
*near-tied* options: two options whose token sequences differ and whose
JAX scores lie within SCORE_TOL of each other may order differently in the
two packages.  The tests count such pairs and print the count; each
near-tied pair can move one rank by one place, which bounds how far a
metric may move.  Options with identical token sequences tie exactly in
both packages.  The JAX CLI runs once per evaluator and mode, in a module
fixture, with its per-chunk scores recorded."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from fixtures import make_cli_env, make_visdial_json
from gstx.cli import evaluate_disc as jdisc_cli
from gstx.cli import evaluate_gen as jgen_cli
from gstx.cli.common import build_model as j_build_model
from gstx.cli.common import init_params
from gstx.cli.common import load_params as jrank_disc_load
from gstx.core.checkpoint import to_torch_state_dict
from gstx.data.feature_store import make_synthetic_store
from gstx.data import tokenizer as jtok
from gstx.data import visdial as jvisdial
from gstx.eval import metrics as jmetrics
from gstx.eval import rank_disc as jrank_disc
from gstx.eval import rank_gen as jrank_gen
from gstx.models.encdec import candidate_log_likelihood as j_cll
from gstx_torch.cli import evaluate_disc as tdisc_cli
from gstx_torch.cli import evaluate_gen as tgen_cli
from gstx_torch.cli.common import build_model as t_build_model
from gstx_torch.cli.common import load_params as t_load_params
from gstx_torch.core import config as tcfg
from gstx_torch.core.checkpoint import load_checkpoint, state_dict_from_jax
from gstx_torch.data import tokenizer as ttok
from gstx_torch.data import visdial as tvisdial
from gstx_torch.data.loader import DataLoader, collate
from gstx_torch.eval import metrics as tmetrics
from gstx_torch.eval import rank_disc as trank_disc
from gstx_torch.eval import rank_gen as trank_gen
from gstx_torch.kernels import ffn as kffn
from gstx_torch.models.encdec import precast_
from gstx_torch.models.encdec import candidate_log_likelihood as t_cll

SCORE_TOL = 1e-4  # the composed model, f32 on the CPU
KINDS = {"gen": (jgen_cli, tgen_cli, jrank_gen, trank_gen),
         "disc": (jdisc_cli, tdisc_cli, jrank_disc, trank_disc)}
MODES = ["vd_eval_val", "vd_eval_test"]
CASES = [(k, m) for k in KINDS for m in MODES]
# the CLI runs: every (kind, mode) on VisDial v1.0, and val on v0.9
# (batches of 25, no NDCG) over V09_DIALOGS dialogs made in the test
CLI_CASES = [(k, m, "1.0") for k, m in CASES] + \
    [(k, "vd_eval_val", "0.9") for k in KINDS]
V09_DIALOGS = 26  # a full batch of 25 and one of 1


# ---------------------------------------------------------------------- #
# metrics
# ---------------------------------------------------------------------- #


def _scores(ties, shape=(3, 10, 100), seed=0):
    rng = np.random.RandomState(seed)
    if ties:  # few distinct values: many exact ties
        return rng.randint(0, 7, size=shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_scores_to_ranks_matches_jax(ties):
    s = _scores(ties)
    got = tmetrics.scores_to_ranks(s)
    np.testing.assert_array_equal(got, jmetrics.scores_to_ranks(s))
    assert sorted(got[0, 0]) == list(range(1, 101))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_sparse_metrics_match_jax(ties):
    got, want = tmetrics.SparseGTMetrics(), jmetrics.SparseGTMetrics()
    for seed in range(3):
        s = _scores(ties, seed=seed)
        gt = np.random.RandomState(seed + 9).randint(0, 100, size=(3, 10))
        got.observe(s, gt)
        want.observe(s, gt)
    assert got.retrieve() == want.retrieve()
    assert got.retrieve() == {}  # reset


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_ndcg_matches_jax(ties):
    got, want = tmetrics.NDCG(), jmetrics.NDCG()
    rng = np.random.RandomState(4)
    for seed in range(3):
        s = _scores(ties, shape=(5, 100), seed=seed)
        rel = (rng.rand(5, 100) * (rng.rand(5, 100) > 0.7)).astype(np.float32)
        rel[0] = 0.0  # a row without relevance scores 0
        got.observe(s, rel)
        want.observe(s, rel)
    assert got.retrieve() == want.retrieve()


def test_candidate_log_likelihood_matches_jax():
    rng = np.random.RandomState(2)
    logits = (rng.randn(6, 9, 50) * 3).astype(np.float32)
    ids = rng.randint(1, 50, size=(6, 9))
    ids[:, -3:] = 0   # padding
    ids[1, 4] = 0     # a PAD target mid-sequence
    got = t_cll(torch.from_numpy(logits), torch.from_numpy(ids))
    want = np.asarray(j_cll(jax.numpy.asarray(logits),
                            jax.numpy.asarray(ids.astype(np.int32))))
    assert got.dtype == torch.float32 and got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------- #
# datasets
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Fixture data and flags, and the JAX tiny params written as a
    reference full ``.ckpt`` (DataParallel ``module.`` prefixes) and as an
    encoder-only one (``module.bert_pretrained.*``, the reference's
    discriminative layout)."""
    tmp = str(tmp_path_factory.mktemp("port_eval"))
    args, cfg = make_cli_env(tmp)
    model, _, _ = j_build_model(cfg)
    params = jax.device_get(init_params(model, cfg, seed=0))
    sd = to_torch_state_dict(params)
    full = os.path.join(tmp, "full.ckpt")
    torch.save({"model_state_dict": {
        "module." + k: torch.from_numpy(np.array(v)) for k, v in sd.items()}},
        full)
    enc = os.path.join(tmp, "enc.ckpt")
    pre = "encoder.bert_pretrained."
    torch.save({"model_state_dict": {
        "module.bert_pretrained." + k[len(pre):]: torch.from_numpy(
            np.array(v)) for k, v in sd.items() if k.startswith(pre)}}, enc)
    # VisDial v0.9: the same JSON layout, no dense annotations, no test
    # split; its own val set and store, and 8 options a round, so that a
    # batch of 25 (2,000 sequences) splits into the evaluators' chunks of
    # 500 and 200
    v09 = {"vd_version": "0.9", "num_options": 8,
           "visdial_processed_train_09": cfg.visdial_processed_train,
           "visdial_processed_val_09": os.path.join(tmp, "val_09.json"),
           "visdial_image_feats": os.path.join(tmp, "feats_09.store")}
    make_visdial_json(v09["visdial_processed_val_09"], V09_DIALOGS, seed=9)
    make_synthetic_store(v09["visdial_image_feats"],
                         [1000 + i for i in range(V09_DIALOGS)],
                         num_boxes=12, feat_dim=16, num_classes=11)
    return args, cfg, params, {"gen": full, "disc": enc}, v09


def _port_config(jcfg):
    return tcfg.GSTConfig(**dataclasses.asdict(jcfg))


def _datasets(env, kind, mode, attack="", version="1.0"):
    """The JAX and the port's dataset; with ``attack``, under that attack
    with ``attack_mode`` set, as the attack evaluator sets it; on VisDial
    ``version``."""
    _, jcfg, _, _, v09 = env
    if version == "0.9":
        jcfg = jcfg.replace(**v09)
    if mode == "vd_eval_test":
        jcfg = jcfg.replace(num_options=100)
    if attack:
        jcfg = jcfg.replace(attack=attack)
    jcls = {"gen": jvisdial.VisdialGenDataset,
            "disc": jvisdial.VisdialDiscDataset}[kind]
    tcls = {"gen": tvisdial.VisdialGenDataset,
            "disc": tvisdial.VisdialDiscDataset}[kind]
    tc = _port_config(jcfg)
    out = (jcls(jcfg, jtok.BertTokenizer(vocab_path=jcfg.vocab_path),
                mode=mode),
           tcls(tc, ttok.BertTokenizer(vocab_path=tc.vocab_path),
                mode=mode))
    if attack:
        for ds in out:
            ds.attack_mode = True
    return out


# the generative val items also under the random_token attack, whose
# history masking draws from the item's rng
ITEM_CASES = [(k, m, "") for k, m in CASES] + \
    [("gen", "vd_eval_val", "random_token")]


@pytest.mark.parametrize("kind,mode,attack", ITEM_CASES,
                         ids=[f"{k}-{m}" + (f"-{a}" if a else "")
                              for k, m, a in ITEM_CASES])
def test_eval_items_match_jax(env, kind, mode, attack):
    want_ds, got_ds = _datasets(env, kind, mode, attack)
    assert len(got_ds) == len(want_ds) == 4
    if attack:
        plain = _datasets(env, kind, mode)[1]
        masked = 0
    for index in range(4):
        got = got_ds.__getitem__(index, seed=index + 3)
        want = want_ds.__getitem__(index, seed=index + 3)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if attack:
            clean = plain.__getitem__(index, seed=index + 3)
            masked += int((clean["enc_input_ids"]
                           != got["enc_input_ids"]).sum())
    if attack:  # the attack masked some history tokens
        assert masked > 0


@pytest.mark.parametrize("kind", ["gen", "disc"])
def test_vd_train_names_item_5(env, kind):
    """Both datasets' vd_train, once refused naming ROADMAP queue 1 item
    5, serve items now: the generative one since generative training, the
    discriminative one since discriminative training (their items against
    JAX's: tests/test_torch_port_train.py, tests/test_torch_port_disc.py)."""
    _, jcfg, _, _, _ = env
    tc = _port_config(jcfg)
    tok = ttok.BertTokenizer(vocab_path=tc.vocab_path)
    if kind == "gen":
        ds = tvisdial.VisdialGenDataset(tc, tok, mode="vd_train")
        assert ds.__getitem__(0, seed=0)["dec_labels"].shape[:2] == (10, 1)
        return
    ds = tvisdial.VisdialDiscDataset(tc, tok, mode="vd_train")
    item = ds.__getitem__(0, seed=0)
    assert item["tokens"].shape[:2] == (10, 1 + tc.num_negative_samples)
    assert item["next_sentence_labels"].shape == (10, 2, 2)


def _jax_flat(batch, kind):
    """The JAX evaluators' host flattening, verbatim
    (gstx/eval/rank_gen.py:98-112, rank_disc.py:74-90)."""
    from gstx.data.encode import nsp_attention_mask

    first = "enc_input_ids" if kind == "gen" else "tokens"
    b, rounds, options = batch[first].shape[:3]
    total = b * rounds * options
    if kind == "gen":
        text = ("enc_input_ids", "enc_segments", "enc_att_mask",
                "dec_input_ids", "dec_att_mask")
        image = ("enc_image_feat", "enc_image_loc", "enc_image_mask")
    else:
        text = ("tokens", "segments")
        image = ("image_feat", "image_loc", "image_mask")
    flat = {k: batch[k].reshape(total, batch[k].shape[-1]) for k in text}
    if kind == "disc":
        flat["att_mask"] = nsp_attention_mask(
            batch["sep_indices"].reshape(total, -1),
            batch["hist_len"].reshape(total), batch["tokens"].shape[-1])
    for key in image:
        x = batch[key]
        expanded = np.broadcast_to(
            x[:, None, None], (b, rounds, options) + x.shape[1:])
        flat[key] = expanded.reshape((total,) + x.shape[1:])
    return flat


@pytest.mark.parametrize("kind,mode", CASES)
def test_chunk_inputs_equal_jax_flattened_arrays(env, kind, mode):
    """The port's chunks (text rows sliced, image rows gathered on the
    device) concatenate to the JAX evaluators' flattened host arrays."""
    _, ds = _datasets(env, kind, mode)
    batch = collate([ds.__getitem__(i, seed=i) for i in range(3)])
    flatten = trank_gen.flatten_gen if kind == "gen" else \
        trank_disc.flatten_disc
    text, images, (b, rounds, options) = flatten(batch)
    total = b * rounds * options
    dev_text, dev_images = trank_gen.batch_to_device(
        text, images, "cpu", torch.float32, ())
    chunks = [trank_gen.chunk_inputs(dev_text, dev_images, j, j + 50,
                                     rounds * options)
              for j in range(0, total, 50)]
    want = _jax_flat(batch, kind)
    assert set(chunks[0]) == set(want)
    for k, v in want.items():
        got = torch.cat([c[k] for c in chunks]).numpy()
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)


# ---------------------------------------------------------------------- #
# scores, ranks and metrics: the CLIs and the evaluators against JAX
# ---------------------------------------------------------------------- #


def _argv(env, kind, mode, out, version="1.0"):
    args, _, _, ckpts, v09 = env
    argv = args + ["-mode", mode, "-start_path", ckpts[kind],
                   "-save_path", out, "-data_parallel", "1"]
    if version == "0.9":
        argv += [a for k, v in v09.items() for a in (f"-{k}", str(v))]
    if kind == "disc":
        argv += ["-model", "enc_only_a"]
    if mode == "vd_eval_test":
        argv += ["-num_options", "100"]
    return argv


def _recording(monkeypatch, module, name, record):
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


FACTORY = {"gen": "make_chunk_scorer", "disc": "make_nsp_scorer"}


@pytest.fixture(scope="module")
def runs(env, tmp_path_factory):
    """Each evaluator, mode and VisDial version through the JAX CLI and
    the port's CLI (the port's with GSTX_PLATFORM=cpu and no ``device``):
    results, per-sequence scores, the save path and (the port's) the
    batch loop's counts."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("GSTX_PLATFORM", "cpu")
        for kind, mode, version in CLI_CASES:
            jcli, tcli, jrank, trank = KINDS[kind]
            res = {}
            for pkg, cli, rank in (("jax", jcli, jrank),
                                   ("port", tcli, trank)):
                rec, stats = [], {}
                kw = {"stats_out": stats} if pkg == "port" else {}
                with pytest.MonkeyPatch.context() as m:
                    _recording(m, rank, FACTORY[kind], rec)
                    save = str(tmp_path_factory.mktemp(f"{pkg}_{kind}"))
                    result = cli.main(_argv(env, kind, mode, save, version),
                                      **kw)
                    kffn.enable(True)  # the module default, for later tests
                res[pkg] = (result, np.concatenate(rec), save, stats)
            out[kind, mode, version] = res
    finally:
        mp.undo()
    return out


def _option_groups(batch_or_items, kind):
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


@pytest.mark.parametrize("kind,mode,version", CLI_CASES,
                         ids=[f"{k}-{m}" + ("-v0.9" if v == "0.9" else "")
                              for k, m, v in CLI_CASES])
def test_cli_matches_jax_cli(env, runs, kind, mode, version):
    """Scores within SCORE_TOL; metrics (val) or predictions.txt (test)
    equal, up to near-ties.  VisDial v0.9: batches of 25 images and no
    NDCG."""
    (jres, jscores, jsave, _), (tres, tscores, tsave, stats) = \
        runs[kind, mode, version]["jax"], runs[kind, mode, version]["port"]
    assert tscores.dtype == np.float32 and tscores.shape == jscores.shape
    np.testing.assert_allclose(tscores, jscores, rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    _, ds = _datasets(env, kind, mode, version=version)
    per_batch = 20 if version == "1.0" else 25
    assert stats["images"] == len(ds) and \
        stats["batches"] == -(-len(ds) // per_batch)
    batch = collate([ds.__getitem__(i, seed=0) for i in range(len(ds))])
    seqs = _option_groups(batch, kind)
    b, rounds = seqs.shape[:2]
    tied = compare_ranks(tscores.reshape(seqs.shape[:3]),
                         jscores.reshape(seqs.shape[:3]), seqs)
    near = int(tied.sum()) // 2
    print(f"{kind} {mode}: {near} near-tied option pairs")
    if mode == "vd_eval_val":
        sparse = {"r@1", "r@5", "r@10", "mean", "mrr"}
        assert tres.keys() == jres.keys() == (
            sparse | {"ndcg"} if version == "1.0" else sparse)
        if near == 0:
            assert tres == jres
        # each near-tied pair moves one rank by at most one place.  The
        # sparse metrics read the gt option's rank, so only the pairs that
        # hold it count, and a mean over rounds moves by at most their
        # number / rows.  NDCG (per image, on its dense round, in [0, 1])
        # moves only by pairs that hold a relevant option.
        gt = batch["gt_option_inds"].reshape(-1)
        near_gt = int(tied[np.arange(b * rounds), gt].sum())
        near_rel = 0
        if version == "1.0":
            dense = tied[np.arange(b) * rounds + batch["round_id"][:, 0] - 1]
            rel = batch["gt_relevance"] > 0
            near_rel = int((dense & (rel[:, :, None] | rel[:, None, :])
                            ).sum()) // 2
        print(f"{kind} {mode}: {near_gt} hold the gt option, {near_rel} "
              "a relevant option of the dense round")
        for k in tres:
            n, rows = (near_rel, b) if k == "ndcg" else \
                (near_gt, b * rounds)
            assert abs(tres[k] - jres[k]) <= n / rows, k
        log = open(os.path.join(tsave, "performance_log.txt")).read()
        assert f"mrr: {tres['mrr']}" in log
    else:
        got = json.load(open(os.path.join(tsave, "predictions.txt")))
        want = json.load(open(os.path.join(jsave, "predictions.txt")))
        assert got == tres and len(got) == 4
        for g, w in zip(got, want):
            assert (g["image_id"], g["round_id"]) == \
                (w["image_id"], w["round_id"])
            assert sorted(g["ranks"]) == list(range(1, 101))
            if near == 0:
                assert g["ranks"] == w["ranks"]


def _port_model(env, kind, dtype=torch.float32):
    args, _, _, ckpts, _ = env
    from gstx_torch.cli.common import parse_config

    cfg = parse_config(args)
    model = t_load_params(t_build_model(cfg, device="cpu",
                                        use_decoder=kind == "gen"),
                          ckpts[kind])
    return precast_(model, dtype) if dtype != torch.float32 else model


def _loader(env, kind, mode, batch_size):
    _, ds = _datasets(env, kind, mode)
    return DataLoader(ds, batch_size=batch_size, shuffle=False,
                      drop_last=False, num_workers=1).epoch(0)


@pytest.mark.parametrize("kind,mode", CASES)
def test_evaluator_scores_match_jax_at_both_chunk_sizes(env, runs,
                                                        monkeypatch, kind,
                                                        mode):
    """evaluate_gen / evaluate_disc called directly, at chunk 500 (one
    chunk of 400 here) and chunk 100 (four), on batches of 2 images:
    scores equal to each other and within SCORE_TOL of the JAX scorer's;
    results equal to the port CLI's."""
    _, _, _, trank = KINDS[kind]
    evaluate = trank.evaluate_gen if kind == "gen" else trank.evaluate_disc
    jscores = runs[kind, mode, "1.0"]["jax"][1]
    model = _port_model(env, kind)
    results, scores = [], []
    for cs in (500, 100):
        rec = []
        with monkeypatch.context() as m:
            _recording(m, trank, FACTORY[kind], rec)
            stats = {}
            results.append(evaluate(model, _loader(env, kind, mode, 2),
                                    mode=mode, chunk_size=cs,
                                    stats_out=stats))
        scores.append(np.concatenate(rec))
        per_batch = 2 * (10 * 10 if mode == "vd_eval_val" else 100)
        assert stats["sequences"] == 2 * per_batch and stats["images"] == 4
        assert stats["chunks"] == 2 * -(-per_batch // min(cs, per_batch))
    np.testing.assert_allclose(scores[1], scores[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(scores[0], jscores, rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    assert results[0] == results[1] == runs[kind, mode, "1.0"]["port"][0]


@pytest.mark.parametrize("kind", ["gen", "disc"])
def test_cli_max_batches_stops_after_the_first_batch(env, tmp_path,
                                                     monkeypatch, kind):
    """main(max_batches=1) scores the first eval batch only (of 2 images
    here: the loader's batch cut from 20 to 2) and reports its metrics as
    the evaluator gives them for that batch alone."""
    _, tcli, _, trank = KINDS[kind]
    evaluate = trank.evaluate_gen if kind == "gen" else trank.evaluate_disc
    chunk = 500 if kind == "gen" else 200  # the CLIs' defaults

    class Pairs(DataLoader):
        def __init__(self, dataset, batch_size, **kw):
            super().__init__(dataset, batch_size=2, **kw)
    monkeypatch.setattr(tgen_cli, "DataLoader", Pairs)
    stats = {}
    got = tcli.main(_argv(env, kind, "vd_eval_val", str(tmp_path)),
                    max_batches=1, device="cpu", stats_out=stats)
    kffn.enable(True)
    assert (stats["batches"], stats["images"]) == (1, 2)
    first = next(iter(_loader(env, kind, "vd_eval_val", 2)))
    assert got == evaluate(_port_model(env, kind), [first],
                           chunk_size=chunk)


@pytest.mark.parametrize("kind", ["gen", "disc"])
def test_chunk_size_must_divide_the_batch(env, kind):
    _, _, _, trank = KINDS[kind]
    evaluate = trank.evaluate_gen if kind == "gen" else trank.evaluate_disc
    with pytest.raises(ValueError, match="chunks of 300"):
        evaluate(_port_model(env, kind),
                 _loader(env, kind, "vd_eval_val", 4), chunk_size=300)


@pytest.mark.parametrize("kind", ["gen", "disc"])
def test_evaluators_leave_the_models_dtypes(env, kind):
    """The evaluator computes in the model's dtype and casts nothing of the
    caller's model: an f32 model stays f32, a precast bf16 one keeps its
    f32 LayerNorms (and the bf16 path gives close scores)."""
    _, _, _, trank = KINDS[kind]
    evaluate = trank.evaluate_gen if kind == "gen" else trank.evaluate_disc
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = _port_model(env, kind, dtype)
        before = {n: p.dtype for n, p in model.named_parameters()}
        out[dtype] = evaluate(model, _loader(env, kind, "vd_eval_val", 4),
                              chunk_size=100)
        assert {n: p.dtype for n, p in model.named_parameters()} == before
        assert all(p.requires_grad for p in model.parameters())
    for k, v in out[torch.bfloat16].items():
        assert np.isfinite(v), k


# ---------------------------------------------------------------------- #
# the encoder-only model and its checkpoints
# ---------------------------------------------------------------------- #


def test_enc_only_model_loads_the_bridge_strictly_and_refuses_full(env):
    """The encoder-only model owns exactly the encoder's names: the JAX
    bridge without the decoder loads strictly, so does the reference's
    encoder-only .ckpt.  A full .ckpt, once refused, now gives its encoder
    part, as JAX's load_params merges it into the encoder-only template:
    the same NSP scores as the JAX model loaded from the same file."""
    args, jcfg, params, ckpts, _ = env
    from gstx_torch.cli.common import parse_config

    model = t_build_model(parse_config(args), device="cpu",
                          use_decoder=False)
    names = model.state_dict().keys()
    assert all(k.startswith("encoder.bert_pretrained.") for k in names)
    sd = state_dict_from_jax(params, with_decoder=False)
    model.load_state_dict(sd, strict=True)
    assert names == sd.keys()
    assert load_checkpoint(model, ckpts["disc"]) == "encoder"
    extracted = t_build_model(parse_config(args), device="cpu", seed=5,
                              use_decoder=False)
    assert load_checkpoint(extracted, ckpts["gen"]) == "full"
    jmodel = j_build_model(jcfg, use_decoder=False)[0]
    jparams = jrank_disc_load(jmodel, jcfg, ckpts["gen"])
    assert "decoder" not in jparams["params"]
    g = np.random.RandomState(3)
    ids = g.randint(1, 200, (3, 20))
    feat = g.rand(3, 5, jcfg.encoder_config().v_feature_size).astype(
        np.float32)
    loc = g.rand(3, 5, 5).astype(np.float32)
    seg = (np.arange(20)[None] > 9).astype(np.int64).repeat(3, 0)
    att = np.ones((3, 20), np.float32)
    att[1, 15:] = 0
    img = np.ones((3, 5), np.float32)
    want = np.asarray(jmodel.apply(jparams, ids, feat, loc, seg, att, img,
                                   method=type(jmodel).pretrain_scores)[2])
    with torch.no_grad():
        got = extracted.nsp_scores(*[torch.from_numpy(a) for a in (
            ids, feat, loc, seg, att, img)])
        enc_only = model.nsp_scores(*[torch.from_numpy(a) for a in (
            ids, feat, loc, seg, att, img)])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCORE_TOL)
    # the two files hold the same encoder
    assert torch.equal(got, enc_only)


def test_nsp_scores_are_pretrain_scores_third_output(env):
    model = _port_model(env, "disc")
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(1, 200, (3, 20), generator=g)
    feat = torch.rand(3, 5, model.enc_config.v_feature_size, generator=g)
    loc = torch.rand(3, 5, 5, generator=g)
    seg = torch.zeros_like(ids)
    att = torch.ones_like(ids)
    img = torch.ones(3, 5)
    want = model.pretrain_scores(ids, feat, loc, seg, att, img)[2]
    got = model.nsp_scores(ids, feat, loc, seg, att, img)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------- #
# refusals
# ---------------------------------------------------------------------- #


REFUSALS = [
    ("disc", ["-model", "enc_dec_a"], "enc_only_a"),
    ("gen", ["-start_path", ""], "start_path"),
    ("disc", ["-start_path", ""], "start_path"),
    ("gen", ["-mode", "vd_gen_val"], "vd_eval_val or vd_eval_test"),
    # message None: not refused; as the JAX CLI, in one process
    # -data_parallel 2 and -model_parallel 2 run as one rank
    # (make_generation_mesh's None) and -distributed alone is a no-op
    ("gen", ["-data_parallel", "2"], None),
    ("disc", ["-model_parallel", "2"], None),
    ("gen", ["-distributed"], None),
]


@pytest.mark.parametrize("kind,extra,message", REFUSALS,
                         ids=[f"{k}{' '.join(e)}" for k, e, _ in REFUSALS])
def test_cli_refusals(env, tmp_path, kind, extra, message):
    _, tcli, _, _ = KINDS[kind]
    argv = _argv(env, kind, "vd_eval_val", str(tmp_path))
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


@pytest.mark.parametrize("kind", ["gen", "disc"])
def test_cli_needs_a_card_unless_asked_for_the_cpu(env, tmp_path,
                                                   monkeypatch, kind):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, tcli, _, _ = KINDS[kind]
    monkeypatch.delenv("GSTX_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(_argv(env, kind, "vd_eval_val", str(tmp_path)))
