"""The port's self-training orchestrator (gstx_torch.cli.selftrain) against
the JAX package's (gstx.cli.selftrain): the same plan with the stages'
modules under gstx_torch; the same retry rule; and one real iteration of
one chunk, each stage a subprocess on the CPU (marked slow, as JAX's
tests/test_selftrain_e2e.py is)."""

import json
import os
import subprocess
import types

import pytest
import torch

from fixtures import make_cc12m_caption_json, make_cli_env
from gstx.cli import selftrain as jselftrain
from gstx_torch.cli import selftrain as tselftrain


def _base(tmp, iterations="2", chunks="3"):
    return ["-iterations", iterations, "-chunks", chunks,
            "-start_path_q", "q.ckpt", "-start_path_a", "a.ckpt",
            "-cc12m_image_feats", os.path.join(tmp, "feats"),
            "-cc12m_caption_dir", os.path.join(tmp, "caps"),
            "-dialog_root", os.path.join(tmp, "dialogs"),
            "-save_path", os.path.join(tmp, "out")]


@pytest.mark.parametrize("extra", [[], ["-batch_size", "2", "-save_path",
                                        "ignored", "-dtype", "bfloat16"]],
                         ids=["no_extra", "extra"])
def test_plan_equals_jax_with_the_port_modules(tmp_path, extra):
    argv = _base(str(tmp_path)) + (["-extra"] + extra if extra else [])
    want = jselftrain.main(argv, dry_run=True)
    got = tselftrain.main(argv, dry_run=True)
    assert len(got) == 2 * (3 + 2)  # per iteration: 3 chunks, 2 trainings
    assert [s[0] for s in want] == \
        ["gstx.cli.generate"] * 3 + ["gstx.cli.train_gen"] * 2 + \
        ["gstx.cli.generate"] * 3 + ["gstx.cli.train_gen"] * 2
    assert got == [["gstx_torch." + s[0][len("gstx."):]] + s[1:]
                   for s in want]
    # the finetuned student of iteration 1 is iteration 2's teacher
    teacher = got[5][got[5].index("-start_path_a") + 1]
    assert teacher == os.path.join(str(tmp_path), "out", "finetune_iter1",
                                   "final.ckpt")


def test_stage_retry_on_signal_not_on_error(tmp_path, monkeypatch):
    """tests/test_selftrain_e2e.py::test_selftrain_stage_retry_on_signal
    for the port: a stage killed by a signal is retried; a stage failing
    with a positive exit code fails at once, with its log's tail."""
    calls = []

    def signal_once(cmd, **kw):
        calls.append(list(cmd))
        return types.SimpleNamespace(returncode=-9 if len(calls) == 1 else 0)

    monkeypatch.setattr(subprocess, "run", signal_once)
    base = _base(str(tmp_path), "1", "1")
    plan = tselftrain.main(base)
    # 3 stages + 1 retry of the first = 4 subprocess invocations
    assert len(calls) == len(plan) + 1 and calls[0] == calls[1]
    assert calls[0][1:3] == ["-m", "gstx_torch.cli.generate"]
    logs = sorted(os.listdir(os.path.join(str(tmp_path), "out",
                                          "selftrain_logs")))
    assert logs == ["stage_000_generate.log", "stage_001_train_gen.log",
                    "stage_002_train_gen.log"]

    calls.clear()

    def error(cmd, **kw):
        calls.append(list(cmd))
        with open(os.path.join(str(tmp_path), "out", "selftrain_logs",
                               "stage_000_generate.log"), "a") as f:
            f.write("boom \xff\n")
        return types.SimpleNamespace(returncode=2)

    monkeypatch.setattr(subprocess, "run", error)
    with pytest.raises(subprocess.CalledProcessError):
        tselftrain.main(base)
    assert len(calls) == 1  # no retry for real errors

    calls.clear()
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append(
        cmd) or types.SimpleNamespace(returncode=-9))
    with pytest.raises(subprocess.CalledProcessError):
        tselftrain.main(base)
    assert len(calls) == 3  # a stage killed three times is given up


@pytest.mark.slow
def test_selftrain_one_iteration_subprocess(tmp_path, monkeypatch):
    """One iteration of one chunk through the real stages, each a
    ``python -m gstx_torch.cli.*`` process under GSTX_PLATFORM=cpu: the
    synthetic dialogs (10 rounds with their answer_ppl), the student's
    final.ckpt, and a finetuned final.ckpt whose weights moved."""
    from gstx_torch.cli.common import build_model, parse_config
    from gstx_torch.data.feature_store import make_synthetic_store

    tmp = str(tmp_path)
    args, _ = make_cli_env(tmp)
    cfg = parse_config(args)
    ckpts = {}
    for name, seed in (("q", 0), ("a", 1)):
        model = build_model(cfg, device="cpu", seed=seed)
        ckpts[name] = os.path.join(tmp, f"{name}.ckpt")
        torch.save({"model_state_dict": model.state_dict()}, ckpts[name])
    feat_dir = os.path.join(tmp, "cc12m_feats")
    cap_dir = os.path.join(tmp, "cc12m_caps")
    os.makedirs(feat_dir)
    os.makedirs(cap_dir)
    make_synthetic_store(os.path.join(feat_dir, "cc12m_img_feat_0.store"),
                         [2000 + i for i in range(4)], num_boxes=12,
                         feat_dim=16, num_classes=11)
    make_cc12m_caption_json(os.path.join(cap_dir, "cc12m_captions_0.json"),
                            num_images=4)
    monkeypatch.setenv("GSTX_PLATFORM", "cpu")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("PYTHONPATH", repo_root + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    dialog_root = os.path.join(tmp, "dialogs")
    out_dir = os.path.join(tmp, "selftrain_out")
    plan = tselftrain.main([
        "-iterations", "1", "-chunks", "1",
        "-start_path_q", ckpts["q"], "-start_path_a", ckpts["a"],
        "-cc12m_image_feats", feat_dir, "-cc12m_caption_dir", cap_dir,
        "-dialog_root", dialog_root, "-save_path", out_dir,
        "-extra"] + args + [
        "-batch_size", "2", "-num_epochs", "1", "-log_every", "1",
        "-max_seq_len", "160", "-max_dec_len", "4",
        "-num_dialog_rounds", "10"])
    assert len(plan) == 3  # generate, student training, finetune

    dialogs = json.load(open(os.path.join(dialog_root, "iter1",
                                          "cc12m_dialogs_0.txt")))
    assert len(dialogs) >= 1, "all samples abnormal"
    for rec in dialogs:
        assert set(rec) == {"image_id", "url", "caption", "dialog"}
        assert len(rec["dialog"]) == 10
        assert all("answer_ppl" in r for r in rec["dialog"])
    student = torch.load(os.path.join(out_dir, "student_iter1", "final.ckpt"),
                         map_location="cpu")["model_state_dict"]
    finetuned = torch.load(os.path.join(out_dir, "finetune_iter1",
                                        "final.ckpt"),
                           map_location="cpu")["model_state_dict"]
    name = "decoder.decoder.lm_head.decoder.weight"
    assert student[name].shape == finetuned[name].shape
    assert not torch.allclose(student[name], finetuned[name]), \
        "the finetune did not change the handed-off student's weights"
