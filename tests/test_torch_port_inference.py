"""The port's interactive demo (gstx_torch.cli.inference) against the JAX
package's REPL (gstx.cli.inference), f32 on the CPU, on the tiny fixture
data and one reference-format checkpoint of the JAX tiny params that both
load.  Greedy (-top_k 1) transcripts must be identical line for line: the
scripted turns of tests/test_cli.py::test_cli_inference_repl, and a
session that fills the context.  The JAX REPL runs once per script, in a
module fixture."""

import os

import jax
import numpy as np
import pytest
import torch

from fixtures import make_cli_env
from gstx.cli import inference as jinference
from gstx.cli.common import build_model as j_build_model
from gstx.cli.common import init_params
from gstx.core.checkpoint import to_torch_state_dict
from gstx_torch.cli import inference as tinference
from gstx_torch.kernels import ffn as kffn

CONTEXT_FULL = "[context full — restarting would be needed]"
# (questions, extra flags, max_turns): tests/test_cli.py:438's session, and
# one whose context overflows on a short -max_seq_len
SCRIPTS = {
    "repl": (["is there a dog", "what color is it"], ["-max_dec_len", "6"],
             2),
    "context_full": (["is there a dog", "what color is it",
                      "how many people", "is it sunny", "can you see water",
                      "what is the man wearing", "is there sand",
                      "what color is the hat"],
                     ["-max_dec_len", "6", "-max_seq_len", "40"], None),
}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("port_inference"))
    args, cfg = make_cli_env(tmp)
    model, _, _ = j_build_model(cfg)
    sd = to_torch_state_dict(jax.device_get(init_params(model, cfg, seed=0)))
    ckpt = os.path.join(tmp, "model.ckpt")
    torch.save({"model_state_dict": {
        k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, ckpt)
    return args + ["-start_path", ckpt, "-top_k", "1",
                   "-data_parallel", "1"]


def _session(main, argv, questions, max_turns, **kw):
    transcript, asked = [], iter(questions)

    def scripted(prompt):
        assert prompt == "you: "
        try:
            return next(asked)
        except StopIteration:
            raise EOFError

    main(argv, input_fn=scripted, output_fn=transcript.append,
         max_turns=max_turns, **kw)
    return transcript


@pytest.fixture(scope="module")
def jax_transcripts(env):
    return {name: _session(jinference.main, env + flags, qs, turns)
            for name, (qs, flags, turns) in SCRIPTS.items()}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_greedy_transcript_matches_jax(env, jax_transcripts, name):
    questions, flags, turns = SCRIPTS[name]
    got = _session(tinference.main, env + flags, questions, turns,
                   device="cpu")
    want = jax_transcripts[name]
    assert got == want
    assert got[0].startswith("image_id: ") and got[1].startswith("caption: ")
    bots = [line for line in got if line.startswith("bot: ")]
    if name == "repl":
        assert len(bots) == 2 and len(got) == 4
    else:
        assert got[-1] == CONTEXT_FULL and len(bots) < len(questions)


@pytest.mark.parametrize("end", ["EOF", "quit", "exit", ""])
def test_session_ends_on_eof_quit_exit_or_an_empty_line(env, end):
    questions = ["is there a dog"] + ([] if end == "EOF" else
                                      [end, "never asked"])
    got = _session(tinference.main, env + ["-max_dec_len", "6"], questions,
                   None, device="cpu")
    assert len(got) == 3 and got[2].startswith("bot: ")


def test_runtime_flags_and_the_device(env, monkeypatch):
    """-no_use_pallas turns the fused kernels' switch off (-use_pallas
    back on); as the JAX CLI, -data_parallel 2 and -model_parallel 2 run
    in the one process (the same transcript); without a card the demo
    needs device="cpu" or GSTX_PLATFORM=cpu."""
    quiet = dict(input_fn=lambda prompt: "", output_fn=lambda line: None)
    tinference.main(env + ["-no_use_pallas"], device="cpu", **quiet)
    assert not kffn.is_enabled()
    tinference.main(env + ["-use_pallas"], device="cpu", **quiet)
    assert kffn.is_enabled()
    short = env + ["-max_dec_len", "6"]
    asked = ["is there a dog"]
    assert _session(tinference.main, short + ["-data_parallel", "2"], asked,
                    None, device="cpu") == \
        _session(tinference.main, short, asked, None, device="cpu")
    assert _session(tinference.main, short + ["-model_parallel", "2"],
                    asked, None, device="cpu") == \
        _session(tinference.main, short, asked, None, device="cpu")
    with pytest.raises(SystemExit, match="start_path"):
        tinference.main(env + ["-start_path", ""], device="cpu", **quiet)
    if not torch.cuda.is_available():
        monkeypatch.delenv("GSTX_PLATFORM", raising=False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tinference.main(env, **quiet)
        monkeypatch.setenv("GSTX_PLATFORM", "cpu")
        tinference.main(env, **quiet)
    kffn.enable(True)
