"""One rank of the two-rank tensor-parallel CPU runs of
``tests/test_torch_port_tp.py``:

    python -m torch.distributed.run --nproc_per_node 2 \\
        tests/torch_tp_rank.py <spec.json>

Joins the group (gloo), builds the ``spec["dp"]`` x ``spec["mp"]``
layout (one replica of two shards unless the spec says otherwise) and runs every
part of the spec in turn, each on the model group, and where the test
needs it the same work in this process without a group (the one-process
reference, which needs no collective).  Writes its
results to ``spec["out"]``.rank<r>.pt.  Imports nothing of JAX: it is a
rank of the port.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch_port_harness  # noqa: E402,F401  (the CPU thread rule)
from gstx_torch.core import checkpoint as ckpt_lib  # noqa: E402
from gstx_torch.core import mesh  # noqa: E402
from gstx_torch.core.config import (DecoderConfig, EncoderConfig,  # noqa: E402
                                    GSTConfig)
from gstx_torch.decode.dialog_engine import make_dialog_engine  # noqa: E402
from gstx_torch.decode.sampler import DecodeSettings  # noqa: E402
from gstx_torch.eval import rank_gen  # noqa: E402
from gstx_torch.kernels import decode_attn as kdecode  # noqa: E402
from gstx_torch.kernels import ffn as kffn  # noqa: E402
from gstx_torch.models import encdec, heads  # noqa: E402
from gstx_torch.models import tensor_parallel as tpar  # noqa: E402
from gstx_torch.models.encdec import GSTVisualDialog  # noqa: E402
from gstx_torch.train import train_disc, train_gen  # noqa: E402


def config_of(fields) -> GSTConfig:
    return GSTConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in fields.items()})


def tensors(path):
    return {k: torch.from_numpy(v) for k, v in np.load(path).items()}


def models(spec, tp, dtype=None):
    """(the model group's model, the one-process model) of spec's f32
    state dict."""
    enc = EncoderConfig(**spec["enc"])
    dec = DecoderConfig(**spec["dec"])
    sd = torch.load(spec["state"], weights_only=True)
    out = []
    for group in (tp, None):
        m = GSTVisualDialog(enc, dec, device="cpu", tp=group, dtype=dtype)
        m.load_state_dict(sd)
        out.append(m.eval())
    return out


def score(model, b, train=None):
    return model.score(b["input_ids"], b["image_feat"], b["image_loc"],
                       b["token_type_ids"], b["attention_mask"],
                       b["image_attention_mask"], b["dec_input_ids"],
                       b["dec_attention_mask"], train=train)


def forward(spec, axes):
    """Teacher-forced logits (gathered) and loss over the model group and
    in one process; and the control, whose row-parallel products skip
    their all-reduce."""
    model, single = models(spec, axes.tp)
    b = tensors(spec["batch"])
    labels = torch.roll(b["dec_input_ids"], -1, 1)
    out = {}
    with torch.no_grad():
        logits = score(model, b)
        out["logits"] = model.full_logits(logits)
        out["loss"] = encdec.teacher_forced_loss(logits, labels,
                                                 tp=model.vocab_tp)
        out["single_logits"] = score(single, b)
        real = tpar.RowParallelLinear.forward
        tpar.RowParallelLinear.forward = lambda self, x: torch.nn.functional\
            .linear(x, self.weight, self.bias)
        try:
            out["control_logits"] = model.full_logits(score(model, b))
        finally:
            tpar.RowParallelLinear.forward = real
    out["vocab_sharded"] = model.vocab_tp is not None
    out["word_rows"] = model.bert.embeddings.word_embeddings.weight.shape[0]
    return out


def steps(spec, axes):
    """One generative and one discriminative step over the layout (each
    replica on its stripe of the batch) and in one process: dropout-free
    (the discriminative one under remat ``full``), and with one replica
    the generative one again with the models' dropout (0.1 everywhere)
    under remat ``small`` (the replicas of a data axis draw masks of
    their own); the model group's checkpoint of the
    dropout-free generative step and the gathered state after each
    step."""
    out = {}
    kinds = (("gen", "gen"), ("disc", "disc"))
    if axes.dp is None:
        kinds += (("gen_dropout", "gen"),)
    for kind, part in kinds:
        cfg = spec[part]
        config = config_of(cfg["config_dropout" if kind == "gen_dropout"
                                else "config"])
        full = part == "gen"
        batch = dict(np.load(cfg["batch"]))
        n = next(iter(batch.values())).shape[0] // axes.data_size
        stripe = {k: v[axes.data_rank * n:(axes.data_rank + 1) * n]
                  for k, v in batch.items()}
        res = {}
        for name, group in (("tp", axes.tp), ("one", None)):
            dp = axes.dp if name == "tp" else None
            real = encdec.FUSION_DROPOUT, heads.POOLED_DROPOUT
            if kind != "gen_dropout":
                encdec.FUSION_DROPOUT = heads.POOLED_DROPOUT = 0.0
            try:
                model, opt = train_gen.init_model_and_state(
                    config, 100, "cpu", use_decoder=full,
                    warmup_steps=None if full else
                    train_disc.DISC_WARMUP_STEPS, tp=group)
                model.load_state_dict(torch.load(cfg["state"],
                                                 weights_only=True))
                # recomputation reruns a region's forward all-reduces
                # inside the backward
                remat = {"gen": None, "disc": "full",
                         "gen_dropout": "small"}[kind]
                step = train_gen.make_train_step(
                    model, opt, config.batch_size, remat=remat, dp=dp) \
                    if full else train_disc.make_disc_train_step(
                        model, opt, config, remat, dp)
                loss = step(batch if dp is None else stripe,
                            train_gen.iteration_generator(0, 3))
            finally:
                encdec.FUSION_DROPOUT, heads.POOLED_DROPOUT = real
            res[name] = dict(loss=loss, state=model.full_state_dict(),
                             norms=train_gen.grad_norms(model))
            if kind == "gen" and name == "tp" and spec.get("ckpt"):
                path = spec["ckpt"]
                ckpt_lib.save_checkpoint(path, model, opt, 1)
                with torch.no_grad():
                    res["ckpt_logits"] = model.full_logits(
                        score(model.eval(), tensors(spec["batch"])))
            if kind == "gen" and name == "one":
                res["optimizer"] = opt.state_dict()
        out[kind] = res
    return out


def engine(spec, axes):
    """Greedy f32 dialogs over the model group, static and dynamic
    buckets; the int8 path with the decode kernel's switch on, counting
    its calls and the decode steps; and the fused kernels' calls of a
    bf16 forward at width 128, over the group and in one process."""
    tp = axes.tp
    out = {}
    qa = []
    for state in (spec["state"], spec["state_a"]):
        m, _ = models(dict(spec, state=state), tp)
        qa.append(m)
    batch = dict(np.load(spec["gen_batch"]))
    greedy_q = dict(max_steps=5, top_k=1, ngram_blocking_size=4)
    greedy_a = dict(max_steps=5, top_k=1, ngram_blocking_size=0)
    for name, kw in (("static", dict(context_buckets=(24,))),
                     ("dynamic", dict(context_buckets=(20, 28),
                                      dynamic_buckets=True))):
        run = make_dialog_engine(
            num_rounds=3, q_settings=DecodeSettings(**greedy_q),
            a_settings=DecodeSettings(**greedy_a), device="cpu", **kw)
        got = run(qa[0], qa[1], batch, torch.Generator().manual_seed(11))
        out[name] = {k: getattr(got, k) for k in
                     ("questions", "answers", "answer_ppl", "abnormal")}
    # the int8 memory on the rank's heads, the decode kernel's switch on
    calls = {"quant": 0, "steps": 0}
    real_q, real_step = kdecode.quant_decode_attention, \
        GSTVisualDialog.decode_step

    def counted_q(*a, **kw):
        calls["quant"] += 1
        assert a[0].shape[1] == qa[0].dec.local_heads
        return real_q(*a, **kw)

    def counted_step(self, *a, **kw):
        calls["steps"] += 1
        return real_step(self, *a, **kw)
    kdecode.quant_decode_attention = counted_q
    GSTVisualDialog.decode_step = counted_step
    kdecode.enable_kernel()
    try:
        q8, _ = models(spec, tp)
        run = make_dialog_engine(
            num_rounds=2, q_settings=DecodeSettings(**greedy_q),
            a_settings=DecodeSettings(**greedy_a), dtype=torch.bfloat16,
            quantize_memory=True, device="cpu")
        got = run(q8, q8, batch, torch.Generator().manual_seed(11))
    finally:
        kdecode.enable_kernel(False)
        kdecode.quant_decode_attention = real_q
        GSTVisualDialog.decode_step = real_step
    out["int8"] = dict(calls, layers=len(q8.dec.layers),
                       answers=got.answers)
    # the fused kernels at bf16, width 128: declined on a sharded layer
    wide = dict(spec, enc=dict(spec["enc"], **spec["wide_enc"]),
                dec=dict(spec["dec"], **spec["wide_dec"]))
    fused = {"tp": 0, "one": 0}
    real = kffn.fused_ffn, kffn.fused_dense_ln
    which = ["tp"]

    def count(fn):
        def call(*a, **kw):
            fused[which[0]] += 1
            return fn(*a, **kw)
        return call
    kffn.fused_ffn, kffn.fused_dense_ln = (count(f) for f in real)
    try:
        for name, group in (("tp", tp), ("one", None)):
            which[0] = name
            m = GSTVisualDialog(EncoderConfig(**wide["enc"]),
                                DecoderConfig(**wide["dec"]), device="cpu",
                                tp=group, dtype=torch.bfloat16).eval()
            with torch.no_grad():
                score(m, tensors(spec["batch"]))
    finally:
        kffn.fused_ffn, kffn.fused_dense_ln = real
    out["fused_calls"] = fused
    return out


def clis(spec, axes):
    """Both evaluators, the attack evaluation (FGSM and random_token with
    the dialog model's own MLM head), the generation CLI, two steps of the
    discriminative trainer's CLI and the demo, each on the two ranks under
    ``-model_parallel 2 -distributed``."""
    from gstx_torch.cli import evaluate_disc as disc_cli
    from gstx_torch.cli import evaluate_gen as eval_cli
    from gstx_torch.cli import evaluate_gen_attack as attack_cli
    from gstx_torch.cli import generate as gen_cli
    from gstx_torch.cli import inference as repl_cli
    from gstx_torch.cli import train_disc as train_disc_cli

    out = {}
    real = rank_gen.gather_scores
    for name, cli in (("eval", eval_cli), ("eval_disc", disc_cli)):
        scores = []

        def recording(*a, **kw):
            got = real(*a, **kw)
            if got is not None:
                scores.append(got.numpy().copy())
            return got
        rank_gen.gather_scores = recording
        try:
            out[name] = dict(result=cli.main(spec[f"{name}_argv"],
                                             device="cpu"),
                             scores=scores)
        finally:
            rank_gen.gather_scores = real
            kffn.enable(True)
    stats = {}
    train_disc_cli.main(spec["train_disc_argv"], max_steps=2, device="cpu",
                        stats_out=stats)
    out["train_disc"] = stats["losses"]
    out["attack"] = attack_cli.main(spec["attack_argv"], device="cpu")
    out["token"] = attack_cli.main(spec["token_argv"], device="cpu")
    out["generate"] = gen_cli.main(spec["generate_argv"], device="cpu")
    questions = iter(spec["questions"])
    transcript = []

    def scripted(prompt):
        try:
            return next(questions)
        except StopIteration:
            raise EOFError
    repl_cli.main(spec["repl_argv"], input_fn=scripted,
                  output_fn=transcript.append, max_turns=spec["max_turns"],
                  device="cpu")
    out["transcript"] = transcript
    return out


PARTS = {"forward": forward, "steps": steps, "engine": engine,
         "clis": clis}


def main():
    spec = json.load(open(sys.argv[1]))
    backend = mesh.init_distributed("cpu")
    axes = mesh.make_groups(spec.get("dp", 1), spec.get("mp", 2), "cpu")
    out = {"backend": backend, "rank": mesh.process_index()}
    for name in spec["parts"]:
        out[name] = PARTS[name](spec, axes)
    torch.save(out, f"{spec['out']}.rank{mesh.process_index()}.pt")


if __name__ == "__main__":
    main()
