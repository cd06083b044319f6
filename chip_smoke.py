#!/usr/bin/env python3
"""Drive the PyTorch port (gstx_torch) on one CUDA card.

  phase 1  the card: its name and power limit (nvidia-smi), and the build of
           the CUDA kernels from gstx_torch/kernels/csrc with nvcc (sm_90a):
           ptxas's registers and spills per kernel, and a cuobjdump SASS
           census of the attention, dense_ln and FFN kernels (a bf16
           attention, a dense_ln or an FFN instance without HMMA and LDGSTS
           instructions fails);
  phase 2  each kernel against its plain PyTorch version at every shape
           the main paths give it plus a ragged one (and, for attention,
           K/V views whose rows past Lk hold NaN; for fused_dense_ln and
           fused_ffn, the evaluators' scoring chunks at context 256: the
           generative val chunk of 500 sequences, 128,000 text and 18,500
           visual rows; the discriminative chunk of 200, 51,200 and 7,400;
           the generative test chunk of 400, 102,400 and 14,800; the
           attack evaluation's chunk of 100, 25,600 and 3,700; each visual
           count ends in a partial 32-row block; and random_token's refill
           of one context, 256 text rows through the attacker's layers
           and the dialog encoder's, 37 visual rows): bf16 fused_dense_ln,
           fused_ffn, fused_attention and fused_attention_batch within
           |kernel - plain| <= 1e-2 + 1.6e-2 * |plain| (about 2 bf16 ulps);
           quant_decode_attention (f32 out of exact int8 operands) within
           5e-3 + 1e-4 * |plain|, also at phase 11's beam shape (B*K
           128 rows); quant_decode_attention at a rank's 6 heads under
           -model_parallel 2 (B 96 and 128, M 293) and fused_attention at
           96 x 6 x 256 x 256 x 64 (phase 15).  Gradient rows for fused_ffn and
           fused_dense_ln at phase 8's training shapes (18,432 text rows
           x 768, F 3,072; BiOutput-t 18,432 x 1,024 -> 768; 2,664 visual
           rows x 1,024), a rank's share of phase 14's two-rank step at
           batch 72 (9,216 / 1,332 rows) and phase 10's FGSM chunk (25,600
           / 3,700 rows):
           the autograd Function (kernel forward, f32
           recompute backward) against autograd through the plain version,
           every gradient within the bf16 tolerance, with the backward's
           time beside the forward's.  Device times (CUDA events around 20
           back-to-back calls queued behind a device sleep, median of 5,
           after 3 warm-up calls) of the kernel, the plain version and one
           PyTorch call of the same function (for the attention kernels
           scaled_dot_product_attention in bf16; for the decode kernel the
           same call over K/V already converted to bf16, the conversion not
           timed: the bf16-memory path's cost per call), beside the least
           time the card could take (bf16 tensor-core FLOPs at 989 TFLOP/s
           or compulsory bytes at 3.35 TB/s, whichever is larger);
  phase 3  the dialog engine at full width (12/6/6-layer encoder, 12-layer
           decoder, bf16, random weights from a seed) on bench.py's
           workload: batch 96, context 256, 37 regions, caption-only
           contexts, buckets 128/192, questions at T=0.7 / top-k 7 / n-gram
           4, answers without n-gram blocking, 18 steps.  A small input
           first checks the bf16 kernel path against the f32 unfused model;
           then one warm-up batch, then the timed batches, with every
           kernel's launch count set to 0 just before and read just after
           (the attention and decode kernels must stay at 0: their switches
           are off, as in the reference's default);
  phase 4  where the time goes: one round's pieces (encoder, decode,
           answer scoring) and one profiled round (device busy share, top
           kernels), the profiled round at the end of the run;
  phase 5  the engine with every optional kernel on, as the reference's
           `bench.py -quant 1 -decode_kernel 1` with its attention switch
           on: int8 decode memory, quant_decode_attention in every decode
           step, fused_attention in every attention of 8 or more query rows.
           The same model and workload as phase 3; a small input first
           checks the int8 decode step against the f32 unfused model
           (max |dlogit| / max |logit| < 0.05, the JAX package's int8
           criterion) and the dequantized memory within phase 3's limit;
           then warm-up, timed batches with counted launches, phase 4's
           breakdown for this configuration, and one batch of each
           configuration in turns (default, all kernels, all kernels,
           default), since the host's speed drifts within a run;
  phase 6  the port's generation CLI (gstx_torch.cli.generate.main)
           in-process at full width, as a user runs it: a 30,522-word
           WordPiece vocab, a synthetic store of 200 images x 36 boxes x
           2,048 features, 8-16-word captions, and the full-width model
           from a seed saved as a reference .ckpt with bench.py's
           short-answer EOS bias (+3.0 on [SEP]'s logit) so that random
           weights end their utterances.  -mode cc12m_gen, bf16, batch 96
           (two full batches and one of 8), buckets 128/192, 10 rounds, the
           default sampling, -use_pallas, -host_prefetch, -pipeline 2.
           Launches counted over the run (fused_ffn and fused_dense_ln 600
           a batch, the rest 0); the JSON must equal main's return, hold
           one 10-round record with finite perplexities for each
           non-abnormal image, and the sidecar must be gone.  Prints the
           run's img/s and generated tok/s and whether the native host
           paths served.  The seeded model is also saved encoder-only
           (bert_pretrained.*) for phase 7;
  phase 7  the port's evaluator CLIs (gstx_torch.cli.evaluate_gen /
           evaluate_disc .main) in-process at full width, bf16,
           -use_pallas, on phase 6's vocab and checkpoints: a synthetic
           VisDial v1.0 val set of 20 dialogs x 10 rounds x 100 options
           with dense annotations, a test set of 4 dialogs, and a store of
           those 24 images.  Generative vd_eval_val (one batch of 20 =
           20,000 sequences in 40 chunks of 500: 1,200 fused_ffn and 1,200
           fused_dense_ln, 30 a chunk, the rest 0) with finite metrics in
           range and performance_log.txt; vd_eval_test (one chunk of 400:
           30 / 30) writing 4 permutations of 1..100 to predictions.txt;
           the same with -no_use_pallas (0 launches); discriminative
           vd_eval_val with the encoder-only model (100 chunks of 200:
           3,000 / 3,000).  Prints each run's main() wall time, scored
           sequences and images a second in its batch loop and peak device
           memory.  Then the bf16 kernel path against the f32 unfused model
           on the first image's first round (100 options): generative and
           NSP scores, centred over the options, within a relative error
           of EVAL_SCORE_TOL, and two controls on the kernel path that must
           exceed it (every fused_ffn's FFN branch zeroed; every
           fused_dense_ln's projection zeroed), beside the bf16 unfused
           model's reading;
  phase 8  the port's training CLI (gstx_torch.cli.train_gen.main)
           in-process at full width, bf16 compute over f32 parameters and
           optimizer state, -remat_policy small, batch 72, warm-started
           from phase 6's .ckpt, on 576 synthetic dialogs over phase 6's
           store: (a) the student, -mode cc12m_train -chunk 1
           -select_data with the reference dropout, 1 warm-up and 5 timed
           steps with -save_every_steps 3: no fused launch (JAX's gate
           declines a site whose dropout is active), each step's loss
           finite, ms/step, examples/s, MFU (the step's matmul FLOPs from
           shapes, 3x the forward, over 989 TFLOP/s), peak memory, each
           checkpoint's size and save time; (c) -continue from (a)'s
           rotating checkpoint for 2 steps, starting at its stored step 6;
           (b) the teacher, -mode vd_train -model enc_dec_a with every
           dropout 0: 2 steps of 30 fused_ffn and 30 fused_dense_ln
           launches (the encoder forward's; 'small' recomputes no fused
           site), the first step's loss and per-tensor gradient norms
           against the same step under -no_use_pallas within
           TRAIN_LOSS_TOL / TRAIN_GRAD_NORM_TOL, and a control whose
           dense_ln backward loses the residual's gradient, which must
           exceed the norms' limit; the second (warm) step's time with the
           kernels beside the unfused one's;
  phase 9  the port's discriminative training CLI
           (gstx_torch.cli.train_disc.main) in-process at full width: the
           encoder-only model, bf16 compute over f32 parameters,
           -remat_policy small, batch 72 rows drawn from 72 dialogs x 10
           rounds x (the positive and one negative), warm-started from the
           encoder part of phase 6's full .ckpt, on 144 synthetic VisDial
           v1.0 train dialogs of 100 options over phase 6's store with
           dense pseudo-labels: (a) the reference dropout, 1 warm-up and 3
           timed steps, no fused launch, the three losses finite, ms/step,
           examples/s, MFU (matmul FLOPs from shapes, 3x the forward, the
           MLM head's vocab projection included), peak memory, each
           checkpoint's size and save time; (c) -continue from (a)'s
           rotating checkpoint, at its stored step 4; (b) -train_dense with
           every dropout 0 but the heads' fixed 0.1: 2 steps of 30 fused_ffn
           and 30 fused_dense_ln launches (the encoder forward's), the first
           step against -no_use_pallas within phase 8's limits, the
           broken-backward control above them, and the warm steps' times
           side by side (phases 8 and 9 share training_phase);
  phase 10 the port's attack evaluation CLI
           (gstx_torch.cli.evaluate_gen_attack.main) in-process at full
           width, bf16, -use_pallas, batches of one dialog, on phase 7's val
           set and phase 6's .ckpt: FGSM (epsilon 1) on 4 dialogs,
           random_token with a seeded bert-base-shaped attacker saved as a
           Hugging Face-named pytorch_model.bin (-mlm_path) on 2,
           random_token with the dialog model's own MLM head on 1, and
           coreference with a synthetic counter-fitted similarity and
           dependency JSON on 2: each run's launches against those derived
           from the code (attack_launches), the contexts a text attack
           changed, metrics in range, scored sequences/s and peak memory.
           Then on the first dialog's dense round the FGSM input gradient
           of the bf16 kernel path (kernels forward, f32 recompute
           backward) against the f32 unfused model's: cosine similarity
           at least FGSM_COS_TOL, a control whose dense_ln backward loses
           the residual's gradient below it, and the scores of the
           features the kernel path perturbed, centred over the options,
           within EVAL_SCORE_TOL["gen"] of the f32 model's.
  phase 11 beam search (gstx_torch.decode.beam) at full width,
           -use_pallas, on phase 6's .ckpt: batch 32, context 256, 37
           regions, 18 steps.  In bf16 with the .ckpt's EOS bias (beams
           end early): (a) K = 1 equal to greedy sample_sequence through
           the same step, token for token; (b) K = 4 (128 rows), 30 / 30
           fused launches (one decode_prepare), every beam's score within
           BEAM_SCORE_TOL nats of its teacher-forced log-likelihood from
           one cache-less pass.  Without the bias (every beam runs every
           step): (b) again; (c) over the int8 memory with the decode
           kernel on (quant_decode_attention 12 x 18 launches), its tokens
           beside (b)'s; then in f32 (a) again and the cache reorder: every
           score within BEAM_REORDER_TOL, a control that skips the reorder
           above it.  ms a beam step and generated tok/s;
  phase 12 the interactive demo (gstx_torch.cli.inference.main)
           in-process at full width on phase 6's .ckpt and vocab and phase
           7's val set: 4 scripted greedy turns under -use_pallas (30 / 30
           launches a turn) and -no_use_pallas (0), ms a turn, both
           transcripts side by side (a bf16 near-tie may flip a token);
  phase 13 one GST iteration as a user runs it: python -m
           gstx_torch.cli.selftrain -iterations 1 -chunks 1 in a
           subprocess (each stage a process on the card) on a CC12M chunk
           of 96 images, phase 6's .ckpt as questioner and teacher, batch
           72, one epoch, phase 8's VisDial train set capped at 144
           dialogs: every stage's exit code, the dialog file, both
           final.ckpt files and the finetune's moved weights; each stage's
           wall time and checkpoint size.
  phase 14 the port's multi-process paths (gstx_torch.core.mesh) at full
           width on the one card, every rank a process of this script
           (``--rank``) with the launcher's environment: (a) train_gen
           -distributed in a group of one over nccl, phase 8 (b)'s teacher
           with -use_pallas, 3 steps: 30 / 30 launches a step, the first
           loss within TRAIN_LOSS_TOL of the run without -distributed;
           (b) two ranks over gloo (NCCL takes one rank a device), the
           generative and the discriminative trainers' step on one fixed
           global batch of 72 dialogs (36 a rank), dropout-free (the
           fusion's and the heads' fixed dropout off too), lr DP_LR,
           against the single-process step rank 0 takes first: in bf16
           with the kernels (30 / 30 launches a rank) the loss within
           TRAIN_LOSS_TOL and gradient norms within TRAIN_GRAD_NORM_TOL,
           warm steps timed; in f32 every updated parameter within the
           bf16 tolerance, and a control that skips the gradient
           all-reduce must leave parameters beyond it; (c) the
           generation CLI on two ranks over phase 6's inputs: the .procN
           shards reassemble phase 6's images once each, summed img/s
           and each rank's launches; then f32 greedy on DP_GREEDY_IMAGES
           images, the ranks' dialogs equal to one process's; (d)
           evaluate_gen on two ranks on phase 7's val set: rank 0's
           gathered scores within EVAL_SCORE_TOL["gen"] (centred, per
           round) of phase 7's, the log written once, scored sequences/s;
           (e) two ranks on the one card under nccl must raise.  Each
           part's wall time.
  phase 15 tensor parallelism (-model_parallel 2, gstx_torch.models.
           tensor_parallel) at full width on the one card: two ranks of
           this script over gloo (NCCL takes one rank a card; gloo's
           collectives are a host transport, not TP's speed), phase 6's
           .ckpt without its EOS bias: (a) teacher-forced logits on 4
           contexts of 256, f32 with TF32 off within TP_LOGIT_TOL of one
           process's, a control whose row-parallel products skip their
           all-reduce beyond it; in bf16 (and (c)'s int8 memory) the
           group's relative error to the f32 logits within TP_BF16_RATIO
           of one process's, the elementwise comparison beside it, and
           one row-parallel product whose outputs differ from the f32
           product rounded once in at most TP_ROUNDING_SHARE of them,
           with a control that rounds each rank's partial to bf16 before
           the all-reduce beyond it; (b)
           greedy f32 dialogs from the engine (TP_IMAGES images, 2
           rounds, 18 steps): the identical share and the first
           divergence, and past it every token within TP_ARGMAX_TOL of
           one process's teacher-forced argmax; (c) the bf16 engine over
           the int8 memory with the decode and attention kernels on, one
           round: quant_decode_attention layers x decode steps a rank, on
           6 heads, fused_attention every attention, fused_ffn /
           fused_dense_ln 0 (declined on a sharded site), tok/s beside one
           process's, the collectives' share of a run with a sync around
           each collective, peak memory, the build's peak; (d) train_gen
           and train_disc, one dropout-free f32 step
           each (TP_TRAIN_BATCH rows, lr DP_LR) against one process's
           (loss within TRAIN_LOSS_TOL, every gathered parameter within
           the bf16 tolerance), the generative one again with the
           reference dropout, and a control whose copy-to-model backward
           skips its all-reduce beyond it; (f) two greedy f32 turns of the
           demo, the transcript one process's; (e) evaluate_gen
           -model_parallel 2 on phase 7's first dialog, its first
           TP_EVAL_OPTIONS options a round, rank 0's scores within
           EVAL_SCORE_TOL["gen"] of phase 7's, the log written once; (g) -model_parallel 3 exits with JAX's
           validate_model_parallel message.  Each part's wall time.

The two profiled rounds of phases 4 and 5 come last: engine timings taken
after a profiled round ran 26-50% slower.  Phases 6 to 13 write their
inputs and checkpoints to one temporary directory.  Prints the kernels JSON line,
the card line, and last ``{"ok": true, "device": {...}}``.  Any failure
exits non-zero with no result; so does a machine without CUDA or a
directory without gstx_torch.

    python3 chip_smoke.py
    python3 chip_smoke.py --dp-cards 4 2   # phase 14 (b), (d) over nccl
    python3 chip_smoke.py --tp-cards 2 4   # phase 15 (a)-(e), (g) over
                                           # nccl: 1 x 2 and 2 x 2, (c) at
                                           # 96 images, (d) at 72 rows
                                           # with a warm step
    python3 chip_smoke.py --tp-cards 1     # phase 15 alone, one card
"""

import contextlib
import copy
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
ABS_TOL, REL_TOL = 1e-2, 1.6e-2
# f32-unfused vs bf16-kernel model on a small input: relative Frobenius
# error of the decoder memory K/V and of the logits (bf16 rounding through
# ~20 sequential layers)
MODEL_REL_TOL = 5e-2
# phase 7: one round's bf16 kernel-path scores against the f32 unfused
# model's, both centred over the round's options (relative error), for the
# generative and the NSP scorer; a control with a kernel's output broken
# must exceed it
EVAL_SCORE_TOL = {"gen": 1e-2, "disc": 0.3}
# int8 decode step vs the f32 unfused model: max |dlogit| / max |logit|
# (tests/test_quantized_memory.py:108)
INT8_LOGIT_TOL = 5e-2
# quant_decode_attention: f32 out of exact int8 operands, summation order
DECODE_ABS_TOL, DECODE_REL_TOL = 5e-3, 1e-4
# ~10 ms of device sleep at the H100's clock: more than the host needs to
# enqueue time_ms's calls
SLEEP_CYCLES = 20_000_000
ROUNDS = 10         # bench.py's dialog length
TIMED_BATCHES = 2   # after one warm-up batch


def log(*a):
    print(*a, flush=True)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3, repeats=5):
    """Device time of one call: CUDA events around ``iters`` back-to-back
    calls, median over ``repeats``.  A device-side sleep queued first lets
    the host enqueue all the calls before the first one runs, so a call
    shorter than its Python wrapper's host time is timed on the device and
    not on the host."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool:
        res = subprocess.run([tool], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        out = res.stdout.splitlines()
        if res.returncode == 0 and len(out) == len(names):
            names = out
    return [re.sub(r"\(anonymous namespace\)::|^void ", "", n) for n in names]


def build_census(build):
    """Phase 1: ptxas's registers and spills for every kernel, and the
    attention, dense_ln and FFN kernels' instructions in the built
    library's SASS: tensor-core products (HMMA), asynchronous copies
    (LDGSTS), ldmatrix (LDSM) and f32 FMAs (FFMA).  Fails if a bf16
    (mma_attention_kernel), a dense_ln_kernel or an ffn_kernel instance has
    no HMMA or no LDGSTS."""
    text = "\n".join(build.build_log)
    segs = re.split(r"Compiling entry function '", text)[1:]
    spills = {"dense_ln_kernel": [], "ffn_kernel": []}
    for name, seg in zip(demangle([g.split("'")[0] for g in segs]), segs):
        regs = re.search(r"Used (\d+) registers", seg)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", seg)
        log(f"[phase 1] ptxas {name}: "
            f"{regs.group(1) if regs else '?'} registers, spill stores/loads "
            f"{'/'.join(spill.groups()) if spill else '?'} bytes")
        for kernel, found in spills.items():
            if kernel in name and spill:
                found.append(int(spill.group(1)) + int(spill.group(2)))
    if not segs:
        log("[phase 1] ptxas: no build log (library cached); not measured")
    for kernel, found in spills.items():
        if found:
            log(f"[phase 1] ptxas {kernel}: {len(found)} instances, "
                f"{sum(s > 0 for s in found)} with spills (most "
                f"{max(found)} bytes stored + loaded)")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("[phase 1] SASS census: no cuobjdump; not measured")
        return
    sass = subprocess.run([tool, "-sass", str(build.build())],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    blocks = [b for b in sass.split("Function : ")[1:]
              if re.search(r"attention_kernel|ffn_kernel|dense_ln_kernel",
                           b.split()[0])]
    for name, block in zip(demangle([b.split()[0] for b in blocks]), blocks):
        counts = {op: len(re.findall(rf"\b{op}\b", block))
                  for op in ("HMMA", "LDGSTS", "LDSM", "FFMA")}
        log(f"[phase 1] SASS {name}: " + ", ".join(
            f"{op} {n}" for op, n in counts.items()))
        if re.search(r"mma_attention_kernel|ffn_kernel|dense_ln_kernel",
                     name) and \
                not (counts["HMMA"] and counts["LDGSTS"]):
            raise AssertionError(f"{name}: no tensor-core or cp.async "
                                 "instruction in its SASS")


def make_randn(torch, gen):
    """Seeded normal draws on the card: ``randn(*shape, scale, dtype,
    shift)``, bf16 unless ``dtype`` says otherwise."""
    def randn(*shape, scale=1.0, dtype=torch.bfloat16, shift=0.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale
                + shift).to(dtype)
    return randn


# (label, M, K, D): the attention-output projections and BiOutput as the
# encoder calls fused_dense_ln (B = 96), a ragged M, and the text ones at
# the context buckets 128 and 192
DENSE_LN_SHAPES = [("text 24576x768->768", 24576, 768, 768),
                   ("visual/BiOutput-v 3552x1024->1024", 3552, 1024, 1024),
                   ("BiOutput-t 24576x1024->768", 24576, 1024, 768),
                   ("ragged 1000x768->768", 1000, 768, 768),
                   ("text ctx128 12288x768->768", 12288, 768, 768),
                   ("text ctx192 18432x768->768", 18432, 768, 768),
                   # the evaluators' scoring chunks at context 256 and 37
                   # regions, whose visual rows end in a partial 32-row
                   # block: the generative val chunk of 500 sequences, the
                   # discriminative chunk of 200, the generative test
                   # chunk of 400
                   ("eval text 128000x768->768", 128000, 768, 768),
                   ("eval BiOutput-t 128000x1024->768", 128000, 1024, 768),
                   ("eval visual tail 18500x1024->1024", 18500, 1024, 1024),
                   ("eval disc text 51200x768->768", 51200, 768, 768),
                   ("eval disc BiOutput-t 51200x1024->768", 51200, 1024, 768),
                   ("eval disc visual tail 7400x1024->1024", 7400, 1024,
                    1024),
                   ("eval test text 102400x768->768", 102400, 768, 768),
                   ("eval test BiOutput-t 102400x1024->768", 102400, 1024,
                    768),
                   ("eval test visual tail 14800x1024->1024", 14800, 1024,
                    1024),
                   # the attack evaluation's chunk (one round's 100
                   # options: 25,600 text rows, 3,700 visual rows)
                   ("attack text 25600x768->768", 25600, 768, 768),
                   ("attack BiOutput-t 25600x1024->768", 25600, 1024, 768),
                   ("attack visual tail 3700x1024->1024", 3700, 1024, 1024),
                   # random_token's refill of one 256-token context: the
                   # attacker BertMLM's layers (text) and the dialog
                   # encoder's own forward of one row (text, BiOutput-t
                   # and 37 visual rows, a partial 32-row block)
                   ("mlm text 256x768->768", 256, 768, 768),
                   ("mlm BiOutput-t 256x1024->768", 256, 1024, 768),
                   ("mlm visual 37x1024->1024", 37, 1024, 1024),
                   # phase 11's decode_prepare: 32 contexts of 256 and 37
                   # regions (1,184 visual rows, a partial 64-row block);
                   # phase 12's one context is the mlm rows'
                   ("beam text 8192x768->768", 8192, 768, 768),
                   ("beam BiOutput-t 8192x1024->768", 8192, 1024, 768),
                   ("beam visual 1184x1024->1024", 1184, 1024, 1024),
                   # phase 13's generate stage: 96 images at batch 72 and
                   # context 256, a batch of 72 (the training rows of
                   # GRAD_SHAPES, forward included) and one of 24
                   ("selftrain tail text 6144x768->768", 6144, 768, 768),
                   ("selftrain tail BiOutput-t 6144x1024->768", 6144, 1024,
                    768),
                   ("selftrain tail visual 888x1024->1024", 888, 1024,
                    1024)]


def dense_ln_inputs(torch, randn, m, k, d):
    """x, w, b, residual, gamma, beta for fused_dense_ln."""
    f32 = torch.float32
    x, res = randn(m, k), randn(m, d)
    w, b = randn(d, k, scale=0.02), randn(d, scale=0.02, dtype=f32)
    g, be = randn(d, scale=0.1, shift=1.0, dtype=f32), \
        randn(d, scale=0.1, dtype=f32)
    return x, w, b, res, g, be


# (label, M, D, F): the text FFN at each context bucket (B = 96) and the
# visual / co-attention FFN, as the encoder calls fused_ffn, and a ragged M
FFN_SHAPES = [("text 24576x768x3072", 24576, 768, 3072),
              ("visual/co-v 3552x1024x1024", 3552, 1024, 1024),
              ("ragged 1000x768x3072", 1000, 768, 3072),
              ("text ctx128 12288x768x3072", 12288, 768, 3072),
              ("text ctx192 18432x768x3072", 18432, 768, 3072),
              # the evaluators' scoring chunks, as DENSE_LN_SHAPES
              ("eval text 128000x768x3072", 128000, 768, 3072),
              ("eval visual tail 18500x1024x1024", 18500, 1024, 1024),
              ("eval disc text 51200x768x3072", 51200, 768, 3072),
              ("eval disc visual tail 7400x1024x1024", 7400, 1024, 1024),
              ("eval test text 102400x768x3072", 102400, 768, 3072),
              ("eval test visual tail 14800x1024x1024", 14800, 1024, 1024),
              ("attack text 25600x768x3072", 25600, 768, 3072),
              ("attack visual tail 3700x1024x1024", 3700, 1024, 1024),
              ("mlm text 256x768x3072", 256, 768, 3072),
              ("mlm visual 37x1024x1024", 37, 1024, 1024),
              # phases 11 and 13, as DENSE_LN_SHAPES
              ("beam text 8192x768x3072", 8192, 768, 3072),
              ("beam visual 1184x1024x1024", 1184, 1024, 1024),
              ("selftrain tail text 6144x768x3072", 6144, 768, 3072),
              ("selftrain tail visual 888x1024x1024", 888, 1024, 1024)]


def ffn_inputs(torch, randn, m, d, f):
    """x, w1, b1, w2, b2, gamma, beta for fused_ffn."""
    f32 = torch.float32
    x = randn(m, d)
    w1, b1 = randn(f, d, scale=0.02), randn(f, scale=0.02, dtype=f32)
    w2, b2 = randn(d, f, scale=0.02), randn(d, scale=0.02, dtype=f32)
    g, be = randn(d, scale=0.1, shift=1.0, dtype=f32), \
        randn(d, scale=0.1, dtype=f32)
    return x, w1, b1, w2, b2, g, be


def kernel_phase(torch, kffn, kattn, kdecode):
    """Phase 2: returns the per-kernel JSON entries."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    randn = make_randn(torch, gen)

    def held(name, label, k, p, abs_tol=ABS_TOL, rel_tol=REL_TOL):
        err = (k.float() - p.float()).abs()
        lim = abs_tol + rel_tol * p.float().abs()
        if not bool(torch.isfinite(k.float()).all()) or \
                not bool((err <= lim).all()):
            raise AssertionError(
                f"{name}[{label}]: kernel disagrees with its plain version:"
                f" max |err| {float(err.max()):.4g}, worst err/limit "
                f"{float((err / lim).max()):.3g}")
        return float(err.max())

    entries = []
    # the context-bucket shapes and the eval shapes draw from generators of
    # their own, so the other rows' inputs stay those of earlier runs
    def draws(n_first, n_ctx, seed, n):
        own = [make_randn(torch, torch.Generator(device=dev).manual_seed(s))
               for s in (seed, seed + 10)]
        return [randn] * n_first + [own[0]] * n_ctx + \
            [own[1]] * (n - n_first - n_ctx)
    ln_draws = draws(4, 2, 5, len(DENSE_LN_SHAPES))
    rows = []
    for i, (label, m, k, d) in enumerate(DENSE_LN_SHAPES):
        args = dense_ln_inputs(torch, ln_draws[i], m, k, d)
        x, w, b, res, g, be = args
        err = held("fused_dense_ln", label, kffn.fused_dense_ln(*args),
                   kffn.dense_ln_plain(*args))
        b16, g16, be16 = b.to(bf), g.to(bf), be.to(bf)
        lib = time_ms(lambda: F.layer_norm(F.linear(x, w, b16) + res, (d,),
                                           g16, be16, 1e-12))
        flops = 2 * m * k * d
        nbytes = 2 * (m * k + d * k + 2 * m * d) + 4 * 3 * d
        bms, by = bound(flops, nbytes)
        rows.append(dict(shape=label, max_abs_err=err,
                         ms=time_ms(lambda: kffn.fused_dense_ln(*args)),
                         plain_ms=time_ms(lambda: kffn.dense_ln_plain(*args)),
                         bound_ms=bms, bound_by=by, library_ms=lib,
                         block_rows=kffn.block_rows(m, d)))
        log(f"[phase 2] fused_dense_ln {label}: " + json.dumps(rows[-1]))
    entries.append(("fused_dense_ln", "gstx/kernels/ffn.py:254", rows))

    # after the first three, as above (the attention rows' inputs stay
    # those of earlier runs)
    ffn_draws = draws(3, 2, 4, len(FFN_SHAPES))
    rows = []
    for i, (label, m, d, f) in enumerate(FFN_SHAPES):
        args = ffn_inputs(torch, ffn_draws[i], m, d, f)
        x, w1, b1, w2, b2, g, be = args
        err = held("fused_ffn", label, kffn.fused_ffn(*args),
                   kffn.ffn_plain(*args))
        b116, b216, g16, be16 = b1.to(bf), b2.to(bf), g.to(bf), be.to(bf)
        lib = time_ms(lambda: F.layer_norm(
            F.linear(F.gelu(F.linear(x, w1, b116)), w2, b216) + x, (d,),
            g16, be16, 1e-12))
        flops = 4 * m * d * f
        nbytes = 2 * (2 * m * d + 2 * d * f) + 4 * (f + 3 * d)
        bms, by = bound(flops, nbytes)
        rows.append(dict(shape=label, max_abs_err=err,
                         ms=time_ms(lambda: kffn.fused_ffn(*args)),
                         plain_ms=time_ms(lambda: kffn.ffn_plain(*args)),
                         bound_ms=bms, bound_by=by, library_ms=lib,
                         block_rows=kffn.block_rows(m, d)))
        log(f"[phase 2] fused_ffn {label}: " + json.dumps(rows[-1]))
    entries.append(("fused_ffn", "gstx/kernels/ffn.py:198", rows))
    entries += attention_rows(torch, F, kattn, randn, held)
    entries.append(decode_rows(torch, F, kdecode, gen, held))
    return entries, grad_rows(torch, kffn, held)


# (kernel, label, dims): the training step's shapes at batch 72 (phases 8
# and 9): 18,432 text rows (72 x 256) and 2,664 visual rows (72 x 37), and
# a rank's half of them (phase 14); the FGSM gradient pass's chunk (phase
# 10): 25,600 and 3,700
GRAD_SHAPES = [("fused_ffn", "train text 18432x768x3072", (18432, 768, 3072)),
               ("fused_ffn", "train visual 2664x1024x1024",
                (2664, 1024, 1024)),
               ("fused_dense_ln", "train text 18432x768->768",
                (18432, 768, 768)),
               ("fused_dense_ln", "train BiOutput-t 18432x1024->768",
                (18432, 1024, 768)),
               ("fused_dense_ln", "train visual 2664x1024->1024",
                (2664, 1024, 1024)),
               # a rank's share of phase 14 (b)'s two-rank step at batch
               # 72: 36 rows of 256 text and 37 visual positions
               ("fused_ffn", "dp2 rank text 9216x768x3072",
                (9216, 768, 3072)),
               ("fused_ffn", "dp2 rank visual 1332x1024x1024",
                (1332, 1024, 1024)),
               ("fused_dense_ln", "dp2 rank text 9216x768->768",
                (9216, 768, 768)),
               ("fused_dense_ln", "dp2 rank BiOutput-t 9216x1024->768",
                (9216, 1024, 768)),
               ("fused_dense_ln", "dp2 rank visual 1332x1024->1024",
                (1332, 1024, 1024)),
               ("fused_ffn", "attack text 25600x768x3072",
                (25600, 768, 3072)),
               ("fused_ffn", "attack visual 3700x1024x1024",
                (3700, 1024, 1024)),
               ("fused_dense_ln", "attack text 25600x768->768",
                (25600, 768, 768)),
               ("fused_dense_ln", "attack BiOutput-t 25600x1024->768",
                (25600, 1024, 768)),
               ("fused_dense_ln", "attack visual 3700x1024->1024",
                (3700, 1024, 1024))]


def grad_rows(torch, kffn, held):
    """Phase 2's gradient rows: at each training shape, the autograd
    Function (kernel forward, f32 recompute backward) against autograd
    through the plain version on the same inputs and cotangent, upcast to
    f32 (the bf16 plain version would round the FFN hidden's gradient to
    bf16 in its graph: at 18,432 rows its weight gradients drift by
    whole bf16 steps where the sum cancels), every gradient within the
    phase's tolerance, and the forward against the bf16 plain version.
    Times: the forward (kernel, plain, the library composite, bound as
    the rows above) and the backward (graph kept; the plain version's
    backward on bf16 inputs beside it), whose bound counts the recompute's
    f32 products, three times the forward's (each product again, then two
    for its gradients), at 67 TFLOP/s, or its bytes (the cotangent and the
    inputs read, their gradients written).  Returns {kernel: [rows]}."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    randn = make_randn(torch, torch.Generator(device=dev).manual_seed(8))
    bf = torch.bfloat16
    out = {"fused_ffn": [], "fused_dense_ln": []}
    for name, label, (m, a, b) in GRAD_SHAPES:
        if name == "fused_ffn":
            args = ffn_inputs(torch, randn, m, a, b)
            fn, plain = kffn.fused_ffn, kffn.ffn_plain
            x, w1, b1, w2, b2, g, be = args
            lib = lambda: F.layer_norm(F.linear(F.gelu(F.linear(
                x, w1, b1.to(bf))), w2, b2.to(bf)) + x, (a,), g.to(bf),
                be.to(bf), 1e-12)
            flops = 4 * m * a * b
            nbytes = 2 * (2 * m * a + 2 * a * b) + 4 * (b + 3 * a)
        else:
            args = dense_ln_inputs(torch, randn, m, a, b)
            fn, plain = kffn.fused_dense_ln, kffn.dense_ln_plain
            x, w, bias, res, g, be = args
            lib = lambda: F.layer_norm(F.linear(x, w, bias.to(bf)) + res,
                                       (b,), g.to(bf), be.to(bf), 1e-12)
            flops = 2 * m * a * b
            nbytes = 2 * (m * a + a * b + 2 * m * b) + 4 * 3 * b
        leaves = [t.detach().requires_grad_(True) for t in args]
        y = fn(*leaves)
        cot = randn(*y.shape)
        got = torch.autograd.grad(y, leaves, cot, retain_graph=True)
        wide = [t.detach().float().requires_grad_(True) for t in args]
        want = torch.autograd.grad(plain(*wide), wide, cot.float())
        del wide
        yp = plain(*leaves)
        errs = [held(name, f"{label} forward", y.detach(), yp.detach())] + [
            held(name, f"{label} grad {i}", gr, w_)
            for i, (gr, w_) in enumerate(zip(got, want))]
        bms, by = bound(flops, nbytes)
        # backward: the cotangent and the inputs read, a gradient of each
        # input written
        bwd_bytes = 2 * y.numel() + 2 * sum(t.numel() * t.element_size()
                                            for t in args)
        bwd_bms, bwd_by = bound(3 * flops, bwd_bytes, PEAK_F32_FLOPS)
        row = dict(shape=label, max_abs_err=max(errs),
                   grad_max_abs_err=errs[1:],
                   ms=time_ms(lambda: fn(*args), iters=5),
                   plain_ms=time_ms(lambda: plain(*args), iters=5),
                   library_ms=time_ms(lib, iters=5),
                   bound_ms=bms, bound_by=by,
                   backward_ms=time_ms(lambda: torch.autograd.grad(
                       y, leaves, cot, retain_graph=True), iters=3,
                       warmup=1, repeats=3),
                   plain_backward_ms=time_ms(lambda: torch.autograd.grad(
                       yp, leaves, cot, retain_graph=True), iters=3,
                       warmup=1, repeats=3),
                   backward_bound_ms=bwd_bms, backward_bound_by=bwd_by)
        out[name].append(row)
        log(f"[phase 2] {name} backward {label}: " + json.dumps(row))
        del y, yp, got, want, leaves
    return out


def padding_mask(torch, gen, b, n, lo):
    """[B, n] additive -10000 past each row's valid length (>= lo), the
    first row full."""
    dev = torch.device("cuda")
    n_valid = torch.randint(lo, n + 1, (b,), generator=gen, device=dev)
    n_valid[0] = n
    valid = torch.arange(n, device=dev)[None, :] < n_valid[:, None]
    return torch.where(valid, 0.0, -10000.0)


# (label, B, H, Lq, Lk, dh): every shape the engine gives the attention
# kernels (the text self-attention at each context bucket, the visual self-
# and co-attentions, the scoring pass's causal self-attention and its
# cross-attention over the 293-slot bf16 memory), a ragged one, and K/V as
# views of buffers whose rows past Lk hold NaN
ATTENTION_SHAPES = [
    ("text self 96x12x256->256x64", 96, 12, 256, 256, 64),
    ("text self 96x12x128->128x64", 96, 12, 128, 128, 64),
    ("text self 96x12x192->192x64", 96, 12, 192, 192, 64),
    ("visual self 96x8x37->37x128", 96, 8, 37, 37, 128),
    ("co t->v 96x8x256->37x128", 96, 8, 256, 37, 128),
    ("co v->t 96x8x37->256x128", 96, 8, 37, 256, 128),
    ("scoring self 96x12x18->18x64 causal", 96, 12, 18, 18, 64),
    ("scoring cross 96x12x18->293x64", 96, 12, 18, 293, 64),
    ("ragged 7x12x100->171x64", 7, 12, 100, 171, 64),
    ("NaN tail 96x12x18->293x64", 96, 12, 18, 293, 64),
    # a rank's heads under -model_parallel 2 (phase 15)
    ("tp rank text self 96x6x256->256x64", 96, 6, 256, 256, 64)]


def attention_inputs(torch, randn, gen, label, b, h, lq, lk, dh):
    """q, k, v for one of ATTENTION_SHAPES, as the heads-split views of the
    [B, L, H*dh] projections the model hands the kernel (K and V views of
    longer buffers whose rows past Lk hold NaN for a "NaN" label), and the
    f32 additive mask: padding [B, 1, 1, Lk], or [B, 1, Lq, Lk] with the
    causal triangle for a "causal" label."""
    def heads(n, nan_tail=False):
        x = randn(b, n + 64 * nan_tail, h * dh)
        if nan_tail:  # rows past n hold NaN; the view stops at n
            x[:, n:] = float("nan")
        return x[:, :n].view(b, n, h, dh).transpose(1, 2)
    tail = "NaN" in label
    q, k, v = heads(lq), heads(lk, tail), heads(lk, tail)
    mask = padding_mask(torch, gen, b, lk, max(1, lk // 4))[:, None, None, :]
    if "causal" in label:
        tri = torch.ones(lq, lk, device="cuda").tril() > 0
        mask = torch.where(tri, mask, -10000.0)
    return q, k, v, mask.contiguous()


def attention_rows(torch, F, kattn, randn, held):
    """fused_attention and fused_attention_batch at the encoder's and the
    scoring pass's shapes (B=96)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"fused_attention": [], "fused_attention_batch": []}
    for label, b, h, lq, lk, dh in ATTENTION_SHAPES:
        q, k, v, mask = attention_inputs(torch, randn, gen, label, b, h, lq,
                                         lk, dh)
        mask16 = mask.to(torch.bfloat16)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask16))
        flops = 4 * b * h * lq * lk * dh
        nbytes = 2 * 2 * b * h * (lq + lk) * dh + 4 * mask.numel()
        bms, by = bound(flops, nbytes)
        for name, fn, plain in (
                ("fused_attention", kattn.fused_attention,
                 kattn.attention_plain),
                ("fused_attention_batch", kattn.fused_attention_batch,
                 kattn.attention_batch_plain)):
            err = held(name, label, fn(q, k, v, mask), plain(q, k, v, mask))
            rows[name].append(dict(
                shape=label, max_abs_err=err,
                ms=time_ms(lambda: fn(q, k, v, mask)),
                plain_ms=time_ms(lambda: plain(q, k, v, mask)),
                bound_ms=bms, bound_by=by, library_ms=lib,
                library="scaled_dot_product_attention, bf16"))
            log(f"[phase 2] {name} {label}: " + json.dumps(rows[name][-1]))
    return [("fused_attention", "gstx/kernels/attention.py:64",
             rows["fused_attention"]),
            ("fused_attention_batch", "gstx/kernels/attention.py:143",
             rows["fused_attention_batch"])]


def decode_rows(torch, F, kdecode, gen, held):
    """quant_decode_attention at the decode steps' shapes: B=96, 12 heads
    of 64, memory M = 37 regions + the context bucket, padded slots
    masked and zero in K/V; a ragged B; phase 11's beam rows (32 x K 4);
    and a rank's 6 heads under -model_parallel 2 (phase 15), at B=96 and
    at the beam's 128 rows."""
    name = "quant_decode_attention"
    dev = torch.device("cuda")
    rows = []
    for b, h, m in ((96, 12, 293), (96, 12, 229), (96, 12, 165),
                    (7, 12, 229), (128, 12, 293), (96, 6, 293),
                    (128, 6, 293)):
        label = f"B={b} H={h} M={m} dh=64"
        dh = 64
        # q with the K scale and 1/sqrt(dh) folded in, as the decoder makes
        # it: scores of order 1
        q = (torch.randn(b, h, 1, dh, generator=gen, device=dev) * 0.05
             ).to(torch.bfloat16)
        add = padding_mask(torch, gen, b, m, 38)
        valid = (add == 0)[:, None, :, None]
        k, v = (torch.randint(-127, 128, (b, h, m, dh), generator=gen,
                              device=dev, dtype=torch.int8) * valid
                for _ in range(2))
        mask = add[:, None, None, :].to(torch.bfloat16)  # as the engine's
        err = held(name, label, kdecode.quant_decode_attention(q, k, v, mask),
                   kdecode.quant_decode_attention_plain(q, k, v, mask),
                   DECODE_ABS_TOL, DECODE_REL_TOL)
        k16, v16 = k.to(torch.bfloat16), v.to(torch.bfloat16)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k16, v16, attn_mask=mask, scale=1.0))
        flops = 4 * b * h * m * dh
        nbytes = 2 * b * h * m * dh + 2 * b * h * dh + 2 * b * m \
            + 4 * b * h * dh
        bms, by = bound(flops, nbytes)
        rows.append(dict(
            shape=label, max_abs_err=err,
            ms=time_ms(lambda: kdecode.quant_decode_attention(q, k, v, mask)),
            plain_ms=time_ms(lambda: kdecode.quant_decode_attention_plain(
                q, k, v, mask)),
            bound_ms=bms, bound_by=by, library_ms=lib,
            library="scaled_dot_product_attention over bf16 K/V "
                    "(conversion not timed)"))
        log(f"[phase 2] {name} {label}: " + json.dumps(rows[-1]))
    return (name, "gstx/kernels/decode_attn.py:60", rows)


def make_batch(np, enc_cfg, b, s, r, cap_len=20):
    """bench.py's caption-only contexts (CLS caption SEP, segment 1)."""
    rng = np.random.RandomState(0)
    ids = np.zeros((b, s), np.int64)
    segs = np.zeros((b, s), np.int64)
    ids[:, 0] = 101
    ids[:, 1:cap_len - 1] = rng.randint(1000, 20000, size=(b, cap_len - 2))
    ids[:, cap_len - 1] = 102
    segs[:, :cap_len] = 1
    return {"enc_input_ids": ids, "enc_segments": segs,
            "enc_image_feat": rng.rand(b, r, enc_cfg.v_feature_size
                                       ).astype(np.float32),
            "enc_image_loc": rng.rand(b, r, 5).astype(np.float32),
            "enc_image_mask": np.ones((b, r), np.float32)}


def rel_err(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


class Counters:
    """Every kernel wrapper's launch counter, read and reset together."""

    def __init__(self, *modules):
        self.modules = modules

    def reset(self):
        for m in self.modules:
            m.reset_launches()

    def read(self):
        return {k: n for m in self.modules for k, n in m.launches.items()}


def small_inputs(torch, np, enc_cfg):
    """B=4, S=128 encoder inputs and 12 decoder tokens for the checks
    against the f32 unfused model."""
    small = make_batch(np, enc_cfg, 4, 128, 37)
    args = [torch.from_numpy(small[k]).cuda() for k in
            ("enc_input_ids", "enc_image_feat", "enc_image_loc",
             "enc_segments")]
    args += [(args[0] != 0).long(), torch.from_numpy(
        small["enc_image_mask"]).cuda()]
    return args, torch.from_numpy(small["enc_input_ids"][:, :12]).cuda()


def run_engine(torch, engine, model, batch, gen, counters, batches, tag):
    """One warm-up batch, then ``batches`` timed ones with every launch
    counter set to 0 just before and read just after."""
    t0 = time.perf_counter()
    engine(model, model, batch, gen)
    torch.cuda.synchronize()
    log(f"[{tag}] warm-up batch {time.perf_counter() - t0:.2f} s")
    counters.reset()
    outs, walls = [], []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(engine(model, model, batch, gen))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"[{tag}] timed batches: " + ", ".join(f"{w:.3f} s" for w in walls))
    return outs, sum(walls) / batches, counters.read()


def check_outputs(torch, outs, rounds, b, t, vocab):
    for out in outs:
        for x in (out.questions, out.answers):
            if tuple(x.shape) != (rounds, b, t):
                raise AssertionError(f"output shape {tuple(x.shape)}")
            if int(x.min()) < 0 or int(x.max()) >= vocab:
                raise AssertionError("token id out of range")
        ppl = out.answer_ppl
        if tuple(ppl.shape) != (rounds, b) or \
                not bool(torch.isfinite(ppl).all()) or \
                not bool((ppl > 0).all()):
            raise AssertionError("answer_ppl not finite and positive")


def check_launches(tag, counts, want):
    log(f"[{tag}] launches: {counts} (expected {want})")
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name}: {n} launches expected, "
                                 f"{counts[name]} counted")


def report_rate(tag, outs, wall, rounds, b, t, card):
    tokens = b * rounds * 2 * t  # bench.py's fixed accounting
    emitted = sum(int((o.questions != 0).sum() + (o.answers != 0).sum())
                  for o in outs) / len(outs)
    log(f"[{tag}] engine: {tokens / wall:.2f} generated tok/s "
        f"({rounds} rounds, batch {b}, {wall:.3f} s/batch, {tokens} tokens "
        f"by fixed accounting, {emitted:.0f} emitted) on {card}")


def engine_phases(torch, np, counters, rounds, batches, card):
    """Phases 3-5 on one full-width model: returns the launch counts of the
    default path (phase 3) and of the all-kernels path (phase 5), and a
    function that runs the two profiled rounds, which come last."""
    from gstx_torch.core.config import DecoderConfig, EncoderConfig
    from gstx_torch.decode.dialog_engine import make_dialog_engine
    from gstx_torch.decode.sampler import DecodeSettings
    from gstx_torch.models.encdec import GSTVisualDialog, precast_

    enc_cfg, dec_cfg = EncoderConfig(), DecoderConfig()
    t0 = time.perf_counter()
    model = GSTVisualDialog(enc_cfg, dec_cfg, device="cuda", seed=0)
    ref = copy.deepcopy(model)  # f32: the unfused reference
    precast_(model, torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[phase 3] full-width model built in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in ref.parameters()) / 1e6:.1f} M params)")

    # the bf16 kernel path against the f32 unfused model on a small input
    args, dec_ids = small_inputs(torch, np, enc_cfg)
    with torch.no_grad():
        kv16, m16 = model.decode_prepare(*args)
        kv32, m32 = ref.decode_prepare(*args)
        lg16 = model.decode_logits_cached(dec_ids, torch.ones_like(dec_ids),
                                          kv16, m16)
        lg32 = ref.decode_logits_cached(dec_ids, torch.ones_like(dec_ids),
                                        kv32, m32)
    kv_err = max(rel_err(a, b) for pair16, pair32 in zip(kv16, kv32)
                 for a, b in zip(pair16, pair32))
    lg_err = rel_err(lg16, lg32)
    log(f"[phase 3] bf16 kernel path vs f32 unfused (B=4, S=128): memory "
        f"K/V rel err {kv_err:.4g}, logits rel err {lg_err:.4g} "
        f"(limit {MODEL_REL_TOL})")
    if not kv_err <= MODEL_REL_TOL or not lg_err <= MODEL_REL_TOL:
        raise AssertionError("bf16 kernel path disagrees with f32 model")
    del kv16, lg16, lg32

    B, S, R, T = 96, 256, 37, 18
    batch = make_batch(np, enc_cfg, B, S, R)
    settings = dict(max_steps=T, temperature=0.7, top_k=7, top_p=0.0,
                    fused_sampler=True)

    def engine(n_rounds, **kw):
        return make_dialog_engine(
            num_rounds=n_rounds,
            q_settings=DecodeSettings(ngram_blocking_size=4, **settings),
            a_settings=DecodeSettings(ngram_blocking_size=0, **settings),
            dtype=torch.bfloat16, context_buckets=(128, 192), device="cuda",
            **kw)
    gen = torch.Generator(device="cuda").manual_seed(1)
    each_pass = per_forward()
    ffn_each = each_pass * 2 * rounds * batches  # 2 encoder passes a round

    outs, wall, default_counts = run_engine(
        torch, engine(rounds), model, batch, gen, counters, batches,
        "phase 3")
    check_launches("phase 3", default_counts, {
        "fused_dense_ln": ffn_each, "fused_ffn": ffn_each,
        "fused_attention": 0, "fused_attention_batch": 0,
        "quant_decode_attention": 0})
    check_outputs(torch, outs, rounds, B, T, dec_cfg.vocab_size)
    report_rate("phase 3", outs, wall, rounds, B, T, card)
    breakdown(torch, model, batch, settings, card, "phase 4", False)

    counts = int8_phase(torch, model, ref, (kv32, m32), args, batch,
                        settings, engine, gen, counters, each_pass,
                        dec_cfg, batches, card)
    from gstx_torch.kernels import attention as kattn
    from gstx_torch.kernels import decode_attn as kdecode

    def profile_last():
        """The profiled rounds, run after every timed phase: see
        profile_round."""
        profile_round(torch, model, batch, settings, card, "phase 4", False)
        kattn.enable()
        kdecode.enable_kernel()
        profile_round(torch, model, batch, settings, card, "phase 5", True)
        kattn.enable(False)
        kdecode.enable_kernel(False)
    return default_counts, counts, profile_last


def int8_phase(torch, model, ref, ref_memory, args, batch, settings, engine,
               gen, counters, each_pass, dec_cfg, batches, card):
    """Phase 5: int8 decode memory with quant_decode_attention and
    fused_attention on, at ROUNDS rounds whatever phase 3 ran."""
    from gstx_torch.decode.sampler import init_cache
    from gstx_torch.kernels import attention as kattn
    from gstx_torch.kernels import decode_attn as kdecode
    from gstx_torch.models.decoder import dequantize_kv, quantize_memory_kv

    kv32, m32 = ref_memory
    tok = torch.full((4, 1), 101, dtype=torch.long, device="cuda")  # CLS
    with torch.no_grad():
        lg32 = ref.decode_step(tok, 0, init_cache(
            dec_cfg, 4, 2, torch.float32, "cuda"), kv32, m32)
        kattn.enable()
        kdecode.enable_kernel()
        before = counters.read()
        kv16, m16 = model.decode_prepare(*args)
        mem8 = quantize_memory_kv(kv16, m16, torch.bfloat16)
        lg8 = model.decode_step(tok, 0, init_cache(
            dec_cfg, 4, 2, torch.bfloat16, "cuda"), mem8, m16)
        after = counters.read()
    if not (after["fused_attention"] > before["fused_attention"] and
            after["quant_decode_attention"] > before[
                "quant_decode_attention"]):
        raise AssertionError("the small check did not reach kernels 3 and 5")
    # over the valid slots: quantization zeroes the padding, whose values
    # the -10000 mask makes free
    valid = (m32[:, 0, 0, :] > -5000.0)[:, None, :, None]
    kv_err = max(rel_err(a * valid, b * valid)
                 for layer8, pair32 in zip(mem8, kv32)
                 for a, b in zip(dequantize_kv(layer8), pair32))
    lg_err = float((lg8 - lg32).abs().max() / lg32.abs().max())
    log(f"[phase 5] int8 memory + kernels vs f32 unfused (B=4, S=128): "
        f"dequantized memory K/V rel err over the valid slots "
        f"{kv_err:.4g} (limit "
        f"{MODEL_REL_TOL}), decode-step max|dlogit|/max|logit| "
        f"{lg_err:.4g} (limit {INT8_LOGIT_TOL})")
    if not kv_err <= MODEL_REL_TOL or not lg_err < INT8_LOGIT_TOL:
        raise AssertionError("int8 kernel path disagrees with f32 model")
    B, T = batch["enc_input_ids"].shape[0], settings["max_steps"]
    rounds = ROUNDS
    outs, wall, counts = run_engine(
        torch, engine(rounds, quantize_memory=True), model, batch, gen,
        counters, batches, "phase 5")
    encoder_each = each_pass * 2 * rounds * batches
    check_launches("phase 5", counts, {
        "fused_dense_ln": encoder_each, "fused_ffn": encoder_each,
        # every encoder attention (one per text or visual layer, two per
        # co-attention layer: each_pass again) in both passes, and the
        # scoring pass's self-attentions (its cross-attention takes the
        # unfused int8 branch)
        "fused_attention":
            (2 * each_pass + dec_cfg.num_hidden_layers) * rounds * batches,
        "fused_attention_batch": 0,
        # every layer of every decode step (no decode ends early)
        "quant_decode_attention":
            dec_cfg.num_hidden_layers * T * 2 * rounds * batches})
    check_outputs(torch, outs, rounds, B, T, dec_cfg.vocab_size)
    report_rate("phase 5", outs, wall, rounds, B, T, card)
    breakdown(torch, model, batch, settings, card, "phase 5", True)

    # the two configurations in turns, one batch each: the host's speed
    # drifts within a run, and decode is host-bound
    engines = {"default": engine(rounds),
               "int8+kernels": engine(rounds, quantize_memory=True)}
    walls = {name: [] for name in engines}
    for name in ("default", "int8+kernels", "int8+kernels", "default"):
        kattn.enable(name != "default")
        kdecode.enable_kernel(name != "default")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engines[name](model, model, batch, gen)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    log("[phase 5] in turns (default, int8+kernels, int8+kernels, "
        "default): " + "; ".join(
            f"{name} {', '.join(f'{w:.3f}' for w in ws)} s/batch = "
            f"{B * rounds * 2 * T * len(ws) / sum(ws):.2f} tok/s"
            for name, ws in walls.items()) + f" on {card}")
    kattn.enable(False)
    kdecode.enable_kernel(False)
    return counts


def synced(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def breakdown(torch, model, batch, settings, card, tag, quantize):
    """Where the time goes: one round's pieces at the full context width
    (host clock around synchronised calls).  ``quantize``: the memory goes
    to int8 after the encoder (timed with it), as the engine's
    ``quantize_memory``."""
    from gstx_torch.decode.sampler import (DecodeSettings, init_cache,
                                           sample_sequence)
    from gstx_torch.models.decoder import quantize_memory_kv

    def prepare():
        kv, mask = model.decode_prepare(*args)
        if quantize:
            kv = quantize_memory_kv(kv, mask, torch.bfloat16)
        return kv, mask

    dev = torch.device("cuda")
    ids = torch.from_numpy(batch["enc_input_ids"]).to(dev)
    args = (ids, torch.from_numpy(batch["enc_image_feat"]).to(dev),
            torch.from_numpy(batch["enc_image_loc"]).to(dev),
            torch.from_numpy(batch["enc_segments"]).to(dev),
            (ids != 0).long(), torch.from_numpy(batch["enc_image_mask"]).to(dev))
    gen = torch.Generator(device=dev).manual_seed(2)
    q_set = DecodeSettings(ngram_blocking_size=4, **settings)
    with torch.no_grad():
        prepare()  # warm
        (kv, mask), enc_ms = synced(torch, prepare)

        def decode():
            caches = init_cache(model.dec_config, ids.shape[0],
                                q_set.max_steps + 1, model.dtype, dev)
            return sample_sequence(
                lambda tok, pos, c: model.decode_step(tok, pos, c, kv, mask),
                gen, ids.shape[0], caches, q_set, ngram_source=ids,
                device=dev)
        seq, dec_ms = synced(torch, decode)
        _, ppl_ms = synced(torch, lambda: model.decode_logits_cached(
            seq, (seq != 0).long(), kv, mask))
    round_ms = 2 * enc_ms + 2 * dec_ms + ppl_ms
    log(f"[{tag}] one round at context 256, batch {ids.shape[0]}: "
        f"encoder+memory{'+int8' if quantize else ''} {enc_ms:.1f} ms x2, "
        f"18-step decode {dec_ms:.1f} ms x2 "
        f"({dec_ms / q_set.max_steps:.2f} ms/step), answer scoring "
        f"{ppl_ms:.1f} ms; sum {round_ms:.1f} ms "
        f"(decode {200 * dec_ms / round_ms:.0f}%) on {card}")


def profile_round(torch, model, batch, settings, card, tag, quantize):
    """One round under torch.profiler: the device's busy share and its top
    kernels.  Run after every timed measurement: on an H100 machine the
    engine's timings taken after a profiled round ran 26-50% slower for the
    rest of the run."""
    from gstx_torch.decode.dialog_engine import make_dialog_engine
    from gstx_torch.decode.sampler import DecodeSettings

    gen = torch.Generator(device="cuda").manual_seed(2)
    q_set = DecodeSettings(ngram_blocking_size=4, **settings)
    one = make_dialog_engine(
        num_rounds=1, q_settings=q_set,
        a_settings=DecodeSettings(ngram_blocking_size=0, **settings),
        dtype=torch.bfloat16, quantize_memory=quantize, device="cuda")
    profiled(torch, lambda: one(model, model, batch, gen),
             "round at context 256", card, tag)


def profiled(torch, fn, what, card, tag):
    """``fn`` under torch.profiler: the device's busy share and its top
    kernels, with the shares of the port's own kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_ms = synced(torch, fn)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log(f"[{tag}] profiler: no device time recorded; busy share not "
            "measured")
        return
    log(f"[{tag}] profiled {what}: wall {wall_ms:.1f} ms "
        f"(profiler on), device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}, {sum(e.count for e in kernels)} "
        f"kernel launches, on {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:7d}x  {e.key[:90]}")
    for what, key in (("attention kernels (csrc/attention.cu)",
                       "attention_kernel"),
                      ("dense_ln kernel (csrc/ffn.cu)", "dense_ln_kernel"),
                      ("FFN kernel (csrc/ffn.cu)", "ffn_kernel")):
        mine = [e for e in kernels if key in e.key]
        if mine:
            ms = sum(e.self_device_time_total for e in mine) / 1e3
            log(f"[{tag}] {what}: {ms:.2f} ms over "
                f"{sum(e.count for e in mine)} launches, "
                f"{ms / busy_ms:.3f} of device busy")


CLI_IMAGES = 200   # two full batches of 96 and a partial one of 8
CLI_BATCH = 96
EOS_BIAS = 3.0     # bench.py -short_answers 1 -eos_bias 3.0


def make_vocab():
    """A 30,522-entry WordPiece vocab in bert-base-uncased's layout:
    specials at 0 and 100-103, [unused*] between, then synthetic words and
    ## pieces."""
    def word(i):
        s = ""
        while i:
            s, i = chr(97 + i % 26) + s, i // 26
        return s
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + \
        ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    return vocab + [("##" if i % 5 == 0 else "") + word(i)
                    for i in range(len(vocab), 30522)]


def cli_inputs(torch, np, tmp):
    """Phase 6's inputs in ``tmp``: :func:`make_vocab`'s vocab, a
    synthetic store of
    CLI_IMAGES images x 36 boxes x 2,048 features, captions of 8-16 vocab
    words with their url maps, and a full-width model from a seed saved as
    a reference .ckpt ({"model_state_dict": ...}, f32), and its encoder as
    an encoder-only one in the reference's discriminative layout
    (``bert_pretrained.*``) for phase 7.  Returns the parameter count, the
    CLI's data flags and the vocab."""
    from gstx_torch.core.config import (SEP_ID, DecoderConfig,
                                        EncoderConfig)
    from gstx_torch.data.feature_store import make_synthetic_store
    from gstx_torch.models.encdec import GSTVisualDialog

    vocab = make_vocab()
    paths = {k: os.path.join(tmp, k) for k in
             ("vocab.txt", "feats.store", "caps.json", "urls.json",
              "url_caps.json", "model.ckpt")}
    with open(paths["vocab.txt"], "w") as f:
        f.write("\n".join(vocab) + "\n")
    ids = list(range(1000, 1000 + CLI_IMAGES))
    make_synthetic_store(paths["feats.store"], ids, num_boxes=36,
                         feat_dim=2048, num_classes=1601, seed=0)
    rng = np.random.RandomState(0)
    words = [w for w in vocab[104:] if not w.startswith("##")]
    caps = [{"image_id": i, "caption": " ".join(
        words[j] for j in rng.randint(0, len(words), rng.randint(8, 17)))}
        for i in ids]
    urls = {str(c["image_id"]): f"http://example.invalid/{c['image_id']}.jpg"
            for c in caps}
    json.dump(caps, open(paths["caps.json"], "w"))
    json.dump(urls, open(paths["urls.json"], "w"))
    json.dump({urls[str(c["image_id"])]: c["caption"] for c in caps},
              open(paths["url_caps.json"], "w"))
    model = GSTVisualDialog(EncoderConfig(), DecoderConfig(), device="cuda",
                            seed=0)
    with torch.no_grad():
        # random weights never sample EOS; bench.py's short-answer bias
        model.dec.lm_head.bias[SEP_ID] += EOS_BIAS
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    torch.save({"model_state_dict": state}, paths["model.ckpt"])
    pre = "encoder.bert_pretrained."
    torch.save({"model_state_dict": {
        "bert_pretrained." + k[len(pre):]: v for k, v in state.items()
        if k.startswith(pre)}}, os.path.join(tmp, "encoder.ckpt"))
    n_params = sum(p.numel() for p in model.parameters())
    del model, state
    torch.cuda.empty_cache()
    return n_params, vocab, [
        "-vocab_path", paths["vocab.txt"],
        "-cc12m_image_feats", paths["feats.store"],
        "-cc12m_caption", paths["caps.json"],
        "-image_id_to_url", paths["urls.json"],
        "-url_to_cap", paths["url_caps.json"],
        "-start_path_q", paths["model.ckpt"],
        "-start_path_a", paths["model.ckpt"]]


def per_forward():
    """Every fused site of one full-width encoder forward: one fused_ffn and
    one fused_dense_ln a text or visual layer, two of each a co-attention
    layer (30)."""
    from gstx_torch.core.config import EncoderConfig

    enc = EncoderConfig()
    return (enc.num_hidden_layers + enc.v_num_hidden_layers
            + 2 * len(enc.v_biattention_id))


def cli_phase(torch, np, counters, card, tmp):
    """Phase 6: the port's generation CLI, gstx_torch.cli.generate.main,
    in-process at full width on CLI_IMAGES images: bf16, batch 96, context
    256, 37 regions, buckets 128/192, 10 rounds of 18 steps, the default
    sampling (T 0.7, top-k 7, n-gram 4 for questions, fused sampler),
    -use_pallas, -host_prefetch and -pipeline 2; inputs in ``tmp``.
    Returns its launch counts (fused_ffn and fused_dense_ln 600 a batch,
    the rest 0), the vocab, the checkpoints' paths, its flags less
    -save_path and its records."""
    import math

    from gstx_torch import native
    from gstx_torch.cli import generate

    t0 = time.perf_counter()
    n_params, vocab, data = cli_inputs(torch, np, tmp)
    log(f"[phase 6] inputs written in {time.perf_counter() - t0:.2f} s "
        f"({n_params / 1e6:.1f} M params, {CLI_IMAGES} images)")
    out_dir = os.path.join(tmp, "out")
    argv = data + [
        "-mode", "cc12m_gen", "-dtype", "bfloat16",
        "-batch_size", str(CLI_BATCH), "-max_seq_len", "256",
        "-max_regions", "37", "-context_buckets", "128,192",
        "-num_dialog_rounds", str(ROUNDS), "-max_dec_len", "18",
        "-use_pallas", "-host_prefetch", "-pipeline", "2",
        "-num_workers", "4", "-save_path", out_dir,
        "-save_name", "dialogs.json"]
    stats = {}
    native.reset_served()
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records = generate.main(argv, stats_out=stats, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters.read()
    out_path = os.path.join(out_dir, "dialogs.json")
    with open(out_path) as f:
        written = json.load(f)
    sidecar_left = os.path.exists(out_path + ".partial.jsonl")

    batches = -(-CLI_IMAGES // CLI_BATCH)
    # two encoder forwards a round
    per_batch = per_forward() * 2 * ROUNDS
    check_launches("phase 6", counts, {
        "fused_dense_ln": per_batch * batches,
        "fused_ffn": per_batch * batches,
        "fused_attention": 0, "fused_attention_batch": 0,
        "quant_decode_attention": 0})
    if written != records:
        raise AssertionError("the output JSON differs from main's return")
    if stats["images"] != CLI_IMAGES or \
            len(records) != CLI_IMAGES - stats["abnormal"] or not records:
        raise AssertionError(
            f"{len(records)} records from {stats['images']} images with "
            f"{stats['abnormal']} abnormal")
    for rec in records:
        if len(rec["dialog"]) != ROUNDS or not all(
                math.isfinite(r["answer_ppl"]) for r in rec["dialog"]):
            raise AssertionError(f"bad record {rec['image_id']}")
    if sidecar_left:
        raise AssertionError("the sidecar outlived the run")
    loop = stats["loop_seconds"]
    log(f"[phase 6] CLI cc12m_gen, {CLI_IMAGES} images in {batches} batches: "
        f"{len(records)} records ({stats['abnormal']} abnormal dropped), "
        f"main() {wall:.2f} s wall with loading, batch loop {loop:.2f} s: "
        f"{stats['images'] / loop:.2f} img/s, "
        f"{stats['tokens'] / loop:.2f} generated non-PAD tok/s "
        f"({stats['tokens']} tokens) on {card}")
    log(f"[phase 6] native host paths served: feature store "
        f"{native.served['feature_store']}, tokenizer "
        f"{native.served['wordpiece']}")
    q = records[0]["dialog"][0]
    log(f"[phase 6] first record: image {records[0]['image_id']}, "
        f"q {q['question']!r}, a {q['answer']!r}, ppl {q['answer_ppl']:.2f}")
    ckpts = {"full": os.path.join(tmp, "model.ckpt"),
             "encoder": os.path.join(tmp, "encoder.ckpt")}
    at = argv.index("-save_path")
    return counts, vocab, ckpts, argv[:at] + argv[at + 2:], records


EVAL_IMAGES = 20      # one VisDial v1.0 eval batch (evaluate_gen.py:151)
EVAL_TEST_IMAGES = 4
EVAL_OPTIONS = 100
GEN_CHUNK, DISC_CHUNK = 500, 200  # the reference evaluators' chunks


def eval_inputs(np, tmp, vocab):
    """Phase 7's data in ``tmp``, in the VisDial v1.0 layouts: a val JSON of
    EVAL_IMAGES dialogs (a caption of 8-14 words, 10 rounds of a 4-8-word
    question and 100 answer options of 1-5 words, one of them the answer),
    its dense annotations (one round each, relevance in quarters), a test
    JSON of EVAL_TEST_IMAGES dialogs of 1-10 rounds with ``round_id``, and
    a synthetic store of those images x 36 boxes x 2,048 features.  Words
    come from phase 6's vocab.  Returns the evaluators' data flags."""
    from gstx_torch.data.feature_store import make_synthetic_store

    rng = np.random.RandomState(1)
    words = [w for w in vocab[104:] if not w.startswith("##")]

    def sample(lo, hi):
        return " ".join(words[j] for j in
                        rng.randint(0, len(words), rng.randint(lo, hi + 1)))
    questions = [sample(4, 8) for _ in range(2000)]
    answers = [sample(1, 5) for _ in range(2000)]

    def dialogs(ids, test):
        out = []
        for i in ids:
            rounds = []
            for _ in range(rng.randint(1, 11) if test else 10):
                opts = rng.choice(len(answers), EVAL_OPTIONS, replace=False)
                gt = int(rng.randint(EVAL_OPTIONS))
                rounds.append({"question": int(rng.randint(len(questions))),
                               "answer": int(opts[gt]), "gt_index": gt,
                               "answer_options": [int(o) for o in opts]})
            d = {"image_id": i, "caption": sample(8, 14), "dialog": rounds}
            if test:
                d["round_id"] = len(rounds)
            out.append(d)
        return {"data": {"dialogs": out, "questions": questions,
                         "answers": answers}}
    val_ids = list(range(5000, 5000 + EVAL_IMAGES))
    test_ids = list(range(6000, 6000 + EVAL_TEST_IMAGES))
    paths = {k: os.path.join(tmp, k) for k in
             ("val.json", "test.json", "dense.json", "eval.store")}
    json.dump(dialogs(val_ids, False), open(paths["val.json"], "w"))
    json.dump(dialogs(test_ids, True), open(paths["test.json"], "w"))
    json.dump([{"image_id": i, "round_id": int(rng.randint(1, 11)),
                "gt_relevance": [float(x) for x in
                                 rng.randint(0, 5, EVAL_OPTIONS) / 4.0
                                 * (rng.rand(EVAL_OPTIONS) < 0.3)]}
               for i in val_ids], open(paths["dense.json"], "w"))
    make_synthetic_store(paths["eval.store"], val_ids + test_ids,
                         num_boxes=36, feat_dim=2048, num_classes=1601,
                         seed=1)
    return eval_flags(tmp)


def eval_flags(tmp):
    """The evaluators' data flags of :func:`eval_inputs`' files."""
    return ["-visdial_processed_train", os.path.join(tmp, "val.json"),
            "-visdial_processed_val", os.path.join(tmp, "val.json"),
            "-visdial_processed_test", os.path.join(tmp, "test.json"),
            "-visdial_processed_val_dense_annotations",
            os.path.join(tmp, "dense.json"),
            "-visdial_image_feats", os.path.join(tmp, "eval.store"),
            "-vd_version", "1.0", "-num_options", str(EVAL_OPTIONS),
            "-max_seq_len", "256", "-max_utt_len", "25",
            "-max_regions", "37", "-dtype", "bfloat16", "-num_workers", "4"]


def eval_run(torch, counters, card, tag, cli, argv, chunk, images,
             sequences, want_counts):
    """One in-process evaluator CLI run with every launch counter set to 0
    just before and read just after; checks the counts and the images and
    sequences scored, and prints main()'s wall time, the batch loop's rates
    and the peak device memory.  Returns (result, counts)."""
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    result = cli.main(argv, chunk_size=chunk, device="cuda",
                      stats_out=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters.read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_launches(tag, counts, want_counts)
    if stats["images"] != images or stats["sequences"] != sequences:
        raise AssertionError(f"{tag}: {stats}")
    loop = stats["loop_seconds"]
    log(f"[{tag}] {stats['images']} images, {stats['sequences']} sequences "
        f"in {stats['chunks']} chunks of {chunk}: main() {wall:.2f} s wall "
        f"with loading, batch loop {loop:.2f} s (waiting for the loader "
        f"{stats['wait_seconds']:.2f} s) = "
        f"{stats['sequences'] / loop:.1f} scored sequences/s, "
        f"{stats['images'] / loop:.3f} images/s; peak device memory "
        f"{peak:.2f} GiB; on {card}")
    return result, counts


def check_metrics(tag, metrics, options):
    want = {"r@1", "r@5", "r@10", "mean", "mrr", "ndcg"}
    if set(metrics) != want:
        raise AssertionError(f"{tag}: metrics {sorted(metrics)}")
    for k, v in metrics.items():
        hi = options if k == "mean" else 1.0
        lo = 1.0 if k == "mean" else 0.0
        if not (lo <= v <= hi):  # also false for NaN
            raise AssertionError(f"{tag}: {k} = {v}")
    log(f"[{tag}] metrics: {json.dumps(metrics)}")


def centred_err(torch, got, want):
    """Relative error of one round's scores centred over its options: the
    round's common offset (the same context for every option) drops out,
    as it does from the options' order."""
    return rel_err(got - got.mean(), want - want.mean())


def eval_accuracy(torch, counters, card, tag, config, use_decoder, ckpt,
                  dataset, flatten, make_scorer, feat_keys, chunk, limit):
    """The bf16 kernel path against the f32 unfused model on the first
    image's first round (EVAL_OPTIONS sequences): relative error of the
    scores centred over the options, within ``limit``.  Beside it the
    bf16 unfused model (bf16 rounding alone) and two controls that must
    fail that limit: the kernel path with every fused_ffn's FFN branch
    zeroed (W2, b2 = 0) and with every fused_dense_ln's projection zeroed
    (W, b = 0).  Then one profiled chunk of the bf16 model, the last
    timing of the phase (timings after a profiled run are slow)."""
    from gstx_torch.cli.common import build_model, load_params
    from gstx_torch.data.loader import collate
    from gstx_torch.eval.rank_gen import batch_to_device, chunk_inputs
    from gstx_torch.kernels import ffn as kffn
    from gstx_torch.models.encdec import precast_

    ref = load_params(build_model(config, device="cuda",
                                  use_decoder=use_decoder), ckpt)
    model = precast_(copy.deepcopy(ref), torch.bfloat16)
    text, images, (_, rounds, options) = flatten(
        collate([dataset.__getitem__(0, seed=0)]))
    inputs = {m.dtype: batch_to_device(text, images, "cuda", m.dtype,
                                       feat_keys) for m in (ref, model)}

    def score(m, stop=options):
        with torch.inference_mode():
            return make_scorer(m)(chunk_inputs(
                *inputs[m.dtype], 0, stop, rounds * options)).float()
    want = score(ref)
    before = counters.read()
    got = score(model)
    after = counters.read()
    if not (after["fused_ffn"] > before["fused_ffn"] and
            after["fused_dense_ln"] > before["fused_dense_ln"]):
        raise AssertionError(f"{tag}: the bf16 check reached no kernel")
    sound = centred_err(torch, got, want)
    kffn.enable(False)
    try:
        unfused = centred_err(torch, score(model), want)
    finally:
        kffn.enable(True)
    real_ffn, real_ln = kffn.fused_ffn, kffn.fused_dense_ln

    def ffn_lost(x, w1, b1, w2, b2, *ln, **eps):
        return real_ffn(x, w1, b1, torch.zeros_like(w2),
                        torch.zeros_like(b2), *ln, **eps)

    def projection_lost(x, w, b, *rest, **eps):
        return real_ln(x, torch.zeros_like(w), torch.zeros_like(b), *rest,
                       **eps)
    controls = {}
    for name, attr, fn in (("FFN branch zeroed", "fused_ffn", ffn_lost),
                           ("projection zeroed", "fused_dense_ln",
                            projection_lost)):
        setattr(kffn, attr, fn)
        try:
            controls[name] = centred_err(torch, score(model), want)
        finally:
            kffn.fused_ffn, kffn.fused_dense_ln = real_ffn, real_ln
    log(f"[{tag}] first image's first round ({options} options), scores "
        f"centred over the options, relative error to the f32 unfused "
        f"model: bf16 kernel path {sound:.4g} (limit {limit}; "
        f"uncentred {rel_err(got, want):.4g}), bf16 unfused {unfused:.4g}; "
        "controls on the kernel path: " + ", ".join(
            f"{k} {v:.4g}" for k, v in controls.items())
        + f"; f32 scores {want[:3].tolist()}, spread (std) "
        f"{float(want.std()):.4g}")
    if not sound <= limit:
        raise AssertionError(f"{tag}: bf16 kernel scores disagree with f32")
    if not min(controls.values()) > limit:
        raise AssertionError(f"{tag}: a control passes the limit: the "
                             "check cannot see a wrong kernel")
    # where a full chunk's device time goes (the image's first `chunk` rows)
    del ref
    with torch.inference_mode():
        profiled(torch, lambda: score(model, chunk),
                 f"chunk of {chunk} sequences (bf16, kernels)", card, tag)
    del model


def eval_phase(torch, np, counters, card, tmp, vocab, ckpts):
    """Phase 7: the evaluator CLIs (gstx_torch.cli.evaluate_gen / _disc)
    in-process at full width, bf16, -use_pallas, on phase 6's vocab and
    checkpoints (the generative one carries phase 6's +3.0 EOS bias).
    Returns the launch counts of the generative and discriminative
    vd_eval_val runs, the data flags, and the generative val run's scores
    a batch."""
    from gstx_torch.cli import common, evaluate_disc, evaluate_gen
    from gstx_torch.data.tokenizer import BertTokenizer
    from gstx_torch.data.visdial import VisdialDiscDataset, VisdialGenDataset
    from gstx_torch.eval import rank_disc, rank_gen
    from gstx_torch.kernels import ffn as kffn

    t0 = time.perf_counter()
    vocab_path = os.path.join(tmp, "vocab.txt")
    data = eval_inputs(np, tmp, vocab) + ["-vocab_path", vocab_path]
    log(f"[phase 7] inputs written in {time.perf_counter() - t0:.2f} s")
    each = per_forward()

    def want(n_chunks):
        return {"fused_dense_ln": each * n_chunks,
                "fused_ffn": each * n_chunks, "fused_attention": 0,
                "fused_attention_batch": 0, "quant_decode_attention": 0}

    def out(name):
        return ["-save_path", os.path.join(tmp, name)]
    gen = data + ["-start_path", ckpts["full"], "-use_pallas"]
    n_val = EVAL_IMAGES * ROUNDS * EVAL_OPTIONS
    scores = []
    with recording_scores(rank_gen, scores):
        metrics, gen_counts = eval_run(
            torch, counters, card, "phase 7 gen val", evaluate_gen,
            gen + ["-mode", "vd_eval_val"] + out("gen_val"), GEN_CHUNK,
            EVAL_IMAGES, n_val, want(n_val // GEN_CHUNK))
    check_metrics("phase 7 gen val", metrics, EVAL_OPTIONS)
    if not os.path.exists(os.path.join(tmp, "gen_val",
                                       "performance_log.txt")):
        raise AssertionError("performance_log.txt not written")

    n_test = EVAL_TEST_IMAGES * EVAL_OPTIONS
    ranks, _ = eval_run(
        torch, counters, card, "phase 7 gen test", evaluate_gen,
        gen + ["-mode", "vd_eval_test"] + out("gen_test"), GEN_CHUNK,
        EVAL_TEST_IMAGES, n_test, want(-(-n_test // GEN_CHUNK)))
    with open(os.path.join(tmp, "gen_test", "predictions.txt")) as f:
        written = json.load(f)
    if written != ranks or len(ranks) != EVAL_TEST_IMAGES or any(
            sorted(r["ranks"]) != list(range(1, EVAL_OPTIONS + 1))
            for r in ranks):
        raise AssertionError("predictions.txt: not 4 permutations of 1..100")
    log(f"[phase 7 gen test] predictions.txt: {len(ranks)} entries, first "
        f"image {ranks[0]['image_id']} round {ranks[0]['round_id']} ranks "
        f"{ranks[0]['ranks'][:10]}...")

    try:
        eval_run(torch, counters, card, "phase 7 gen test -no_use_pallas",
                 evaluate_gen, data + ["-start_path", ckpts["full"],
                                       "-no_use_pallas", "-mode",
                                       "vd_eval_test"] + out("gen_test_off"),
                 GEN_CHUNK, EVAL_TEST_IMAGES, n_test, want(0))
    finally:
        kffn.enable(True)

    metrics, disc_counts = eval_run(
        torch, counters, card, "phase 7 disc val", evaluate_disc,
        data + ["-start_path", ckpts["encoder"], "-use_pallas",
                "-model", "enc_only_a", "-mode", "vd_eval_val"]
        + out("disc_val"), DISC_CHUNK, EVAL_IMAGES, n_val,
        want(n_val // DISC_CHUNK))
    check_metrics("phase 7 disc val", metrics, EVAL_OPTIONS)

    config = common.parse_config(data + ["-mode", "vd_eval_val"])
    tok = BertTokenizer(vocab_path=vocab_path)
    eval_accuracy(torch, counters, card, "phase 7 gen", config, True,
                  ckpts["full"],
                  VisdialGenDataset(config, tok, mode="vd_eval_val"),
                  rank_gen.flatten_gen, rank_gen.make_chunk_scorer,
                  ("enc_image_feat", "enc_image_loc"), GEN_CHUNK,
                  EVAL_SCORE_TOL["gen"])
    eval_accuracy(torch, counters, card, "phase 7 disc", config, False,
                  ckpts["encoder"],
                  VisdialDiscDataset(config, tok, mode="vd_eval_val"),
                  rank_disc.flatten_disc, rank_disc.make_nsp_scorer,
                  ("image_feat", "image_loc"), DISC_CHUNK,
                  EVAL_SCORE_TOL["disc"])
    return gen_counts, disc_counts, data, scores


TRAIN_BATCH = 72      # the reference's batch (options.py)
TRAIN_DIALOGS = 576   # 8 steps an epoch at batch 72
TRAIN_UTT = 25        # -max_utt_len
# phase 8 (b): the first step's loss (relative) and its per-tensor
# gradient norms (largest relative difference over the tensors), the bf16
# kernel path against the bf16 unfused one; a control whose kernel
# backward loses the residual's gradient must exceed the norms' limit
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_NORM_TOL = 0.5


def encoder_flops(enc, l, r):
    """The matmul FLOPs of one encoder forward of one row at context ``l``
    and ``r`` regions, counted from the shapes: every weight product and
    attention product, the region embedding included; lookups not."""
    d, f, dv, fv, bi = (enc.hidden_size, enc.intermediate_size,
                        enc.v_hidden_size, enc.v_intermediate_size,
                        enc.bi_hidden_size)
    text = l * (2 * (4 * d * d + 2 * d * f) + 4 * l * d)
    vis = r * (2 * (4 * dv * dv + 2 * dv * fv) + 4 * r * dv)
    co = (r * (2 * 3 * dv * bi + 4 * l * bi + 2 * bi * dv + 4 * dv * fv)
          + l * (2 * 3 * d * bi + 4 * r * bi + 2 * bi * d + 4 * d * f))
    emb = r * 2 * (enc.v_feature_size + enc.v_loc_size) * dv
    return (enc.num_hidden_layers * text + enc.v_num_hidden_layers * vis
            + len(enc.v_biattention_id) * co + emb)


def train_flops(enc, dec, b, l, r, t):
    """The matmul FLOPs of one generative training step's forward at batch
    ``b``, context ``l``, ``r`` regions and ``t`` decoder tokens, counted
    from the shapes: the encoder (:func:`encoder_flops`), the fusion, every
    decoder product (causal ones counted whole) and the LM head.  The step
    is taken as 3x this (forward, and a backward of twice the forward);
    recomputation is not counted."""
    d, dv = enc.hidden_size, enc.v_hidden_size
    fusion = r * 2 * dv * d + l * 2 * d * d
    m = r + l
    dd, df = dec.hidden_size, dec.intermediate_size
    dec_layer = (t * (2 * 4 * dd * dd + 4 * t * dd + 2 * dd * dd
                      + 4 * m * dd + 4 * dd * df) + m * 2 * 2 * dd * dd)
    per_row = (encoder_flops(enc, l, r) + fusion
               + dec.num_hidden_layers * dec_layer
               + t * 2 * dd * dec.vocab_size)
    return b * per_row


def disc_flops(enc, b, l, r):
    """The matmul FLOPs of one discriminative training step's forward at
    batch ``b`` rows, context ``l`` and ``r`` regions: the encoder, the
    poolers, the MLM head (transform and the f32 projection onto the
    word table) and the region head; 3x this is the step."""
    d, dv, bi = enc.hidden_size, enc.v_hidden_size, enc.bi_hidden_size
    heads = (l * (2 * d * d + 2 * d * enc.vocab_size)
             + r * (2 * dv * dv + 2 * dv * enc.v_target_size)
             + 2 * (d + dv) * bi + 2 * bi * 2)
    return b * (encoder_flops(enc, l, r) + heads)


def train_inputs(np, tmp, vocab):
    """Phase 8's data in ``tmp``: TRAIN_DIALOGS synthetic 10-round dialogs
    over phase 6's store (images 1000..1199, cycled), once as the
    student's generated-dialog chunk (answers with a perplexity drawn in
    [0, 100), the selection threshold 50) with the store linked under the
    chunk's name, once as a VisDial v1.0 train JSON (question and answer
    tables, 100 options a round), and the zero-dropout model JSONs of part
    (b).  Words come from phase 6's vocab.  Returns (common flags, the
    student's flags, the teacher's flags)."""
    rng = np.random.RandomState(8)
    words = [w for w in vocab[104:] if not w.startswith("##")]

    def sample(lo, hi):
        return " ".join(words[j] for j in
                        rng.randint(0, len(words), rng.randint(lo, hi + 1)))
    ids = [1000 + i % CLI_IMAGES for i in range(TRAIN_DIALOGS)]
    root = os.path.join(tmp, "train") + "/"
    os.makedirs(root + "iter1")
    os.symlink(os.path.join(tmp, "feats.store"),
               root + "cc12m_img_feat_0.store")
    json.dump([{"image_id": i, "url": f"http://example.invalid/{i}.jpg",
                "caption": sample(8, 16),
                "dialog": [{"question": sample(4, 8),
                            "answer": sample(1, 6),
                            "answer_ppl": float(rng.rand() * 100)}
                           for _ in range(ROUNDS)]} for i in ids],
              open(root + "iter1/cc12m_dialogs_0.txt", "w"))
    questions = [sample(4, 8) for _ in range(3000)]
    answers = [sample(1, 6) for _ in range(3000)]

    def rnd():
        opts = rng.choice(len(answers), EVAL_OPTIONS, replace=False)
        gt = int(rng.randint(EVAL_OPTIONS))
        return {"question": int(rng.randint(len(questions))),
                "answer": int(opts[gt]), "gt_index": gt,
                "answer_options": [int(o) for o in opts]}
    visdial = {"data": {"questions": questions, "answers": answers,
                        "dialogs": [{"image_id": i, "caption": sample(8, 14),
                                     "dialog": [rnd() for _ in
                                                range(ROUNDS)]}
                                    for i in ids]}}
    json.dump(visdial, open(root + "visdial_train.json", "w"))
    no_dropout = {"hidden_dropout_prob": 0.0,
                  "attention_probs_dropout_prob": 0.0}
    json.dump(dict(no_dropout, v_hidden_dropout_prob=0.0,
                   v_attention_probs_dropout_prob=0.0),
              open(root + "enc_no_dropout.json", "w"))
    json.dump(no_dropout, open(root + "dec_no_dropout.json", "w"))
    common = ["-vocab_path", os.path.join(tmp, "vocab.txt"),
              "-start_path", os.path.join(tmp, "model.ckpt"),
              "-dtype", "bfloat16", "-batch_size", str(TRAIN_BATCH),
              "-max_seq_len", "256", "-max_utt_len", str(TRAIN_UTT),
              "-max_regions", "37", "-remat_policy", "small",
              "-num_workers", "4", "-log_every", "1"]
    student = ["-mode", "cc12m_train", "-chunk", "1", "-select_data",
               "-cc12m_image_feats", root, "-cc12m_processed_train", root]
    teacher = ["-mode", "vd_train", "-model", "enc_dec_a",
               "-visdial_processed_train", root + "visdial_train.json",
               "-visdial_processed_val", root + "visdial_train.json",
               "-visdial_processed_test", root + "visdial_train.json",
               "-visdial_image_feats", os.path.join(tmp, "feats.store"),
               "-model_enc_config", root + "enc_no_dropout.json",
               "-model_dec_config", root + "dec_no_dropout.json"]
    return common, student, teacher


def train_run(torch, counters, tag, cli, argv, steps, card):
    """One in-process run of a training CLI (``cli.main``) with every
    launch counter set to 0 just before and read just after; every step's
    losses must be finite.  Returns (stats, counts, peak GiB)."""
    import math

    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    model, optimizer = cli.main(argv, max_steps=steps, device="cuda",
                                stats_out=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters.read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, optimizer
    torch.cuda.empty_cache()
    losses = stats["losses"]
    if not losses or any(len(v) != steps or not all(
            math.isfinite(x) for x in v) for v in losses.values()):
        raise AssertionError(f"{tag}: losses {losses}")
    log(f"[{tag}] {steps} steps from iteration {stats['start_iter_id']}: "
        + ", ".join(f"{k} {[round(x, 4) for x in v]}"
                    for k, v in losses.items())
        + f"; step seconds {[round(x, 4) for x in stats['step_seconds']]}, "
        f"main() {wall:.2f} s wall; launches {counts}; peak device memory "
        f"{peak:.2f} GiB; on {card}")
    return stats, counts, peak


def grad_norm_err(a, b):
    """The largest relative difference of the per-tensor gradient norms
    over the tensors both runs have (relative to the reference's norm).
    The attention key biases are left out: softmax ignores a shift shared
    by every key, so their exact gradient is 0 and both readings are
    rounding noise."""
    if set(a) != set(b):
        raise AssertionError("the two runs' gradients name other tensors")
    return max((abs(a[k] - b[k]) / max(b[k], 1e-12), k) for k in b
               if not re.search(r"\.key\d?\.bias$", k))


@contextlib.contextmanager
def residual_lost(kffn):
    """The control of phases 8 (b), 9 (b) and 10: inside the block the
    fused kernels' dense_ln backward loses the residual's gradient."""
    real = kffn.dense_ln_recompute

    def lost(x, w, b, residual, gamma, beta, eps):
        return real(x, w, b, residual * 0.0, gamma, beta, eps)
    kffn.dense_ln_recompute = lost
    try:
        yield
    finally:
        kffn.dense_ln_recompute = real


def training_phase(torch, counters, card, tmp, phase, cli, flops, argv_a,
                   steps_a, save_every, step_ckpt, steps_c, argv_b):
    """Phases 8 and 9 on the training CLI ``cli``.  (a) ``argv_a`` (the
    reference dropout) for ``steps_a`` steps, saving the rotating
    checkpoint every ``save_every``: no fused launch; the steps after the
    first timed, with examples/s and MFU from ``flops`` a step, peak memory
    and each checkpoint's size and save time.  (c) ``-continue`` from (a)'s
    ``step_ckpt`` for ``steps_c`` steps, at its stored step.  (b)
    ``argv_b`` (every dropout 0 but the heads' fixed one): 2 steps with
    the kernels, per_forward() launches of each fused kernel a step (the
    encoder forward's sites; 'small' recomputes none and the heads have
    none), and 2 with -no_use_pallas; the first step's loss and per-tensor
    gradient norms within TRAIN_LOSS_TOL / TRAIN_GRAD_NORM_TOL of the
    unfused one's, a control whose dense_ln backward loses the residual's
    gradient beyond the limit, and the second (warm) steps' times side by
    side.  Returns (b)'s launch counts."""
    from gstx_torch.kernels import ffn as kffn

    zero = {k: 0 for k in SOURCES}
    out_a, out_c = (os.path.join(tmp, f"train_{phase}{p}") for p in "ac")
    stats, counts, peak = train_run(
        torch, counters, f"phase {phase}a", cli, argv_a + [
            "-save_every_steps", str(save_every), "-save_path", out_a],
        steps_a, card)
    check_launches(f"phase {phase}a", counts, zero)
    log(f"[phase {phase}a] no fused launch, as the JAX package's gate "
        "decides: every site's dropout is active, and maybe_fused_* "
        "decline a site where `not deterministic and dropout_rate > 0` "
        "(gstx/kernels/ffn.py:401,419)")
    timed = stats["step_seconds"][1:]
    step_s = statistics.mean(timed)
    log(f"[phase {phase}a] {len(timed)} timed steps (after 1 warm-up): "
        f"{step_s * 1e3:.1f} ms/step (min {min(timed) * 1e3:.1f}, max "
        f"{max(timed) * 1e3:.1f}), {TRAIN_BATCH / step_s:.1f} examples/s, "
        f"{flops / 1e12:.2f} TFLOP a step counted from shapes -> MFU "
        f"{flops / step_s / PEAK_BF16_FLOPS:.4f} of "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; peak device memory "
        f"{peak:.2f} GiB; on {card}")
    for save in stats["saves"]:
        log(f"[phase {phase}a] checkpoint {os.path.basename(save['path'])}"
            f": {save['bytes'] / 1e9:.3f} GB in {save['seconds']:.2f} s")
    # the rotating checkpoint holds the completed step count; the others
    # go before (c) writes its own
    for name in os.listdir(out_a):
        if name.endswith(".ckpt") and name != step_ckpt:
            os.remove(os.path.join(out_a, name))
    stats_c, counts_c, _ = train_run(
        torch, counters, f"phase {phase}c resume", cli, argv_a + [
            "-save_every_steps", str(save_every), "-start_path",
            os.path.join(out_a, step_ckpt), "-continue", "-save_path",
            out_c], steps_c, card)
    if stats_c["start_iter_id"] != steps_a:
        raise AssertionError(f"resumed at {stats_c['start_iter_id']}, not "
                             f"at the stored step {steps_a}")
    check_launches(f"phase {phase}c resume", counts_c, zero)
    log(f"[phase {phase}c] resumed at the stored step {steps_a}")
    shutil.rmtree(out_a)
    shutil.rmtree(out_c)

    def run_b(tag, extra, steps):
        out = os.path.join(tmp, f"train_{phase}b")
        try:
            return train_run(torch, counters, f"phase {phase}b {tag}", cli,
                             argv_b + extra + ["-save_path", out], steps,
                             card)[:2]
        finally:
            kffn.enable(True)
            shutil.rmtree(out, ignore_errors=True)
    steps_b = 2
    stats_b, counts_b = run_b("kernels", ["-use_pallas"], steps_b)
    check_launches(f"phase {phase}b", counts_b, dict(
        zero, fused_ffn=per_forward() * steps_b,
        fused_dense_ln=per_forward() * steps_b))
    stats_u, counts_u = run_b("unfused", ["-no_use_pallas"], steps_b)
    check_launches(f"phase {phase}b unfused", counts_u, zero)
    with residual_lost(kffn):
        stats_x, _ = run_b("control: dense_ln backward without the "
                           "residual", ["-use_pallas"], 1)
    loss_b, loss_u = stats_b["losses"]["loss"][0], \
        stats_u["losses"]["loss"][0]
    loss_err = abs(loss_b - loss_u) / abs(loss_u)
    norms_b, norms_u = stats_b["grad_norms"], stats_u["grad_norms"]
    norm_err, worst = grad_norm_err(norms_b, norms_u)
    control, worst_x = grad_norm_err(stats_x["grad_norms"], norms_u)
    warm_b, warm_u = stats_b["step_seconds"][1], stats_u["step_seconds"][1]
    log(f"[phase {phase}b] largest gradient-norm difference at {worst}: "
        f"{norms_b[worst]:.6g} against {norms_u[worst]:.6g} (the largest "
        f"norm {max(norms_u.values()):.6g}); the control's at {worst_x}")
    log(f"[phase {phase}b] first step, bf16 kernel path against bf16 "
        f"unfused: loss {loss_b:.6f} / {loss_u:.6f} (relative "
        f"{loss_err:.4g}, limit {TRAIN_LOSS_TOL}); per-tensor gradient "
        f"norms over {len(norms_u)} tensors, largest relative difference "
        f"{norm_err:.4g} (limit {TRAIN_GRAD_NORM_TOL}); control (dense_ln's"
        f" residual gradient lost) {control:.4g}; second (warm) step "
        f"{warm_b * 1e3:.1f} ms with the kernels (fused forward, f32 "
        f"recompute backward), {warm_u * 1e3:.1f} ms unfused ("
        f"{warm_b / warm_u:.3f}x); on {card}")
    if not (loss_err <= TRAIN_LOSS_TOL and norm_err <= TRAIN_GRAD_NORM_TOL):
        raise AssertionError(f"phase {phase}b: the kernel path's first "
                             "step disagrees with the unfused one")
    if not control > TRAIN_GRAD_NORM_TOL:
        raise AssertionError(f"phase {phase}b: the broken-backward control "
                             "passes the limit: the check cannot see it")
    return counts_b


def train_phase(torch, np, counters, card, tmp, vocab):
    """Phase 8: the training CLI (gstx_torch.cli.train_gen.main) in-process
    at full width: 12/6/6 encoder, 12-layer decoder, widths 768 / 1,024, a
    30,522-word vocab, bf16 compute over f32 parameters, -remat_policy
    small, batch 72, warm-started from phase 6's reference .ckpt, on
    synthetic data of the real shapes, through training_phase: (a) the
    student, cc12m_train -select_data with the reference dropout, 1
    warm-up and 5 timed steps; (c) -continue for 2 steps; (b) the teacher,
    vd_train enc_dec_a with every dropout 0.  Returns (b)'s launch
    counts."""
    from gstx_torch.cli import train_gen
    from gstx_torch.core.config import DecoderConfig, EncoderConfig

    t0 = time.perf_counter()
    common, student, teacher = train_inputs(np, tmp, vocab)
    log(f"[phase 8] inputs written in {time.perf_counter() - t0:.2f} s; "
        f"free disk {shutil.disk_usage(tmp).free / 2**30:.1f} GiB")
    flops = 3 * train_flops(EncoderConfig(), DecoderConfig(), TRAIN_BATCH,
                            256, 37, TRAIN_UTT)
    return training_phase(torch, counters, card, tmp, 8, train_gen, flops,
                          common + student, 6, 3, "cc12m_train_step.ckpt",
                          2, common + teacher), (common, teacher)


DISC_DIALOGS = 144    # 2 steps an epoch at batch 72


def disc_inputs(np, tmp, vocab):
    """Phase 9's data in ``tmp``: DISC_DIALOGS synthetic VisDial v1.0 train
    dialogs over phase 6's store (images 1000..1143), 10 rounds of a
    question and 100 answer options, their dense pseudo-labels (a score in
    [0, 1) for every option of every round), and the zero-dropout encoder
    JSON of part (b).  Words come from phase 6's vocab.  Returns (the
    common flags, the flags of part (b))."""
    rng = np.random.RandomState(9)
    words = [w for w in vocab[104:] if not w.startswith("##")]

    def sample(lo, hi):
        return " ".join(words[j] for j in
                        rng.randint(0, len(words), rng.randint(lo, hi + 1)))
    questions = [sample(4, 8) for _ in range(3000)]
    answers = [sample(1, 6) for _ in range(3000)]

    def rnd():
        opts = rng.choice(len(answers), EVAL_OPTIONS, replace=False)
        gt = int(rng.randint(EVAL_OPTIONS))
        return {"question": int(rng.randint(len(questions))),
                "answer": int(opts[gt]), "gt_index": gt,
                "answer_options": [int(o) for o in opts]}
    ids = [1000 + i for i in range(DISC_DIALOGS)]
    root = os.path.join(tmp, "disc") + "/"
    os.makedirs(root)
    json.dump({"data": {"questions": questions, "answers": answers,
                        "dialogs": [{"image_id": i, "caption": sample(8, 14),
                                     "dialog": [rnd() for _ in
                                                range(ROUNDS)]}
                                    for i in ids]}},
              open(root + "train.json", "w"))
    json.dump([{"image_id": i, "scores": np.round(rng.rand(
        ROUNDS, EVAL_OPTIONS), 4).tolist()} for i in ids],
        open(root + "train_dense.json", "w"))
    json.dump({"hidden_dropout_prob": 0.0,
               "attention_probs_dropout_prob": 0.0,
               "v_hidden_dropout_prob": 0.0,
               "v_attention_probs_dropout_prob": 0.0},
              open(root + "enc_no_dropout.json", "w"))
    common = ["-mode", "vd_train", "-model", "enc_only_a",
              "-vocab_path", os.path.join(tmp, "vocab.txt"),
              "-start_path", os.path.join(tmp, "model.ckpt"),
              "-visdial_processed_train", root + "train.json",
              "-visdial_processed_val", root + "train.json",
              "-visdial_processed_test", root + "train.json",
              "-visdial_image_feats", os.path.join(tmp, "feats.store"),
              "-vd_version", "1.0", "-num_options", str(EVAL_OPTIONS),
              "-dtype", "bfloat16", "-batch_size", str(TRAIN_BATCH),
              "-max_seq_len", "256", "-max_regions", "37",
              "-remat_policy", "small", "-num_workers", "4",
              "-log_every", "1"]
    dense = ["-train_dense", "-visdial_processed_train_dense",
             root + "train_dense.json",
             "-model_enc_config", root + "enc_no_dropout.json"]
    return common, dense


def disc_phase(torch, np, counters, card, tmp, vocab):
    """Phase 9: the discriminative training CLI (gstx_torch.cli.train_disc
    .main) in-process at full width: the encoder-only model (12/6/6,
    widths 768 / 1,024, a 30,522-word vocab), bf16 compute over f32
    parameters, -remat_policy small, batch 72 rows of 1,440 a batch (72
    dialogs x 10 rounds x the positive and one negative), warm-started
    from phase 6's full .ckpt (its encoder part), on DISC_DIALOGS
    synthetic dialogs, through training_phase: (a) the reference dropout,
    1 warm-up and 3 timed steps; (c) -continue for 1 step; (b)
    -train_dense with every dropout 0 but the heads' fixed 0.1.  Returns
    (b)'s launch counts."""
    from gstx_torch.cli import train_disc
    from gstx_torch.core.config import EncoderConfig

    t0 = time.perf_counter()
    common, dense = disc_inputs(np, tmp, vocab)
    log(f"[phase 9] inputs written in {time.perf_counter() - t0:.2f} s")
    flops = 3 * disc_flops(EncoderConfig(), TRAIN_BATCH, 256, 37)
    return training_phase(torch, counters, card, tmp, 9, train_disc, flops,
                          common, 4, 4, "vd_train_disc_step.ckpt", 1,
                          common + dense), (common, dense)


# phase 10: dialogs of each attack run, and the FGSM input gradient's
# cosine similarity, bf16 kernel path against the f32 unfused model, on one
# dense round: the limit lies between the sound reading on an H100
# (0.99969) and that of a control whose dense_ln backward loses the
# residual's gradient (0.0174), ~60x from either in 1 - cosine
ATTACK_DIALOGS = {"fgsm": 4, "random_token, -mlm_path": 2,
                  "random_token": 1, "coreference": 2}
FGSM_COS_TOL = 0.98


def attack_inputs(torch, np, tmp, vocab):
    """Phase 10's extra inputs in ``tmp``: a bert-base-shaped attacker
    masked LM from a seed saved as a Hugging Face-named
    ``pytorch_model.bin``, and for coreference a counter-fitted similarity
    matrix (each target word 0.8 from one synonym) with its word maps and
    a dependency JSON naming, for every round of each val dialog, the
    first word of its first question and answer (rounds 1 and 2 of the
    reference's numbering), so that the dense round's context changes.
    Returns the flags of each attack run."""
    import pickle

    from gstx_torch.models.mlm import BertMLM, mlm_config

    root = os.path.join(tmp, "attack") + "/"
    os.makedirs(root)
    attacker = BertMLM(mlm_config(), device="cuda", seed=0)
    torch.save({k: v.cpu() for k, v in attacker.state_dict().items()},
               root + "pytorch_model.bin")
    del attacker
    val = json.load(open(os.path.join(tmp, "val.json")))["data"]
    rng = np.random.RandomState(10)
    words = [w for w in vocab[104:] if not w.startswith("##")]
    deps, targets = [], []
    for d in val["dialogs"]:
        first = [val["questions"][d["dialog"][0]["question"]].split()[0],
                 val["answers"][d["dialog"][1]["answer"]].split()[0]]
        targets += first
        deps.append({"image_id": d["image_id"], "coreference": [
            {"1": first[0], "2": first[1]} for _ in range(ROUNDS)]})
    targets = sorted(set(targets))
    synonyms = [words[i] for i in rng.randint(0, len(words),
                                              len(targets))]
    table = targets + synonyms
    sim = np.eye(len(table), dtype=np.float32)
    for i in range(len(targets)):
        sim[i, len(targets) + i] = sim[len(targets) + i, i] = 0.8
    np.save(root + "cos.npy", sim)
    idx2word = dict(enumerate(table))
    pickle.dump(idx2word, open(root + "i2w.pickle", "wb"))
    pickle.dump({w: i for i, w in idx2word.items()},
                open(root + "w2i.pickle", "wb"))
    json.dump(deps, open(root + "coref.json", "w"))
    return {"fgsm": ["-attack", "fgsm"],
            "random_token, -mlm_path": [
                "-attack", "random_token", "-mask_prob", "0.15",
                "-mlm_path", root + "pytorch_model.bin"],
            "random_token": ["-attack", "random_token", "-mask_prob",
                             "0.15"],
            "coreference": [
                "-attack", "coreference",
                "-cos_sim_counter_fitting", root + "cos.npy",
                "-cos_sim_idx2word", root + "i2w.pickle",
                "-cos_sim_word2idx", root + "w2i.pickle",
                "-visdial_processed_val_coref_dependency",
                root + "coref.json"]}


def attack_launches(attack, dialogs):
    """The fused launches of each kernel an attack run gives, derived from
    the code: every round's chunk is scored by one forward (per_forward()
    sites); FGSM adds the gradient pass's forward on its dense round (its
    backward is the f32 recompute, no launch); random_token adds the
    refill's forward every round, the attacker's 12 layers (one of each
    kernel a layer) or the dialog encoder's own forward; coreference only
    edits the context."""
    from gstx_torch.models.mlm import mlm_config

    each = per_forward()
    per_dialog = {"fgsm": ROUNDS * each + each,
                  "random_token, -mlm_path": ROUNDS * (
                      each + mlm_config().num_hidden_layers),
                  "random_token": ROUNDS * 2 * each,
                  "coreference": ROUNDS * each}[attack]
    return per_dialog * dialogs


def fgsm_accuracy(torch, counters, card, config, ckpt, dataset):
    """The FGSM input gradient of the first val dialog's dense round (100
    options): the bf16 kernel path's against the f32 unfused model's by
    cosine similarity, beside the bf16 unfused model's and a control on
    the kernel path whose dense_ln backward loses the residual's gradient;
    then the scores of the features the kernel path perturbed, bf16 kernel
    path against the f32 model, centred over the options."""
    from gstx_torch.cli.common import build_model, load_params
    from gstx_torch.data.loader import collate
    from gstx_torch.eval.attacks import make_chunk_scorer, make_fgsm_scorer
    from gstx_torch.eval.rank_gen import (batch_to_device, chunk_inputs,
                                          flatten_gen)
    from gstx_torch.kernels import ffn as kffn
    from gstx_torch.models.encdec import precast_

    ref = load_params(build_model(config, device="cuda"), ckpt)
    model = precast_(copy.deepcopy(ref), torch.bfloat16)
    batch = collate([dataset.__getitem__(0, seed=0)])
    text, images, (_, rounds, options) = flatten_gen(batch)
    j = int(batch["round_id"][0, 0]) - 1
    chunk = chunk_inputs(*batch_to_device(text, images, "cuda",
                                          torch.float32, ()),
                         j * options, (j + 1) * options, rounds * options)
    rel = torch.from_numpy(batch["gt_relevance"][0]).to("cuda")
    feat = chunk["enc_image_feat"]

    def grad(m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = make_fgsm_scorer(m).nll_grad(feat, chunk, rel)
        torch.cuda.synchronize()
        return g.flatten(), time.perf_counter() - t0

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    want, want_s = grad(ref)
    counters.reset()
    got, got_s = grad(model)
    counts = counters.read()
    check_launches("phase 10 FGSM gradient pass", counts, dict(
        {k: 0 for k in SOURCES}, fused_ffn=per_forward(),
        fused_dense_ln=per_forward()))
    kffn.enable(False)
    try:
        unfused, _ = grad(model)
    finally:
        kffn.enable(True)
    with residual_lost(kffn):
        control, _ = grad(model)
    perturbed = feat + torch.sign(got).reshape(feat.shape)
    with torch.no_grad():
        s_bf = make_chunk_scorer(model)(dict(chunk,
                                             enc_image_feat=perturbed))
        s_32 = make_chunk_scorer(ref)(dict(chunk, enc_image_feat=perturbed))
    err = centred_err(torch, s_bf.float(), s_32.float())
    same_sign = float((torch.sign(got) == torch.sign(want)).float().mean())
    sound, control_cos = cos(got, want), cos(control, want)
    log(f"[phase 10] FGSM input gradient of dialog 0's dense round {j + 1} "
        f"({options} options, {int((rel > 0).sum())} relevant): cosine to "
        f"the f32 unfused model's: bf16 kernel path {sound:.6f} (limit "
        f"{FGSM_COS_TOL}; signs equal on {same_sign:.4f} of the entries), "
        f"bf16 unfused {cos(unfused, want):.6f}, control (dense_ln's "
        f"residual gradient lost) {control_cos:.6f}; gradient pass "
        f"{got_s * 1e3:.1f} ms bf16 kernels, {want_s * 1e3:.1f} ms f32; "
        f"perturbed scores centred over the options, relative error "
        f"{err:.4g} (limit {EVAL_SCORE_TOL['gen']}); on {card}")
    if not (sound >= FGSM_COS_TOL and err <= EVAL_SCORE_TOL["gen"]):
        raise AssertionError("phase 10: the bf16 kernel path's FGSM "
                             "disagrees with the f32 model's")
    if not control_cos < FGSM_COS_TOL:
        raise AssertionError("phase 10: the broken-backward control passes "
                             "the limit: the check cannot see it")
    del ref, model


def attack_phase(torch, np, counters, card, tmp, vocab, ckpts):
    """Phase 10: the attack evaluation CLI (gstx_torch.cli.
    evaluate_gen_attack.main) in-process at full width, bf16, -use_pallas,
    on phase 7's synthetic VisDial v1.0 val set and phase 6's full .ckpt,
    batches of one dialog: each attack of ATTACK_DIALOGS with its launches
    against attack_launches(), metrics in range, scored sequences/s and
    peak memory; then fgsm_accuracy.  Returns the FGSM run's counts."""
    from gstx_torch.cli import common, evaluate_gen_attack
    from gstx_torch.data.tokenizer import BertTokenizer
    from gstx_torch.data.visdial import VisdialGenDataset

    t0 = time.perf_counter()
    runs = attack_inputs(torch, np, tmp, vocab)
    vocab_path = os.path.join(tmp, "vocab.txt")
    data = eval_flags(tmp) + ["-vocab_path", vocab_path,
                                     "-mode", "vd_eval_val",
                                     "-start_path", ckpts["full"],
                                     "-use_pallas"]
    log(f"[phase 10] inputs written in {time.perf_counter() - t0:.2f} s")
    out = {}
    for attack, dialogs in ATTACK_DIALOGS.items():
        tag = f"phase 10 {attack}"
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters.reset()
        t0 = time.perf_counter()
        metrics = evaluate_gen_attack.main(
            data + runs[attack] + ["-save_path", os.path.join(
                tmp, "attack_" + attack.split(",")[0])],
            max_batches=dialogs, device="cuda", stats_out=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counters.read()
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = attack_launches(attack, dialogs)
        check_launches(tag, counts, dict({k: 0 for k in SOURCES},
                                         fused_ffn=n, fused_dense_ln=n))
        want_fgsm = dialogs if attack == "fgsm" else 0
        if (stats["images"], stats["sequences"], stats["fgsm_chunks"]) != \
                (dialogs, dialogs * ROUNDS * EVAL_OPTIONS, want_fgsm) or \
                (stats["text_attacked"] > 0) != (attack != "fgsm"):
            raise AssertionError(f"{tag}: {stats}")
        check_metrics(tag, metrics, EVAL_OPTIONS)
        loop = stats["loop_seconds"]
        log(f"[{tag}] {dialogs} dialogs, {stats['sequences']} sequences in "
            f"{stats['chunks']} chunks of {EVAL_OPTIONS} "
            f"({stats['fgsm_chunks']} perturbed, {stats['text_attacked']} "
            f"contexts changed): main() {wall:.2f} s wall "
            f"with loading, batch loop {loop:.2f} s (waiting for the loader "
            f"{stats['wait_seconds']:.2f} s) = "
            f"{stats['sequences'] / loop:.1f} scored sequences/s; peak "
            f"device memory {peak:.2f} GiB; on {card}")
        out[attack] = counts
    config = common.parse_config(data)
    fgsm_accuracy(torch, counters, card, config, ckpts["full"],
                  VisdialGenDataset(config, BertTokenizer(
                      vocab_path=vocab_path), mode="vd_eval_val"))
    return out["fgsm"]


BEAM_BATCH, BEAM_K, BEAM_STEPS = 32, 4, 18   # 128 rows of 18 steps
# phase 11: |score - teacher-forced log-likelihood| of every beam, in
# nats, the largest over the B*K beams.  The two sides sum the same up to
# BEAM_STEPS log-probs through the same weights, one token at a time over
# the self-attention cache and in one causal pass.
# In bf16 they differ by rounding: ~1e-2 relative on the logits (phase 3),
# a few thousandths of a nat a token (0.0038-0.0089 on an H100);
# BEAM_SCORE_TOL bounds 18 tokens of ~0.02 each.  It bounds rounding and
# nothing else: a search that skips the cache reorder reads 0.14 nats in
# bf16, inside it, and the int8 memory's sound search reads 0.16, above
# that control, so no limit in bf16 or over the int8 memory separates a
# broken reorder from rounding.
BEAM_SCORE_TOL = 0.5
# The reorder's gate is f32, where the two sides differ by summation order
# only (~1e-6 a logit).  A search that skips the reorder scores each step
# over another beam's history: at random weights the history moves a
# logit little (0.14 nats over 18 steps), but some hundred times f32's
# rounding, so BEAM_REORDER_TOL sits between them and that control must
# exceed it.
BEAM_REORDER_TOL = 1e-2


def beam_error(torch, model, state, kv, mask):
    """The largest |score - log-likelihood| over every beam of ``state``,
    and the largest per scored token: each beam's tokens re-scored in one
    cache-less teacher-forced pass (``decode_logits_cached`` over the
    memory K/V, no self-attention cache), summed up to and including its
    first EOS."""
    import torch.nn.functional as F

    from gstx_torch.core.config import SEP_ID

    tokens = state.tokens.reshape(-1, state.tokens.shape[-1])
    with torch.no_grad():
        logits = model.decode_logits_cached(
            tokens[:, :-1], torch.ones_like(tokens[:, :-1]), kv, mask)
        logp = F.log_softmax(logits.float(), -1).gather(
            -1, tokens[:, 1:, None])[..., 0]
    is_eos = (tokens[:, 1:] == SEP_ID).long()
    scored = (is_eos.cumsum(-1) - is_eos) == 0
    ll = (logp * scored).sum(-1)
    err = (ll - state.scores.reshape(-1)).abs()
    return float(err.max()), float((err / scored.sum(-1)).max())


def beam_phase(torch, np, counters, card, ckpt):
    """Phase 11: beam search (gstx_torch.decode.beam) at full width,
    -use_pallas, on phase 6's .ckpt: BEAM_BATCH contexts of 256 with 37
    regions, BEAM_STEPS steps.  In bf16 with the .ckpt's EOS bias (beams
    end early): (a) K = 1 against greedy sample_sequence through the same
    step, token for token; (b) K = BEAM_K, 30 / 30 fused launches, every
    beam's score against its teacher-forced log-likelihood within
    BEAM_SCORE_TOL.  Without the bias (every beam runs every step): (b)
    again in bf16; (c) over the int8 memory with the decode kernel on; and
    in f32 (a) and the reorder check: every score within BEAM_REORDER_TOL,
    a control that skips the cache reorder above it.  Returns the launch
    counts of (b) and (c), and a function that profiles one bf16 and one
    f32 search, to be called after every timed phase."""
    from gstx_torch.core.config import SEP_ID
    from gstx_torch.decode import beam
    from gstx_torch.decode.sampler import (DecodeSettings, init_cache,
                                           sample_sequence)
    from gstx_torch.kernels import decode_attn as kdecode
    from gstx_torch.models import decoder as tdecoder
    from gstx_torch.models.encdec import precast_

    from gstx_torch.cli import common

    t0 = time.perf_counter()
    model = precast_(common.load_params(common.build_model(
        common.parse_config([]), device="cuda"), ckpt))
    batch = make_batch(np, model.enc_config, BEAM_BATCH, 256, 37)
    args = [torch.from_numpy(batch[k]).cuda() for k in
            ("enc_input_ids", "enc_image_feat", "enc_image_loc",
             "enc_segments")]
    args += [(args[0] != 0).long(),
             torch.from_numpy(batch["enc_image_mask"]).cuda()]
    log(f"[phase 11] model loaded in {time.perf_counter() - t0:.2f} s")
    b, steps = BEAM_BATCH, BEAM_STEPS

    def prepared(k, quantize=False):
        mem_kv, mem_mask = model.decode_prepare(*args)
        if quantize:
            mem_kv = tdecoder.quantize_memory_kv(mem_kv, mem_mask,
                                                 torch.bfloat16)
        kv, mask = beam.tile_for_beams((mem_kv, mem_mask), k)

        def step(tok, pos, caches):
            return model.decode_step(tok, pos, caches, kv, mask)
        return step, kv, mask, init_cache(model.dec_config, b * k, steps + 1,
                                          model.dtype, "cuda")

    @torch.no_grad()
    def search(tag, k, quantize=False):
        """decode_prepare and the search with the counters set to 0 just
        before and read just after, the search alone timed; returns
        (state, best tokens, max |err| and per token, counts)."""
        counters.reset()
        step, kv, mask, caches = prepared(k, quantize)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = beam.beam_steps(step, caches, b, k, steps)
        seq, _ = beam.best_beam(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counters.read()
        err = beam_error(torch, model, state, kv, mask)
        log(f"[phase 11 {tag}] K={k}, {b * k} rows x {steps} steps, "
            f"{str(model.dtype)[6:]}: {wall * 1e3 / steps:.2f} ms a beam "
            f"step, {b * k * steps / wall:.1f} generated tok/s (B*K*steps "
            f"over the search's wall) on {card}; every beam's score vs its "
            f"teacher-forced log-likelihood: max |err| {err[0]:.6f} nats "
            f"({err[1]:.6f} a scored token); "
            f"{int(state.finished.sum())} of {b * k} beams finished; best "
            f"lengths {(seq != 0).sum(-1).tolist()}")
        return state, seq, err, counts

    @torch.no_grad()
    def greedy_check(tag):
        _, seq1, _, _ = search(f"a {tag}", 1)
        step, _, _, caches = prepared(1)
        greedy = sample_sequence(
            step, torch.Generator(device="cuda").manual_seed(0), b, caches,
            DecodeSettings(max_steps=steps, temperature=1.0, top_k=1,
                           ngram_blocking_size=0), device="cuda")
        diff = int((seq1 != greedy).sum())
        log(f"[phase 11 a {tag}] K=1 vs greedy sample_sequence: {diff} of "
            f"{seq1.numel()} tokens differ")
        if diff:
            raise AssertionError("phase 11 (a): K=1 beam search is not "
                                 "greedy")
        return seq1

    per_prepare = per_forward()
    search("warm-up", BEAM_K)
    seq1 = greedy_check("bf16, EOS bias")
    _, seq, err, counts = search("b bf16, EOS bias", BEAM_K)
    check_launches("phase 11 b", counts, dict(
        {k: 0 for k in SOURCES}, fused_ffn=per_prepare,
        fused_dense_ln=per_prepare))

    with torch.no_grad():
        model.dec.lm_head.bias[SEP_ID] -= EOS_BIAS
    _, l_seq, l_err, _ = search("b bf16, no EOS bias", BEAM_K)
    kdecode.enable_kernel()
    try:
        _, q_seq, q_err, q_counts = search("c int8 + decode kernel, no EOS "
                                           "bias", BEAM_K, True)
    finally:
        kdecode.enable_kernel(False)
    check_launches("phase 11 c", q_counts, dict(
        {k: 0 for k in SOURCES}, fused_ffn=per_prepare,
        fused_dense_ln=per_prepare,
        quant_decode_attention=model.dec_config.num_hidden_layers * steps))
    log(f"[phase 11 c] best tokens equal to bf16's at "
        f"{float((q_seq == l_seq).float().mean()):.4f}")
    for i in range(2):
        log(f"[phase 11] row {i}: (a) {seq1[i].tolist()}; (b) "
            f"{seq[i].tolist()}\n[phase 11] row {i} without the bias: (b) "
            f"{l_seq[i].tolist()}\n[phase 11] row {i} without the bias: "
            f"(c) {q_seq[i].tolist()}")
    if max(err[0], l_err[0], q_err[0]) > BEAM_SCORE_TOL:
        raise AssertionError("phase 11 (b)/(c): bf16 beam scores outside "
                             "BEAM_SCORE_TOL")

    precast_(model, torch.float32)
    greedy_check("f32, no EOS bias")
    _, _, f_err, _ = search("b f32, no EOS bias", BEAM_K)
    reorder = beam._reorder_
    beam._reorder_ = lambda caches, rows: None
    try:
        _, _, c_err, _ = search("b f32 control, no cache reorder", BEAM_K)
    finally:
        beam._reorder_ = reorder
    log(f"[phase 11 b] the cache reorder in f32: max |err| {f_err[0]:.6f} "
        f"nats, control {c_err[0]:.6f}, limit {BEAM_REORDER_TOL}")
    if not f_err[0] <= BEAM_REORDER_TOL < c_err[0]:
        raise AssertionError("phase 11 (b): f32 beam scores outside "
                             "BEAM_REORDER_TOL, or the control inside it")

    @torch.no_grad()
    def profile_searches():
        """Where a beam step's time goes: a K = BEAM_K search without the
        EOS bias under torch.profiler, in bf16 and in f32 (the device's
        busy time and launches against the wall)."""
        for dtype in (torch.bfloat16, torch.float32):
            precast_(model, dtype)
            step, _, _, caches = prepared(BEAM_K)
            profiled(torch, lambda: beam.beam_steps(step, caches, b, BEAM_K,
                                                    steps),
                     f"beam search, {b * BEAM_K} rows x {steps} steps, "
                     f"{str(dtype)[6:]}", card, "phase 11 profile")
    return counts, q_counts, profile_searches


DEMO_TURNS = ["is there a dog", "what color is the car",
              "how many people are there", "is it sunny"]


def unbiased_ckpt(torch, ckpt, path):
    """Phase 6's .ckpt at ``path`` without its EOS bias: each name of the
    LM head's bias (two names of one tensor) cloned and lowered by
    EOS_BIAS at SEP, as phase 11 does in memory."""
    from gstx_torch.core.config import SEP_ID

    state = torch.load(ckpt, map_location="cpu", mmap=True,
                       weights_only=True)["model_state_dict"]
    for name in ("decoder.decoder.lm_head.bias",
                 "decoder.decoder.lm_head.decoder.bias"):
        state[name] = state[name].clone()
        state[name][SEP_ID] -= EOS_BIAS
    torch.save({"model_state_dict": state}, path)
    return path


def demo_phase(torch, counters, card, tmp, ckpt, vocab_path):
    """Phase 12: the interactive demo (gstx_torch.cli.inference.main)
    in-process at full width, bf16, on phase 6's .ckpt without its EOS
    bias (greedy decoding with it ends every reply at its first token),
    phase 6's vocab and phase 7's val set: DEMO_TURNS scripted turns,
    greedy (-top_k 1), max_turns 4, under -use_pallas (one encoder forward
    a turn: 30 fused_ffn and 30 fused_dense_ln launches) and
    -no_use_pallas (0).  Every reply must be non-empty.  Returns the
    -use_pallas run's counts."""
    from gstx_torch.cli import inference
    from gstx_torch.kernels import ffn as kffn

    demo_ckpt = unbiased_ckpt(torch, ckpt, os.path.join(tmp, "demo.ckpt"))
    argv = eval_flags(tmp) + [
        "-vocab_path", vocab_path, "-start_path", demo_ckpt, "-top_k", "1",
        "-max_dec_len", "18"]
    transcripts, out = {}, None
    for flag in ("-use_pallas", "-no_use_pallas"):
        lines, marks = [], []
        asked = iter(DEMO_TURNS)

        def scripted(prompt):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            return next(asked)

        counters.reset()
        inference.main(argv + [flag], input_fn=scripted,
                       output_fn=lines.append, max_turns=len(DEMO_TURNS),
                       device="cuda")
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts = counters.read()
        n = per_forward() * len(DEMO_TURNS) if flag == "-use_pallas" else 0
        check_launches(f"phase 12 {flag}", counts, dict(
            {k: 0 for k in SOURCES}, fused_ffn=n, fused_dense_ln=n))
        words = [len(line[5:].split()) for line in lines
                 if line.startswith("bot: ")]
        if len(words) != len(DEMO_TURNS) or not all(words):
            raise AssertionError(f"phase 12 {flag}: {lines}")
        turn_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        log(f"[phase 12 {flag}] {len(words)} turns: ms a turn "
            + ", ".join(f"{t:.1f}" for t in turn_ms) + f" on {card}; "
            f"reply lengths {words} words")
        transcripts[flag] = lines
        if out is None:
            out = counts
    kffn.enable(True)
    log("[phase 12] transcripts (-use_pallas | -no_use_pallas):")
    for a, b in zip(*transcripts.values()):
        log(f"[phase 12]   {a!r} | {b!r}")
    os.remove(demo_ckpt)
    return out


SELFTRAIN_IMAGES = 96


def selftrain_phase(torch, np, card, tmp, ckpt, vocab):
    """Phase 13: one GST iteration as a user runs it, ``python -m
    gstx_torch.cli.selftrain -iterations 1 -chunks 1`` in a subprocess, each
    stage a process on the card: phase 6's .ckpt as questioner and teacher,
    a CC12M chunk of SELFTRAIN_IMAGES images (store and captions), batch 72,
    one epoch, phase 8's VisDial train set capped at 144 dialogs for the
    finetune.  Checks each stage's exit code, the dialog file (10 rounds
    with answer_ppl), both final.ckpt files and that the finetune moved
    the weights; prints each stage's wall time, the utterances' lengths
    and each checkpoint's size."""
    from gstx_torch.data.feature_store import make_synthetic_store

    root = os.path.join(tmp, "selftrain")
    feats, caps = os.path.join(root, "feats"), os.path.join(root, "caps")
    os.makedirs(feats)
    os.makedirs(caps)
    ids = list(range(3000, 3000 + SELFTRAIN_IMAGES))
    make_synthetic_store(os.path.join(feats, "cc12m_img_feat_0.store"), ids,
                         num_boxes=36, feat_dim=2048, num_classes=1601,
                         seed=3)
    rng = np.random.RandomState(3)
    words = [w for w in vocab[104:] if not w.startswith("##")]
    with open(os.path.join(caps, "cc12m_captions_0.json"), "w") as f:
        json.dump([{"image_id": i, "caption": " ".join(
            words[j] for j in rng.randint(0, len(words),
                                          rng.randint(8, 17)))}
            for i in ids], f)
    train_json = os.path.join(tmp, "train", "visdial_train.json")
    out_dir = os.path.join(root, "out")
    cmd = [sys.executable, "-m", "gstx_torch.cli.selftrain",
           "-iterations", "1", "-chunks", "1",
           "-start_path_q", ckpt, "-start_path_a", ckpt,
           "-cc12m_image_feats", feats, "-cc12m_caption_dir", caps,
           "-dialog_root", os.path.join(root, "dialogs"),
           "-save_path", out_dir,
           "-extra", "-vocab_path", os.path.join(tmp, "vocab.txt"),
           "-dtype", "bfloat16", "-use_pallas", "-batch_size", "72",
           "-num_epochs", "1", "-max_seq_len", "256", "-max_regions", "37",
           "-max_dec_len", "18", "-num_dialog_rounds", str(ROUNDS),
           "-remat_policy", "small", "-num_workers", "4", "-log_every", "1",
           # a random model's answers are far above the reference's
           # selection threshold of 50: select every row
           "-threshold", "1000000000",
           "-visdial_processed_train", train_json,
           "-visdial_processed_val", train_json,
           "-visdial_processed_test", train_json,
           "-visdial_image_feats", os.path.join(tmp, "feats.store"),
           "-num_train_samples", "144"]
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith("[selftrain] stage"):
            log(f"[phase 13] {line}")
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-4000:])
        raise AssertionError(f"phase 13: selftrain exited {proc.returncode}")
    dialog_path = os.path.join(root, "dialogs", "iter1",
                               "cc12m_dialogs_0.txt")
    with open(dialog_path) as f:
        dialogs = json.load(f)
    if not dialogs or any(
            len(d["dialog"]) != ROUNDS
            or not all("answer_ppl" in r for r in d["dialog"])
            for d in dialogs):
        raise AssertionError("phase 13: bad dialog file")
    # the .ckpt's EOS bias ends most utterances early: their lengths
    for key in ("question", "answer"):
        n = [len(r[key].split()) for d in dialogs for r in d["dialog"]]
        log(f"[phase 13] {key}s: {len(n)}, mean {statistics.mean(n):.3f} "
            f"words, longest {max(n)}, empty {n.count(0)}")
    finals = {k: os.path.join(out_dir, f"{k}_iter1", "final.ckpt")
              for k in ("student", "finetune")}
    states = {k: torch.load(p, map_location="cpu", mmap=True,
                            weights_only=True)["model_state_dict"]
              for k, p in finals.items()}
    name = "decoder.decoder.lm_head.decoder.weight"
    moved = not torch.equal(states["student"][name], states["finetune"][name])
    log(f"[phase 13] selftrain, 1 iteration of 1 chunk "
        f"({SELFTRAIN_IMAGES} images): {wall:.2f} s wall; "
        f"{len(dialogs)} dialogs of {ROUNDS} rounds; checkpoints "
        + ", ".join(f"{k} {os.path.getsize(p) / 1e9:.3f} GB"
                    for k, p in finals.items())
        + f"; the finetune moved the weights: {moved}; on {card}")
    del states
    if not moved:
        raise AssertionError("phase 13: the finetune left the student's "
                             "weights unchanged")
    shutil.rmtree(root)


# ---------------------------------------------------------------------- #
# phase 14: data parallelism across processes
# ---------------------------------------------------------------------- #


DP_RANKS = 2
# (b)'s learning rate (every group, the schedule's floor too): the first
# AdamW step moves an entry by about the lr whatever its gradient, so at the
# trainers' 1e-5 no fault of the gradient all-reduce could reach the bf16
# parameter tolerance; at 0.1 an entry whose gradient's sign a missing
# all-reduce flips moves 0.2 away, past it
DP_LR = "0.1"
DP_GREEDY_IMAGES = 8   # (c)'s f32 greedy comparison


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(tag, spec, tmp, world=DP_RANKS, backend=None,
                 timeout=900):
    """``world`` ranks of this script (``--rank``) on ``spec``, launched as
    a user launches the port: ``python -m torch.distributed.run
    --nproc_per_node world``, whose agent serves the rendezvous store, with
    GSTX_DIST_BACKEND=``backend`` when given.  Each rank writes its own log
    (:func:`rank_main`).  A rank that fails (or a launch that outlives
    ``timeout``) fails the phase: the launcher and every rank are stopped
    and every log's tail printed.  Returns (each rank's result, wall s)."""
    root = tempfile.mkdtemp(prefix="ranks_", dir=tmp)
    spec = dict(spec, out=os.path.join(root, "result"))
    spec_path = os.path.join(root, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ)
    env.pop("GSTX_DIST_BACKEND", None)
    if backend:
        env["GSTX_DIST_BACKEND"] = backend
    launcher_log = os.path.join(root, "launcher.log")
    t0 = time.perf_counter()
    with open(launcher_log, "w") as out:
        # a session of its own, so that a timeout stops the ranks too
        p = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", str(world), "--master_addr", "127.0.0.1",
             "--master_port", str(free_port()), os.path.abspath(__file__),
             "--rank", spec_path], env=env, stdout=out,
            stderr=subprocess.STDOUT, cwd=HERE, start_new_session=True)
        try:
            code = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            code = "timeout"
        finally:
            if p.poll() is None:
                os.killpg(p.pid, 9)
            p.wait()
    wall = time.perf_counter() - t0
    if code != 0:
        for path in [launcher_log] + [os.path.join(root, f"rank{r}.log")
                                      for r in range(world)]:
            text = open(path).read() if os.path.exists(path) else ""
            log(f"[{tag}] {os.path.basename(path)}'s tail:\n"
                f"{text[-3000:]}")
        raise AssertionError(f"{tag}: the ranks' launch ended {code}")
    results = []
    for rank in range(world):
        with open(f"{spec['out']}.rank{rank}.json") as f:
            results.append(json.load(f))
    shutil.rmtree(root)
    return results, wall


@contextlib.contextmanager
def recording_scores(rank_gen, into):
    """Every batch's scores that the evaluators gather (rank 0's, or a
    single process's) appended to ``into`` as host arrays."""
    real = rank_gen.gather_scores

    def recording(*a, **kw):
        got = real(*a, **kw)
        if got is not None:
            into.append(got.numpy().copy())
        return got
    rank_gen.gather_scores = recording
    try:
        yield into
    finally:
        rank_gen.gather_scores = real


def dp_one_step(torch, counters, config, dev, kind, batch, dp,
                timed=False, keep=False):
    """One step of the ``kind`` trainer's step function (gstx_torch.train)
    from ``-start_path`` on the numpy ``batch``, across ``dp`` when given:
    its loss, per-tensor gradient norms, launch counts and wall time, the
    updated parameters (device copies) when ``keep``, and with ``timed`` a
    second (warm) step's wall time."""
    from gstx_torch.train import train_disc, train_gen

    remat = config.remat_policy if config.remat else None
    if kind == "gen":
        model, opt = train_gen.init_model_and_state(config, 100, dev)
        train_gen.load_start_checkpoint(config, model, opt)
        step = train_gen.make_train_step(model, opt, config.batch_size,
                                         config.batch_multiply, remat, dp)
    else:
        model, opt = train_gen.init_model_and_state(
            config, 100, dev, use_decoder=False,
            warmup_steps=train_disc.DISC_WARMUP_STEPS)
        train_disc.load_start_checkpoint(config, model, opt)
        step = train_disc.make_disc_train_step(model, opt, config, remat,
                                               dp)
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    out = step(batch, train_gen.iteration_generator(config.seed, 0))
    torch.cuda.synchronize()
    res = dict(first_s=time.perf_counter() - t0, counts=counters.read(),
               loss=float(out if kind == "gen" else out["loss"]),
               norms={n: float(p.grad.float().norm())
                      for n, p in model.named_parameters()
                      if p.grad is not None})
    if keep:
        res["params"] = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
    if timed:
        spent = dp.spent if dp is not None else {}
        spent.clear()
        t0 = time.perf_counter()
        step(batch, train_gen.iteration_generator(config.seed, 1))
        torch.cuda.synchronize()
        res["second_s"] = time.perf_counter() - t0
        res["second_parts_s"] = dict(spent)
    del model, opt, step
    torch.cuda.empty_cache()
    return res


def param_check(got, want):
    """(elements beyond ABS_TOL + REL_TOL * |want|, the worst
    |got - want| / limit) over every parameter."""
    over, worst = 0, 0.0
    for name, w in want.items():
        d = (got[name] - w).abs()
        lim = ABS_TOL + REL_TOL * w.abs()
        over += int((d > lim).sum())
        worst = max(worst, float((d / lim).max()))
    return over, worst


def rank_step(torch, counters, spec):
    """Phase 14 (b) on one rank.  For each run, on this rank's stripe of
    one fixed global batch, across the group: the bf16 step with the
    kernels (loss, gradient norms, launches, a warm step's time); the f32
    step, whose updated parameters rank 0 holds elementwise against the
    single-process step's; and the f32 control that skips the gradient
    all-reduce.  Rank 0 first takes the single-process steps on the whole
    batch.  The parameter check runs in f32 because AdamW's first update,
    m / (sqrt(v) + eps), is ill-conditioned where |g| is near eps /
    sqrt(1 - b2): there bf16's rounding of the gradient alone moves an
    entry past the limit (1e-5 of the entries in a CPU rehearsal at width
    128), which f32 rounding does not."""
    from gstx_torch.cli import common
    from gstx_torch.core import mesh
    from gstx_torch.data.loader import collate
    from gstx_torch.data.tokenizer import BertTokenizer
    from gstx_torch.data.visdial import VisdialDiscDataset, VisdialGenDataset
    from gstx_torch.models import encdec, heads

    # dropout-free: the model JSONs' rates are 0, and the fusion's and the
    # heads' fixed 0.1 off (their masks follow the rows' layout, which a
    # split batch changes)
    encdec.FUSION_DROPOUT = heads.POOLED_DROPOUT = 0.0

    class Timed(mesh.DataParallel):
        """The data axis, its batch gathering and gradient all-reduce
        timed (wall, the device synchronised around each) into
        ``spent``."""

        spent = {}

        def _timed(self, what, fn, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            self.spent[what] = self.spent.get(what, 0.0) + \
                time.perf_counter() - t0
            return out

        def gather_batch(self, batch):
            return self._timed("gather", super().gather_batch, batch)

        def all_reduce_grads_(self, params):
            return self._timed("all_reduce", super().all_reduce_grads_,
                               params)

    class NoReduce(mesh.DataParallel):
        """The control: the gradients stay each rank's own."""

        spent = {}

        def all_reduce_grads_(self, params):
            pass

    out = {}
    for run in spec["runs"]:
        kind = run["kind"]
        bf16 = common.parse_config(run["argv"])
        f32 = common.parse_config(run["argv"] + ["-dtype", "float32"])
        dev = common.default_device("cuda")
        common.apply_runtime_flags(bf16, dev)
        axis = mesh.make_layout(bf16.data_parallel, 1, dev).dp
        dp = Timed(axis.group, axis.rank, axis.size, axis.device)
        ctrl = NoReduce(dp.group, dp.rank, dp.size, dp.device)
        cls = VisdialGenDataset if kind == "gen" else VisdialDiscDataset
        ds = cls(bf16, BertTokenizer(vocab_path=bf16.vocab_path),
                 mode="vd_train")
        n = run["images"] // dp.size

        def batch(items):
            return collate([ds.__getitem__(i, seed=i) for i in items])
        res = {"backend": dp.backend, "device": str(dp.device)}
        if dp.rank == 0:
            whole = batch(range(run["images"]))
            ref16 = dp_one_step(torch, counters, bf16, dev, kind, whole,
                                None, timed=True)
            ref32 = dp_one_step(torch, counters, f32, dev, kind, whole,
                                None, keep=True)
            del whole
            res.update(ref_loss=ref16["loss"], ref_first_s=ref16["first_s"],
                       ref_second_s=ref16["second_s"],
                       ref_counts=ref16["counts"], ref32_loss=ref32["loss"])
        mesh.barrier()
        mine = batch(range(dp.rank * n, (dp.rank + 1) * n))
        got = dp_one_step(torch, counters, bf16, dev, kind, mine, dp,
                          timed=True)
        res.update(dp_loss=got["loss"], dp_counts=got["counts"],
                   dp_first_s=got["first_s"], dp_second_s=got["second_s"],
                   dp_second_parts_s=got["second_parts_s"])
        if dp.rank == 0:
            res["dp_norm_err"], res["dp_norm_worst"] = grad_norm_err(
                got["norms"], ref16["norms"])
        for name, axis in (("dp32", dp), ("control", ctrl)):
            got = dp_one_step(torch, counters, f32, dev, kind, mine, axis,
                              keep=dp.rank == 0)
            res[f"{name}_loss"] = got["loss"]
            if dp.rank == 0:
                err, worst_t = grad_norm_err(got["norms"], ref32["norms"])
                over, worst = param_check(got["params"], ref32["params"])
                res.update({f"{name}_norm_err": err,
                            f"{name}_norm_worst": worst_t,
                            f"{name}_params_over": over,
                            f"{name}_params_worst": worst,
                            f"{name}_params_differ": sum(
                                int((ref32["params"][k] != v).sum())
                                for k, v in got["params"].items()),
                            "params": sum(p.numel() for p in
                                          ref32["params"].values())})
            del got
        if dp.rank == 0:
            del ref16, ref32
        torch.cuda.empty_cache()
        out[kind] = res
    return out


def rank_cli(torch, counters, spec):
    """Phase 14 (a), (c), (d) on one rank: ``spec["cli"]``'s main on
    ``spec["argv"]`` with every launch counter set to 0 just before and
    read just after; the trainer's losses and step times, the run's
    stats, and the scores the evaluator gathers (rank 0)."""
    import importlib

    from gstx_torch.core import mesh
    from gstx_torch.eval import rank_gen

    cli = importlib.import_module(spec["cli"])
    stats, scores = {}, []
    kwargs = dict(device="cuda", stats_out=stats, **spec.get("kwargs", {}))
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    with recording_scores(rank_gen, scores):
        result = cli.main(spec["argv"], **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(counts=counters.read(), wall=wall,
               device=str(mesh.rank_device("cuda")),
               stats={k: v for k, v in stats.items()
                      if isinstance(v, (int, float, dict, list))
                      and k not in ("grad_norms", "saves")})
    if isinstance(result, dict):
        out["metrics"] = result
    elif isinstance(result, list):
        out["records"] = len(result)
    if scores:
        out["scores"] = [float(x) for a in scores for x in a]
    return out


def rank_pair(torch, counters, spec):
    """Phase 14's refusal check on one rank: under nccl, two ranks on the
    one card must raise in init_distributed, not fall back to gloo."""
    from gstx_torch.core import mesh

    try:
        backend = mesh.init_distributed(torch.device("cuda"))
    except RuntimeError as e:
        return {"raised": str(e)}
    return {"raised": None, "backend": backend}


def rank_main(spec_path):
    """A rank of phase 14 (``python3 chip_smoke.py --rank spec.json``): runs
    ``spec["task"]`` and writes its JSON result to ``spec["out"]``.rankN.
    json."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from gstx_torch.kernels import attention as kattn
    from gstx_torch.kernels import build
    from gstx_torch.kernels import decode_attn as kdecode
    from gstx_torch.kernels import ffn as kffn

    # this rank's output into its own log, beside the spec
    fd = os.open(os.path.join(os.path.dirname(spec_path),
                              f"rank{os.environ['RANK']}.log"),
                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    build.library()  # the parent's build, loaded
    result = RANK_TASKS[spec["task"]](torch, Counters(kffn, kattn, kdecode),
                                      spec)
    if dist.is_initialized():
        result.setdefault("backend", dist.get_backend())
        dist.destroy_process_group()
    with open(f"{spec['out']}.rank{os.environ['RANK']}.json", "w") as f:
        json.dump(result, f)
    return 0


def dp_nccl_part(torch, counters, card, tmp, train_flags):
    """Phase 14 (a): train_gen -distributed in a group of one over nccl
    against the same run without -distributed.  Returns its launch
    counts."""
    from gstx_torch.cli import train_gen
    from gstx_torch.kernels import ffn as kffn

    common, teacher = train_flags
    each = per_forward()
    argv = common + teacher + ["-use_pallas"]
    out_ref, out_a = (os.path.join(tmp, f"dp_a_{k}") for k in ("one", "nccl"))
    stats, _, _ = train_run(torch, counters, "phase 14a one process",
                            train_gen, argv + ["-save_path", out_ref], 1,
                            card)
    kffn.enable(True)
    (got,), wall = launch_ranks("phase 14a", {
        "task": "cli", "cli": "gstx_torch.cli.train_gen",
        "argv": argv + ["-distributed", "-save_path", out_a],
        "kwargs": {"max_steps": 3}}, tmp, world=1)
    shutil.rmtree(out_ref)
    shutil.rmtree(out_a)
    check_launches("phase 14a", got["counts"], dict(
        {k: 0 for k in SOURCES}, fused_ffn=each * 3,
        fused_dense_ln=each * 3))
    loss, want = got["stats"]["losses"]["loss"][0], \
        stats["losses"]["loss"][0]
    err = abs(loss - want) / abs(want)
    log(f"[phase 14a] train_gen -distributed, world size 1: backend "
        f"{got['backend']}; 3 steps, launches {got['counts']} "
        f"({each} / {each} a step); losses "
        f"{[round(x, 5) for x in got['stats']['losses']['loss']]}; first "
        f"step {loss:.6f} against {want:.6f} without -distributed "
        f"(relative {err:.3g}, limit {TRAIN_LOSS_TOL}); step seconds "
        f"{[round(x, 4) for x in got['stats']['step_seconds']]}; "
        f"{wall:.2f} s wall with the process's start; on {card}")
    if got["backend"] != "nccl" or err > TRAIN_LOSS_TOL:
        raise AssertionError("phase 14a: not nccl, or the loss disagrees")
    return got["counts"]


def dp_step_part(card, tmp, train_flags, disc_flags, world=DP_RANKS,
                 backend="gloo", tag="phase 14b"):
    """Phase 14 (b): ``world`` ranks (each on cuda:rank % cards) over
    ``backend`` (None: the device's, nccl), the generative and the
    discriminative trainers' step on one fixed global batch of TRAIN_BATCH
    dialogs (:func:`rank_step`), held against the single-process step
    rank 0 takes, with the no-all-reduce control."""
    common, teacher = train_flags
    disc_common, dense = disc_flags
    each = per_forward()
    lr = ["-lr", DP_LR, "-image_lr", DP_LR, "-min_lr", DP_LR,
          "-distributed"]
    runs = [{"kind": "gen", "images": TRAIN_BATCH,
             "argv": common + teacher + ["-use_pallas"] + lr},
            {"kind": "disc", "images": TRAIN_BATCH,
             "argv": disc_common + dense + ["-use_pallas"] + lr}]
    ranks, wall = launch_ranks(tag, {"task": "step", "runs": runs}, tmp,
                               world=world, backend=backend)
    for kind in ("gen", "disc"):
        r0 = ranks[0][kind]
        slowest = max(r[kind]["dp_second_s"] for r in ranks)
        loss_err = abs(r0["dp_loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
        log(f"[{tag} {kind}] {world} ranks over {r0['backend']} on "
            f"{[r[kind]['device'] for r in ranks]}, {TRAIN_BATCH} images "
            f"({TRAIN_BATCH // world} a rank), {TRAIN_BATCH} rows a step, "
            f"lr {DP_LR}, bf16 with the kernels: loss {r0['dp_loss']:.6f} "
            f"against one process's {r0['ref_loss']:.6f} (relative "
            f"{loss_err:.3g}, limit {TRAIN_LOSS_TOL}); gradient norms: "
            f"largest relative difference {r0['dp_norm_err']:.4g} at "
            f"{r0['dp_norm_worst']} (limit {TRAIN_GRAD_NORM_TOL})")
        log(f"[{tag} {kind}] f32: loss {r0['dp32_loss']:.7f} against "
            f"{r0['ref32_loss']:.7f}; norms {r0['dp32_norm_err']:.3g}; "
            f"parameters beyond {ABS_TOL} + {REL_TOL}|p|: "
            f"{r0['dp32_params_over']} of {r0['params']} (worst "
            f"{r0['dp32_params_worst']:.3g} of the limit; "
            f"{r0['dp32_params_differ']} differ at all); control without "
            f"the gradient all-reduce: loss {r0['control_loss']:.7f}, "
            f"norms {r0['control_norm_err']:.4g}, parameters beyond "
            f"{r0['control_params_over']} (worst "
            f"{r0['control_params_worst']:.3g}; "
            f"{r0['control_params_differ']} differ)")
        log(f"[{tag} {kind}] launches a step: "
            f"{[r[kind]['dp_counts'] for r in ranks]}, one process "
            f"{r0['ref_counts']}; warm (second) bf16 step: one process "
            f"{r0['ref_second_s'] * 1e3:.1f} ms "
            f"({TRAIN_BATCH / r0['ref_second_s']:.1f} examples/s), the "
            f"ranks {[round(r[kind]['dp_second_s'] * 1e3, 1) for r in ranks]}"
            f" ms ({TRAIN_BATCH / slowest:.1f} examples/s), of which "
            f"gathering the batch "
            f"{r0['dp_second_parts_s']['gather'] * 1e3:.1f} ms and the "
            f"gradient all-reduce "
            f"{r0['dp_second_parts_s']['all_reduce'] * 1e3:.1f} ms on rank "
            f"0; first steps {r0['ref_first_s'] * 1e3:.1f} / "
            f"{r0['dp_first_s'] * 1e3:.1f} ms; on {card}")
        for r in ranks:
            check_launches(f"{tag} {kind}", r[kind]["dp_counts"], dict(
                {k: 0 for k in SOURCES}, fused_ffn=each,
                fused_dense_ln=each))
        if not (loss_err <= TRAIN_LOSS_TOL
                and r0["dp_norm_err"] <= TRAIN_GRAD_NORM_TOL
                and r0["dp32_params_over"] == 0):
            raise AssertionError(f"{tag} {kind}: the step across the ranks "
                                 "disagrees with one process's")
        if r0["control_params_over"] == 0:
            raise AssertionError(f"{tag} {kind}: the control without the "
                                 "all-reduce passes: the check is blind")
    log(f"[{tag}] {wall:.2f} s wall")


def dp_generate_part(torch, counters, card, tmp, gen_argv, records6):
    """Phase 14 (c).  Returns each rank's launch counts."""
    from gstx_torch.cli import generate
    from gstx_torch.kernels import ffn as kffn
    from gstx_torch.data.cc12m import load_dialog_json

    each = per_forward() * 2 * ROUNDS
    zero = {k: 0 for k in SOURCES}
    out = os.path.join(tmp, "dp_gen")
    ranks, wall = launch_ranks("phase 14c", {
        "task": "cli", "cli": "gstx_torch.cli.generate",
        "argv": gen_argv + ["-save_path", out, "-distributed"]}, tmp,
        backend="gloo")
    counts = [r["counts"] for r in ranks]
    for rank, r in enumerate(ranks):
        images = len(range(rank, CLI_IMAGES, DP_RANKS))
        check_launches(f"phase 14c rank {rank}", r["counts"], dict(
            zero, fused_ffn=each * -(-images // CLI_BATCH),
            fused_dense_ln=each * -(-images // CLI_BATCH)))
    shards = sorted(os.listdir(out))
    ids = [d["image_id"] for d in
           load_dialog_json(os.path.join(out, "dialogs.json"))]
    want = sorted(r["image_id"] for r in records6)
    rates = [r["stats"]["images"] / r["stats"]["loop_seconds"]
             for r in ranks]
    log(f"[phase 14c] generate -distributed, 2 ranks over gloo on the one "
        f"card, phase 6's {CLI_IMAGES} images: shards {shards}; "
        f"{len(ids)} dialogs reassembled ({len(set(ids))} distinct; phase "
        f"6 wrote {len(want)}); rank img/s "
        f"{[round(x, 2) for x in rates]}, summed {sum(rates):.2f}; "
        f"{CLI_IMAGES} images over the slower rank's loop "
        f"{CLI_IMAGES / max(r['stats']['loop_seconds'] for r in ranks):.2f}"
        f" img/s; launches a rank {counts}; {wall:.2f} s wall with the "
        f"processes' start; on {card}")
    if shards != ["dialogs.proc0.json", "dialogs.proc1.json"] or \
            sorted(ids) != want:
        raise AssertionError("phase 14c: the shards do not reassemble "
                             "phase 6's images once each")
    shutil.rmtree(out)

    # f32 greedy: two ranks against one process, image for image, on
    # phase 6's first captions over a store of their images
    from gstx_torch.data.feature_store import make_synthetic_store

    caps = json.load(open(gen_argv[gen_argv.index("-cc12m_caption") + 1])
                     )[:DP_GREEDY_IMAGES]
    few, store = (os.path.join(tmp, n) for n in ("caps_few.json",
                                                  "few.store"))
    json.dump(caps, open(few, "w"))
    make_synthetic_store(store, [c["image_id"] for c in caps], num_boxes=36,
                         feat_dim=2048, num_classes=1601, seed=14)
    ckpt = unbiased_ckpt(torch, gen_argv[gen_argv.index("-start_path_q")
                                         + 1],
                         os.path.join(tmp, "dp_greedy.ckpt"))
    argv = gen_argv + ["-cc12m_caption", few, "-cc12m_image_feats", store,
                       "-start_path_q", ckpt,
                       "-start_path_a", ckpt, "-dtype", "float32",
                       "-top_k", "1", "-batch_size", "4",
                       "-num_dialog_rounds", "3", "-save_path",
                       os.path.join(tmp, "dp_greedy")]
    one = generate.main(argv + ["-save_name", "one.json"], device="cuda")
    kffn.enable(True)
    _, wall = launch_ranks("phase 14c f32", {
        "task": "cli", "cli": "gstx_torch.cli.generate",
        "argv": argv + ["-save_name", "two.json", "-distributed"]}, tmp,
        backend="gloo")
    two = load_dialog_json(os.path.join(tmp, "dp_greedy", "two.json"))
    by_id = {d["image_id"]: d["dialog"] for d in two}
    same = sum(by_id.get(d["image_id"]) is not None and all(
        a["question"] == b["question"] and a["answer"] == b["answer"]
        for a, b in zip(d["dialog"], by_id[d["image_id"]])) for d in one)
    words = sum(len(u[k].split()) for d in one for u in d["dialog"]
                for k in ("question", "answer"))
    log(f"[phase 14c f32] greedy, {len(one)} images, 3 rounds: {same} of "
        f"{len(one)} dialogs equal image for image ({len(two)} from the "
        f"ranks; {words} words in the one process's); first: "
        f"{one[0]['dialog'][0]}; {wall:.2f} s wall")
    if same != len(one) or len(two) != len(one):
        raise AssertionError("phase 14c: the ranks' greedy dialogs differ "
                             "from one process's")
    shutil.rmtree(os.path.join(tmp, "dp_greedy"))
    for path in (ckpt, few, store):
        os.remove(path)
    return counts


def dp_eval_part(torch, counters, card, tmp, eval_data, ckpts, scores7,
                 world=DP_RANKS, backend="gloo", tag="phase 14d"):
    """Phase 14 (d): ``evaluate_gen -distributed`` on ``world`` ranks (each
    on cuda:rank % cards) over ``backend`` (None: the device's, nccl),
    rank 0's gathered scores against the single-process ``scores7``.
    Returns each rank's launch counts."""
    import numpy as np

    out = os.path.join(tmp, "dp_eval")
    n_val = EVAL_IMAGES * ROUNDS * EVAL_OPTIONS
    each = per_forward() * (n_val // GEN_CHUNK)
    ranks, wall = launch_ranks(tag, {
        "task": "cli", "cli": "gstx_torch.cli.evaluate_gen",
        "kwargs": {"chunk_size": GEN_CHUNK},
        "argv": eval_data + ["-start_path", ckpts["full"], "-use_pallas",
                             "-mode", "vd_eval_val", "-save_path", out,
                             "-distributed"]}, tmp, world=world,
        backend=backend)
    r0, rest = ranks[0], ranks[1:]
    for rank, r in enumerate(ranks):
        check_launches(f"{tag} rank {rank}", r["counts"], dict(
            {k: 0 for k in SOURCES}, fused_ffn=each, fused_dense_ln=each))
    got = torch.tensor(r0["scores"]).reshape(EVAL_IMAGES * ROUNDS,
                                             EVAL_OPTIONS)
    want = torch.from_numpy(np.concatenate(scores7)).reshape(got.shape)
    err = max(centred_err(torch, g, w) for g, w in zip(got, want))
    files = sorted(os.listdir(out))
    loop = r0["stats"]["loop_seconds"]
    log(f"[{tag}] evaluate_gen -distributed, {world} ranks over "
        f"{r0['backend']} on {[r['device'] for r in ranks]}, phase 7's val "
        f"set ({n_val} sequences, chunks of {GEN_CHUNK}, "
        f"{-(-GEN_CHUNK // world)} rows a rank): rank 0's gathered scores "
        f"against one process's, centred per round: largest relative error "
        f"{err:.4g} (limit {EVAL_SCORE_TOL['gen']}); metrics "
        f"{json.dumps(r0.get('metrics'))}; the other ranks returned "
        f"{[r.get('metrics') for r in rest]}; files {files}; rank 0's batch "
        f"loop {loop:.2f} s = {n_val / loop:.1f} scored sequences/s; "
        f"launches {[r['counts'] for r in ranks]}; {wall:.2f} s wall; on "
        f"{card}")
    if err > EVAL_SCORE_TOL["gen"] or files != ["performance_log.txt"] or \
            any("metrics" in r or "scores" in r for r in rest):
        raise AssertionError(f"{tag}: the evaluation across the ranks "
                             "differs from one process's")
    check_metrics(tag, r0["metrics"], EVAL_OPTIONS)
    shutil.rmtree(out)
    return [r["counts"] for r in ranks]


def dp_pair_check(tmp, card):
    """Phase 14 (e): two ranks on the one card under nccl must raise."""
    ranks, wall = launch_ranks("phase 14e", {"task": "pair"}, tmp)
    log(f"[phase 14e] 2 ranks on the one card under nccl: "
        f"{[r['raised'] for r in ranks]} ({wall:.2f} s)")
    if not all(r["raised"] and "all run on" in r["raised"] for r in ranks):
        raise AssertionError("phase 14e: nccl took two ranks on one card")


def dp_phase(torch, counters, card, tmp, gen_argv, records6, eval_data,
             scores7, ckpts, train_flags, disc_flags):
    """Phase 14: the port's multi-process paths at full width on the one
    card.  Returns the launch counts by path."""
    torch.cuda.empty_cache()
    log(f"[phase 14] card: {card}")
    t0 = time.perf_counter()
    counts = {"dp_train_nccl": dp_nccl_part(torch, counters, card, tmp,
                                            train_flags)}
    dp_step_part(card, tmp, train_flags, disc_flags)
    t1 = time.perf_counter()
    counts["dp_generate"] = dp_generate_part(torch, counters, card, tmp,
                                             gen_argv, records6)
    t2 = time.perf_counter()
    counts["dp_eval"] = dp_eval_part(torch, counters, card, tmp, eval_data,
                                     ckpts, scores7)
    t3 = time.perf_counter()
    dp_pair_check(tmp, card)
    log(f"[phase 14] (a)+(b) {t1 - t0:.1f} s, (c) {t2 - t1:.1f} s, (d) "
        f"{t3 - t2:.1f} s, (e) {time.perf_counter() - t3:.1f} s; on {card}")
    return counts


# ---------------------------------------------------------------------- #
# phase 15: tensor parallelism across processes
# ---------------------------------------------------------------------- #


TP_DEGREE = 2
TP_IMAGES = 8          # (b), and (c) on one card: the engine's batch
TP_ROUNDS = 2
TP_INT8_ROUNDS = 1     # (c): gloo's per-collective latency paces it
TP_STEPS = 18
# (d) on one card: rows a step, drawn from as many dialogs; under gloo
# every activation all-reduce is staged through host memory, so the step
# is a small one, timed cold
TP_TRAIN_BATCH = 8
# --tp-cards (nccl): (c) at the engine's batch (bench.py's 96 images) and
# (d) at the trainers' (72 rows), each step timed again warm
TP_CARDS_IMAGES = 96
TP_CARDS_TRAIN_BATCH = 72
# (a): f32 logits over the model group against one process's, max |d| /
# max |one process|, TF32 off; (b): an argmax within this many logits
TP_LOGIT_TOL = 1e-4
TP_ARGMAX_TOL = 1e-4
# (a), (c) in bf16: the group's relative error to the f32 logits over one
# process's.  Elementwise, two bf16 models that round in another order
# differ by as much as each differs from f32 (~1.4% of the largest logit
# at random weights on an H100; ratios 1.034 and, over the int8 memory,
# 1.088 there); a group that lost a reduction lands ~100x one process's
# error (the control)
TP_BF16_RATIO = 1.25
# (a) in bf16, the rounding of one row-parallel product (the first one of
# the model, on TP_ROUNDING_ROWS seeded rows): the share of its outputs
# that differ from the f32 product rounded once to bf16.  Partials summed
# in f32 and rounded once differ only where the order of the f32 sum
# moves a value across a rounding boundary; a group that rounds each
# rank's partial to bf16 before the sum (the control) rounds twice
TP_ROUNDING_ROWS = 8192
TP_ROUNDING_SHARE = 0.05
# (e): phase 7's first dialog, the first options of each round (gloo's
# host transport paces the scoring: ~17 sequences/s on one H100)
TP_EVAL_OPTIONS = 20
# (g): JAX's validate_model_parallel on the production configs at degree 3
JAX_MP3_MESSAGE = ("model_parallel=3 does not divide v_num_attention_heads"
                   "=8; pick a degree dividing every head count and "
                   "intermediate size")


def tp_peak(torch):
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


@contextlib.contextmanager
def clocked_collectives(torch, clock):
    """The model group's collectives (``ModelGroup.all_reduce`` /
    ``all_gather`` / ``broadcast``) wrapped for the run inside: the device
    synchronised before and after each one, its wall time added to
    ``clock["seconds"]`` and one to ``clock["calls"]``.  The syncs stall
    the stream, so the share read this way is that of a run with a sync
    around each collective, not of the unclocked run."""
    from gstx_torch.core.mesh import ModelGroup

    names = ("all_reduce", "all_gather", "broadcast")
    real = {n: getattr(ModelGroup, n) for n in names}

    def timed(fn):
        def run(self, *a, **kw):
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            torch.cuda.synchronize(self.device)
            clock["seconds"] += time.perf_counter() - t0
            clock["calls"] += 1
            return out
        return run
    clock.update(seconds=0.0, calls=0)
    for n in names:
        setattr(ModelGroup, n, timed(real[n]))
    try:
        yield clock
    finally:
        for n in names:
            setattr(ModelGroup, n, real[n])


def tp_logit_batch(torch, np, enc_cfg, dev):
    """(a)'s fixed batch: 4 caption contexts of 256 and 20 decoder
    tokens."""
    b = make_batch(np, enc_cfg, 4, 256, 37)
    rng = np.random.RandomState(15)
    t = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    dec = torch.from_numpy(rng.randint(1000, 20000, (4, 20))).to(dev)
    return (t["enc_input_ids"], t["enc_image_feat"], t["enc_image_loc"],
            t["enc_segments"], (t["enc_input_ids"] != 0).long(),
            t["enc_image_mask"].long(), dec, torch.ones_like(dec))


def tp_models(config, dev, tp, primary):
    """The model group's shard of ``config``'s -start_path (every rank)
    and one process's whole model (``primary`` only)."""
    from gstx_torch.cli import common

    def build(group):
        return common.load_params(common.build_model(config, device=dev,
                                                     tp=group),
                                  config.start_path)
    return build(tp), (build(None) if primary else None)


def tp_logits_part(torch, np, dev, primary, models, res, ref):
    """(a): teacher-forced logits, f32 then bf16, against one process's;
    the control whose row-parallel products skip their all-reduce."""
    from gstx_torch.models import tensor_parallel as tpar

    model, one = models
    args = tp_logit_batch(torch, np, model.enc_config, dev)
    with torch.no_grad():
        got = model.full_logits(model.score(*args))
        real = tpar.RowParallelLinear.forward
        tpar.RowParallelLinear.forward = lambda self, x: \
            torch.nn.functional.linear(x, self.weight, self.bias)
        try:
            ctrl = model.full_logits(model.score(*args))
        finally:
            tpar.RowParallelLinear.forward = real
        if primary:
            want = one.score(*args)
            scale = float(want.abs().max())
            res["a_f32"] = float((got - want).abs().max()) / scale
            res["a_control"] = float((ctrl - want).abs().max()) / scale
            ref["f32"] = want
        del got, ctrl


def tp_bf16_logits(torch, np, dev, primary, models, res, ref):
    """(a) in bf16 and (c)'s int8 memory: the precast models' logits on
    (a)'s batch, each model's relative error to the f32 one process's
    logits (the group's within TP_BF16_RATIO of one process's), beside the
    elementwise comparison with one process's at ABS_TOL + REL_TOL |p|;
    over the int8 memory (teacher-forced through decode_logits_cached)
    also max |d| / max |f32| against INT8_LOGIT_TOL."""
    from gstx_torch.models import decoder as tdecoder

    model, one = models
    args = tp_logit_batch(torch, np, model.enc_config, dev)

    def int8_logits(m):
        mem, mask = m.decode_prepare(*args[:6])
        mem = tdecoder.quantize_memory_kv(mem, mask, m.dtype)
        return m.full_logits(m.decode_logits_cached(args[6], args[7], mem,
                                                    mask))
    with torch.no_grad():
        with rounded_partials(torch):
            twice = model.full_logits(model.score(*args))
        if primary:
            res["a_twice_vs_f32"] = rel_err(twice, ref["f32"])
        del twice
        for tag, fn in (("a", lambda m: m.full_logits(m.score(*args))),
                        ("c", int8_logits)):
            got = fn(model)
            if not primary:
                continue
            want = fn(one)
            lim = ABS_TOL + REL_TOL * want.abs()
            d = (got - want).abs()
            res[f"{tag}_bf16_over"] = int((d > lim).sum())
            res[f"{tag}_bf16_worst"] = float((d / lim).max())
            res[f"{tag}_group_vs_f32"] = rel_err(got, ref["f32"])
            res[f"{tag}_one_vs_f32"] = rel_err(want, ref["f32"])
            res[f"{tag}_group_max_vs_f32"] = float(
                (got - ref["f32"]).abs().max() / ref["f32"].abs().max())


@contextlib.contextmanager
def rounded_partials(torch):
    """The control of the bf16 checks: every row-parallel product rounds
    its rank's partial to the input's dtype before the all-reduce, the
    double rounding that summing the partials in f32 avoids."""
    from gstx_torch.models import tensor_parallel as tpar

    real = tpar._partial_product
    tpar._partial_product = lambda x, w: real(x, w).to(x.dtype).float()
    try:
        yield
    finally:
        tpar._partial_product = real


def tp_rounding_part(torch, dev, primary, models, res):
    """(a) in bf16, one row-parallel product alone: the model's first
    :class:`RowParallelLinear` on TP_ROUNDING_ROWS seeded bf16 rows (the
    rank's slice of their features), and the same product under
    :func:`rounded_partials`; each output's share of elements that differ
    from the f32 product of the whole weight rounded once to bf16, beside
    one process's bf16 ``nn.Linear`` on the whole rows."""
    from gstx_torch.models import tensor_parallel as tpar

    model, one = models
    name, mod = next((n, m) for n, m in model.named_modules()
                     if isinstance(m, tpar.RowParallelLinear))
    per = mod.weight.shape[1]
    x = torch.randn(TP_ROUNDING_ROWS, per * mod.tp.size, device=dev,
                    generator=torch.Generator(dev).manual_seed(15)
                    ).to(torch.bfloat16)
    mine = x[:, mod.tp.rank * per:(mod.tp.rank + 1) * per]
    with torch.no_grad():
        got = mod(mine)
        with rounded_partials(torch):
            twice = mod(mine)
        if not primary:
            return
        full = dict(one.named_modules())[name]
        once = (x.float() @ full.weight.float().t()
                + full.bias.float()).to(torch.bfloat16)
        res["a_rounding"] = dict(
            layer=name, shape=[TP_ROUNDING_ROWS, per * mod.tp.size,
                               mod.weight.shape[0]],
            group=float((got != once).float().mean()),
            control=float((twice != once).float().mean()),
            one=float((full(x) != once).float().mean()))


def tp_argmax_check(torch, one, out, batch, dev):
    """(b)'s fallback when the tokens differ: every token the model group
    chose is within TP_ARGMAX_TOL of the largest of one process's
    teacher-forced logits, each utterance scored in the context the
    model group built (up to its first EOS).  Returns (tokens checked,
    the worst gap)."""
    from gstx_torch.core.config import CLS_ID, PAD_ID, SEP_ID
    from gstx_torch.decode.dialog_engine import DialogState, append_utterance

    ids = torch.from_numpy(batch["enc_input_ids"]).to(dev).clone()
    state = DialogState(ids, torch.from_numpy(batch["enc_segments"]).to(
        dev).clone(), (ids != PAD_ID).sum(-1), torch.zeros(
        ids.shape[0], dtype=torch.bool, device=dev))
    image = [torch.from_numpy(batch[k]).to(dev) for k in
             ("enc_image_feat", "enc_image_loc", "enc_image_mask")]
    checked, worst = 0, 0.0
    for r in range(out.questions.shape[0]):
        for kind in ("q", "a"):
            utt = (out.questions if kind == "q" else out.answers)[r]
            att = (state.enc_input_ids != PAD_ID).long()
            mem, mask = one.decode_prepare(state.enc_input_ids, image[0],
                                           image[1], state.enc_segments,
                                           att, image[2])
            inp = torch.cat([torch.full_like(utt[:, :1], CLS_ID),
                             utt[:, :-1]], 1)
            inp = torch.where(inp == SEP_ID, PAD_ID, inp)
            logits = one.decode_logits_cached(inp, torch.ones_like(inp), mem,
                                              mask)
            chosen = logits.gather(-1, utt[..., None])[..., 0]
            gap = logits.max(-1).values - chosen
            live = (torch.cumsum((utt == SEP_ID).long(), 1)
                    - (utt == SEP_ID).long()) == 0
            live &= utt != PAD_ID
            checked += int(live.sum())
            worst = max(worst, float(torch.where(live, gap, 0.0).max()))
            if kind == "q":
                state, _ = append_utterance(state, utt, (utt != PAD_ID).sum(
                    -1), segment=0, write_segments=False)
            else:
                wo = torch.where(utt == SEP_ID, PAD_ID, utt)
                state, _ = append_utterance(state, wo, (wo != PAD_ID).sum(-1),
                                            segment=1, write_segments=True)
    return checked, worst


def tp_engine_part(torch, np, dev, primary, models, res):
    """(b): greedy f32 dialogs over the model group against one
    process's."""
    from gstx_torch.decode.dialog_engine import make_dialog_engine
    from gstx_torch.decode.sampler import DecodeSettings

    model, one = models
    batch = make_batch(np, model.enc_config, TP_IMAGES, 256, 37)
    greedy = DecodeSettings(max_steps=TP_STEPS, top_k=1,
                            ngram_blocking_size=0)
    run = make_dialog_engine(num_rounds=TP_ROUNDS, q_settings=greedy,
                             a_settings=greedy, dtype=torch.float32,
                             device=dev)
    with torch.no_grad():
        if primary:
            want = run(one, one, batch, torch.Generator(dev).manual_seed(0))
        got = run(model, model, batch, torch.Generator(dev).manual_seed(0))
        if not primary:
            return
        pairs = [(g, w) for g, w in ((got.questions, want.questions),
                                     (got.answers, want.answers))]
        same = sum(int((g == w).all(-1).sum()) for g, w in pairs)
        total = sum(g.shape[0] * g.shape[1] for g, _ in pairs)
        first = None
        for r in range(TP_ROUNDS):
            for name, g, w in (("question", got.questions[r],
                                want.questions[r]),
                               ("answer", got.answers[r], want.answers[r])):
                bad = (g != w).any(-1).nonzero()
                if first is None and len(bad):
                    i = int(bad[0])
                    first = dict(round=r, utterance=name, row=i,
                                 group=g[i].tolist(), one=w[i].tolist())
        res["b_same"], res["b_total"], res["b_first"] = same, total, first
        res["b_tokens"] = int(sum(int((g != 0).sum()) for g, _ in pairs))
        if first is not None:
            res["b_checked"], res["b_worst"] = tp_argmax_check(
                torch, one, got, batch, dev)


def tp_int8_part(torch, np, counters, kattn, kdecode, dev, tp, primary,
                 models, res, images):
    """(c): the bf16 engine over the int8 memory with the decode and the
    attention kernels on, one round of ``images`` images: launches
    against the decode steps, tok/s, the collectives' share of the wall
    time (a second run under :func:`clocked_collectives`), peak memory,
    and one process's tok/s.  (The teacher-forced logits over the int8
    memory are :func:`tp_bf16_logits`'.)"""
    from gstx_torch.decode.dialog_engine import make_dialog_engine
    from gstx_torch.decode.sampler import DecodeSettings
    from gstx_torch.models.encdec import GSTVisualDialog

    model, one = models
    batch = make_batch(np, model.enc_config, images, 256, 37)
    run = make_dialog_engine(
        num_rounds=TP_INT8_ROUNDS,
        q_settings=DecodeSettings(max_steps=TP_STEPS, ngram_blocking_size=4,
                                  fused_sampler=True),
        a_settings=DecodeSettings(max_steps=TP_STEPS, ngram_blocking_size=0,
                                  fused_sampler=True),
        dtype=torch.bfloat16, quantize_memory=True, device=dev)
    steps = [0]
    real_step = GSTVisualDialog.decode_step

    def counted(self, *a, **kw):
        steps[0] += 1
        return real_step(self, *a, **kw)
    kdecode.enable_kernel()
    kattn.enable()
    GSTVisualDialog.decode_step = counted
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counters.reset()
            t0 = time.perf_counter()
            out = run(model, model, batch,
                      torch.Generator(dev).manual_seed(2))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = counters.read()
            res["c_counts"], res["c_steps"] = counts, steps[0]
            res["c_layers"] = len(model.dec.layers)
            # fused_attention: every encoder attention of both encoder
            # passes a round, and the answer scoring's decoder
            # self-attentions (the int8 cross-attention has its own path)
            enc = model.enc_config
            res["c_attention_per_round"] = 2 * (
                enc.num_hidden_layers + enc.v_num_hidden_layers
                + 2 * len(enc.v_biattention_id)) + len(model.dec.layers)
            res["c_wall"] = wall
            res["c_tokens"] = int((out.questions != 0).sum()
                                  + (out.answers != 0).sum())
            res["c_peak_gib"] = tp_peak(torch)
            if tp is not None:
                clock = {}
                with clocked_collectives(torch, clock):
                    t0 = time.perf_counter()
                    run(model, model, batch,
                        torch.Generator(dev).manual_seed(2))
                    torch.cuda.synchronize()
                res["c_clocked_wall"] = time.perf_counter() - t0
                res["c_collective_s"] = clock["seconds"]
                res["c_collectives"] = clock["calls"]
            if primary:
                counters.reset()
                t0 = time.perf_counter()
                ref = run(one, one, batch, torch.Generator(dev).manual_seed(2))
                torch.cuda.synchronize()
                res["c_one_wall"] = time.perf_counter() - t0
                res["c_one_tokens"] = int((ref.questions != 0).sum()
                                          + (ref.answers != 0).sum())
    finally:
        GSTVisualDialog.decode_step = real_step
        kdecode.enable_kernel(False)
        kattn.enable(False)


def tp_step(torch, config, dev, kind, batch, axes, gather=True,
            warm=False):
    """One step of the ``kind`` trainer over ``axes`` (None: one process)
    from -start_path: (loss, the updated parameters on the device, the
    step's wall seconds, the step's peak GiB, a dict of the build's peak
    GiB (the model built and loaded, before any step), the build and
    gather seconds and, with ``warm``, a second step's wall seconds and
    peak GiB).  The parameters are the full ones after the first step,
    gathered over the model group, or with ``gather=False`` this rank's
    shards."""
    from gstx_torch.train import train_disc, train_gen

    tp = None if axes is None else axes.tp
    dp = None if axes is None else axes.dp
    # the trainers' recomputation (-remat_policy small): a recomputed
    # region runs its forward all-reduces again inside the backward
    remat = config.remat_policy if config.remat else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    if kind == "gen":
        model, opt = train_gen.init_model_and_state(config, 100, dev, tp=tp)
        train_gen.load_start_checkpoint(config, model, opt)
        step = train_gen.make_train_step(model, opt, config.batch_size,
                                         remat=remat, dp=dp)
    else:
        model, opt = train_gen.init_model_and_state(
            config, 100, dev, use_decoder=False,
            warmup_steps=train_disc.DISC_WARMUP_STEPS, tp=tp)
        train_disc.load_start_checkpoint(config, model, opt)
        step = train_disc.make_disc_train_step(model, opt, config, remat,
                                               dp)
    parts = dict(build_peak_gib=tp_peak(torch))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = step(batch, train_gen.iteration_generator(config.seed, 0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = tp_peak(torch)
    loss = float(out if kind == "gen" else out["loss"])
    t1 = time.perf_counter()
    own = model.tp is None or not gather
    # copies: a warm step updates the parameters in place
    params = {k: v.detach().to(dev, torch.float32, copy=True)
              for k, v in (model.state_dict() if own
                           else model.full_state_dict()).items()}
    parts.update(build_s=t0 - t_build, gather_s=time.perf_counter() - t1)
    if warm:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(batch, train_gen.iteration_generator(config.seed, 1))
        torch.cuda.synchronize()
        parts.update(warm_s=time.perf_counter() - t0,
                     warm_peak_gib=tp_peak(torch))
    del model, opt, step
    torch.cuda.empty_cache()
    return loss, params, wall, peak, parts


def tp_train_part(torch, spec, dev, axes, primary, res):
    """(d): each trainer's f32 step over the layout against one process's
    (dropout-free: the model JSONs' rates 0 and the fusion's and the
    heads' fixed 0.1 off), then the generative one with the reference
    dropout, and the control whose copy-to-model backward skips its
    all-reduce."""
    from gstx_torch.cli import common
    from gstx_torch.core import mesh
    from gstx_torch.data.loader import collate
    from gstx_torch.data.tokenizer import BertTokenizer
    from gstx_torch.data.visdial import VisdialDiscDataset, VisdialGenDataset
    from gstx_torch.models import encdec, heads
    from gstx_torch.models import tensor_parallel as tpar

    fixed = encdec.FUSION_DROPOUT, heads.POOLED_DROPOUT
    rows, warm = spec["train_batch"], spec["warm"]
    for run in spec["train_runs"]:
        kind, tag = run["kind"], run["tag"]
        config = common.parse_config(run["argv"] + ["-dtype", "float32"])
        cls = VisdialGenDataset if kind == "gen" else VisdialDiscDataset
        ds = cls(config, BertTokenizer(vocab_path=config.vocab_path),
                 mode="vd_train")
        n = rows // axes.data_size
        d = axes.data_rank

        def batch(items):
            return collate([ds.__getitem__(i, seed=i) for i in items])
        dropout = run.get("dropout", False)
        encdec.FUSION_DROPOUT, heads.POOLED_DROPOUT = \
            fixed if dropout else (0.0, 0.0)
        try:
            if primary:
                ref = tp_step(torch, config, dev, kind, batch(range(rows)),
                              None, warm=warm)
            got = tp_step(torch, config, dev, kind,
                          batch(range(d * n, (d + 1) * n)), axes, warm=warm)
            if run.get("control"):
                # past the limit on rank 0's own shards already: no gather
                real = tpar._CopyToModel.backward
                tpar._CopyToModel.backward = staticmethod(
                    lambda ctx, grad: (grad, None))
                try:
                    ctrl = tp_step(torch, config, dev, kind,
                                   batch(range(d * n, (d + 1) * n)), axes,
                                   gather=False)
                finally:
                    tpar._CopyToModel.backward = real
        finally:
            encdec.FUSION_DROPOUT, heads.POOLED_DROPOUT = fixed
        out = dict(loss=got[0], step_s=got[2], peak_gib=got[3],
                   parts=got[4])
        if primary:
            over, worst = param_check(got[1], ref[1])
            out.update(ref_loss=ref[0], ref_step_s=ref[2],
                       ref_peak_gib=ref[3], ref_parts=ref[4], over=over,
                       worst=worst,
                       params=sum(v.numel() for v in ref[1].values()))
            if run.get("control"):
                out["control_over"], out["control_worst"] = param_check(
                    ctrl[1], mesh.shard_state_dict(ref[1], axes.tp.size,
                                                   axes.tp.rank))
            del ref
        del got
        res[f"d_{tag}"] = out


def tp_demo_part(spec, res, primary):
    """(f): two scripted greedy f32 turns of the demo over the model
    group, and the same in one process (rank 0; the others idle)."""
    from gstx_torch.cli import inference

    for tag, extra in (("one", []), ("group", ["-distributed",
                                               "-model_parallel",
                                               str(TP_DEGREE)])):
        lines = []
        asked = iter(DEMO_TURNS[:2])
        inference.main(spec["demo_argv"] + extra,
                       input_fn=lambda prompt: next(asked),
                       output_fn=lines.append, max_turns=2, device="cuda")
        if primary:
            res[f"f_{tag}"] = lines


def rank_tp(torch, counters, spec):
    """Phase 15 on one rank: the ``spec["dp"] x spec["mp"]`` layout over
    the launched group; (a)-(c) on the -start_path of ``spec["argv"]``,
    (d) on ``spec["train_runs"]``, (f) when ``spec["demo_argv"]`` is
    given, then (e) on ``spec["eval_argv"]``.  The global rank 0 also
    computes each one-process reference."""
    import numpy as np

    from gstx_torch.cli import common
    from gstx_torch.core import mesh
    from gstx_torch.kernels import attention as kattn
    from gstx_torch.kernels import decode_attn as kdecode
    from gstx_torch.models.encdec import precast_

    config = common.parse_config(spec["argv"])
    dev = common.default_device("cuda")
    common.apply_runtime_flags(config.replace(distributed=True), dev)
    axes = mesh.make_groups(spec["dp"], spec["mp"], dev)
    primary = mesh.process_index() == 0
    res = {"device": str(dev), "data_rank": axes.data_rank,
           "model_rank": axes.model_rank}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    models = tp_models(config.replace(dtype="float32"), dev, axes.tp,
                       primary)
    # every rank builds the whole model and loads the whole file before it
    # keeps its shard (rank 0 also holds one process's model)
    res["build_peak_gib"] = tp_peak(torch)
    ref = {}
    tp_logits_part(torch, np, dev, primary, models, res, ref)
    tp_engine_part(torch, np, dev, primary, models, res)
    for m in models:
        if m is not None:
            precast_(m)
    tp_rounding_part(torch, dev, primary, models, res)
    tp_bf16_logits(torch, np, dev, primary, models, res, ref)
    ref.clear()
    tp_int8_part(torch, np, counters, kattn, kdecode, dev, axes.tp, primary,
                 models, res, spec["images"])
    del models
    torch.cuda.empty_cache()
    res["abc_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp_train_part(torch, spec, dev, axes, primary, res)
    res["d_s"] = time.perf_counter() - t0
    if spec.get("demo_argv"):
        t0 = time.perf_counter()
        tp_demo_part(spec, res, primary)
        res["f_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp_eval_rank(torch, counters, spec, primary, res)
    res["e_s"] = time.perf_counter() - t0
    return res


def tp_eval_inputs(tmp):
    """(e)'s val set: the first dialog of phase 7's, scored at
    TP_EVAL_OPTIONS options a round.  The dataset takes a round's ground
    truth and then the other options in order, as many as -num_options
    asks, and a sequence's score depends on its context and its option
    alone: its scores are phase 7's first TP_EVAL_OPTIONS of each round
    of that dialog.  Beside phase 7's files."""
    flags = eval_flags(tmp)
    val = json.load(open(os.path.join(tmp, "val.json")))
    val["data"]["dialogs"] = val["data"]["dialogs"][:1]
    path = os.path.join(tmp, "val_one.json")
    json.dump(val, open(path, "w"))
    out = list(flags)
    out[out.index("-visdial_processed_val") + 1] = path
    out[out.index("-num_options") + 1] = str(TP_EVAL_OPTIONS)
    return out


def tp_report(tag, card, ranks, spec):
    """Log and check phase 15's (a)-(d) and (f) from the ranks' results;
    returns each rank's (c) launch counts."""
    r0 = ranks[0]
    each = ", ".join(f"rank {i} on {r['device']} (data {r['data_rank']}, "
                     f"model {r['model_rank']})" for i, r in enumerate(ranks))
    log(f"[{tag}] {spec['dp']} x {spec['mp']} (data x model): {each}; on "
        f"{card}")
    log(f"[{tag} a] teacher-forced logits, 4 x 256 contexts, 20 tokens: f32 "
        f"max |group - one| / max |one| {r0['a_f32']:.3g} (limit "
        f"{TP_LOGIT_TOL}); control without the row-parallel all-reduce "
        f"{r0['a_control']:.3g}")
    ok = r0["a_f32"] <= TP_LOGIT_TOL
    rnd = r0["a_rounding"]
    log(f"[{tag} a] bf16 rounding of one row-parallel product "
        f"({rnd['layer']}, {' x '.join(map(str, rnd['shape']))}): share "
        f"of outputs that differ from the f32 product rounded once: the "
        f"group's {rnd['group']:.4g} (limit {TP_ROUNDING_SHARE}), one "
        f"process's nn.Linear {rnd['one']:.4g}; control with each rank's "
        f"partial rounded to bf16 before the all-reduce {rnd['control']:.4g}")
    ok &= rnd["group"] <= TP_ROUNDING_SHARE
    if rnd["control"] <= TP_ROUNDING_SHARE:
        raise AssertionError(f"{tag} a: the rounding control passes: blind "
                             "check")
    log(f"[{tag} a] the same control on the bf16 logits (a reading, no "
        f"limit): relative error to one process's f32 "
        f"{r0['a_twice_vs_f32']:.4g}, ratio "
        f"{r0['a_twice_vs_f32'] / r0['a_one_vs_f32']:.4f} to one process's")
    for part, what in (("a", "bf16"), ("c", "bf16 over the int8 memory")):
        ratio = r0[f"{part}_group_vs_f32"] / r0[f"{part}_one_vs_f32"]
        log(f"[{tag} {part}] {what}, relative error to one process's f32 "
            f"logits: the group's {r0[f'{part}_group_vs_f32']:.4g}, one "
            f"process's {r0[f'{part}_one_vs_f32']:.4g} (ratio {ratio:.4f}, "
            f"limit {TP_BF16_RATIO}); the group's max |d| / max |f32| "
            f"{r0[f'{part}_group_max_vs_f32']:.4g}; elementwise against one "
            f"process's: {r0[f'{part}_bf16_over']} beyond {ABS_TOL} + "
            f"{REL_TOL}|p| (worst {r0[f'{part}_bf16_worst']:.3g} of it)")
        ok &= ratio <= TP_BF16_RATIO
    ok &= r0["c_group_max_vs_f32"] <= INT8_LOGIT_TOL
    if r0["a_control"] <= TP_LOGIT_TOL:
        raise AssertionError(f"{tag} a: the control passes: blind check")
    if "b_same" in r0:
        msg = (f"[{tag} b] greedy f32, {TP_IMAGES} images x {TP_ROUNDS} "
               f"rounds, {TP_STEPS} steps: {r0['b_same']} of "
               f"{r0['b_total']} utterances identical to one process's "
               f"({r0['b_tokens']} tokens); first divergence "
               f"{json.dumps(r0['b_first'])}")
        if r0["b_first"] is not None:
            msg += (f"; the group's {r0['b_checked']} tokens against one "
                    f"process's teacher-forced logits: largest gap to the "
                    f"argmax {r0['b_worst']:.3g} (limit {TP_ARGMAX_TOL})")
            ok &= r0["b_worst"] <= TP_ARGMAX_TOL
        log(msg)
    layers = r0["c_layers"]
    held = ", with one process's model"
    for i, r in enumerate(ranks):
        want_q = layers * r["c_steps"]
        rate = r["c_tokens"] / r["c_wall"]
        share = r.get("c_collective_s", 0.0) / r.get("c_clocked_wall", 1.0)
        log(f"[{tag} c] rank {i}: int8 memory, decode and attention "
            f"kernels on, bf16, {spec['images']} images x "
            f"{TP_INT8_ROUNDS} round: "
            f"launches {r['c_counts']} over {r['c_steps']} decode steps "
            f"({layers} layers: quant_decode_attention {want_q} implied); "
            f"{r['c_tokens']} tokens in {r['c_wall']:.3f} s = {rate:.1f} "
            f"tok/s; collectives {r.get('c_collectives', 0)} calls, "
            f"{r.get('c_collective_s', 0.0):.3f} s of a "
            f"{r.get('c_clocked_wall', 0.0):.3f} s run with a sync around "
            f"each collective ({share:.3f}); peak {r['c_peak_gib']:.2f} "
            f"GiB; the build's peak (whole model built and loaded, then "
            f"sharded{held if i == 0 else ''}) {r['build_peak_gib']:.2f} "
            f"GiB")
        # the fused FFN / dense_ln kernels decline every sharded site
        check_launches(f"{tag} c rank {i}", r["c_counts"], dict(
            {k: 0 for k in SOURCES}, quant_decode_attention=want_q,
            fused_attention=r["c_attention_per_round"] * TP_INT8_ROUNDS))
    log(f"[{tag} c] one process: {r0['c_one_tokens']} tokens in "
        f"{r0['c_one_wall']:.3f} s = "
        f"{r0['c_one_tokens'] / r0['c_one_wall']:.1f} tok/s")
    rows = spec["train_batch"]
    for run in spec["train_runs"]:
        key = f"d_{run['tag']}"
        d = r0[key]
        err = abs(d["loss"] - d["ref_loss"]) / abs(d["ref_loss"])
        msg = (f"[{tag} d {run['tag']}] f32, {rows} rows, lr "
               f"{DP_LR}: loss {d['loss']:.7f} against one process's "
               f"{d['ref_loss']:.7f} (relative {err:.3g}, limit "
               f"{TRAIN_LOSS_TOL}); parameters beyond {ABS_TOL} + "
               f"{REL_TOL}|p|: {d['over']} of {d['params']} (worst "
               f"{d['worst']:.3g}); first step {d['step_s'] * 1e3:.1f} ms "
               f"({rows / d['step_s']:.1f} examples/s) against one "
               f"process's {d['ref_step_s'] * 1e3:.1f} ms")
        if spec["warm"]:
            w, rw = d["parts"]["warm_s"], d["ref_parts"]["warm_s"]
            msg += (f"; warm step {w * 1e3:.1f} ms ({rows / w:.1f} "
                    f"examples/s) against one process's {rw * 1e3:.1f} ms "
                    f"({rows / rw:.1f}), ratio {w / rw:.3f}; warm peak "
                    f"{[round(r[key]['parts']['warm_peak_gib'], 2) for r in ranks]}"
                    f" GiB a rank, one process "
                    f"{d['ref_parts']['warm_peak_gib']:.2f}")
        msg += (f"; first step's peak "
                f"{[round(r[key]['peak_gib'], 2) for r in ranks]} GiB a "
                f"rank, one process {d['ref_peak_gib']:.2f}; the build's "
                f"peak (whole model built and loaded, then sharded) "
                f"{[round(r[key]['parts']['build_peak_gib'], 2) for r in ranks]}"
                f" GiB a rank, one process "
                f"{d['ref_parts']['build_peak_gib']:.2f}; rank 0's build and "
                f"load {d['parts']['build_s']:.2f} s, gather "
                f"{d['parts']['gather_s']:.2f} s")
        if "control_over" in d:
            msg += (f"; control without the copy's backward all-reduce: "
                    f"{d['control_over']} of rank 0's shards beyond (worst "
                    f"{d['control_worst']:.3g})")
            if d["control_over"] == 0:
                raise AssertionError(f"{tag} d: the control passes: blind "
                                     "check")
        log(msg)
        ok &= err <= TRAIN_LOSS_TOL and d["over"] == 0
    if "f_one" in r0:
        log(f"[{tag} f] demo, 2 greedy f32 turns: one process "
            f"{r0['f_one']}; the model group {r0['f_group']}")
        ok &= r0["f_one"] == r0["f_group"] and len(r0["f_one"]) == 4
    log(f"[{tag}] (a)-(c) {r0['abc_s']:.1f} s, (d) {r0['d_s']:.1f} s"
        + (f", (f) {r0['f_s']:.1f} s" if "f_s" in r0 else "")
        + f", (e) {r0['e_s']:.1f} s")
    if not ok:
        raise AssertionError(f"{tag}: a check failed (see above)")
    return [r["c_counts"] for r in ranks]


def without_flags(argv, names):
    """``argv`` without each of ``names`` and the value after it."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in names:
            skip = True
        else:
            out.append(a)
    return out


def tp_spec(tmp, train_flags, disc_flags, dp, demo=True, images=TP_IMAGES,
            train_batch=TP_TRAIN_BATCH, warm=False):
    """Phase 15's rank spec on phase 6-9's inputs for ``dp`` replicas,
    (c) at ``images`` images, (d) at ``train_batch`` rows (``warm``: each
    step timed again).  The dropout step runs with one replica only: the
    replicas of a data axis draw their own masks (train_gen.rank_seed),
    so a step across them equals one process's only dropout-free."""
    common, teacher = train_flags
    disc_common, dense = disc_flags
    lr = ["-lr", DP_LR, "-image_lr", DP_LR, "-min_lr", DP_LR,
          "-batch_size", str(train_batch), "-distributed",
          "-model_parallel", str(TP_DEGREE)]
    demo_ckpt = os.path.join(tmp, "tp_demo.ckpt")
    spec = {"task": "tp", "mp": TP_DEGREE, "dp": dp, "images": images,
            "train_batch": train_batch, "warm": warm,
            "argv": ["-vocab_path", os.path.join(tmp, "vocab.txt"),
                     "-start_path", demo_ckpt],
            "train_runs": [
                {"kind": "gen", "tag": "train_gen", "control": True,
                 "argv": common + teacher + lr},
                {"kind": "disc", "tag": "train_disc",
                 "argv": disc_common + dense + lr}]}
    if dp == 1:
        # the production configs' dropout
        spec["train_runs"].append(
            {"kind": "gen", "tag": "train_gen dropout", "dropout": True,
             "argv": without_flags(common + teacher + lr,
                                   ("-model_enc_config",
                                    "-model_dec_config"))})
    if demo:
        spec["demo_argv"] = eval_flags(tmp) + [
            "-vocab_path", os.path.join(tmp, "vocab.txt"), "-start_path",
            demo_ckpt, "-top_k", "1", "-max_dec_len", "18", "-dtype",
            "float32"]
    return spec, demo_ckpt


def tp_eval_argv(tmp, ckpts):
    """(e)'s run: evaluate_gen -model_parallel on :func:`tp_eval_inputs`
    with phase 6's .ckpt, its log under ``tmp``/tp_eval."""
    return tp_eval_inputs(tmp) + [
        "-vocab_path", os.path.join(tmp, "vocab.txt"), "-start_path",
        ckpts["full"], "-use_pallas", "-mode", "vd_eval_val", "-save_path",
        os.path.join(tmp, "tp_eval"), "-distributed", "-model_parallel",
        str(TP_DEGREE)]


def tp_eval_rank(torch, counters, spec, primary, res):
    """(e) on one rank, in the launched group: ``spec["eval_argv"]``'s
    evaluate_gen with the counters set to 0 just before and read just
    after; rank 0's gathered scores and batch loop."""
    from gstx_torch.cli import evaluate_gen
    from gstx_torch.eval import rank_gen
    from gstx_torch.kernels import ffn as kffn

    scores, stats = [], {}
    torch.cuda.synchronize()
    counters.reset()
    with recording_scores(rank_gen, scores):
        res["e_metrics"] = evaluate_gen.main(
            spec["eval_argv"], chunk_size=GEN_CHUNK, device="cuda",
            stats_out=stats)
    torch.cuda.synchronize()
    kffn.enable(True)
    res["e_counts"] = counters.read()
    res["e_loop_s"] = stats["loop_seconds"]
    if primary:
        res["e_scores"] = [float(x) for a in scores for x in a]


def tp_eval_check(torch, card, tmp, ranks, want, tag):
    """(e): rank 0's scores against ``want`` ([ROUNDS, TP_EVAL_OPTIONS],
    one process's; centred per round), the log written once, no kernel
    launched (the fused ones decline a sharded site).  Returns each rank's
    launch counts."""
    n = ROUNDS * TP_EVAL_OPTIONS
    r0 = ranks[0]
    got = torch.tensor(r0["e_scores"]).reshape(ROUNDS, TP_EVAL_OPTIONS)
    err = max(centred_err(torch, g, w) for g, w in zip(got, want))
    out = os.path.join(tmp, "tp_eval")
    files = sorted(os.listdir(out))
    loop = r0["e_loop_s"]
    log(f"[{tag}] evaluate_gen -model_parallel {TP_DEGREE}, phase 7's "
        f"first dialog, {TP_EVAL_OPTIONS} options a round ({n} sequences):"
        f" rank 0's scores against one process's, centred per round: "
        f"largest relative error {err:.4g} (limit {EVAL_SCORE_TOL['gen']});"
        f" metrics {json.dumps(r0['e_metrics'])}; files {files}; batch "
        f"loop {loop:.2f} s = {n / loop:.1f} scored sequences/s; on {card}")
    zero = {k: 0 for k in SOURCES}
    for i, r in enumerate(ranks):
        check_launches(f"{tag} rank {i}", r["e_counts"], zero)
    if err > EVAL_SCORE_TOL["gen"] or files != ["performance_log.txt"]:
        raise AssertionError(f"{tag}: the evaluation over the model group "
                             "differs from one process's")
    shutil.rmtree(out)
    return [r["e_counts"] for r in ranks]


def tp_refusal_part(train_flags):
    """(g): -model_parallel 3 exits with JAX's validate_model_parallel
    message, before any work."""
    from gstx_torch.cli import train_gen

    common, teacher = train_flags
    try:
        train_gen.main(common + teacher + ["-model_parallel", "3"],
                       max_steps=1, device="cuda")
    except ValueError as e:
        got = str(e)
    else:
        got = None
    log(f"[phase 15g] -model_parallel 3 on the production configs: {got!r}")
    if got != JAX_MP3_MESSAGE:
        raise AssertionError(f"phase 15g: want {JAX_MP3_MESSAGE!r}")


def tp_run(torch, card, tmp, ckpts, want, train_flags, disc_flags,
           cards, tag):
    """Phase 15 (a)-(f) on ``cards`` cards: 1 is the two ranks on one card
    over gloo, with the demo, (c) and (d) at a small batch; more is
    ``cards / 2`` replicas of two shards over nccl, a rank a card, (c) at
    TP_CARDS_IMAGES images and (d) at TP_CARDS_TRAIN_BATCH rows with a
    warm step.  Returns the launch counts of (c) and (e) by rank."""
    t0 = time.perf_counter()
    one_card = cards == 1
    world = TP_DEGREE if one_card else cards
    backend = "gloo" if one_card else None
    sizes = {} if one_card else dict(images=TP_CARDS_IMAGES,
                                     train_batch=TP_CARDS_TRAIN_BATCH,
                                     warm=True)
    spec, demo_ckpt = tp_spec(tmp, train_flags, disc_flags,
                              world // TP_DEGREE, demo=one_card, **sizes)
    spec["eval_argv"] = tp_eval_argv(tmp, ckpts)
    unbiased_ckpt(torch, ckpts["full"], demo_ckpt)
    ranks, wall = launch_ranks(tag, spec, tmp, world=world, backend=backend)
    if one_card:
        log(f"[{tag}] the ranks' launch: {wall:.2f} s wall, gloo (NCCL "
            "takes one rank a card): its collectives are a host "
            "transport, not tensor parallelism's speed")
    else:
        log(f"[{tag}] the ranks' launch: {wall:.2f} s wall, nccl")
    counts = {"tp_int8": tp_report(tag, card, ranks, spec),
              "tp_eval": tp_eval_check(torch, card, tmp, ranks, want,
                                       f"{tag} e")}
    os.remove(demo_ckpt)
    log(f"[{tag}] {time.perf_counter() - t0:.1f} s; on {card}")
    return counts


def tp_phase(torch, card, tmp, ckpts, scores7, train_flags, disc_flags):
    """Phase 15: tensor parallelism at full width on the one card, two
    ranks over gloo.  Returns the launch counts by path."""
    import numpy as np

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # phase 7's scores of the first dialog's first options
    want = torch.from_numpy(np.concatenate(scores7)[:ROUNDS * EVAL_OPTIONS]
                            ).reshape(ROUNDS, EVAL_OPTIONS)[:, :TP_EVAL_OPTIONS]
    counts = tp_run(torch, card, tmp, ckpts, want, train_flags,
                    disc_flags, 1, "phase 15")
    tp_refusal_part(train_flags)
    log(f"[phase 15] {time.perf_counter() - t0:.1f} s in all; on {card}")
    return counts


RANK_TASKS = {"step": rank_step, "cli": rank_cli, "pair": rank_pair,
              "tp": rank_tp}


SOURCES = {"fused_dense_ln": "gstx_torch/kernels/csrc/ffn.cu",
           "fused_ffn": "gstx_torch/kernels/csrc/ffn.cu",
           "fused_attention": "gstx_torch/kernels/csrc/attention.cu",
           "fused_attention_batch": "gstx_torch/kernels/csrc/attention.cu",
           "quant_decode_attention": "gstx_torch/kernels/csrc/decode_attn.cu"}


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "gstx_torch")):
        print("chip_smoke: gstx_torch/ not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from gstx_torch.kernels import attention as kattn
    from gstx_torch.kernels import build
    from gstx_torch.kernels import decode_attn as kdecode
    from gstx_torch.kernels import ffn as kffn

    # the plain versions' f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"[phase 1] card: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.library()
    log(f"[phase 1] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        f"{'%.2f s' % build.build_seconds if build.build_seconds else 'cached'})")
    for text in build.build_log:
        print(text, file=sys.stderr)
    build_census(build)

    entries, grads = kernel_phase(torch, kffn, kattn, kdecode)
    counters = Counters(kffn, kattn, kdecode)
    default_counts, int8_counts, profile_last = engine_phases(
        torch, np, counters, ROUNDS, TIMED_BATCHES, card)
    with tempfile.TemporaryDirectory() as tmp:
        cli_counts, vocab, ckpts, gen_argv, records6 = cli_phase(
            torch, np, counters, card, tmp)
        gen_counts, disc_counts, eval_data, scores7 = eval_phase(
            torch, np, counters, card, tmp, vocab, ckpts)
        train_counts, train_flags = train_phase(torch, np, counters, card,
                                                tmp, vocab)
        disc_train_counts, disc_flags = disc_phase(torch, np, counters,
                                                   card, tmp, vocab)
        attack_counts = attack_phase(torch, np, counters, card, tmp, vocab,
                                     ckpts)
        beam_counts, beam_int8_counts, profile_beam = beam_phase(
            torch, np, counters, card, ckpts["full"])
        demo_counts = demo_phase(torch, counters, card, tmp, ckpts["full"],
                                 os.path.join(tmp, "vocab.txt"))
        torch.cuda.empty_cache()
        selftrain_phase(torch, np, card, tmp, ckpts["full"], vocab)
        dp_counts = dp_phase(torch, counters, card, tmp, gen_argv, records6,
                             eval_data, scores7, ckpts, train_flags,
                             disc_flags)
        tp_counts = tp_phase(torch, card, tmp, ckpts, scores7, train_flags,
                             disc_flags)
    profile_last()
    profile_beam()

    kernels = []
    for name, replaces, rows in entries:
        main_row = rows[0]
        # each kernel's launches on the path that runs it: the CLI (the
        # main path's entry point, the default configuration) for kernels
        # 1-2, the all-kernels engine for 3-5
        on_default = name in ("fused_dense_ln", "fused_ffn")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=replaces,
            launches=(cli_counts if on_default else int8_counts)[name],
            launches_by_path={"default": default_counts[name],
                              "int8_attention": int8_counts[name],
                              "cli": cli_counts[name],
                              "eval_gen": gen_counts[name],
                              "eval_disc": disc_counts[name],
                              "train": train_counts[name],
                              "train_disc": disc_train_counts[name],
                              "attack_fgsm": attack_counts[name],
                              "beam": beam_counts[name],
                              "beam_int8": beam_int8_counts[name],
                              "inference": demo_counts[name],
                              "dp_train_nccl":
                                  dp_counts["dp_train_nccl"][name],
                              "dp_generate_ranks": [
                                  c[name] for c in dp_counts["dp_generate"]],
                              "dp_eval_ranks": [
                                  c[name] for c in dp_counts["dp_eval"]],
                              "tp_int8_ranks": [
                                  c[name] for c in tp_counts["tp_int8"]],
                              "tp_eval_ranks": [
                                  c[name] for c in tp_counts["tp_eval"]]},
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], shapes=rows,
            backward_shapes=grads.get(name, [])))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def dp_cards_main(worlds):
    """``python3 chip_smoke.py --dp-cards N [M ...]``: phase 14 (b) and (d)
    on N (then M ...) cards over nccl, a rank a card, after phase 1's build
    and the inputs of phases 6-9; (d) holds rank 0's scores against one
    process's run of the evaluator on the same inputs.  Needs as many
    cards."""
    import numpy as np
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < max(worlds):
        print(f"chip_smoke --dp-cards: {max(worlds)} cards needed",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from gstx_torch.cli import evaluate_gen
    from gstx_torch.eval import rank_gen
    from gstx_torch.kernels import attention as kattn
    from gstx_torch.kernels import build
    from gstx_torch.kernels import decode_attn as kdecode
    from gstx_torch.kernels import ffn as kffn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[dp cards] {torch.cuda.device_count()} x {card}")
    build.library()
    counters = Counters(kffn, kattn, kdecode)
    with tempfile.TemporaryDirectory() as tmp:
        _, vocab, _ = cli_inputs(torch, np, tmp)
        ckpts = {"full": os.path.join(tmp, "model.ckpt")}
        common, _, teacher = train_inputs(np, tmp, vocab)
        disc = disc_inputs(np, tmp, vocab)
        eval_data = eval_inputs(np, tmp, vocab) + [
            "-vocab_path", os.path.join(tmp, "vocab.txt")]
        n_val = EVAL_IMAGES * ROUNDS * EVAL_OPTIONS
        each = per_forward() * (n_val // GEN_CHUNK)
        scores = []
        with recording_scores(rank_gen, scores):
            eval_run(torch, counters, card, "dp cards one process",
                     evaluate_gen, eval_data + [
                         "-start_path", ckpts["full"], "-use_pallas",
                         "-mode", "vd_eval_val", "-save_path",
                         os.path.join(tmp, "dp_eval_one")], GEN_CHUNK,
                     EVAL_IMAGES, n_val, dict(
                         {k: 0 for k in SOURCES}, fused_ffn=each,
                         fused_dense_ln=each))
        for world in worlds:
            dp_step_part(card, tmp, (common, teacher), disc, world=world,
                         backend=None, tag=f"dp {world} cards")
            dp_eval_part(torch, counters, card, tmp, eval_data, ckpts,
                         scores, world=world, backend=None,
                         tag=f"dp {world} cards eval")
    log(f"[dp cards] passed on {card}")
    return 0


def tp_cards_main(worlds):
    """``python3 chip_smoke.py --tp-cards N [M ...]``: phase 15 (a)-(e)
    and (g) on N (then M ...) cards over nccl, a rank a card: N / 2
    replicas of 2 shards (2 cards: 1 x 2; 4 cards: 2 x 2, data x model),
    after phase 1's build and the inputs of phases 6-9; (e) holds rank 0's
    scores against one process's run of the evaluator on the same dialog.
    Each part's times and peak memory a rank beside one process's.  N = 1
    is phase 15 itself (two ranks on one card over gloo, the demo too),
    alone.  Needs as many cards."""
    import numpy as np
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < max(worlds):
        print(f"chip_smoke --tp-cards: {max(worlds)} cards needed",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from gstx_torch.cli import evaluate_gen
    from gstx_torch.eval import rank_gen
    from gstx_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[tp cards] {torch.cuda.device_count()} x {card}")
    build.library()
    with tempfile.TemporaryDirectory() as tmp:
        _, vocab, _ = cli_inputs(torch, np, tmp)
        ckpts = {"full": os.path.join(tmp, "model.ckpt")}
        train_flags = train_inputs(np, tmp, vocab)
        train_flags = (train_flags[0], train_flags[2])
        disc_flags = disc_inputs(np, tmp, vocab)
        eval_inputs(np, tmp, vocab)
        scores = []
        with recording_scores(rank_gen, scores):
            evaluate_gen.main(tp_eval_inputs(tmp) + [
                "-vocab_path", os.path.join(tmp, "vocab.txt"),
                "-start_path", ckpts["full"], "-use_pallas", "-mode",
                "vd_eval_val", "-save_path", os.path.join(tmp, "tp_one")],
                chunk_size=GEN_CHUNK, device="cuda")
        want = torch.from_numpy(np.concatenate(scores)).reshape(
            ROUNDS, TP_EVAL_OPTIONS)
        for cards in worlds:
            tp_run(torch, card, tmp, ckpts, want, train_flags, disc_flags,
                   cards, f"tp {cards} cards")
        tp_refusal_part(train_flags)
    log(f"[tp cards] passed on {card}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank":
        sys.exit(rank_main(sys.argv[2]))
    if len(sys.argv) > 2 and sys.argv[1] == "--dp-cards":
        sys.exit(dp_cards_main([int(n) for n in sys.argv[2:]]))
    if len(sys.argv) > 2 and sys.argv[1] == "--tp-cards":
        sys.exit(tp_cards_main([int(n) for n in sys.argv[2:]]))
    sys.exit(main())
