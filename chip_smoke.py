#!/usr/bin/env python3
"""Drive the PyTorch port (gstx_torch) on one CUDA card.

  phase 1  the card: its name and power limit (nvidia-smi), and the build of
           the CUDA kernels from gstx_torch/kernels/csrc with nvcc (sm_90a);
  phase 2  each kernel against its plain PyTorch version, bf16, at every
           shape the main path gives it plus a ragged M: elementwise
           |kernel - plain| <= 1e-2 + 1.6e-2 * |plain| (about 2 bf16 ulps),
           and times (CUDA events, median of 20 calls after 3 warm-up
           calls) of the kernel, the plain version and one PyTorch
           composite of the same function, beside the least time the card
           could take (bf16 tensor-core FLOPs at 989 TFLOP/s or compulsory
           bytes at 3.35 TB/s, whichever is larger);
  phase 3  the dialog engine at full width (12/6/6-layer encoder, 12-layer
           decoder, bf16, random weights from a seed) on bench.py's
           workload: batch 96, context 256, 37 regions, caption-only
           contexts, buckets 128/192, questions at T=0.7 / top-k 7 / n-gram
           4, answers without n-gram blocking, 18 steps.  A small input
           first checks the bf16 kernel path against the f32 unfused model;
           then one warm-up batch, then the timed batches, with every
           kernel's launch count set to 0 just before and read just after;
  phase 4  where the time goes: one round's pieces (encoder, decode,
           answer scoring) and one profiled round (device busy share, top
           kernels).

Prints the kernels JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero with no
result; so does a machine without CUDA or a directory without gstx_torch.

    python3 chip_smoke.py
"""

import copy
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
ABS_TOL, REL_TOL = 1e-2, 1.6e-2
# f32-unfused vs bf16-kernel model on a small input: relative Frobenius
# error of the decoder memory K/V and of the logits (bf16 rounding through
# ~20 sequential layers)
MODEL_REL_TOL = 5e-2
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


def time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_phase(torch, kffn):
    """Phase 2: returns the per-kernel JSON entries."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0, dtype=bf, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                + shift).to(dtype)

    def held(name, label, k, p):
        err = (k.float() - p.float()).abs()
        lim = ABS_TOL + REL_TOL * p.float().abs()
        if not bool(torch.isfinite(k.float()).all()) or \
                not bool((err <= lim).all()):
            raise AssertionError(
                f"{name}[{label}]: kernel disagrees with its plain version:"
                f" max |err| {float(err.max()):.4g}, worst err/limit "
                f"{float((err / lim).max()):.3g}")
        return float(err.max())

    entries = []
    # (label, M, K, D): attention-output projections and BiOutput
    dense_ln_shapes = [("text 24576x768->768", 24576, 768, 768),
                       ("visual/BiOutput-v 3552x1024->1024", 3552, 1024, 1024),
                       ("BiOutput-t 24576x1024->768", 24576, 1024, 768),
                       ("ragged 1000x768->768", 1000, 768, 768)]
    rows = []
    for label, m, k, d in dense_ln_shapes:
        x, res = randn(m, k), randn(m, d)
        w, b = randn(d, k, scale=0.02), randn(d, scale=0.02, dtype=f32)
        g, be = randn(d, scale=0.1, shift=1.0, dtype=f32), \
            randn(d, scale=0.1, dtype=f32)
        args = (x, w, b, res, g, be)
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
                         bound_ms=bms, bound_by=by, library_ms=lib))
        log(f"[phase 2] fused_dense_ln {label}: " + json.dumps(rows[-1]))
    entries.append(("fused_dense_ln", "gstx/kernels/ffn.py:254", rows))

    ffn_shapes = [("text 24576x768x3072", 24576, 768, 3072),
                  ("visual/co-v 3552x1024x1024", 3552, 1024, 1024),
                  ("ragged 1000x768x3072", 1000, 768, 3072)]
    rows = []
    for label, m, d, f in ffn_shapes:
        x = randn(m, d)
        w1, b1 = randn(f, d, scale=0.02), randn(f, scale=0.02, dtype=f32)
        w2, b2 = randn(d, f, scale=0.02), randn(d, scale=0.02, dtype=f32)
        g, be = randn(d, scale=0.1, shift=1.0, dtype=f32), \
            randn(d, scale=0.1, dtype=f32)
        args = (x, w1, b1, w2, b2, g, be)
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
                         bound_ms=bms, bound_by=by, library_ms=lib))
        log(f"[phase 2] fused_ffn {label}: " + json.dumps(rows[-1]))
    entries.append(("fused_ffn", "gstx/kernels/ffn.py:198", rows))
    return entries


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


def engine_phase(torch, np, kffn, rounds, batches, card):
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
    small = make_batch(np, enc_cfg, 4, 128, 37)
    args = [torch.from_numpy(small[k]).cuda() for k in
            ("enc_input_ids", "enc_image_feat", "enc_image_loc",
             "enc_segments")]
    args += [(args[0] != 0).long(), torch.from_numpy(
        small["enc_image_mask"]).cuda()]
    dec_ids = torch.from_numpy(small["enc_input_ids"][:, :12]).cuda()
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
    del ref, kv32, kv16
    torch.cuda.empty_cache()

    B, S, R, T = 96, 256, 37, 18
    batch = make_batch(np, enc_cfg, B, S, R)
    settings = dict(max_steps=T, temperature=0.7, top_k=7, top_p=0.0,
                    fused_sampler=True)
    engine = make_dialog_engine(
        num_rounds=rounds,
        q_settings=DecodeSettings(ngram_blocking_size=4, **settings),
        a_settings=DecodeSettings(ngram_blocking_size=0, **settings),
        dtype=torch.bfloat16, context_buckets=(128, 192), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)

    t0 = time.perf_counter()
    engine(model, model, batch, gen)
    torch.cuda.synchronize()
    log(f"[phase 3] warm-up batch {time.perf_counter() - t0:.2f} s")

    kffn.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [engine(model, model, batch, gen) for _ in range(batches)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / batches
    counts = dict(kffn.launches)
    per_forward = (enc_cfg.num_hidden_layers + enc_cfg.v_num_hidden_layers
                   + 2 * len(enc_cfg.v_biattention_id))
    want = per_forward * 2 * rounds * batches
    log(f"[phase 3] launches over {batches} batches: {counts} "
        f"(expected {want} each: {per_forward} per encoder forward, "
        f"2 forwards per round, {rounds} rounds)")
    for name, n in counts.items():
        if n != want:
            raise AssertionError(f"{name}: {n} launches, expected {want}")
    for out in outs:
        for t in (out.questions, out.answers):
            if tuple(t.shape) != (rounds, B, T):
                raise AssertionError(f"output shape {tuple(t.shape)}")
            if int(t.min()) < 0 or int(t.max()) >= dec_cfg.vocab_size:
                raise AssertionError("token id out of range")
        ppl = out.answer_ppl
        if tuple(ppl.shape) != (rounds, B) or \
                not bool(torch.isfinite(ppl).all()) or \
                not bool((ppl > 0).all()):
            raise AssertionError("answer_ppl not finite and positive")
    tokens = B * rounds * 2 * T  # bench.py's fixed accounting
    emitted = sum(int((o.questions != 0).sum() + (o.answers != 0).sum())
                  for o in outs) / batches
    log(f"[phase 3] engine: {tokens / wall:.2f} generated tok/s "
        f"({rounds} rounds, batch {B}, {wall:.3f} s/batch, {tokens} tokens "
        f"by fixed accounting, {emitted:.0f} emitted) on {card}")
    breakdown(torch, model, batch, settings, DecodeSettings,
              make_dialog_engine, card)
    return counts


def breakdown(torch, model, batch, settings, DecodeSettings,
              make_dialog_engine, card):
    """Phase 4, where the time goes: one round's pieces at the full context
    width (host clock around synchronised calls), then one round under
    torch.profiler for the device's busy share and its top kernels."""
    from gstx_torch.decode.sampler import init_cache, sample_sequence

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    dev = torch.device("cuda")
    ids = torch.from_numpy(batch["enc_input_ids"]).to(dev)
    args = (ids, torch.from_numpy(batch["enc_image_feat"]).to(dev),
            torch.from_numpy(batch["enc_image_loc"]).to(dev),
            torch.from_numpy(batch["enc_segments"]).to(dev),
            (ids != 0).long(), torch.from_numpy(batch["enc_image_mask"]).to(dev))
    gen = torch.Generator(device=dev).manual_seed(2)
    q_set = DecodeSettings(ngram_blocking_size=4, **settings)
    with torch.no_grad():
        model.decode_prepare(*args)  # warm
        (kv, mask), enc_ms = synced(lambda: model.decode_prepare(*args))

        def decode():
            caches = init_cache(model.dec_config, ids.shape[0],
                                q_set.max_steps + 1, model.dtype, dev)
            return sample_sequence(
                lambda tok, pos, c: model.decode_step(tok, pos, c, kv, mask),
                gen, ids.shape[0], caches, q_set, ngram_source=ids,
                device=dev)
        seq, dec_ms = synced(decode)
        _, ppl_ms = synced(lambda: model.decode_logits_cached(
            seq, (seq != 0).long(), kv, mask))
    round_ms = 2 * enc_ms + 2 * dec_ms + ppl_ms
    log(f"[phase 4] one round at context 256, batch {ids.shape[0]}: "
        f"encoder+memory {enc_ms:.1f} ms x2, 18-step decode {dec_ms:.1f} ms "
        f"x2 ({dec_ms / q_set.max_steps:.2f} ms/step), answer scoring "
        f"{ppl_ms:.1f} ms; sum {round_ms:.1f} ms "
        f"(decode {200 * dec_ms / round_ms:.0f}%)")

    from torch.profiler import ProfilerActivity, profile

    one = make_dialog_engine(
        num_rounds=1, q_settings=q_set,
        a_settings=DecodeSettings(ngram_blocking_size=0, **settings),
        dtype=torch.bfloat16, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_ms = synced(lambda: one(model, model, batch, gen))
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log("[phase 4] profiler: no device time recorded; busy share not "
            "measured")
        return
    log(f"[phase 4] profiled round at context 256: wall {wall_ms:.1f} ms "
        f"(profiler on), device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}, {sum(e.count for e in kernels)} "
        f"kernel launches, on {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[phase 4]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:7d}x  {e.key[:90]}")


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
    from gstx_torch.kernels import build
    from gstx_torch.kernels import ffn as kffn

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

    entries = kernel_phase(torch, kffn)
    counts = engine_phase(torch, np, kffn, ROUNDS, TIMED_BATCHES, card)

    kernels = []
    for name, replaces, rows in entries:
        main_row = rows[0]
        kernels.append(dict(
            name=name, route="cuda",
            source="gstx_torch/kernels/csrc/ffn.cu", replaces=replaces,
            launches=counts[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], shapes=rows))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
