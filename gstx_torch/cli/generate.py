"""CLI: synthetic dialog generation (the GST data engine), the port of
``gstx/cli/generate.py``.

A questioner and a teacher (answerer) model generate ``-num_dialog_rounds``
rounds for every image of a CC12M chunk (``-mode cc12m_gen``) or of the
VisDial val captions (``-mode vd_gen_val``), with the answers' perplexity,
and write JSON records {image_id, url, caption, dialog: [{question, answer,
answer_ppl}]}.  Abnormal samples (context overflow) are dropped, as
``generate.py:236-237`` does.

    python -m gstx_torch.cli.generate -mode cc12m_gen -start_path_q q.ckpt \\
        -start_path_a a.ckpt -save_name out.json ...

It runs on ``cuda`` unless ``main`` is given ``device="cpu"`` or the
environment sets ``GSTX_PLATFORM=cpu``; without a card it raises.  Under
``-distributed`` across N ranks (``python -m torch.distributed.run
--nproc_per_node N -m gstx_torch.cli.generate ... -distributed``) each
rank generates its stripe of the images and writes the shard
``name.procN.ext``, as the JAX CLI's processes do; the ranks never talk,
and :func:`gstx_torch.data.cc12m.load_dialog_json` reads the shards back.
With ``-model_parallel M`` the N ranks form N / M replicas of M shards:
each replica generates its stripe (striped by the replica's index) over
its model group, and the group's rank 0 alone writes the replica's shard
``name.procD.ext`` and its sidecar.

Differences from the JAX CLI, none of which changes what a run computes:
  * each batch samples from its own ``torch.Generator`` on the device,
    seeded from ``(seed, batch index)`` through ``numpy.random.SeedSequence``
    (the JAX CLI folds the batch index into its key), so a resumed run
    reproduces the uninterrupted one.  Torch's generators are not JAX's
    threefry, so sampled tokens differ from the JAX CLI's; greedy ones
    (``-top_k 1``) agree;
  * the sidecar identity also names the device type: CPU and CUDA
    generators draw different streams from one seed;
  * the prefetch thread does host work only (padding, the bf16 cast of the
    region features, pinned buffers); the main thread issues the
    host-to-device copies and runs the engine.
"""

from __future__ import annotations

import contextlib
import json
import os
import pprint
import queue as queue_mod
import threading
import time

import numpy as np
import torch

from gstx_torch.cli.common import (apply_runtime_flags, build_model,
                                   build_tokenizer, default_device,
                                   load_params, pad_batch_rows, parse_config)
from gstx_torch.core import mesh, profiling
from gstx_torch.data.loader import DataLoader
from gstx_torch.decode.dialog_engine import make_dialog_engine
from gstx_torch.decode.sampler import DecodeSettings

# what the engine reads of a batch; the rest stays on the host
ENGINE_KEYS = ("enc_input_ids", "enc_segments", "enc_image_feat",
               "enc_image_loc", "enc_image_mask")


def _file_fp(path):
    """Freshness fingerprint of an input file: [size, mtime_ns], or None
    when absent.  Catches a regenerated same-path input without hashing
    large stores."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return [st.st_size, st.st_mtime_ns]


def _process_info():
    """(process_index, process_count): the seam through which tests run one
    rank of a multi-process generation in one process
    (``gstx/cli/generate.py:37-40``)."""
    return mesh.process_index(), mesh.process_count()


def _sidecar_meta(config, proc_idx, proc_count, n_items, device_type):
    """Identity of a generation run: a partial sidecar is resumable only by
    a run that would produce the identical batch sequence.  Every setting
    that can change the generated tokens is part of it (the JAX CLI's
    fields, ``gstx/cli/generate.py:56-102``): data selection, decode
    semantics, numerics, kernels, the bucket schedule, the input files'
    fingerprints, and here the device type, whose generator draws the
    samples."""
    if config.mode == "cc12m_gen":
        data_paths = [config.cc12m_image_feats, config.cc12m_caption,
                      config.image_id_to_url, config.url_to_cap]
    else:
        data_paths = [config.visdial_processed_val,
                      config.visdial_image_feats]
    return {
        "seed": config.seed,
        "batch_size": config.batch_size,
        "mode": config.mode,
        "chunk": config.chunk,
        "num_dialog_rounds": config.num_dialog_rounds,
        "max_dec_len": config.max_dec_len,
        "start_path_q": config.start_path_q,
        "start_path_a": config.start_path_a,
        "temperature": config.temperature,
        "top_k": config.top_k,
        "top_p": config.top_p,
        "ngram_blocking_size": config.ngram_blocking_size,
        "fused_sampler": config.fused_sampler,
        "dtype": config.dtype,
        "use_pallas": config.use_pallas,
        "quantize_memory": config.quantize_memory,
        "context_buckets": config.context_buckets,
        "dynamic_buckets": config.dynamic_buckets,
        "model_parallel": config.model_parallel,
        "process": [proc_idx, proc_count],
        "n_items": n_items,
        "max_seq_len": config.max_seq_len,
        "max_regions": config.max_regions,
        "vocab_path": config.vocab_path,
        "inputs": {p: _file_fp(p) for p in [config.vocab_path] + data_paths},
        "device": device_type,
    }


def _load_sidecar(path, meta):
    """(start_batch, per_batch_records) recovered from a partial sidecar:
    the contiguous completed-batch prefix.  Returns (0, []) when the file is
    absent, empty, or written by a different run (meta mismatch).  A torn
    trailing line (preemption mid-append) is ignored."""
    if not os.path.exists(path):
        return 0, []
    lines = open(path).read().splitlines()
    if not lines:
        return 0, []
    try:
        head = json.loads(lines[0])
    except json.JSONDecodeError:
        return 0, []
    if head.get("meta") != meta:
        print(f"[generate] ignoring sidecar {path}: meta mismatch "
              "(written by a different run)")
        return 0, []
    done = {}
    for ln in lines[1:]:
        try:
            row = json.loads(ln)
        except json.JSONDecodeError:
            break  # torn tail from a mid-append preemption
        done[row["batch"]] = row["records"]
    batches = []
    while len(batches) in done:
        batches.append(done[len(batches)])
    return len(batches), batches


def _prefetch(src, prepare, depth):
    """Run ``prepare`` over ``src`` on a daemon thread, ``depth`` items
    ahead of the consumer.  ``prepare`` does host work only; the consumer
    (the main thread) issues the copies to the device and runs the engine.
    An exception in ``prepare`` re-raises at the consumer."""
    q = queue_mod.Queue(maxsize=max(1, depth))
    err = []
    stop = threading.Event()  # consumer gone: unblock and end the worker

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def work():
        try:
            for idx, batch in src:
                with profiling.span("gstx:generate.prepare"):
                    item = prepare(idx, batch)
                if not put(item):
                    return
        except BaseException as e:  # re-raised below, incl. KeyboardInterrupt
            err.append(e)
        finally:
            put(None)

    threading.Thread(target=work, daemon=True,
                     name="gstx-generate-prefetch").start()
    try:
        while True:
            with profiling.span("gstx:generate.wait"):
                item = q.get()
            if item is None:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # the consumer failed (or closed the generator) while the queue is
        # full: the worker would block in q.put forever, pinning up to
        # `depth` prepared batches for the life of the process
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue_mod.Empty:
                break


def batch_generator(seed: int, idx: int, device) -> torch.Generator:
    """The sampling generator of batch ``idx``: a function of (seed, idx)
    only, so any batch's tokens are the same whether or not the batches
    before it ran in this process."""
    state = np.random.SeedSequence([seed, idx]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def main(argv=None, max_batches=None, stats_out=None, finalize=True,
         device=None):
    """``finalize=False`` stops after the batch loop without the final JSON
    write or sidecar cleanup: the test seam for a preempted run (a real
    preemption kills the process anywhere; the sidecar protocol tolerates
    that through the torn-tail rule of ``_load_sidecar``).  ``device``:
    see :func:`gstx_torch.cli.common.default_device`.  ``stats_out``, a
    dict, receives this run's ``images``, generated non-PAD ``tokens``,
    ``abnormal`` samples and ``loop_seconds`` (the batch loop's wall
    time).  ``-trace_dir`` writes a trace of the batch loop and its spans
    (:func:`gstx_torch.core.profiling.trace`)."""
    config = parse_config(argv, "gstx_torch dialog generation")
    dev = default_device(device)
    pprint.pprint(config)
    if config.mode not in ("vd_gen_val", "cc12m_gen"):
        raise SystemExit(f"error: -mode {config.mode}: generation runs "
                         "vd_gen_val or cc12m_gen")
    if not config.save_name:
        raise SystemExit("error: -save_name is required")
    if not (config.start_path_q and config.start_path_a):
        raise SystemExit("error: -start_path_q and -start_path_a are "
                         "required")
    apply_runtime_flags(config, dev)
    os.makedirs(config.save_path, exist_ok=True)
    # every rank a replica of its own (striped by _process_info) unless
    # -model_parallel groups them: world / M replicas of M shards
    axes = mesh.make_layout(-1, config.model_parallel, dev) \
        if config.model_parallel > 1 and mesh.process_count() > 1 else None
    tp = None if axes is None else axes.tp
    # the model group's rank 0 writes its replica's shard and sidecar
    writer = tp is None or tp.rank == 0

    tokenizer = build_tokenizer(config)
    if config.mode == "vd_gen_val":
        from gstx_torch.data.visdial import VisdialGenDataset

        dataset = VisdialGenDataset(config, tokenizer, mode="vd_gen_val")
    else:
        from gstx_torch.data.cc12m import CC12mDataset

        dataset = CC12mDataset(config, tokenizer, mode="cc12m_gen")

    q_model = load_params(build_model(config, device=dev, tp=tp),
                          config.start_path_q)
    if config.start_path_a == config.start_path_q:
        a_model = q_model  # one set of weights; the engine sees it as one
    else:
        a_model = load_params(build_model(config, device=dev, tp=tp),
                              config.start_path_a)

    image_id_to_url = {}
    url_to_cap = {}
    if os.path.exists(config.image_id_to_url):
        image_id_to_url = json.load(open(config.image_id_to_url))
    if os.path.exists(config.url_to_cap):
        url_to_cap = json.load(open(config.url_to_cap))

    bf16 = config.dtype == "bfloat16"
    engine = make_dialog_engine(
        num_rounds=config.num_dialog_rounds,
        q_settings=DecodeSettings(
            max_steps=config.max_dec_len, temperature=config.temperature,
            top_k=config.top_k, top_p=config.top_p,
            ngram_blocking_size=config.ngram_blocking_size,
            fused_sampler=config.fused_sampler),
        a_settings=DecodeSettings(
            max_steps=config.max_dec_len, temperature=config.temperature,
            top_k=config.top_k, top_p=config.top_p, ngram_blocking_size=0,
            fused_sampler=config.fused_sampler),
        dtype=torch.bfloat16 if bf16 else torch.float32,
        context_buckets=config.context_bucket_tuple(),
        dynamic_buckets=config.dynamic_buckets,
        quantize_memory=config.quantize_memory,
        device=dev)

    proc_idx, proc_count = _process_info() if axes is None else \
        (axes.data_rank, axes.data_size)
    loader = DataLoader(dataset, batch_size=config.batch_size, shuffle=False,
                        drop_last=False, num_workers=config.num_workers,
                        seed=config.seed, process_index=proc_idx,
                        process_count=proc_count)
    save_name = config.save_name
    if proc_count > 1:
        # this rank's output shard (gstx/cli/generate.py:255-261)
        root, ext = os.path.splitext(save_name)
        save_name = f"{root}.proc{proc_idx}{ext}"
    out_path = os.path.join(config.save_path, save_name)

    # preemption recovery (the reference loses the whole chunk,
    # generate.py:258): completed batches append to a JSONL sidecar; a
    # restart resumes at the first unfinished batch
    sidecar = out_path + ".partial.jsonl" \
        if config.flush_every > 0 and writer else None
    meta = _sidecar_meta(config, proc_idx, proc_count, len(dataset),
                         dev.type)
    start_batch, recovered = 0, []
    if sidecar and config.resume_generation:
        start_batch, recovered = _load_sidecar(sidecar, meta)
        if start_batch:
            print(f"[generate] resuming at batch {start_batch} "
                  f"({sum(len(b) for b in recovered)} dialogs recovered)")
    if tp is not None:
        # the writer's resume point for the whole model group
        start_batch = int(tp.broadcast(torch.tensor([start_batch]))[0])
    if sidecar:
        # rewrite the sidecar as exactly the recovered prefix (drops a torn
        # tail, stamps the meta of a fresh run) through a temp file: a
        # second preemption during the rewrite must not truncate the
        # progress it is re-serialising
        tmp = sidecar + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps({"meta": meta}) + "\n")
            for b, recs in enumerate(recovered):
                f.write(json.dumps({"batch": b, "records": recs}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, sidecar)
    gen_data = [rec for recs in recovered for rec in recs]
    flush_buf = []

    def flush_sidecar():
        if sidecar is None or not flush_buf:
            return
        with open(sidecar, "a") as f:
            for b, recs in flush_buf:
                f.write(json.dumps({"batch": b, "records": recs}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        flush_buf.clear()

    t0 = time.time()
    roll_state = [t0, 0]  # rolling-window rate
    pending = []  # dispatched batches not yet drained to the host
    # this run's images, generated non-PAD tokens and abnormal samples
    totals = {"images": 0, "tokens": 0, "abnormal": 0}
    pin = dev.type == "cuda"

    def prepare(idx, batch):
        """Host work, on the prefetch thread under -host_prefetch: pad,
        cast, pin, and the bucketed engine's initial width from the host
        lengths.  A bf16 engine casts the region features to bf16 here
        (the rounding the device would do, bitwise), halving the upload."""
        # a rank computes on one device: its data axis is 1, so nothing
        # is padded
        batch, n_valid = pad_batch_rows(batch, 1)
        host = {}
        for k in ENGINE_KEYS:
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if bf16 and k in ("enc_image_feat", "enc_image_loc") \
                    and t.dtype == torch.float32:
                t = t.to(torch.bfloat16)
            host[k] = t.pin_memory() if pin else t
        init_max = int((np.asarray(batch["enc_input_ids"]) != 0)
                       .sum(-1).max())
        return idx, batch, n_valid, host, init_max

    def dispatch(idx, batch, n_valid, host, init_max):
        with profiling.span("gstx:dispatch_rounds"):
            dev_batch = {k: v.to(dev, non_blocking=True)
                         for k, v in host.items()}
            out = engine(q_model, a_model, dev_batch,
                         batch_generator(config.seed, idx, dev),
                         init_max=init_max)
        pending.append((idx, batch, n_valid, out))

    def drain():
        idx, batch, n_valid, out = pending.pop(0)
        with profiling.span("gstx:fetch_results"):
            questions = out.questions.cpu().numpy()[:, :n_valid]
            answers = out.answers.cpu().numpy()[:, :n_valid]
            ppls = out.answer_ppl.float().cpu().numpy()[:, :n_valid]
            abnormal = out.abnormal.cpu().numpy()[:n_valid]
        image_ids = np.asarray(batch["image_id"])[:n_valid, 0]
        totals["images"] += n_valid
        totals["tokens"] += int((questions != 0).sum() + (answers != 0).sum())
        totals["abnormal"] += int(abnormal.sum())
        with profiling.span("gstx:generate.collect"):
            collect(idx, image_ids, questions, answers, ppls, abnormal)

    def collect(idx, image_ids, questions, answers, ppls, abnormal):
        batch_records = []
        for j in range(len(image_ids)):
            if abnormal[j]:
                continue  # generate.py:236-237
            img_id = int(image_ids[j])
            url = image_id_to_url.get(str(img_id), "")
            cap = url_to_cap.get(url, "")
            batch_records.append({
                "image_id": img_id,
                "url": url,
                "caption": cap,
                "dialog": [
                    {
                        "question": tokenizer.decode(
                            [int(t) for t in questions[r, j]],
                            skip_special_tokens=True),
                        "answer": tokenizer.decode(
                            [int(t) for t in answers[r, j]],
                            skip_special_tokens=True),
                        "answer_ppl": float(ppls[r, j]),
                    }
                    for r in range(config.num_dialog_rounds)
                ],
            })
        gen_data.extend(batch_records)
        if sidecar is not None:
            flush_buf.append((idx, batch_records))
            if len(flush_buf) >= config.flush_every:
                flush_sidecar()
        if idx % 10 == 0:
            now = time.time()
            done = (idx + 1 - start_batch) * config.batch_size
            rate = done / (now - t0)
            roll = ((done - roll_state[1]) / (now - roll_state[0])
                    if idx else rate)
            print(f"[generate] {done} images, {rate:.1f} img/s "
                  f"(last window {roll:.1f})")
            roll_state[0], roll_state[1] = now, done

    depth = max(1, config.pipeline)

    def batches():
        for idx, batch in enumerate(loader.epoch(0, start_batch=start_batch),
                                    start=start_batch):
            if max_batches is not None and idx >= max_batches:
                return
            yield idx, batch

    if config.host_prefetch:
        prepared = _prefetch(batches(), prepare, depth)
    else:
        prepared = (prepare(i, b) for i, b in batches())
    # closing(): _prefetch's worker shutdown lives in its finally, which an
    # abandoned generator reaches only when collected; close() runs it on
    # any exit, an engine exception included
    with profiling.trace(config.trace_dir), contextlib.closing(prepared):
        for item in prepared:
            dispatch(*item)
            if len(pending) >= depth:
                drain()
        while pending:
            drain()
    if stats_out is not None:
        stats_out.update(totals, loop_seconds=time.time() - t0)

    if not finalize or not writer:
        # a simulated preemption (the sidecar holds progress), or a rank
        # whose model group's rank 0 writes
        return gen_data
    flush_sidecar()
    # write a temp file and swap it in: a kill during the dump must not
    # leave a torn JSON; the sidecar goes only once the swap has landed
    with open(out_path + ".tmp", "w") as f:
        json.dump(gen_data, f)
    os.replace(out_path + ".tmp", out_path)
    if sidecar is not None and os.path.exists(sidecar):
        os.remove(sidecar)
    print(f"[generate] wrote {len(gen_data)} dialogs to {out_path}")
    return gen_data


if __name__ == "__main__":
    main()
