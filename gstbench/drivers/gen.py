"""Synthetic dialog generation: the GST engine of ``gstx_torch`` over a
CC12M-style chunk, a questioner and a teacher of their own seeded weights.

Set-up writes the chunk (``mix["images"]`` images, captions of
``mix["caption_words"]`` words), builds the program's dataset, loader and
engine from the mix's CLI flags as ``gstx_torch.cli.generate`` does, and
runs one batch.  The window then runs whole batches, cycling the chunk,
through the CLI's host prefetch and its dispatch / drain pipeline, each
batch sampling from the CLI's per-batch generator.  A batch that could not
finish inside the window is not started.

The check: a sample of the window's dialogs drawn from the seed, the
longest among them, against the reference, round by round: every sampled
question and answer token must lie within the reference's top-k (after
temperature, and n-gram blocking for questions) of the uncached forward,
and each answer's perplexity must match the reference's.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time

import numpy as np
import torch

from gstbench import peaks, synth, weights
from gstbench.drivers import argv, program_model
from gstbench.reference import inputs as ref_inputs
from gstbench.reference import model as ref_model
from gstbench.trace import span

PAD, CLS, SEP = 0, 101, 102


class Run:
    def __init__(self, config, mix, seed, device, tmp, fault=None,
                 control=None):
        self.config, self.mix, self.seed = config, mix, seed
        self.dev, self.tmp = device, tmp
        self.fault, self.control = fault, control

    # ------------------------------------------------------------------ #
    def setup(self):
        from gstx_torch.cli.common import (apply_runtime_flags,
                                           build_tokenizer, parse_config)
        from gstx_torch.data.cc12m import CC12mDataset
        from gstx_torch.data.loader import DataLoader

        mix = self.mix
        self.corpus = synth.cc12m(self.tmp, weights.seed_for(self.seed, 1),
                                  mix)
        cfg = parse_config(argv(mix["flags"], {
            "-vocab_path": self.corpus.paths["vocab"],
            "-cc12m_image_feats": self.corpus.paths["store"],
            "-cc12m_caption": self.corpus.paths["captions"],
            "-save_path": self.tmp, "-seed": self.seed}))
        apply_runtime_flags(cfg, self.dev)
        self.cfg = cfg
        dataset = CC12mDataset(cfg, build_tokenizer(cfg), mode="cc12m_gen")
        self.loader = DataLoader(dataset, batch_size=cfg.batch_size,
                                 shuffle=False, drop_last=False,
                                 num_workers=cfg.num_workers, seed=cfg.seed)
        self.models = []
        for purpose in (2, 3):
            w = weights.make(self.config, self.seed, purpose, self.dev,
                             mix["eos_bias"])
            self.models.append(program_model(self.config, w, self.dev, True))
            del w
        self.engine = self._engine()
        if self.fault == "token":
            self._break_tokens()
        if self.dev.type == "cuda":
            # the kernels' build (a checkout's first run), apart from the
            # batch whose time sets the window's first estimate
            from gstx_torch.kernels import build
            build.library()
        # one batch: warms every shape the window runs
        self.outs, pending = [], []
        t = time.perf_counter()
        self._dispatch(self._prepare(0, next(iter(self.loader.epoch(0)))),
                       pending)
        self._drain(pending)
        self.est_s = time.perf_counter() - t
        self.outs = []

    def _engine(self):
        """The engine as ``gstx_torch.cli.generate`` builds it."""
        from gstx_torch.decode.dialog_engine import make_dialog_engine
        from gstx_torch.decode.sampler import DecodeSettings

        c = self.cfg

        def settings(ngram):
            return DecodeSettings(
                max_steps=c.max_dec_len, temperature=c.temperature,
                top_k=c.top_k, top_p=c.top_p, ngram_blocking_size=ngram,
                fused_sampler=c.fused_sampler)
        return make_dialog_engine(
            num_rounds=c.num_dialog_rounds,
            q_settings=settings(c.ngram_blocking_size),
            a_settings=settings(0),
            dtype=torch.bfloat16 if c.dtype == "bfloat16" else torch.float32,
            context_buckets=c.context_bucket_tuple(),
            dynamic_buckets=c.dynamic_buckets,
            quantize_memory=c.quantize_memory, device=self.dev)

    def _break_tokens(self):
        """The fault of the tests: every sampled token replaced by the next
        id where it is produced."""
        from gstx_torch.decode import sampler

        topk, plain = sampler.sample_token_topk, sampler.sample_token
        v = self.config["decoder"]["vocab_size"]
        sampler.sample_token_topk = lambda *a: (topk(*a) + 1) % v
        sampler.sample_token = lambda *a: (plain(*a) + 1) % v
        self._restore = lambda: (setattr(sampler, "sample_token_topk", topk),
                                 setattr(sampler, "sample_token", plain))

    # the CLI's host batch, dispatch and drain ------------------------- #
    def _prepare(self, idx, batch):
        """``gstx_torch.cli.generate``'s host work: pad, pin, the bf16
        cast of the region features, the initial context width."""
        from gstx_torch.cli.common import pad_batch_rows
        from gstx_torch.cli.generate import ENGINE_KEYS

        batch, n_valid = pad_batch_rows(batch, 1)
        host = {}
        for k in ENGINE_KEYS:
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if self.cfg.dtype == "bfloat16" and t.dtype == torch.float32 \
                    and k in ("enc_image_feat", "enc_image_loc"):
                t = t.to(torch.bfloat16)
            host[k] = t.pin_memory() if self.dev.type == "cuda" else t
        init_max = int((np.asarray(batch["enc_input_ids"]) != 0)
                       .sum(-1).max())
        return idx, batch, n_valid, host, init_max

    def _dispatch(self, item, pending):
        from gstx_torch.cli.generate import batch_generator

        idx, batch, n_valid, host, init_max = item
        with span("engine"):
            dev_batch = {k: v.to(self.dev, non_blocking=True)
                         for k, v in host.items()}
            out = self.engine(self.models[0], self.models[1], dev_batch,
                              batch_generator(self.cfg.seed, idx, self.dev),
                              init_max=init_max)
        pending.append((batch, n_valid, init_max, out))

    def _drain(self, pending):
        batch, n, init_max, out = pending.pop(0)
        with span("fetch"):
            self.outs.append({
                "image": np.asarray(batch["image_id"])[:n, 0] - 1000,
                "q": out.questions.cpu().numpy()[:, :n],
                "a": out.answers.cpu().numpy()[:, :n],
                "ppl": out.answer_ppl.float().cpu().numpy()[:, :n],
                "abnormal": out.abnormal.cpu().numpy()[:n],
                "init_max": init_max})

    def _batches(self, first):
        k, epoch = first, 0
        while True:
            for b in self.loader.epoch(epoch, start_batch=0 if epoch
                                       else first):
                yield k, b
                k += 1
            epoch += 1

    # ------------------------------------------------------------------ #
    def window(self, seconds, tracer):
        from gstx_torch.cli.generate import _prefetch

        depth = max(1, self.cfg.pipeline)
        cap = self.mix["trace_batches"] if tracer is not None else None
        if tracer is not None:
            self._spans(True)
        src = _prefetch(self._batches(1), self._prepare, depth) \
            if self.cfg.host_prefetch else \
            (self._prepare(i, b) for i, b in self._batches(1))
        pending, wait, est, n, times = [], 0.0, self.est_s, 0, []
        if tracer is not None:
            tracer.start()
        t0 = time.perf_counter()
        with contextlib.closing(src):
            while (cap is None or n < cap) and \
                    time.perf_counter() - t0 + est <= seconds:
                tb = time.perf_counter()
                with span("next_batch"):
                    item = next(src)
                wait += time.perf_counter() - tb
                self._dispatch(item, pending)
                n += 1
                if len(pending) >= depth:
                    self._drain(pending)
                est = time.perf_counter() - tb
                times.append(est)
            while pending:
                self._drain(pending)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        elapsed = time.perf_counter() - t0
        if tracer is not None:
            tracer.stop()
            self._spans(False)
        out = self._tally(elapsed, wait)
        out["counters"]["batch_s"] = times
        return out

    def _spans(self, on):
        """The traced run's spans around the engine's calls into each
        model."""
        for m in self.models:
            if on:
                for name, label in (("decode_prepare", "encoder_memory"),
                                    ("decode_step", "decode_step"),
                                    ("decode_logits_cached",
                                     "answer_scoring")):
                    fn = getattr(m, name)
                    setattr(m, name, _spanned(fn, label))
            else:
                for name in ("decode_prepare", "decode_step",
                             "decode_logits_cached"):
                    m.__dict__.pop(name, None)

    def _tally(self, elapsed, wait):
        good = failed = tokens = 0
        flops = 0.0
        for o in self.outs:
            bad = o["abnormal"] | ~np.isfinite(o["ppl"]).all(0)
            good += int((~bad).sum())
            failed += int(bad.sum())
            tokens += int((o["q"] != PAD).sum() + (o["a"] != PAD).sum())
            flops += self._flops(o)
        return {"seconds": elapsed, "units": good, "failed": failed,
                "rates": {"dialogs_per_s": good / elapsed},
                "counters": {"tokens": tokens, "wait_s": wait,
                             "flops": flops, "batches": len(self.outs)}}

    def _flops(self, o) -> float:
        """The matmul operations of one batch, from its shapes and the
        decode steps its tokens took: per round two encoder passes and
        memories at the round's context bucket, the decode steps of the
        question and of the answer (until every row has ended), and the
        answer's scoring pass."""
        enc, dec = self.config["encoder"], self.config["decoder"]
        c = self.cfg
        b = o["q"].shape[1]
        r_ = c.max_regions
        t = c.max_dec_len
        full = c.max_seq_len
        buckets = sorted(x for x in c.context_bucket_tuple() if x < full)
        buckets.append(full)
        total = 0.0
        for rnd in range(c.num_dialog_rounds):
            worst = min(o["init_max"] + (rnd + 1) * 2 * t, full)
            w = next(x for x in buckets if x >= worst) \
                if len(buckets) > 1 else full
            m = r_ + w
            per_model = (peaks.encoder_flops(enc, w, r_)
                         + peaks.fusion_flops(enc, w, r_)
                         + peaks.memory_kv_flops(dec, m))
            steps = sum(_steps(o[k][rnd], t) for k in ("q", "a"))
            total += b * (2 * per_model
                          + steps * peaks.decoder_flops(dec, 1, m, t + 1)
                          + peaks.decoder_flops(dec, t, m, t))
        return total

    def release(self):
        if getattr(self, "_restore", None):
            self._restore()
        self.models = self.engine = self.loader = None
        gc.collect()

    # ------------------------------------------------------------------ #
    def check(self):
        """The sampled dialogs against the reference (see the module's
        docstring).  Under ``control="fp8"`` the readings are those of the
        reference in float8 on the same prompts and tokens: at each
        position it samples a token of its own as the program does (top-k
        at the temperature, after blocking), from a generator seeded by the
        run's seed, and that token's shortfall is read."""
        mix, c = self.mix, self.cfg
        cands = [(i, j) for i, o in enumerate(self.outs)
                 for j in range(len(o["image"])) if not o["abnormal"][j]]
        if not cands:
            return {}
        rng = np.random.RandomState(weights.seed_for(self.seed, 9) % 2**32)

        def size(ij):
            o, j = self.outs[ij[0]], ij[1]
            return int((o["q"][:, j] != PAD).sum() + (o["a"][:, j] != PAD)
                       .sum())
        longest = max(cands, key=size)
        rest = [x for x in cands if x != longest]
        n = min(mix["check"]["dialogs"] - 1, len(rest))
        sample = [longest] + [rest[k] for k in
                              rng.choice(len(rest), n, replace=False)]
        refs, lows = [], []
        for purpose in (2, 3):
            w = weights.make(self.config, self.seed, purpose, self.dev,
                             mix["eos_bias"])
            refs.append(ref_model.Reference(w, self.config["encoder"],
                                            self.config["decoder"]))
            if self.control == "fp8":
                lows.append(ref_model.Reference(w, self.config["encoder"],
                                                self.config["decoder"],
                                                "fp8"))
            del w
        self._low_gen = None
        if lows:
            self._low_gen = torch.Generator(self.dev)
            self._low_gen.manual_seed(weights.seed_for(self.seed, 10))
        topk = ppl = 0.0
        with torch.no_grad(), ref_model.exact_f32():
            for i, j in sample:
                g, p = self._dialog(refs, lows, self.outs[i], j)
                topk, ppl = max(topk, g), max(ppl, p)
        lim = mix["limits"]
        return {"topk_gap": {"value": topk, "limit": lim["topk_gap"]},
                "ppl_gap": {"value": ppl, "limit": lim["ppl_gap"]}}

    def _dialog(self, refs, lows, o, j):
        c, dev = self.cfg, self.dev
        img = o["image"][j]
        f, loc, mask = ref_inputs.image_inputs(
            self.corpus.images.feats[img], self.corpus.images.boxes[img],
            synth.IMAGE_H, synth.IMAGE_W, c.max_regions)
        image = [torch.from_numpy(x)[None].to(dev) for x in (f, loc, mask)]
        cap = self.corpus.captions[img][: self.mix["caption_tokens"]]
        ids, segs = [CLS] + cap + [SEP], [1] * (len(cap) + 2)
        history, topk, ppl = [], 0.0, 0.0
        for rnd in range(c.num_dialog_rounds):
            q, a = o["q"][rnd, j], o["a"][rnd, j]
            g, _ = self._utterance(refs[0], lows[:1], ids, segs, image, q,
                                   history, c.ngram_blocking_size)
            topk = max(topk, g)
            q_app = [int(x) for x in q[: int((q != PAD).sum())]]
            history.append(q_app)
            ids, segs = ids + q_app, segs + [0] * len(q_app)
            g, p = self._utterance(refs[1], lows[1:], ids, segs, image, a,
                                   None, 0, o["ppl"][rnd, j])
            topk, ppl = max(topk, g), max(ppl, p)
            a_wo = np.where(a == SEP, PAD, a)
            a_app = [int(x) for x in a_wo[: int((a_wo != PAD).sum())]]
            ids, segs = ids + a_app, segs + [1] * len(a_app)
        return topk, ppl

    def _utterance(self, ref, low, ids, segs, image, utt, history, ngram,
                   ppl_prog=None):
        """(top-k gap, perplexity gap) of one decoded utterance: each
        token's shortfall below the k-th best logit (over temperature, after
        blocking) of the reference's uncached forward over the context and
        the tokens before it, and |log ppl - log ppl_ref| of an answer."""
        c, dev = self.cfg, self.dev
        t_ids = torch.tensor([ids], device=dev)
        t_seg = torch.tensor([segs], device=dev)
        att = torch.ones_like(t_ids)
        mem, mem_mask = ref.memory(t_ids, t_seg, att, *image)
        n = int(np.argmax(utt == SEP)) + 1 if (utt == SEP).any() \
            else len(utt)
        toks = [int(x) for x in utt[:n]]
        dec_in = torch.tensor([[CLS] + toks[:-1]], device=dev)
        logits = ref.decode_logits(dec_in, torch.ones_like(dec_in), mem,
                                   mem_mask)[0] / c.temperature
        if low:
            lmem, lmask = low[0].memory(t_ids, t_seg, att, *image)
            low_logits = low[0].decode_logits(
                dec_in, torch.ones_like(dec_in), lmem, lmask)[0] \
                / c.temperature
        gap = 0.0
        for i, tok in enumerate(toks):
            row = logits[i].clone()
            if history is not None:
                ban = ref_inputs.banned(history, [CLS] + toks[:i], ngram)
                if ban:
                    row[list(ban)] = -1e9
            kth = torch.topk(row, c.top_k).values[-1]
            if low:
                lrow = low_logits[i].clone()
                if history is not None and ban:
                    lrow[list(ban)] = -1e9
                vals, idx = torch.topk(lrow, c.top_k)
                tok = idx[torch.multinomial(torch.softmax(vals, -1), 1,
                                            generator=self._low_gen)]
            gap = max(gap, float((kth - row[tok]).clamp(min=0)))
        if ppl_prog is None:
            return gap, 0.0
        ans = torch.from_numpy(utt.astype(np.int64))[None].to(dev)
        att_a = (ans != PAD).long()
        inputs = torch.where(ans == SEP, PAD, ans)
        labels = torch.zeros_like(ans)
        labels[:, :-1] = ans[:, 1:]

        def log_ppl(r, m, mm):
            lg = r.decode_logits(inputs, att_a, m, mm)
            nll = -torch.log_softmax(lg, -1).gather(-1, labels[..., None])[
                ..., 0]
            nll = torch.where(labels == PAD, 0.0, nll).sum()
            return float(nll) / max(int((inputs != PAD).sum()), 1)
        want = log_ppl(ref, mem, mem_mask)
        got = log_ppl(low[0], lmem, lmask) if low else \
            math.log(float(ppl_prog))
        return gap, abs(got - want)


def _steps(tokens, t):
    """Decode steps a batch's utterance ran: until every row has emitted
    [SEP] (the sampler's early exit), at most ``t``."""
    ended = tokens == SEP
    lens = np.where(ended.any(-1), ended.argmax(-1) + 1, t)
    return int(lens.max())


def _spanned(fn, label):
    def call(*a, **k):
        with span(label):
            return fn(*a, **k)
    return call
