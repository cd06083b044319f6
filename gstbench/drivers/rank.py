"""VisDial ranking evaluation: ``gstx_torch``'s discriminative
(``evaluate_disc``, NSP probabilities) or generative (``evaluate_gen``,
candidate log-likelihoods) evaluator over a synthetic VisDial v1.0 val
set, chosen by the configuration's ``model``.

Set-up writes the set, builds the program's dataset, loader and model from
the mix's CLI flags as the evaluator CLIs do, casts the model to its
compute dtype once, prepares the first batch and scores one chunk twice.
The window feeds the evaluator whole batches, cycling the set, and starts
no batch that could not finish inside it.  Each chunk's scores are kept as
the evaluator produces them.

The check: a sample of whole rounds (every option of a round) of the
window's batches drawn from the seed, one of them a last round (the
longest sequences), scored again by the reference from the benchmark's own
word ids and region arrays.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from gstbench import peaks, synth, weights
from gstbench.drivers import argv, program_model
from gstbench.reference import inputs as ref_inputs
from gstbench.reference import model as ref_model
from gstbench.trace import span

PAD, SEP = 0, 102


class Run:
    def __init__(self, config, mix, seed, device, tmp, fault=None,
                 control=None):
        self.config, self.mix, self.seed = config, mix, seed
        self.dev, self.tmp = device, tmp
        self.fault, self.control = fault, control
        self.disc = config["model"] == "enc_only"

    # ------------------------------------------------------------------ #
    def setup(self):
        from gstx_torch.cli.common import (apply_runtime_flags,
                                           build_tokenizer, parse_config)
        from gstx_torch.data.loader import DataLoader
        from gstx_torch.data.visdial import (VisdialDiscDataset,
                                             VisdialGenDataset)
        from gstx_torch.eval import rank_disc, rank_gen
        from gstx_torch.models.encdec import precast_

        mix = self.mix
        self.corpus = synth.visdial(self.tmp,
                                    weights.seed_for(self.seed, 1), mix)
        p = self.corpus.paths
        flags = dict(mix["flags"],
                     **{"-model": "enc_only_a" if self.disc else "enc_dec_a"})
        cfg = parse_config(argv(flags, {
            "-vocab_path": p["vocab"], "-visdial_processed_train": p["val"],
            "-visdial_processed_val": p["val"],
            "-visdial_processed_val_dense_annotations": p["dense"],
            "-visdial_image_feats": p["store"], "-save_path": self.tmp,
            "-seed": self.seed}))
        apply_runtime_flags(cfg, self.dev, enc_only=self.disc)
        self.cfg = cfg
        cls = VisdialDiscDataset if self.disc else VisdialGenDataset
        dataset = cls(cfg, build_tokenizer(cfg), mode="vd_eval_val")
        self.loader = DataLoader(dataset, batch_size=mix["batch"],
                                 shuffle=False, drop_last=False,
                                 num_workers=cfg.num_workers)
        w = weights.make(self.config, self.seed, 2, self.dev)
        self.model = program_model(self.config, w, self.dev, not self.disc)
        del w
        if cfg.dtype == "bfloat16":
            precast_(self.model, torch.bfloat16)
        self.chunk = mix["chunk"][self.config["model"]]
        if self.disc:
            self.evaluate, self._mod, self._name = \
                rank_disc.evaluate_disc, rank_disc, "make_nsp_scorer"
            self._flatten = rank_disc.flatten_disc
            self._keys = ("image_feat", "image_loc")
        else:
            self.evaluate, self._mod, self._name = \
                rank_gen.evaluate_gen, rank_gen, "make_chunk_scorer"
            self._flatten = rank_gen.flatten_gen
            self._keys = ("enc_image_feat", "enc_image_loc")
        self._install()
        self.scores, self.batches = [], []
        # the warm chunk is timed before the loader's threads start
        # preparing batches beside it
        warm = DataLoader(dataset, batch_size=mix["batch"], shuffle=False,
                          drop_last=False, num_workers=1)
        self.est_s = self._warm(next(iter(warm.epoch(0))))
        self.scores = []
        # the window's first batch is prepared here; the loader prepares
        # the next ones meanwhile
        self._it = self._cycle()
        self._first = next(self._it)

    def _cycle(self):
        epoch = 0
        while True:
            yield from self.loader.epoch(epoch)
            epoch += 1

    def _install(self):
        """Keep every chunk's scores as the evaluator's scorer returns
        them; the tests' faults break them there."""
        orig = getattr(self._mod, self._name)
        fault = self.fault

        def make(model):
            score = orig(model)

            def recorded(chunk):
                out = score(chunk)
                if fault == "answer":
                    out = out.clone()
                    out[::7] += 0.5
                elif fault == "half":
                    out = out.clone()
                    out[out.shape[0] // 2:] = out[: out.shape[0] // 2].mean()
                self.scores.append(out)
                return out
            return recorded
        setattr(self._mod, self._name, make)
        self._restore = lambda: setattr(self._mod, self._name, orig)

    def _warm(self, batch) -> float:
        """Score the first chunk once, then three times back to back; the
        batch's expected time from the three."""
        from gstx_torch.eval.rank_gen import batch_to_device, chunk_inputs

        text, images, (b, rounds, options) = self._flatten(batch)
        dev_text, dev_images = batch_to_device(text, images, self.dev,
                                               self.model.dtype, self._keys)
        score = getattr(self._mod, self._name)(self.model)
        chunk = chunk_inputs(dev_text, dev_images, 0, self.chunk,
                             rounds * options)
        with torch.inference_mode():
            score(chunk).cpu()
            t = time.perf_counter()
            torch.stack([score(chunk) for _ in range(3)]).cpu()
            dt = (time.perf_counter() - t) / 3
        return dt * b * rounds * options / self.chunk

    # ------------------------------------------------------------------ #
    def window(self, seconds, tracer):
        cap = self.mix["trace_batches"] if tracer is not None else None
        st = {"est": self.est_s, "last": None, "times": []}
        if tracer is not None:
            tracer.start()
        t0 = time.perf_counter()

        def feed():
            first = self._first
            while True:
                now = time.perf_counter()
                if st["last"] is not None:
                    st["est"] = now - st["last"]
                    st["times"].append(st["est"])
                if (cap is not None and len(self.batches) >= cap) or \
                        now - t0 + st["est"] > seconds:
                    return
                st["last"] = now
                with span("next_batch"):
                    b = first if first is not None else next(self._it)
                first = None
                self.batches.append(np.asarray(b["image_id"])[:, 0] - 5000)
                yield b
        with span("evaluate"):
            self.evaluate(self.model, feed(), mode="vd_eval_val",
                          vd_version=self.cfg.vd_version,
                          chunk_size=self.chunk)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        elapsed = time.perf_counter() - t0
        if tracer is not None:
            tracer.stop()
        scores = torch.cat(self.scores).float().cpu().numpy() \
            if self.scores else np.zeros(0)
        self.scores = scores
        finite = np.isfinite(scores)
        good = int(finite.sum())
        enc = self.config["encoder"]
        l, r = self.cfg.max_seq_len, self.cfg.max_regions
        if self.disc:
            per = peaks.encoder_flops(enc, l, r) + peaks.nsp_head_flops(enc)
        else:
            dec, t = self.config["decoder"], self.cfg.max_utt_len
            per = (peaks.encoder_flops(enc, l, r)
                   + peaks.fusion_flops(enc, l, r)
                   + peaks.memory_kv_flops(dec, l + r)
                   + peaks.decoder_flops(dec, t, l + r, t))
        return {"seconds": elapsed, "units": good,
                "failed": int(scores.size - good),
                "rates": {"scored_seqs_per_s": good / elapsed},
                "counters": {"flops": per * scores.size,
                             "batches": len(self.batches),
                             "batch_s": st["times"]}}

    def release(self):
        self._restore()
        self._it.close()
        self.model = self.loader = self._it = self._first = None
        gc.collect()

    # ------------------------------------------------------------------ #
    def check(self):
        """Whole sampled rounds against the reference (see the module's
        docstring); under ``control="fp8"`` the readings are the float8
        reference's."""
        mix, c = self.mix, self.cfg
        rounds, options = mix["rounds"], mix["options"]
        per_dialog = rounds * options
        picks = [(bi, di, rnd) for bi, ids in enumerate(self.batches)
                 for di in range(len(ids)) for rnd in range(rounds)]
        if not picks or self.scores.size < len(self.batches) * \
                mix["batch"] * per_dialog:
            return {}
        rng = np.random.RandomState(weights.seed_for(self.seed, 9) % 2**32)
        last = [p for p in picks if p[2] == rounds - 1]
        first = last[rng.randint(len(last))]
        rest = [p for p in picks if p != first]
        n = min(mix["check"]["rounds"] - 1, len(rest))
        sample = [first] + [rest[k] for k in
                            rng.choice(len(rest), n, replace=False)]
        w = weights.make(self.config, self.seed, 2, self.dev)
        ref = ref_model.Reference(w, self.config["encoder"],
                                  self.config.get("decoder"))
        low = ref_model.Reference(w, self.config["encoder"],
                                  self.config.get("decoder"), "fp8") \
            if self.control == "fp8" else None
        del w
        gap = 0.0
        with torch.no_grad(), ref_model.exact_f32():
            for bi, di, rnd in sample:
                d = int(self.batches[bi][di])
                start = (bi * mix["batch"] + di) * per_dialog + rnd * options
                got = self.scores[start:start + options]
                want = self._reference(ref, d, rnd)
                if low is not None:
                    got = self._reference(low, d, rnd)
                gap = max(gap, float(np.abs(got - want).max()))
        name = "nsp_gap" if self.disc else "ll_gap"
        return {name: {"value": gap, "limit": mix["limits"][name]}}

    def _reference(self, ref, d, rnd) -> np.ndarray:
        """The reference's scores of every option of round ``rnd`` (0-based)
        of dialog ``d``, in the evaluators' order (the ground truth first,
        then the others by index)."""
        c, corpus, dev = self.cfg, self.corpus, self.dev
        dialog = corpus.dialogs[d]
        hist = [dialog["caption"]]
        for k in range(rnd):
            u = dialog["dialog"][k]
            hist += [corpus.questions[u["question"]],
                     corpus.answers[u["answer"]]]
        u = dialog["dialog"][rnd]
        hist.append(corpus.questions[u["question"]])
        gt = u["gt_index"]
        order = [gt] + [k for k in range(100) if k != gt][: c.num_options - 1]
        opts = [corpus.answers[u["answer_options"][k]] for k in order]
        f, loc, mask = ref_inputs.image_inputs(
            corpus.images.feats[d], corpus.images.boxes[d], synth.IMAGE_H,
            synth.IMAGE_W, c.max_regions)
        n = len(opts)
        image = [torch.from_numpy(x)[None].expand(n, *x.shape).to(dev)
                 for x in (f, loc, mask)]
        if self.disc:
            rows = []
            for o in opts:
                utts, start = ref_inputs.recent_rounds(hist + [o],
                                                       c.visdial_tot_rounds)
                rows.append(ref_inputs.pack(utts, c.max_seq_len, start))
            ids = torch.from_numpy(np.stack([r[0] for r in rows])).to(dev)
            segs = torch.from_numpy(np.stack([r[1] for r in rows])).to(dev)
            logits = ref.nsp_logits(ids, segs, (ids != PAD).long(), *image)
            return torch.softmax(logits, -1)[:, 0].cpu().numpy()
        ids, segs = ref_inputs.pack(hist, c.max_seq_len)
        ids = torch.from_numpy(ids)[None].to(dev)
        segs = torch.from_numpy(segs)[None].to(dev)
        mem, mem_mask = ref.memory(ids, segs, (ids != PAD).long(),
                                   *[x[:1] for x in image])
        dec = np.stack([ref_inputs.pack([o[: c.max_utt_len - 2]],
                                        c.max_utt_len)[0] for o in opts])
        dec = torch.from_numpy(dec).to(dev)
        inputs = torch.where(dec == SEP, PAD, dec)
        logits = ref.decode_logits(inputs, (dec != PAD).long(),
                                   mem.expand(n, -1, -1),
                                   mem_mask.expand(n, -1))
        target = torch.zeros_like(dec)
        target[:, :-1] = dec[:, 1:]
        lp = torch.log_softmax(logits, -1).gather(-1, target[..., None])[
            ..., 0]
        return torch.where(target == PAD, 0.0, lp).sum(-1).cpu().numpy()
