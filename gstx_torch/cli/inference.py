"""CLI: the interactive demo, the port of ``gstx/cli/inference.py``
(reference ``inference.py:79-186``).

A REPL: it shows a VisDial val image's caption, the user types questions,
and the answerer model decodes replies.  The context grows exactly as in
the dialog engine (the question appended with segment 0, the answer with
segment 1):

    python -m gstx_torch.cli.inference -start_path answerer.ckpt ...

It runs on ``cuda`` unless ``main`` is given ``device="cpu"`` or the
environment sets ``GSTX_PLATFORM=cpu``; without a card it raises.  The
model is built, loaded and (``-dtype bfloat16``) cast to bf16 once per
run; the fused FFN / projection-LayerNorm kernels follow ``-use_pallas``.
One process, as the JAX CLI: ``-data_parallel`` changes nothing (a batch
of one dialog), ``-model_parallel`` > 1 is refused (ROADMAP queue 1 item
9b).

Sampling draws from one ``torch.Generator`` on the device, seeded from
``-seed``; the JAX CLI splits a ``PRNGKey`` per turn, so sampled replies
differ from JAX's.  Greedy ones (``-top_k 1``) agree.
"""

from __future__ import annotations

import pprint

import numpy as np
import torch

from gstx_torch.cli.common import (apply_runtime_flags, build_model,
                                   build_tokenizer, default_device,
                                   load_params, parse_config)
from gstx_torch.core.config import CLS_ID, PAD_ID, SEP_ID
from gstx_torch.data.visdial import VisdialGenDataset
from gstx_torch.decode.dialog_engine import DialogState, append_utterance
from gstx_torch.decode.sampler import (DecodeSettings, init_cache,
                                       sample_sequence)
from gstx_torch.models.encdec import precast_


def main(argv=None, input_fn=input, output_fn=print, max_turns=None,
         device=None):
    """``input_fn(prompt)`` gives each question (EOF, an empty line,
    ``quit`` or ``exit`` ends the session), ``output_fn`` takes each
    transcript line; ``max_turns`` ends it after that many answers.
    ``device``: see :func:`gstx_torch.cli.common.default_device`."""
    config = parse_config(argv, "gstx_torch interactive demo")
    config = config.replace(mode="vd_gen_val")
    dev = default_device(device)
    pprint.pprint(config)
    if not config.start_path:
        raise SystemExit("error: -start_path (the answerer's checkpoint) "
                         "is required")
    apply_runtime_flags(config, dev)

    tokenizer = build_tokenizer(config)
    dataset = VisdialGenDataset(config, tokenizer, mode="vd_gen_val")
    model = load_params(build_model(config, device=dev), config.start_path)
    if config.dtype == "bfloat16":
        precast_(model)
    settings = DecodeSettings(
        max_steps=config.max_dec_len, temperature=config.temperature,
        top_k=config.top_k, top_p=config.top_p, ngram_blocking_size=0,
        fused_sampler=config.fused_sampler)

    item = dataset.__getitem__(0, seed=0)
    output_fn(f"image_id: {int(item['image_id'][0])}")
    output_fn("caption: " + tokenizer.decode(
        [int(t) for t in item["enc_input_ids"]], skip_special_tokens=True))

    def tensor(key, dtype):
        return torch.from_numpy(np.asarray(item[key]))[None].to(dev, dtype)

    ids = tensor("enc_input_ids", torch.long)
    state = DialogState(enc_input_ids=ids,
                        enc_segments=tensor("enc_segments", torch.long),
                        enc_len=(ids != PAD_ID).sum(-1),
                        abnormal=torch.zeros(1, dtype=torch.bool,
                                             device=dev))
    image = {"feat": tensor("enc_image_feat", torch.float32),
             "loc": tensor("enc_image_loc", torch.float32),
             "mask": tensor("enc_image_mask", torch.float32)}
    generator = torch.Generator(device=dev).manual_seed(config.seed)

    @torch.no_grad()
    def answer(state):
        att = (state.enc_input_ids != PAD_ID).long()
        mem_kv, mem_mask = model.decode_prepare(
            state.enc_input_ids, image["feat"], image["loc"],
            state.enc_segments, att, image["mask"])

        def step_fn(tok, pos, caches):
            return model.decode_step(tok, pos, caches, mem_kv, mem_mask)

        caches = init_cache(model.dec_config, 1, settings.max_steps + 1,
                            model.dtype, dev)
        return sample_sequence(step_fn, generator, 1, caches, settings,
                               bos_id=CLS_ID, eos_id=SEP_ID, device=dev)

    q_cap = min(config.max_utt_len - 2, config.max_dec_len - 1)
    turns = 0
    while True:
        try:
            line = input_fn("you: ")
        except EOFError:
            break
        if not line or line.strip() in ("quit", "exit"):
            break
        q_ids = tokenizer.encode(line.strip())[:q_cap] + [SEP_ID]
        q = torch.zeros((1, config.max_dec_len), dtype=torch.long)
        q[0, :len(q_ids)] = torch.tensor(q_ids)
        state, _ = append_utterance(
            state, q.to(dev), torch.tensor([len(q_ids)], device=dev),
            segment=0, write_segments=False)
        ans = answer(state)
        output_fn("bot: " + tokenizer.decode(
            ans[0].tolist(), skip_special_tokens=True))
        ans_wo_eos = torch.where(ans == SEP_ID, PAD_ID, ans)
        state, _ = append_utterance(state, ans_wo_eos,
                                    (ans_wo_eos != PAD_ID).sum(-1),
                                    segment=1, write_segments=True)
        if bool(state.abnormal[0]):
            output_fn("[context full — restarting would be needed]")
            break
        turns += 1
        if max_turns is not None and turns >= max_turns:
            break


if __name__ == "__main__":
    main()
