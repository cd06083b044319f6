"""Adversarial robustness attacks (the port of ``gstx/eval/attacks.py``;
reference ``evaluate_gen_attack.py:28-231`` and ``utils/text_attack.py``):

  * FGSM: one ascent step ``x + eps * sign(grad)`` on the region
    features, the loss being the relevance-weighted mean teacher-forced
    NLL over the candidates of the dense-annotated round
    (``evaluate_gen_attack.py:100-148``);
  * coreference: a dependency-linked word replaced by its most similar
    counter-fitted synonym (cos-sim >= 0.5) in the affected rounds
    (``text_attack.py:58-116``; the reference's ``substitute_word`` crashes
    as written, so the evident intent: split the decoded context on [SEP],
    replace in the segment, re-tokenise);
  * random_token: the eval dataset masks history tokens with
    ``mask_prob``, and a masked LM refills them (``text_attack.py:30-56``):
    the independent attacker of ``-mlm_path``
    (:mod:`gstx_torch.models.mlm`) or the dialog encoder's own MLM head.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gstx_torch.core.config import MASK_ID, PAD_ID, SEP_ID
from gstx_torch.data.encode import list2arraypad
from gstx_torch.eval.rank_gen import make_chunk_scorer
from gstx_torch.models.encdec import (GSTVisualDialog,
                                      derive_labels_and_inputs,
                                      teacher_forced_nll)


@contextlib.contextmanager
def _frozen(model):
    """No parameter of ``model`` asks for a gradient inside the block (the
    kernels' backward then differentiates their inputs only); restored
    after."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def make_fgsm_scorer(model: GSTVisualDialog, epsilon: float = 1.0):
    """``fgsm_scores(chunk, gt_relevance)`` -> [N] f32 candidate
    log-likelihoods after the FGSM perturbation of the chunk's region
    features (``gstx/eval/attacks.py:41-113``); ``chunk`` is a dict of
    device tensors as :func:`gstx_torch.eval.rank_gen.make_chunk_scorer`
    takes it, ``gt_relevance`` [N] on the device.

    The gradient is taken at an f32 leaf that the model casts to its
    activation dtype inside, and the step is taken in f32, as JAX perturbs
    its f32 ``enc_image_feat``: a step after a bf16 cast would round
    ``x + 1``.  A row of relevance 0 has a zero gradient, and
    ``sign(0) == 0`` leaves it unperturbed.  ``fgsm_scores.nll_grad
    (image_feat, chunk, gt_relevance)`` is that input gradient, the
    quantity the step's sign reads."""
    score_chunk = make_chunk_scorer(model)

    def nll_loss(image_feat, chunk, gt_relevance):
        labels, dec_inputs = derive_labels_and_inputs(
            chunk["dec_input_ids"], SEP_ID, PAD_ID)
        logits = model.score(
            chunk["enc_input_ids"], image_feat, chunk["enc_image_loc"],
            chunk["enc_segments"], chunk["enc_att_mask"],
            chunk["enc_image_mask"], dec_inputs, chunk["dec_att_mask"])
        # the mean over every position, pads included (reference :127)
        per_sample = teacher_forced_nll(logits, labels, PAD_ID,
                                        model.vocab_tp).mean(-1)
        return (per_sample * gt_relevance.float()).sum()

    def nll_grad(image_feat, chunk, gt_relevance):
        with torch.enable_grad(), _frozen(model):
            feat = image_feat.detach().float().requires_grad_(True)
            (grad,) = torch.autograd.grad(
                nll_loss(feat, chunk, gt_relevance), feat)
        return grad

    def fgsm_scores(chunk, gt_relevance):
        feat = chunk["enc_image_feat"].float()
        grad = nll_grad(feat, chunk, gt_relevance)
        return score_chunk(dict(chunk, enc_image_feat=feat
                                + epsilon * torch.sign(grad)))

    fgsm_scores.nll_grad = nll_grad
    return fgsm_scores


def _argmax_ids(logits: torch.Tensor) -> np.ndarray:
    """The argmax over the vocab of an MLM's logits, taken on their device
    (the first of tied maxima, as numpy's), as host ids."""
    return logits.argmax(-1).cpu().numpy()


class TextAttack:
    """Host-side text attacks (``gstx/eval/attacks.py:116-216``,
    text_attack.py:13-116), re-tokenising through the port's tokenizer."""

    def __init__(self, tokenizer, cos_sim: Optional[np.ndarray] = None,
                 cos_sim_idx2word: Optional[dict] = None,
                 cos_sim_word2idx: Optional[dict] = None,
                 mlm_fill: Optional[Callable] = None,
                 max_seq_len: int = 256):
        self.tokenizer = tokenizer
        self.cos_sim = cos_sim
        self.idx2word = cos_sim_idx2word
        self.word2idx = cos_sim_word2idx
        self.mlm_fill = mlm_fill
        self.max_seq_len = max_seq_len

    def random_token_attack(self, input_ids: np.ndarray,
                            token_type_ids: np.ndarray,
                            attention_mask: np.ndarray,
                            image: Optional[Dict] = None) -> np.ndarray:
        """Refill the [MASK]ed history tokens with the MLM's argmax; every
        candidate row shares the context, so row 0 is predicted and
        repeated (text_attack.py:30-56)."""
        batch_size = input_ids.shape[0]
        masked = np.array(input_ids[:1])
        if self.mlm_fill is None:
            return np.array(input_ids)
        logits = self.mlm_fill(masked, token_type_ids[:1],
                               attention_mask[:1], image)
        mask_pos = masked == MASK_ID
        if mask_pos.any():
            masked[mask_pos] = _argmax_ids(logits)[mask_pos]
        return np.repeat(masked, batch_size, axis=0)

    def coreference_attack(self, input_ids: np.ndarray,
                           sep_indices: np.ndarray,
                           coref_dependency: Dict) -> np.ndarray:
        """Synonym-substitute the dependency-linked words in the affected
        rounds (text_attack.py:58-91)."""
        batch_size = input_ids.shape[0]
        if not coref_dependency:
            return np.array(input_ids)
        unit = np.array(input_ids[:1])
        for k, target_word in coref_dependency.items():
            target_round = int(k)
            if self.word2idx is None or target_word not in self.word2idx:
                continue
            synonyms, _ = self.pick_most_similar_words_batch(
                [self.word2idx[target_word]], self.cos_sim, self.idx2word)
            if not synonyms[0]:
                continue
            synonym = synonyms[0][0]
            if target_round == 0:
                unit = self._substitute(unit, target_word, synonym, 0)
            else:
                unit = self._substitute(unit, target_word, synonym,
                                        target_round * 2 - 1)
                unit = self._substitute(unit, target_word, synonym,
                                        target_round * 2)
        return np.repeat(unit, batch_size, axis=0)

    def _substitute(self, unit_input_ids: np.ndarray, target_word: str,
                    synonym_word: str, segment_index: int) -> np.ndarray:
        """The reference substitute_word's intent (text_attack.py:93-100):
        decode, split on [SEP], replace in the segment, re-tokenise with a
        [CLS] prefix and re-pad."""
        ids = [int(t) for t in unit_input_ids[0] if t != PAD_ID]
        text = self.tokenizer.decode(ids, skip_special_tokens=False)
        segments = [s.strip() for s in text.replace("[CLS]", "").split(
            "[SEP]")]
        if segment_index >= len(segments):
            return unit_input_ids
        segments[segment_index] = segments[segment_index].replace(
            target_word, synonym_word)
        rebuilt = ["[CLS]"]
        for seg in (s for s in segments if s != ""):
            rebuilt.extend(self.tokenizer.tokenize(seg))
            rebuilt.append("[SEP]")
        new_ids = self.tokenizer.convert_tokens_to_ids(rebuilt)
        return list2arraypad(new_ids, self.max_seq_len)[None, :]

    @staticmethod
    def pick_most_similar_words_batch(src_words, sim_mat, idx2word,
                                      ret_count: int = 10,
                                      threshold: float = 0.5):
        """text_attack.py:103-116 (TextFooler's synonym lookup)."""
        sim_order = np.argsort(-sim_mat[src_words, :])[:, 1:1 + ret_count]
        sim_words, sim_values = [], []
        for idx, src_word in enumerate(src_words):
            sim_value = sim_mat[src_word][sim_order[idx]]
            mask = sim_value >= threshold
            sim_word = sim_order[idx][mask]
            sim_words.append([idx2word[i] for i in sim_word])
            sim_values.append(sim_value[mask])
        return sim_words, sim_values


def make_mlm_fill(model: GSTVisualDialog):
    """The refill callable of the dialog encoder's own MLM head
    (``gstx/eval/attacks.py:219-237``), conditioned on the image: numpy
    ids, segments and mask, and ``image`` (``feat`` / ``loc`` / ``mask``
    device tensors of the chunk, row 0 used) -> [1, L, vocab] f32 logits
    on the model's device."""

    def fill(input_ids, token_type_ids, attention_mask, image):
        dev = model.device
        ids, seg, att = (torch.from_numpy(np.asarray(a)).to(dev)
                         for a in (input_ids, token_type_ids,
                                   attention_mask))
        with torch.no_grad():
            # the whole vocab, gathered under a sharded one
            return model.full_logits(model.pretrain_scores(
                ids, image["feat"][:1], image["loc"][:1], seg, att,
                image["mask"][:1])[0])

    return fill
