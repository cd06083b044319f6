"""Checkpoints: the weight bridge from a JAX ``gstx`` param tree to the
port's state dict, and the loader of checkpoint files.

The port's modules carry the reference PyTorch state-dict names
(``encoder.bert_pretrained.{bert,cls}.*``, ``vlfusion.*``,
``decoder.decoder.{bert,lm_head}.*``), so this is the port's own copy of
the converter ``gstx/core/checkpoint.py::to_torch_state_dict`` (lines
313-458): it splits each fused QKV kernel into query/key/value projections,
transposes Flax ``Dense`` kernels (``[in, out]``) into ``nn.Linear`` weights
(``[out, in]``), and emits the tied duplicates.  Released reference
checkpoints then load with ``load_state_dict(strict=True)``.

The co-attention ``biOutput.q_dense1/q_dense2`` projections exist in the
reference model but are never called in its forward pass.  The port OWNS
those names (as unused ``nn.Linear``s, see
``gstx_torch/models/two_stream.py::BiOutput``), so a reference checkpoint
loads strictly; the bridge fills them with zeros, as the JAX converter does.

Input arrays are numpy (a test calls ``jax.device_get`` on the JAX tree);
nothing here imports JAX.

:func:`load_checkpoint` reads a released reference ``.ckpt`` or the port's
own ``torch.save`` of a state dict into a model.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch

from gstx_torch.core import mesh


def state_dict_from_jax(params: dict, with_decoder: bool = True,
                        enc_prefix: str = "encoder.bert_pretrained"
                        ) -> Dict[str, torch.Tensor]:
    """JAX param tree (nested dicts of numpy arrays) -> float32 state dict
    in the reference layout."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}
    bert = f"{enc_prefix}.bert"
    cls = f"{enc_prefix}.cls"

    def arr(x):
        return np.asarray(x, dtype=np.float32)

    def put_dense(prefix, node):
        sd[f"{prefix}.weight"] = arr(node["kernel"]).T
        sd[f"{prefix}.bias"] = arr(node["bias"])

    def put_ln(prefix, node):
        sd[f"{prefix}.weight"] = arr(node["scale"])
        sd[f"{prefix}.bias"] = arr(node["bias"])

    def put_qkv(prefix, node, names=("query", "key", "value")):
        ks = np.split(arr(node["kernel"]), len(names), axis=1)
        bs = np.split(arr(node["bias"]), len(names), axis=0)
        for name, kk, bb in zip(names, ks, bs):
            sd[f"{prefix}.{name}.weight"] = kk.T
            sd[f"{prefix}.{name}.bias"] = bb

    def put_embeddings(prefix, emb):
        for name in ("word_embeddings", "position_embeddings",
                     "token_type_embeddings",
                     "token_type_embeddings_extension"):
            sd[f"{prefix}.{name}.weight"] = arr(emb[name]["embedding"])
        sd[f"{prefix}.sep_embeddings.weight"] = arr(emb["sep_embeddings"])
        put_ln(f"{prefix}.LayerNorm", emb["ln"])

    enc = p["encoder"]
    put_embeddings(f"{bert}.embeddings", enc["embeddings"])
    put_dense(f"{bert}.v_embeddings.image_embeddings",
              enc["v_embeddings"]["image_embeddings"])
    put_dense(f"{bert}.v_embeddings.image_location_embeddings",
              enc["v_embeddings"]["image_location_embeddings"])
    put_ln(f"{bert}.v_embeddings.LayerNorm", enc["v_embeddings"]["ln"])

    def put_stream(prefix, node):
        put_qkv(f"{prefix}.attention.self", node["attention"]["qkv"])
        put_dense(f"{prefix}.attention.output.dense", node["attention"]["out"])
        put_ln(f"{prefix}.attention.output.LayerNorm",
               node["attention"]["out_ln"])
        put_dense(f"{prefix}.intermediate.dense", node["ffn"]["intermediate"])
        put_dense(f"{prefix}.output.dense", node["ffn"]["output"])
        put_ln(f"{prefix}.output.LayerNorm", node["ffn"]["output_ln"])

    for name, node in enc["encoder"].items():
        m = re.fullmatch(r"(v_|c_)?layer_(\d+)", name)
        if m is None:
            continue
        kind, idx = m.group(1) or "", m.group(2)
        prefix = f"{bert}.encoder.{kind}layer.{idx}"
        if kind != "c_":
            put_stream(prefix, node)
            continue
        put_qkv(f"{prefix}.biattention", node["biattention"]["qkv1"],
                ("query1", "key1", "value1"))
        put_qkv(f"{prefix}.biattention", node["biattention"]["qkv2"],
                ("query2", "key2", "value2"))
        put_dense(f"{prefix}.biOutput.dense1", node["v_dense"])
        put_ln(f"{prefix}.biOutput.LayerNorm1", node["v_ln"])
        put_dense(f"{prefix}.biOutput.dense2", node["t_dense"])
        put_ln(f"{prefix}.biOutput.LayerNorm2", node["t_ln"])
        bi, v_hidden = arr(node["v_dense"]["kernel"]).shape
        hidden = arr(node["t_dense"]["kernel"]).shape[1]
        # never used in the forward pass; zero-filled for a strict load
        sd[f"{prefix}.biOutput.q_dense1.weight"] = np.zeros(
            (v_hidden, bi), np.float32)
        sd[f"{prefix}.biOutput.q_dense1.bias"] = np.zeros(v_hidden,
                                                          np.float32)
        sd[f"{prefix}.biOutput.q_dense2.weight"] = np.zeros(
            (hidden, bi), np.float32)
        sd[f"{prefix}.biOutput.q_dense2.bias"] = np.zeros(hidden, np.float32)
        for side in ("v", "t"):
            ffn = node[f"{side}_ffn"]
            put_dense(f"{prefix}.{side}_intermediate.dense",
                      ffn["intermediate"])
            put_dense(f"{prefix}.{side}_output.dense", ffn["output"])
            put_ln(f"{prefix}.{side}_output.LayerNorm", ffn["output_ln"])

    put_dense(f"{bert}.t_pooler.dense", enc["t_pooler"]["dense"])
    put_dense(f"{bert}.v_pooler.dense", enc["v_pooler"]["dense"])

    heads = p["cls"]
    put_dense(f"{cls}.predictions.transform.dense",
              heads["transform"]["dense"])
    put_ln(f"{cls}.predictions.transform.LayerNorm", heads["transform"]["ln"])
    sd[f"{cls}.predictions.bias"] = arr(heads["mlm_bias"])
    # tied to the word-embedding table
    sd[f"{cls}.predictions.decoder.weight"] = arr(
        enc["embeddings"]["word_embeddings"]["embedding"])
    put_dense(f"{cls}.bi_seq_relationship", heads["bi_seq_relationship"])
    put_dense(f"{cls}.imagePredictions.transform.dense",
              heads["img_transform"]["dense"])
    put_ln(f"{cls}.imagePredictions.transform.LayerNorm",
           heads["img_transform"]["ln"])
    put_dense(f"{cls}.imagePredictions.decoder", heads["img_decoder"])

    if with_decoder and "decoder" in p:
        dec = p["decoder"]
        dbert = "decoder.decoder.bert"
        # the decoder's input embeddings ARE the encoder's (tied module)
        put_embeddings(f"{dbert}.embeddings", enc["embeddings"])
        for name, node in dec.items():
            m = re.fullmatch(r"layer_(\d+)", name)
            if m is None:
                continue
            prefix = f"{dbert}.encoder.layer.{m.group(1)}"
            put_qkv(f"{prefix}.attention.self", node["qkv"])
            put_dense(f"{prefix}.attention.output.dense", node["self_out"])
            put_ln(f"{prefix}.attention.output.LayerNorm", node["self_ln"])
            put_dense(f"{prefix}.crossattention.self.query", node["cross_q"])
            put_qkv(f"{prefix}.crossattention.self", node["cross_kv"],
                    ("key", "value"))
            put_dense(f"{prefix}.crossattention.output.dense",
                      node["cross_out"])
            put_ln(f"{prefix}.crossattention.output.LayerNorm",
                   node["cross_ln"])
            put_dense(f"{prefix}.intermediate.dense", node["intermediate"])
            put_dense(f"{prefix}.output.dense", node["output"])
            put_ln(f"{prefix}.output.LayerNorm", node["output_ln"])
        # independent LM projection; its bias is one tensor under two names
        sd["decoder.decoder.lm_head.decoder.weight"] = arr(dec["lm_weight"])
        sd["decoder.decoder.lm_head.bias"] = arr(dec["lm_bias"])
        sd["decoder.decoder.lm_head.decoder.bias"] = arr(dec["lm_bias"])
        put_dense("vlfusion.fc_l", p["fusion_fc_l"])
        put_dense("vlfusion.fc_v", p["fusion_fc_v"])

    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


# ---------------------------------------------------------------------- #
# loading a checkpoint file into the port's model
# ---------------------------------------------------------------------- #

ENC_PREFIX = "encoder.bert_pretrained"


def _strip_prefixes(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop DataParallel's ``module.`` wrapper (``gstx/core/checkpoint.py``
    ``_strip_prefixes``) and bring an encoder-only checkpoint's names
    (``bert_pretrained.*``, or a bare ``bert.*`` / ``cls.*``) under the
    port's ``encoder.bert_pretrained.*``."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("bert_pretrained."):
            k = "encoder." + k
        elif k.startswith(("bert.", "cls.")):
            k = f"{ENC_PREFIX}.{k}"
        out[k] = v
    return out


def refuse_directory(path: str):
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package?); the port reads torch checkpoint files only.  "
            "Convert it with gstx.core.checkpoint.to_torch_state_dict and "
            "torch.save, or see ROADMAP.md (orbax checkpoints)")


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file's state dict: a released reference ``.ckpt``
    (``{"model_state_dict": ...}``, possibly with DataParallel's
    ``module.`` prefixes) or the port's own ``torch.save`` of a state
    dict.  An orbax checkpoint directory of the JAX package raises."""
    refuse_directory(path)
    # weights_only: tensors and plain containers, no arbitrary objects
    return state_dict_of(torch.load(path, map_location="cpu",
                                    weights_only=True))


def state_dict_of(raw: dict) -> Dict[str, torch.Tensor]:
    """The model state dict of a loaded checkpoint payload (its
    ``model_state_dict``, or the payload itself), names as
    :func:`_strip_prefixes` leaves them."""
    if "model_state_dict" in raw:
        raw = raw["model_state_dict"]
    return _strip_prefixes({k: torch.as_tensor(v) for k, v in raw.items()})


def load_checkpoint(model, path: str) -> str:
    """Load a checkpoint file (:func:`read_state_dict`) into ``model`` in
    place and return its kind, ``"full"`` or ``"encoder"``
    (:func:`load_state`)."""
    return load_state(model, read_state_dict(path), path)


def load_state(model, sd: Dict[str, torch.Tensor], path: str) -> str:
    """Load the state dict ``sd`` of the file ``path`` into ``model`` in
    place and return the file's kind, ``"full"`` (it has decoder weights)
    or ``"encoder"``.

    A full file loads into a full model with ``strict=True``; into an
    encoder-only model (``use_decoder=False``) its encoder part loads,
    strictly over the encoder's names, and its fusion and decoder are
    dropped, as the JAX package's ``load_params`` merges a full file into
    the encoder-only template (``gstx/cli/common.py:202-230``): the
    discriminative trainer starts from a generatively trained
    encoder-decoder.  An encoder-only file loads into an encoder-only
    model with ``strict=True``; into a full model strictly over the
    encoder's names, the fusion and decoder keeping their initial weights
    but the LM projection, seeded from the loaded word embeddings as the
    reference's pretrained init does.
    """
    full = any(k.startswith("decoder.") for k in sd)
    if full == model.use_decoder:
        model.load_state_dict(sd, strict=True)
    else:
        load_encoder_part(model, sd, path, seed_lm_head=not full)
    return "full" if full else "encoder"


def load_encoder_part(model, sd: Dict[str, torch.Tensor], path: str,
                      seed_lm_head: bool):
    """Load the ``encoder.*`` names of ``sd`` into ``model``, strictly over
    the encoder's names (every one present; no name of ``sd`` unknown to
    the model, except the fusion and decoder names of a full file, which an
    encoder-only model drops); the model's fusion and decoder keep their
    weights.  ``seed_lm_head``: copy the loaded word table into a full
    model's LM projection, as the reference's pretrained init does when
    the file has no decoder."""
    own = model.state_dict()
    enc = {k: v for k, v in sd.items() if k.startswith("encoder.")}
    dropped = () if model.use_decoder else ("decoder.", "vlfusion.")
    missing = sorted(k for k in own
                     if k.startswith("encoder.") and k not in enc)
    unknown = sorted(k for k in sd
                     if k not in own and not k.startswith(dropped))
    if missing or unknown:
        raise RuntimeError(
            f"checkpoint {path}: missing encoder names "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''}, unknown "
            f"names {unknown[:5]}{'...' if len(unknown) > 5 else ''}")
    model.load_state_dict(enc, strict=False)
    if not (seed_lm_head and model.use_decoder):
        return
    word = model.bert.embeddings.word_embeddings.weight
    lm = model.dec.lm_head.decoder.weight
    if lm.shape == word.shape:
        with torch.no_grad():
            lm.copy_(word)


# ---------------------------------------------------------------------- #
# training checkpoints
# ---------------------------------------------------------------------- #


def save_checkpoint(path: str, model, optimizer, step: int):
    """Write a training checkpoint as one torch file
    ``{"model_state_dict": <reference names>, "optimizer_state_dict": ...,
    "step": int}`` (the JAX package's ``save_checkpoint``,
    ``gstx/core/checkpoint.py:33-86``, writes an orbax directory instead).
    :func:`read_state_dict` and the JAX package's ``load_torch_checkpoint``
    read its weights.

    Written to ``path.tmp`` first, then swapped in three steps, so that at
    every instant ``path`` or ``path.old`` holds a complete checkpoint
    (:func:`restore_checkpoint` falls back to ``.old``).

    In a multi-process run every rank calls it with the same path on a
    shared file system; the ranks hold the same replica, so rank 0 alone
    writes and swaps, and the others wait at a barrier before and after
    (``gstx/core/checkpoint.py:38-70``): no rank returns before the file
    is complete."""
    path = os.path.abspath(path)
    mesh.barrier()
    if mesh.process_index() == 0:
        _write_checkpoint(path, model, optimizer, step)
    mesh.barrier()


def _write_checkpoint(path, model, optimizer, step):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp, old = path + ".tmp", path + ".old"
    torch.save({"model_state_dict": {k: v.detach().cpu() for k, v in
                                     model.state_dict().items()},
                "optimizer_state_dict": optimizer.state_dict(),
                "step": int(step)}, tmp)
    if os.path.exists(old):
        os.remove(old)
    if os.path.exists(path):
        os.replace(path, old)
    os.replace(tmp, path)
    if os.path.exists(old):
        os.remove(old)


def restore_checkpoint(path: str) -> dict:
    """The payload of a checkpoint file; when a kill landed inside
    :func:`save_checkpoint`'s swap, the surviving previous copy at
    ``.old``."""
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.exists(path + ".old"):
        print(f"[checkpoint] {path} missing after an interrupted swap; "
              "restoring the surviving previous copy at .old")
        path = path + ".old"
    refuse_directory(path)
    return torch.load(path, map_location="cpu", weights_only=True)
