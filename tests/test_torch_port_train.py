"""Generative training in the port (gstx_torch.train, the kernels under
autograd, dropout and recomputation in the models, the training CLI)
against the JAX package, f32 on the CPU.

The JAX side is computed once per module: ``jax.value_and_grad`` of
``score`` + ``teacher_forced_loss`` on fixed rows and one ``make_optimizer``
update, not a jitted train step.  Tolerances:

  * the kernels' Functions: gradients within 1e-5 of each tensor's max |g|;
  * one step: loss within 1e-5 relative, each gradient within 1e-4 of its
    max |g|, the parameters after the update within 1e-5;
  * the optimizer over 5 steps: within 1e-6 of each parameter's max |p|;
  * port-internal: the remat policies within 1e-6 of no remat (dropout
    0.1), a resumed run equal to the uninterrupted one bit for bit, and a
    port-written checkpoint's logits in JAX within 1e-4.
"""

import copy
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_harness import assert_rel
from fixtures import (init_tiny_params, make_cc12m_dialog_json, make_cli_env,
                      make_train_rows_batch, tiny_enc_dec_configs)
from gstx.core.checkpoint import convert_torch_state_dict, \
    load_torch_checkpoint
from gstx.data import visdial as jvisdial
from gstx.data.feature_store import make_synthetic_store
from gstx.data.tokenizer import BertTokenizer as JTokenizer
from gstx.kernels.ffn import fused_dense_ln as jax_fused_dense_ln
from gstx.kernels.ffn import fused_ffn as jax_fused_ffn
from gstx.models.encdec import GSTVisualDialog as JGST
from gstx.models.encdec import teacher_forced_loss as jax_loss
from gstx.train import optim as joptim
from gstx.train.train_gen import select_rows as jax_select_rows
from gstx_torch.cli import train_gen as cli
from gstx_torch.core import checkpoint as tckpt
from gstx_torch.core import config as tcfg
from gstx_torch.core.checkpoint import state_dict_from_jax
from gstx_torch.data import visdial as tvisdial
from gstx_torch.data.tokenizer import BertTokenizer as TTokenizer
from gstx_torch.kernels import ffn as kffn
from gstx_torch.models import layers
from gstx_torch.models.encdec import GSTVisualDialog, precast_, \
    teacher_forced_loss
from gstx_torch.models.layers import Training
from gstx_torch.train import optim as toptim
from gstx_torch.train import train_gen as ttrain
from test_reference_data_parity import _PTTAdamW

KERNEL_GRAD_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
OPTIM_TOL = 1e-6
REMAT_TOL = 1e-6
LOGIT_TOL = 1e-4
LR = 2e-5


def torch_configs(enc, dec):
    return (tcfg.EncoderConfig(**dataclasses.asdict(enc)),
            tcfg.DecoderConfig(**dataclasses.asdict(dec)))


def port_model(enc, dec, np_params, **kw):
    model = GSTVisualDialog(*torch_configs(enc, dec), device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(np_params), strict=True)
    return model


def _rows(enc, seed=0):
    """Fixed rows: select_rows of a [4, 3, 1] batch at fixed indices."""
    batch = make_train_rows_batch(enc, seed=seed)
    idx = np.array([0, 5, 5, 11, 2, 7], np.int64)
    return batch, idx, ttrain.select_rows(batch, idx)


def _jax_loss_fn(model):
    def loss_fn(params, r):
        logits = model.apply(
            params, r["enc_input_ids"], r["enc_image_feat"],
            r["enc_image_loc"], r["enc_segments"], r["enc_att_mask"],
            r["enc_image_mask"], r["dec_input_ids"], r["dec_att_mask"],
            deterministic=True, method=JGST.score)
        return jax_loss(logits, r["dec_labels"])
    return loss_fn


def _jrows(rows):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                           else v) for k, v in rows.items()}


@pytest.fixture(scope="module", params=[(0, 0), (1, 1)],
                ids=["all_layers", "frozen_prefix"])
def step_ref(request):
    """The JAX side of one f32 step on fixed rows: loss, gradients and the
    parameters after one make_optimizer update (lr 2e-5, no warmup), with
    the frozen prefixes ``(fixed_t_layer, fixed_v_layer)``."""
    fixed_t, fixed_v = request.param
    enc, dec = tiny_enc_dec_configs()
    enc = dataclasses.replace(enc, fixed_t_layer=fixed_t,
                              fixed_v_layer=fixed_v)
    params = init_tiny_params(enc, dec)
    _, _, rows = _rows(enc)
    loss, grads = jax.value_and_grad(_jax_loss_fn(JGST(enc, dec)))(
        params, _jrows(rows))
    opt = joptim.make_optimizer(LR, LR, warmup_steps=0, t_total=100,
                                fixed_t_layer=fixed_t, fixed_v_layer=fixed_v)
    updates, _ = opt.update(grads, opt.init(params), params)
    new = optax.apply_updates(params, updates)
    return dict(enc=enc, dec=dec, np_params=jax.device_get(params),
                rows=rows, loss=float(loss),
                grads=state_dict_from_jax(jax.device_get(grads)),
                new=state_dict_from_jax(jax.device_get(new)))


# ---------------------------------------------------------------------- #
# the kernels under autograd
# ---------------------------------------------------------------------- #


def _ffn_inputs(m, d, f, seed):
    r = np.random.RandomState(seed)
    return [r.randn(m, d).astype(np.float32),
            (r.randn(d, f) / np.sqrt(d)).astype(np.float32),
            (0.1 * r.randn(f)).astype(np.float32),
            (r.randn(f, d) / np.sqrt(f)).astype(np.float32),
            (0.1 * r.randn(d)).astype(np.float32),
            (1 + 0.1 * r.randn(d)).astype(np.float32),
            (0.1 * r.randn(d)).astype(np.float32)]


def _dense_ln_inputs(m, din, d, seed):
    r = np.random.RandomState(seed)
    return [r.randn(m, din).astype(np.float32),
            (r.randn(din, d) / np.sqrt(din)).astype(np.float32),
            (0.1 * r.randn(d)).astype(np.float32),
            r.randn(m, d).astype(np.float32),
            (1 + 0.1 * r.randn(d)).astype(np.float32),
            (0.1 * r.randn(d)).astype(np.float32)]


# argument positions holding a JAX [in, out] kernel, a torch [out, in] weight
_WEIGHTS = {"ffn": (1, 3), "dense_ln": (1,)}


@pytest.mark.parametrize("kind,m", [("ffn", 40), ("ffn", 128),
                                    ("dense_ln", 40), ("dense_ln", 128)])
def test_function_grads_match_jax_vjp(kind, m):
    """The autograd.Function's value and gradients (CPU: the plain forward,
    the f32 recompute backward) against jax.vjp of the JAX package's fused
    kernel in interpret mode (its custom_vjp), for every input."""
    if kind == "ffn":
        args = _ffn_inputs(m, 128, 256, seed=m)
        jfn = lambda *a: jax_fused_ffn(*a, block_m=64, interpret=True)
        tfn = kffn.fused_ffn
    else:
        args = _dense_ln_inputs(m, 256, 128, seed=m)
        jfn = lambda *a: jax_fused_dense_ln(*a, block_m=64, interpret=True)
        tfn = kffn.fused_dense_ln
    cot = np.random.RandomState(m + 1).randn(m, 128).astype(np.float32)
    want, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    want_g = vjp(jnp.asarray(cot))
    t_args = [torch.from_numpy(a.T.copy() if i in _WEIGHTS[kind] else a)
              .requires_grad_(True) for i, a in enumerate(args)]
    out = tfn(*t_args)
    out.backward(torch.from_numpy(cot))
    assert_rel(out.detach(), want, KERNEL_GRAD_TOL, "value")
    for i, (t, g) in enumerate(zip(t_args, want_g)):
        g = np.asarray(g).T if i in _WEIGHTS[kind] else np.asarray(g)
        assert_rel(t.grad, g, KERNEL_GRAD_TOL, f"grad {i}")


def test_ffn_backward_does_not_round_the_hidden():
    """The FFN's forward rounds the hidden to x's dtype; its backward
    differentiates the unrounded f32 math, as the JAX package's does."""
    args = [torch.from_numpy(a) for a in _ffn_inputs(8, 128, 128, 3)]
    args[1], args[3] = args[1].t().contiguous(), args[3].t().contiguous()
    x = args[0].to(torch.bfloat16).requires_grad_(True)
    w1 = args[1].to(torch.bfloat16).requires_grad_(True)
    w2 = args[3].to(torch.bfloat16)
    bf_args = [x, w1, args[2], w2] + args[4:]
    kffn.fused_ffn(*bf_args).float().sum().backward()
    want_x, want_w1 = torch.autograd.grad(
        kffn.ffn_recompute(x, w1, args[2], w2, *args[4:], 1e-12)
        .float().sum(), [x, w1])
    assert torch.equal(x.grad, want_x) and torch.equal(w1.grad, want_w1)
    assert x.grad.dtype == w1.grad.dtype == torch.bfloat16


# ---------------------------------------------------------------------- #
# one training step against JAX
# ---------------------------------------------------------------------- #


def _port_step(ref):
    """The port's loss and gradients on the reference rows.  Deterministic
    on both sides: the fusion's dropout is a fixed 0.1 in both packages
    (``gstx/models/encdec.py:85``), and their masks differ."""
    model = port_model(ref["enc"], ref["dec"], ref["np_params"])
    rows = ttrain.rows_to_device(ref["rows"], "cpu")
    loss = ttrain.row_loss(model, rows, None)
    loss.backward()
    return model, loss.detach()


def test_one_step_loss_and_grads_match_jax(step_ref):
    model, loss = _port_step(step_ref)
    assert abs(float(loss) - step_ref["loss"]) <= \
        LOSS_TOL * abs(step_ref["loss"])
    enc = step_ref["enc"]
    top = max(float(g.abs().max()) for g in step_ref["grads"].values())
    checked = 0
    for name, p in model.named_parameters():
        if ".biOutput.q_dense" in name:
            continue
        frozen = toptim.is_frozen_param(name, enc.fixed_t_layer,
                                        enc.fixed_v_layer)
        want = step_ref["grads"][name].numpy()
        if frozen:
            # no_grad in the port, stop_gradient (zero) in JAX
            assert p.grad is None and not want.any(), name
            continue
        if re.search(r"\.key\d?\.bias$", name):
            # softmax ignores a shift shared by every key: the exact
            # gradient of a key bias is 0, and both packages' readings are
            # rounding noise, held against the model's largest gradient
            got = p.grad if p.grad is not None else torch.zeros_like(p)
            for g in (got, step_ref["grads"][name]):
                assert float(g.abs().max()) <= 1e-6 * top, name
            continue
        # no gradient where a frozen layer stands between the parameter
        # and the loss; JAX's stop_gradient gives zeros there
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        assert_rel(got, want, GRAD_TOL, name)
        checked += 1
    assert checked > 50


def test_params_after_one_step_match_jax(step_ref):
    model, _ = _port_step(step_ref)
    enc = step_ref["enc"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = toptim.AdamW(model.named_parameters(), LR, LR, 0, 100,
                       fixed_t_layer=enc.fixed_t_layer,
                       fixed_v_layer=enc.fixed_v_layer)
    opt.step()
    for name, got in model.state_dict().items():
        np.testing.assert_allclose(got.numpy(), step_ref["new"][name].numpy(),
                                   rtol=0, atol=PARAM_TOL, err_msg=name)
        if toptim.is_frozen_param(name, enc.fixed_t_layer,
                                  enc.fixed_v_layer):
            assert torch.equal(got, before[name]), name


# ---------------------------------------------------------------------- #
# the optimizer
# ---------------------------------------------------------------------- #


OPT_LRS = (1e-3, 1e-2)  # language, image


@pytest.fixture(scope="module")
def optim_ref():
    """Five make_optimizer updates of the tiny model's tree, every leaf
    drawn N(0, 1), under seeded gradients whose scales span 1e-5 to 1 (the
    eps-before-correction regime included); warmup 2 of t_total 4, so the
    schedule warms up, decays and floors.  The lrs are large enough that a
    wrong eps placement moves a parameter by ~lr."""
    enc, dec = tiny_enc_dec_configs()
    leaves, treedef = jax.tree_util.tree_flatten(init_tiny_params(enc, dec))
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(rs.randn(*np.shape(x)).astype(np.float32))
        for x in leaves])
    grads = [jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray((rs.randn(*np.shape(x)) * 10.0 ** rs.randint(-5, 1))
                    .astype(np.float32)) for x in leaves]) for _ in range(5)]
    opt = joptim.make_optimizer(*OPT_LRS, warmup_steps=2, t_total=4)
    st, p = opt.init(params), params
    traj = []
    for g in grads:
        up, st = opt.update(g, st, p)
        p = optax.apply_updates(p, up)
        traj.append(state_dict_from_jax(jax.device_get(p)))
    return dict(enc=enc, dec=dec, np_params=jax.device_get(params),
                grads=[state_dict_from_jax(jax.device_get(g))
                       for g in grads], traj=traj)


def _set_grads(named, grads):
    for name, p in named:
        p.grad = grads[name].clone()


@pytest.mark.parametrize("oracle", ["jax", "ptt"])
def test_optimizer_trajectory(optim_ref, oracle):
    """Five steps of the port's AdamW against JAX's make_optimizer, and
    against the transcribed pytorch-transformers 1.2.0 AdamW with the
    port's groups and the JAX schedule's lrs (every parameter)."""
    model = port_model(optim_ref["enc"], optim_ref["dec"],
                       optim_ref["np_params"])
    named = toptim.trained_params(model.named_parameters())
    opt = toptim.AdamW(model.named_parameters(), *OPT_LRS, 2, 4)
    if oracle == "ptt":
        twin = copy.deepcopy(model)
        tnamed = toptim.trained_params(twin.named_parameters())
        groups = {}
        for name, p in tnamed:
            key = (toptim.is_language_param(name),
                   0.0 if toptim.is_no_decay_param(name) else 0.01)
            groups.setdefault(key, []).append(p)
        ptt = _PTTAdamW([{"params": ps, "lr": 0.0, "weight_decay": wd,
                          "language": lang}
                         for (lang, wd), ps in groups.items()], lr=0.0)
    for step, grads in enumerate(optim_ref["grads"]):
        _set_grads(named, grads)
        opt.step()
        if oracle == "jax":
            want = optim_ref["traj"][step]
            got = dict(model.state_dict())
        else:
            for g in ptt.param_groups:
                g["lr"] = float(joptim.warmup_linear_nonzero(
                    OPT_LRS[0] if g["language"] else OPT_LRS[1], 2,
                    4)(step))
            _set_grads(tnamed, grads)
            ptt.step()
            want = {k: v.numpy() for k, v in twin.state_dict().items()}
            got = dict(model.state_dict())
        for name, p in named:
            assert_rel(got[name], want[name], OPTIM_TOL,
                        f"step {step} {name}")


def test_schedule_matches_jax():
    for base, warm, total in [(2e-5, 3, 10), (2e-4, 0, 7), (1e-3, 5, 5)]:
        want = joptim.warmup_linear_nonzero(base, warm, total, 1e-5)
        got = toptim.warmup_linear_nonzero(base, warm, total, 1e-5)
        for step in range(0, 14):
            assert got(step) == float(want(step)), (base, warm, step)


def test_group_and_decay_verdicts_match_jax_for_every_param():
    """Each JAX leaf filled with its own marker value: the bridge maps it
    to its torch names, and the port's predicates on those names give the
    JAX predicates' verdicts on the leaf's path."""
    enc, dec = tiny_enc_dec_configs()
    enc = dataclasses.replace(enc, fixed_t_layer=2, fixed_v_layer=1)
    params = jax.device_get(init_tiny_params(enc, dec))
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(v), i + 1, np.float32)
                  for i, (_, v) in enumerate(flat)])
    sd = state_dict_from_jax(marked)
    model = port_model(enc, dec, params)
    # a tied parameter is the optimizer's under its first name
    first = {n for n, _ in model.named_parameters()}
    jax_frozen = set()
    for i, (path, _) in enumerate(flat):
        joined = "/" + "/".join(getattr(k, "key", str(k)) for k in path)
        if any(f"/encoder/layer_{n}/" in joined + "/" for n in range(2)) or \
                "/encoder/v_layer_0/" in joined + "/":
            jax_frozen.add(i + 1)
    seen = set()
    for name, t in sd.items():
        if name not in first:
            continue
        marker = int(t.flatten()[0]) if t.numel() else 0
        if marker == 0:
            assert ".biOutput.q_dense" in name, name  # the port's own
            continue
        path = flat[marker - 1][0]
        assert toptim.is_language_param(name) == \
            joptim.is_language_param(path), name
        assert toptim.is_no_decay_param(name) == \
            joptim.is_no_decay_param(path), name
        assert toptim.is_frozen_param(name, 2, 1) == \
            (marker in jax_frozen), name
        seen.add(marker)
    assert seen == set(range(1, len(flat) + 1))
    # the optimizer holds every non-frozen JAX leaf (a fused QKV kernel as
    # its three projections), each parameter once
    opt = toptim.AdamW(model.named_parameters(), 1.0, 2.0, 0, 10,
                       fixed_t_layer=2, fixed_v_layer=1)
    held = [n for g in opt.param_groups for n in g["names"]]
    markers = {int(sd[n].flatten()[0]) for n in held}
    assert markers == set(range(1, len(flat) + 1)) - jax_frozen
    assert len(set(held)) == len(held) == len(
        {id(p) for g in opt.param_groups for p in g["params"]})


# ---------------------------------------------------------------------- #
# the step's pieces
# ---------------------------------------------------------------------- #


def test_select_rows_matches_jax():
    enc, _ = tiny_enc_dec_configs()
    batch = make_train_rows_batch(enc)
    idx = np.array([11, 0, 4, 4, 9], np.int64)
    got = ttrain.select_rows(batch, idx)
    want = jax_select_rows({k: jnp.asarray(v) for k, v in batch.items()},
                           jnp.asarray(idx))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_candidate_sampling_and_zero_candidate_rows():
    enc, _ = tiny_enc_dec_configs()
    batch = make_train_rows_batch(enc)
    labels = np.zeros_like(batch["dec_labels"])
    labels.reshape(12, -1)[7, 2] = 5  # one row with a label
    w = ttrain.candidate_weights(labels)
    cand = (labels.reshape(12, -1).sum(-1) != 0).astype(np.float32)
    np.testing.assert_allclose(
        w.numpy(), np.exp(np.asarray(jnp.log(jnp.maximum(cand, 1e-9)))),
        rtol=1e-6)
    idx = torch.multinomial(w, 64, replacement=True,
                            generator=torch.Generator().manual_seed(0))
    assert bool((idx == 7).all())
    # no candidate: rows drawn uniformly, the loss 0, the step runs
    none = ttrain.candidate_weights(np.zeros_like(batch["dec_labels"]))
    assert bool((none == none[0]).all())
    logits = torch.randn(3, 5, 11)
    assert float(teacher_forced_loss(logits, torch.zeros(3, 5).long())) == 0


def test_loss_matches_jax():
    r = np.random.RandomState(4)
    logits = r.randn(3, 6, 17).astype(np.float32)
    labels = r.randint(0, 4, size=(3, 6))
    want = float(jax_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(teacher_forced_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)


def _dropout_configs(rate=0.1):
    enc, dec = tiny_enc_dec_configs()
    enc = dataclasses.replace(
        enc, hidden_dropout_prob=rate, v_hidden_dropout_prob=rate,
        attention_probs_dropout_prob=rate,
        v_attention_probs_dropout_prob=rate)
    dec = dataclasses.replace(dec, hidden_dropout_prob=rate,
                              attention_probs_dropout_prob=rate)
    return enc, dec


@pytest.fixture(scope="module")
def dropout_model():
    enc, dec = _dropout_configs()
    params = jax.device_get(init_tiny_params(enc, dec))
    return enc, port_model(enc, dec, params)


def _loss_and_grads(model, rows, train):
    model.zero_grad(set_to_none=True)
    loss = ttrain.row_loss(model, rows, train)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in
                         model.named_parameters() if p.grad is not None}


def test_batch_multiply_is_the_mean_of_its_micro_steps(dropout_model):
    enc, model = dropout_model
    batch = make_train_rows_batch(enc, seed=2)
    a = copy.deepcopy(model)
    opt = toptim.AdamW(a.named_parameters(), LR, LR, 0, 100)
    loss = ttrain.make_train_step(a, opt, 5, batch_multiply=2,
                                  remat="small")(
        batch, ttrain.iteration_generator(3, 7))
    gen = ttrain.iteration_generator(3, 7)
    w = ttrain.candidate_weights(batch["dec_labels"])
    losses, sums = [], {}
    for _ in range(2):
        idx = torch.multinomial(w, 5, replacement=True, generator=gen)
        seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
        rows = ttrain.rows_to_device(ttrain.select_rows(batch, idx.numpy()),
                                     "cpu")
        lo, g = _loss_and_grads(model, rows, Training(seed, "small"))
        losses.append(lo)
        for n, v in g.items():
            sums[n] = sums[n] + v if n in sums else v
    assert abs(float(loss) - float(np.mean(np.float32(losses)))) <= 1e-6
    for n, p in a.named_parameters():
        if n in sums:
            torch.testing.assert_close(p.grad, sums[n] / 2, rtol=1e-6,
                                       atol=1e-9)


@pytest.mark.parametrize("policy", ["full", "dots", "small"])
def test_remat_policies_equal_no_remat_with_dropout(dropout_model, policy):
    enc, model = dropout_model
    _, _, rows = _rows(enc, seed=1)
    rows = ttrain.rows_to_device(rows, "cpu")
    want_loss, want = _loss_and_grads(model, rows, Training(11, None))
    got_loss, got = _loss_and_grads(model, rows, Training(11, policy))
    assert abs(got_loss - want_loss) <= REMAT_TOL * abs(want_loss)
    assert got.keys() == want.keys()
    for n in want:
        assert_rel(got[n], want[n], REMAT_TOL, n)
    # dropout really acted: another seed gives another loss
    other, _ = _loss_and_grads(model, rows, Training(12, None))
    assert other != want_loss


def test_dropout_keep_rate_scaling_and_eval(dropout_model):
    enc, model = dropout_model
    train = Training(5)
    x = torch.ones(400, 500)
    y = train.dropout(x, 0.3, site=9)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    assert bool((y[kept] == torch.tensor(1 / 0.7)).all())
    assert torch.equal(y, train.dropout(x, 0.3, site=9))  # (seed, site)
    assert not torch.equal(y, train.dropout(x, 0.3, site=10))
    assert torch.equal(train.dropout(x, 0.0, site=9), x)
    _, _, rows = _rows(enc)
    rows = ttrain.rows_to_device(rows, "cpu")
    with torch.no_grad():
        a = ttrain.row_loss(model, rows, None)
        b = ttrain.row_loss(model, rows, None)
        c = ttrain.row_loss(model, rows, Training(5))
    assert torch.equal(a, b) and not torch.equal(a, c)


def _count_wrappers(monkeypatch):
    calls = {"fused_dense_ln": 0, "fused_ffn": 0}
    for name in calls:
        real = getattr(kffn, name)

        def wrapped(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(kffn, name, wrapped)
    return calls


@pytest.mark.parametrize("train,rate,want", [
    (None, 0.1, 1), (Training(0), 0.0, 1), (Training(0, "small"), 0.0, 1),
    (Training(0), 0.1, 0), (Training(0, "full"), 0.1, 0)],
    ids=["eval", "train_rate0", "train_rate0_small", "train_dropout",
         "train_dropout_full"])
def test_gates_decline_the_kernels_under_dropout(monkeypatch, train, rate,
                                                 want):
    """A bf16 layer at widths the kernels take: each wrapper is called
    once a forward unless the site's dropout is active (the CPU wrappers
    run the plain versions)."""
    calls = _count_wrappers(monkeypatch)
    layer = layers.TransformerLayer(128, 2, 64, 256, attn_dropout=rate,
                                    hidden_dropout=rate)
    layers.number_dropout_sites(layer)
    layer = layer.to(torch.bfloat16)
    x = torch.randn(2, 9, 128).to(torch.bfloat16).requires_grad_(True)
    layer(x, None, train).float().sum().backward()
    assert calls == {"fused_dense_ln": want, "fused_ffn": want}
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


@pytest.mark.parametrize("width", [32, 128])
def test_bf16_compute_over_f32_params_equals_precast(width):
    """GSTVisualDialog(dtype=bf16) over f32 parameters gives the precast_
    model's forward bit for bit (at width 128 through the fused sites'
    plain versions)."""
    enc, dec = tiny_enc_dec_configs()
    if width != 32:
        enc = dataclasses.replace(enc, hidden_size=width,
                                  intermediate_size=2 * width,
                                  v_hidden_size=width,
                                  v_intermediate_size=width,
                                  bi_hidden_size=width)
        dec = dataclasses.replace(dec, hidden_size=width,
                                  intermediate_size=2 * width)
    params = jax.device_get(init_tiny_params(enc, dec))
    compute = port_model(enc, dec, params, dtype=torch.bfloat16)
    cast = precast_(port_model(enc, dec, params))
    assert compute.bert.embeddings.word_embeddings.weight.dtype == \
        torch.float32
    _, _, rows = _rows(enc)
    rows = ttrain.rows_to_device(rows, "cpu")
    with torch.no_grad():
        a = ttrain.row_loss(compute, rows, None)
        b = ttrain.row_loss(cast, rows, None)
        la = compute.score(rows["enc_input_ids"], rows["enc_image_feat"],
                           rows["enc_image_loc"], rows["enc_segments"],
                           rows["enc_att_mask"], rows["enc_image_mask"],
                           rows["dec_input_ids"], rows["dec_att_mask"])
        lb = cast.score(rows["enc_input_ids"], rows["enc_image_feat"],
                        rows["enc_image_loc"], rows["enc_segments"],
                        rows["enc_att_mask"], rows["enc_image_mask"],
                        rows["dec_input_ids"], rows["dec_att_mask"])
    assert torch.equal(la, lb) and torch.equal(a, b)


def test_int8_memory_refuses_training():
    enc, dec = tiny_enc_dec_configs()
    model = port_model(enc, dec, jax.device_get(init_tiny_params(enc, dec)))
    layer = model.dec.layers[0]
    x = torch.randn(2, 4, dec.hidden_size)
    mem = (torch.zeros(2, 4, 3, 8, dtype=torch.int8),) * 2 + \
        (torch.ones(2, 4, 1, 8),) * 2
    with pytest.raises(ValueError, match="deterministic=True"):
        layer._cross_block(x, mem, None, Training(0))


# ---------------------------------------------------------------------- #
# data
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("train"))
    args, jcfg = make_cli_env(tmp)
    cc = os.path.join(tmp, "cc12m") + "/"
    os.makedirs(cc + "iter1")
    data = make_cc12m_dialog_json(cc + "iter1/cc12m_dialogs_0.txt",
                                  num_images=4)
    make_synthetic_store(cc + "cc12m_img_feat_0.store",
                         [d["image_id"] for d in data], num_boxes=12,
                         feat_dim=16, num_classes=11)
    cc_args = ["-cc12m_image_feats", cc, "-cc12m_processed_train", cc]
    return tmp, args, jcfg, cc_args


@pytest.mark.parametrize("model", ["enc_dec_a", "enc_dec_q"])
def test_vd_train_items_match_jax(cli_env, model):
    _, _, jcfg, _ = cli_env
    jcfg = jcfg.replace(model=model)
    tcfg_ = tcfg.GSTConfig(**dataclasses.asdict(jcfg))
    want = jvisdial.VisdialGenDataset(
        jcfg, JTokenizer(vocab_path=jcfg.vocab_path), mode="vd_train")
    got = tvisdial.VisdialGenDataset(
        tcfg_, TTokenizer(vocab_path=tcfg_.vocab_path), mode="vd_train")
    assert len(got) == len(want) == 4
    for index in range(4):
        a = got.__getitem__(index, seed=index + 3)
        b = want.__getitem__(index, seed=index + 3)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------- #
# the CLI: checkpoints, log lines, resume, and JAX reading its files
# ---------------------------------------------------------------------- #

LOG_LINE = re.compile(
    r"^\[\w{3} \d{2} \w{3} \d{2} \d{2}:\d{2}:\d{2}\]\[LR: \d+\.\d{7}\]"
    r"\[Ep: \d+\.\d{2}\]\[Iter: \d+\]\[Time: +\d+\.\d{2}s\]"
    r"\[LM Loss: [-+.\deE]+\]$")


def _train(args, save, extra, max_steps):
    return cli.main(args + ["-save_path", save, "-batch_size", "1",
                            "-num_epochs", "2", "-log_every", "1"] + extra,
                    max_steps=max_steps, device="cpu")


@pytest.fixture(scope="module")
def runs(cli_env):
    """vd_train with dropout 0.1 and remat 'small': 4 steps straight; 2
    steps, then -continue from the rotating checkpoint for 2 more."""
    tmp, args, _, _ = cli_env
    out = {k: os.path.join(tmp, k) for k in ("whole", "first", "resumed")}
    whole = _train(args, out["whole"], ["-mode", "vd_train",
                                        "-save_every_steps", "2"], 4)
    _train(args, out["first"], ["-mode", "vd_train",
                                "-save_every_steps", "2"], 2)
    step_ckpt = os.path.join(out["first"], "vd_train_step.ckpt")
    resumed = _train(args, out["resumed"],
                     ["-mode", "vd_train", "-save_every_steps", "2",
                      "-start_path", step_ckpt, "-continue"], 2)
    return out, whole, resumed, step_ckpt


def test_resumed_run_equals_the_uninterrupted_one(runs):
    out, (m_whole, o_whole), (m_res, o_res), step_ckpt = runs
    assert tckpt.restore_checkpoint(step_ckpt)["step"] == 2
    for k, v in m_whole.state_dict().items():
        assert torch.equal(v, m_res.state_dict()[k]), k
    sa, sb = o_whole.state_dict(), o_res.state_dict()
    assert [g["step"] for g in sa["param_groups"]] == \
        [g["step"] for g in sb["param_groups"]] == [4] * 4
    for i, st in sa["state"].items():
        for k in st:
            assert torch.equal(st[k], sb["state"][i][k]), (i, k)
    a = tckpt.restore_checkpoint(os.path.join(out["whole"], "final.ckpt"))
    b = tckpt.restore_checkpoint(os.path.join(out["resumed"], "final.ckpt"))
    assert a["step"] == b["step"] == 3
    for k, v in a["model_state_dict"].items():
        assert torch.equal(v, b["model_state_dict"][k]), k


def test_cli_writes_the_jax_cli_checkpoint_names_and_log_lines(runs):
    """The JAX CLI's names (``gstx/train/train_gen.py:250-278``): a
    rotating ``{mode}_step.ckpt``, an epoch checkpoint
    ``{mode}_{chunk}_{epoch}.ckpt`` at each epoch boundary but the start,
    ``final.ckpt``; ``log_{mode}.txt`` with its line format, and
    ``metrics.jsonl``."""
    out, _, _, _ = runs
    assert sorted(os.listdir(out["whole"])) == [
        "final.ckpt", "log_vd_train.txt", "metrics.jsonl",
        "vd_train_step.ckpt"]
    # the resumed run starts at iteration 2 of a 4-iteration epoch
    assert sorted(os.listdir(out["resumed"])) == [
        "final.ckpt", "log_vd_train.txt", "metrics.jsonl",
        "vd_train_step.ckpt"]
    lines = [ln for ln in open(os.path.join(out["whole"],
                                            "log_vd_train.txt")).read()
             .splitlines() if ln]
    assert len(lines) == 4 and all(LOG_LINE.match(ln) for ln in lines), lines
    assert [int(re.search(r"Iter: (\d+)", ln).group(1)) for ln in lines] \
        == [0, 1, 2, 3]


def test_cc12m_select_data_trains_and_writes_epoch_checkpoints(cli_env):
    tmp, args, _, cc_args = cli_env
    save = os.path.join(tmp, "cc")
    model, opt = _train(args + cc_args, save,
                        ["-mode", "cc12m_train", "-chunk", "1",
                         "-select_data", "-threshold", "50"], 6)
    assert [g["step"] for g in opt.param_groups] == [6] * 4
    # 4 dialogs at batch 1: epoch 1 begins at iteration 4
    assert sorted(os.listdir(save)) == [
        "cc12m_train_1_1.ckpt", "final.ckpt", "log_cc12m_train.txt",
        "metrics.jsonl"]
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


def test_port_checkpoint_loads_in_jax_with_the_same_logits(runs, cli_env):
    out, (model, _), _, _ = runs
    _, _, jcfg, _ = cli_env
    path = os.path.join(out["whole"], "final.ckpt")
    enc, dec = jcfg.encoder_config(), jcfg.decoder_config()
    tree = convert_torch_state_dict(
        load_torch_checkpoint(path), enc.num_hidden_layers,
        enc.v_num_hidden_layers, len(enc.v_biattention_id),
        dec.num_hidden_layers)
    _, _, rows = _rows(enc)
    want = JGST(enc, dec).apply(
        {"params": tree}, *[_jrows(rows)[k] for k in (
            "enc_input_ids", "enc_image_feat", "enc_image_loc",
            "enc_segments", "enc_att_mask", "enc_image_mask",
            "dec_input_ids", "dec_att_mask")], deterministic=True,
        method=JGST.score)
    loaded = GSTVisualDialog(*torch_configs(enc, dec), device="cpu")
    loaded.load_state_dict(tckpt.read_state_dict(path), strict=True)
    r = ttrain.rows_to_device(rows, "cpu")
    with torch.no_grad():
        got = loaded.score(r["enc_input_ids"], r["enc_image_feat"],
                           r["enc_image_loc"], r["enc_segments"],
                           r["enc_att_mask"], r["enc_image_mask"],
                           r["dec_input_ids"], r["dec_att_mask"])
        live = model.score(r["enc_input_ids"], r["enc_image_feat"],
                           r["enc_image_loc"], r["enc_segments"],
                           r["enc_att_mask"], r["enc_image_mask"],
                           r["dec_input_ids"], r["dec_att_mask"])
    assert torch.equal(got, live)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)


def test_checkpoint_swap_falls_back_to_old(tmp_path):
    enc, dec = tiny_enc_dec_configs()
    model = GSTVisualDialog(*torch_configs(enc, dec), device="cpu")
    opt = toptim.AdamW(model.named_parameters(), LR, LR, 0, 10)
    path = str(tmp_path / "x_step.ckpt")
    tckpt.save_checkpoint(path, model, opt, 3)
    tckpt.save_checkpoint(path, model, opt, 5)
    assert sorted(os.listdir(tmp_path)) == ["x_step.ckpt"]
    os.replace(path, path + ".old")  # a kill between the swap's steps
    assert tckpt.restore_checkpoint(path)["step"] == 5


def test_warm_start_loads_the_encoder_and_seeds_the_lm_head(cli_env):
    """Without -continue only encoder names load; a file without a decoder
    seeds the LM projection from the loaded word table (gstx/train/
    train_gen.py:336-362)."""
    tmp, _, jcfg, _ = cli_env
    enc, dec = jcfg.encoder_config(), jcfg.decoder_config()
    src = GSTVisualDialog(*torch_configs(enc, dec), device="cpu", seed=7)
    pre = "encoder.bert_pretrained."
    path = os.path.join(tmp, "enc_only.ckpt")
    torch.save({"model_state_dict": {
        "bert_pretrained." + k[len(pre):]: v
        for k, v in src.state_dict().items() if k.startswith(pre)}}, path)
    cfg = tcfg.GSTConfig(**dataclasses.asdict(jcfg)).replace(start_path=path)
    model, opt = ttrain.init_model_and_state(cfg, 100, "cpu")
    fusion = model.vlfusion.fc_l.weight.clone()
    assert ttrain.load_start_checkpoint(cfg, model, opt) == (0, False)
    assert torch.equal(model.bert.embeddings.word_embeddings.weight,
                       src.bert.embeddings.word_embeddings.weight)
    assert torch.equal(model.dec.lm_head.decoder.weight,
                       src.bert.embeddings.word_embeddings.weight)
    assert torch.equal(model.vlfusion.fc_l.weight, fusion)
