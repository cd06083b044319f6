"""The plain reference against ``gstx_torch`` at a tiny width on the CPU,
in float32, on the benchmark's seeded weights: the NSP logits, the
decoder's memory and teacher-forced logits, and the cached decode step."""

import numpy as np
import pytest
import torch

from gstbench import weights
from gstbench.drivers import program_model
from gstbench.reference import inputs, model
from gstbench.tests import tiny

TOL = 2e-4


def _batch(cfg, b=3, l=20, r=5, seed=0):
    rng = np.random.RandomState(seed)
    ids = np.zeros((b, l), np.int64)
    segs = np.zeros((b, l), np.int64)
    for i in range(b):
        n = rng.randint(8, l + 1)
        u = [list(rng.randint(1000, 20000, rng.randint(1, 5)))
             for _ in range(n // 4)]
        ids[i], segs[i] = inputs.pack(u, l)
    enc = cfg["encoder"]
    feat = rng.rand(b, r, enc["v_feature_size"]).astype(np.float32)
    loc = rng.rand(b, r, 5).astype(np.float32)
    mask = np.ones((b, r), np.float32)
    mask[0, -2:] = 0
    t = [torch.from_numpy(x) for x in (ids, segs, feat, loc, mask)]
    return t[0], t[1], (t[0] != 0).long(), t[2], t[3], t[4]


@pytest.mark.parametrize("name", ["rank.vilbert_disc.val",
                                  "gen.gst_enc_dec.cc12m"])
def test_encoder_and_heads(name):
    cfg = tiny.cell(name).config
    dec = cfg.get("decoder")
    w = weights.make(cfg, 5, 2, "cpu", eos_bias=3.0)
    prog = program_model(cfg, w, "cpu", dec is not None)
    ref = model.Reference(w, cfg["encoder"], dec)
    ids, segs, att, feat, loc, mask = _batch(cfg)
    with torch.no_grad():
        got = prog.nsp_scores(ids, feat, loc, segs, att, mask)
        want = ref.nsp_logits(ids, segs, att, feat, loc, mask)
    assert (got - want).abs().max() < TOL


def test_decoder_paths():
    cfg = tiny.cell("gen.gst_enc_dec.cc12m").config
    w = weights.make(cfg, 6, 3, "cpu", eos_bias=3.0)
    prog = program_model(cfg, w, "cpu", True)
    ref = model.Reference(w, cfg["encoder"], cfg["decoder"])
    ids, segs, att, feat, loc, mask = _batch(cfg)
    dec = torch.randint(1000, 20000, (3, 7))
    dec[1, 5:] = 0
    dmask = (dec != 0).long()
    with torch.no_grad():
        got = prog.score(ids, feat, loc, segs, att, mask, dec, dmask)
        mem, mmask = ref.memory(ids, segs, att, feat, loc, mask)
        want = ref.decode_logits(dec, dmask, mem, mmask)
        assert (got - want)[dmask.bool()].abs().max() < TOL
        # the cached decode step against the uncached forward
        kv, mem_add = prog.decode_prepare(ids, feat, loc, segs, att, mask)
        from gstx_torch.decode.sampler import init_cache

        caches = init_cache(prog.dec_config, 3, 8, torch.float32, "cpu")
        full = ref.decode_logits(dec[:, :4].clamp(min=1),
                                 torch.ones(3, 4, dtype=torch.long), mem,
                                 mmask)
        for pos in range(4):
            step = prog.decode_step(dec[:, pos:pos + 1].clamp(min=1), pos,
                                    caches, kv, mem_add)
            assert (step - full[:, pos]).abs().max() < TOL


def test_weights_cover_the_program():
    cfg = tiny.cell("gen.gst_enc_dec.cc12m").config
    w = weights.make(cfg, 1, 2, "cpu")
    prog = program_model(cfg, w, "cpu", True)
    names = set(prog.state_dict())
    assert set(weights.state_dict_for(names, w, True)) == names
    with pytest.raises(RuntimeError):
        weights.state_dict_for(names | {"extra.weight"}, w, True)
    again = weights.make(cfg, 1, 2, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


def test_seed_permutes_weights_not_the_function():
    """Two run seeds: other weights, the same model."""
    cfg = tiny.cell("gen.gst_enc_dec.cc12m").config
    a, b = (weights.make(cfg, s, 2, "cpu") for s in (1, 2))
    assert any(not torch.equal(a[k], b[k]) for k in a)
    ids, segs, att, feat, loc, mask = _batch(cfg)
    dec = torch.randint(1000, 20000, (3, 5))
    with torch.no_grad():
        got = [program_model(cfg, w, "cpu", True).score(
            ids, feat, loc, segs, att, mask, dec, torch.ones_like(dec))
            for w in (a, b)]
    assert (got[0] - got[1]).abs().max() < 1e-4


def test_ngram_ban():
    hist = [[2000, 2001, 2002, 2003, 102], [2001, 2002, 2004]]
    assert inputs.banned(hist, [101, 7, 2000, 2001, 2002], 4) == {2003}
    assert inputs.banned(hist, [101, 2001, 2002], 3) == {2003, 2004}
    assert inputs.banned(hist, [101, 2002, 2003], 3) == set()  # [SEP]
