"""The port's generation CLI (``python -m gstx_torch.cli.generate``) on the
CPU against the JAX CLI, on the tiny fixture data and one reference-format
``.ckpt`` both load.

Greedy (``-top_k 1``, f32): the same records, identical strings and
``answer_ppl`` within PPL_TOL relative, in ``vd_gen_val`` and
``cc12m_gen``, bucketed or not.  Sampled runs (top-k 7) are the port's
alone (torch's generators are not JAX's threefry): byte-identical across
``-host_prefetch`` on and off, ``-pipeline`` 1 and 2, and a stop and
resume.  The JAX CLI runs once per configuration, in module fixtures."""

import dataclasses
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from torch_port_harness import assert_same_records
from fixtures import make_cc12m_caption_json, make_cli_env
from gstx.cli import generate as jgen
from gstx.cli.common import build_model as j_build_model
from gstx.cli.common import init_params
from gstx.cli.common import parse_config as j_parse_config
from gstx.core.checkpoint import to_torch_state_dict
from gstx.data.feature_store import make_synthetic_store
from gstx_torch.cli import generate as tgen
from gstx_torch.cli.common import apply_runtime_flags
from gstx_torch.cli.common import parse_config as t_parse_config
from gstx_torch.kernels import ffn as kffn
from gstx_torch.models import layers


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Fixture data, plus the JAX tiny params written as a reference
    ``.ckpt`` with DataParallel's ``module.`` prefixes, and a CC12M
    chunk (store, captions, url maps)."""
    tmp = str(tmp_path_factory.mktemp("port_cli"))
    args, cfg = make_cli_env(tmp)
    model, _, _ = j_build_model(cfg)
    params = jax.device_get(init_params(model, cfg, seed=0))
    ckpt = os.path.join(tmp, "ref.ckpt")
    torch.save({"model_state_dict": {
        "module." + k: torch.from_numpy(np.array(v))
        for k, v in to_torch_state_dict(params).items()}}, ckpt)
    caps = os.path.join(tmp, "caps.json")
    captions = make_cc12m_caption_json(caps, num_images=5)
    store = os.path.join(tmp, "cc.store")
    make_synthetic_store(store, [c["image_id"] for c in captions],
                         num_boxes=12, feat_dim=16, num_classes=11)
    urls = {str(c["image_id"]): f"http://example/{c['image_id']}"
            for c in captions}
    url_json, cap_json = (os.path.join(tmp, n) for n in ("u.json", "c.json"))
    json.dump(urls, open(url_json, "w"))
    json.dump({u: f"caption {i}" for i, u in enumerate(urls.values())},
              open(cap_json, "w"))
    cc_args = ["-cc12m_image_feats", store, "-cc12m_caption", caps,
               "-image_id_to_url", url_json, "-url_to_cap", cap_json]
    return args, cfg, ckpt, cc_args


def _base(ckpt, mode="vd_gen_val", rounds=3, steps=6, top_k=1):
    return ["-mode", mode, "-start_path_q", ckpt, "-start_path_a", ckpt,
            "-batch_size", "2", "-num_dialog_rounds", str(rounds),
            "-max_dec_len", str(steps), "-top_k", str(top_k)]


def port(argv, **kw):
    kw.setdefault("device", "cpu")
    try:
        return tgen.main(argv, **kw)
    finally:
        kffn.enable(True)  # the module default, for later tests


# ---------------------------------------------------------------------- #
# greedy parity with the JAX CLI
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def jax_vd(env):
    args, _, ckpt, _ = env
    return jgen.main(args + _base(ckpt) + ["-save_name", "j_vd.json"])


@pytest.fixture(scope="module")
def port_vd(env):
    args, _, ckpt, _ = env
    return port(args + _base(ckpt) + ["-save_name", "t_vd.json"])


def test_greedy_vd_gen_val_matches_jax_cli(env, jax_vd, port_vd):
    _, cfg, _, _ = env
    assert_same_records(port_vd, jax_vd)
    assert len(port_vd) == 4  # no fixture dialog overflows
    written = json.load(open(os.path.join(cfg.save_path, "t_vd.json")))
    assert written == port_vd
    assert not os.path.exists(os.path.join(cfg.save_path,
                                           "t_vd.json.partial.jsonl"))


def test_greedy_cc12m_gen_matches_jax_cli(env):
    """Five images at batch 2: a partial last batch; url and caption come
    from the url maps."""
    args, _, ckpt, cc = env
    base = _base(ckpt, mode="cc12m_gen") + cc
    want = jgen.main(args + base + ["-save_name", "j_cc.json"])
    got = port(args + base + ["-save_name", "t_cc.json"])
    assert_same_records(got, want)
    assert {r["url"] for r in got} >= {"http://example/2000"}
    assert all(r["caption"].startswith("caption ") for r in got)


BUCKETS = "32,48"  # below the fixture's max_seq_len of 96


@pytest.fixture(scope="module")
def jax_bucketed(env):
    args, _, ckpt, _ = env
    return jgen.main(args + _base(ckpt) + ["-save_name", "j_b.json",
                                           "-context_buckets", BUCKETS])


@pytest.mark.parametrize("dynamic", [False, True],
                         ids=["static", "dynamic"])
def test_greedy_bucketed_matches_jax_and_unbucketed(env, jax_bucketed,
                                                    port_vd, dynamic):
    args, _, ckpt, _ = env
    got = port(args + _base(ckpt) + [
        "-save_name", f"t_b{int(dynamic)}.json",
        "-context_buckets", BUCKETS]
        + (["-dynamic_buckets"] if dynamic else []))
    assert_same_records(got, jax_bucketed)
    assert_same_records(got, port_vd)


# ---------------------------------------------------------------------- #
# sampled runs: host-side identity and resume (tests/test_cli.py:83-213)
# ---------------------------------------------------------------------- #


def _sampled(ckpt, rounds=2, steps=6, extra=()):
    return _base(ckpt, rounds=rounds, steps=steps, top_k=7) + list(extra)


def test_prefetch_and_pipeline_identity(env):
    """-host_prefetch and -pipeline only reorder host work: the records
    are byte-identical across both."""
    args, _, ckpt, _ = env
    base = args + _sampled(ckpt)
    ref = port(base + ["-save_name", "s_pre.json"])
    assert len(ref) > 0
    assert port(base + ["-save_name", "s_inl.json",
                        "-no_host_prefetch"]) == ref
    assert port(base + ["-save_name", "s_p1.json", "-pipeline", "1"]) == ref
    assert port(base + ["-save_name", "s_p3.json", "-pipeline", "3",
                        "-no_host_prefetch"]) == ref


def test_batch_generator_depends_on_seed_and_index_only():
    """Each batch samples from a generator of (seed, batch index) alone, so
    a resumed run draws what the uninterrupted one drew."""
    def draw(seed, idx):
        return torch.rand(4, generator=tgen.batch_generator(seed, idx, "cpu"))
    assert torch.equal(draw(0, 1), draw(0, 1))
    assert not torch.equal(draw(0, 1), draw(0, 2))
    assert not torch.equal(draw(0, 1), draw(1, 1))


def test_resume_identical(env):
    args, cfg, ckpt, _ = env
    base = args + _sampled(ckpt, extra=["-flush_every", "1"])
    ref = port(base + ["-save_name", "r_ref.json"])
    assert len(ref) > 2
    partial = port(base + ["-save_name", "r.json"], max_batches=1,
                   finalize=False)
    sidecar = os.path.join(cfg.save_path, "r.json.partial.jsonl")
    assert os.path.exists(sidecar)
    assert 0 < len(partial) < len(ref)
    assert not os.path.exists(os.path.join(cfg.save_path, "r.json"))
    resumed = port(base + ["-save_name", "r.json"])
    assert resumed == ref
    assert json.load(open(os.path.join(cfg.save_path, "r.json"))) == ref
    assert not os.path.exists(sidecar)


def test_resume_torn_tail_and_meta_mismatch(env):
    args, cfg, ckpt, _ = env
    base = args + _sampled(ckpt, rounds=1, steps=4,
                           extra=["-flush_every", "1"])
    ref = port(base + ["-save_name", "torn_ref.json"])
    port(base + ["-save_name", "torn.json"], max_batches=1, finalize=False)
    sidecar = os.path.join(cfg.save_path, "torn.json.partial.jsonl")
    with open(sidecar, "a") as f:
        f.write('{"batch": 1, "records": [{"image_id"')  # torn mid-append
    assert port(base + ["-save_name", "torn.json"]) == ref

    # a sidecar of another run is not spliced in: preempt at one round,
    # "resume" at two; every record of the fresh run has two rounds
    port(base + ["-save_name", "mm.json"], max_batches=1, finalize=False)
    fresh = port(base + ["-save_name", "mm.json", "-num_dialog_rounds", "2"])
    assert len(fresh) >= len(ref)
    assert all(len(rec["dialog"]) == 2 for rec in fresh)


def test_resume_unflushed_tail(env):
    args, cfg, ckpt, _ = env
    base = args + _base(ckpt, rounds=1, steps=4, top_k=7) + [
        "-batch_size", "1", "-flush_every", "2"]
    ref = port(base + ["-save_name", "tail_ref.json"])
    port(base + ["-save_name", "tail.json"], max_batches=3, finalize=False)
    sidecar = os.path.join(cfg.save_path, "tail.json.partial.jsonl")
    assert len(open(sidecar).read().splitlines()) == 3  # meta + 2 batches
    assert port(base + ["-save_name", "tail.json"]) == ref
    assert not os.path.exists(sidecar)


def test_sidecar_meta_matches_jax_and_names_the_device(env):
    """The port's sidecar identity holds every field of the JAX CLI's (the
    process's place in a multi-process run among them), and the device
    type, whose generator draws the samples."""
    args, _, ckpt, _ = env
    argv = args + _base(ckpt) + ["-save_name", "x.json"]
    for proc in ((0, 1), (1, 2)):
        jmeta = jgen._sidecar_meta(j_parse_config(argv), *proc, 4)
        tmeta = tgen._sidecar_meta(t_parse_config(argv), *proc, 4, "cpu")
        assert tmeta.pop("device") == "cpu"
        assert tmeta == jmeta


def test_prefetch_worker_unblocks_on_consumer_failure():
    before = {t.name for t in threading.enumerate()}
    gen = tgen._prefetch(enumerate(range(50)), lambda i, b: (i, b), depth=2)
    assert next(gen) == (0, 0)
    gen.close()  # the consumer abandons the iterator mid-stream
    deadline = time.time() + 5.0
    while time.time() < deadline:
        alive = {t.name for t in threading.enumerate()} - before
        if not any(n.startswith("gstx-generate-prefetch") for n in alive):
            break
        time.sleep(0.02)
    else:
        raise AssertionError("prefetch worker still alive after close()")


def test_prefetch_reraises_worker_errors():
    def prepare(i, b):
        if i == 2:
            raise ValueError("bad batch")
        return i
    with pytest.raises(ValueError, match="bad batch"):
        list(tgen._prefetch(enumerate(range(5)), prepare, depth=1))


def test_trace_dir_writes_a_trace_with_the_cli_spans(env, tmp_path):
    """``trace.json`` with the CLI's and the program's spans, and
    ``spans.json`` with the registry's spans, counters and launches."""
    args, _, ckpt, _ = env
    trace_dir = tmp_path / "trace"
    port(args + _base(ckpt, rounds=1, steps=2)
         + ["-save_name", "traced.json", "-trace_dir", str(trace_dir)],
         max_batches=1)
    text = (trace_dir / "trace.json").read_text()
    assert "gstx:dispatch_rounds" in text and "gstx:fetch_results" in text
    assert "gstx:decode.step" in text and "gstx:decoder.ffn" in text
    spans = json.loads((trace_dir / "spans.json").read_text())
    names = {r[0] for r in spans["spans"]}
    assert {"gstx:engine.batch", "gstx:decode.step",
            "gstx:loader.fetch", "gstx:generate.collect"} <= names
    snap = spans["snapshot"]
    assert snap["counters"]["decode.steps"] == \
        snap["spans"]["gstx:decode.step"]["count"] > 0
    assert snap["counters"]["engine.batches"] == 1
    assert spans["launches"]["fused_ffn"] == 0
    assert spans["fields"][:3] == ["name", "start_ns", "end_ns"]
    assert "max_memory_allocated" in spans


# ---------------------------------------------------------------------- #
# flags, the kernel switch, refusals
# ---------------------------------------------------------------------- #

FLAG_CASES = [
    [],
    ["-no_use_pallas", "-continue", "-batch_size", "7", "-lr", "3e-5"],
    ["-mode", "cc12m_gen", "-quantize_memory", "-dynamic_buckets",
     "-context_buckets", "128,192", "-no_fused_sampler", "-top_p", "0.9"],
    ["-no_host_prefetch", "-pipeline", "1", "-flush_every", "0",
     "-no_resume_generation", "-dtype", "float32", "-no_remat",
     "-select_data", "-vd_version", "0.9", "-model", "enc_dec_q"],
]


@pytest.mark.parametrize("argv", FLAG_CASES, ids=range(len(FLAG_CASES)))
def test_flags_parse_as_jax(argv):
    argv = argv + ["-save_path", "out/"]
    got = dataclasses.asdict(t_parse_config(argv))
    want = dataclasses.asdict(j_parse_config(argv))
    assert got == want


def test_default_save_path_is_timestamped():
    cfg = t_parse_config([])
    assert cfg.save_path.startswith("checkpoints/") and \
        cfg.save_path != "checkpoints/"


@pytest.mark.parametrize("argv", [["-mode", "nonsense"],
                                  ["-dtype", "float16"],
                                  ["-sequences_per_image", "9"]], ids=str)
def test_bad_flags_exit(argv):
    with pytest.raises(SystemExit):
        t_parse_config(argv)


@pytest.mark.parametrize("flags", [["-mode", "vd_train"],
                                   ["-save_name", ""]], ids=str)
def test_generate_refuses_what_it_cannot_run(env, flags):
    args, _, ckpt, _ = env
    with pytest.raises(SystemExit):
        port(args + _base(ckpt) + ["-save_name", "x.json"] + flags)


def test_kernel_switch_follows_use_pallas():
    """On by default (the port's module default and the CLI's), off under
    -no_use_pallas, and the layers' gate reads it before the widths."""
    x = torch.zeros(2, 128, dtype=torch.bfloat16)
    try:
        assert kffn.is_enabled()
        apply_runtime_flags(t_parse_config(["-no_use_pallas"]))
        assert not kffn.is_enabled()
        assert not layers._fusable(x, 128, 256)
        apply_runtime_flags(t_parse_config([]))
        assert kffn.is_enabled() and layers._fusable(x, 128, 256)
    finally:
        kffn.enable(True)


def test_kernel_switch_defaults_differ_from_jax_by_design():
    """A deliberate difference (ROADMAP queue 3): the JAX package's switch
    is off at module level and its CLIs turn it on from -use_pallas; the
    port's is on at module level.  Read from the sources, since an earlier
    test in this process may have flipped either switch."""
    import ast

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def module_default(rel):
        tree = ast.parse(open(os.path.join(root, rel)).read())
        return next(node.value.value for node in tree.body
                    if isinstance(node, ast.Assign)
                    and [t.id for t in node.targets] == ["_ENABLED"])
    assert module_default("gstx/kernels/ffn.py") is False
    assert module_default("gstx_torch/kernels/ffn.py") is True
    assert t_parse_config([]).use_pallas and j_parse_config([]).use_pallas


def test_main_without_a_card_raises(env, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.delenv("GSTX_PLATFORM", raising=False)
    args, _, ckpt, _ = env
    with pytest.raises(RuntimeError, match="cuda"):
        tgen.main(args + _base(ckpt) + ["-save_name", "nocard.json"])


def test_gstx_platform_cpu_selects_the_cpu(env, monkeypatch):
    monkeypatch.setenv("GSTX_PLATFORM", "cpu")
    args, _, ckpt, _ = env
    got = port(args + _base(ckpt, rounds=1, steps=2)
               + ["-save_name", "envcpu.json"], max_batches=1, device=None)
    assert len(got) > 0


@pytest.mark.parametrize("flags", [["-data_parallel", "2"],
                                   ["-model_parallel", "2"],
                                   ["-distributed"]], ids=str)
def test_multi_device_flags_exit(env, port_vd, flags):
    """As the JAX CLI: in one process -data_parallel 2 and
    -model_parallel 2 run as one rank (make_generation_mesh's None for one
    device) and -distributed alone is a no-op, each writing the plain
    run's records to the unsharded file."""
    args, cfg, ckpt, _ = env
    got = port(args + _base(ckpt) + ["-save_name", "mp.json"] + flags)
    assert got == port_vd
    assert json.load(open(os.path.join(cfg.save_path, "mp.json"))) == got
