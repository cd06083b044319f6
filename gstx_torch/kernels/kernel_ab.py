#!/usr/bin/env python3
"""Time one family of the port's kernels in several checkouts of this repo,
in turns, on one CUDA card, at chip_smoke.py's phase-2 shapes.

    python3 gstx_torch/kernels/kernel_ab.py FAMILY ROOT [ROOT ...]

FAMILY is ``attention`` (fused_attention and fused_attention_batch at
ATTENTION_SHAPES), ``dense_ln`` (fused_dense_ln at DENSE_LN_SHAPES) or
``ffn`` (fused_ffn at FFN_SHAPES).  Each ROOT is a
checkout (for example the parent commit unpacked with ``git archive``).
Each is run in its own process, in the order given (give A B B A to see the
card's drift), and builds its own kernels from its own sources.  Every run
uses this checkout's shapes and the same seeded inputs, holds each kernel
against that checkout's plain version within chip_smoke's tolerance, and
prints one JSON line: ``{"root": ..., "card": ..., "rows": [{"shape",
"kernel", "ms", "max_abs_err", "held"}, ...]}``.  A row that does not hold
is timed all the same and makes the exit code 1.  A table of the medians
per root follows.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
FAMILIES = ("attention", "dense_ln", "ffn")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cases(torch, cs, family, randn, gen):
    """(shape label, kernel name, kernel call, plain call) of one family."""
    if family == "ffn":
        from gstx_torch.kernels import ffn as kffn

        for label, m, d, f in cs.FFN_SHAPES:
            args = cs.ffn_inputs(torch, randn, m, d, f)
            yield (label, "fused_ffn", lambda a=args: kffn.fused_ffn(*a),
                   lambda a=args: kffn.ffn_plain(*a))
        return
    if family == "dense_ln":
        from gstx_torch.kernels import ffn as kffn

        for label, m, k, d in cs.DENSE_LN_SHAPES:
            args = cs.dense_ln_inputs(torch, randn, m, k, d)
            yield (label, "fused_dense_ln",
                   lambda a=args: kffn.fused_dense_ln(*a),
                   lambda a=args: kffn.dense_ln_plain(*a))
        return
    from gstx_torch.kernels import attention as kattn

    for label, b, h, lq, lk, dh in cs.ATTENTION_SHAPES:
        qkvm = cs.attention_inputs(torch, randn, gen, label, b, h, lq, lk,
                                   dh)
        for name, plain in (("fused_attention", kattn.attention_plain),
                            ("fused_attention_batch",
                             kattn.attention_batch_plain)):
            fn = getattr(kattn, name)
            yield (label, name, lambda f=fn, a=qkvm: f(*a),
                   lambda p=plain, a=qkvm: p(*a))


def worker(family, root):
    """One checkout's kernels at every shape: prints one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    randn = cs.make_randn(torch, gen)
    rows, held = [], True
    for label, name, call, plain in _cases(torch, cs, family, randn, gen):
        out, want = call(), plain()
        err = (out.float() - want.float()).abs()
        lim = cs.ABS_TOL + cs.REL_TOL * want.float().abs()
        ok = bool(torch.isfinite(out.float()).all()) and \
            bool((err <= lim).all())
        if not ok:  # still timed: a variant may leave work out on purpose
            print(f"{root}: {name}[{label}] disagrees with its plain version",
                  file=sys.stderr)
        held = held and ok
        rows.append(dict(shape=label, kernel=name, ms=cs.time_ms(call),
                         max_abs_err=float(err.max()), held=ok))
    print(json.dumps({"root": root, "card": cs.card_line(), "rows": rows}),
          flush=True)
    return 0 if held else 1


def main(family, roots):
    runs, failed = [], []
    for root in roots:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", family, root],
                             capture_output=True, text=True)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode != 0:  # the other roots still run
            print(f"kernel_ab: {family} in {root} failed", file=sys.stderr)
            failed.append(root)
        if res.stdout.strip():
            line = res.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append(json.loads(line))
    if not runs:
        return 1
    by_root = {}
    for run in runs:
        for r in run["rows"]:
            by_root.setdefault(run["root"], {}).setdefault(
                (r["shape"], r["kernel"]), []).append(r["ms"])
    print("shape | kernel | " + " | ".join(by_root))
    for key in by_root[runs[0]["root"]]:
        print(" | ".join(key) + " | " + " | ".join(
            f"{statistics.median(t[key]):.4f}" for t in by_root.values()))
    return 1 if failed else 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        sys.exit(worker(sys.argv[2], sys.argv[3]))
    elif len(sys.argv) >= 3 and sys.argv[1] in FAMILIES:
        sys.exit(main(sys.argv[1], sys.argv[2:]))
    else:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
