#!/usr/bin/env python3
"""Time the attention kernels of several checkouts of this repo in turns on
one CUDA card, at chip_smoke.py's phase-2 attention shapes.

    python3 gstx_torch/kernels/attention_ab.py ROOT [ROOT ...]

Each ROOT is a checkout (for example the parent commit unpacked with
``git archive``).  Each is run in its own process, in the order given (give
A B B A to see the card's drift), and builds its own kernels from its own
sources.  Every run uses this checkout's shapes and the same seeded inputs,
holds each kernel against that checkout's plain version within chip_smoke's
tolerance, and prints one JSON line: ``{"root": ..., "rows": [{"shape",
"kernel", "ms", "max_abs_err"}, ...]}``.  A table of the medians per root
follows.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root):
    """One checkout's kernels at every shape: prints one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from gstx_torch.kernels import attention as kattn

    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    rows = []
    for label, b, h, lq, lk, dh in cs.ATTENTION_SHAPES:
        q, k, v, mask = cs.attention_inputs(torch, randn, gen, label, b, h,
                                            lq, lk, dh)
        for name, plain in (("fused_attention", kattn.attention_plain),
                            ("fused_attention_batch",
                             kattn.attention_batch_plain)):
            fn = getattr(kattn, name)
            out, want = fn(q, k, v, mask), plain(q, k, v, mask)
            err = (out.float() - want.float()).abs()
            lim = cs.ABS_TOL + cs.REL_TOL * want.float().abs()
            if not bool(torch.isfinite(out.float()).all()) or \
                    not bool((err <= lim).all()):
                raise AssertionError(f"{root}: {name}[{label}] disagrees "
                                     "with its plain version")
            rows.append(dict(shape=label, kernel=name,
                             ms=cs.time_ms(lambda: fn(q, k, v, mask)),
                             max_abs_err=float(err.max())))
    print(json.dumps({"root": root, "card": cs.card_line(), "rows": rows}),
          flush=True)


def main(roots):
    runs = []
    for root in roots:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root], capture_output=True,
                             text=True)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode != 0:
            print(f"attention_ab: {root} failed", file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    by_root = {}
    for run in runs:
        for r in run["rows"]:
            by_root.setdefault(run["root"], {}).setdefault(
                (r["shape"], r["kernel"]), []).append(r["ms"])
    print("shape | kernel | " + " | ".join(by_root))
    for key in by_root[runs[0]["root"]]:
        print(" | ".join(key) + " | " + " | ".join(
            f"{statistics.median(t[key]):.4f}" for t in by_root.values()))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
    elif len(sys.argv) >= 2:
        sys.exit(main(sys.argv[1:]))
    else:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
