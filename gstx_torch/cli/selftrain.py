"""CLI: generative self-training orchestration, the port of
``gstx/cli/selftrain.py``.

The GST loop (reference README.md:87-128, run by hand there as a sequence
of script invocations) as one orchestrator:

  for iteration n = 1..N:
    1. generate: questioner + teacher synthesize 10-round dialogs for every
       CC12M chunk (cli/generate, writes iter{n}/cc12m_dialogs_{c}.txt)
    2. train the student on all synthetic chunks so far with
       perplexity-based selection (cli/train_gen -mode cc12m_train
       -select_data -iter n)
    3. finetune the student on VisDial (cli/train_gen -mode vd_train)
    4. the finetuned student becomes the next iteration's teacher

    python -m gstx_torch.cli.selftrain -iterations 3 -chunks 30 \\
        -start_path_q q.ckpt -start_path_a a.ckpt -cc12m_image_feats feats/ \\
        -cc12m_caption_dir caps/ -dialog_root dialogs/ -save_path out/ \\
        -extra -vocab_path vocab.txt -dtype bfloat16 ...

Each stage runs ``python -m gstx_torch.cli.<stage>``, the CLI a user would
run, in its own process: on ``cuda``, or on the CPU when the environment
sets ``GSTX_PLATFORM=cpu`` (the children inherit it).  A process per stage
also means the in-place bf16 cast of a model (the dialog engine's, the
CLIs' precast) never reaches a model that a later stage uses.  The
checkpoints are the port's torch files; their paths are the JAX
orchestrator's.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def main(argv=None, dry_run=False):
    """Run the plan, or with ``dry_run`` only return it: one
    ``[module, *args]`` list a stage."""
    p = argparse.ArgumentParser(description="gstx_torch self-training loop")
    p.add_argument("-iterations", type=int, default=3)
    p.add_argument("-chunks", type=int, default=30)
    p.add_argument("-start_path_q", required=True,
                   help="questioner checkpoint")
    p.add_argument("-start_path_a", required=True,
                   help="initial teacher checkpoint")
    p.add_argument("-cc12m_image_feats", required=True,
                   help="dir with cc12m_img_feat_{c}.store")
    p.add_argument("-cc12m_caption_dir", required=True,
                   help="dir with cc12m_captions_{c}.json")
    p.add_argument("-dialog_root", required=True,
                   help="output dir for iter{n}/cc12m_dialogs_{c}.txt")
    p.add_argument("-save_path", required=True)
    p.add_argument("-extra", nargs=argparse.REMAINDER, default=[],
                   help="extra flags forwarded to every stage")
    args = p.parse_args(argv)

    plan = []
    teacher = args.start_path_a
    # extra flags go FIRST so stage-specific flags win argparse's
    # last-occurrence rule on conflicts (-save_path, -mode, ...)
    for n in range(1, args.iterations + 1):
        iter_dir = os.path.join(args.dialog_root, f"iter{n}")
        for c in range(args.chunks):
            plan.append([
                "gstx_torch.cli.generate"] + args.extra + [
                "-mode", "cc12m_gen",
                "-start_path_q", args.start_path_q,
                "-start_path_a", teacher,
                "-cc12m_image_feats",
                os.path.join(args.cc12m_image_feats,
                             f"cc12m_img_feat_{c}.store"),
                "-cc12m_caption",
                os.path.join(args.cc12m_caption_dir,
                             f"cc12m_captions_{c}.json"),
                "-save_path", iter_dir,
                "-save_name", f"cc12m_dialogs_{c}.txt",
            ])
        student_dir = os.path.join(args.save_path, f"student_iter{n}")
        student_ckpt = os.path.join(student_dir, "final.ckpt")
        plan.append([
            "gstx_torch.cli.train_gen"] + args.extra + [
            "-mode", "cc12m_train", "-select_data",
            "-iter", str(n), "-chunk", str(args.chunks),
            "-cc12m_processed_train", args.dialog_root + "/",
            "-cc12m_image_feats",
            args.cc12m_image_feats + "/",
            "-save_path", student_dir,
        ])
        finetune_dir = os.path.join(args.save_path, f"finetune_iter{n}")
        plan.append([
            "gstx_torch.cli.train_gen"] + args.extra + [
            "-mode", "vd_train",
            "-start_path", student_ckpt, "-continue",
            "-save_path", finetune_dir,
        ])
        # the finetuned student becomes the next teacher (final checkpoint
        # saved by the train loop)
        teacher = os.path.join(finetune_dir, "final.ckpt")

    if dry_run:
        return plan

    log_dir = os.path.join(args.save_path, "selftrain_logs")
    os.makedirs(log_dir, exist_ok=True)
    for i, stage in enumerate(plan):
        module, stage_args = stage[0], stage[1:]
        log_path = os.path.join(
            log_dir, f"stage_{i:03d}_{module.rsplit('.', 1)[-1]}.log")
        print(f"[selftrain] python -m {module} {' '.join(stage_args)}\n"
              f"[selftrain] stage log: {log_path}", flush=True)
        cmd = [sys.executable, "-m", module] + stage_args
        t0 = time.perf_counter()
        for attempt in range(3):
            with open(log_path, "ab") as log_f:
                proc = subprocess.run(cmd, stdout=log_f,
                                      stderr=subprocess.STDOUT)
            if proc.returncode >= 0:
                break
            # killed by a signal (the OOM killer, host pressure): a
            # multi-day loop should survive infrastructure kills, and every
            # stage writes its checkpoints and JSON atomically, so a clean
            # retry is safe.  Real errors exit with a positive code and are
            # NOT retried.
            print(f"[selftrain] stage died with signal {-proc.returncode}"
                  f" (attempt {attempt + 1})"
                  + ("; retrying" if attempt < 2 else ""), flush=True)
        if proc.returncode != 0:
            try:
                # errors='replace': the log holds raw subprocess bytes, and
                # a non-UTF-8 byte must not mask the real failure
                with open(log_path, errors="replace") as f:
                    tail = "".join(f.readlines()[-30:])
            except OSError:
                tail = "<no log>"
            print(f"[selftrain] stage failed (rc={proc.returncode}); "
                  f"log tail:\n{tail}", flush=True)
            raise subprocess.CalledProcessError(proc.returncode, cmd)
        print(f"[selftrain] stage {i} done in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    return plan


if __name__ == "__main__":
    main()
