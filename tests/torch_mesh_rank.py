"""One rank of the two-rank CPU runs of ``tests/test_torch_port_mesh.py``.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_mesh_rank.py <task> <spec.json>

``same_device``: both ranks on one CUDA device under nccl, which
``init_distributed`` must refuse.  Any other task: one generative and one
discriminative training step on this rank's half of a fixed global batch
(``spec["gen"]`` / ``spec["disc"]``), then the CLI runs of
``spec["runs"]`` in turn, in the same process group (a run ``{"load":
argv}`` loads ``-start_path`` as the generative trainer's ``-continue``
does).  Each writes its results to
``spec["out"]``.rank<r>.pt.  Imports nothing of
JAX: it is a rank of the port.
"""

import json
import os
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch_port_harness  # noqa: E402,F401  (the CPU thread rule)
from gstx_torch.core import mesh  # noqa: E402
from gstx_torch.core.config import GSTConfig  # noqa: E402
from gstx_torch.eval import rank_gen  # noqa: E402
from gstx_torch.models import encdec, heads  # noqa: E402
from gstx_torch.train import train_disc, train_gen  # noqa: E402


def config_of(fields) -> GSTConfig:
    return GSTConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in fields.items()})


def stripe(batch, dp):
    """This rank's images of the global batch, in rank order."""
    n = next(iter(batch.values())).shape[0] // dp.size
    return {k: v[dp.rank * n:(dp.rank + 1) * n] for k, v in batch.items()}


def one_step(spec, dp, use_decoder):
    """One step of the trainer's step function on this rank's stripe, from
    the state in ``spec["state"]``: (loss or losses, state after)."""
    config = config_of(spec["config"])
    model, optimizer = train_gen.init_model_and_state(
        config, 100, "cpu", use_decoder=use_decoder,
        warmup_steps=None if use_decoder else train_disc.DISC_WARMUP_STEPS)
    model.load_state_dict(torch.load(spec["state"], weights_only=True))
    batch = dict(np.load(spec["batch"]))
    if use_decoder:
        step = train_gen.make_train_step(model, optimizer,
                                         config.batch_size, dp=dp)
    else:
        step = train_disc.make_disc_train_step(model, optimizer, config,
                                               dp=dp)
    loss = step(stripe(batch, dp), train_gen.iteration_generator(0, 3))
    return loss, {k: v.clone() for k, v in model.state_dict().items()}


def load(argv):
    """The state dict this rank holds after the generative trainer's
    resume from ``argv``'s ``-start_path``."""
    from gstx_torch.cli.common import parse_config

    config = parse_config(argv)
    model, optimizer = train_gen.init_model_and_state(config, 100, "cpu")
    train_gen.load_start_checkpoint(config, model, optimizer)
    return {k: v.clone() for k, v in model.state_dict().items()}


def run_cli(spec):
    """The CLI runs in turn; each records its result and, for the
    evaluators, rank 0's gathered scores a batch; a run marked
    ``expect_error`` records the message of the SystemExit or ValueError
    it must raise."""
    import importlib

    out = []
    real = rank_gen.gather_scores
    for run in spec["runs"]:
        if "load" in run:
            out.append({"result": load(run["load"])})
            continue
        scores = []

        def recording(*a, **kw):
            got = real(*a, **kw)
            if got is not None:
                scores.append(got.numpy().copy())
            return got
        rank_gen.gather_scores = recording
        try:
            cli = importlib.import_module(run["module"])
            kwargs = dict(device="cpu")
            if "max_steps" in run:
                kwargs["max_steps"] = run["max_steps"]
            result = cli.main(run["argv"], **kwargs)
        except (SystemExit, ValueError) as e:
            if not run.get("expect_error"):
                raise
            out.append({"error": str(e)})
            continue
        finally:
            rank_gen.gather_scores = real
        if run.get("expect_error"):
            raise AssertionError(f"{run['argv']} ran, expected an error")
        if isinstance(result, tuple):  # a trainer: (model, optimizer)
            result = {k: v.clone() for k, v in
                      result[0].state_dict().items()}
        out.append({"result": result, "scores": scores})
    return out


def main():
    task, spec_path = sys.argv[1], sys.argv[2]
    spec = json.load(open(spec_path))
    if task == "same_device":
        # two ranks on one CUDA device under nccl: init_distributed must
        # refuse before it builds the group (no card here: set_device is
        # a no-op, both ranks see one card's UUID, the check runs on the
        # rendezvous store)
        torch.cuda.set_device = lambda device: None
        torch.cuda.get_device_properties = \
            lambda device: types.SimpleNamespace(uuid="GPU-shared")
        try:
            mesh.init_distributed("cuda:0")
            result = {"raised": None}
        except RuntimeError as e:
            result = {"raised": str(e)}
        torch.save(result, f"{spec['out']}.rank{os.environ['RANK']}.pt")
        return
    result = {}
    if "gen" in spec:
        # a dropout-free step: the fusion's and the heads' fixed dropout
        # off too
        fixed = encdec.FUSION_DROPOUT, heads.POOLED_DROPOUT
        encdec.FUSION_DROPOUT = heads.POOLED_DROPOUT = 0.0
        mesh.init_distributed("cpu")
        dp = mesh.data_parallel("cpu")
        result = {"backend": dp.backend,
                  "gen": one_step(spec["gen"], dp, True),
                  "disc": one_step(spec["disc"], dp, False)}
        encdec.FUSION_DROPOUT, heads.POOLED_DROPOUT = fixed
    if "runs" in spec:
        result["runs"] = run_cli(spec)
    result["rank"] = mesh.process_index()
    torch.save(result, f"{spec['out']}.rank{mesh.process_index()}.pt")


if __name__ == "__main__":
    main()
