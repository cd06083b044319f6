"""Data parallelism across processes (the port's copy of what
``gstx/core/mesh.py`` offers for it).

The JAX package shards the batch over the ``data`` axis of a device mesh
and lets XLA insert the collectives.  The port runs one process per card,
so the data axis is a ``torch.distributed`` process group: a rank per
process, launched by ``torchrun`` (``python -m torch.distributed.run``) or
by any launcher that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``.

  * the trainers all-gather each rank's stripe into the global batch, every
    rank draws the same rows from it, computes its share of them and the
    gradients are summed over the ranks (:class:`DataParallel`);
  * generation stripes the dataset per process, and the ranks never talk;
  * the evaluators split each chunk's rows, padded by
    :func:`pad_batch_rows`, over the ranks and gather the scores to rank 0.

The group's backend follows the rank's device: ``nccl`` on a card, ``gloo``
on the CPU.  ``GSTX_DIST_BACKEND=gloo`` asks for gloo on a card, the one
way to put several ranks on one card: NCCL refuses two ranks on one device,
and :func:`init_distributed` raises before it would try.  Gloo reduces on
the host, so under gloo a CUDA tensor crosses to host memory for each
collective and back (a transport; the compute stays on the card).

Tensor parallelism (``-model_parallel`` > 1, the JAX module's ``model``
axis, ``mesh.py:179-311``): ``world = dp x mp`` ranks, rank ``d * mp + m``
(the order of ``make_mesh``'s ``reshape(data_parallel, model_parallel)``)
holding model shard ``m`` of replica ``d``; every entry point takes its
layout from :func:`make_layout`.  :func:`make_groups` builds a
**model group** of the ``mp`` ranks of one replica (:class:`ModelGroup`)
and a **data group** of the ``dp`` ranks that hold the same shard (a
:class:`DataParallel`).  :func:`param_partition` names each parameter's
class in the port's state-dict names (vocab rows, column-parallel,
row-parallel or replicated); :func:`shard_state_dict` slices a full state
dict for one rank and :func:`gather_state_dict` puts a rank's shards back
together.  The sharded modules are in
:mod:`gstx_torch.models.tensor_parallel`.
"""

from __future__ import annotations

import atexit
import datetime
import os
import re
import socket
from dataclasses import dataclass
from typing import Dict, Iterable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

BACKEND_ENV = "GSTX_DIST_BACKEND"
# a collective's deadline: generous, since one rank may still be loading a
# checkpoint or building the kernels while another already waits
TIMEOUT = datetime.timedelta(minutes=30)
# the gradient all-reduce's flat buckets, one collective each
BUCKET_BYTES = 256 << 20


def process_index() -> int:
    """This process's rank, 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks, 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device) -> torch.device:
    """The device of this rank: ``cuda`` without an index becomes
    ``cuda:(LOCAL_RANK % device_count)`` (``LOCAL_RANK``, the launcher's
    index of this process on its host, 0 when unset); any other device is
    itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
    return dev


def backend_for(device) -> str:
    """The group's backend: ``GSTX_DIST_BACKEND`` when set, else ``nccl``
    for a CUDA device and ``gloo`` for the CPU."""
    asked = os.environ.get(BACKEND_ENV)
    if asked:
        if asked not in ("nccl", "gloo"):
            raise ValueError(f"{BACKEND_ENV}={asked!r}: use nccl or gloo")
        if asked == "nccl" and torch.device(device).type != "cuda":
            raise ValueError(f"{BACKEND_ENV}=nccl needs a CUDA device, the "
                             f"rank runs on {device}")
        return asked
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device, timeout: datetime.timedelta = TIMEOUT
                     ) -> Optional[str]:
    """Join the process group the launcher's environment describes
    (``gstx/core/mesh.py:57``), with the backend of :func:`backend_for`,
    and end in one barrier, so that every rank leaves aligned.  Returns
    the backend, or None when there is nothing to do: a plain process (no
    ``RANK`` / ``WORLD_SIZE`` in the environment) or a group that is
    already initialised.

    The store is the ``env://`` rendezvous's: under ``torchrun`` every
    rank is a client of the store the launcher's agent serves on
    ``MASTER_PORT`` (``TORCHELASTIC_USE_AGENT_STORE``), else rank 0
    serves it.  Under ``nccl`` the ranks first publish their card through
    it: two ranks on one card raise here, with both named.  ``timeout`` is
    every collective's deadline, the counterpart of the JAX package's
    ``relax_cpu_collective_timeouts`` (XLA's CPU rendezvous watchdog,
    ``mesh.py:40``)."""
    if dist.is_initialized():
        return None
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    dev = rank_device(device)
    backend = backend_for(dev)
    store, rank, world = next(dist.rendezvous(
        "env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]), timeout=timeout))
    if backend == "nccl":
        torch.cuda.set_device(dev)
        _refuse_shared_devices(store, rank, world, dev)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    # a group left to the interpreter's teardown can abort the process
    # (its threads are still joinable); the CLIs end through this
    atexit.register(_leave_group)
    barrier()
    return backend


def _leave_group():
    if dist.is_initialized():
        dist.destroy_process_group()


def card_name(dev: torch.device) -> str:
    """The physical card behind ``dev``: its host and UUID.  A launcher
    that gives each rank its own card through ``CUDA_VISIBLE_DEVICES``
    shows every rank its card as ``cuda:0``; the UUID tells them apart."""
    return (f"{socket.gethostname()}:"
            f"{torch.cuda.get_device_properties(dev).uuid}")


def _refuse_shared_devices(store, rank: int, world: int, dev: torch.device):
    """Every rank publishes its card (:func:`card_name`) and reads the
    others'; when two share one, every rank raises, naming them.  Each
    rank waits until all have read, and rank 0, which serves the store
    outside ``torchrun``, stays until every rank's last call on it has
    been answered."""
    where = card_name(dev)
    store.set(f"gstx/device/{rank}", where)
    seen = [store.get(f"gstx/device/{r}").decode() for r in range(world)]
    store.set(f"gstx/device_seen/{rank}", "1")
    store.wait([f"gstx/device_seen/{r}" for r in range(world)])
    store.set(f"gstx/device_left/{rank}", "1")
    if rank == 0:
        store.wait([f"gstx/device_left/{r}" for r in range(world)])
    shared = [r for r in range(world) if seen[r] == where and r != rank]
    if shared:
        raise RuntimeError(
            f"ranks {sorted([rank] + shared)} all run on card {where} "
            f"({dev} here): NCCL takes one rank a card; run one rank a "
            f"card, or set {BACKEND_ENV}=gloo to share a card")


def barrier() -> None:
    """Every rank waits for the others; nothing without a group."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def process_shard(n_items: int, index: Optional[int] = None,
                  count: Optional[int] = None) -> np.ndarray:
    """The stripe of ``n_items`` dataset indices of process ``index`` of
    ``count`` (default: this one of the group; ``gstx/core/mesh.py:96``)."""
    if index is None:
        index = process_index()
    if count is None:
        count = process_count()
    return np.arange(index, n_items, count)


def auto_data_parallel(batch_size: int, n_devices: Optional[int] = None
                       ) -> int:
    """Largest divisor of batch_size that is <= the device count, so the
    batch axis always shards evenly (``gstx/core/mesh.py:146``); the ranks
    stand for the devices."""
    if n_devices is None:
        n_devices = process_count()
    for d in range(min(batch_size, n_devices), 0, -1):
        if batch_size % d == 0:
            return d
    return 1


def local_batch_size(batch_size: int, n_proc: Optional[int] = None) -> int:
    """Per-host slice of the global batch for multi-host training.  The
    global batch must split evenly: a silent floor division would shrink
    the real global batch away from the one num_iter_epoch / the LR
    schedule / auto_data_parallel were computed for
    (``gstx/core/mesh.py:157``)."""
    if n_proc is None:
        n_proc = process_count()
    if n_proc <= 1:
        return batch_size
    if batch_size % n_proc != 0:
        raise ValueError(
            f"-batch_size {batch_size} must be divisible by the process "
            f"count {n_proc} (each host contributes batch_size/process_count "
            "rows to the global batch)")
    return batch_size // n_proc


def pad_batch_rows(batch, multiple: int):
    """Pad a numpy batch dict's leading axis up to a multiple (DP meshes
    need the batch divisible by the data axis; ``gstx/core/mesh.py:329``).
    Padded rows repeat row 0 and are dropped by the caller via the
    returned valid count."""
    n = next(iter(batch.values())).shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch, n
    batch = {k: np.concatenate([np.asarray(v),
                                np.repeat(np.asarray(v)[:1], pad, axis=0)])
             for k, v in batch.items()}
    return batch, n


def _wire(t: torch.Tensor, backend: str, device) -> torch.Tensor:
    """``t`` as a collective of ``backend`` takes it: gloo reduces on the
    host, so a CUDA tensor is staged through host memory (the transport
    gloo itself would use); NCCL moves device memory only."""
    if backend == "nccl":
        return t.to(device)
    return t.cpu()


@dataclass(frozen=True)
class DataParallel:
    """The data axis: ``size`` ranks of ``group`` (None: the default group),
    this process being ``rank``, computing on ``device``.  It replaces the
    JAX package's ``make_mesh`` / ``training_mesh`` / ``make_global_batch``:
    the batch is not placed on a mesh but gathered (:meth:`gather_batch`)
    or split (:meth:`row_indices`), and gradients and scores move through
    explicit collectives."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return _wire(t, self.backend, self.device)

    def all_reduce_grads_(self, params: Iterable[torch.nn.Parameter]
                          ) -> None:
        """Sum the parameters' gradients over the ranks, in place, in flat
        buckets of at most BUCKET_BYTES a dtype (a parameter without a
        gradient on every rank stays without one)."""
        by_dtype: Dict[torch.dtype, list] = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            bucket, size = [], 0
            for g in grads:
                nbytes = g.numel() * g.element_size()
                if bucket and size + nbytes > BUCKET_BYTES:
                    self._reduce_bucket(bucket)
                    bucket, size = [], 0
                bucket.append(g)
                size += nbytes
            self._reduce_bucket(bucket)

    def _reduce_bucket(self, bucket):
        flat = self._wire(torch.cat([t.reshape(-1) for t in bucket]))
        dist.all_reduce(flat, group=self.group)
        flat = flat.to(bucket[0].device)
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, on ``t``'s device."""
        out = self._wire(t.detach().clone())
        dist.all_reduce(out, group=self.group)
        return out.to(t.device)

    def gather_batch(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        """The global batch: every rank's numpy batch (the same keys and
        shapes on every rank) concatenated on the leading axis in rank
        order, on every rank, as ``make_global_batch`` assembles it
        (``gstx/core/mesh.py:107``)."""
        out = {}
        for k in sorted(batch):
            x = torch.from_numpy(np.ascontiguousarray(batch[k]))
            wire = self._wire(x)
            parts = [torch.empty_like(wire) for _ in range(self.size)]
            dist.all_gather(parts, wire, group=self.group)
            out[k] = torch.cat(parts).cpu().numpy()
        return out

    def row_indices(self, n: int):
        """This rank's rows of ``n``: the rows padded by
        :func:`pad_batch_rows` to a multiple of ``size`` (the padded rows
        repeat row 0), split into ``size`` equal runs.  Returns (the run's
        row indices, which of them are real rows and not padding)."""
        rows, _ = pad_batch_rows({"row": np.arange(n)}, self.size)
        per = len(rows["row"]) // self.size
        run = slice(self.rank * per, (self.rank + 1) * per)
        return rows["row"][run], np.arange(len(rows["row"]))[run] < n

    def gather_rows(self, local: torch.Tensor, n: int
                    ) -> Optional[torch.Tensor]:
        """Rank 0: the [n, ...] rows that :meth:`row_indices` split, each
        rank's ``local`` [per, ...] put back in order with the padded rows
        dropped, on the host.  The other ranks: None."""
        wire = self._wire(local.contiguous())
        parts = [torch.empty_like(wire) for _ in range(self.size)] \
            if self.rank == 0 else None
        dist.gather(wire, parts, dst=self._global(0), group=self.group)
        if self.rank != 0:
            return None
        return torch.cat(parts)[:n].cpu()

    def _global(self, group_rank: int) -> int:
        if self.group is None:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)


def data_parallel(device, ranks: Optional[int] = None
                  ) -> Optional[DataParallel]:
    """The data axis over the first ``ranks`` ranks (default: all) of the
    initialised group, for this process; None without a group or for a
    rank outside it.  Every rank must call it (a subgroup is made
    collectively)."""
    if not dist.is_initialized():
        return None
    world = dist.get_world_size()
    ranks = world if ranks is None else ranks
    group = None if ranks == world else dist.new_group(list(range(ranks)))
    rank = dist.get_rank()
    if rank >= ranks:
        return None
    return DataParallel(group, rank, ranks, rank_device(device))


# ---------------------------------------------------------------------- #
# tensor parallelism: the model axis
# ---------------------------------------------------------------------- #

VOCAB, COLUMN, ROW = "vocab", "column", "row"

# The classes of ``gstx/core/mesh.py:179-233`` in the port's state-dict
# names (``nn.Linear`` weights are [out, in]).  Vocab rows: the word table
# (and its tied names), the decoder's LM head and the vocab biases.
# Column-parallel, the output features with their bias: every attention
# query / key / value (text, visual and decoder stacks, the decoder's
# cross-attention, the co-attention's six), every FFN's first product.
# Row-parallel, the input features (the bias is added after the
# all-reduce, so it stays whole): every attention output projection, the
# co-attention's BiOutput projections and every FFN's second product.
# Everything else is replicated, the unused ``biOutput.q_dense*`` too.
_VOCAB_NAMES = re.compile(
    r"(?:^|\.)(?:word_embeddings\.weight|lm_head\.decoder\.(?:weight|bias)"
    r"|lm_head\.bias|cls\.predictions\.(?:decoder\.weight|bias))$")
_COLUMN_NAMES = re.compile(
    r"\.(?:(?:cross)?attention\.self\.(?:query|key|value)"
    r"|biattention\.(?:query|key|value)[12]"
    r"|(?:v_|t_)?intermediate\.dense)\.(?:weight|bias)$")
_ROW_NAMES = re.compile(
    r"\.(?:(?:v_|t_)?output\.dense|biOutput\.dense[12])\.weight$")


def param_partition(name: str) -> Optional[str]:
    """The partition class of a state-dict name: :data:`VOCAB`,
    :data:`COLUMN`, :data:`ROW`, or None (replicated); the port's
    ``param_partition_spec`` (``gstx/core/mesh.py:221-233``)."""
    if _VOCAB_NAMES.search(name):
        return VOCAB
    if _COLUMN_NAMES.search(name):
        return COLUMN
    if _ROW_NAMES.search(name):
        return ROW
    return None


def partition_dim(name: str) -> Optional[int]:
    """The dimension a parameter shards on: 0 for the vocab rows and the
    column-parallel outputs (weights and biases), 1 for the row-parallel
    inputs, None when replicated."""
    kind = param_partition(name)
    if kind is None:
        return None
    return 1 if kind == ROW else 0


def validate_model_parallel(enc_cfg, dec_cfg, model_parallel: int) -> None:
    """Raise early, naming the dimension, when a model-parallel degree
    cannot shard the transformer on head and feature boundaries
    (``gstx/core/mesh.py:236-258``, its dimensions and message).  Pass
    ``dec_cfg=None`` for the encoder-only model."""
    if model_parallel <= 1:
        return
    dims = {
        "num_attention_heads": enc_cfg.num_attention_heads,
        "v_num_attention_heads": enc_cfg.v_num_attention_heads,
        "bi_num_attention_heads": enc_cfg.bi_num_attention_heads,
        "intermediate_size": enc_cfg.intermediate_size,
        "v_intermediate_size": enc_cfg.v_intermediate_size,
    }
    if dec_cfg is not None:
        dims["decoder num_attention_heads"] = dec_cfg.num_attention_heads
        dims["decoder intermediate_size"] = dec_cfg.intermediate_size
    for name, value in dims.items():
        if value % model_parallel != 0:
            raise ValueError(
                f"model_parallel={model_parallel} does not divide {name}="
                f"{value}; pick a degree dividing every head count and "
                f"intermediate size")


def sharded_dim(name: str, shape, mp: int) -> Optional[int]:
    """The dimension ``name`` (of ``shape``) shards on at degree ``mp``, or
    None when it stays whole: a replicated class, ``mp`` 1, or a dimension
    that does not divide by ``mp``."""
    dim = partition_dim(name)
    if dim is None or mp <= 1 or shape[dim] % mp:
        return None
    return dim


def shard_dim(name: str, shape, mp: int, warned: Optional[set] = None
              ) -> Optional[int]:
    """:func:`sharded_dim`, with one message per tensor tail (the last two
    name components, collected in ``warned``) for a dimension that does
    not divide by ``mp``, as ``shard_by_path`` prints
    (``gstx/core/mesh.py:277-311``): the 30,522-row vocab at ``mp`` 4
    stays whole."""
    dim = sharded_dim(name, shape, mp)
    if dim is not None or partition_dim(name) is None or mp <= 1:
        return dim
    tail = ".".join(name.split(".")[-2:])
    if warned is None or tail not in warned:
        if warned is not None:
            warned.add(tail)
        print(f"[gstx_torch.mesh] {name}: dimension not divisible by "
              f"model_parallel={mp}; tensor replicated", flush=True)
    return None


def shard_tensor(name: str, t: torch.Tensor, mp: int, m: int,
                 warned: Optional[set] = None) -> torch.Tensor:
    """Rank ``m``'s slice of the full tensor ``t`` named ``name``
    (:func:`shard_dim`), a view; the tensor itself when it stays whole."""
    dim = shard_dim(name, t.shape, mp, warned)
    if dim is None:
        return t
    per = t.shape[dim] // mp
    return t.narrow(dim, m * per, per)


def shard_state_dict(full_sd: Dict[str, torch.Tensor], mp: int, m: int,
                     warned: Optional[set] = None
                     ) -> Dict[str, torch.Tensor]:
    """Rank ``m`` of ``mp``'s slice of a full state dict (views; names
    kept).  Its inverse is :func:`gather_state_dict`."""
    warned = set() if warned is None else warned
    return {k: shard_tensor(k, v, mp, m, warned) for k, v in full_sd.items()}


def gather_state_dict(sd: Dict[str, torch.Tensor], tp: "ModelGroup",
                      full_shapes: Dict[str, torch.Size]
                      ) -> Dict[str, torch.Tensor]:
    """The full tensors of a rank's shards ``sd``, on every rank of the
    model group ``tp`` (a collective: every rank calls it with the same
    names in the same order); ``full_shapes`` gives each tensor's full
    shape, which decides, as :func:`sharded_dim` does, whether it was
    sharded.  On the host."""
    out = {}
    for k, v in sd.items():
        dim = sharded_dim(k, full_shapes[k], tp.size)
        v = v.detach()
        out[k] = (v if dim is None else tp.all_gather(v, dim)).cpu()
    return out


@dataclass(frozen=True)
class ModelGroup:
    """The model axis: the ``size`` ranks of ``group`` that hold one
    replica, this process holding shard ``rank``, computing on
    ``device``.  It carries the collectives of the sharded modules
    (:mod:`gstx_torch.models.tensor_parallel`)."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def _fresh(self, t: torch.Tensor) -> torch.Tensor:
        wire = _wire(t.detach(), self.backend, self.device)
        if wire.data_ptr() == t.data_ptr():
            wire = wire.clone()
        return wire.contiguous()

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """``op`` of ``t`` over the group, a new tensor on ``t``'s
        device."""
        wire = self._fresh(t)
        dist.all_reduce(wire, op=op, group=self.group)
        return wire.to(t.device)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The group's ``t``s concatenated on ``dim`` in rank order, on
        ``t``'s device."""
        wire = self._fresh(t)
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire, group=self.group)
        return torch.cat(parts, dim).to(t.device)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Group rank 0's ``t`` on every rank, on ``t``'s device."""
        wire = self._fresh(t)
        dist.broadcast(wire, src=dist.get_global_rank(self.group, 0),
                       group=self.group)
        return wire.to(t.device)


class Axes(NamedTuple):
    """This rank's place in a ``dp x mp`` layout: its data axis (None for
    one replica) and its model group (None without tensor
    parallelism)."""

    dp: Optional[DataParallel]
    tp: Optional[ModelGroup]

    @property
    def data_rank(self) -> int:
        return 0 if self.dp is None else self.dp.rank

    @property
    def data_size(self) -> int:
        return 1 if self.dp is None else self.dp.size

    @property
    def model_rank(self) -> int:
        return 0 if self.tp is None else self.tp.rank

    @property
    def spans(self) -> bool:
        """Whether this rank shares its work with others (a data axis or
        a model group); ``Axes(None, None)`` runs alone or idles."""
        return self.dp is not None or self.tp is not None


def make_groups(data_size: int, model_size: int, device) -> Axes:
    """The groups of a ``data_size x model_size`` layout over the first
    ``data_size * model_size`` ranks: rank ``d * model_size + m`` holds
    shard ``m`` of replica ``d``.  Every rank of the process group calls
    it: ``dist.new_group`` is collective, and every rank creates every
    subgroup, the model groups first, in the same order.  Returns this
    rank's :class:`Axes`, ``Axes(None, None)`` for a rank outside the
    layout."""
    n = data_size * model_size
    model_groups = [dist.new_group(list(range(d * model_size,
                                              (d + 1) * model_size)))
                    for d in range(data_size)]
    data_groups = [dist.new_group(list(range(m, n, model_size)))
                   for m in range(model_size)]
    rank = dist.get_rank()
    if rank >= n:
        return Axes(None, None)
    d, m = divmod(rank, model_size)
    dev = rank_device(device)
    tp = ModelGroup(model_groups[d], m, model_size, dev) \
        if model_size > 1 else None
    dp = DataParallel(data_groups[m], d, data_size, dev) \
        if data_size > 1 else None
    return Axes(dp, tp)


def make_layout(data_parallel_flag: int, model_parallel: int, device,
                every_rank: bool = True) -> Axes:
    """This rank's place in a ``dp x mp`` layout of the group's ranks,
    ``-data_parallel`` -1 taking ``world // mp`` replicas
    (``gstx/core/mesh.py:126-146``).  Every rank must call it (the
    subgroups are made collectively).

    ``every_rank`` (the trainers, ``training_mesh``, ``mesh.py:261-274``):
    the layout is every rank of the group, a plain process included, and
    any other raises, as ``make_mesh`` does.  Else (the evaluators and
    the demo, ``gstx/cli/common.py:140-178``): a plain process runs the
    whole model whatever the degrees ask, the first ``dp x mp`` ranks form
    the layout and the others idle, and more ranks than the group has
    raise JAX's error.  A layout of one rank, or a rank outside it, gets
    ``Axes(None, None)``."""
    mp = max(1, model_parallel)
    world = process_count()
    dp = world // mp if data_parallel_flag == -1 else data_parallel_flag
    if every_rank:
        if dp * mp != world or dp < 1:
            raise ValueError(
                f"mesh {dp}x{mp} != {world} devices available (one rank a "
                "device: launch data_parallel x model_parallel ranks, or "
                "pass -data_parallel -1)")
    elif world <= 1:
        return Axes(None, None)
    elif dp < 1 or dp * mp > world:
        raise SystemExit(f"error: mesh {dp}x{mp} needs {dp * mp} devices, "
                         f"have {world} ranks")
    if dp * mp == 1:
        return Axes(None, None)
    if mp == 1:
        return Axes(data_parallel(device, dp), None)
    return make_groups(dp, mp, device)
