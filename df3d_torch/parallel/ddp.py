"""Data parallelism over processes (port of df3d/parallel/mesh.py).

The JAX package runs one `jit` program over a ("data",) mesh: its batch
statistics and loss normalizers cover the global batch, so a step over n
devices computes what the one-device step computes on the global batch.
Here each process (rank) holds its rows of the global batch
(`shard_batch`) and runs the step on them. For the step to equal the
one-process step on the global batch:

* every batch reduction of a training forward (the norms' sums and
  counts, the losses' normalizers) goes through `global_sum`, which sums
  over the ranks of the group that `data_parallel` makes active. Its
  backward sums the incoming gradients over the ranks again, as SyncBN's
  does, so each rank's backward carries the other ranks' losses back
  through the shared statistics. With no active group, or one rank, it
  returns its inputs unchanged;
* each rank's loss is its share of the global loss, so the gradients are
  summed over the ranks (`sum_over_ranks`), not averaged, before the
  clip, and so are the logs.

`init_data_parallel` joins the process group (NCCL on the card, gloo
when the caller asks for the CPU), `broadcast_state` gives every rank
rank 0's state, and `train.trainer.DataParallelTrainStep` is the step.
"""

from __future__ import annotations

import contextlib
import datetime

import torch
import torch.distributed as dist

from df3d_torch.utils import stages

_group = None  # the group whose ranks `global_sum` sums over
# how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(seconds=300)


def init_data_parallel(rank: int, world_size: int, backend: str | None = None,
                       init_method: str = "env://",
                       device=None) -> torch.device:
    """Join the default process group as `rank` of `world_size` and return
    this rank's device: `cuda:rank` unless `device` says otherwise. The
    backend is NCCL for a card and gloo for the CPU, unless `backend`
    names one (gloo also reduces CUDA tensors, through host copies: two
    ranks sharing one card, which NCCL refuses). A collective that waits
    longer than `TIMEOUT` raises."""
    device = (torch.device("cuda", rank) if device is None
              else torch.device(device))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_data_parallel: no CUDA device; pass "
                               "device='cpu' for gloo CPU processes")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL reduces CUDA tensors only")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=TIMEOUT)
    return device


def shard_batch(batch: dict, rank: int, world_size: int) -> dict:
    """This rank's rows of a global batch (tensors or arrays with the batch
    dim first): rows rank * b to (rank + 1) * b, b = B / world_size."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % world_size:
            raise ValueError(f"batch {k}: {n} rows do not divide over "
                             f"{world_size} ranks")
        b = n // world_size
        out[k] = v[rank * b:(rank + 1) * b]
    return out


@contextlib.contextmanager
def data_parallel():
    """Within the block, `global_sum` sums over the ranks of the default
    process group."""
    global _group
    saved, _group = _group, dist.group.WORLD
    try:
        yield
    finally:
        _group = saved


def world_size() -> int:
    """The number of ranks `global_sum` sums over (1 outside
    `data_parallel`)."""
    return 1 if _group is None else dist.get_world_size(_group)


class _GlobalSum(torch.autograd.Function):
    """x summed over the ranks of `group`; the backward sums the incoming
    gradients over the ranks (d(sum_r x_r)/dx_r = 1 on every rank, and
    each rank's loss reads the sum). Both directions are timed as the
    "allreduce" stage."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        with stages.span("allreduce"):
            dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        with stages.span("allreduce"):
            dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_sum(*tensors: torch.Tensor):
    """Each tensor summed over the ranks of the active group, in one
    all-reduce of their flattened concatenation (one dtype), differentiable
    (`_GlobalSum`). Returns one tensor for one input, else a tuple. The
    identity with no active group or one rank."""
    if world_size() == 1:
        return tensors[0] if len(tensors) == 1 else tensors
    flat = _GlobalSum.apply(torch.cat([t.reshape(-1) for t in tensors]),
                            _group)
    sizes = [t.numel() for t in tensors]
    out = tuple(p.reshape(t.shape)
                for p, t in zip(flat.split(sizes), tensors))
    return out[0] if len(out) == 1 else out


def first_rank_share(x: torch.Tensor) -> torch.Tensor:
    """`x` on the active group's rank 0 and zeros on the others, so that a
    log summed over the ranks counts a value that every rank computed from
    global sums once."""
    if world_size() == 1 or dist.get_rank(_group) == 0:
        return x
    return torch.zeros_like(x)


def sum_over_ranks(tensors):
    """Tensors (a list, or a dict's values) summed over the ranks, not
    differentiated: one all-reduce of the flattened
    concatenation per dtype. Returns the same structure; the tensors of a
    list come back as views of one buffer per dtype."""
    items = (list(tensors.items()) if isinstance(tensors, dict)
             else list(enumerate(tensors)))
    out = {}
    for dtype in dict.fromkeys(t.dtype for _, t in items):
        part = [(k, t) for k, t in items if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for _, t in part])
        with stages.span("allreduce"):
            dist.all_reduce(flat)
        for (k, t), p in zip(part, flat.split([t.numel() for _, t in part])):
            out[k] = p.view(t.shape)
    if isinstance(tensors, dict):
        return {k: out[k] for k in tensors}
    return [out[i] for i in range(len(items))]


_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _fingerprint(tensors: list[torch.Tensor]) -> torch.Tensor:
    """Two int64 sums over the tensors' bits read as integer words: of the
    words and of their squares (both wrapping). Equal tensors give equal
    fingerprints; a change of one word changes both sums."""
    fp = torch.zeros(2, dtype=torch.int64, device=tensors[0].device)
    for t in tensors:
        w = t.reshape(-1).view(_WORDS[t.element_size()]).to(torch.int64)
        fp[0] += w.sum()
        fp[1] += (w * w).sum()
    return fp


@torch.no_grad()
def broadcast_state(state, group=None):
    """Give every rank rank 0's parameters, batch statistics, optimizer
    moments and step counts, in place (one broadcast per dtype), then
    assert that every rank holds the same bits: the minimum and the maximum
    over the ranks of each rank's `_fingerprint` agree. Returns `state`."""
    # the parameters and buffers (batch statistics, the frozen image
    # branch's too), the optimizer's moments and the step counts
    tensors = (list(state.model.state_dict().values()) + state.opt_state.mu
               + state.opt_state.nu)
    counts = torch.tensor([state.step, state.opt_state.count],
                          dtype=torch.int64, device=tensors[0].device)
    tensors.append(counts)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        part = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in part])
        dist.broadcast(flat, 0, group=group)
        for t, p in zip(part, flat.split([t.numel() for t in part])):
            t.copy_(p.view(t.shape))
    fp = _fingerprint(tensors)
    lo, hi = fp.clone(), fp.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    if not torch.equal(lo, hi):
        raise RuntimeError("broadcast_state: the ranks' states differ after "
                           "the broadcast")
    state.step, state.opt_state.count = (int(c) for c in counts)
    return state
