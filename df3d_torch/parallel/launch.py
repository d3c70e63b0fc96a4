"""One process per rank: the port's counterpart of the device mesh that
the JAX package's train CLI shards its global batch over
(tools/train.py:244-256).

`spawn(fn, nprocs, *args)` starts `nprocs` new processes (spawned, so a
parent that has touched the card may start them), each running
`fn(rank, nprocs, init_method, *args)`; they meet through a FileStore in
a temporary directory (`ddp.init_data_parallel(rank, nprocs,
init_method=...)`). Each rank starts with its parent's TF32 and cuDNN
settings, so that it computes as the parent would. `rank_devices` places
the ranks: one card each over NCCL while there are cards enough, several
ranks a card over gloo otherwise (NCCL refuses two ranks on one device),
gloo CPU processes for `device="cpu"`.
"""

from __future__ import annotations

import tempfile

import torch


def rank_devices(nprocs: int, device=None) -> tuple[list[str], str]:
    """(each rank's device, the backend) for `nprocs` ranks on `device`'s
    kind: "cpu" -> gloo CPU ranks; the card (None or "cuda") -> rank r on
    card r over NCCL when there are `nprocs` cards, else on card r modulo
    the cards over gloo. Raises with no card unless `device` is "cpu"."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return ["cpu"] * nprocs, "gloo"
    if kind != "cuda":
        raise ValueError(f"ranks run on the card or the CPU, not {device!r}")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("df3d_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' for gloo CPU ranks")
    devices = [f"cuda:{r % count}" for r in range(nprocs)]
    return devices, "nccl" if nprocs <= count else "gloo"


def _backend_flags() -> dict:
    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_benchmark": torch.backends.cudnn.benchmark}


def _rank(rank, fn, nprocs, init_method, flags, args):
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn_tf32"]
    torch.backends.cudnn.benchmark = flags["cudnn_benchmark"]
    fn(rank, nprocs, init_method, *args)


def spawn(fn, nprocs: int, *args) -> None:
    """Run fn(rank, nprocs, init_method, *args) in `nprocs` spawned
    processes and wait for all of them; raises if a rank raises. `fn` and
    `args` must pickle (a module-level function, no lambdas)."""
    with tempfile.TemporaryDirectory(prefix="df3d_ranks_") as tmp:
        torch.multiprocessing.spawn(
            _rank, nprocs=nprocs,
            args=(fn, nprocs, f"file://{tmp}/store", _backend_flags(), args))
