"""The data-parallel parts (`df3d_torch.parallel.ddp`) on 2 gloo CPU ranks
against one process: the differentiable global sum, the three training
norms synced over the ranks (forward, backward and running statistics),
`broadcast_state`, `shard_batch`, and the entry point
`dryrun_multichip(2, device="cpu")`.

Each rank holds one of two samples (tests/torch_parallel_ranks.py); the
masked norm's samples hold 31 and 9 valid rows. Tolerances (f32, another
summation order): atol = 1e-5 * max|ref| + 1e-6."""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from df3d_torch import entry
from df3d_torch.parallel import ddp


def _close(got, ref):
    tol = 1e-5 * ref.abs().max().item() + 1e-6
    return (got - ref).abs().max().item() <= tol


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with R.one_thread():
        yield


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    R.spawn(R.units_rank, tmp, str(tmp))
    return [torch.load(tmp / f"units{rank}.pt") for rank in (0, 1)]


def test_global_sum_carries_the_gradient(units):
    """Each rank's share of f summed over the ranks is f of the global
    batch, and each rank's gradient is its rows of f's gradient; a plain
    all-reduce gives the same value and misses the gradient."""
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 3).astype(
        np.float32))
    value, grad = R.global_sum_case(x)  # one process: the sum is local
    got = torch.cat([u["grad"] for u in units])
    assert _close(sum(u["value"] for u in units), value)
    assert _close(got, grad)
    plain = torch.cat([u["plain_grad"] for u in units])
    assert not _close(plain, grad)


@pytest.mark.parametrize("norm", ["masked", "flax", "flax2d"])
def test_synced_norm(units, norm):
    """MaskedBatchNorm, FlaxBatchNorm and FlaxBatchNorm2d on one sample a
    rank, under `ddp.data_parallel`, against the norm on both samples in
    one process: each rank's output and input gradient are its rows of
    the one process's, the parameter gradients sum to its, and the running
    statistics equal its on every rank (a loss that also reads the
    output's global sum sends gradient across the ranks)."""
    ref = R.norms_forward_backward(R.norm_inputs(), slice(0, 2))[norm]
    got = [u["norms"][norm] for u in units]
    for key in ("y", "dx"):
        assert _close(torch.cat([g[key] for g in got]), ref[key]), key
    for key in ("dweight", "dbias"):
        assert _close(got[0][key] + got[1][key], ref[key]), key
    for key in ("running_mean", "running_var"):
        for g in got:
            assert _close(g[key], ref[key]), key
    # a per-rank statistic would not do: the samples' statistics differ
    own = R.norms_forward_backward(R.norm_inputs(), slice(0, 1))[norm]
    assert not _close(own["running_mean"], ref["running_mean"])


def test_broadcast_state(units):
    """Ranks that drew their weights from seeds 0 and 1 hold rank 0's
    parameters, batch statistics and moments after `broadcast_state`, bit
    for bit."""
    state, _ = entry.build_centerpoint_trainer(entry.mesh_cfg(), "cpu",
                                               seed=0)
    want = R.record(state, {}, state.params)
    for u in units:
        for section in ("params", "stats", "mu", "nu"):
            for k, v in want[section].items():
                assert torch.equal(u["state"][section][k], v), (section, k)
    other, _ = entry.build_centerpoint_trainer(entry.mesh_cfg(), "cpu",
                                               seed=1)
    assert not torch.equal(other.params[0], state.params[0])


def test_shard_batch_and_one_process():
    batch = {"a": torch.arange(12).reshape(4, 3), "b": np.arange(4)}
    got = ddp.shard_batch(batch, 1, 2)
    assert torch.equal(got["a"], batch["a"][2:]) and list(got["b"]) == [2, 3]
    with pytest.raises(ValueError):
        ddp.shard_batch(batch, 0, 3)
    # outside `data_parallel` the global sum is the identity
    x = torch.ones(3)
    assert ddp.world_size() == 1 and ddp.global_sum(x) is x


def test_init_data_parallel_refuses():
    """NCCL on the CPU is refused, not switched to gloo; with no card the
    default device (a card) raises, as does `dryrun_multichip` asked for
    cards."""
    with pytest.raises(ValueError):
        ddp.init_data_parallel(0, 1, backend="nccl", device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError):
        ddp.init_data_parallel(0, 1)
    with pytest.raises(RuntimeError):
        entry.dryrun_multichip(1)


def test_dryrun_multichip_cpu(capsys):
    losses = entry.dryrun_multichip(2, device="cpu")
    assert all(np.isfinite(v) for v in losses.values())
    assert "dryrun_multichip(2): ok, loss=" in capsys.readouterr().out
