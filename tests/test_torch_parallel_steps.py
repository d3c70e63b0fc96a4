"""Data-parallel training (`train.trainer.DataParallelTrainStep`): each of
the six training steps over 2 gloo CPU ranks, one sample each, against the
port's own one-process step on the global batch of two (which the step
tests hold against JAX), on the same weights and batch
(tests/torch_parallel_ranks.py: tiny configs, two samples that differ in
valid points, gt boxes and positives). The ranks replay the one-process
step's ReLU decisions and, in Voxel R-CNN, its proposals (that module's
docstring says why); the replays are counted here.

Tolerances (f32, another summation order): every gradient leaf atol =
1e-4 * max|leaf| + 1e-6 * max|every leaf| (a bias ahead of a training
norm has an exact gradient of 0 and holds rounding noise of the step's
scale); updated parameters 1e-4 * max|p| + 1e-6 plus Adam's
first-step jump lr * |u(g + t) - u(g - t)| (u(g) = g / (|g| + eps), t the
gradient's tolerance, both clipped); the optimizer's moments the same
tolerance carried through mu = (1 - b1) g and nu = (1 - b2) g^2; batch
statistics 1e-4 * max|stat| + 1e-6; float logs rtol 1e-5; integer logs
(cap_overflow, tf_matched) exact. Both ranks must end with the same bits.

Negative control: the same ranks as plain DDP (per-rank statistics and
normalizers, averaged gradients and logs) must miss these tolerances."""

import pytest
import torch

import torch_parallel_ranks as R
from df3d_torch.train.schedules import global_norm

B2 = 0.999


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with R.one_thread():
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    R.spawn(R.steps_rank, tmp, str(tmp), R.STEPS)
    refs = {name: torch.load(tmp / f"{name}_ref.pt")["ref"]
            for name in R.STEPS}
    got = {(name, kind, rank): torch.load(tmp / f"{name}_{kind}{rank}.pt")
           for name in R.STEPS for kind, rank in (("dp", 0), ("dp", 1),
                                                  ("ddp", 0))}
    return refs, got


def misses(ref: dict, got: dict) -> list[str]:
    """The entries of `got` off `ref` by more than the module's
    tolerances."""
    out = []
    grads = ref["grads"]
    scale = max(g.abs().max().item() for g in grads.values())
    clip = min(1.0, 10.0 / float(global_norm(list(grads.values()))))

    def u(g):  # Adam's first update direction for a gradient g
        return g / (g.abs() + 1e-8)

    for name, r in grads.items():
        t = 1e-4 * r.abs().max().item() + 1e-6 * scale
        if (got["grads"][name] - r).abs().max().item() > t:
            out.append(f"gradient {name}")
        g, tc = r * clip, t * clip
        p = ref["params"][name]
        atol = (1e-4 * p.abs().max().item() + 1e-6
                + ref["lr0"] * (u(g + tc) - u(g - tc)).abs())
        if ((got["params"][name] - p).abs() > atol).any():
            out.append(f"parameter {name}")
        mu_tol = (1 - ref["b1"]) * tc + 1e-12
        if (got["mu"][name] - ref["mu"][name]).abs().max().item() > mu_tol:
            out.append(f"mu {name}")
        nu_tol = (1 - B2) * (2 * g.abs() * tc + tc ** 2) + 1e-20
        if ((got["nu"][name] - ref["nu"][name]).abs() > nu_tol).any():
            out.append(f"nu {name}")
    for k, r in ref["stats"].items():
        if ((got["stats"][k] - r).abs().max().item()
                > 1e-4 * r.abs().max().item() + 1e-6):
            out.append(f"statistic {k}")
    for k, r in ref["logs"].items():
        v = got["logs"][k]
        if r.is_floating_point():
            if abs(v.item() - r.item()) > 1e-5 * abs(r.item()):
                out.append(f"log {k}")
        elif not torch.equal(v, r):
            out.append(f"log {k}")
    return out


@pytest.mark.parametrize("name", R.STEPS)
def test_two_ranks_equal_one_process(runs, name):
    refs, got = runs
    dp0, dp1 = got[name, "dp", 0], got[name, "dp", 1]
    assert set(dp0["grads"]) == set(refs[name]["grads"])
    assert misses(refs[name], dp0) == []
    assert torch.equal(R.state_fingerprint(dp0), dp1["fingerprint"])
    for rank_flips in (dp0["flips"], dp1["flips"]):
        assert sum(n for n, _ in rank_flips) <= 4
        assert all(z < 1e-4 for _, z in rank_flips)
    print(f"{name}: ReLU replays per rank {dp0['flips']} {dp1['flips']}")


@pytest.mark.parametrize("name", R.STEPS)
def test_plain_ddp_misses(runs, name):
    refs, got = runs
    missed = misses(refs[name], got[name, "ddp", 0])
    assert any(m.startswith("gradient") for m in missed)
    assert any(m.startswith("statistic") for m in missed)
    assert any(m.startswith("log") for m in missed)


def test_samples_differ(runs):
    """The two samples of every batch differ in valid points and gt boxes
    (and so in valid rows and positives), and the one-process steps see
    positives: every gt matched (TransFusion), RoIs with a regression
    target (Voxel R-CNN)."""
    for name, ref in runs[0].items():
        valid, gts = ref["valid_points"], ref["valid_gts"]
        assert valid[0] != valid[1] and gts[0] != gts[1], name
        logs = ref["logs"]
        if "tf_matched" in logs:
            assert int(logs["tf_matched"]) == int(gts.sum())
        if "rcnn_reg_loss" in logs:
            assert float(logs["rcnn_reg_loss"]) > 0
