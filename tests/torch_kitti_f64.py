"""Measure whether the KITTI step tests' gradient gaps at the seeded weight
scales are f32 rounding: the Voxel R-CNN and Voxel R-CNN + 3D-DF training
steps of tests/test_torch_voxelrcnn_train_step.py and
tests/test_torch_voxelrcnn_fused_train_step.py (same configs, points, gts
and JAX decisions replayed, `torch_port_helpers.voxelrcnn_step_run`), at
the seeded scales (box kernels at the full He scale, the deformable
attention's kernels LeCun-seeded) and at the tests' reduced ones, once in
f32 and once in f64: the JAX step under x64, the port's plain step with its
model and batch in f64; and, in f32 at the seeded scales, with torch's sin
and cos in the port (in place of XLA's). Prints, per case, the largest
gap of a gradient leaf in units of the tests' tolerance (1e-4 * max|leaf|
+ 1e-6) and the leaf, and the largest relative gap of a log. Not a test
(each case compiles a JAX step: ~2 min on one core):

    JAX_PLATFORMS=cpu python tests/torch_kitti_f64.py

Each case runs in its own process (x64 is set before JAX starts). Under
x64 two parts of the JAX package assume 32-bit integers, and the script
works round them in its own process: the plans are built by the package's
sort method instead of its bit-rank key table (both give the same plans),
and FPS's argmax is cast to the int32 its loop carries. The port's voxel
centres (f32 by design, as XLA rounds them) enter its f64 layers as f64."""

import json
import os
import subprocess
import sys


def run_case(step: str, scales: str, precision: str,
             sincos: str = "xla") -> dict:
    """One case in this process; JAX_ENABLE_X64 must be set as the
    precision asks before JAX is imported. `sincos` "torch" gives the
    port torch's sin and cos in place of XLA's (`core.boxes.xla_sin_cos`)."""
    import jax
    import numpy as np
    import torch

    import test_torch_voxelrcnn_fused_train_step as F
    import test_torch_voxelrcnn_train_step as L
    from df3d_torch.train.trainer import create_train_state
    from df3d_torch.train.schedules import adam_onecycle
    from df3d_torch.weights import params_from_flax, train_state_from_flax
    from torch_port_helpers import (
        gts_near_proposals, small_box_residuals, voxelrcnn_step_run,
        voxelrcnn_variables,
    )

    f64 = precision == "f64"
    assert jax.config.jax_enable_x64 == f64
    if sincos == "torch":
        from df3d_torch.core import boxes
        boxes.xla_sin_cos = lambda a: (torch.sin(a), torch.cos(a))
    if f64:  # the bit-rank key table assumes 32-bit integers, the sort
        # method builds the same plans; FPS's loop carries an int32 index
        import types

        import df3d.ops.pointops as jpo
        import df3d.ops.sparse as jsp
        import jax.numpy as jnp
        jsp._use_bitrank = lambda *args: False
        jpo.jnp = types.SimpleNamespace(**{
            k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
        jpo.jnp.argmax = lambda *a, **k: jnp.argmax(*a, **k).astype(
            jnp.int32)
    mod = F if step == "fused" else L
    jcfg, tcfg = mod.configs(mod.JConfig, mod.jrh), mod.configs(
        mod.VoxelRCNNConfig, mod.trh)
    batch = L.points_batch()
    if step == "fused":
        jmodel = F.JVoxelRCNN3DDF(jcfg, F.JFusedConfig(
            actr=F.JACTRConfig(**F.ACTR), **F.FUSED))
        b = batch["points"].shape[0]
        rng = np.random.RandomState(3)
        batch["images"] = rng.randn(b, *F.IMAGE, 3).astype(np.float32)
        batch["proj"] = np.broadcast_to(F.kitti_camera(F.IMAGE[1] / 1280.0),
                                        (b, 3, 4)).copy()
        reduced = F.initial_scales
    else:
        jmodel = L.JVoxelRCNN(jcfg)
        reduced = small_box_residuals
    jhead = L.jrh.VoxelRCNNHead(jcfg.rcnn, jcfg.voxel_size, jcfg.pc_range)
    res = jax.eval_shape(lambda p, v: L.jvoxelize_batch(
        p, v, jcfg.voxel_size, jcfg.pc_range, jcfg.grid_size,
        jcfg.max_voxels, jcfg.max_points_per_voxel),
        batch["points"], batch["points_valid"])
    fwd = (res.features, res.coords)
    if step == "fused":
        fwd += (batch["images"], batch["proj"])
    variables = voxelrcnn_variables(
        jmodel, jhead, fwd, jcfg.rcnn.roi_per_image, seed=1,
        out_scale=reduced if scales == "reduced" else None)
    if step == "fused":
        state, tstep = F.build_voxelrcnn3ddf_trainer(
            tcfg, F.FusedConfig(actr=F.ACTRConfig(**F.ACTR), **F.FUSED),
            "cpu")
    else:
        state, tstep = L.build_voxelrcnn_trainer(tcfg, "cpu")
    tx = adam_onecycle(L.LR_MAX, L.TOTAL_STEPS)
    state = train_state_from_flax(state.model, variables["params"],
                                  variables["batch_stats"], tx)
    batch.update(gts_near_proposals(state.model, tstep, batch))
    if f64:
        variables = jax.tree_util.tree_map(
            lambda v: v.astype(np.float64) if v.dtype == np.float32 else v,
            variables)
        batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                 for k, v in batch.items()}
        state = create_train_state(state.model.double(), tx)
        # the port's voxel centres are f32 by design (XLA's rounding); in
        # f64 they enter the f64 layers as f64
        import df3d_torch.models.fusion.hooks as thooks
        import df3d_torch.models.heads.voxelrcnn_head as thead
        for m in (thooks, thead):
            m.voxel_centers_fma = (lambda f: lambda *a, **k: f(
                *a, **k).double())(m.voxel_centers_fma)
    r = voxelrcnn_step_run(jmodel, jhead, jcfg, state, tstep, batch,
                           variables, L.LR_MAX, L.TOTAL_STEPS,
                           with_package_step=False)
    want = params_from_flax(r["model"], r["new"].opt_state[0])
    gaps = []
    for name, g in r["grads"].items():
        ref = want[name].double().numpy()
        tol = 1e-4 * np.abs(ref).max() + 1e-6
        gaps.append((float(np.abs(g.double().numpy() - ref).max() / tol),
                     name))
    gaps.sort(reverse=True)
    logs = sorted(((abs(float(r["logs"][k]) - float(v))
                    / max(abs(float(v)), 1e-30), k)
                   for k, v in r["jlogs"].items() if k != "cap_overflow"),
                  reverse=True)
    return {"step": step, "scales": scales, "precision": precision,
            "sincos": sincos,
            "grad_dtype": str(next(iter(r["grads"].values())).dtype),
            "relu_replays": sum(n for _, n, _ in r["flips"]),
            "loss": float(r["logs"]["loss"]), "jax_loss":
            float(r["jlogs"]["loss"]), "worst": gaps[:3],
            "worst_log_rel": logs[:2]}


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    cases = [(step, scales, precision, "xla") for step in ("lidar", "fused")
             for scales in ("seeded", "reduced")
             for precision in ("f32", "f64")]
    cases += [(step, "seeded", "f32", "torch") for step in ("lidar", "fused")]
    for case in cases:
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   JAX_ENABLE_X64="1" if case[2] == "f64" else "0",
                   PYTHONPATH=os.pathsep.join([here, os.path.dirname(here)]))
        out = subprocess.run([sys.executable, __file__, *case], env=env,
                             check=True, capture_output=True, text=True)
        print(out.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 5:
        print(json.dumps(run_case(*sys.argv[1:])))
    else:
        main()
