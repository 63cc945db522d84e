"""One rank of the port's multi-process tests (tests/test_torch_sharded.py).

    python tests/_torch_mesh_worker.py <job> <work_dir> [train.main arguments]

The parent sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT.
Every rank runs on the CPU over gloo and writes what it computed to
``<work_dir>/<job>_rank<RANK>.pt``:

  * ``steps`` (a 2x2 mesh): on the scene of ``<work_dir>/scene.pt`` (numpy
    parameters, degrees, cameras and images), from fresh models: one
    ShardedTrainer step over [view 0, view 0] and one over [view 0, view 1]
    (parameters and densification statistics), a camera trainer over the
    sharded engine stepped on [view 0] (a short batch) and then twice on
    [view 0, view 1], the sharded importance and colour sweeps, two steps of
    the 2DGS model over [view 0, view 1], and render_sharded of view 0;
  * ``main``: ``train.main`` with the given arguments (``--mesh`` among
    them); N after every step, the losses and the final parameters.

This module imports neither JAX nor the JAX package: the spawned ranks load
the port alone.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def _state(model):
    return {k: p.detach().clone() for k, p in model.param_dict().items()}


def steps_job(work):
    from reduced_3dgs_torch.dataset.camera import build_camera
    from reduced_3dgs_torch.dataset.dataset import CameraDataset
    from reduced_3dgs_torch.parallel import (ShardedTrainer, distributed_init, make_mesh,
                                             render_sharded, shard_train_step,
                                             sharded_colours_variance, sharded_prune_list)
    from reduced_3dgs_torch.shculling import (VariableSHGaussianModel,
                                              VariableSHGsplat2DGSGaussianModel)
    from reduced_3dgs_torch.trainer import CameraTrainer

    assert distributed_init("cpu") is True
    mesh = make_mesh(n_data=2, n_tile=2)
    scene = torch.load(os.path.join(work, "scene.pt"), weights_only=False)

    def dataset():
        return CameraDataset([
            build_camera(c["height"], c["width"], c["fovx"], c["fovy"], R=c["R"], T=c["T"],
                         ground_truth_image=torch.as_tensor(img), device="cpu")
            for c, img in zip(scene["cams"], scene["images"])])

    def model(cls=VariableSHGaussianModel):
        return cls(3, device="cpu").load_numpy(scene["params"], scene["degrees"])

    res = {"mesh": (mesh.shape, mesh.data_rank, mesh.tile_rank)}
    ds = dataset()
    m = model()
    loss, _ = shard_train_step(ShardedTrainer(m, ds, mesh=mesh), [ds[0], ds[0]])
    res["grad"] = dict(_state(m), loss=loss)

    m = model()
    t = ShardedTrainer(m, ds, mesh=mesh)
    loss, out = t.step([ds[0], ds[1]])
    res["stats"] = dict(_state(m), loss=loss, xyz_grad_accum=t.xyz_grad_accum.clone(),
                        xyz_grad_denom=t.xyz_grad_denom.clone(),
                        max_radii2d=t.max_radii2d.clone(), render=out["render"])

    m = model()
    ct = CameraTrainer(ShardedTrainer(m, ds, mesh=mesh), ds)
    losses = [ct.step([ds[0]])[0]]
    count_after_short = int(ct._cam_adam[id(ds[0])].count)
    losses += [ct.step([ds[0], ds[1]])[0] for _ in range(2)]
    res["cameras"] = dict(_state(m), losses=torch.stack(losses),
                          count_after_short=count_after_short,
                          **{f"{k}{i}": ct._cam_params[id(ds[i])][k].detach().clone()
                             for i in range(2) for k in ("rot", "trans")},
                          **{f"count{i}": int(ct._cam_adam[id(ds[i])].count)
                             for i in range(2)})

    m = model()
    count, op, ta = sharded_prune_list(m, ds, mesh)
    params = {k: p.detach() for k, p in m.param_dict().items()}
    dist, var, mean = sharded_colours_variance(list(ds), m, params, m.aux_state()["degrees"],
                                               m.active_sh_degree, mesh)
    res["sweeps"] = dict(count=count, opacity=op, t_alpha=ta, dist=dist, var=var, mean=mean)

    m = model(VariableSHGsplat2DGSGaussianModel)
    t = ShardedTrainer(m, ds, mesh=mesh)
    losses = [t.step([ds[0], ds[1]])[0] for _ in range(2)]
    res["2dgs"] = dict(_state(m), losses=torch.stack(losses))

    res["render_sharded"] = render_sharded(model(), ds[0], mesh)
    return res


def main_job(work, argv):
    from reduced_3dgs_torch import train

    rec = {"n": []}
    training = train.training

    def recording(**kwargs):
        trainer, model = kwargs["trainer"], kwargs["gaussians"]
        take_step = trainer.step

        def step(cameras):
            out = take_step(cameras)
            rec["n"].append(model.num_points)
            return out

        trainer.step = step
        rec["model"] = model
        return training(**kwargs)

    train.training = recording
    losses = train.main(argv)
    model = rec.pop("model")
    return dict(rec, losses=torch.stack(losses), degrees=model._degrees.clone(),
                **_state(model))


def run():
    job, work = sys.argv[1], sys.argv[2]
    res = steps_job(work) if job == "steps" else main_job(work, sys.argv[3:])
    torch.save(res, os.path.join(work, f"{job}_rank{os.environ['RANK']}.pt"))


if __name__ == "__main__":
    torch.set_num_threads(1)
    run()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
