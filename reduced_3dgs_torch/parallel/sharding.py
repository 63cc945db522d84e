"""Training over several devices: a ("data", "tile") mesh of processes over
torch.distributed (counterpart of reduced_3dgs_tpu/parallel/sharding.py).

The mesh is the JAX package's:

  * the "data" axis runs one camera per rank (data parallelism over views);
  * the "tile" axis runs one horizontal band of tile rows per rank, with the
    Gaussians replicated (``render_band``: the renderers' viewport, so a
    band is a crop of the full image, not an approximation of it);
  * the bands are gathered, so that the loss (SSIM's 11x11 window and the
    depth loss's normalisation by the full image's alpha included) sees the
    whole image;
  * the gradients are averaged over the mesh and every rank applies the same
    update to its replica of the state, so the densification events need no
    resharding.

One process runs each rank. ``distributed_init`` joins them from the
variables a launcher such as torchrun sets; rank r sits at mesh position
(r // n_tile, r % n_tile), and ``make_mesh`` makes one process group per
mesh row (the ranks that render one camera's bands) and one per mesh
column. The collectives are ``all_reduce`` (SUM) and ``broadcast`` only:
gloo carries CUDA tensors for these, so several ranks can share one GPU
over gloo, where NCCL refuses two ranks on one device; with a GPU per rank
they go over NCCL. A band gather is the ``all_reduce`` SUM of a
zero-filled full-height buffer into which each rank has written its rows:
adding exact zeros changes no bit, so the gathered image equals the bands.

JAX's single controller holds one copy of the state; here every rank holds
a replica, and they stay equal by construction: every rank builds the same
model from the same files, every random draw comes from a generator seeded
the same on every rank (the split's normals, the K-Means++ seeding, the
epoch shuffle of ``train.training``), and every update is computed from
all-reduced values, which are the same on every rank. JAX's
``globalize_tree`` (the promotion of process-local arrays to global ones),
``_cache_key`` (its jit cache) and ``cameras_first`` (the first camera of a
batched camera pytree; a batch here is a list) are JAX plumbing with no
counterpart.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .. import config
from ..trainer.base import Trainer
from ..trainer.optimizer import adam_update


def distributed_init(device="cuda") -> bool:
    """Join the process group of a multi-process run; False, and nothing
    done, when ``WORLD_SIZE`` is unset or 1.

    Reads RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT, as torchrun sets them. The backend is gloo when ``device``
    is the CPU or when the node's ranks outnumber its GPUs (several ranks on
    one GPU), NCCL when each rank has a GPU of its own
    (``cuda:LOCAL_RANK``, ``rank_device``)."""
    world = int(os.environ.get("WORLD_SIZE") or 1)
    if world == 1:
        return False
    if dist.is_initialized():
        return True
    rank = int(os.environ["RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE") or world)
    if torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("distributed_init on cuda but CUDA is not available; "
                               "pass device='cpu' to run on the CPU")
        torch.cuda.set_device(rank_device(device))
        backend = "nccl" if count >= local_world else "gloo"
    address = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    dist.init_process_group(backend, init_method=address, rank=rank, world_size=world)
    return True


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK % device_count`` for a CUDA
    ``device`` in a multi-process run, else ``device`` as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or int(os.environ.get("WORLD_SIZE") or 1) == 1:
        return dev
    local = int(os.environ.get("LOCAL_RANK") or 0)
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def is_main_rank() -> bool:
    """Whether this process writes the run's files: rank 0, or the only one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier():
    """Wait for every rank (nothing to wait for in a single process)."""
    if dist.is_initialized():
        dist.barrier()


class Mesh:
    """The ("data", "tile") mesh of this process's world, row-major.

    ``shape`` is {"data": n_data, "tile": n_tile}; ``rank``, ``data_rank``
    and ``tile_rank`` place this process; ``tile_group`` holds the ranks of
    its mesh row and ``data_group`` those of its column (None in a world of
    one). Collectives over an axis of size 1 are skipped."""

    def __init__(self, n_data: int, n_tile: int, rank: int = 0,
                 tile_group=None, data_group=None):
        self.shape = {"data": n_data, "tile": n_tile}
        self.rank = rank
        self.data_rank, self.tile_rank = divmod(rank, n_tile)
        self.tile_group = tile_group
        self.data_group = data_group

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["tile"]

    def all_reduce(self, tensors, axis: str = "mesh"):
        """The element-wise sum of the float32 ``tensors`` over ``axis``
        ("tile", "data" or the whole "mesh"), in one collective on one flat
        buffer; returns new tensors of the inputs' shapes."""
        size = self.size if axis == "mesh" else self.shape[axis]
        if size == 1:
            return list(tensors)
        group = {"mesh": None, "tile": self.tile_group, "data": self.data_group}[axis]
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=group)
        return [p.reshape(t.shape) for p, t in zip(torch.split(flat, [t.numel() for t in tensors]),
                                                    tensors)]

    def broadcast(self, tensors, src: int = 0):
        """Overwrite ``tensors`` in place with rank ``src``'s values."""
        if self.size > 1:
            for t in tensors:
                dist.broadcast(t, src)


def make_mesh(n_data: Optional[int] = None, n_tile: int = 1) -> Mesh:
    """The mesh of n_data x n_tile ranks over this process's world (a world
    of one outside ``distributed_init``); ``n_data`` defaults to the world
    size over ``n_tile``. Every rank must call it, with the same shape: it
    makes every row's and every column's group, in the same order on all."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_tile
    if n_data * n_tile != world or n_data < 1:
        raise ValueError(f"a {n_data}x{n_tile} mesh needs {n_data * n_tile} ranks; the "
                         f"world has {world}")
    if world == 1:
        return Mesh(1, 1)
    rank = dist.get_rank()
    data_rank, tile_rank = divmod(rank, n_tile)
    rows = [dist.new_group([d * n_tile + t for t in range(n_tile)]) for d in range(n_data)]
    cols = [dist.new_group([d * n_tile + t for d in range(n_data)]) for t in range(n_tile)]
    return Mesh(n_data, n_tile, rank, rows[data_rank], cols[tile_rank])


def batch_cameras(cameras, n_data: int):
    """(the cameras of one step, one per data rank; how many were given):
    a bare camera is a batch of one, and a short batch wraps round."""
    cams = list(cameras) if isinstance(cameras, (list, tuple)) else [cameras]
    n_orig = len(cams)
    if not 0 < n_orig <= n_data:
        raise ValueError(f"{n_orig} cameras for {n_data} data ranks")
    return (cams * n_data)[:n_data], n_orig


def band_layout(image_height: int, n_tile: int):
    """(tile rows per band, band pixel height, padded full height)."""
    tiles_y = -(-image_height // config.BLOCK_Y)
    band_tiles = -(-tiles_y // n_tile)
    band_h = band_tiles * config.BLOCK_Y
    return band_tiles, band_h, band_h * n_tile


class _SpliceBand(torch.autograd.Function):
    """The gathered image with this rank's band spliced back in with
    autograd. Forward: the gathered rows, which equal the band's bit for
    bit. Backward: the band gets ``scale`` (n_tile) times its rows'
    cotangent, as JAX's all_gather VJP hands each tile rank (a psum-scatter
    of the cotangents every rank computes of the same loss); the mean over
    the mesh then counts each band once and a term of the loss that reads
    the parameters alone once."""

    @staticmethod
    def forward(ctx, band, gathered, row0: int, scale: float):
        ctx.row0, ctx.rows, ctx.scale = row0, band.shape[-2], scale
        return gathered.clone()

    @staticmethod
    def backward(ctx, g):
        rows = g[..., ctx.row0:ctx.row0 + ctx.rows, :]
        return rows * ctx.scale, None, None, None


def gather_bands(mesh: Mesh, bands, height: int):
    """Each [..., band_h, W] tensor of ``bands`` (this rank's band of tile
    rows) gathered over the mesh row into the full [..., height, W] image,
    differentiable in this rank's rows."""
    band_h = bands[0].shape[-2]
    row0 = mesh.tile_rank * band_h
    padded = band_h * mesh.shape["tile"]
    bufs = []
    for b in bands:
        buf = b.new_zeros(b.shape[:-2] + (padded, b.shape[-1]))
        buf[..., row0:row0 + band_h, :] = b.detach()
        bufs.append(buf)
    bufs = mesh.all_reduce(bufs, "tile")
    return [_SpliceBand.apply(b, buf, row0, float(mesh.shape["tile"]))[..., :height, :]
            for b, buf in zip(bands, bufs)]


class ShardedTrainer(Trainer):
    """Camera-data-parallel x pixel-band-parallel trainer.

    ``step`` takes the cameras of one step, one per data rank (a short list
    wraps round; a bare camera is a list of one), the same list on every
    rank; each rank renders the band ``tile_rank`` of camera ``data_rank``.
    Parameters, Adam's state and the densification statistics are
    replicated; the gradients are the mean over the mesh (JAX's ``pmean``
    over both axes of the n_tile-scaled band cotangents, ``_SpliceBand``),
    and the statistics are those of n_data single-device steps over the
    batch, as JAX takes them (sharding.py:269-291): the screen-space
    gradient is summed over the tile ranks, its norm and the visibility are
    summed over the data ranks, the radii are their maximum. A rank's radii
    are the full image's preprocess radii, the same on every tile rank of a
    camera, so their maximum over the tile ranks is tile rank 0's.

    Every per-step reduction after ``backward`` goes in one ``all_reduce``
    SUM over the mesh, each data rank's quantities in its own slot of a
    zero-filled [n_data, ...] buffer: the parameter gradients, the loss, the
    screen-space gradients, the radii (from tile rank 0) and, under the
    camera trainer, the camera deltas' gradients. Every rank's camera
    trainer holds a slot for every camera, so each of them steps the deltas
    of the whole batch; a camera that only pads a short batch does not step
    its slot again. (The JAX trainer's maximum of the entry counts sizes its
    key buffers; the sharded step renders each band through the exact
    binning instead, and ``num_rendered`` stays this rank's band's count.)
    ``update_many`` runs a window as single steps, as JAX's does
    (sharding.py:284-300): window fusion is the single-device engine's."""

    def __init__(self, model, dataset=None, mesh: Optional[Mesh] = None, **configs):
        super().__init__(model, dataset, **configs)
        self.mesh = mesh if mesh is not None else make_mesh()

    def forward_loss(self, loss_fn, camera, extras):
        """Render this rank's band with a zero screen-space offset that
        requires grad, gather the bands and take the loss on the full
        image: (loss, output, offset)."""
        model = self.model
        offset = torch.zeros((model.num_points, 2), dtype=torch.float32,
                             device=model._xyz.device, requires_grad=True)
        band_tiles, _, _ = band_layout(camera.image_height, self.mesh.shape["tile"])
        band = model.render_band(camera, self.mesh.tile_rank * band_tiles, band_tiles, offset)
        render, depth, final_t = gather_bands(
            self.mesh, [band["render"], band["depth"], band["final_T"]], camera.image_height)
        out = {"render": render, "depth": depth, "final_T": final_t, "radii": band["radii"],
               "num_rendered": band["num_rendered"]}
        return loss_fn(model.param_dict(), out, camera, extras), out, offset

    @torch.no_grad()
    def _reduce(self, loss, out, offset, cam_grads):
        """The one all_reduce after ``backward``: sets each parameter's
        ``.grad`` to the mesh mean and ``out``'s statistics to the batch's;
        returns the mesh-mean loss and the camera gradients [n_data, C]
        (C 0 without a camera trainer)."""
        mesh = self.mesh
        n_data, n_tile, d = mesh.shape["data"], mesh.shape["tile"], mesh.data_rank
        params = list(self.model.param_dict().values())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        off = offset.grad.new_zeros((n_data,) + tuple(offset.shape))
        off[d] = offset.grad
        radii = off.new_zeros((n_data, offset.shape[0]))
        if mesh.tile_rank == 0:
            radii[d] = out["radii"].float()
        cams = off.new_zeros((n_data, sum(g.numel() for g in cam_grads)))
        if cam_grads:
            cams[d] = torch.cat([g.reshape(-1) for g in cam_grads])
        *grads, loss_sum, off, radii, cams = mesh.all_reduce(
            [*grads, loss.detach().reshape(1), off, radii, cams])
        for p, g in zip(params, grads):
            p.grad = g / mesh.size
        visible = radii > 0                                        # [n_data, N]
        norms = torch.linalg.vector_norm(off / n_tile, dim=-1)
        out.update(radii=radii.max(dim=0).values.to(out["radii"].dtype),
                   viewspace_grad_norm=torch.where(visible, norms,
                                                   torch.zeros_like(norms)).sum(dim=0),
                   visible_count=visible.to(torch.int32).sum(dim=0, dtype=torch.int32))
        out["visibility_filter"] = out["radii"] > 0
        return loss_sum[0] / mesh.size, cams / n_tile

    @torch.no_grad()
    def optimizer_step(self, out, offset):
        """After ``_reduce``: Adam on the mesh-mean gradients, then the
        batch's densification statistics, then the gradients are dropped."""
        del offset
        params = self.model.param_dict()
        adam_update(params, self.adam, self.lr_tree(params))
        radii = out["radii"]
        self.xyz_grad_accum += out["viewspace_grad_norm"]
        self.xyz_grad_denom += out["visible_count"]
        torch.maximum(self.max_radii2d,
                      torch.where(out["visibility_filter"], radii,
                                  torch.zeros_like(radii)).float(),
                      out=self.max_radii2d)
        for p in params.values():
            p.grad = None

    def update(self, outer, cameras):
        """One data x tile step over ``cameras`` (see the class): (loss,
        out), detached. ``out`` holds this rank's camera's full image and
        the batch's statistics, and ``_last_step_io_engine`` keeps this
        rank's camera; the events read only replicated state."""
        self.maybe_advance_schedules()
        cams, n_orig = batch_cameras(cameras, self.mesh.shape["data"])
        camera = cams[self.mesh.data_rank]
        extras = self._extras(outer)
        adjustments = [outer.camera_adjustment(c) for c in cams]
        seen, leaves = camera, {}
        if adjustments[0] is not None:
            leaves, apply, _ = adjustments[self.mesh.data_rank]
            seen = apply(camera, leaves)
        loss, out, offset = self.forward_loss(outer.loss_pure(), seen, extras)
        loss.backward()
        names = sorted(leaves)
        loss, cam_grads = self._reduce(
            loss, out, offset,
            [leaves[k].grad if leaves[k].grad is not None else torch.zeros_like(leaves[k])
             for k in names])
        if leaves:
            for (cam_params, _, consume_grads), g in zip(adjustments[:n_orig], cam_grads):
                parts = torch.split(g, [cam_params[k].numel() for k in names])
                for k, part in zip(names, parts):
                    cam_params[k].grad = part.reshape(cam_params[k].shape).clone()
                consume_grads({k: p.grad for k, p in cam_params.items()})
        self.optimizer_step(out, offset)
        self._curr_step += 1
        out = {k: v.detach() if torch.is_tensor(v) else v for k, v in out.items()}
        self._last_step_io_engine = (loss, out, camera)
        return loss, out

    def update_many(self, outer, cameras):
        """One ``update`` per item of ``cameras`` (each a step's cameras, or
        one camera), with the PSNR of this rank's image."""
        return self._single_steps(outer, cameras)

    def _image_camera(self, cameras):
        return batch_cameras(cameras, self.mesh.shape["data"])[0][self.mesh.data_rank]


@torch.no_grad()
def render_sharded(model, camera, mesh: Mesh) -> torch.Tensor:
    """Inference render [3, H, W] with the pixels sharded over the mesh's
    tile axis: each rank renders its band, and the bands are gathered."""
    band_tiles, _, _ = band_layout(camera.image_height, mesh.shape["tile"])
    band = model.render_band(camera, mesh.tile_rank * band_tiles, band_tiles)
    return gather_bands(mesh, [band["render"]], camera.image_height)[0]


def shard_train_step(trainer, cameras):
    """One data x tile step over a list of per-data-rank cameras."""
    return trainer.step(list(cameras))
