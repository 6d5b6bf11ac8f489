"""(data, cameras) meshes of ranks (port of
``jarvis_hybridnet_tpu/parallel/mesh.py``).

The JAX package meshes chips; the port meshes processes, one per GPU,
launched by ``torchrun`` and joined by ``multihost.initialize_distributed``.
A mesh of ``n_data x n_cameras`` ranks is laid out rank-major on the data
axis, as JAX lays out its device grid: the rank at (data d, camera k) is
``ranks[d * n_cameras + k]``. The data axis splits the batch (framesets,
or the frames of a recording); the camera axis splits the cameras of each
frameset, and the camera mean of the reprojection layer becomes a sum over
the camera group (``collectives.camera_sum``). Each rank holds a process
group over its camera group (the ranks of its data index) and one over its
data group (the ranks of its camera index).

InstanceNorm normalizes each sample alone, so data parallelism needs no
synchronized statistics.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from ..utils import clp


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, cameras) mesh of ranks and this rank's place in it.

    ``member`` is False on a rank of the world outside ``ranks`` (its
    indices are -1 and its groups None): such a rank idles. ``group`` spans
    the mesh, ``camera_group`` this rank's camera group, ``data_group`` its
    data group; a group equal to the world is the default group."""

    n_data: int
    n_cameras: int
    ranks: tuple
    rank: int
    data_index: int
    camera_index: int
    group: object
    camera_group: object
    data_group: object
    backend: str

    @property
    def size(self) -> int:
        return self.n_data * self.n_cameras

    @property
    def member(self) -> bool:
        return self.data_index >= 0

    @property
    def camera_root(self) -> int:
        """The world rank of camera index 0 in this rank's data group."""
        return self.ranks[self.data_index * self.n_cameras]

    def cameras(self, num_cameras: int) -> slice:
        """This rank's cameras of a rig of ``num_cameras``."""
        if num_cameras % self.n_cameras:
            raise ValueError(f"{num_cameras} cameras do not split over {self.n_cameras} ranks")
        per = num_cameras // self.n_cameras
        return slice(self.camera_index * per, (self.camera_index + 1) * per)

    def batch(self, global_batch: int) -> slice:
        """This rank's samples of a global batch of ``global_batch``."""
        if global_batch % self.n_data:
            raise ValueError(f"global batch {global_batch} does not split over "
                             f"{self.n_data} ranks")
        per = global_batch // self.n_data
        return slice(self.data_index * per, (self.data_index + 1) * per)


def _group(ranks: list, world: int, timeout):
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks, timeout=timeout)


def make_mesh(n_data: int | None = None, n_cameras: int = 1, ranks=None,
              timeout=None) -> Mesh:
    """A (data, cameras) mesh over ``ranks`` (default: the world). Defaults
    to all ranks on 'data'. Every rank of the world must call it with the
    same arguments (each new process group is made collectively)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(parallel.multihost.initialize_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if n_data is None:
        n_data = len(ranks) // n_cameras
    if n_data < 1 or n_cameras < 1 or n_data * n_cameras > len(ranks):
        raise ValueError(f"a {n_data} x {n_cameras} mesh does not fit {len(ranks)} ranks")
    ranks = ranks[: n_data * n_cameras]
    group = _group(ranks, world, timeout)
    camera_groups = [_group(ranks[d * n_cameras:(d + 1) * n_cameras], world, timeout)
                     for d in range(n_data)]
    data_groups = [_group(ranks[k::n_cameras], world, timeout) for k in range(n_cameras)]
    backend = dist.get_backend()
    if rank not in ranks:
        return Mesh(n_data, n_cameras, tuple(ranks), rank, -1, -1, None, None, None, backend)
    d, k = divmod(ranks.index(rank), n_cameras)
    return Mesh(n_data, n_cameras, tuple(ranks), rank, d, k, group, camera_groups[d],
                data_groups[k], backend)


def plan_inference_devices(all_devices, n_data_cap, n_cam=1, num_cameras=0):
    """Pick the ranks and camera-shard factor for the inference drivers.

    ``TPU.MESH_DATA_AXIS`` (``n_data_cap``) caps the data-parallel axis
    (-1 = all ranks; 1 = one data group). Camera-sharding feasibility is
    decided BEFORE slicing so an infeasible ``TPU.SHARD_CAMERAS`` cannot
    leak its factor into the data axis (MESH_DATA_AXIS=1 must stay one data
    group). Returns ``(devices, n_cam)`` with ``n_cam == 1`` when camera
    sharding is off; ``len(devices)`` is always divisible by ``n_cam``.
    """
    if n_cam > 1 and num_cameras % n_cam != 0:
        n_cam = 1
    devices = (all_devices[:n_data_cap * n_cam] if n_data_cap > 0
               else all_devices)
    if n_cam > 1 and len(devices) % n_cam != 0:
        # not enough ranks for whole camera groups: drop camera sharding
        n_cam = 1
        devices = (all_devices[:n_data_cap] if n_data_cap > 0
                   else all_devices)
    return devices, n_cam


def train_mesh_shape(n: int, batch_size: int, num_cameras: int) -> tuple[int, int]:
    """(n_data, n_cameras) of the multi-view (3D) training mesh over ``n``
    ranks: ``batch_size % n_data == 0`` and ``num_cameras % n_cam == 0``,
    the most ranks engaged, ties to the data axis (gradient all-reduce
    only, no activation collectives), with the JAX package's warnings.
    (1, 1): stay on one device."""
    if n <= 1:
        return 1, 1
    best = (1, 1)
    for n_data in range(1, n + 1):
        if batch_size % n_data:
            continue
        n_cam = n // n_data
        while n_cam > 1 and num_cameras % n_cam:
            n_cam -= 1
        if n_data * n_cam > best[0] * best[1] or (
                n_data * n_cam == best[0] * best[1] and n_data > best[0]):
            best = (n_data, n_cam)
    n_data, n_cam = best
    if n_data * n_cam <= 1:
        clp.warning(
            f"{n} devices are visible but neither BATCH_SIZE={batch_size} "
            f"nor NUM_CAMERAS={num_cameras} factors across them — training "
            f"will run on a SINGLE device.")
        return 1, 1
    if n_data * n_cam < n:
        clp.info(f"Training mesh uses {n_data * n_cam} of {n} devices "
                 f"(data={n_data}, cameras={n_cam}); BATCH_SIZE multiples of "
                 f"{n} would engage all of them.")
    return n_data, n_cam


def data_mesh_shape(n: int, batch_size: int) -> int:
    """n_data of the data-parallel (2D) training mesh over ``n`` ranks: n
    when the global batch divides across them, else 1 (one device), with
    the JAX package's warning."""
    if n <= 1:
        return 1
    if batch_size % n != 0:
        clp.warning(
            f"{n} devices are visible but BATCH_SIZE="
            f"{batch_size} does not divide across them — training will "
            f"run on a SINGLE device. Set BATCH_SIZE to a multiple of "
            f"{n} to enable data-parallel sharding.")
        return 1
    return n


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def auto_train_mesh(batch_size: int, num_cameras: int, timeout=None) -> Mesh | None:
    """The 3D training mesh over the world (:func:`train_mesh_shape`);
    ``None`` -> one device (rank 0 trains, the other ranks idle)."""
    n_data, n_cam = train_mesh_shape(_world(), batch_size, num_cameras)
    if n_data * n_cam <= 1:
        return None
    return make_mesh(n_data, n_cam, ranks=range(n_data * n_cam), timeout=timeout)


def auto_data_mesh(batch_size: int, timeout=None) -> Mesh | None:
    """The data-parallel training mesh over the world
    (:func:`data_mesh_shape`); ``None`` -> one device."""
    n_data = data_mesh_shape(_world(), batch_size)
    if n_data <= 1:
        return None
    return make_mesh(n_data, 1, timeout=timeout)
