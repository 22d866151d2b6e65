"""Device mesh and sharding helpers — counterpart of
``wsiseg_tpu/parallel/mesh.py`` on ``torch.distributed``.

The JAX package shards arrays over one ``Mesh`` and lets GSPMD insert the
collectives. The port is multi-controller: one process (rank) per
device, each holding its own rows, with the collectives of
:mod:`.comm` called explicitly. A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims over an
initialized process group (:mod:`.launch` starts one); a route's layout
(batch rows, canvas stripes) is in its own code, not in DTensor
placements.

On a 2-D ``("data", "space")`` mesh (``--mesh NxM``) rank (d, s) holds
the d-th 1/N of each batch's rows and the s-th horizontal stripe of each
of those tiles (:func:`shard_batch_spatial`; ``parallel/spatial.py``
holds the ops that run on stripes).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.parallel import comm


def make_mesh(cfg: Optional[Config] = None,
              devices: Optional[Sequence] = None,
              shape: Optional[Sequence[int]] = None,
              axes: Optional[Sequence[str]] = None) -> DeviceMesh:
    """A mesh over the first ``prod(shape)`` ranks of the initialized
    process group, dims named ``axes`` (default ``cfg.mesh_axes`` or
    ``("data",)``); a ``-1`` in ``shape`` takes the rest of the world.
    ``devices`` maps each rank to its device (default: this rank's
    current CUDA device when the group runs on cards, else the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.launch.run_ranks or torchrun)")
    n = dist.get_world_size()
    axes = tuple(axes or (cfg.mesh_axes if cfg else ("data",)))
    shape = list(shape or (cfg.mesh_shape if cfg else (-1,)))
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[shape.index(-1)] = n // known
    total = int(np.prod(shape))
    if total > n:
        raise ValueError(f"mesh shape {tuple(shape)} needs {total} ranks; "
                         f"the group has {n}")
    if devices is not None:
        dtype = torch.device(devices[dist.get_rank()]).type
    else:
        dtype = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(dtype, torch.arange(total).reshape(shape),
                      mesh_dim_names=axes)
    if len(shape) > 1:
        # every rank of the world takes part in making a group, so the
        # group of all the mesh's ranks (comm.as_group) is made here
        mesh.flat_group = dist.new_group(ranks=list(range(total)))
    return mesh


def mesh_size(mesh, axis: Optional[str] = None) -> int:
    """Ranks along ``axis`` (default: the mesh's first dim)."""
    return mesh.size(_dim(mesh, axis))


def mesh_rank(mesh, axis: Optional[str] = None) -> int:
    """This rank's coordinate along ``axis`` (default: the first dim)."""
    return mesh.get_local_rank(_dim(mesh, axis))


def mesh_group(mesh, axis: Optional[str] = None):
    """The process group along ``axis`` (default: the first dim)."""
    return mesh.get_group(_dim(mesh, axis))


def _dim(mesh, axis: Optional[str]) -> int:
    names = mesh.mesh_dim_names or ()
    return names.index(axis) if axis is not None else 0


def mesh_index(mesh) -> int:
    """This rank's index among all the mesh's ranks (row-major)."""
    return dist.get_rank(comm.as_group(mesh))


def is_lead(mesh) -> bool:
    """True on the mesh's first rank (every coordinate 0): the one that
    logs, validates and saves."""
    return all(c == 0 for c in mesh.get_coordinate())


def space_size(mesh, axis: str = "space") -> int:
    """Ranks along the mesh's space axis; 1 without one."""
    return mesh_size(mesh, axis) if axis in (mesh.mesh_dim_names or ()) \
        else 1


def stripe_bounds(mesh, n: int, axis: str = "space") -> Tuple[int, int]:
    """This rank's [lo, hi) of ``n`` rows (or patches) split over the
    space axis, as JAX shards a dim over a mesh axis: evenly, in order;
    ``ValueError`` when they do not divide."""
    m = space_size(mesh, axis)
    if n % m:
        raise ValueError(f"height {n} not divisible by the space axis "
                         f"({m})")
    s = mesh_rank(mesh, axis) if m > 1 else 0
    return s * n // m, (s + 1) * n // m


def _spatial_key(k: str, v) -> bool:
    return k in SPATIAL_KEYS and getattr(v, "ndim", 0) >= 3


def mesh_device(mesh) -> torch.device:
    """This rank's device: its current CUDA device on a CUDA mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_rows(mesh, b: int, axis: str = "data",
               microbatches: int = 1) -> np.ndarray:
    """Global row indices of this rank's share of a b-row batch, in
    microbatch order: under JAX's sharding, microbatch k of a step with
    ``grad_accum`` = ``microbatches`` is global rows [k·b/ga, (k+1)·b/ga)
    split over the ranks, so rank r holds the r-th 1/n of each."""
    n, r = mesh_size(mesh, axis), mesh_rank(mesh, axis)
    if b % (n * microbatches):
        raise ValueError(
            f"global batch_size {b} must divide evenly over {n} ranks × "
            f"{microbatches} microbatches")
    m = b // (n * microbatches)
    return np.concatenate([k * n * m + r * m + np.arange(m)
                           for k in range(microbatches)])


def shard_batch(mesh, batch: Dict, axis: str = "data",
                microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """This rank's rows (:func:`batch_rows`) of a host batch, on its
    device; ``rng*`` keys are replicated."""
    dev = mesh_device(mesh)
    b = next(len(v) for k, v in batch.items() if not k.startswith("rng"))
    rows = batch_rows(mesh, b, axis, microbatches)
    return {k: torch.as_tensor(np.asarray(v) if k.startswith("rng")
                               else np.asarray(v)[rows]).to(dev)
            for k, v in batch.items()}


#: the batch keys sharded on (batch, height) on a (data, space) mesh, as
#: JAX's (its s2d label view included); others shard on batch only
SPATIAL_KEYS = ("image", "seg_label", "seg_label_s2d")


def take_stripe(mesh, batch: Dict, axis: str = "space") -> Dict:
    """This rank's stripe of a batch of its rows (tensors or arrays): dim
    1 of each :data:`SPATIAL_KEYS` entry of 3 dims or more (an image's or
    label map's height; the HR ensemble's patches), split over ``axis``
    by :func:`stripe_bounds`; other keys as they are."""
    out = {}
    for k, v in batch.items():
        if _spatial_key(k, v):
            lo, hi = stripe_bounds(mesh, v.shape[1], axis)
            v = v[:, lo:hi]
        out[k] = v
    return out


def shard_batch_spatial(mesh, batch: Dict, data_axis: str = "data",
                        space_axis: str = "space",
                        microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """JAX's ``shard_batch_spatial`` (``mesh.py:70``) for one rank: the
    images and dense label maps of a host batch sharded on (batch,
    height), per-row values on batch only, ``rng*`` keys replicated; this
    rank's shard, on its device. Rows by :func:`batch_rows` (microbatch
    order under ``microbatches``), the stripe by :func:`take_stripe`.
    Raises ``ValueError`` when a height does not divide over the space
    axis."""
    m = space_size(mesh, space_axis)
    for k, v in batch.items():
        if _spatial_key(k, v) and v.shape[1] % m:
            raise ValueError(f"{k} height {v.shape[1]} not divisible by "
                             f"the space axis ({m})")
    dev = mesh_device(mesh)
    b = next(len(v) for k, v in batch.items() if not k.startswith("rng"))
    rows = batch_rows(mesh, b, data_axis, microbatches)
    local = take_stripe(mesh, {
        k: np.asarray(v) if k.startswith("rng") else np.asarray(v)[rows]
        for k, v in batch.items()}, space_axis)
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev)
            for k, v in local.items()}


def replicate_tree(mesh, module_or_state, axis: str = "data"):
    """Rank 0's parameters, buffers and optimizer state (and a
    ``TrainState``'s step) broadcast to every rank (every rank of the mesh
    when it has more than one dim), in place; returns the argument.
    Optimizer scalars kept off the mesh's device (torch's step counts on
    the CPU) are left as each rank has them: every rank counts the same
    steps."""
    g = comm.as_group(mesh) if len(mesh.mesh_dim_names or ()) > 1 \
        else mesh_group(mesh, axis)
    dev = mesh_device(mesh)
    model = getattr(module_or_state, "model", module_or_state)
    tensors = [t.data for t in model.parameters()] + \
        [t for t in model.buffers()]
    opt = getattr(module_or_state, "optimizer", None)
    if opt is not None:
        for st in opt.state.values():
            tensors += [v for v in st.values() if torch.is_tensor(v)]
    comm.broadcast_tensors([t for t in tensors if t.device == dev], g)
    if hasattr(module_or_state, "step"):
        step = torch.tensor([float(module_or_state.step)], device=dev)
        comm.broadcast_tensors([step], g)
        module_or_state.step = int(step.item())
    return module_or_state
