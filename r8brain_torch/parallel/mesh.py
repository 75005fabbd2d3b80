"""A mesh of shards over the axes ("ch", "t"), and how halos move on it.

Counterpart of the ``jax.sharding.Mesh`` + ``lax.ppermute`` pair the
reference package's sharded programs run on.  A mesh has the named axes
``"ch"`` (channel shards, no communication) and ``"t"`` (time-block shards,
halos between time neighbours), either one absent or of size 1.  Shard
coordinates are row-major over the axes in the order given, as the
reference mesh's device array is; a shard's *rank* is its row-major index.

Two transports, chosen by the constructor:

* **In-process** (``group=None``): every shard's program runs in this
  process, on the caller's device, one shard after another.  A halo is a
  slice of the neighbour's piece, which this process holds.
* **torch.distributed** (``group=`` a process group of the mesh's size):
  group rank r runs shard r and holds only its own piece.  Halos move with
  ``dist.batch_isend_irecv`` between the ranks that exchange them: on the
  device under NCCL, through pinned host buffers under gloo.

Either way ``permute`` is ``ppermute``: a shard that no pair sends to gets
zeros, as the reference's stream start and end get zero history.
"""

from __future__ import annotations

import math
import socket
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

__all__ = ["Mesh"]

AXES = ("ch", "t")


class Mesh:
    """Shards over the axes ``axis_names`` (a subset of ("ch", "t")) of
    sizes ``shape``, in-process or on the process group ``group``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str] =
                 AXES, group=None):
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names) \
                or not set(names) <= set(AXES):
            raise ValueError(f"a mesh takes the axes {AXES} (either may be "
                             f"absent); got {names} of shape {shape}")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axes must have size >= 1, got {shape}")
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.size = math.prod(shape)
        self.n_ch = self.shape.get("ch", 1)
        self.n_t = self.shape.get("t", 1)
        self.group = group
        self.rank = None
        self.backend = None
        self._checked = set()
        if group is not None:
            import torch.distributed as dist

            if dist.get_world_size(group) != self.size:
                raise ValueError(
                    f"the process group has {dist.get_world_size(group)} "
                    f"ranks, the mesh {self.size} shards")
            self.rank = dist.get_rank(group)
            self.backend = str(dist.get_backend(group)).lower()
            self._global = dist.get_process_group_ranks(group)
        # CUDA pieces travel on the device where the group's backend for
        # them is NCCL ("nccl", or a "cpu:gloo,cuda:nccl" pair)
        self.nccl = self.backend is not None and "nccl" in self.backend

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def __repr__(self) -> str:
        how = "in-process" if self.group is None else \
            f"{self.backend} rank {self.rank}"
        return f"Mesh({self.shape}, {how})"

    # -- coordinates -------------------------------------------------------

    def coord(self, rank: int) -> Tuple[int, int]:
        """(ch, t) coordinate of shard ``rank`` (row-major over the axes)."""
        idx = {}
        for name in reversed(self.axis_names):
            rank, idx[name] = divmod(rank, self.shape[name])
        return idx.get("ch", 0), idx.get("t", 0)

    def rank_at(self, ci: int, ti: int) -> int:
        c = {"ch": ci, "t": ti}
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + c[name]
        return r

    def local_ranks(self) -> List[int]:
        """The shards this process runs: all of them in-process, its own
        under torch.distributed."""
        return list(range(self.size)) if self.group is None else [self.rank]

    def t_pairs(self, step: int) -> List[Tuple[int, int]]:
        """(source, destination) pairs from each shard to the one ``step``
        time blocks later (earlier for step < 0) in its channel row."""
        return [(self.rank_at(c, t), self.rank_at(c, t + step))
                for c in range(self.n_ch) for t in range(self.n_t)
                if 0 <= t + step < self.n_t]

    def carry_pairs(self) -> List[Tuple[int, int]]:
        """From each channel row's last time shard to its first: a stream's
        carried history, which the next call's first shard reads."""
        return [(self.rank_at(c, self.n_t - 1), self.rank_at(c, 0))
                for c in range(self.n_ch)]

    # -- transport ---------------------------------------------------------

    def check_device(self, device: torch.device) -> None:
        """Under NCCL, refuse two ranks on one device (NCCL cannot run
        them); a collective, so every rank calls it with its device."""
        device = torch.device(device)
        if not self.nccl or device.type != "cuda" or device in self._checked:
            return
        import torch.distributed as dist

        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        where = [None] * self.size
        dist.all_gather_object(where, (socket.gethostname(), idx),
                               group=self.group)
        dup = [r for r, w in enumerate(where) if where.index(w) != r]
        if dup:
            raise ValueError(
                f"NCCL cannot run two ranks on one device: ranks "
                f"{[where.index(where[r]) for r in dup]} and {dup} share "
                f"{[where[r] for r in dup]}; give each rank its own GPU or "
                f"use the gloo backend")
        self._checked.add(device)

    def permute(self, pieces: Dict[int, torch.Tensor],
                pairs: Iterable[Tuple[int, int]]) -> Dict[int, torch.Tensor]:
        """``lax.ppermute``: for each local shard, the piece its source in
        ``pairs`` holds, zeros where no pair sends to it.  ``pieces`` holds
        a tensor of one shape for every local shard."""
        pairs = list(pairs)
        like = next(iter(pieces.values()))
        src_of = {d: s for s, d in pairs}
        out = {}
        if like.numel() == 0:  # every shard's piece has this shape
            return {r: torch.zeros_like(like) for r in pieces}
        if self.group is None:
            for r in pieces:
                s = src_of.get(r)
                out[r] = pieces[s] if s is not None else torch.zeros_like(like)
            return out
        import torch.distributed as dist

        me = self.rank
        mine = pieces[me].contiguous()
        # gloo's point-to-point ops take host tensors only: a CUDA piece
        # crosses through pinned host buffers (NCCL sends device memory)
        stage = mine.is_cuda and not self.nccl
        ops, recv = [], None
        for s, d in pairs:
            if s == me and d == me:
                recv = mine
            elif s == me:
                send = mine.cpu().pin_memory() if stage else mine
                ops.append(dist.P2POp(dist.isend, send, self._global[d],
                                      self.group))
            elif d == me:
                recv = torch.empty(mine.shape, dtype=mine.dtype,
                                   device="cpu", pin_memory=True) \
                    if stage else torch.empty_like(mine)
                ops.append(dist.P2POp(dist.irecv, recv, self._global[s],
                                      self.group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        if recv is None:
            out[me] = torch.zeros_like(mine)
        else:
            out[me] = recv.to(mine.device, non_blocking=False) \
                if stage and recv is not mine else recv
        return out

    def split(self, x: torch.Tensor, rows: int, cols: int
              ) -> Dict[int, torch.Tensor]:
        """The in-process pieces of x [n_ch*rows, n_t*cols]: shard (c, t)
        gets rows [c*rows, (c+1)*rows) and columns [t*cols, (t+1)*cols)."""
        out = {}
        for r in self.local_ranks():
            ci, ti = self.coord(r)
            out[r] = x[ci * rows : (ci + 1) * rows,
                       ti * cols : (ti + 1) * cols]
        return out

    def assemble(self, pieces: Dict[int, torch.Tensor]) -> torch.Tensor:
        """The in-process pieces joined: each channel row's time pieces side
        by side (they may differ in length), the rows stacked."""
        rows = [torch.cat([pieces[self.rank_at(c, t)]
                           for t in range(self.n_t)], dim=1)
                for c in range(self.n_ch)]
        return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]
