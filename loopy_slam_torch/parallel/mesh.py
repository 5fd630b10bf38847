"""The port's device mesh: one process per rank over torch.distributed.

The JAX package runs one program over a device mesh (shard_map, with
lax.psum / ppermute as its collectives). Here every rank is a process that
runs the same host loop on its own device, and the collectives are
torch.distributed calls:

  psum(tensors)      one all_reduce(SUM) over a flat buffer of all of them
  pmax(t)            all_reduce(MAX)
  ring_shift(ts, s)  each rank's tensors go to rank + s (mod n): one
                     all_to_all_single that sends the packed buffer to one
                     rank and nothing to the others
  all_gather_rows(t) the ranks' row blocks, of any row counts, in rank order
  broadcast_from_rank0(obj)  a host object from rank 0 to every rank

Backend rule (deterministic, printed by rank 0 at init): NCCL when every
rank has a card of its own, gloo when ranks share the machine's one card
or run on the CPU; more ranks than cards on a machine of several cards is
refused. Ranks that share the card move the payloads of psum and
ring_shift through mailboxes: each rank allocates one on the card and
maps the others' through CUDA IPC, a writer copies into the receiver's
mailbox on the device, and two gloo barriers order the writes and the
reads (a sum adds the mailboxes in rank order, so every rank gets the
same bits). pmax and all_gather_rows stage their (small) CUDA tensors
through host memory for gloo, so every collective takes device tensors
and gives back device tensors.

Rendezvous goes through a FileStore (no TCP port to collide), with a
timeout: a rank that waits longer than that in a collective raises, so a
desynchronised program fails instead of hanging. `launch` spawns the ranks
(never forks) and raises in the caller when any rank fails.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
MAILBOX_BYTES = 256 << 20  # a rank's mailbox on a shared card


def rank_device(rank: int, device=None) -> torch.device:
    """The rank -> device rule: cuda:(rank % device_count), or the CPU when
    the caller asks for it."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("a rank needs a CUDA device and none is "
                           "available; pass device='cpu' for the CPU")
    return torch.device("cuda", rank % n)


def choose_backend(world: int, device: torch.device) -> str:
    """nccl when every rank has a card of its own, gloo when ranks share the
    machine's one card or run on the CPU. More ranks than cards on a machine
    of several cards is refused."""
    if device.type != "cuda":
        return "gloo"
    n = torch.cuda.device_count()
    if world <= n:
        return "nccl"
    if n > 1:
        raise ValueError(f"{world} ranks on {n} cards: ranks share a card "
                         f"only on a machine with one card")
    return "gloo"


class Mesh:
    """This process's rank in the process group, with the collectives the
    sharded programs use. Keeps the wall time, count and payload bytes of
    its collectives (`stats`), with the device synchronised around each
    one so the time is the collective's own."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str):
        self.rank = rank
        self.world = world
        self.device = device
        self.backend = backend
        self.stats: Dict[str, List[float]] = {}
        # gloo with CUDA tensors: pmax and all_gather_rows go through host
        # memory, psum and ring_shift through the mailboxes
        self._stage = backend == "gloo" and device.type == "cuda"
        self._boxes: Optional[List[torch.Tensor]] = None
        self.transport = backend

    def open_mailboxes(self):
        """Ranks on one shared card: allocate this rank's mailbox and map
        every other rank's through CUDA IPC (a collective)."""
        import torch.multiprocessing  # noqa: F401 - CUDA tensor pickling
        from multiprocessing.reduction import ForkingPickler

        box = torch.zeros(MAILBOX_BYTES // 4, dtype=torch.float32,
                          device=self.device)
        blobs: List[Any] = [None] * self.world
        dist.all_gather_object(blobs, bytes(ForkingPickler.dumps(box)))
        self._boxes = [box if r == self.rank else pickle.loads(b)
                       for r, b in enumerate(blobs)]
        self._sync()
        dist.barrier()
        self.transport = "cuda ipc mailboxes"

    def close_mailboxes(self):
        """Release the peers' mailboxes before any rank frees its own."""
        if self._boxes is not None:
            self._boxes = None
            self._sync()
            dist.barrier()

    def _through_boxes(self, flat: torch.Tensor, dst: Optional[int]
                       ) -> torch.Tensor:
        """Mailbox exchange of a flat float32 payload, in mailbox-sized
        pieces: to rank dst's mailbox (a ring hop; returns what arrived in
        this rank's), or, with dst None, into this rank's own and summed
        over every rank's in rank order (a psum)."""
        cap = self._boxes[0].numel()
        out = torch.empty_like(flat)
        for s in range(0, flat.numel(), cap):
            e = min(flat.numel(), s + cap)
            self._sync()
            dist.barrier()  # every rank has read its mailbox
            target = self._boxes[self.rank if dst is None else dst]
            target[:e - s].copy_(flat[s:e])
            self._sync()
            dist.barrier()  # every write has landed
            if dst is None:
                acc = self._boxes[0][:e - s].clone()
                for box in self._boxes[1:]:
                    acc += box[:e - s]
                out[s:e] = acc
            else:
                out[s:e] = self._boxes[self.rank][:e - s]
        self._sync()
        return out

    # ---- identity
    def axis_index(self) -> int:
        return self.rank

    def size(self) -> int:
        return self.world

    # ---- bookkeeping
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _record(self, name: str, t0: float, nbytes: int):
        self._sync()
        s = self.stats.setdefault(name, [0.0, 0.0, 0.0])
        s[0] += time.perf_counter() - t0
        s[1] += 1
        s[2] += nbytes

    def reset_stats(self):
        self.stats = {}

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self._stage else t

    def _from_wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self._stage else t

    # ---- collectives
    def psum(self, tensors: Union[Sequence, Dict]):
        """Sum over ranks of a list or dict of tensors (summed in float32,
        returned in their own dtype), in one all_reduce."""
        if isinstance(tensors, dict):
            keys = list(tensors)
            out = self.psum([tensors[k] for k in keys])
            return dict(zip(keys, out))
        items = list(tensors)
        if self.world == 1 or not items:
            return items
        t0 = time.perf_counter()
        self._sync()
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in items])
        if self._boxes is not None:
            flat = self._through_boxes(flat, None)
        else:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        out, off = [], 0
        for t in items:
            n = t.numel()
            out.append(flat[off:off + n].reshape(t.shape).to(t.dtype))
            off += n
        self._record("psum", t0, flat.numel() * 4)
        return out

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum over ranks."""
        if self.world == 1:
            return t
        t0 = time.perf_counter()
        self._sync()
        wire = self._to_wire(t.clone())
        dist.all_reduce(wire, op=dist.ReduceOp.MAX)
        self._record("pmax", t0, wire.numel() * wire.element_size())
        return self._from_wire(wire)

    def ring_shift(self, tensors: Sequence[torch.Tensor], shift: int = 1
                   ) -> List[torch.Tensor]:
        """Each rank's tensors move to rank (rank + shift) mod n, in one
        all_to_all_single of their packed bytes (float32 and int32 only;
        every rank passes the same shapes, as under shard_map). Returns the
        tensors that arrived from rank (rank - shift) mod n."""
        items = list(tensors)
        if self.world == 1:
            return items
        for t in items:
            if t.dtype not in (torch.float32, torch.int32):
                raise TypeError(f"ring_shift packs float32/int32, got "
                                f"{t.dtype}")
        t0 = time.perf_counter()
        self._sync()
        flat = torch.cat([t.contiguous().reshape(-1).view(torch.float32)
                          if t.dtype == torch.int32 else t.reshape(-1)
                          for t in items])
        n = flat.numel()
        dst = (self.rank + shift) % self.world
        src = (self.rank - shift) % self.world
        if self._boxes is not None:
            recv = self._through_boxes(flat, dst)
        else:
            in_split = [0] * self.world
            out_split = [0] * self.world
            in_split[dst] = n
            out_split[src] = n
            recv = torch.empty_like(flat)
            dist.all_to_all_single(recv, flat,
                                   output_split_sizes=out_split,
                                   input_split_sizes=in_split)
        out, off = [], 0
        for t in items:
            m = t.numel()
            part = recv[off:off + m]
            if t.dtype == torch.int32:
                part = part.view(torch.int32)
            out.append(part.reshape(t.shape))
            off += m
        self._record("ring", t0, n * 4)
        return out

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Concatenate every rank's (rows, ...) block in rank order; the row
        counts may differ between ranks."""
        if self.world == 1:
            return t
        t0 = time.perf_counter()
        self._sync()
        counts = torch.zeros(self.world, dtype=torch.int64)
        counts[self.rank] = t.shape[0]
        wire_c = counts if self._stage else counts.to(self.device)
        dist.all_reduce(wire_c, op=dist.ReduceOp.SUM)
        counts = wire_c.cpu().tolist()
        mx = max(counts)
        pad = t.new_zeros((mx,) + tuple(t.shape[1:]))
        pad[:t.shape[0]] = t
        wire = self._to_wire(pad)
        parts = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(parts, wire)
        out = torch.cat([p[:c] for p, c in zip(parts, counts)])
        self._record("all_gather", t0,
                     out.numel() * out.element_size())
        return self._from_wire(out)

    def broadcast_from_rank0(self, obj: Any) -> Any:
        """Rank 0's host object on every rank (pickled)."""
        if self.world == 1:
            return obj
        t0 = time.perf_counter()
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        self._record("broadcast", t0, 0)
        return box[0]

    def close(self):
        """Leave the process group (the mailboxes first)."""
        if dist.is_initialized():
            self.close_mailboxes()
            dist.destroy_process_group()


def init(rank: int, world: int, store_path: str, device=None,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join the process group as `rank` of `world` through a FileStore at
    store_path, on rank_device(rank, device), with the backend of
    choose_backend. A collective that waits longer than timeout_s
    raises."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    be = choose_backend(world, dev)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        be, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    mesh = Mesh(rank, world, dev, be)
    if mesh._stage:  # ranks share the one card (choose_backend)
        mesh.open_mailboxes()
    if rank == 0:
        where = (f"{torch.cuda.device_count()} card(s)" if dev.type == "cuda"
                 else "the CPU")
        why = "one card per rank" if be == "nccl" else "shared card or CPU"
        print(f"mesh: {world} ranks on {where}, backend {be} ({why}), "
              f"psum and ring over {mesh.transport}", flush=True)
    return mesh


def _rank_main(fn, rank, world, store_path, device, timeout_s, out_dir,
               args, kwargs):
    """Body of a spawned rank: join, run fn(mesh, *args, **kwargs), write
    its result (or its traceback) where the parent reads it."""
    code, mesh = 0, None
    try:
        if torch.device(device if device is not None else "cuda").type \
                == "cpu":
            torch.set_num_threads(1)
        mesh = init(rank, world, store_path, device, timeout_s)
        result = fn(mesh, *args, **kwargs)
        with open(os.path.join(out_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:  # noqa: BLE001 - reported to the parent
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        code = 1
    finally:
        try:
            if mesh is not None:
                mesh.close()
        except Exception:  # noqa: BLE001 - the result is already written
            pass
    if code:
        os._exit(code)


class RankError(RuntimeError):
    """A rank of launch() failed; the message holds its traceback."""


def launch(fn: Callable, world: int, *args, device=None,
           timeout_s: float = DEFAULT_TIMEOUT_S,
           store_dir: Optional[str] = None, **kwargs) -> List[Any]:
    """Run fn(mesh, *args, **kwargs) on `world` spawned ranks and return
    each rank's result, in rank order. fn must be importable by the
    children (a module-level function). If a rank raises or exits non-zero
    the others are stopped and RankError names the rank with its
    traceback. timeout_s bounds each collective's wait (a rank left
    waiting for a failed or stuck one raises). store_dir holds the
    FileStore and the results
    (a fresh temporary directory inside it; removed afterwards)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    if store_dir is not None:
        os.makedirs(store_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="mesh_", dir=store_dir)
    store_path = os.path.join(work, "store")
    procs = []
    try:
        for r in range(world):
            p = ctx.Process(target=_rank_main, args=(
                fn, r, world, store_path, device, timeout_s, work, args,
                kwargs), name=f"rank{r}")
            p.start()
            procs.append(p)
        failed = None
        while True:
            alive = [p for p in procs if p.exitcode is None]
            for r, p in enumerate(procs):
                if p.exitcode not in (None, 0) or os.path.exists(
                        os.path.join(work, f"error_{r}.txt")):
                    failed = r
                    break
            if failed is not None or not alive:
                break
            time.sleep(0.05)
        if failed is not None:
            # the first rank to fail is the cause: the others may fail in
            # the collectives it left
            time.sleep(0.5)
            errs = {}
            for r in range(world):
                path = os.path.join(work, f"error_{r}.txt")
                if os.path.exists(path):
                    stamp, _, tb = open(path).read().partition("\n")
                    errs[r] = (float(stamp), tb)
            if not errs:
                raise RankError(f"rank {failed} of {world} exited with code "
                                f"{procs[failed].exitcode} and no traceback")
            first = min(errs, key=lambda r: errs[r][0])
            others = sorted(set(errs) - {first})
            raise RankError(
                f"rank {first} of {world} failed:\n{errs[first][1]}"
                + (f"(then ranks {others} failed too)" if others else ""))
        results = []
        for r in range(world):
            path = os.path.join(work, f"result_{r}.pkl")
            if not os.path.exists(path):
                raise RankError(f"rank {r} of {world} exited without a "
                                f"result (exit code {procs[r].exitcode})")
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.exitcode is None:
                p.terminate()
        for p in procs:
            p.join(timeout=10.0)
            if p.exitcode is None:
                p.kill()
                p.join()
        shutil.rmtree(work, ignore_errors=True)
