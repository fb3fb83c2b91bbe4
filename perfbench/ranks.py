"""One rank per card: the launcher of a cell whose configuration states
more than one rank, and what a rank needs to stay in step with the others.

launch(fn, world, pg_backend, device, args) starts `world` processes with
torch.multiprocessing, joins them into one process group through a file://
rendezvous in a temporary directory (no TCP port to clash with another
run), with every collective bounded by TIMEOUT_S, and calls
fn(Rank, *args) on each; it returns rank 0's return value.  Rank r runs on
cuda:{r % device_count()}: one card each over NCCL (gloo on the CPU in the
tests).  A rank that raises
ends every rank (torch.multiprocessing terminates the others), and launch
raises in its turn: it never waits on a rank that is gone.  Its error
names the rank that raised first (the others then fail in their
collectives, and torch.multiprocessing reports whichever it sees first).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time
import traceback

TIMEOUT_S = 300  # the longest a collective may wait before the group gives up


@dataclasses.dataclass(frozen=True)
class Rank:
    """This process's place in the group, and the launching process's clock
    (its seconds before time zero, and time zero on time.perf_counter,
    which every process of the host shares) for the set-up time."""

    rank: int
    world: int
    startup: float
    t0: float

    def _flag_device(self):
        import torch
        import torch.distributed as tdist

        return (torch.device("cuda", torch.cuda.current_device())
                if tdist.get_backend() == "nccl" else torch.device("cpu"))

    def barrier(self) -> None:
        import torch.distributed as tdist

        tdist.barrier()

    def decide(self, flag: bool) -> bool:
        """Rank 0's flag, on every rank."""
        import torch
        import torch.distributed as tdist

        t = torch.tensor([int(flag)], dtype=torch.int32, device=self._flag_device())
        tdist.broadcast(t, src=0)
        return bool(t.item())

    def gather(self, obj) -> list:
        """Every rank's obj (picklable), in rank order, on every rank."""
        import torch.distributed as tdist

        out = [None] * self.world
        tdist.all_gather_object(out, obj)
        return out


def _main(rank, fn, world, pg_backend, device, tmp, args, clock):
    import torch
    import torch.distributed as tdist

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    kw = {}
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        if pg_backend == "nccl":
            kw["device_id"] = dev
            # the ranks share one host: NCCL's own bootstrap over loopback
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    tdist.init_process_group(pg_backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                             rank=rank, world_size=world,
                             timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    try:
        out = fn(Rank(rank, world, *clock), *args)
        if rank == 0:
            with open(os.path.join(tmp, "rank0.pkl"), "wb") as fh:
                pickle.dump(out, fh)
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as fh:
            fh.write(f"{time.time()!r}\n-- rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        tdist.destroy_process_group()


def launch(fn, world: int, pg_backend: str, device: str, args=(), clock=(0.0, 0.0)):
    """fn(Rank, *args) on `world` ranks of a `pg_backend` group ('nccl',
    'gloo') on `device` ('cuda', 'cpu'); rank 0's return value.  fn must be
    importable by name (a module-level function)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="perfbench-ranks-") as tmp:
        try:
            mp.spawn(_main, args=(fn, world, pg_backend, device, tmp, tuple(args), tuple(clock)),
                     nprocs=world, join=True)
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
            errors = []
            for r in range(world):
                try:
                    with open(os.path.join(tmp, f"error{r}.txt")) as fh:
                        when, text = fh.read().split("\n", 1)
                    errors.append((float(when), text))
                except (OSError, ValueError):
                    pass
            if not errors:
                raise
            raise RuntimeError(min(errors)[1]) from exc
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as fh:
            return pickle.load(fh)
