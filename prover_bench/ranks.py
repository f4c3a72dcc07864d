"""A cell on D > 1 cards: D ranks, one process a card, that prove together
through the port's own sharded path (`prove(mesh=..., shard_axis=...)`).

`run.py` stays the one command.  For a cell whose `chips` is D > 1 the
parent (:func:`launch`) builds the kernel library once (so that D ranks
never race `nvcc`), and starts D children of the same command with the
hidden arguments `--rank r --ranks D --rank-dir <dir> --t-start <s>`
through torch's own launcher (`torch.distributed.elastic.multiprocessing
.start_processes`); rank r proves on `cuda:r`.  The children meet through
a `FileStore` in a temporary directory, run `init_process_group` (NCCL on
the cards, gloo on the CPU) with :data:`COLLECTIVE_TIMEOUT_S`, and open a
second, gloo group on the host for the harness's own messages, so that
these put nothing on the cards' streams.

One window for all ranks: before each job rank 0 broadcasts the trace the
job proves, or the stop, and whether the profiler records; the others
follow (:func:`follow`).  Every rank so runs the same jobs on the same
traces in the same order, and none can block in a collective that another
never reaches.  After the window each rank sends rank 0 its job count, its
peak, the sha256 of each job's proof and, in a traced run, its device busy
time; rank 0 checks the proofs and prints the one result line, which the
parent copies with every rank's standard error.

Never hang: each rank writes to log files of its own, never to a pipe.
The launcher ends every rank as soon as one exits non-zero; the parent
ends them all at the deadline, `--seconds` + :data:`SETUP_ALLOWANCE_S`
after they start, and then gives no result but the rank that failed
first, its error and its log's tail."""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import signal
import sys
import tempfile
import time
import traceback
from pathlib import Path

# seconds a run may take past --seconds, counted from the ranks' start:
# the ranks' imports and groups, each rank's traces and warm-up, the
# window's last job, the reference's check after it (at 2^19 rows 3-8 s)
# and the teardown.  A 50-s window so ends 350 s after the ranks start,
# inside the 360 s a run is given.
SETUP_ALLOWANCE_S = 300
# a rank waiting longer than this in one collective raises: longer than
# any wait of a sound run (the ranks' skew in set-up, rank 0's profiler
# export inside the window)
COLLECTIVE_TIMEOUT_S = 120
POLL_S = 0.05
TAIL_CHARS = 4000
STOP = -1


class RankFailure(Exception):
    """A rank raised, exited non-zero or outlived the deadline: the run has
    no result."""


# -- the parent -----------------------------------------------------------

def _kernel_build_line(device: str) -> str:
    """Builds the kernel library where the checkout has none, before any
    rank starts; the line says whether it compiled."""
    if device != "cuda":
        return "kernel build: none (the ranks run on the CPU)"
    import harness
    from lambdaworks_cairo_prover_tpu_torch import cuda_lib

    return harness.build_line(cuda_lib.build())


def _text(path) -> str:
    path = Path(path)
    return path.read_text(errors="replace") if path.exists() else ""


def _tail(path, n: int = TAIL_CHARS) -> str:
    return _text(path)[-n:]


def _first_failure(failures, stderrs):
    """The failure that came first.  A rank that raised records the time in
    its error file (a rank that another's failure broke raises later); one
    that died without a record (a C++ abort) counts from the last write to
    its log.  Ranks the launcher ended (SIGTERM) come last."""
    def key(f):
        ended = f.exitcode == -signal.SIGTERM
        t = f.error_file_data.get("time")
        if t is None:
            t = os.path.getmtime(stderrs[f.local_rank])
        return ended, t, f.local_rank

    return min(failures.values(), key=key)


def launch(cell, seed: int, seconds: float, trace: bool, *, t_start: float,
           device: str, bench_dir: Path, rank_command=None):
    """Run the cell as `chips` ranks; returns rank 0's result and the lines
    for standard error (each other rank's, the kernel build, rank 0's,
    whose last lines are the checks).  Raises :class:`RankFailure`."""
    from torch.distributed.elastic.multiprocessing import (
        DefaultLogsSpecs, Std, start_processes)

    world = cell.entry["chips"]
    build = _kernel_build_line(device)
    command = list(rank_command or [sys.executable,
                                    str(bench_dir / "run.py")])
    shared = ["--workload", cell.name, "--seed", str(seed),
              "--seconds", repr(seconds), "--trace", str(int(trace)),
              "--device", device, "--ranks", str(world),
              "--t-start", repr(t_start)]
    env = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"} if (
        device == "cpu") else {}
    # the launcher answers these signals by raising in this process, and
    # leaves its handlers behind
    handlers = {s: signal.getsignal(s) for s in (
        signal.SIGTERM, signal.SIGINT, signal.SIGHUP, signal.SIGQUIT)}
    with tempfile.TemporaryDirectory(prefix="prover_bench_ranks_") as tmp:
        pc = start_processes(
            name="prover_bench", entrypoint=command[0],
            args={r: (*command[1:], *shared, "--rank", str(r),
                      "--rank-dir", tmp) for r in range(world)},
            envs={r: dict(env) for r in range(world)},
            logs_specs=DefaultLogsSpecs(log_dir=tmp, redirects=Std.ALL))
        try:
            done = pc.wait(timeout=seconds + SETUP_ALLOWANCE_S,
                           period=POLL_S)
            running = [r for r, h in sorted(pc.subprocess_handlers.items())
                       if h.proc.poll() is None]
        finally:
            pc.close()
            for s, h in handlers.items():
                signal.signal(s, h)
        if done is None:
            tails = "".join(f"\n--- rank {r}'s log, its end:\n"
                            f"{_tail(pc.stderrs[r], 1500)}" for r in running)
            raise RankFailure(
                f"ranks {running} still ran at the deadline, {seconds:g} s "
                f"+ {SETUP_ALLOWANCE_S} s after they started{tails}")
        if done.is_failed():
            f = _first_failure(done.failures, pc.stderrs)
            error = f.message if f.error_file_data.get("time") else (
                f"exited with code {f.exitcode}")
            raise RankFailure(
                f"rank {f.local_rank}: {error}\n--- rank {f.local_rank}'s "
                f"log, its end:\n{_tail(pc.stderrs[f.local_rank])}")
        out0 = _text(pc.stdouts[0]).strip().splitlines()
        try:
            result = json.loads(out0[-1])
        except (IndexError, ValueError):
            raise RankFailure("rank 0: exited 0 and printed no result\n"
                              f"{_tail(pc.stderrs[0])}") from None
        lines = [f"[rank {r}] {line}" for r in range(1, world)
                 for line in _text(pc.stderrs[r]).splitlines()]
        lines.append(build)
        lines += _text(pc.stderrs[0]).splitlines()
    return result, lines


# -- a rank ---------------------------------------------------------------

class Team:
    """This rank's place among the cell's ranks: its rank, their number,
    the host group for the harness's messages and the mesh the prove
    shards over."""

    def __init__(self, rank: int, world: int, control, mesh, shard_axis: str):
        self.rank, self.world = rank, world
        self.control, self.mesh, self.shard_axis = control, mesh, shard_axis

    @property
    def prove_kwargs(self) -> dict:
        return {"mesh": self.mesh, "shard_axis": self.shard_axis}

    def tell(self, k: int, recording: bool) -> None:
        """Rank 0: the next job's trace (or STOP) and whether it records."""
        import torch
        import torch.distributed as dist

        dist.broadcast(torch.tensor([k, int(recording)], dtype=torch.int64),
                       src=0, group=self.control)

    def hear(self) -> tuple[int, bool]:
        import torch
        import torch.distributed as dist

        msg = torch.empty(2, dtype=torch.int64)
        dist.broadcast(msg, src=0, group=self.control)
        return int(msg[0]), bool(msg[1])

    def gather(self, obj):
        """Every rank's ``obj`` on rank 0, in rank order (None elsewhere)."""
        import torch.distributed as dist

        got = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, got, dst=0, group=self.control)
        return got

    def close(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.control)
        dist.destroy_process_group()


def join(rank: int, world: int, store_path: str, dev, shard_axis: str) -> Team:
    """Join the cell's process groups: NCCL (gloo on the CPU) for the
    prove's collectives, and gloo on the host for the harness's."""
    import warnings

    import torch.distributed as dist

    from lambdaworks_cairo_prover_tpu_torch.parallel.sharding import make_mesh

    # torch > 2.11 calls all_gather_into_tensor deprecated; the sharded
    # path has no other name for it
    warnings.filterwarnings("ignore", category=FutureWarning,
                            message=".*all_gather_into_tensor.*")
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    store = dist.FileStore(store_path, world)
    if dev.type == "cuda":
        dist.init_process_group("nccl", store=store, rank=rank,
                                world_size=world, timeout=timeout,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world, timeout=timeout)
    control = dist.new_group(backend="gloo", timeout=timeout)
    return Team(rank, world, control, make_mesh(world, device_type=dev.type),
                shard_axis)


def follow(ctx, team: Team) -> None:
    """A rank other than 0 in the window: run each job rank 0 announces,
    stop recording when it does, end at its stop."""
    while True:
        k, recording = team.hear()
        if ctx.recording_on() and not recording:
            ctx.stop_recording()
        if k == STOP:
            return
        ctx.run_job(k)


def job_digests(jobs, proofs) -> list:
    """The sha256 of each job's proof, in job order (None for a job with no
    proof); each distinct proof is hashed once."""
    memo, out = {}, []
    for j in jobs:
        if j.proof is None:
            out.append(None)
            continue
        key = (j.trace, j.proof)
        if key not in memo:
            memo[key] = hashlib.sha256(proofs[j.trace][j.proof]).hexdigest()
        out.append(memo[key])
    return out


def divergent_jobs(digests: list) -> set:
    """Indices of the jobs whose proof differs on some rank from rank 0's,
    or that some rank did not run."""
    n = max(len(d) for d in digests)
    lead = digests[0]
    return {i for i in range(n)
            if any(i >= len(d) or i >= len(lead) or d[i] != lead[i]
                   for d in digests)}


def _die_with_parent() -> None:
    """Linux's PR_SET_PDEATHSIG: the kernel kills this rank when its parent
    dies.  The launcher ends the ranks when it closes, or when the parent
    takes a signal it handles; a parent killed outright (SIGKILL) would
    leave them running, each in a session of its own."""
    import ctypes

    ctypes.CDLL(None).prctl(1, signal.SIGKILL)


def _record(e: BaseException) -> None:
    """The error file the launcher reads (`TORCHELASTIC_ERROR_FILE`), in its
    format, with the time to the microsecond beside its whole second."""
    path = os.environ.get("TORCHELASTIC_ERROR_FILE")
    if not path:
        return
    t = time.time()
    error = (f"{type(e).__name__}: {e}".splitlines() or [""])[0][:500]
    tmp = f"{path}.tmp"
    Path(tmp).write_text(json.dumps({"message": error, "timestamp": int(t),
                                     "time": t}))
    os.replace(tmp, path)


def child(args, manifest_path: Path, bench_dir: Path) -> int:
    """One rank, from run.py's hidden arguments.  Rank 0 prints the result
    line and the lines of checks; a rank that fails records when and why
    for the launcher, prints its traceback, and exits 1 at once (a rank
    whose collectives are broken may not tear down)."""
    import harness

    _die_with_parent()
    try:
        import torch

        cell = harness.resolve(json.loads(manifest_path.read_text()),
                               args.workload, bench_dir)
        if args.device == "cuda":
            dev = torch.device("cuda", args.rank)
            torch.cuda.set_device(dev)
        else:
            dev = torch.device(args.device)
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.ranks))
        team = join(args.rank, args.ranks,
                    str(Path(args.rank_dir) / "store"), dev,
                    cell.config["shard_axis"])
        out = harness.measure(cell, args.seed, args.seconds, bool(args.trace),
                              t_start=args.t_start, dev=dev, team=team)
        loaded = harness.forbidden_modules(sys.modules)
        if loaded:
            raise harness.BenchError(f"the run loaded {loaded}")
    except BaseException as e:  # noqa: BLE001 - recorded, then the rank ends
        _record(e)
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    if out is not None:
        result, lines = out
        for line in lines:
            print(line, file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return 0
