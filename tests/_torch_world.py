"""A world of CPU ranks for the port's parallel tests: `run_world(n,
target, args, tmp_path)` spawns n processes over gloo (one default
group at a free 127.0.0.1 port), runs `target` ("module:function",
called as fn(rank, world, *args)) in each, and returns each rank's
result (anything torch.save takes).  A rank that raises writes its
traceback, which the caller's assertion shows.  Ranks import only
torch, numpy and the port: the JAX references run in the test process.
"""

import datetime
import importlib
import socket
import traceback

import torch

RANK_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, target, args, out_path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    result = {}
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S // 2))
        module, fn = target.split(":")
        result = {"ok": getattr(importlib.import_module(module), fn)(
            rank, world, *args)}
        dist.destroy_process_group()
    except BaseException:   # reported to the test process, then exit 1
        result = {"error": traceback.format_exc()}
        torch.save(result, out_path)
        raise
    torch.save(result, out_path)


def run_world(world, target, args, tmp_path, meanwhile=None):
    """Each rank's result; with `meanwhile`, also its return value: it
    runs in this process while the ranks do (the JAX references)."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, target, args, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    beside = None
    try:
        if meanwhile is not None:
            beside = meanwhile()
        for p in procs:
            p.join(timeout=RANK_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    results = []
    for r, out in enumerate(outs):
        try:
            got = torch.load(out, weights_only=False)
        except FileNotFoundError:
            got = {"error": f"rank {r} wrote nothing (exit code "
                            f"{procs[r].exitcode})"}
        assert "error" not in got, f"rank {r}:\n{got['error']}"
        results.append(got["ok"])
    return results if meanwhile is None else (results, beside)
