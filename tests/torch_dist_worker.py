"""Worker processes of the ``torch.distributed`` tests (gloo on the CPU).
A spawned process unpickles its target by module path, so the worker lives
in this importable module; it imports torch and the port only (no JAX), so
a worker starts in a few seconds."""
from datetime import timedelta

# seconds a rank waits for its peers at init (the tests join each process
# with a timeout too, so a hang fails in seconds)
INIT_TIMEOUT = 30


def int8_allreduce_rank(rank: int, world: int, init_file: str, inputs,
                        queue):
    """Rank ``rank`` of ``world``: ``int8_allreduce`` of ``xs[rank]`` for
    each ``xs`` of ``inputs`` over a gloo group; puts (rank, [result as
    numpy, ...]) on ``queue``."""
    import torch
    import torch.distributed as dist

    from repro_torch.training import int8_allreduce

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=INIT_TIMEOUT))
    try:
        queue.put((rank, [int8_allreduce(torch.from_numpy(xs[rank])).numpy()
                          for xs in inputs]))
    finally:
        dist.destroy_process_group()
