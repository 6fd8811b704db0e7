"""Two-rank runs of the port on the CPU, for the data-parallel tests.

``spawn(job, tmp_path, **kwargs)`` starts ``WORLD`` processes (spawned,
gloo over a ``FileStore`` under ``tmp_path``: no TCP port, so test workers
never collide), runs ``job(env, **kwargs)`` in each (``job`` a module-level
function: the children import it) and returns each rank's result, a
pickled dict. Each child uses one thread. The parent joins the children
with its own timeout and kills them when it expires: a hang fails the test
instead of using up the suite's time. The children import no JAX; the
tests compare their results with the JAX package in the parent.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import traceback

WORLD = 2
TIMEOUT_S = 170


def _child(rank: int, world: int, store: str, out: str, job, kwargs: dict) -> None:
    import torch

    torch.set_num_threads(1)
    from iseg_tpu_torch.core.env import EnvConfig, common_env_clean, common_env_setup

    try:
        env = common_env_setup(EnvConfig(
            device="cpu", mixed_precision=False, initialize_distributed=True, backend="gloo",
            init_method=f"file://{store}", num_processes=world, process_id=rank))
        result = job(env, **kwargs)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        common_env_clean()


def spawn(job, tmp_path, world: int = WORLD, timeout: float = TIMEOUT_S, **kwargs) -> list:
    """Each rank's ``job(env, **kwargs)``, in rank order."""
    out = os.path.join(str(tmp_path), f"ranks-{job.__name__}")
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, "store")
    for name in os.listdir(out):  # a FileStore is good for one group only
        os.remove(os.path.join(out, name))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, world, store, out, job, kwargs), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
            if p.is_alive():
                raise TimeoutError(f"{job.__name__}: a rank did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(out, f"rank{r}.err")
        if p.exitcode != 0 or os.path.exists(err):
            msg = open(err).read() if os.path.exists(err) else f"exit code {p.exitcode}"
            errors.append(f"rank {r}:\n{msg}")
    if errors:
        raise RuntimeError(f"{job.__name__} failed\n" + "\n".join(errors))
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    shutil.rmtree(out)  # the results are in memory; keep the temp space small
    return results
