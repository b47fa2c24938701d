"""A result that the pytest-xdist workers of one test session share.

Under `-n N --dist load` the tests of one file are dealt to any worker, and
every worker that draws one builds the file's `scope="module"` fixtures
anew: a parity file whose fixture runs the JAX package (and the port) for a
minute would run it on up to N workers at once. `shared_result` runs such
a fixture's body once per session: the first worker that asks computes it
under an `fcntl` lock and pickles it into the session's shared temporary
directory (`tmp_path_factory.getbasetemp().parent` under xdist, the
session's own without); the others wait on the lock and load it.

A result's JAX arrays are kept as numpy arrays and come back as JAX
arrays on the CPU, so every worker sees the types the computing worker
saw. Tensors, paths, dataclasses and containers of them pickle as they
are. A fixture that hands out objects with state (a SlamSystem, a
monkeypatched module) cannot go through it; its tests keep their own.

`fresh_process(fn, *args)` runs fn in a new Python process with the JAX
settings of tests/conftest.py. It is for the JAX runs of the IMU
configuration with ICP (tests/test_torch_slice_inertial_geoflow.py):
under `--dist load` a worker that had run many tests before died reading
their executables from JAX's persistent compilation cache, in XLA's
deserialization, in three of four runs of the whole tier (the parent
commit's and twice on this code), in four different programs, while a
process that ran only them never did (four runs). If the new process
dies all the same, fn runs once more in another one without the
persistent cache (its compiles then take ~480 s in place of ~250 s).

The tests below hold the helper itself: one computation across processes,
the same value in each, and a failed computation left to the next caller.
"""
from __future__ import annotations

import fcntl
import multiprocessing as mp
import os
import pickle
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool

import jax
import numpy as np


class _Jax:
    """A JAX array's values, pickled as a numpy array."""

    def __init__(self, x):
        self.a = np.asarray(x)


def _pack(value):
    return jax.tree_util.tree_map(
        lambda x: _Jax(x) if isinstance(x, jax.Array) else x, value)


def _unpack(value):
    return jax.tree_util.tree_map(
        lambda x: jax.numpy.asarray(x.a) if isinstance(x, _Jax) else x,
        value)


def _root(tmp_path_factory):
    """The directory that every xdist worker of this session shares."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def cached(root, key: str, compute):
    """compute() once for everyone who asks under `root`; see the module
    docstring."""
    path = os.path.join(str(root), f"shared-{key}.pkl")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path):
                with open(path + ".tmp", "wb") as f:
                    pickle.dump(_pack(compute()), f,
                                protocol=pickle.HIGHEST_PROTOCOL)
                os.replace(path + ".tmp", path)
            with open(path, "rb") as f:
                return _unpack(pickle.load(f))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


# the settings tests/conftest.py gives JAX, copied into a fresh process
JAX_SETTINGS = ("jax_platforms", "jax_threefry_partitionable",
                "jax_compilation_cache_dir",
                "jax_persistent_cache_min_compile_time_secs")


def _fresh(fn, args, settings):
    for name, value in settings.items():
        jax.config.update(name, value)
    return _pack(fn(*_unpack(args)))


def fresh_process(fn, *args):
    """fn(*args) in a new (spawned) process with this process's JAX
    settings, again without the persistent compilation cache if that
    process dies; fn is a module-level function (pickled by name) and its
    JAX arrays come back as JAX arrays."""
    ctx = mp.get_context("spawn")
    settings = {name: getattr(jax.config, name) for name in JAX_SETTINGS}
    for use_cache in (True, False):
        if not use_cache:
            settings["jax_enable_compilation_cache"] = False
        with ProcessPoolExecutor(1, mp_context=ctx) as pool:
            try:
                out = pool.submit(_fresh, fn, _pack(args), settings)
                return _unpack(out.result())
            except BrokenProcessPool:
                if not use_cache:
                    raise


def shared_result(tmp_path_factory, key: str, compute):
    """compute() once per test session, shared by the xdist workers."""
    return cached(_root(tmp_path_factory), key, compute)



# ---------------------------------------------------------------------------
# The helper's own tests
# ---------------------------------------------------------------------------

def _count_and_value(root, log):
    def compute():
        with open(log, "a") as f:
            f.write("x")
        return {"a": np.arange(4.0) * 3, "n": 7}
    return cached(root, "probe", compute)


def _worker(root, log, q):
    q.put(_count_and_value(root, log))


def test_cached_computes_once_across_processes(tmp_path):
    """More processes than cores ask at once: one computes, all get it."""
    log = str(tmp_path / "calls")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(str(tmp_path), log, q))
             for _ in range((os.cpu_count() or 4) + 2)]
    for p in procs:
        p.start()
    got = [q.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    assert open(log).read() == "x"
    for g in got:
        assert g["n"] == 7
        np.testing.assert_array_equal(g["a"], np.arange(4.0) * 3)


def test_cached_keeps_the_types(tmp_path):
    """JAX arrays come back as JAX arrays (dtype kept), tensors as tensors,
    numpy arrays as numpy arrays, to the computing caller too."""
    import jax.numpy as jnp
    import torch
    want = (jnp.ones(3), {"b": jnp.asarray([2], jnp.uint32)},
            torch.arange(3), np.zeros(2, np.int64), None)
    out = cached(tmp_path, "jx", lambda: want)
    again = cached(tmp_path, "jx", lambda: None)
    for v in (out, again):
        assert isinstance(v[0], jax.Array) and v[0].dtype == jnp.float32
        assert isinstance(v[1]["b"], jax.Array)
        assert v[1]["b"].dtype == jnp.uint32 and int(v[1]["b"][0]) == 2
        assert torch.equal(v[2], torch.arange(3))
        assert isinstance(v[3], np.ndarray) and v[3].dtype == np.int64
        assert v[4] is None


def _jax_sum(n, die_with_the_cache=False):
    import jax.numpy as jnp
    cache = jax.config.jax_enable_compilation_cache
    if die_with_the_cache and cache:
        os._exit(11)
    return {"s": jnp.arange(n, dtype=jnp.float32).sum(), "cache": cache,
            "pid": os.getpid()}


def test_fresh_process_returns_jax_arrays():
    out = fresh_process(_jax_sum, 5)
    assert isinstance(out["s"], jax.Array) and float(out["s"]) == 10.0
    assert out["cache"] is True and out["pid"] != os.getpid()


def test_fresh_process_runs_again_without_the_cache_if_it_dies():
    out = fresh_process(_jax_sum, 4, True)
    assert float(out["s"]) == 6.0 and out["cache"] is False


def test_cached_leaves_a_failed_computation_to_the_next_caller(tmp_path):
    def boom():
        raise RuntimeError("no")
    try:
        cached(tmp_path, "f", boom)
    except RuntimeError:
        pass
    assert cached(tmp_path, "f", lambda: 5) == 5
    assert not os.path.exists(tmp_path / "shared-f.pkl.tmp")
