"""Set-up shared by every test run from the repository's root, which pytest
loads before ``tests/conftest.py``: one thread per CPU runtime, and a time
limit for each test.
"""
import faulthandler
import os
import signal

import pytest

# One thread per runtime in every test process and the processes it starts:
# the test workers share the machine's cores, and a runtime that spins a
# thread per core slows every other worker's test many times over.  Set
# before jax or torch is imported, which read these at load time.  XLA:CPU's
# Eigen pool keeps its width: --xla_cpu_multi_thread_eigen=false moves the
# last bits of the JAX package's assembly, and with them the exact zeros
# that test_torch_spmd.py's ring layouts of D and D^T are built from.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"


def pytest_configure(config):
    # torch after tests/conftest.py has set up jax, as the test files import
    # them.  A pytest plugin (jaxtyping's) loads numpy before any conftest,
    # so its BLAS read the variables above too late: limit the pools loaded.
    try:
        import torch
    except ImportError:
        pass
    else:
        torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        return
    threadpool_limits(limits=1)


# A time limit for each test, its set-up and teardown included.  At
# _LIMIT_S - 20 s faulthandler writes every thread's stack to stderr, which
# the failing phase's report carries; at _LIMIT_S the alarm raises in the
# phase that runs, pytest fails that phase, and the suite goes on, so one
# stuck test costs _LIMIT_S.  pytest, and each xdist worker, runs tests on
# the main thread, where an alarm can be armed.
_LIMIT_S = 300


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    def expire(signum, frame):
        raise TimeoutError(f"{item.nodeid} ran past {_LIMIT_S} s")

    previous = signal.signal(signal.SIGALRM, expire)
    faulthandler.dump_traceback_later(_LIMIT_S - 20)
    signal.alarm(_LIMIT_S)
    try:
        return (yield)
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)
