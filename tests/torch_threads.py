"""One OpenMP thread for torch in the test processes of the port's tests.

Every tests/test_torch_*.py imports this module first, before torch.  The
suite runs in several worker processes at once, and on these tests' tiny
tensors each process's pool of threads, one per core, spends its time
waiting on the others' load.  ``torch.set_num_threads(1)`` after torch is
loaded is no cure: a thread that a test then starts (a Simulation's
stepping thread) stalls behind the other processes (measured on an 8-core
CPU beside six busy processes: 200 plain chunks of the README demo scene
took 63.4 s in a started thread, 0.44 s without the call).
``OMP_NUM_THREADS`` read when torch loads its OpenMP runtime has neither
effect: on that CPU the port's test files took 125-127 s under six workers
with it, against 180-265 s without it (the same tests and checks).  A
value the caller set is kept.
"""

import os
import sys

if "torch" not in sys.modules:
    os.environ.setdefault("OMP_NUM_THREADS", "1")
