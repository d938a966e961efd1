"""The port's static analysis and runtime sanitizers, twins of
``repro.analysis`` for the PyTorch serving stack.

Passes and rule ids
-------------------

``concurrency`` — lock-discipline lint (static, AST), the reference's
rules over the port, ``python -m repro_torch.analysis --check``:
    * ``LOCK001`` — attribute declared in a class's ``_GUARDED_BY``
      mapping accessed outside a ``with self.<lock>:`` scope.
    * ``LOCK002`` — blocking call while holding a lock: the reference's
      table (L2/L3 fetches, ``time.sleep``, bus poll/publish, future
      ``.result``, thread ``.join``, pool ``.shutdown``) and PyTorch's
      host syncs (``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``,
      ``torch.cuda.synchronize``, a stream's or event's
      ``.synchronize()``).
    * ``LOCK003`` — lock-order cycle in the static acquisition graph,
      or re-acquiring a held non-reentrant lock.
    * ``LOCK004`` — ``*_locked``-suffixed method called without holding
      the lock.

``hotpath`` — runtime sanitizer (:class:`~.hotpath.HotPathMonitor`):
    * ``SYNC001`` — a tensor's value brought to the host (``item``,
      ``cpu``, ``numpy``, ``tolist``, ``__array__``) or a blocking wait
      (``torch.cuda.synchronize``, the port's fence
      ``repro_torch.device.synchronize``) inside the monitored region.
    * ``SYNC002`` — a fresh load (and build) of the kernel library
      inside the monitored region (``kernels/_build.py``).

``lockorder`` — :class:`~.lockorder.LockOrderRecorder`, the dynamic
counterpart of LOCK003: wraps live locks during a test hammer and
asserts the OBSERVED acquisition graph is acyclic.

``deadcode`` — import-graph reachability, the reference's pass with the
port's roots (``python -m repro_torch.analysis --rules lock,dead``):
    * ``DEAD001`` — module unreachable from every entry point
      (``launch/*``, ``api``, ``__main__`` modules, ``chip_smoke.py``,
      ``tools/*.py``, ``tests/test_torch_*.py``).
    * ``DEAD002`` — module reachable only from tests (informational).

Conventions are the reference's: ``_GUARDED_BY`` / ``_LOCKS_OF`` class
attributes, ``# lock-ok: RULE reason`` inline waivers. The port keeps no
baseline: every finding is fixed or waived where it stands.

The static passes are stdlib only; ``hotpath`` imports torch when a
monitor is armed.
"""
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.hotpath import HotPathMonitor, SyncEvent, active_monitor
from repro_torch.analysis.lockorder import LockOrderRecorder

__all__ = ["Finding", "HotPathMonitor", "SyncEvent", "active_monitor",
           "LockOrderRecorder"]
