"""Hot-path sanitizer: runtime host-sync + kernel-build monitor
(SYNC001/SYNC002), the twin of ``repro/analysis/hotpath.py`` for torch.

:class:`HotPathMonitor` is a context manager that instruments, for the
duration of the ``with`` block:

* **host syncs** (``SYNC001``): a tensor's value brought to the host,
  ``Tensor.item`` / ``cpu`` / ``numpy`` / ``tolist`` and ``__array__``
  (what ``np.asarray(t)`` calls), kind ``"d2h"``; and the blocking waits
  ``torch.cuda.synchronize`` and the port's fence
  :func:`repro_torch.device.synchronize`, kind ``"block"``. Every call
  counts, on a tensor of any device, with the device it names: on the
  card each one waits for the device; on the CPU the same calls are the
  stand-ins that let a CPU test pin the count. One transfer is one event:
  a hooked call made inside another (``__array__`` calls ``numpy``, the
  fence calls ``torch.cuda.synchronize``) is not counted again, nor is the
  first conversion of the host copy a counted ``cpu()`` returned
  (``t.cpu().numpy()`` is one transfer).
* **kernel-library builds** (``SYNC002``): each fresh load of the CUDA
  kernel library (``kernels._build.build``, which compiles it when no
  build of these sources exists). There is no jit: after warm-up a
  served path launches already-loaded kernels, so the count stays 0.

Syncs made inside C++ (``bool(t)``, ``nonzero``, boolean-mask indexing,
a blocking host-to-device copy) are invisible to Python hooks; on the
card, hold the count against ``torch.cuda.set_sync_debug_mode("warn")``
over the same window, which sees those.

The hooks are strictly scoped: the attributes are swapped on
``__enter__`` and restored to the original objects on ``__exit__``
(``torch.Tensor``'s C methods by removing the shadowing attribute), so
disarmed overhead is zero. Monitors do not nest and there is at most one
active process-wide.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple


class SyncEvent(NamedTuple):
    kind: str       # "d2h" (host materialization) | "block" (sync wait)
    via: str        # entry point, e.g. "Tensor.cpu"
    shape: Any      # shape of the tensor, when there is one
    device: str     # device type the call names ("cuda", "cpu")


#: (method, kind) hooked on torch.Tensor
TENSOR_HOOKS = (("item", "d2h"), ("cpu", "d2h"), ("numpy", "d2h"),
                ("tolist", "d2h"), ("__array__", "d2h"))

_MISSING = object()
_state_lock = threading.Lock()
_active: Optional["HotPathMonitor"] = None
#: (owner, attribute) -> the object that was there before arming
_saved: Dict[Tuple[Any, str], Any] = {}
#: per-thread "inside a hooked call" flag: nested hooked calls are one event
_inside = threading.local()


def active_monitor() -> Optional["HotPathMonitor"]:
    """The currently-armed monitor, or None (the disarmed state)."""
    return _active


def _counted(mon: "HotPathMonitor", kind: str, via: str, shape, device,
             impl, args, kwargs):
    if getattr(_inside, "on", False):
        return impl(*args, **kwargs)
    _inside.on = True
    try:
        mon._note_sync(kind, via, shape, device)
        return impl(*args, **kwargs)
    finally:
        _inside.on = False


def _install() -> None:
    import torch

    from repro_torch import device as devmod
    from repro_torch.kernels import _build

    def tensor_hook(name: str, kind: str, impl):
        def hooked(self, *args, **kwargs):
            mon = _active
            if mon is None or mon._take_host_copy(self):
                return impl(self, *args, **kwargs)
            out = _counted(mon, kind, f"Tensor.{name}", tuple(self.shape),
                           self.device.type, impl, (self,) + args, kwargs)
            if name == "cpu":
                mon._mark_host_copy(out)
            return out
        hooked._hotpath_orig = impl
        return hooked

    def sync_hook(via: str, impl):
        def hooked(device=None, *args, **kwargs):
            mon = _active
            if mon is None:
                return impl(device, *args, **kwargs)
            kind = "cuda" if device is None else torch.device(device).type
            return _counted(mon, "block", via, None, kind, impl,
                            (device,) + args, kwargs)
        hooked._hotpath_orig = impl
        return hooked

    def build_hook(impl):
        def hooked(*args, **kwargs):
            out = impl(*args, **kwargs)
            mon = _active
            if mon is not None:
                mon._note_build(float(_build.build_info["seconds"]))
            return out
        hooked._hotpath_orig = impl
        return hooked

    for name, kind in TENSOR_HOOKS:
        _saved[(torch.Tensor, name)] = torch.Tensor.__dict__.get(
            name, _MISSING)
        setattr(torch.Tensor, name,
                tensor_hook(name, kind, getattr(torch.Tensor, name)))
    for owner, via in ((torch.cuda, "torch.cuda.synchronize"),
                       (devmod, "repro_torch.device.synchronize")):
        _saved[(owner, "synchronize")] = owner.synchronize
        owner.synchronize = sync_hook(via, owner.synchronize)
    _saved[(_build, "build")] = _build.build
    _build.build = build_hook(_build.build)


def _uninstall() -> None:
    for (owner, name), orig in list(_saved.items()):
        if orig is _MISSING:
            delattr(owner, name)
        else:
            setattr(owner, name, orig)
    _saved.clear()


class HotPathMonitor:
    """Arm the sanitizer for a ``with`` block; see the module docstring.

    Event recording is thread-safe (the serve loop and the HPS host
    workers run on their own threads), and attribution is process-global:
    every sync and build anywhere in the process during the block is
    charged to this monitor.
    """

    _GUARDED_BY = {"syncs": "_mu", "compiles": "_mu",
                   "compile_secs": "_mu"}

    def __init__(self, label: str = ""):
        self.label = label
        self.syncs: List[SyncEvent] = []
        #: fresh kernel-library loads (SYNC002), named as the reference's
        self.compiles = 0
        self.compile_secs = 0.0
        #: tags the host copies a counted ``cpu()`` returned
        self._token = object()
        self._mu = threading.Lock()

    # -- recording (called from the hooks, any thread) -----------------------

    def _note_sync(self, kind: str, via: str, shape, device: str) -> None:
        with self._mu:
            self.syncs.append(SyncEvent(kind, via, shape, device))

    def _note_build(self, seconds: float) -> None:
        with self._mu:
            self.compiles += 1
            self.compile_secs += seconds

    def _mark_host_copy(self, t) -> None:
        t._hotpath_host_copy = self._token

    def _take_host_copy(self, t) -> bool:
        """True (once) for the host copy a counted ``cpu()`` returned: its
        first conversion is the same transfer. On the CPU ``cpu()``
        returns the tensor itself, so later calls count again."""
        if getattr(t, "_hotpath_host_copy", None) is not self._token:
            return False
        del t._hotpath_host_copy
        return True

    # -- inspection ----------------------------------------------------------

    @property
    def sync_count(self) -> int:
        with self._mu:
            return len(self.syncs)

    def events(self) -> List[SyncEvent]:
        with self._mu:
            return list(self.syncs)

    def summary(self) -> Dict[str, Any]:
        with self._mu:
            return {"label": self.label,
                    "syncs": len(self.syncs),
                    "d2h": sum(1 for e in self.syncs
                               if e.kind == "d2h"),
                    "block": sum(1 for e in self.syncs
                                 if e.kind == "block"),
                    "compiles": self.compiles,
                    "compile_secs": self.compile_secs}

    # -- arming --------------------------------------------------------------

    def __enter__(self) -> "HotPathMonitor":
        global _active
        with _state_lock:
            if _active is not None:
                raise RuntimeError(
                    "HotPathMonitor does not nest: one monitor may be "
                    "active per process")
            _install()
            _active = self
        return self

    def __exit__(self, *exc) -> bool:
        global _active
        with _state_lock:
            _active = None
            _uninstall()
        return False
