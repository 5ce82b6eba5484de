"""Device-side control flow for the fused ODE loops.

The port's counterpart of ``lax.cond`` / ``lax.while_loop`` in the
reference package's fused solvers (``russell_tpu.ode.radau5_fused``,
``erk_fused``). A step attempt is a Python function that reads and writes
tensors with fixed addresses (the loop's state) and never reads a device
value on the host, except through ``when``:

- ``when(pred, fn)`` runs ``fn`` if the 0-d bool tensor ``pred`` is true.
  On the CPU (the tests) it reads ``pred`` and calls ``fn`` or not. While a
  ``DeviceLoop`` captures the step on the card it records ``fn`` into the
  body of a CUDA graph IF node (``csrc/graph_cond.cu``), so the replay
  decides on the device; while the loop warms up it runs every ``fn``.
  It is the only place where a step reads a device value on the host
  (``host_reads`` counts those reads).
- ``DeviceLoop(step, state, done, device).run()`` calls the step attempt
  until the 0-d bool tensor ``done`` is true. On the card the first run
  warms up one attempt (every body, on the streams the capture will use,
  with the state restored afterwards), captures the attempt into one
  ``torch.cuda.CUDAGraph`` and replays it ``REPLAYS_PER_READ`` times
  between host reads of ``done``. An attempt once the loop is done
  changes nothing, so the result is the same bits whatever that number
  is. A capture that fails raises: the step never runs eagerly in its
  place.

A body's temporaries come from a memory pool of the loop's own, one
stream for each nesting depth (and a stream of its own for a body given
``stream=name``): a tensor a body allocates and the code after the body
reads keeps its address from replay to replay, and no work outside that
stream ever reuses its memory.

The capture takes about what the warm-up reserved: each stream's pool
holds that stream's largest working set (the factorize body's
temporaries, for Radau5 through a sparse genie, several times its
factors), and no pool returns memory to the card while the capture runs.
A capture that runs out of memory inside a conditional body cannot be
ended cleanly, so ``capture`` refuses (``ValueError``) where the warm-up's
reservation and ``CAPTURE_SPARE_BYTES`` exceed the card's free memory, or
where the warm-up only fitted by returning cached memory to the card.
"""

from __future__ import annotations

import ctypes
import gc
import time
from typing import Callable, Optional

import torch

__all__ = ["REPLAYS_PER_READ", "CAPTURE_SPARE_BYTES", "when",
           "check_capturable", "capture_refusal", "DeviceLoop",
           "host_reads"]

# replays of the captured step attempt between two host reads of the done
# flag (the bits of a result do not depend on it)
REPLAYS_PER_READ = 8

# memory a capture must leave free beyond what its warm-up reserved
CAPTURE_SPARE_BYTES = 2 << 30

# the reads of a device value that ``when`` made on the host (eager mode)
host_reads = 0

# the DeviceLoop warming up or capturing, if any
_active: Optional["DeviceLoop"] = None


def when(pred: torch.Tensor, fn: Callable[[], None],
         stream: Optional[str] = None) -> None:
    """Run ``fn()`` where the 0-d bool tensor ``pred`` is true: on the card
    under capture as an IF node of the graph (``stream`` names a stream of
    the body's own), eagerly elsewhere."""
    loop = _active
    if loop is None:
        global host_reads
        host_reads += 1
        if bool(pred):
            fn()
        return
    loop._body(pred, fn, stream)


def check_capturable(device, *calls) -> None:
    """Run each ``(what, fn, run)`` of ``calls`` (``run()`` calls the
    user's function ``fn``) once (its first call may upload constants),
    then capture it into a throwaway CUDA graph at the top level, where a
    failed capture is cleaned up, and raise naming the first that fails.
    The fused solvers check the system's functions so before their step's
    capture: a capture that fails inside a conditional body cannot be
    ended cleanly (torch 2.11 crashes in ``capture_end``)."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    for what, fn, run in calls:
        with torch.cuda.stream(stream):
            run()
        try:
            with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream):
                run()
        except Exception as e:
            name = getattr(fn, "__qualname__", repr(fn))
            raise RuntimeError(
                f"the system's {what} ({name}) cannot be captured into a "
                "CUDA graph for the fused loop: it must not read device "
                "values on the host (.item(), float(), bool(), .tolist(), "
                f"numpy) nor copy from the host: {e}") from e
    torch.cuda.synchronize(device)


def capture_refusal(need: int, retries: int, free: int,
                    total: int) -> Optional[str]:
    """Why a capture whose warm-up reserved ``need`` bytes, with
    ``retries`` allocations served only by returning cached memory to the
    card, would not fit in ``free`` of the card's ``total`` bytes (with
    ``CAPTURE_SPARE_BYTES`` to spare); None where it fits."""
    gib = 2 ** 30
    if retries:
        return (f"its warm-up only fitted in the card's {total / gib:.1f} "
                f"GiB by returning cached memory ({retries} times), which "
                "a capture cannot do")
    if need + CAPTURE_SPARE_BYTES > free:
        return (f"it needs about {need / gib:.1f} GiB (what its warm-up "
                f"reserved) and {CAPTURE_SPARE_BYTES / gib:.1f} GiB to "
                f"spare, and {free / gib:.1f} GiB of the card's "
                f"{total / gib:.1f} GiB are free")
    return None


def _lib():
    from russell_tpu_torch.sparse import _cuda
    return _cuda.library("graph_cond")


def _check(what, rc):
    if rc != 0:
        raise RuntimeError(f"CUDA graph {what} failed with cudaError_t {rc}")


class DeviceLoop:
    """Run a step attempt until ``done``: replays of one captured CUDA
    graph on the card, eager calls on the CPU.

    ``state`` lists every tensor whose value at the start of an attempt
    matters (the warm-up restores them); ``done`` is a 0-d bool tensor the
    step writes; ``before_capture`` drops what the warm-up left that the
    graph will make anew (memory the capture needs). Measurements of the
    last capture and run: ``warmup_s``, ``capture_s`` (capture and
    instantiation), ``nodes`` (graph nodes, bodies included),
    ``if_nodes``, ``body_nodes`` (per body stream), ``replays`` and
    ``reads``."""

    def __init__(self, step: Callable[[], None], state, done: torch.Tensor,
                 device, before_capture: Optional[Callable[[], None]] = None):
        self.step = step
        self.before_capture = before_capture
        self.state = list(state)
        self.done = done
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.graph = None
        self.capture_s = None
        self.warmup_s = None
        self.nodes = 0
        self.if_nodes = 0
        self.body_nodes: dict = {}
        self.replays = 0
        self.reads = 0
        self.warmup_bytes = 0
        self.warmup_retries = 0
        self.capture_free = None
        self._mode = None
        self._streams: dict = {}
        self._depth = 0
        self._pool = None
        self._main = None

    # -- bodies -------------------------------------------------------------

    def _stream(self, key):
        s = self._streams.get(key)
        if s is None:
            s = self._streams[key] = torch.cuda.Stream(self.device)
        return s

    def _body(self, pred, fn, name):
        key = name if name is not None else self._depth + 1
        child = self._stream(key)
        parent = torch.cuda.current_stream(self.device)
        if self._mode == "warmup":
            child.wait_stream(parent)
            self._run_in(child, fn)
            parent.wait_stream(child)
            return
        if (pred.device != self.device or pred.dtype != torch.bool
                or pred.numel() != 1):
            raise ValueError("when: pred must be a bool tensor of one value "
                             f"on {self.device}")
        pred = pred.reshape(()).contiguous()
        lib = _lib()
        body = ctypes.c_void_p()
        _check("IF node", lib.cond_if_begin(
            parent.cuda_stream, child.cuda_stream, pred.data_ptr(), 0,
            ctypes.byref(body)))
        self.if_nodes += 1
        try:
            self._run_in(child, fn)
        finally:
            rc = lib.cond_if_end(child.cuda_stream)
        _check("IF node body capture", rc)
        n = ctypes.c_ulonglong()
        _check("node count", lib.graph_node_count(body, ctypes.byref(n)))
        self.nodes += n.value
        self.body_nodes[key] = self.body_nodes.get(key, 0) + n.value

    def _run_in(self, stream, fn):
        self._depth += 1
        try:
            with torch.cuda.stream(stream):
                fn()
        finally:
            self._depth -= 1

    # -- capture ------------------------------------------------------------

    def warm_up(self):
        """One attempt with every body taken, on the capture's streams, so
        that each stream's library handles and workspaces exist before the
        capture; the state is restored afterwards. Records the memory it
        reserved (``warmup_bytes``) and the allocations served only by
        returning cached memory to the card (``warmup_retries``), which
        ``capture`` reads."""
        global _active
        t0 = time.perf_counter()
        snap = [t.clone() for t in self.state]
        self._main = torch.cuda.Stream(self.device)
        self._main.wait_stream(torch.cuda.current_stream(self.device))
        # what the set-up left cached on other streams, which the warm-up
        # cannot use, goes back to the card first
        gc.collect()
        torch.cuda.empty_cache()
        st0 = torch.cuda.memory_stats(self.device)
        _active, self._mode = self, "warmup"
        try:
            with torch.cuda.stream(self._main):
                self.step()
        finally:
            _active, self._mode = None, None
        torch.cuda.synchronize(self.device)
        st1 = torch.cuda.memory_stats(self.device)
        self.warmup_bytes = (st1["reserved_bytes.all.current"]
                             - st0["reserved_bytes.all.current"])
        self.warmup_retries = (st1["num_alloc_retries"]
                               - st0["num_alloc_retries"])
        for t, v in zip(self.state, snap):
            t.copy_(v)
        torch.cuda.synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0

    def capture(self, warm_up: bool = True):
        """Warm up (unless the caller just did), then capture the step
        attempt into ``self.graph``. Raises if the capture fails, naming
        what failed."""
        global _active
        if self.device.type != "cuda":
            raise ValueError("DeviceLoop.capture needs a CUDA device")
        if warm_up or self._main is None:
            self.warm_up()
        t0 = time.perf_counter()
        if self.before_capture is not None:
            self.before_capture()
        # return what finished loops (reference cycles) and the warm-up
        # left to the card before the graph's pools take memory
        gc.collect()
        torch.cuda.empty_cache()
        self.capture_free, total = torch.cuda.mem_get_info(self.device)
        why = capture_refusal(self.warmup_bytes, self.warmup_retries,
                              self.capture_free, total)
        if why is not None:
            raise ValueError(f"the fused step attempt is not captured: "
                             f"{why}; integrate fewer lanes at once, or "
                             "a smaller system")
        idx = self.device.index
        graph = torch.cuda.CUDAGraph()
        self.nodes = self.if_nodes = 0
        self.body_nodes = {}
        # the bodies' streams allocate from a pool of their own, kept as
        # long as the graph (the graph's pool takes the capturing stream)
        self._pool = torch.cuda.graph_pool_handle()
        err = None
        with torch.cuda.stream(self._main):
            graph.capture_begin()
            torch._C._cuda_beginAllocateCurrentThreadToPool(idx, self._pool)
            _active, self._mode = self, "capture"
            try:
                self.step()
                n = ctypes.c_ulonglong()
                _check("node count", _lib().capture_node_count(
                    self._main.cuda_stream, ctypes.byref(n)))
                self.nodes += n.value
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                err = e
            finally:
                _active, self._mode = None, None
                torch._C._cuda_endAllocateToPool(idx, self._pool)
            try:
                graph.capture_end()
            except BaseException as e:  # noqa: BLE001
                if err is None:
                    err = RuntimeError(
                        f"instantiating the graph: {e} (a conditional "
                        "body holds a node type that it may not, such as "
                        "a library's stream-ordered allocation; cuBLAS "
                        "makes none once CUBLAS_WORKSPACE_CONFIG is set "
                        "before its first handle, which importing "
                        "russell_tpu_torch does)")
        if err is not None:
            self.graph = None
            raise RuntimeError(
                "capturing the fused step attempt as a CUDA graph failed: "
                f"{err}") from err
        torch.cuda.synchronize(self.device)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def __del__(self):
        self.graph = None
        if self._pool is not None:
            try:
                torch._C._cuda_releasePool(self.device.index, self._pool)
            except Exception:  # noqa: BLE001 (interpreter shutdown)
                pass

    # -- run ----------------------------------------------------------------

    def run(self):
        """Step until ``done``: eager attempts on the CPU; on the card,
        replays of the captured attempt (captured at the first run), with
        one host read of ``done`` every ``REPLAYS_PER_READ`` replays."""
        self.replays = self.reads = 0
        if self.device.type != "cuda":
            while True:
                for _ in range(REPLAYS_PER_READ):
                    self.step()
                self.replays += REPLAYS_PER_READ
                self.reads += 1
                if bool(self.done):
                    return
        if self.graph is None:
            self.capture()
        while True:
            for _ in range(REPLAYS_PER_READ):
                self.graph.replay()
            self.replays += REPLAYS_PER_READ
            self.reads += 1
            if bool(self.done):
                return
