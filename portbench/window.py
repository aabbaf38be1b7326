"""The measured window: counts and timings taken from outside the program.

The program's stages hand their optimizers objective callables; the window
wraps those callables.  Each wrapped call is counted and kept (its inputs and
its output stay on the device, by reference, for the check after the
window); with tracing on, CUDA events are recorded around it.  Nothing
synchronizes inside the window.  At the first call after the deadline the
wrapper raises :class:`WindowClosed` before the program runs, which unwinds
the stage; the window then synchronizes and reads the clock, so every call it
counted has finished inside it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch


class WindowClosed(Exception):
    """Raised from inside a wrapped objective to end the stage it runs in."""


@dataclasses.dataclass(eq=False)
class Call:
    kind: str                       # "site" or "gene"
    params: Dict[str, torch.Tensor]
    value: Optional[torch.Tensor] = None
    idx: Optional[torch.Tensor] = None
    grads: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    with_grad: bool = False
    host_s: float = 0.0
    start: Optional[torch.cuda.Event] = None
    end: Optional[torch.cuda.Event] = None

    @property
    def items(self) -> int:
        return 1 if self.idx is None else int(self.idx.shape[0])


class Window:
    """``seconds``: the deadline after :meth:`open`; ``max_calls``: a call
    budget instead (warm-up); ``events``: record CUDA events per call."""

    def __init__(self, seconds: Optional[float] = None, max_calls: Optional[int] = None,
                 events: bool = False):
        self.seconds = seconds
        self.max_calls = max_calls
        self.events = events
        self.calls: List[Call] = []
        self.deadline = None
        self.t_start = self.t_end = None
        self.stages = 0

    def open(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t_start = time.perf_counter()
        if self.seconds is not None:
            self.deadline = self.t_start + self.seconds

    def close(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t_end = time.perf_counter()

    @property
    def wall_s(self) -> float:
        return self.t_end - self.t_start

    def _check(self) -> None:
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise WindowClosed
        if self.max_calls is not None and len(self.calls) >= self.max_calls:
            raise WindowClosed

    def _event(self):
        if not self.events:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def site_objective(self, objective):
        """Wrap a batched per-site objective ``(idx [N], params) -> [N]``."""
        def wrapped(idx, params):
            self._check()
            h0 = time.perf_counter()
            start = self._event()
            out = objective(idx, params)
            end = self._event()
            self.calls.append(Call("site", {k: v.detach() for k, v in params.items()},
                                   out.detach(), idx, host_s=time.perf_counter() - h0,
                                   start=start, end=end))
            return out
        return wrapped

    def gene_objective(self, objective):
        """Wrap a gene objective ``params -> lnL``; where the optimizer takes
        a gradient, hooks on the parameters keep the gradient it gets, and
        the end event is recorded from the last hook."""
        def wrapped(params):
            self._check()
            h0 = time.perf_counter()
            call = Call("gene", {k: v.detach() for k, v in params.items()},
                        start=self._event())
            if torch.is_grad_enabled():
                for key, v in params.items():
                    if isinstance(v, torch.Tensor) and v.requires_grad:
                        v.register_hook(self._keeper(call, key))
            out = objective(params)
            call.value = out.detach()
            call.with_grad = out.requires_grad
            if not call.with_grad:
                call.end = self._event()
            call.host_s = time.perf_counter() - h0
            self.calls.append(call)
            return out
        return wrapped

    def _keeper(self, call: Call, key: str):
        def hook(grad):
            call.grads[key] = grad.detach()
            if self.events:
                call.end = self._event()
        return hook
