"""Peaks of the cards, and a probe that adds up the bytes of a
program function's calls.

A roofline share is the least time the card could take for the work,
bytes at the card's HBM rate, over the device time the work took.  The
bytes of a call count each input and each output tensor once, from their
shapes, whatever the kernels read again, so the share reads the same
work whatever implements the call.  Each roofline metric's reader says
which function and which tensors (metrics/*_roofline.py).
"""

from __future__ import annotations

#: Published HBM rates, bytes/s, by torch.cuda.get_device_name()
#: (NVIDIA's data sheet; the SXM part's rate assumes its 700 W limit).
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


class CallBytes:
    """Wraps every module-level binding of a function in the program's
    loaded modules, to add up the bytes of its calls; `undo` puts the
    function back."""

    def __init__(self, fn, modules, measure):
        self.fn = fn
        self.measure = measure
        self.bytes = 0
        self.calls = 0
        self.bound = []

        def counted(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.bytes += measure(args, out)
            self.calls += 1
            return out

        counted.__wrapped__ = fn
        for mod in modules:
            for name, value in list(vars(mod).items()):
                if value is fn:
                    setattr(mod, name, counted)
                    self.bound.append((mod, name))

    def reset(self):
        self.bytes = 0
        self.calls = 0

    def __str__(self):
        return f"{self.calls} calls, {self.bytes} bytes"

    def undo(self):
        for mod, name in self.bound:
            setattr(mod, name, self.fn)
        self.bound = []
