"""Failure detection and an opt-in host fallback (the port of
``jpeg_tpu.utils.resilience``; SURVEY §5).

The reference aborts on hardware failure (camera init,
``main/main.c:175-179``; SD mount, ``:105-114``) because an ESP32 has
nothing to fall back to.  A serving host does: the CPU can run the
bit-exact golden encoder.  This module is the serving-side elasticity
layer, and the only fallback the port offers; nothing else wraps itself
in it, so a caller who wants it says so:

* ``probe_device`` — bounded-time device health check.  A wedged card
  can HANG a copy instead of raising, so the probe runs a small tensor
  round trip in a daemon thread and enforces its own deadline.
* ``ResilientEncoder`` — wraps any batch encoder; device exceptions are
  retried, then the batch is re-encoded on the host by the pure-NumPy
  golden encoder with matching stream options (degraded throughput,
  identical format).  Every event is recorded and reported via an
  optional callback.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch


def probe_device(timeout_s: float = 30.0,
                 device: str | torch.device = "cuda") -> bool:
    """True iff a small tensor round trip to ``device`` completes within
    the deadline.

    Copies ``arange(8)`` to the device, sums it there and fetches the sum,
    in a daemon thread: a healthy card answers in milliseconds; a wedged
    one may block forever, which a plain try/except would never detect.
    Without a CUDA device it returns False (it does not raise).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        return False
    ok = [False]

    def touch():
        try:
            x = torch.arange(8, dtype=torch.int32).to(dev)
            ok[0] = int(x.sum().cpu()) == 28
        except RuntimeError:  # a CUDA error: the device is not healthy
            ok[0] = False

    t = threading.Thread(target=touch, daemon=True)
    t.start()
    t.join(timeout_s)
    return ok[0] and not t.is_alive()


@dataclass
class FailureEvent:
    """One detected device failure (kept on ``ResilientEncoder.events``)."""
    kind: str                 # "device_error" | "fallback"
    attempt: int
    error: str
    ts: float = field(default_factory=time.time)


class ResilientEncoder:
    """Elastic wrapper: device encode with retry + host golden fallback.

    ``encoder`` is any object with ``encode_batch(batch) -> list[bytes]``
    (``FastBatchEncoder``, ...).  ``config`` supplies the stream options
    the host fallback must reproduce (4:2:0 only — the golden encoder
    mirrors the reference).  On a device exception the batch is retried
    ``retries`` times (each preceded by a bounded ``probe_device`` of
    ``device``, so a wedged card fails fast instead of hanging), then
    encoded on the host.  The output format is identical either way; only
    throughput degrades, and ``events`` records why.
    """

    def __init__(self, encoder, config=None, retries: int = 1,
                 probe_timeout_s: float = 30.0, on_event=None,
                 device: str | torch.device = "cuda"):
        self.encoder = encoder
        self.config = config
        self.retries = retries
        self.probe_timeout_s = probe_timeout_s
        self.on_event = on_event
        self.device = device
        self.events: list[FailureEvent] = []

    def _record(self, kind: str, attempt: int, err: BaseException | str):
        ev = FailureEvent(kind, attempt, str(err))
        self.events.append(ev)
        if self.on_event is not None:
            self.on_event(ev)

    def _host_batch(self, batch) -> list[bytes]:
        from ..golden.encoder import encode as golden_encode
        cfg = self.config
        kw = {}
        if cfg is not None:
            if getattr(cfg, "subsampling", "420") != "420":
                raise RuntimeError(
                    "host fallback covers 4:2:0 only (golden encoder); "
                    f"cannot fall back for subsampling={cfg.subsampling!r}")
            # the golden encoder knows exact modes only; the sampled
            # mode's contract is a legal stream with per-image tables,
            # which exact dynamic strictly satisfies
            huffman = ("dynamic" if cfg.huffman == "dynamic-sampled"
                       else cfg.huffman)
            kw = dict(quality=cfg.quality, scan_layout=cfg.scan_layout,
                      restart_interval_mcu_rows=(
                          cfg.restart_interval_mcu_rows or 0),
                      huffman=huffman)
        batch = batch.cpu().numpy() if torch.is_tensor(batch) \
            else np.asarray(batch)
        if batch.ndim == 3:  # [B, H, W*3] flat-minor layout
            b, h, w3 = batch.shape
            batch = batch.reshape(b, h, w3 // 3, 3)
        return [bytes(golden_encode(img, **kw)) for img in batch]

    def encode_batch(self, batch) -> list[bytes]:
        for attempt in range(self.retries + 1):
            if attempt and not probe_device(self.probe_timeout_s,
                                            self.device):
                # the card didn't answer: skip straight to the host
                self._record("fallback", attempt, "device probe timeout")
                break
            try:
                return self.encoder.encode_batch(batch)
            except Exception as e:  # noqa: BLE001 - any device failure
                self._record("device_error", attempt, e)
        else:
            self._record("fallback", self.retries + 1, "retries exhausted")
        return self._host_batch(batch)
