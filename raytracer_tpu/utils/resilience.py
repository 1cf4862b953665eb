"""Device-fault detection and retry — the failure-recovery subsystem.

The reference's only failure handling is readable panics + Result plumbing
on GL setup (src/lib.rs:116, src/webgl.rs:16-64). A device runtime can
also fail transiently (UNAVAILABLE / DEADLINE_EXCEEDED while a worker
restarts). Device buffers from before such a fault are lost, so the
recovery unit is a WHOLE step or render re-run from host-side inputs,
never an individual chunk whose accumulator died with the device.
"""

from __future__ import annotations

import functools
import logging
import os
import time

log = logging.getLogger(__name__)

#: substrings identifying faults worth retrying (worker crash/restart or
#: transient unavailability) — anything else re-raises immediately.
#: MAINTENANCE RISK: this is substring matching against jaxlib error text
#: (no structured error codes are exposed at the Python layer); a jaxlib
#: upgrade that rewords these messages silently turns retries OFF (fail
#: closed: unknown faults re-raise, never loop). Re-validate against a
#: real fault after each jaxlib bump — tests/test_resilience.py pins the
#: matched/unmatched split but cannot pin jaxlib's wording.
_RETRYABLE = ("UNAVAILABLE", "crashed or restarted", "DEADLINE_EXCEEDED")


def is_device_fault(exc: BaseException) -> bool:
    """True for runtime device faults that a retry can plausibly clear."""
    name = type(exc).__name__
    if name not in ("JaxRuntimeError", "XlaRuntimeError"):
        return False
    msg = str(exc)
    return any(tag in msg for tag in _RETRYABLE)


def retry_on_device_fault(fn=None, *, retries: int | None = None,
                          delay_s: float = 10.0):
    """Decorator: re-run ``fn`` after a transient device fault.

    Retries ``retries`` times (default: env RAYTRACER_TPU_DEVICE_RETRIES,
    else 2) with ``delay_s`` sleeps for the device to come back. The
    wrapped function must be restartable from host-side inputs — device
    buffers do not survive a device fault.
    """

    def wrap(f):
        @functools.wraps(f)
        def inner(*args, **kwargs):
            n = retries
            if n is None:
                n = int(os.environ.get("RAYTRACER_TPU_DEVICE_RETRIES", "2"))
            attempt = 0
            while True:
                try:
                    return f(*args, **kwargs)
                except Exception as e:  # noqa: BLE001 — filtered below
                    if not is_device_fault(e) or attempt >= n:
                        raise
                    attempt += 1
                    log.warning(
                        "device fault (%s); retry %d/%d in %.0fs",
                        str(e)[:120], attempt, n, delay_s,
                    )
                    time.sleep(delay_s)

        return inner

    return wrap(fn) if fn is not None else wrap
