"""Per-plan cost attribution: what the device did for each query and
update plan, as ``plan.cost.*`` counters captured once per signature.

Counterpart of ``repro/obs/costs.py``, at the same capture sites (the
engine's kNN, range-count and range-list plans, the facade's update
calls) and under the same signature strings (e.g.
``knn.q64.k10.pallas-frontier-auto.v32768x64``; the port's routes are
named as the reference names them). The reference AOT-compiles each plan
and reads flops and bytes from its HLO. Eager PyTorch compiles nothing,
so a plan's cost here is what the card did: when the installed recorder
was built with ``capture_costs=True``, :func:`capture` runs the plan once
more under ``torch.profiler`` and records

    plan.cost.<sig>.device_us -- the device time of the kernels it
                                 launched (on the CPU: its ops' time)
    plan.cost.<sig>.launches  -- kernels launched (on the CPU: ops run)
    plan.cost.captured        -- number of plans captured

and the kernels by name in ``Recorder.cost_kernels[sig]`` (the report's
``plan_kernels``), so a consumer can see which kernels carried a plan.

Capture is not free: the plan runs a second time, and the profiler
waits for the device when it stops. It is opt-in (the default
``Recorder()`` never captures) and meant for warm-up calls, as the
driver's ``--attributed`` and the roofline sweep use it, so measured
percentiles never include it. Nothing here reads a device value: the
profiler reports times on the host once it has stopped. Exceptions
propagate: a plan that fails under capture fails its caller.
"""

from __future__ import annotations

__all__ = ["capture", "enabled", "plan_costs", "PREFIX", "METRICS"]

PREFIX = "plan.cost."
METRICS = ("device_us", "launches")


def _recorder():
    # function-level import: this module loads during package init
    from . import recorder
    return recorder()


def enabled() -> bool:
    """True iff a recorder with ``capture_costs=True`` is installed."""
    rec = _recorder()
    return rec is not None and getattr(rec, "capture_costs", False)


def capture(fn, args, sig: str) -> bool:
    """Record ``plan.cost.<sig>.*`` for plan ``fn`` called with ``args``
    -- once per signature per recorder; a no-op unless a
    ``capture_costs`` recorder is installed. The capture sites check
    :func:`enabled` first, so with capture off they build no signature.
    Returns True iff a capture happened."""
    rec = _recorder()
    if rec is None or not getattr(rec, "capture_costs", False):
        return False
    with rec._lock:
        if sig in rec._cost_sigs:
            return False
        rec._cost_sigs.add(sig)
    device_us, kernels = _profile(fn, args)
    rec.count(f"{PREFIX}{sig}.device_us", device_us)
    rec.count(f"{PREFIX}{sig}.launches", sum(kernels.values()))
    rec.count(f"{PREFIX}captured")
    with rec._lock:
        rec.cost_kernels[sig] = kernels
    return True


def _profile(fn, args):
    """``fn(*args)`` under ``torch.profiler`` -> (device us, {kernel:
    launches}); the CPU ops' self time and calls when no kernel ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn(*args)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and "Command Buffer Full" not in e.key]
    if kernels:
        total = sum(e.self_device_time_total for e in kernels)
    else:
        kernels = [e for e in events if e.device_type == DeviceType.CPU]
        total = sum(e.self_cpu_time_total for e in kernels)
    names: dict[str, int] = {}
    for e in kernels:
        names[e.key] = names.get(e.key, 0) + e.count
    return float(total), names


def plan_costs(counters: dict) -> dict:
    """Group ``plan.cost.<sig>.<metric>`` counters back into
    ``{sig: {metric: value}}`` (report/post-processing helper)."""
    out: dict[str, dict] = {}
    for name, value in counters.items():
        if not name.startswith(PREFIX):
            continue
        rest = name[len(PREFIX):]
        sig, sep, metric = rest.rpartition(".")
        if not sep or metric not in METRICS:
            continue
        out.setdefault(sig, {})[metric] = value
    return out
