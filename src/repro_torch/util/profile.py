"""Printing a torch.profiler trace, shared by the launchers."""
from __future__ import annotations

import torch


def print_profile(prof, seconds: float) -> None:
    """Time by operator, and the share of the run's wall clock in which
    the card ran a kernel (the profiler slows the host, so the share is
    a lower bound of the unprofiled run's).  A scheduled profile's step
    ranges (``ProfilerStep*``) also sit on the device's timeline; they
    span the kernels and are left out of the sum."""
    avg = prof.key_averages()
    on_device = [e for e in avg
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.key.startswith("ProfilerStep")]
    sort = "self_device_time_total" if on_device else "self_cpu_time_total"
    print(avg.table(sort_by=sort, row_limit=25))
    if on_device:
        busy_us = sum(e.self_device_time_total for e in on_device)
        print(f"device busy {busy_us / 1e6:.3f} s of {seconds:.3f} s wall "
              f"({busy_us / 1e6 / seconds:.1%}); by kernel:")
        for e in sorted(on_device, key=lambda e: -e.self_device_time_total
                        )[:12]:
            print(f"  {e.self_device_time_total / 1e3:10.1f} ms "
                  f"{e.count:8d} x  {e.key[:90]}")
