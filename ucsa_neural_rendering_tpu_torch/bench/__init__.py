"""Measurements on the card: `device_ms` (the device time of a call's
operations, torch.profiler) and the row-gather benchmark
`bench.dma_gather`."""

import torch


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms per call of fn: the summed durations of the kernels,
    copies and fills it puts on the device over `iters` calls
    (torch.profiler), after `warmup` calls. The host's time to launch them
    does not count, as it would between CUDA events around calls back to
    back wherever the host is slower than the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
    return 1e-3 * busy_us / iters
