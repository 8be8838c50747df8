"""Measurements on the card: `device_ms` (the device time of a call's
operations, torch.profiler) and the row-gather benchmark
`bench.dma_gather`."""

import torch


PROFILE_TRIES = 5
COUNT = "device_ms.counted_call"
WINDOW = "device_ms.timed_calls"
GAP_S = 2e-3  # host sleep between the profile's parts


def device_ms(fn, iters: int = 20, warmup: int = 3, by_name: bool = False):
    """Mean device ms per call of fn: the summed durations of the kernels,
    copies and fills it puts on the device over `iters` calls
    (torch.profiler), after `warmup` calls. The host's time to launch them
    does not count, as it would between CUDA events around calls back to
    back wherever the host is slower than the device. With by_name, a dict
    of the same ms per call by device operation name.

    The profiler may miss device operations as it starts, now and then
    returns none at all, or loses a range. So a profile holds three parts,
    each waited for and GAP_S apart: one call it may lose operations of,
    one call in the COUNT range that counts the device operations of a
    call (k), and the timed calls in the WINDOW range. A device operation
    belongs to the part whose range began last before it started, give or
    take half the gap (the device's clock as the profiler maps it onto the
    host's). A profile without both ranges, with k = 0 or with other than
    k·iters operations in the window is taken again, up to PROFILE_TRIES
    times, after which this raises rather than report a time from a
    profile that lost some of them."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    tries = []
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            time.sleep(GAP_S)
            with record_function(COUNT):
                fn()
                torch.cuda.synchronize()
            time.sleep(GAP_S)
            with record_function(WINDOW):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        starts = {name: min((e.time_range.start for e in events
                             if e.name == name
                             and e.device_type == DeviceType.CPU),
                            default=None) for name in (COUNT, WINDOW)}
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation]
        if None in starts.values():
            tries.append(f"{len(device)} operations, a range lost")
            continue
        half_gap_us = 0.5e6 * GAP_S
        count_from = starts[COUNT] - half_gap_us
        window_from = starts[WINDOW] - half_gap_us
        k = sum(count_from <= e.time_range.start < window_from
                for e in device)
        timed = [e for e in device if e.time_range.start >= window_from]
        if k and len(timed) == k * iters:
            if not by_name:
                return 1e-3 * sum(e.time_range.elapsed_us()
                                  for e in timed) / iters
            us = {}
            for e in timed:
                us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us()
            return {name: 1e-3 * t / iters for name, t in us.items()}
        tries.append(f"k = {k}, {len(timed)} in the window")
    raise RuntimeError(f"device_ms: in {PROFILE_TRIES} profiles the profiler "
                       f"never recorded {iters} calls' device operations as "
                       f"{iters} times those of the counted call: "
                       + "; ".join(tries))
