"""Measurements on the card: `device_ms` (the device time of a call's
operations, torch.profiler) and the row-gather benchmark
`bench.dma_gather`."""

import torch


PROFILE_TRIES = 5
COUNT = "device_ms.counted_call"
WINDOW = "device_ms.timed_calls"
PAD_S = 5e-3  # host sleep before the counted call and after the window


def device_ms(fn, iters: int = 20, warmup: int = 3, by_name: bool = False):
    """Mean device ms per call of fn: the summed durations of the kernels,
    copies and fills it puts on the device over `iters` calls
    (torch.profiler), after `warmup` calls. The host's time to launch them
    does not count, as it would between CUDA events around calls back to
    back wherever the host is slower than the device. With by_name, a dict
    of the same ms per call by device operation name.

    A profile holds three parts: one call whose operations the profiler
    may lose as it starts, one call in the COUNT range that counts the
    device operations of a call (k), and the timed calls in the WINDOW
    range. A device operation belongs to the part whose range holds the
    host call that launched it (a CUDA API call, `cu...`, with the
    operation's correlation id), both on the host's clock. The
    device's timestamps, as the profiler maps them onto the host's clock,
    can lie milliseconds before or after their launch, so they place
    nothing; and the profiler drops operations mapped outside the
    profile. So the profile sleeps a pad before the counted call and after
    the window, PAD_S on the first try and twice as long on each next one.
    A profile without both ranges, with k = 0 or with other than k·iters
    operations in the window is taken again, up to PROFILE_TRIES times,
    after which this raises rather than report a time from a profile that
    lost some of them."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    tries = []
    for attempt in range(PROFILE_TRIES):
        pad_s = PAD_S * 2 ** attempt
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
            with record_function(COUNT):
                fn()
                torch.cuda.synchronize()
            with record_function(WINDOW):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            time.sleep(pad_s)
        events = prof.events()
        host = [e for e in events if e.device_type == DeviceType.CPU]
        ranges = {name: [e.time_range for e in host if e.name == name]
                  for name in (COUNT, WINDOW)}
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation]
        if not all(ranges.values()):
            tries.append(f"{len(device)} operations, a range lost")
            continue
        launched = {}
        for e in host:
            if e.name.startswith("cu"):
                launched[e.id] = min(e.time_range.start,
                                     launched.get(e.id, e.time_range.start))

        def part(name):
            r = ranges[name][0]
            return [e for e in device
                    if r.start <= launched.get(e.id, -1.0) <= r.end]
        k = len(part(COUNT))
        timed = part(WINDOW)
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
