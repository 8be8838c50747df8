"""Measurements on the card: `device_ms` (the device time of a call's
operations, torch.profiler) and the row-gather benchmark
`bench.dma_gather`."""

import torch


PROFILE_TRIES = 5
MARK = "cudaEventRecord"  # the host call of a mark, by name prefix
# host calls that launch a kernel, by name prefix
LAUNCH = ("cudaLaunch", "cuLaunch")
PAD_S = 5e-3  # host sleep before the counted call and after the window
# calls after the first pad, before the first mark: their device
# operations take the drops that follow an idle pad (ROADMAP F6)
SETTLE_CALLS = 3
# the profiles device_ms has taken in this process, of them the short ones
# it took again (or raised after), and those whose k it counted by the
# counted call's launches
PROFILES = {"taken": 0, "short": 0, "recounted": 0}


def device_ms(fn, iters: int = 20, warmup: int = 3, by_name: bool = False):
    """Mean device ms per call of fn: the summed durations of the kernels,
    copies and fills it puts on the device over `iters` calls
    (torch.profiler), after `warmup` calls. The host's time to launch them
    does not count, as it would between CUDA events around calls back to
    back wherever the host is slower than the device. With by_name, a dict
    of the same ms per call by device operation name. fn must not record
    CUDA events itself.

    A profile holds one call whose operations the profiler may lose, a pad,
    SETTLE_CALLS calls, then three marks (a CUDA event recorded by the host)
    around one counted call and the timed calls: mark, counted call, mark,
    `iters` calls, mark, and a pad. The profiler gives each host call into
    CUDA a correlation id, in the order of the calls, and each device
    operation the id of the call that launched it. So an operation belongs
    to the counted call (k of them) if its id lies between the first two
    marks' ids, and to the timed calls if between the last two: no clock
    places it. The profiler maps device operations onto the host's clock up
    to 6.2 ms before their own launches (on an H100, ROADMAP F6), and drops
    those it maps before the profile's start: the first call's in about one
    profile in 70, now and then the counted call's too. So the profile
    sleeps a pad before the counted call and after the window, PAD_S on the
    first try and twice as long on each next one. An H100's profiler has
    also lost the first one or two operations after the pad in every try of
    a call, whatever the pad (ROADMAP F6): SETTLE_CALLS calls between the
    pad and the first mark take those drops. Where the counted call's
    operations are all lost but not its launches, k is its kernel launches
    if the timed calls launched iters times as many and the window holds one
    operation for each. A profile without the three marks, with k = 0 or
    with other than k·iters operations among the timed calls' is taken
    again, up to PROFILE_TRIES times, after which this raises rather than
    report a time from a profile that lost some of them."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    mark = torch.cuda.Event()
    tries = []
    for attempt in range(PROFILE_TRIES):
        pad_s = PAD_S * 2 ** attempt
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
            for _ in range(SETTLE_CALLS):
                fn()
            mark.record()
            fn()
            mark.record()
            for _ in range(iters):
                fn()
            mark.record()
            torch.cuda.synchronize()
            time.sleep(pad_s)
        events = prof.events()
        PROFILES["taken"] += 1
        marks = sorted(e.id for e in events if e.device_type == DeviceType.CPU
                       and e.name.startswith(MARK))
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation]
        if len(marks) != 3:
            PROFILES["short"] += 1
            tries.append(f"{len(device)} operations, {len(marks)} of the 3 "
                         f"marks")
            continue
        k = sum(marks[0] < e.id < marks[1] for e in device)
        timed = [e for e in device if marks[1] < e.id < marks[2]]
        if not k:
            # The profiler has dropped the counted call's operations while
            # it kept their launches (an H100's did, in all five tries of
            # one call: ROADMAP F6). Where the counted call launched
            # kernels, the timed calls launched iters times as many and
            # the window holds one operation a launch, k is the counted
            # call's launches.
            launches = [e.id for e in events
                        if e.device_type == DeviceType.CPU
                        and e.name.startswith(LAUNCH)]
            kl = sum(marks[0] < i < marks[1] for i in launches)
            if kl and len(timed) == kl * iters == sum(
                    marks[1] < i < marks[2] for i in launches):
                k = kl
                PROFILES["recounted"] = PROFILES.get("recounted", 0) + 1
        if k and len(timed) == k * iters:
            if not by_name:
                return 1e-3 * sum(e.time_range.elapsed_us()
                                  for e in timed) / iters
            us = {}
            for e in timed:
                us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us()
            return {name: 1e-3 * t / iters for name, t in us.items()}
        PROFILES["short"] += 1
        # the host calls into CUDA of each part: where these are whole, the
        # profiler lost device operations whose launches it recorded
        host = [e.id for e in events if e.device_type == DeviceType.CPU
                and e.name.startswith("cu") and not e.name.startswith(MARK)]
        tries.append(f"k = {k}, {len(timed)} in the window "
                     f"({sum(marks[0] < i < marks[1] for i in host)} and "
                     f"{sum(marks[1] < i < marks[2] for i in host)} host "
                     f"calls into CUDA)")
    raise RuntimeError(f"device_ms: in {PROFILE_TRIES} profiles the profiler "
                       f"never recorded {iters} calls' device operations as "
                       f"{iters} times those of the counted call: "
                       + "; ".join(tries))
