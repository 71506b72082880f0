#!/usr/bin/env python3
"""Device time and memory of the port's counting calls, kernel by kernel,
on one CUDA card, for comparing checkouts of the repository.

    python3 tools/counting_kernels_profile.py [--root CHECKOUT] [--seed 0]

Imports `repro_torch` from CHECKOUT/src (default: this checkout), so the
same script measures any commit of the port through its public calls:
`rank_counter(y)(p)` at m = 2^20 (136 features, five grades, as
chip_smoke.py's main cell), `pairwise_counts(p, y)` at m = 4096 (the
auto cell's size) and the merge-sort tree `counts_fused(p, y)` at
m = 2^20 with real-valued utilities (the sparse and stream cells'
counting pass). For each call it prints one JSON line: every CUDA
kernel of the call by name with its device milliseconds and launches per
call (torch.profiler), the call's device time, its time by CUDA events
with the calls back to back (host launch cost included), and the peak
bytes it allocated on the card above what was allocated before it. The
last line is the card's name and power limit as nvidia-smi gives them.
It builds the checkout's kernels at first use (nvcc, into that
checkout's .kernel_build/) and exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def profile_call(torch, fn, reps: int):
    """{kernel name: [ms per call, launches per call]}, device ms per
    call, event ms per call and peak bytes above the start of fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + (e.time_range.end - e.time_range.start)
                               / 1e3, n + 1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    per_call = {name[:80]: [ms / reps, n / reps]
                for name, (ms, n) in kernels.items()}
    return (per_call, sum(ms for ms, _ in per_call.values()),
            start.elapsed_time(end) / reps, peak)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device is available', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), 'src'))
    from repro_torch.core import counts as TC
    from repro_torch.kernels.pairwise_rank import ops as PR
    from repro_torch.kernels.rank_counts import ops as RC
    dev = torch.device('cuda')
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)

    m = 1 << 20
    X = torch.randn(m, 136, generator=g, device=dev)
    w = torch.randn(136, generator=g, device=dev) / 136 ** 0.5
    p = X @ w
    y = torch.randint(0, 5, (m,), generator=g, device=dev).float()
    del X
    count = RC.rank_counter(y)
    kernels, device_ms, events_ms, peak = profile_call(
        torch, lambda: count(p), 20)
    print(json.dumps(dict(call='rank_counter(y)(p)', m=m, root=args.root,
                          kernels=kernels, device_ms=device_ms,
                          events_ms=events_ms, peak_bytes=peak)), flush=True)
    y = torch.randn(m, generator=g, device=dev)
    kernels, device_ms, events_ms, peak = profile_call(
        torch, lambda: TC.counts_fused(p, y), 5)
    print(json.dumps(dict(call='counts_fused(p, y)', m=m, root=args.root,
                          launches=sum(n for _, n in kernels.values()),
                          device_ms=device_ms, events_ms=events_ms,
                          peak_bytes=peak)), flush=True)

    m = 4096
    p = torch.randn(m, generator=g, device=dev)
    y = torch.randn(m, generator=g, device=dev)
    kernels, device_ms, events_ms, peak = profile_call(
        torch, lambda: PR.pairwise_counts(p, y), 50)
    print(json.dumps(dict(call='pairwise_counts(p, y)', m=m, root=args.root,
                          kernels=kernels, device_ms=device_ms,
                          events_ms=events_ms, peak_bytes=peak)), flush=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else 'nvidia-smi failed')
    return 0


if __name__ == '__main__':
    sys.exit(main())
