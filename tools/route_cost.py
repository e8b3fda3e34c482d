"""Host cost of the stagewise route's decision (``ops/stagewise._admm_route``
on a CUDA device: K5's plan, else K4's, asked from the shapes) at the
shapes of three paths: config 6's long arm (K5's shared variant), 32
batteries at N=24 (b=128, K5's global variant: the longest ladder) and
fleet_b160 (b=160: no K5 plan, the torch loop with K6). Each is timed with
the plans memoized (``k5_plan``, ``k4_plan``: what every solve after the
first pays) and with their caches cleared before each call (every call
planning anew), in microseconds a call, the median of repeated batches:

    python tools/route_cost.py [--calls 200]

The preps are built on the CPU and the route is only asked, never run, so
the script needs no card; its times are the host's it runs on.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def per_call_us(fn, calls, batches=7):
    """Median over ``batches`` of the mean µs of ``calls`` calls of fn."""
    out = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append(1e6 * (time.perf_counter() - t0) / calls)
    return statistics.median(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=200)
    a = ap.parse_args(argv)

    import torch

    import chip_smoke as smoke
    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    swt = smoke.config6_preps(cpu, smoke.config6_trees()[1],
                              smoke.config6_extra(smoke.CFG6_N))[0]
    shapes = (("config 6 long arm", swt.sw, swt.M),
              ("32 batteries, N=24",
               smoke.fleet_controller(32, 24, cpu)[0]._sw, None),
              ("fleet_b160", smoke.fleet_controller(
                  *smoke.FLEET_B160, cpu)[0]._sw, None))
    if torch.cuda.is_available():
        print(smoke.gpu_line(), flush=True)
    for tag, sw, M in shapes:
        for par in (False, True):
            def route():
                return tsw._admm_route(sw, cuda, par, M)

            def planning():
                cs.k5_plan.cache_clear()
                cs.k4_plan.cache_clear()
                return route()

            run, kw = route()
            name = getattr(kw.get("sweep"), "__name__", run.__name__)
            print(f"{tag} (b={sw.b}, N={sw.N}, "
                  f"{'parallel' if par else 'sequential'}; {name}): "
                  f"memoized {per_call_us(route, a.calls):.2f} µs, "
                  f"planning anew {per_call_us(planning, a.calls):.2f} µs "
                  f"a call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
