#!/usr/bin/env python3
"""Device events, kernel launches and device time a step of the benchmark's
training cell (bench_cells/train_step.py's model, camera and step), under
torch.profiler on one CUDA card.

    python3 tools/step_events_torch.py [ROOT] [--steps N]

ROOT (default: the checkout this script is in) is the tree whose
gs2mesh_torch/ and bench_cells/ are imported, so that two trees (a parent
commit unpacked beside this one) are counted by the same code. After the
cell's 5 warm-up steps, N (default 3) steps are profiled. Prints the card's
line, then one JSON line: device events a step (kernels, copies, fills),
kernel launches a step (the host's launch calls), device-busy ms a step,
the cell's parts of it (train_step.step_parts), and the ten device
kernels that launch most often a step.
"""

import argparse
import collections
import json
import os
import sys

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=here)
    ap.add_argument("--steps", type=int, default=3)
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.root))
    import torch

    from bench_cells import counts, measure, train_step

    if not torch.cuda.is_available():
        print("step_events_torch: needs a CUDA card", file=sys.stderr)
        return 2
    print(measure.card_line("cuda"), flush=True)
    cell = counts.TRAIN_CELL
    s = train_step.setup(cell, "cuda")
    for _ in range(cell["warmup"]):
        s.step()
    n = a.steps
    events = measure.profile(s.step, n)
    dev = measure.device_events(events)
    by_name = collections.Counter(e.name for e in dev)
    launches = sum(1 for e in events if e.name in LAUNCH_CALLS)
    print(json.dumps(dict(
        root=os.path.abspath(a.root), steps=n,
        device_events_a_step=len(dev) / n,
        kernel_launches_a_step=launches / n,
        device_busy_ms=measure.busy_ms(events, n),
        parts_ms=train_step.step_parts(events, n),
        most_launched={k[:80]: v / n for k, v in by_name.most_common(10)})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
