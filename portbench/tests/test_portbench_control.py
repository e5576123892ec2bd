"""The control of each cell comes out not correct, at the cell's own size, on the card.

The control is the configuration's lower-precision path: the program's own
int8 path (``rn50-clip-b32``), the reference in int8 in the program's
place (``vitb16-siglip2``, whose ViT subject has no int8 path) or the
dense reference with TF32 matmuls (the search). Readings over more seeds:
``portbench/tools/readings.py --control``.
"""

from __future__ import annotations

import pytest


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["rn50-clip-b32.sweep", "vitb16-siglip2.sweep", "rn50-clip-b32.search"])
def test_control_is_not_correct(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    from portbench.harness import checks
    from portbench.harness.bench import Benchmark
    from portbench.harness.runner import Run

    bench = Benchmark()
    for variant, expect in (("control", False), ("program", True)):
        run = Run(bench, workload, seed=2**31 + 99, seconds=0, trace=False, device=torch.device("cuda"),
                  variant=variant, warmup=False)
        run.kind.setup(run)
        run.kind.window(run)
        run.kind.release(run)
        limits = bench.limits(workload)
        correct, report = checks.judge(run.kind.check(run, sorted(limits)), limits)
        assert correct is expect, (variant, report)
