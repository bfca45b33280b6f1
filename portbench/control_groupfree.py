"""The readings that set the Group-Free 3D cell's limits: ``control.py`` with
that cell's control (the reference with TF32 matmuls, the attention's
products too, against the reference in float32), and with
``--witness-seeds`` the witness (the reference in float32 against float64)
and the planted one-scene fault (``eval_groupfree.witness_detections``),
one ``{"kind": "witness", ...}`` line a seed.

    python3 portbench/control_groupfree.py --workload eval_gf3d_l6o256_b64 --seeds 1,2,... \
        --control-seeds 7,8,9 [--witness-seeds 4,5,6] [--out FILE]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import control, harness  # noqa: E402
from portbench.drivers import eval_groupfree  # noqa: E402


def witness(argv):
    """Pops ``--witness-seeds`` from ``argv``; runs the witness on each."""
    if "--witness-seeds" not in argv:
        return
    i = argv.index("--witness-seeds")
    seeds = [int(x) for x in argv[i + 1].split(",") if x]
    del argv[i:i + 2]
    out = argv[argv.index("--out") + 1] if "--out" in argv else ""
    workload = argv[argv.index("--workload") + 1]
    cell = harness.load_cell(workload)
    device = harness.devices_or_exit(cell.workload["chips"])
    for s in seeds:
        t = time.time()
        nums = eval_groupfree.witness_detections(cell, s, device)
        control._line(out, dict(kind="witness", seed=s, secs=time.time() - t, **nums))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    control.control_detections = eval_groupfree.control_detections
    witness(sys.argv)
    control.main()
