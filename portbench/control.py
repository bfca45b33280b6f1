"""The readings that set a cell's limits: sound runs of the program on many
seeds, the control on a few, and (training cells) the planted faults.

    python3 portbench/control.py --workload <name> --seeds 1,2,... --control-seeds 7,8,9 [--out FILE]

Each reading is one JSON line: ``{"kind", "seed", <numbers>}``.

- ``sound``: a run of the cell as the benchmark makes it, with a window
  just long enough for one pass or step, and its comparison;
- ``control``: the reference in the program's place, one precision below
  the configuration's (float32 layers: TF32 matmuls; bfloat16 layers:
  scaled float8), against the reference as stated;
- ``half_batch`` (training): the program fed half of each batch, against the
  reference on the whole batch.

A state left unchanged reads 1 in ``change_gap`` by its definition and
needs no run. The benchmark's own runs never run this.
"""

import json
import sys
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _line(out, rec):
    s = json.dumps(rec)
    print(s, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(s + "\n")


def control_detections(cell, seed, device):
    """The control of an eval cell on as many scenes as a run checks: the
    reference in TF32 against the reference in float32."""
    from portbench.drivers import common
    from portbench.yardstick.compare import detection_numbers, reference_detections
    from portbench.yardstick.scenes import make_scenes

    tr = cell.traffic
    B, n = tr["batch"], tr["scenes"]
    points = make_scenes(seed, n, cell.model, device)["points"]
    ids = list(range(min(tr["sample_batches"] * B, n)))
    sd = common.weights(cell, seed, device)
    ref = common.reference_detections(sd, points[ids], cell, block=B)
    low = common.reference_detections(sd, points[ids], cell, block=B, tf32=True)
    return detection_numbers(reference_detections(low), ref, cell.limits["tau"])


def control_training(cell, seed, device, half=False):
    from portbench.drivers import common, train
    from portbench.yardstick.compare import training_numbers

    sd = common.weights(cell, seed, device)
    batches = train.host_batches(cell, seed, device)
    ref = train.reference_steps(cell, sd, batches, device)
    if half:
        B = cell.traffic["batch"]
        trainer, prog = train.program_steps(cell, sd, batches, device,
                                            break_batch=lambda b: {k: v[:B // 2] for k, v in b.items()})
        del trainer
        common.free_memory()
        return training_numbers(prog, ref)
    low = train.reference_steps(cell, sd, batches, device, low="fp8", tf32=True)
    return training_numbers(low, ref)


def main():
    import argparse

    import torch

    from portbench import harness

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.01)
    p.add_argument("--out", default="")
    a = p.parse_args()
    cell = harness.load_cell(a.workload)
    device = harness.devices_or_exit(cell.workload["chips"])
    drv = harness.import_driver(cell.traffic["entry"])
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    for s in seeds(a.seeds):
        t = time.time()
        obs = drv.run(cell, types.SimpleNamespace(seed=s, seconds=a.seconds, trace=0), t, device)
        _line(a.out, dict(kind="sound", seed=s, secs=time.time() - t, **obs["numbers"], e2e=obs["e2e"]))
        torch.cuda.empty_cache()
    for s in seeds(a.control_seeds):
        t = time.time()
        nums = control_training(cell, s, device) if cell.traffic["entry"] == "train" else \
            control_detections(cell, s, device)
        _line(a.out, dict(kind="control", seed=s, secs=time.time() - t, **nums))
        torch.cuda.empty_cache()
    for s in seeds(a.fault_seeds):
        t = time.time()
        nums = control_training(cell, s, device, half=True)
        _line(a.out, dict(kind="half_batch", seed=s, secs=time.time() - t, **nums))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
