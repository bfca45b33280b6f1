"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is ``BENCHMARK.json``'s workload of that name; its driver makes the
inputs and weights from ``--seed``, warms every shape the window uses,
measures for ``--seconds`` (``--trace 1``: then traces a short stretch and
reads the per-layer metrics), and checks the window's outputs against the
plain reference. Standard output's last line is the result: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), and last ``checks``, each compared number beside its limit; the
same checks are standard error's last lines. Exits 3 without a result
where the card is missing, 4 where JAX or the JAX package was loaded.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# caches of the program and its libraries stay inside the checkout, at a fixed path
_CACHE = ROOT / ".portbench_cache"
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "cuda")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    from portbench import harness
    from portbench.yardstick.compare import judge

    args = harness.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = harness.devices_or_exit(cell.workload["chips"])
    import torch

    obs = harness.import_driver(cell.traffic["entry"]).run(cell, args, T_START, device)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules loaded in this process that the port must not use: {found}", file=sys.stderr)
        return 4
    ok, checks = judge(obs["numbers"], cell.limits)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.workload["chips"],
           "memory_peak_bytes": int(obs["peak_bytes"])}
    result = {"correct": bool(ok and obs["failed"] == 0), "attempted": obs["attempted"], "failed": obs["failed"]}
    if args.trace:
        tr = obs["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result.update(metrics=harness.per_layer(cell, obs), device=dev,
                      breakdown={"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]})
    else:
        result.update(metrics=harness.end_to_end(cell, obs), device=dev)
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
