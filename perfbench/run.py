"""Run one benchmark cell once and print its result as the last line of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Needs as many CUDA devices as the cell asks for, and
exits with another code than 0, printing no result, without them, when the port cannot
be imported, or when JAX or the JAX package was loaded.  The numbers compared with the
reference are printed beside their limits as the last lines of standard error and last
in the result line.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout: only a checkout's first
# run builds (the port's own kernels and native runtime go to build/kernels and
# build/native)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "perfbench" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "perfbench" / "triton")
os.environ["USE_FLAX"] = "0"
# run as a script, this folder heads sys.path: take it off, so that its modules shadow
# nothing, and import them as the package ``perfbench`` from the checkout's root
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "perfbench":
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "mlvectordb_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the JAX
    package's (whole names: the port's own name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                           T_START, log=lambda line: print(line, flush=True))
    print(json.dumps({"cell": args.workload, "seed": args.seed, "seconds": args.seconds,
                      "trace": args.trace, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "card": _power_limit(),
                      "devices": torch.cuda.device_count()}), flush=True)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
